#!/usr/bin/env python3
"""Where the backward's 16-head tensor-core class (``staged_kernel``) spends
its time, on one NVIDIA GPU.

    python3 tools/torch_bwd16_variants.py [--only NAME,...]

Builds ``flash_reattention_train.cu`` once per variant, all in parallel, into
``build/bwd16_variants/`` (ignored by git), each with an edited copy of
``reattention_bwd_tc.cuh``, and times ``vit_train_bwd`` on the tensor-core
route at the classifier's two levels ((16, 48) N 196, (16, 12) N 784),
batch 64, bf16, the BN term on, dropout rate 0 (no Philox draws) and 0.2
(CUDA events, 20 calls after 3):

* ``base``: the source as it is;
* ``noprod``: step 2a without its two products (S and T taken as 0);
* ``nomix``: step 2b without its two H x H mixes (dA and B);
* ``nostep3``: without step 3 (dk, dv and dq products, the dq atomics).

Only ``base`` computes the function; the others exist to be timed.  Prints
the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vit_unet_tpu_torch.kernels import _build  # noqa: E402
from vit_unet_tpu_torch.kernels.flash_reattention_train import keep_threshold  # noqa: E402

OUT = ROOT / "build" / "bwd16_variants"
HEADER = "reattention_bwd_tc.cuh"
PRODUCTS = """      prod_16x8<C, BQ>(qs, ks, h, r0, c0, lane, s);
      prod_16x8<C, BQ>(gs, vs, h, r0, c0, lane, tt);
      const int ra = r0 + gq, kk = c0 + 2 * t4;"""
NO_PRODUCTS = """      for (int e = 0; e < 4; ++e) s[e] = tt[e] = 0.f;
      const int ra = r0 + gq, kk = c0 + 2 * t4;"""
DA_MIX = """    for (int h1 = 0; h1 < H; ++h1)
#pragma unroll
      for (int h2 = 0; h2 < H; h2 += 4) {
        const float4 m4 = *reinterpret_cast<const float4*>(m_s + h1 * H + h2);"""
B_MIX = """    for (int h2 = 0; h2 < H; ++h2)
#pragma unroll
      for (int h1 = 0; h1 < H; h1 += 4) {
        const float4 m4 = *reinterpret_cast<const float4*>(mt_s + h2 * H + h1);"""
STEP3 = "    // ---- 3. warp w, heads w + NW hw: dk, dv, dq\n"
SHAPES = [(16, 48, 196), (16, 12, 784)]   # (heads, dh, N) of the classifier
BATCH = 64


def variants() -> dict[str, str]:
    src = (_build.CSRC / HEADER).read_text()
    for piece in (PRODUCTS, DA_MIX, B_MIX, STEP3):
        if src.count(piece) != 1:
            raise SystemExit(f"{HEADER} no longer holds once the piece a variant edits:\n{piece}")
    no_loop = lambda piece, var: piece.replace(f"{var} < H; ++{var}", f"{var} < 0; ++{var}", 1)
    return {"base": src, "noprod": src.replace(PRODUCTS, NO_PRODUCTS),
            "nomix": src.replace(DA_MIX, no_loop(DA_MIX, "h1")).replace(B_MIX, no_loop(B_MIX, "h2")),
            "nostep3": src.replace(STEP3, STEP3 + "    continue;\n")}


def build(name: str, header: str) -> Path:
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    (d / HEADER).write_text(header)
    lib = d / "lib.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(d / "flash_reattention_train.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return lib


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", help="comma-separated variants to build (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd16_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    jobs = variants()
    if args.only:
        jobs = {name: jobs[name] for name in args.only.split(",")}
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(jobs, pool.map(build, jobs, jobs.values())))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.vit_train_bwd.argtypes = [p] * 10 + [i, f] + [p] * 3 + [i] * 7 + [p, p]
        libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream
    for heads, dh, n in SHAPES:
        g = torch.Generator().manual_seed(0)
        rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).cuda()
        q = rnd(BATCH, heads, n, dh, scale=3 * dh ** -0.5).bfloat16()
        k = rnd(BATCH, heads, n, dh).bfloat16()
        v = rnd(BATCH, n, heads * dh).bfloat16()
        gout = rnd(BATCH, n, heads * dh).bfloat16()
        lse = torch.logsumexp(q.float() @ k.float().transpose(-1, -2), -1)
        d, m_eff = rnd(BATCH, heads, n), rnd(heads, heads, scale=heads ** -0.5)
        g_mat, kappa = rnd(heads, heads, scale=0.1), rnd(heads, scale=0.1)
        seed = torch.tensor([5], device="cuda")
        dq, dk = (torch.zeros(BATCH, heads, n, dh, device="cuda") for _ in range(2))
        dv = torch.empty(BATCH, n, heads * dh, device="cuda")
        for name, lib in libs.items():
            for rate in (0.0, 0.2):
                thr = keep_threshold(rate) if rate else 0
                call = lambda: lib.vit_train_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), gout.data_ptr(), lse.data_ptr(),
                    d.data_ptr(), m_eff.data_ptr(), g_mat.data_ptr(), kappa.data_ptr(),
                    seed.data_ptr() if thr else None, thr, 1.0 / (1.0 - rate), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), BATCH, heads, n, n, dh, 1, 1, None, stream)
                if call():
                    raise SystemExit(f"variant {name} failed to launch")
                print(f"H{heads} dh{dh} N{n} {name:8s} rate {rate}: {time_ms(call):.4f} ms",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
