#!/usr/bin/env python3
"""Tile variants of kernel 3's float32 tensor-core route (``train_bwd_tc_f32``
in ``reattention_bwd_tc.cuh``) at lite's classes, on one NVIDIA GPU.

    python3 tools/torch_bwd_f32_tiling.py [--only NAME,...]

Builds ``flash_reattention_train.cu`` once per variant, all in parallel, into
``build/bwd_f32_tiling/`` (ignored by git), each from a copy of ``csrc/``
with one class's ``VIT_BWD_F32(DH, BKEY, BQ, MINB, TRIPLE)`` dispatch line
rewritten, and prints ptxas's registers and spill stores of each build's
f32 kernels.  Then, at lite's three levels at b64, f32, rate 0.2, the BN
term on: each variant's dq, dk, dv on the first 8 images against the plain
version (max|err| / max|plain|; ``base``, the source as it is, must be
within 1e-4, a variant's is printed), and its time a call against ``base``
in turns (base, variant, variant, base; CUDA events, 10 calls after 2).
Prints the card's name and power limit first.  ``*_pairs`` variants carry
q and K as pairs (three MMAs for the scores) where ``base`` has triples.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vit_unet_tpu_torch.kernels import _build  # noqa: E402
from vit_unet_tpu_torch.kernels import flash_reattention_train as T  # noqa: E402

OUT = ROOT / "build" / "bwd_f32_tiling"
HEADER = "reattention_bwd_tc.cuh"
LINE = re.compile(r"(if \(heads == 4 && dh == (\d+)\) return VIT_BWD_F32\(\d+), [^)]*\);")
VARIANTS = {  # name: (dh, "BKEY, BQ, MINB, TRIPLE") of the rewritten class
    "base": None,
    "12_pairs": (12, "64, 16, 2, false"),
    "12_bq32": (12, "64, 32, 1, true"),
    "48_pairs": (48, "64, 16, 1, false"),
    "48_bkey32_bq32": (48, "32, 32, 1, true"),
}
LEVELS = [(12, 3136), (48, 784), (192, 196)]   # lite's (dh, N), 4 heads
BATCH, HEADS, RATE, SLICE = 64, 4, 0.2, 8


def header(variant) -> str:
    src = (_build.CSRC / HEADER).read_text()
    found = {int(m.group(2)) for m in LINE.finditer(src)}
    if found != {dh for dh, _ in LEVELS}:
        raise SystemExit(f"{HEADER}: the f32 dispatch lines found are for dh {sorted(found)}")
    if variant is None:
        return src
    dh, tiles = variant
    return LINE.sub(lambda m: f"{m.group(1)}, {tiles});" if int(m.group(2)) == dh
                    else m.group(0), src)


def build(name: str) -> tuple[Path, str]:
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    (d / HEADER).write_text(header(VARIANTS[name]))
    lib = d / "lib.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-o", str(lib),
                           str(d / "flash_reattention_train.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return lib, proc.stderr


def f32_kernels(ptxas: str) -> list[str]:
    """'(dh, BKEY, BQ, MINB, TRIPLE): N registers, S B spill stores' of each
    f32 ``bwd_kernel`` in ptxas's output."""
    out, cfg, spill = [], None, None
    for line in ptxas.splitlines():
        m = re.search(r"bwd_kernelINS_3CfgILi4ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb1ELb(\d)E",
                      line)
        if "Compiling entry" in line:
            cfg = m.groups() if m else None
        elif cfg and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif cfg and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"({', '.join(cfg)}): {regs} registers, {spill} B spill stores")
            cfg = None
    return out


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
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
    parser.add_argument("--only", help="comma-separated variants besides base (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd_f32_tiling: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    names = ["base"] + ([n for n in args.only.split(",") if n != "base"] if args.only
                        else [n for n in VARIANTS if n != "base"])
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, (path, ptxas) in built.items():
        lib = ctypes.CDLL(str(path))
        lib.vit_train_bwd.argtypes = [p] * 10 + [i, f] + [p] * 3 + [i] * 7 + [p, p]
        libs[name] = lib
        print(f"{name}: " + "; ".join(f32_kernels(ptxas)), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    route = T.BWD_ROUTES.index(T.F32_TC_ROUTE)
    for dh, n in LEVELS:
        g = torch.Generator().manual_seed(dh)
        rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).cuda()
        q = rnd(BATCH, HEADS, n, dh, scale=3 * dh ** -0.5)
        k, v, gout = rnd(BATCH, HEADS, n, dh), rnd(BATCH, n, HEADS * dh), rnd(BATCH, n, HEADS * dh)
        lse = torch.cat([torch.logsumexp(a @ b.transpose(-1, -2), -1)
                         for a, b in zip(q.split(SLICE), k.split(SLICE))])
        d, m_eff = rnd(BATCH, HEADS, n), rnd(HEADS, HEADS, scale=HEADS ** -0.5)
        g_mat, kappa = rnd(HEADS, HEADS, scale=0.1), rnd(HEADS, scale=0.1)
        seed = torch.tensor([5], device="cuda")
        want = T.train_bwd_plain(q[:SLICE], k[:SLICE], v[:SLICE], lse[:SLICE], gout[:SLICE],
                                 m_eff, d[:SLICE], seed, RATE, (g_mat, kappa))
        out = [torch.zeros(BATCH, HEADS, n, dh, device="cuda"),
               torch.zeros(BATCH, HEADS, n, dh, device="cuda"),
               torch.empty(BATCH, n, HEADS * dh, device="cuda")]

        def call(lib):
            out[0].zero_()
            rc = lib.vit_train_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), gout.data_ptr(), lse.data_ptr(),
                d.data_ptr(), m_eff.data_ptr(), g_mat.data_ptr(), kappa.data_ptr(),
                seed.data_ptr(), T.keep_threshold(RATE), 1.0 / (1.0 - RATE), out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), BATCH, HEADS, n, n, dh, 0, route, None,
                stream)
            if rc:
                raise SystemExit(f"a variant failed to launch at dh {dh}: error {rc}")

        for name in names:
            if name != "base" and VARIANTS[name][0] != dh:
                continue
            call(libs[name])
            torch.cuda.synchronize()
            rel = max(((a[:SLICE] - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(out, want))
            if name == "base" and not rel <= 1e-4:
                raise SystemExit(f"base at dh {dh}: rel {rel:.2e} against plain")
            if name == "base":
                print(f"H4 dh{dh} N{n} B{BATCH} f32 base: rel {rel:.2e} against plain "
                      f"(first {SLICE} images)", flush=True)
                continue
            turns = [(who, time_ms(lambda: call(libs[who])))
                     for who in ("base", name, name, "base")]
            print(f"H4 dh{dh} N{n} B{BATCH} f32 {name}: rel {rel:.2e} against plain; in "
                  "turns " + ", ".join(f"{w} {t:.4f} ms" for w, t in turns), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
