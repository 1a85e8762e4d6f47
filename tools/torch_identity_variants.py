#!/usr/bin/env python3
"""Tile variants of the identity-mix routes, timed in turns on one NVIDIA GPU.

    python3 tools/torch_identity_variants.py

Builds, all in parallel into ``build/identity_variants/`` (ignored by git),
each from a copy of ``csrc/`` with one header edited:

* ``flash_reattention_train.cu`` as it is (``train_bk32``) and with
  ``attention_identity_tc.cuh`` walking keys in tiles of 64 (``train_bk64``):
  the training forward's identity route (route 2 of ``vit_train_fwd``) in
  tiles of half a 64-key dropout window (its keep bits kept in a register for
  the second half) or of a whole window (one block an SM);
* ``flash_reattention.cu`` as it is (``f32_warps8``) and with
  ``attention_identity_f32.cuh`` at 4 warps a block (``f32_warps4``): kernel
  1's float32 identity route (route 3) with blocks of 128 or 64 query rows.

Each pair is held against the plain version (bf16 2e-2, f32 1e-4 of
max|plain|; lse 1e-3 and 1e-5) and timed in turns (a, b, b, a; CUDA events,
20 calls after 3) at HViTUNetTF's keras classes (8, 192) and (4, 192), N 256,
batch 64, the training forward at dropout rate 0.2.  Prints the card's name
and power limit first, and each build's ptxas registers and spills.
"""
from __future__ import annotations

import ctypes
import importlib
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vit_unet_tpu_torch.kernels import _build  # noqa: E402

# the package exports kernel 1's function under its module's name
K1 = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
T = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")

OUT = ROOT / "build" / "identity_variants"
TRAIN_HEADER, F32_HEADER = "attention_identity_tc.cuh", "attention_identity_f32.cuh"
# header: the (piece, replacement) edits of its 64-key or 4-warp variant
EDITS = {
    TRAIN_HEADER: [("  using C = Cfg<192, 32>;", "  using C = Cfg<192, 64>;"),
                   ('  static_assert(BK == 32, "a tile is half a 64-key dropout window");\n', ""),
                   ('  static_assert(2 * (SMEM + 1024) <= 233472, "two blocks an SM");\n', ""),
                   ("__launch_bounds__(NT, 2) attend_kernel(",
                    "__launch_bounds__(NT, 1) attend_kernel(")],
    F32_HEADER: [("  using C = Cfg<192, 32, 8>;", "  using C = Cfg<192, 32, 4>;")],
}
VARIANTS = {  # name: (source, header edited or None)
    "train_bk32": ("flash_reattention_train.cu", None),
    "train_bk64": ("flash_reattention_train.cu", TRAIN_HEADER),
    "f32_warps8": ("flash_reattention.cu", None),
    "f32_warps4": ("flash_reattention.cu", F32_HEADER),
}
BATCH, N, RATE = 64, 256, 0.2


def edited(header: str) -> str:
    src = (_build.CSRC / header).read_text()
    for piece, new in EDITS[header]:
        if src.count(piece) != 1:
            raise SystemExit(f"{header} no longer holds once the piece a variant edits:\n{piece}")
        src = src.replace(piece, new)
    return src


def build(name: str) -> ctypes.CDLL:
    source, header = VARIANTS[name]
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    if header is not None:
        (d / header).write_text(edited(header))
    out = d / "lib.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-o", str(out), str(d / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    kernel = "attend_kernel" if name.startswith("train") else "attend_f32_kernel"
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x]
            print(f"  {name}: {line.split()[-1][:60]} ... {'; '.join(info)}")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(out))
    if name.startswith("train"):
        lib.vit_train_fwd.argtypes = [p] * 7 + [i, f] + [p] * 3 + [i] * 7 + [p]
    else:
        lib.vit_flash_reattention.argtypes = [p] * 10 + [i] * 8 + [p]
    return lib


def time_ms(fn, reps=20, warmup=3) -> float:
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


def rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def inputs(heads, dtype):
    g = torch.Generator().manual_seed(heads)
    q = torch.randn(BATCH, heads, N, 192, generator=g) * 3 * 192 ** -0.5
    k = torch.randn(BATCH, heads, N, 192, generator=g)
    v = torch.randn(BATCH, N, heads * 192, generator=g)
    return [t.to("cuda", dtype) for t in (q, k, v)]


def train_call(lib, q, k, v, seed, out, lse):
    heads = q.shape[1]
    rc = lib.vit_train_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None,
                           seed.data_ptr(), T.keep_threshold(RATE), T._keep_scale(RATE),
                           lse.data_ptr(), None, out.data_ptr(), BATCH, heads, N, N, 192, 1,
                           T.FWD_ROUTES.index("identity_tc"),
                           torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"vit_train_fwd failed: {rc}")


def eval_call(lib, q, k, v, out, lse):
    heads = q.shape[1]
    rc = lib.vit_flash_reattention(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                                   None, None, None, lse.data_ptr(), out.data_ptr(), BATCH,
                                   heads, N, N, 192, 0, K1.ROUTES.index("identity_f32"), 3,
                                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"vit_flash_reattention failed: {rc}")


def in_turns(label, libs, call, plain, tols):
    """``call(lib, out, lse)`` for the two libraries, held against ``plain``
    (out, lse) and timed a, b, b, a."""
    res = {}
    for name, lib in libs.items():
        out, lse = torch.empty_like(plain[0]), torch.empty_like(plain[1])
        call(lib, out, lse)
        torch.cuda.synchronize()
        errs = (rel(out, plain[0]), (lse - plain[1]).abs().max().item())
        if not (errs[0] <= tols[0] and errs[1] <= tols[1]):
            raise AssertionError(f"{label} {name}: out rel {errs[0]:.2e}, lse abs {errs[1]:.2e}")
        res[name] = (out, lse, errs)
    a, b = libs
    turns = [(n, time_ms(lambda: call(libs[n], *res[n][:2]))) for n in (a, b, b, a)]
    print(f"  {label}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in turns) + "; "
          + ", ".join(f"{n} out rel {res[n][2][0]:.2e} lse {res[n][2][1]:.2e}" for n in libs))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_identity_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    seed = torch.tensor([1234], dtype=torch.int64, device="cuda")
    for heads in (8, 4):
        q, k, v = inputs(heads, torch.bfloat16)
        plain = T.train_fwd_identity_plain(q, k, v, seed, RATE)
        in_turns(f"train fwd identity H{heads} dh192 N{N} B{BATCH} rate {RATE}",
                 {n: libs[n] for n in ("train_bk32", "train_bk64")},
                 lambda lib, out, lse: train_call(lib, q, k, v, seed, out, lse), plain,
                 (2e-2, 1e-3))
        qf, kf, vf = inputs(heads, torch.float32)
        eye = torch.eye(heads, device="cuda")
        w, b = K1.expand_reattention_affine(eye, torch.zeros(heads, device="cuda"), dh=192)
        want = K1.flash_reattention_plain(qf, kf, vf, w, b, num_heads=heads)
        want_lse = torch.logsumexp(qf @ kf.transpose(-1, -2), -1)
        in_turns(f"eval identity f32 H{heads} dh192 N{N} B{BATCH}",
                 {n: libs[n] for n in ("f32_warps8", "f32_warps4")},
                 lambda lib, out, lse: eval_call(lib, qf, kf, vf, out, lse), (want, want_lse),
                 (1e-4, 1e-5 * max(1.0, want_lse.abs().max().item())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
