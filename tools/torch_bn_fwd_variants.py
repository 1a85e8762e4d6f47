#!/usr/bin/env python3
"""Where the exact-BN forward's tensor-core route spends its time, on one
NVIDIA GPU.

    python3 tools/torch_bn_fwd_variants.py

Builds ``flash_reattention_train.cu`` four times in parallel into
``build/bn_fwd_variants/`` (ignored by git), each with an edited copy of
``reattention_bnfwd_tc.cuh``, and times ``vit_bn_fwd`` on its tensor-core
route at base's three level shapes, batch 64, bf16, dropout rate 0 and 0.2
(CUDA events, 20 calls after 3):

* ``base``: the source as it is;
* ``noprod``: without step 3 of the register form (o_norm += A V_cat);
* ``noC``: without the products of C;
* ``lseonly``: the log-sum-exp pass alone.

Only ``base`` computes the function; the others exist to be timed.  Prints
the card's name and power limit first.
"""
from __future__ import annotations

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

OUT = ROOT / "build" / "bn_fwd_variants"
HEADER = "reattention_bnfwd_tc.cuh"
PRODUCT = """      if constexpr (C::RES) {
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) product_step<C>(as, vbuf, kk, warp, lane, acc);
      }"""
C_PRODUCTS = "      for (int j = 0; j < 4; ++j) cacc[p] = fmaf(a[h2][j], a[h3][j], cacc[p]);"
AFTER_LSE = "  if (rc) return rc;\n#define VIT_BNFWD"
SHAPES = [(8, 24, 784), (8, 96, 196), (8, 384, 49)]   # (heads, dh, N) of base
BATCH = 64


def variants() -> dict[str, str]:
    src = (_build.CSRC / HEADER).read_text()
    for piece in (PRODUCT, C_PRODUCTS, AFTER_LSE):
        if piece not in src:
            raise SystemExit(f"{HEADER} no longer holds the piece a variant edits:\n{piece}")
    return {"base": src, "noprod": src.replace(PRODUCT, ""),
            "noC": src.replace(C_PRODUCTS, ";"),
            "lseonly": src.replace(AFTER_LSE, "  return rc;\n#define VIT_BNFWD")}


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
    if not torch.cuda.is_available():
        print("torch_bn_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    srcs = variants()
    with ThreadPoolExecutor(len(srcs)) as pool:
        paths = dict(zip(srcs, pool.map(build, srcs, srcs.values())))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.vit_bn_fwd.argtypes = [p] * 4 + [i, f] + [p] * 4 + [i] * 7 + [p]
        libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream
    for heads, dh, n in SHAPES:
        g = torch.Generator().manual_seed(0)
        q = (torch.randn(BATCH, heads, n, dh, generator=g) * 3 * dh ** -0.5).cuda().bfloat16()
        k = torch.randn(BATCH, heads, n, dh, generator=g).cuda().bfloat16()
        v = torch.randn(BATCH, n, heads * dh, generator=g).cuda().bfloat16()
        seed = torch.tensor([5], device="cuda")
        lse = torch.empty(BATCH, heads, n, device="cuda")
        srow = torch.empty(BATCH, heads, n, device="cuda")
        crow = torch.empty(BATCH, heads, heads, n, device="cuda")
        onorm = torch.empty(BATCH, heads, n, heads * dh, device="cuda", dtype=torch.bfloat16)
        for name, lib in libs.items():
            for rate in (0.0, 0.2):
                thr = keep_threshold(rate) if rate else 0
                scale = 1.0 / (1.0 - rate)
                call = lambda: lib.vit_bn_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), seed.data_ptr() if thr else None,
                    thr, scale, lse.data_ptr(), onorm.data_ptr(), srow.data_ptr(),
                    crow.data_ptr(), BATCH, heads, n, n, dh, 1, 1, stream)
                if call():
                    raise SystemExit(f"variant {name} failed to launch")
                print(f"N{n} dh{dh} {name:8s} rate {rate}: {time_ms(call):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
