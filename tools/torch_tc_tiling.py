#!/usr/bin/env python3
"""Tile configurations of the eval kernel's tensor-core route at one shape
class, timed against each other on one NVIDIA GPU.

    python3 tools/torch_tc_tiling.py [--heads 8 --dh 192 --n 256 --batch 64]
                                     [--variants BQ,BK,HG,NSTAGE,MINB;...]

Builds ``flash_reattention.cu`` once per variant, all in parallel, into
``build/tc_tiling/`` (ignored by git), each with the class's
``VIT_TC_CASE(heads, dh, ...)`` line of ``vit_tc::dispatch`` set to the
variant's BQ, BK, HG, NSTAGE and blocks per SM (``Cfg`` in
``reattention_tc.cuh``; a variant the header's ``static_assert``s refuse
fails to build and is reported so).  Then, on bf16 inputs of the class at
batch ``--batch`` and N ``--n`` with a random head mix, each variant's
route is held against ``flash_reattention_plain`` (max|err| / max|plain|
within 2e-2) and timed: the whole call and each pass alone (CUDA events,
20 calls after 3), every variant in order and then in reverse order, the
faster turn kept; the CUDA-core route and the plain version beside them.
ptxas's registers and spills of the class's two kernels are printed per
variant.  Prints the card's name and power limit first.
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
from vit_unet_tpu_torch.kernels.flash_reattention import (  # noqa: E402
    expand_reattention_affine, flash_reattention_plain)

OUT = ROOT / "build" / "tc_tiling"
SOURCE = "flash_reattention.cu"
# BQ, BK, HG, NSTAGE, blocks per SM
DEFAULT_VARIANTS = ("16,32,2,2,1;16,32,4,2,1;16,32,2,3,1;16,64,2,2,1;16,16,4,2,2;16,16,4,2,1;"
                    "16,16,8,2,1")
TOL = 2e-2


def build(name: str, heads: int, dh: int, tiling: str) -> tuple[Path | None, str]:
    """A copy of csrc/ with the class's case set to ``tiling``: (library or
    None, ptxas lines of the class's kernels or nvcc's error)."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    src = (d / SOURCE).read_text()
    case = re.compile(rf"VIT_TC_CASE\({heads}, {dh}, [^)]*\)")
    if len(case.findall(src)) != 1:
        raise SystemExit(f"{SOURCE} has no single VIT_TC_CASE({heads}, {dh}, ...) line")
    (d / SOURCE).write_text(case.sub(f"VIT_TC_CASE({heads}, {dh}, {tiling}, false)", src))
    lib = d / "lib.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-o",
                           str(lib), str(d / SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        return None, proc.stderr[-2000:]
    # ptxas: "Compiling entry function '<mangled>'" ... "Used N registers, ..."
    mark, lines, kernel = f"CfgILi{heads}ELi{dh}E", [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            kernel = line if mark in line and "vit_tc" in line else None
        elif kernel and ("Used" in line or "spill" in line):
            kind = "lse" if "lse_kernel" in kernel else "out"
            lines.append(f"{kind}: {line.split(':', 1)[-1].strip()}")
    return lib, "; ".join(lines)


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
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--dh", type=int, default=192)
    parser.add_argument("--n", type=int, default=256)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--variants", default=DEFAULT_VARIANTS,
                        help="';'-separated BQ,BK,HG,NSTAGE,MINB")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_tc_tiling: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    heads, dh, n, batch = args.heads, args.dh, args.n, args.batch
    tilings = [t.strip() for t in args.variants.split(";") if t.strip()]
    names = ["v" + t.replace(",", "_") for t in tilings]
    with ThreadPoolExecutor(len(tilings)) as pool:
        built = dict(zip(names, pool.map(lambda a: build(*a),
                                         [(nm, heads, dh, t) for nm, t in zip(names, tilings)])))
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, (path, info) in built.items():
        print(f"{name}: {'built; ' + info if path else 'did not build: ' + info}")
        if path:
            lib = ctypes.CDLL(str(path))
            lib.vit_flash_reattention.argtypes = [p] * 7 + [i] * 8 + [p]
            libs[name] = lib
    if not libs:
        return 1

    g = torch.Generator().manual_seed(0)
    q = (torch.randn(batch, heads, n, dh, generator=g) * dh ** -0.5).cuda().bfloat16()
    k = torch.randn(batch, heads, n, dh, generator=g).cuda().bfloat16()
    v = torch.randn(batch, n, heads * dh, generator=g).cuda().bfloat16()
    w, b = expand_reattention_affine(torch.randn(heads, heads, generator=g) * heads ** -0.5,
                                     torch.randn(heads, generator=g) * 0.1, dh=dh)
    w, b = w.cuda(), b.cuda()
    lse = torch.empty(batch, heads, n, device="cuda")
    out = torch.empty(batch, n, heads * dh, device="cuda", dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    want = flash_reattention_plain(q, k, v, w, b, num_heads=heads).float()

    def call(lib, route, passes):
        return lambda: lib.vit_flash_reattention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), b.data_ptr(),
            lse.data_ptr(), out.data_ptr(), batch, heads, n, n, dh, 1, route, passes, stream)

    ok = {}
    for name, lib in libs.items():
        out.zero_()
        rc = call(lib, 1, 3)()
        torch.cuda.synchronize()
        rel = ((out.float() - want).abs().max() / want.abs().max()).item()
        ok[name] = rc == 0 and rel <= TOL
        print(f"{name}: launch rc {rc}, rel err {rel:.3e} against plain "
              f"({'ok' if ok[name] else 'FAILED'})")
    order = [nm for nm in libs if ok[nm]]
    times: dict[tuple[str, int], list[float]] = {}
    for name in order + order[::-1]:
        for passes in (3, 1, 2):
            times.setdefault((name, passes), []).append(time_ms(call(libs[name], 1, passes)))
    first = next(iter(libs.values()))
    core = min(time_ms(call(first, 0, 3)) for _ in range(2))
    plain = time_ms(lambda: flash_reattention_plain(q, k, v, w, b, num_heads=heads), 5, 1)
    print(f"B{batch} H{heads} dh{dh} N{n} bf16: cuda_core route {core:.4f} ms, plain "
          f"{plain:.4f} ms")
    for name in order:
        t = {ps: min(times[name, ps]) for ps in (3, 1, 2)}
        print(f"{name}: call {t[3]:.4f} ms (turns "
              + ", ".join(f"{x:.4f}" for x in times[name, 3])
              + f"), lse pass {t[1]:.4f}, output pass {t[2]:.4f}; "
              f"cuda_core / this {core / t[3]:.2f}x")
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
