#!/usr/bin/env python3
"""Where the two training forwards' tensor-core routes spend their time, on
one NVIDIA GPU.

    python3 tools/torch_fwd_variants.py [--parent DIR] [--only NAME,...] [--lite]

Builds ``flash_reattention_train.cu`` once per variant, all in parallel, into
``build/fwd_variants/`` (ignored by git), each with an edited copy of
``reattention_bnfwd_tc.cuh``, and times the exact-BN forward (``vit_bn_fwd``)
and the frozen-BN forward (``vit_train_fwd``) on their tensor-core routes at
base's three level shapes (``--lite``: the exact-BN forward alone at lite's,
4 heads), batch 64, bf16, dropout rate 0 and 0.2 (CUDA events, 20 calls
after 3):

* ``base``: the source as it is;
* ``noprod``: without step 3 of the register form (o_norm += A V_cat);
* ``noC``: without the products of C (exact BN only);
* ``lseonly``: the log-sum-exp pass alone (where the frozen forward takes
  its own, at most 64 keys, nothing);
* ``passlse``: the frozen forward always takes the log-sum-exp pass;
* ``nomix``: the frozen forward without its head mix (``out`` unwritten);
* ``minb1``, ``minb3``: lite's (4, 12) class at one or three blocks an SM
  (the source: two);
* ``twopass``: lite's (4, 12) class with the log-sum-exp pass first and the
  sweep reading it (the source takes it in the sweep).

With ``--parent DIR`` (a copy of an earlier ``kernels/csrc``), that source
is built too as ``parent`` and its exact-BN forward timed beside the others
in the same process, and held bit for bit against ``base``'s outputs.  Only
``base`` and ``parent`` compute the functions; the others exist to be
timed.  Prints the card's name and power limit first.
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

OUT = ROOT / "build" / "fwd_variants"
HEADER = "reattention_bnfwd_tc.cuh"
PRODUCT = """#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) product_step<C>(as, vbuf, kk, wh, wcol, lane, acc);
"""
C_PRODUCTS = "      for (int j = 0; j < 4; ++j) cacc[p] = fmaf(a[h2][j], a[h3][j], cacc[p]);"
SWEEP = ("  launch<Cfg<__VA_ARGS__>>(q, k, v, seed, thr, scale, lse, onorm, o, batch, nq, nk, "
         "stream)")
OWN_LSE = "{ return mix && nk <= KT; }"
MIX_BODY = "  constexpr int H = C::H, LDX = C::LDX, NQD = C::PC / 4;   // column quads of a row\n"
LITE12 = "VIT_BNFWD(4, 12, 64, 48, false, 16, 2, true)"
TWOPASS12 = ("{ rc = VIT_BNFWD_LSE(4, 12, 32, 64, 4, 2, 2); "
             "return rc ? rc : VIT_BNFWD(4, 12, 64, 48, false, 16, 2); }")
SHAPES = [(8, 24, 784), (8, 96, 196), (8, 384, 49)]   # (heads, dh, N) of base
LITE_SHAPES = [(4, 12, 3136), (4, 48, 784), (4, 192, 196)]
BATCH = 64


def variants() -> dict[str, str]:
    src = (_build.CSRC / HEADER).read_text()
    for piece in (PRODUCT, C_PRODUCTS, SWEEP, OWN_LSE, MIX_BODY, LITE12):
        if piece not in src:
            raise SystemExit(f"{HEADER} no longer holds the piece a variant edits:\n{piece}")
    return {"base": src, "noprod": src.replace(PRODUCT, ""),
            "noC": src.replace(C_PRODUCTS, ";"),
            "lseonly": src.replace(SWEEP, "  0"),
            "passlse": src.replace(OWN_LSE, "{ return false; }"),
            "nomix": src.replace(MIX_BODY, "  return;\n" + MIX_BODY),
            "minb1": src.replace(LITE12, LITE12.replace("16, 2,", "16, 1,")),
            "minb3": src.replace(LITE12, LITE12.replace("16, 2,", "16, 3,")),
            "twopass": src.replace("return " + LITE12 + ";", TWOPASS12)}


def build(name: str, csrc: Path, header: str | None) -> Path:
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    if header is not None:
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
    parser.add_argument("--parent", type=Path, help="an earlier kernels/csrc to build beside")
    parser.add_argument("--only", help="comma-separated variants to build (default: all)")
    parser.add_argument("--lite", action="store_true",
                        help="lite's shapes (4 heads), the exact-BN forward alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    jobs = {name: (_build.CSRC, src) for name, src in variants().items()}
    if args.only:
        jobs = {name: jobs[name] for name in args.only.split(",")}
    if args.parent:
        jobs["parent"] = (args.parent, None)
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(jobs, pool.map(build, jobs, *zip(*jobs.values()))))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.vit_bn_fwd.argtypes = [p] * 4 + [i, f] + [p] * 4 + [i] * 7 + [p]
        lib.vit_train_fwd.argtypes = [p] * 7 + [i, f] + [p] * 3 + [i] * 7 + [p]
        libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream
    for heads, dh, n in LITE_SHAPES if args.lite else SHAPES:
        g = torch.Generator().manual_seed(0)
        q = (torch.randn(BATCH, heads, n, dh, generator=g) * 3 * dh ** -0.5).cuda().bfloat16()
        k = torch.randn(BATCH, heads, n, dh, generator=g).cuda().bfloat16()
        v = torch.randn(BATCH, n, heads * dh, generator=g).cuda().bfloat16()
        vsum = v.float().sum(1)
        m_eff = (torch.randn(heads, heads, generator=g) * heads ** -0.5).cuda()
        c_eff = (torch.randn(heads, generator=g) * 0.1).cuda()
        seed = torch.tensor([5], device="cuda")
        outs = {}
        for name, lib in libs.items():
            bufs = dict(lse=torch.empty(BATCH, heads, n, device="cuda"),
                        srow=torch.empty(BATCH, heads, n, device="cuda"),
                        crow=torch.empty(BATCH, heads, heads, n, device="cuda"),
                        onorm=torch.empty(BATCH, heads, n, heads * dh, device="cuda",
                                          dtype=torch.bfloat16),
                        out=torch.empty(BATCH, n, heads * dh, device="cuda",
                                        dtype=torch.bfloat16))
            ptr = {key: t.data_ptr() for key, t in bufs.items()}
            for rate in (0.0, 0.2):
                thr = keep_threshold(rate) if rate else 0
                scale = 1.0 / (1.0 - rate)
                sd = seed.data_ptr() if thr else None
                calls = {"bn_fwd": lambda: lib.vit_bn_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), sd, thr, scale, ptr["lse"],
                    ptr["onorm"], ptr["srow"], ptr["crow"], BATCH, heads, n, n, dh, 1, 1,
                    stream)}
                if name != "parent" and not args.lite:
                    calls["fwd"] = lambda: lib.vit_train_fwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), vsum.data_ptr(),
                        m_eff.data_ptr(), c_eff.data_ptr(), sd, thr, scale, ptr["lse"],
                        ptr["onorm"], ptr["out"], BATCH, heads, n, n, dh, 1, 1, stream)
                for kname, call in calls.items():
                    if call():
                        raise SystemExit(f"variant {name} {kname} failed to launch")
                    if kname == "bn_fwd" and name in ("base", "parent"):
                        torch.cuda.synchronize()
                        outs[name, rate] = [bufs[key].clone()
                                            for key in ("srow", "crow", "lse", "onorm")]
                    print(f"N{n} dh{dh} {name:8s} {kname:6s} rate {rate}: "
                          f"{time_ms(call):.4f} ms", flush=True)
        for rate in (0.0, 0.2):
            if ("parent", rate) in outs:
                same = all(torch.equal(a, b) for a, b in zip(outs["base", rate],
                                                             outs["parent", rate]))
                print(f"N{n} dh{dh} rate {rate}: exact-BN S, C, lse, o_norm of base and "
                      f"parent {'bit-identical' if same else 'DIFFER'}")
                if not same:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
