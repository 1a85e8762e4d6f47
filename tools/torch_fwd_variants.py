#!/usr/bin/env python3
"""Where the two training forwards' tensor-core routes spend their time, on
one NVIDIA GPU.

    python3 tools/torch_fwd_variants.py [--parent DIR] [--only NAME,...] [--lite]
                                        [--head16] [--twin NAME] [--routes 1,0]

Builds ``flash_reattention_train.cu`` once per variant, all in parallel, into
``build/fwd_variants/`` (ignored by git), each with an edited copy of
``reattention_bnfwd_tc.cuh``, and times the exact-BN forward (``vit_bn_fwd``)
and the frozen-BN forward (``vit_train_fwd``) on their tensor-core routes at
base's three level shapes (``--lite``: at lite's, 4 heads; ``--head16``: at
the classifier's two, 16 heads, with ``reattention_bnfwd16_tc.cuh`` edited
instead), batch 64, bf16,
dropout rate 0 and 0.2 (CUDA events, 20 calls after 3).  ``--routes``: the
C routes timed, 1 the tensor cores (the default), 0 the CUDA cores (the
variants share it; timed once, as ``cuda_core``).  The variants:

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
  sweep reading it (the source takes it in the sweep);
* ``pc64``: lite's (4, 192) class in 64-column chunks (the source: 128),
  so that the frozen forward's exchange fits the score region.

With ``--head16`` the variants are the 16-head header's:

* ``base``: the source as it is;
* ``twopass16``: the (16, 12) class with kernel 1's log-sum-exp pass first
  and the sweep reading it (the source takes it in the sweep).

With ``--parent DIR`` (a copy of an earlier ``kernels/csrc``), that source
is built too as ``parent`` and its exact-BN forward (with ``--head16`` both
forwards) timed beside the others in the same process, and held bit for bit
against the outputs of the variant ``--twin`` names (``base`` unless
given).  Only ``base``, ``twopass16`` and ``parent`` compute the functions;
the others exist to be timed.  Prints the card's name and power limit
first.
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
LITE12 = "VIT_BNFWD(4, 12, 64, 48, MIX, 16, 2, true)"
TWOPASS12 = ("{ rc = VIT_BNFWD_LSE(4, 12, 32, 64, 4, 2, 2); "
             "return rc ? rc : VIT_BNFWD(4, 12, 64, 48, MIX, 16, 2); }")
LITE192 = "VIT_BNFWD(4, 192, 256, 128, MIX, 32, 1)"
SHAPES = [(8, 24, 784), (8, 96, 196), (8, 384, 49)]   # (heads, dh, N) of base
LITE_SHAPES = [(4, 12, 3136), (4, 48, 784), (4, 192, 196)]
HEADER16 = "reattention_bnfwd16_tc.cuh"
ONLINE16 = """  if (dh == 12)
    return launch<Cfg<12, MIX, true>>(q, k, v, seed, thr, scale, lse, onorm, srow, crow, vsum,
                                      m_eff, c_eff, out, batch, nq, nk, stream);
"""
TWOPASS16 = """  if (dh == 12) {
    rc = vit_tc::launch_lse<vit_tc::Cfg<16, 12, 32, 32, 8, 2, 1>>(q, k, lse, batch, nq, nk,
                                                                   stream);
    return rc ? rc : launch<Cfg<12, MIX>>(q, k, v, seed, thr, scale, lse, onorm, srow, crow,
                                          vsum, m_eff, c_eff, out, batch, nq, nk, stream);
  }
"""
HEAD16_SHAPES = [(16, 12, 784), (16, 48, 196)]
BATCH = 64


def variants16() -> dict[str, tuple[str, str]]:
    src = (_build.CSRC / HEADER16).read_text()
    if ONLINE16 not in src:
        raise SystemExit(f"{HEADER16} no longer holds the piece a variant edits:\n{ONLINE16}")
    return {"base": (HEADER16, src), "twopass16": (HEADER16, src.replace(ONLINE16, TWOPASS16))}


def variants() -> dict[str, tuple[str, str]]:
    src = (_build.CSRC / HEADER).read_text()
    for piece in (PRODUCT, C_PRODUCTS, SWEEP, OWN_LSE, MIX_BODY, LITE12, LITE192):
        if piece not in src:
            raise SystemExit(f"{HEADER} no longer holds the piece a variant edits:\n{piece}")
    edited = {"base": src, "noprod": src.replace(PRODUCT, ""),
              "noC": src.replace(C_PRODUCTS, ";"),
              "lseonly": src.replace(SWEEP, "  0"),
              "passlse": src.replace(OWN_LSE, "{ return false; }"),
              "nomix": src.replace(MIX_BODY, "  return;\n" + MIX_BODY),
              "minb1": src.replace(LITE12, LITE12.replace("16, 2,", "16, 1,")),
              "minb3": src.replace(LITE12, LITE12.replace("16, 2,", "16, 3,")),
              "twopass": src.replace("return " + LITE12 + ";", TWOPASS12),
              "pc64": src.replace(LITE192, LITE192.replace("128", "64"))}
    return {name: (HEADER, text) for name, text in edited.items()}


def build(name: str, csrc: Path, header: tuple[str, str] | None) -> Path:
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    if header is not None:
        (d / header[0]).write_text(header[1])
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
    parser.add_argument("--lite", action="store_true", help="lite's shapes (4 heads)")
    parser.add_argument("--head16", action="store_true",
                        help="the classifier's shapes (16 heads) and the 16-head header")
    parser.add_argument("--twin", default="base",
                        help="the variant whose outputs the parent's must equal")
    parser.add_argument("--routes", default="1",
                        help="comma-separated C routes to time: 1 tensor cores, 0 CUDA cores")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    table = variants16() if args.head16 else variants()
    jobs = {name: (_build.CSRC, src) for name, src in table.items()}
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
    routes = [int(r) for r in args.routes.split(",")]
    # the CUDA-core route is the same in every variant: timed on the first
    runs = [(name, lib, 1) for name, lib in libs.items() if 1 in routes]
    if 0 in routes:
        runs.append(("cuda_core", next(iter(libs.values())), 0))
    for heads, dh, n in (HEAD16_SHAPES if args.head16 else LITE_SHAPES if args.lite
                         else SHAPES):
        g = torch.Generator().manual_seed(0)
        q = (torch.randn(BATCH, heads, n, dh, generator=g) * 3 * dh ** -0.5).cuda().bfloat16()
        k = torch.randn(BATCH, heads, n, dh, generator=g).cuda().bfloat16()
        v = torch.randn(BATCH, n, heads * dh, generator=g).cuda().bfloat16()
        vsum = v.float().sum(1)
        m_eff = (torch.randn(heads, heads, generator=g) * heads ** -0.5).cuda()
        c_eff = (torch.randn(heads, generator=g) * 0.1).cuda()
        seed = torch.tensor([5], device="cuda")
        outs = {}
        for name, lib, route in runs:
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
                    ptr["onorm"], ptr["srow"], ptr["crow"], BATCH, heads, n, n, dh, 1, route,
                    stream)}
                if name != "parent" or args.head16:
                    calls["fwd"] = lambda: lib.vit_train_fwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), vsum.data_ptr(),
                        m_eff.data_ptr(), c_eff.data_ptr(), sd, thr, scale, ptr["lse"],
                        ptr["onorm"], ptr["out"], BATCH, heads, n, n, dh, 1, route, stream)
                for kname, call in calls.items():
                    if call():
                        raise SystemExit(f"variant {name} {kname} failed to launch")
                    if name in (args.twin, "parent"):
                        torch.cuda.synchronize()
                        keys = (("srow", "crow", "lse", "onorm") if kname == "bn_fwd"
                                else ("out", "lse", "onorm"))
                        outs[name, kname, rate] = [bufs[key].clone() for key in keys]
                    print(f"N{n} dh{dh} {name:8s} {kname:6s} rate {rate}: "
                          f"{time_ms(call):.4f} ms", flush=True)
        for rate in (0.0, 0.2):
            for kname, what in (("bn_fwd", "exact-BN S, C, lse, o_norm"),
                                ("fwd", "frozen-BN out, lse, o_norm")):
                if ("parent", kname, rate) not in outs:
                    continue
                same = all(torch.equal(a, b) for a, b in zip(outs[args.twin, kname, rate],
                                                             outs["parent", kname, rate]))
                print(f"N{n} dh{dh} rate {rate}: {what} of {args.twin} and parent "
                      f"{'bit-identical' if same else 'DIFFER'}")
                if not same:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
