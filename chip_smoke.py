#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # everything, with the result lines
    python3 chip_smoke.py --phases 2a      # phase 1 and the named phases only
                                           # (2a, 2b, 3, 4; no result lines)

Phases, each of which raises (exit code != 0) when it fails:

1. environment: card name and power limit, CUDA and nvcc versions; builds
   every kernel source of the port from ``vit_unet_tpu_torch/kernels/csrc``,
   one nvcc per source, all started together;
2. every kernel against its plain PyTorch version on the card, at the
   level shapes of the lite and base presets, in float32 (TF32 off) and
   bfloat16, with times and the least time the card could take (``bound``):
   the eval kernel (2a: also one rectangular and two 16-head cases, a
   peaked map, a handful of keys and a single query; each on the route
   ``kernel_route`` names, float32 on the CUDA cores, bfloat16 on the tensor
   cores; at the main path's shapes both routes in turns, each pass alone,
   and ``scaled_dot_product_attention`` as a reading of the two products'
   cost), and the three training kernels (2b) at dropout rate 0 and 0.2,
   plus the autograd Functions' gradients against torch autograd of the
   N x N forward with the same dropout mask; the backward and both forwards
   on the routes ``train_bwd_route``, ``train_fwd_route`` and
   ``bn_fwd_route`` name (bfloat16 at base's level shapes on the tensor
   cores), with ragged cases and the two routes held against each other
   (the forwards also at batch 64, and their dropout bits read back
   exactly), and at the main path's shapes both routes timed in turns;
3. serving: the base preset at full width (224², bf16) served through
   ``Predictor(batch_size=64)`` with the eval kernel's launch counts by
   route, the kernel path held against the plain path in float32 and in
   bfloat16, and the serving rate, with the eval kernel held on the
   CUDA-core route before and after for comparison;
4. training: the base preset at full width (224², bf16, batch 64, AdamW
   1e-4 with weight decay 1e-4, x ~ N(0, 1), y = 0.9 x): 2 + 10 exact-BN
   steps and 5 frozen-BN steps through ``build_step_functions`` with the
   training kernels' launch counts by route, step time, img/s, peak
   memory and a profiler breakdown; both steps timed again with the
   backward held on the CUDA-core route before and after (old, new, new,
   old), and each step with its forward held there;
   then one f32 step at batch 4 of the kernel path
   against the plain path (``flash_train=False``) with the same weights
   and dropout seed; then a model whose level 0 (head dim 1536) is wider
   than the kernels take (``GATE_MODEL``), served and trained against its
   plain path, level 0 on the plain path and the others on the kernels;
5. a ``{"kernels": [...]}`` line, then the card's name and power limit,
   then ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX.  Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

# published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # max|err| / max|plain|
# f32 model path vs plain path: same weights, same f32 math, but other
# summation orders through 12 re-attention calls and 20 LayerNorms
MODEL_TOL = 1e-3
# bf16 model, kernel path vs plain path, same weights: the plain path keeps
# the mixed map in f32 and rounds each call's output to bf16, the tensor-core
# route also rounds the mixed map to bf16 before the product with V (as the
# TPU kernel does); 12 calls and 20 LayerNorms carry those roundings on
MODEL_TOL_BF16 = 2e-2
BASE_LEVELS = [  # (heads, dh, n, calls per base forward)
    (8, 384, 49, 3),    # encoder level 0 x2, skip connection 1
    (8, 96, 196, 5),    # encoder level 1 x2, decoder level 1 x2, skip 0
    (8, 24, 784, 4),    # bottleneck x2, decoder level 2 x2
]
CHECK_SHAPES = [  # (batch, heads, dh, n_q, n_k)
    (4, 8, 384, 49, 49), (4, 8, 96, 196, 196), (4, 8, 24, 784, 784),     # base
    (2, 4, 12, 3136, 3136), (4, 4, 48, 784, 784), (4, 4, 192, 196, 196),  # lite
    (4, 8, 96, 96, 200),                                                 # rectangular
    (4, 16, 12, 256, 256), (8, 16, 48, 64, 64),                          # 16 heads
]
EDGE_CASES = [  # (label, batch, heads, dh, n_q, n_k, q scale), bf16
    ("peaked", 4, 8, 96, 196, 196, 8.0),      # large lse, far from uniform maps
    ("few keys", 4, 8, 24, 100, 9, 1.0),      # Nk < 16
    ("one query", 4, 8, 384, 1, 49, 1.0),     # Nq = 1
]
SERVE_SIZES = (1, 17, 64, 70)
BATCH = 64
PHASES = ("2a", "2b", "3", "4")
EVAL_SOURCE = "flash_reattention.cu"
TRAIN_SOURCE = "flash_reattention_train.cu"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reattention_inputs(batch, heads, dh, n_q, n_k, dtype, seed, q_scale=1.0):
    """Random kernel inputs on the card: q pre-scaled, a random head mix."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = rnd(batch, heads, n_q, dh) * (q_scale * dh ** -0.5)
    k = rnd(batch, heads, n_k, dh)
    v = rnd(batch, n_k, heads * dh)
    m_eff = rnd(heads, heads) * heads ** -0.5
    c_eff = rnd(heads) * 0.1
    from vit_unet_tpu_torch.kernels.flash_reattention import (
        expand_reattention_affine)
    w, b = expand_reattention_affine(m_eff, c_eff, dh=dh)
    dev = "cuda"
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            w.to(dev), b.to(dev))


def bound_parts(batch, heads, dh, n_q, n_k, dtype) -> tuple[float, float]:
    """Least time for one call: bytes (inputs read once, output written
    once) over HBM bandwidth vs operations (scores, head mix, product with
    V) over the peak rate for the input type."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (item * (batch * heads * (n_q + n_k) * dh + batch * n_k * heads * dh
                      + batch * n_q * heads * dh)
              + 4 * (heads * heads * dh + heads * dh))
    ops = 2.0 * batch * heads * n_q * n_k * (2 * dh + heads)
    return nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS[dtype] * 1e3


def bound_of(t_bytes: float, t_ops: float) -> tuple[float, str]:
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pass_bounds(batch, heads, dh, n_q, n_k, dtype) -> dict:
    """{pass: (t_bytes, t_ops)} in ms for the two passes alone: the
    log-sum-exp pass reads q and k and writes lse (scores: 2 dh operations a
    map entry); the output pass reads everything and lse and writes out."""
    item = torch.tensor([], dtype=dtype).element_size()
    qk = item * batch * heads * (n_q + n_k) * dh
    lse = 4 * batch * heads * n_q
    area = batch * heads * n_q * n_k
    t_bytes, t_ops = bound_parts(batch, heads, dh, n_q, n_k, dtype)
    return {"lse": ((qk + lse) / PEAK_BYTES * 1e3,
                    2.0 * area * dh / PEAK_FLOPS[dtype] * 1e3),
            "out": (t_bytes + lse / PEAK_BYTES * 1e3, t_ops)}


def check_kernel(batch, heads, dh, n_q, n_k, dtype, seed=0, reps=10,
                 q_scale=1.0, label=""):
    from vit_unet_tpu_torch.kernels.flash_reattention import (
        flash_reattention, flash_reattention_plain, kernel_route)
    args = reattention_inputs(batch, heads, dh, n_q, n_k, dtype, seed, q_scale)
    route = kernel_route(dtype, heads, dh)
    before = flash_reattention.route_launches[route]
    got = flash_reattention(*args, num_heads=heads)
    if flash_reattention.route_launches[route] != before + 1:
        raise AssertionError(f"the call did not take the {route} route")
    want = flash_reattention_plain(*args, num_heads=heads)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    ms = time_ms(lambda: flash_reattention(*args, num_heads=heads), reps)
    plain = time_ms(lambda: flash_reattention_plain(*args, num_heads=heads), reps)
    t_bytes, t_ops = bound_parts(batch, heads, dh, n_q, n_k, dtype)
    bound, by = bound_of(t_bytes, t_ops)
    name = str(dtype).replace("torch.", "")
    print(f"  B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k} {name}"
          f"{' ' + label if label else ''} [{route}]: max_abs_err "
          f"{err:.3e} rel {rel:.3e} (tol {TOL[dtype]:.0e}) | kernel {ms:.4f} ms"
          f" plain {plain:.4f} ms bound {bound:.4f} ms ({by})")
    if not (math.isfinite(rel) and rel <= TOL[dtype]):
        raise AssertionError(f"flash_reattention disagrees with its plain "
                             f"version: rel {rel:.3e} > {TOL[dtype]:.0e}")
    return dict(err=err, ms=ms, plain_ms=plain, t_bytes=t_bytes, t_ops=t_ops,
                route=route, shape_class=f"H{heads} dh{dh} {name}")


def time_passes(batch, heads, dh, n, reps=10):
    """At one main-path shape in bf16: the whole call on the CUDA-core route
    and on the tensor-core route in turns (old, new, new, old), the route
    against route difference, each pass of the main path's route alone, and
    scaled_dot_product_attention on the same q, k, v."""
    from vit_unet_tpu_torch.kernels.flash_reattention import (
        ROUTES, kernel_route, launch_passes)
    dtype = torch.bfloat16
    q, k, v, w, b = reattention_inputs(batch, heads, dh, n, n, dtype, 0)
    outs = {r: torch.empty(batch, n, heads * dh, dtype=dtype, device="cuda")
            for r in ROUTES}
    lses = {r: torch.empty(batch, heads, n, device="cuda") for r in ROUTES}
    run = lambda r, passes=3: launch_passes(q, k, v, w, b, lses[r], outs[r],
                                            route=r, passes=passes)
    turns = [(r, time_ms(lambda: run(r), reps))
             for r in ("cuda_core", "tensor_core", "tensor_core", "cuda_core")]
    d_out = (outs["tensor_core"].float() - outs["cuda_core"].float()).abs().max().item()
    d_out /= outs["cuda_core"].float().abs().max().item()
    d_lse = (lses["tensor_core"] - lses["cuda_core"]).abs().max().item()
    print(f"    N{n} dh{dh} whole call in turns: "
          + ", ".join(f"{r} {t:.4f} ms" for r, t in turns)
          + f"; tensor_core vs cuda_core out rel {d_out:.3e}, lse abs {d_lse:.3e}")
    if not (d_out <= TOL[dtype] and d_lse <= 1e-3):
        raise AssertionError("the two routes disagree on the same bf16 inputs")
    route = kernel_route(dtype, heads, dh)
    bounds = pass_bounds(batch, heads, dh, n, n, dtype)
    res = {}
    for name, passes in (("lse", 1), ("out", 2)):
        res[name] = time_ms(lambda: run(route, passes), reps)
        bound, by = bound_of(*bounds[name])
        print(f"    N{n} dh{dh} {name} pass [{route}]: {res[name]:.4f} ms, "
              f"bound {bound:.4f} ms ({by})")
    vh = v.view(batch, n, heads, dh).transpose(1, 2)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, vh, scale=1.0)
    res["sdpa"] = time_ms(sdpa, reps)
    print(f"    N{n} dh{dh} sdpa_ms {res['sdpa']:.4f} (NOT the same function: no "
          f"head mix, M = I, c = 0; what the two products alone cost here; the "
          f"port never calls it)")
    res["old"] = min(t for r, t in turns if r == "cuda_core")
    return res


def phase_environment(sources):
    print("== phase 1: environment")
    print("card:", card_line())
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))
    from vit_unet_tpu_torch.kernels import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(lambda src: _build.build(src, extra_flags=("-Xptxas=-v",)),
                      sources))
    print(f"kernel build ({len(sources)} sources in parallel): "
          f"{time.perf_counter() - t0:.1f} s")


def phase_kernels():
    print("== phase 2a: flash_reattention kernel vs plain on the card")
    t_phase = time.perf_counter()
    checks = [check_kernel(*shape, dtype)
              for dtype in (torch.float32, torch.bfloat16) for shape in CHECK_SHAPES]
    checks += [check_kernel(batch, heads, dh, n_q, n_k, torch.bfloat16,
                            q_scale=q_scale, label=label)
               for label, batch, heads, dh, n_q, n_k, q_scale in EDGE_CASES]
    print(f"  main-path shapes (base, B{BATCH}, bf16), calls per forward:")
    total = dict(err=0.0, ms=0.0, plain_ms=0.0, t_bytes=0.0, t_ops=0.0,
                 lse_ms=0.0, out_ms=0.0, old_ms=0.0)
    for heads, dh, n, calls in BASE_LEVELS:
        r = check_kernel(BATCH, heads, dh, n, n, torch.bfloat16, reps=10)
        checks.append(r)
        total["err"] = max(total["err"], r["err"])
        for key in ("ms", "plain_ms", "t_bytes", "t_ops"):
            total[key] += calls * r[key]
        passes = time_passes(BATCH, heads, dh, n)
        for key in ("lse", "out", "old"):
            total[f"{key}_ms"] += calls * passes[key]
    total["bound_ms"], total["bound_by"] = bound_of(total["t_bytes"],
                                                    total["t_ops"])
    print(f"  per base forward (12 calls): kernel {total['ms']:.4f} ms (lse passes "
          f"{total['lse_ms']:.4f}, output passes {total['out_ms']:.4f}), on the "
          f"CUDA-core route {total['old_ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
          f"({total['bound_by']})")
    # route -> the (heads, dh, dtype) classes that ran on it
    total["routes"] = {route: sorted({r["shape_class"] for r in checks
                                      if r["route"] == route})
                       for route in sorted({r["route"] for r in checks})}
    print(f"  routes: {total['routes']}")
    print(f"  phase 2a: {time.perf_counter() - t_phase:.1f} s")
    return total


def phase_slice():
    print("== phase 3: base ViT-UNet served through Predictor")
    t_phase = time.perf_counter()
    import importlib
    from vit_unet_tpu_torch import Predictor, get_vit_unet
    # the package exports the function under its module's name
    TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
    flash_reattention = TK.flash_reattention

    model = get_vit_unet("base", dtype="bfloat16", param_dtype="bfloat16",
                         seed=0)
    pred = Predictor(model, batch_size=BATCH)
    rng = np.random.default_rng(0)
    requests = [rng.random((n, 3, 224, 224), dtype=np.float32)
                for n in SERVE_SIZES]
    forwards = sum(-(-n // BATCH) for n in SERVE_SIZES)

    flash_reattention.launches = 0
    flash_reattention.route_launches = dict.fromkeys(TK.ROUTES, 0)
    outs = [pred(x) for x in requests]
    torch.cuda.synchronize()
    launches = flash_reattention.launches
    by_route = dict(flash_reattention.route_launches)
    print(f"  requests {SERVE_SIZES}: {forwards} forwards, "
          f"flash_reattention launches {launches}, by route {by_route}")
    if launches != 12 * forwards:
        raise AssertionError(f"expected 12 launches per forward "
                             f"({12 * forwards}), counted {launches}")
    if by_route != {"cuda_core": 0, "tensor_core": 12 * forwards}:
        raise AssertionError(f"a bf16 base forward takes the tensor-core route "
                             f"12 times, counted {by_route}")
    for x, y in zip(requests, outs):
        if y.shape != x.shape or not np.isfinite(y).all():
            raise AssertionError(f"bad output for a request of {len(x)}: "
                                 f"shape {y.shape}, finite {np.isfinite(y).all()}")

    # the kernel path against the plain path, same weights, batch 8
    for dt, tol in (("float32", MODEL_TOL), ("bfloat16", MODEL_TOL_BF16)):
        kern = get_vit_unet("base", seed=0, dtype=dt, param_dtype=dt)
        plain = get_vit_unet("base", seed=0, dtype=dt, param_dtype=dt,
                             use_flash=False)
        x = torch.from_numpy(requests[2][:8]).cuda()
        with torch.inference_mode():
            got, want = kern(x).float(), plain(x).float()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        print(f"  {dt} kernel path vs plain path, batch 8: max_abs_err "
              f"{err:.3e} rel {rel:.3e} (tol {tol:.0e})")
        if not rel <= tol:
            raise AssertionError(f"{dt} kernel path disagrees with the plain path")
        del kern, plain, got, want

    # the forward and the served rate, with kernel 1 held on the CUDA-core
    # route (the earlier kernels) before and after: old, new, new, old
    xb = torch.from_numpy(requests[2]).cuda()
    card = card_line()

    def rates(label):
        with torch.inference_mode():
            ms = time_ms(lambda: model(xb), reps=20)
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            pred(requests[2])
        serve_s = (time.perf_counter() - t0) / reps
        print(f"  base b{BATCH} bf16 forward [{label}]: {ms:.3f} ms/batch, "
              f"{BATCH / ms * 1e3:.1f} img/s (device-resident input); Predictor "
              f"(numpy in/out): {serve_s * 1e3:.3f} ms/batch, "
              f"{BATCH / serve_s:.1f} img/s [{card}]")
        return ms

    held = mock.patch.object(TK, "kernel_route", lambda *a: "cuda_core")
    with held:
        rates("kernel 1 held on cuda_core")
    rates("tensor_core")
    ms = rates("tensor_core")
    with held:
        rates("kernel 1 held on cuda_core")
    device_breakdown(lambda: model(xb), ms, "forward", inference=True, top=12)
    print(f"  phase 3: {time.perf_counter() - t_phase:.1f} s")
    return launches


def device_breakdown(run, total_ms, what, reps=3, top=8, inference=False):
    """Device time per ``run()`` by kernel (torch.profiler), and the share
    of its time the device is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ctx = torch.inference_mode() if inference else torch.enable_grad()
    with ctx, profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / reps / 1e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(t for t, _ in rows)
    print(f"  device time per {what} {busy:.3f} ms of {total_ms:.3f} ms "
          f"(busy {busy / total_ms:.1%}); top kernels:")
    for t, name in rows[:top]:
        print(f"    {t:8.3f} ms {t / busy:6.1%}  {name[:90]}")


# --- the training kernels ----------------------------------------------------

# max|err| / max|plain|: f32 differs by summation order (dk by f32 atomics);
# bf16 stores o_norm and out in bf16, so their error is its rounding; S, C,
# lse and the f32 gradients come from f32 math on the same inputs
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
F32_OUT_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# autograd Function vs torch autograd of the N x N forward in float64 on the
# same inputs: f32 math in another order; the Functions take the
# softmax-dot term from o_norm, and in bf16 store o_norm in bf16, so bf16
# is held to its rounding
GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
BN_FWD_TOLS = (F32_OUT_TOL, F32_OUT_TOL, F32_OUT_TOL, TRAIN_TOL)   # S, C, lse, o_norm
TRAIN_SHAPES = [  # (batch, heads, dh, n_q, n_k)
    (4, 8, 384, 49, 49), (4, 8, 96, 196, 196), (4, 8, 24, 784, 784),      # base
    (2, 4, 12, 3136, 3136), (4, 4, 48, 784, 784), (4, 4, 192, 196, 196),   # lite
    (4, 8, 96, 96, 200),                                                  # rectangular
]
RATE = 0.2
# the backward's tensor-core route at ragged and rectangular sizes: (batch,
# heads, dh, n_q, n_k); a key tile with fewer valid keys than one MMA tile,
# a single query, more keys than queries and the other way round
BWD_EDGE_CASES = [
    (4, 8, 24, 100, 9), (4, 8, 24, 1, 49), (4, 8, 96, 1, 49), (4, 8, 384, 1, 49),
    (4, 8, 96, 96, 200), (4, 8, 24, 200, 96), (2, 8, 384, 70, 130),
]
# the forwards also with more keys than the chunked form keeps A of (256),
# so A is recomputed for every column chunk
FWD_EDGE_CASES = BWD_EDGE_CASES + [(2, 8, 96, 40, 300), (2, 8, 384, 17, 270)]


def train_inputs(batch, heads, dh, n_q, n_k, dtype, seed=0):
    """Training-kernel inputs on the card.  Scores have std ~3, so the maps
    are peaked and the batch variance of the head mix stays far above the
    BatchNorm epsilon."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    dev = "cuda"
    q = (rnd(batch, heads, n_q, dh) * 3 * dh ** -0.5).to(dev, dtype)
    k = rnd(batch, heads, n_k, dh).to(dev, dtype)
    v = rnd(batch, n_k, heads * dh).to(dev, dtype)
    m_eff = (rnd(heads, heads) * heads ** -0.5).to(dev)
    c_eff = (rnd(heads) * 0.1).to(dev)
    g_out = rnd(batch, n_q, heads * dh).to(dev, dtype)
    seed_t = torch.tensor([1234 + seed], dtype=torch.int64, device=dev)
    return q, k, v, m_eff, c_eff, g_out, seed_t


def train_bounds(batch, heads, dh, n_q, n_k, dtype):
    """{kernel: (t_bytes, t_ops)} in ms: inputs read once, outputs written
    once, over HBM bandwidth; operations over the peak for the input type.
    The backward's least operations per map entry and head: scores, g.v per
    head, dq, dk and dv (2 dh each), the head mix of g.v into dA and of A
    into dv's weights (2 H each), and the BN term's sum G.A (2 H)."""
    item = torch.tensor([], dtype=dtype).element_size()
    proj = heads * dh
    qkv = item * (batch * heads * (n_q + n_k) * dh + batch * n_k * proj)
    onorm = item * batch * heads * n_q * proj
    lse = 4 * batch * heads * n_q
    area = batch * heads * n_q * n_k
    fwd_ops = 2.0 * area * (dh + proj)
    parts = {
        "fwd": (qkv + item * batch * n_q * proj + onorm + lse, fwd_ops),
        "bn_fwd": (qkv + onorm + lse + 4 * batch * heads * (heads + 1) * n_q,
                   fwd_ops + area * (heads + 1)),
        "bwd": (qkv + item * batch * n_q * proj + 2 * lse
                + 4 * (batch * heads * (n_q + n_k) * dh + batch * n_k * proj),
                2.0 * area * (5 * dh + 2 * heads) + 2.0 * area * heads),
    }
    return {k: (b / PEAK_BYTES * 1e3, o / PEAK_FLOPS[dtype] * 1e3)
            for k, (b, o) in parts.items()}


def rel_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def require(name, rel, tol):
    if not (math.isfinite(rel) and rel <= tol):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"rel {rel:.3e} > {tol:.0e}")


def check_train_kernels(batch, heads, dh, n_q, n_k, dtype, rate, reps=0):
    """Each training kernel against its plain version on the same inputs;
    with ``reps``, their times.  Returns {kernel: dict(err, ms, plain_ms)}."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, m_eff, c_eff, g_out, seed = train_inputs(batch, heads, dh, n_q,
                                                      n_k, dtype)
    vsum = v.float().sum(1)
    d = torch.randn(batch, heads, n_q, device="cuda")
    bn_extra = (torch.randn(heads, heads, device="cuda") * 0.1,
                torch.randn(heads, device="cuda") * 0.1)
    calls = {
        "fwd": (lambda: T.train_fwd(q, k, v, vsum, m_eff, c_eff, seed, rate),
                lambda: T.train_fwd_plain(q, k, v, vsum, m_eff, c_eff, seed, rate),
                (TRAIN_TOL, F32_OUT_TOL, TRAIN_TOL)),
        "bn_fwd": (lambda: T.bn_fwd(q, k, v, seed, rate),
                   lambda: T.bn_fwd_plain(q, k, v, seed, rate),
                   BN_FWD_TOLS),
    }
    res = {}
    for name, (kern, plain, tols) in calls.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        for (err, rel), tol in zip(errs, tols):
            require(f"{name} B{batch} H{heads} dh{dh}", rel, tol[dtype])
        res[name] = dict(err=max(e for e, _ in errs), rel=max(r for _, r in errs))
    lse = calls["fwd"][0]()[1]
    for extra, label in ((None, "bwd"), (bn_extra, "bwd_bn")):
        got = T.train_bwd(q, k, v, lse, g_out, m_eff, d, seed, rate, extra)
        want = T.train_bwd_plain(q, k, v, lse, g_out, m_eff, d, seed, rate, extra)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        for _, rel in errs:
            require(f"{label} B{batch} H{heads} dh{dh}", rel, F32_OUT_TOL[dtype])
        res[label] = dict(err=max(e for e, _ in errs), rel=max(r for _, r in errs))
    if reps:
        run_bwd = lambda fn: lambda: fn(q, k, v, lse, g_out, m_eff, d, seed,
                                        rate, bn_extra)
        timed = {"fwd": calls["fwd"][:2], "bn_fwd": calls["bn_fwd"][:2],
                 "bwd": (run_bwd(T.train_bwd), run_bwd(T.train_bwd_plain))}
        for name, (kern, plain) in timed.items():
            res[name]["ms"] = time_ms(kern, reps)
            res[name]["plain_ms"] = time_ms(plain, max(2, reps // 5), warmup=1)
    name = str(dtype).replace("torch.", "")
    print(f"  B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k} {name} rate {rate}: "
          + ", ".join(f"{kname} rel {r['rel']:.2e}" for kname, r in res.items()))
    return res


def bwd_inputs(batch, heads, dh, n_q, n_k, dtype, rate, bn):
    """The backward's arguments on the card, lse from the plain forward."""
    q, k, v, m_eff, _, g_out, seed = train_inputs(batch, heads, dh, n_q, n_k, dtype)
    lse = torch.logsumexp(q.float() @ k.float().transpose(-1, -2), -1)
    gen = torch.Generator(device="cuda").manual_seed(4)
    d = torch.randn(batch, heads, n_q, generator=gen, device="cuda")
    extra = ((torch.randn(heads, heads, generator=gen, device="cuda") * 0.1,
              torch.randn(heads, generator=gen, device="cuda") * 0.1) if bn else None)
    return q, k, v, lse, g_out, m_eff, d, seed, rate, extra


def check_bwd_routes(batch, heads, dh, n_q, n_k, rate, bn):
    """bf16 backward on the route ``train_bwd_route`` names against its
    plain version, and the two routes against each other, on the same
    inputs; f32 gradients, so both at F32_OUT_TOL."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    args = bwd_inputs(batch, heads, dh, n_q, n_k, torch.bfloat16, rate, bn)
    route = T.train_bwd_route(torch.bfloat16, heads, dh)
    before = dict(T.train_bwd.route_launches)
    got = T.train_bwd(*args)
    if T.train_bwd.route_launches[route] != before[route] + 1:
        raise AssertionError(f"the call did not take the {route} route")
    want = T.train_bwd_plain(*args)
    other = T.launch_bwd(*args, route="cuda_core") if route == "tensor_core" else None
    torch.cuda.synchronize()
    tol = F32_OUT_TOL[torch.bfloat16]
    rels = [rel_err(a, b)[1] for a, b in zip(got, want)]
    for r in rels:
        require(f"bwd [{route}] B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k}", r, tol)
    msg = (f"  bwd [{route}] B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k} rate {rate} "
           f"bn {bn}: dq dk dv rel " + " ".join(f"{r:.2e}" for r in rels))
    if other is not None:
        routes = [rel_err(a, b)[1] for a, b in zip(got, other)]
        for r in routes:
            require("bwd tensor_core vs cuda_core", r, tol)
        msg += " | vs cuda_core " + " ".join(f"{r:.2e}" for r in routes)
    print(msg)
    return max(rel_err(a, b)[0] for a, b in zip(got, want))


def time_bwd_routes(batch, heads, dh, n, reps=10):
    """At one main-path shape, bf16, rate 0.2, BN term on: the backward on
    the CUDA-core and the tensor-core route in turns (old, new, new, old)."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    args = bwd_inputs(batch, heads, dh, n, n, torch.bfloat16, RATE, True)
    turns = [(r, time_ms(lambda: T.launch_bwd(*args, route=r), reps))
             for r in ("cuda_core", "tensor_core", "tensor_core", "cuda_core")]
    old = min(t for r, t in turns if r == "cuda_core")
    new = min(t for r, t in turns if r == "tensor_core")
    print(f"    N{n} dh{dh} bwd in turns: " + ", ".join(f"{r} {t:.4f} ms" for r, t in turns)
          + f"; cuda_core / tensor_core {old / new:.2f}x")
    return old, new


FWD_TOLS = (TRAIN_TOL, F32_OUT_TOL, TRAIN_TOL)   # out, lse, o_norm
FWD_OUTPUTS = {"fwd": "out lse o_norm", "bn_fwd": "S C lse o_norm"}


Forward = collections.namedtuple("Forward", "kernel plain launch route tols args")


def forward(key) -> Forward:
    """The forward ``key`` ("fwd": frozen BN, "bn_fwd": exact BN): its
    wrapper, plain version, launch on a named route, route choice,
    tolerances of its outputs, and its arguments from (q, k, v, m_eff,
    c_eff, seed, rate).  Both return o_norm last."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    if key == "fwd":
        return Forward(T.train_fwd, T.train_fwd_plain, T.launch_train_fwd,
                       T.train_fwd_route, FWD_TOLS,
                       lambda q, k, v, m, c, sd, rate: (q, k, v, v.float().sum(1), m, c,
                                                        sd, rate))
    return Forward(T.bn_fwd, T.bn_fwd_plain, T.launch_bn_fwd, T.bn_fwd_route,
                   BN_FWD_TOLS, lambda q, k, v, m, c, sd, rate: (q, k, v, sd, rate))


def fwd_turns(key, batch, heads, dh, n_q, n_k, rate, seed=0):
    """bf16 forward ``key`` on the route its route choice names against its
    plain version and against the CUDA-core route, on the same inputs, each
    output at its tolerance.  Returns the worst max_abs_err against the
    plain version."""
    f = forward(key)
    dtype = torch.bfloat16
    q, k, v, m_eff, c_eff, _, sd = train_inputs(batch, heads, dh, n_q, n_k, dtype, seed)
    args = f.args(q, k, v, m_eff, c_eff, sd, rate)
    route = f.route(dtype, heads, dh)
    before = dict(f.kernel.route_launches)
    got = f.kernel(*args)
    if f.kernel.route_launches[route] != before[route] + 1:
        raise AssertionError(f"the call did not take the {route} route")
    want = f.plain(*args)
    other = f.launch(*args, route="cuda_core")
    torch.cuda.synchronize()
    label = f"{key} [{route}] B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k} rate {rate}"
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    routes = [rel_err(a, b)[1] for a, b in zip(got, other)]
    for (_, rel), r, tol in zip(errs, routes, f.tols):
        require(label, rel, tol[dtype])
        require(f"{label} against the cuda_core route", r, tol[dtype])
    print(f"  {label}: {FWD_OUTPUTS[key]} rel " + " ".join(f"{r:.2e}" for _, r in errs)
          + " | vs cuda_core " + " ".join(f"{r:.2e}" for r in routes))
    return max(e for e, _ in errs)


def check_fwd_bits(key, batch, heads, dh, n):
    """The dropout bits of forward ``key``'s route, read back exactly: with
    q = 0 every probability is 1/Nk, and with V_cat[m, j] = 1 where m = j mod
    P, o_norm[b, h, n, j] Nk / scale counts the kept keys m = j mod P of row
    n, which must equal the count from ``dropout_mask`` (every bit itself
    where P >= Nk).  The frozen forward mixes with M = identity and c = 0,
    so its out[b, n, j] must equal o_norm[b, head(j), n, j] bit for bit."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    f = forward(key)
    proj = heads * dh
    q = torch.zeros(batch, heads, n, dh, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(batch, heads, n, dh, device="cuda").bfloat16()
    v = (torch.arange(n, device="cuda")[:, None] % proj
         == torch.arange(proj, device="cuda")[None, :]).to(torch.bfloat16)
    v = v.expand(batch, n, proj).contiguous()
    sd = torch.tensor([77], dtype=torch.int64, device="cuda")
    eye = torch.eye(heads, device="cuda")
    got_all = f.kernel(*f.args(q, k, v, eye, torch.zeros(heads, device="cuda"), sd, RATE))
    onorm = got_all[-1]
    mask = T.dropout_mask(77, RATE, batch, heads, n, n, "cuda") > 0
    want = torch.einsum("bhnm,mj->bhnj", mask.float(), v[0].float())
    got = torch.round(onorm.float() * n * (1 - RATE))
    if not torch.equal(got, want):
        raise AssertionError(f"{key}'s dropout bits differ from dropout_mask "
                             f"(H{heads} dh{dh} N{n}): {int((got != want).sum())} counts")
    if key == "fwd":
        own = onorm.unflatten(-1, (heads, dh)).diagonal(dim1=1, dim2=3)   # (B, N, dh, H)
        if not torch.equal(got_all[0], own.permute(0, 1, 3, 2).flatten(-2)):
            raise AssertionError(f"fwd's out with M = I, c = 0 is not its own head's "
                                 f"o_norm (H{heads} dh{dh} N{n})")
    print(f"  {key} dropout bits H{heads} dh{dh} N{n} B{batch}: all "
          f"{mask.numel()} identical to dropout_mask "
          f"({'each bit' if proj >= n else 'counts of keys m = j mod P'})"
          + ("; out with M = I, c = 0 is each column's own head" if key == "fwd" else ""))


def time_fwd_routes(key, batch, heads, dh, n, reps=10):
    """At one main-path shape, bf16, rate 0.2: forward ``key`` on the
    CUDA-core and the tensor-core route in turns (old, new, new, old)."""
    f = forward(key)
    q, k, v, m_eff, c_eff, _, sd = train_inputs(batch, heads, dh, n, n, torch.bfloat16)
    args = f.args(q, k, v, m_eff, c_eff, sd, RATE)
    turns = [(r, time_ms(lambda: f.launch(*args, route=r), reps))
             for r in ("cuda_core", "tensor_core", "tensor_core", "cuda_core")]
    old = min(t for r, t in turns if r == "cuda_core")
    new = min(t for r, t in turns if r == "tensor_core")
    bound, by = bound_of(*train_bounds(batch, heads, dh, n, n, torch.bfloat16)[key])
    print(f"    N{n} dh{dh} {key} in turns: " + ", ".join(f"{r} {t:.4f} ms" for r, t in turns)
          + f"; cuda_core / tensor_core {old / new:.2f}x; bound {bound:.4f} ms ({by})")
    return old, new


def check_functions(batch, heads, dh, n, dtype):
    """Both autograd Functions at rate 0.2 against torch autograd of the
    N x N forward (``reattention_nxn``) with the same mask, in float64 on
    the same inputs.  The loss takes the BN moments too, so the conv bias's
    gradient is d(sum mu)/d cb = 1: BatchNorm removes a uniform shift of the
    map, and the reference's other terms cancel to its float64 rounding."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, m_eff, c_eff, g_out, seed = train_inputs(batch, heads, dh, n, n, dtype, 1)
    mask = T.dropout_mask(int(seed.item()), RATE, batch, heads, n, n, "cuda")
    gen = torch.Generator().manual_seed(3)
    cm = (torch.randn(heads, heads, generator=gen) * 0.4).cuda()
    cb = (torch.randn(heads, generator=gen) * 0.2).cuda()
    ga = (1 + 0.3 * torch.randn(heads, generator=gen)).cuda()
    be = (torch.randn(heads, generator=gen) * 0.2).cuda()

    worst = 0.0
    for mode in ("frozen", "bn"):
        leaves = ([q, k, v, m_eff, c_eff] if mode == "frozen"
                  else [q, k, v, cm, cb, ga, be])
        kl = [t.detach().clone().requires_grad_() for t in leaves]
        rl = [t.detach().double().requires_grad_() for t in leaves]
        if mode == "frozen":
            got = (T.flash_reattention_train(*kl, seed, num_heads=heads, rate=RATE),)
            want = (T.reattention_nxn(*rl, mask)[0],)
        else:
            got = T.flash_reattention_train_bn(*kl, seed, num_heads=heads, rate=RATE)
            out, moments = T.reattention_nxn(*rl[:5], mask, norm=rl[5:])
            want = (out, *moments)
        loss = lambda outs: ((outs[0] * g_out.to(outs[0].dtype)).sum()
                             + sum(o.sum() for o in outs[1:]))
        gk = torch.autograd.grad(loss(got), kl)
        gr = torch.autograd.grad(loss(want), rl)
        rels = [rel_err(a, b)[1] for a, b in zip((got[0],) + tuple(gk), (want[0],) + tuple(gr))]
        print(f"  {mode} Function B{batch} H{heads} dh{dh} N{n} "
              f"{str(dtype).replace('torch.', '')} rate {RATE}: out and grads rel "
              + " ".join(f"{r:.1e}" for r in rels))
        for r in rels:
            require(f"{mode} Function gradients", r, GRAD_TOL[dtype])
        worst = max(worst, *rels)
    return worst


def phase_train_kernels():
    print("== phase 2b: training kernels vs plain on the card")
    t_phase = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for shape in TRAIN_SHAPES:
            for rate in (0.0, RATE):
                check_train_kernels(*shape, dtype, rate)
        for batch, heads, dh, n, _ in TRAIN_SHAPES[:3]:
            check_functions(batch, heads, dh, n, dtype)
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    print("  the backward in bf16 on the route train_bwd_route names:")
    tc_err = 0.0
    for shape in [s for s in TRAIN_SHAPES[:3] if s[1:3] in T.TRAIN_BWD_TC_SHAPES] + BWD_EDGE_CASES:
        for rate in (0.0, RATE):
            for bn in (False, True):
                tc_err = max(tc_err, check_bwd_routes(*shape, rate, bn))
    fwd_err = {}
    for key, classes in (("fwd", T.TRAIN_FWD_TC_SHAPES), ("bn_fwd", T.BN_FWD_TC_SHAPES)):
        print(f"  the {'frozen' if key == 'fwd' else 'exact'}-BN forward in bf16 on the "
              f"route its route choice names:")
        fwd_err[key] = 0.0
        shapes = [s for s in TRAIN_SHAPES[:3] if s[1:3] in classes]
        for shape in shapes + [(BATCH,) + s[1:] for s in shapes] + FWD_EDGE_CASES:
            for rate in (0.0, RATE):
                fwd_err[key] = max(fwd_err[key], fwd_turns(key, *shape, rate))
        for batch, heads, dh, n, _ in shapes:
            check_fwd_bits(key, batch, heads, dh, n)
    print(f"  main-path shapes (base, B{BATCH}, bf16, rate {RATE}), "
          f"calls per train step:")
    total = {kname: dict(err=0.0, ms=0.0, plain_ms=0.0, t_bytes=0.0, t_ops=0.0)
             for kname in ("fwd", "bn_fwd", "bwd")}
    total["bwd"].update(err=tc_err, old_ms=0.0, routes={})
    for key, err in fwd_err.items():
        total[key].update(err=err, old_ms=0.0, routes={})
    for heads, dh, n, calls in BASE_LEVELS:
        res = check_train_kernels(BATCH, heads, dh, n, n, torch.bfloat16, RATE,
                                  reps=10)
        route = T.train_bwd_route(torch.bfloat16, heads, dh)
        total["bwd"]["routes"].setdefault(route, []).append(f"H{heads} dh{dh} bfloat16")
        if route == "tensor_core":
            old, _ = time_bwd_routes(BATCH, heads, dh, n)
        else:
            old = res["bwd"]["ms"]
        total["bwd"]["old_ms"] += calls * old
        for key in ("fwd", "bn_fwd"):
            route = forward(key).route(torch.bfloat16, heads, dh)
            total[key]["routes"].setdefault(route, []).append(f"H{heads} dh{dh} bfloat16")
            if route == "tensor_core":
                old, _ = time_fwd_routes(key, BATCH, heads, dh, n)
            else:
                old = res[key]["ms"]
            total[key]["old_ms"] += calls * old
        bounds = train_bounds(BATCH, heads, dh, n, n, torch.bfloat16)
        for kname, tot in total.items():
            r = res[kname]
            if kname == "bwd":
                r = dict(r, err=max(r["err"], res["bwd_bn"]["err"]))
            b, o = bounds[kname]
            bound, by = bound_of(b, o)
            print(f"    N{n} {kname}: kernel {r['ms']:.4f} ms plain "
                  f"{r['plain_ms']:.4f} ms bound {bound:.4f} ms ({by})")
            tot["err"] = max(tot["err"], r["err"])
            tot["ms"] += calls * r["ms"]
            tot["plain_ms"] += calls * r["plain_ms"]
            tot["t_bytes"] += calls * b
            tot["t_ops"] += calls * o
    for kname, tot in total.items():
        tot["bound_ms"], tot["bound_by"] = bound_of(tot["t_bytes"], tot["t_ops"])
        print(f"  {kname} per train step (12 calls): kernel {tot['ms']:.4f} ms, "
              f"plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
              f"({tot['bound_by']})")
    for kname in ("fwd", "bn_fwd", "bwd"):
        print(f"  {kname} per train step with every call on the CUDA-core route: "
              f"{total[kname]['old_ms']:.4f} ms; routes {total[kname]['routes']}")
    print(f"  phase 2b: {time.perf_counter() - t_phase:.1f} s")
    return total


def train_launches():
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    return {"fwd": T.train_fwd.launches, "bn_fwd": T.bn_fwd.launches,
            "bwd": T.train_bwd.launches,
            **{f"fwd_{r}": n for r, n in T.train_fwd.route_launches.items()},
            **{f"bn_fwd_{r}": n for r, n in T.bn_fwd.route_launches.items()},
            **{f"bwd_{r}": n for r, n in T.train_bwd.route_launches.items()}}


def reset_train_launches():
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    T.train_fwd.launches = T.bn_fwd.launches = T.train_bwd.launches = 0
    T.train_fwd.route_launches = dict.fromkeys(T.train_fwd.route_launches, 0)
    T.bn_fwd.route_launches = dict.fromkeys(T.bn_fwd.route_launches, 0)
    T.train_bwd.route_launches = dict.fromkeys(T.train_bwd.route_launches, 0)


def routes_per_step(expect) -> dict:
    """{"<kernel>_<route>": calls per base train step} for the training
    kernels (``expect``: launches per re-attention call): each base level's
    calls on the route ``train_fwd_route`` / ``bn_fwd_route`` /
    ``train_bwd_route`` names for bf16."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    per = {}
    for kname, pick in (("fwd", T.train_fwd_route), ("bn_fwd", T.bn_fwd_route),
                        ("bwd", T.train_bwd_route)):
        per.update({f"{kname}_{r}": 0 for r in T.ROUTES})
        for heads, dh, _, calls in BASE_LEVELS:
            per[f"{kname}_{pick(torch.bfloat16, heads, dh)}"] += calls * expect[kname]
    return per


def run_steps(steps, state, batch, n, expect, label):
    """n train steps with the launch counts checked (``expect``: launches
    per re-attention call, the backward's by route per step); returns
    (state, losses, per-step ms, launches)."""
    reset_train_launches()
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = steps.train_step(state, batch)
        losses.append(m["loss"].item())       # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    launches = train_launches()
    want = {kname: 12 * n * per for kname, per in expect.items()}
    want.update({k: n * per for k, per in routes_per_step(expect).items()})
    print(f"  {label}: {n} steps, launches {launches} (expected {want}), "
          f"losses {losses[0]:.5f} .. {losses[-1]:.5f}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: loss not finite: {losses}")
    return state, losses, times, launches


def phase_train():
    print("== phase 4: base ViT-UNet train step (exact BN, then frozen BN)")
    t_phase = time.perf_counter()
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse

    model = get_vit_unet("base", dtype="bfloat16", param_dtype="bfloat16", seed=0,
                         device="cuda")
    model.train()
    opt = adamw(model, 1e-4)
    state = TrainState.create(model=model, optimizer=opt, seed=1)
    exact = build_step_functions(model, opt, mse)
    frozen = build_step_functions(model, opt, mse, bn_frozen=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, 3, 224, 224, generator=gen, device="cuda")
    batch = {"x": x, "y": 0.9 * x}
    bn = model.Encoders[0].ReAttn.var_norm
    stats0 = torch.cat([bn.running_mean, bn.running_var]).clone()
    params0 = [p.detach().clone() for p in model.parameters()]

    state, _, _, _ = run_steps(exact, state, batch, 2,
                               {"fwd": 0, "bn_fwd": 1, "bwd": 1}, "exact-BN warm-up")
    torch.cuda.reset_peak_memory_stats()
    state, losses, times, l_exact = run_steps(
        exact, state, batch, 10, {"fwd": 0, "bn_fwd": 1, "bwd": 1}, "exact-BN")
    if l_exact["bn_fwd_tensor_core"] != 12 * 10:
        raise AssertionError("a bf16 base exact-BN step takes the exact-BN forward's "
                             "tensor-core route 12 times")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved_stats = (torch.cat([bn.running_mean, bn.running_var]) - stats0).abs().max().item()
    moved_params = max((p.detach().float() - p0.float()).abs().max().item()
                       for p, p0 in zip(model.parameters(), params0))
    print(f"  BN running stats moved by {moved_stats:.3e}, params by up to "
          f"{moved_params:.3e}")
    if not (moved_stats > 0 and moved_params > 0):
        raise AssertionError("the train step moved no running statistic or no parameter")
    step_ms = sorted(times)[len(times) // 2]
    card = card_line()
    print(f"  base b{BATCH} bf16 exact-BN train step: median {step_ms:.3f} ms, "
          f"{BATCH / step_ms * 1e3:.1f} img/s, peak memory {peak:.2f} GiB [{card}]")
    device_breakdown(lambda: exact.train_step(state, batch), step_ms, "train step", reps=1)

    state, f_losses, f_times, l_frozen = run_steps(
        frozen, state, batch, 5, {"fwd": 1, "bn_fwd": 0, "bwd": 1}, "frozen-BN")
    if l_frozen["fwd_tensor_core"] != 12 * 5:
        raise AssertionError("a bf16 base frozen-BN step takes the frozen-BN forward's "
                             "tensor-core route 12 times")
    f_ms = sorted(f_times)[len(f_times) // 2]
    print(f"  base b{BATCH} bf16 frozen-BN train step: median {f_ms:.3f} ms, "
          f"{BATCH / f_ms * 1e3:.1f} img/s [{card}]")
    device_breakdown(lambda: frozen.train_step(state, batch), f_ms,
                     "frozen-BN train step", reps=1)
    launches = {kname: l_exact[kname] + l_frozen[kname] for kname in l_exact}

    # both steps with the backward held on the CUDA-core route (the earlier
    # kernels) before and after: old, new, new, old, each the median of 5
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    held = mock.patch.object(T, "train_bwd_route", lambda *a: "cuda_core")
    for label, steps in (("exact-BN", exact), ("frozen-BN", frozen)):
        turns = []
        for route in ("cuda_core", "tensor_core", "tensor_core", "cuda_core"):
            ctx = held if route == "cuda_core" else contextlib.nullcontext()
            with ctx:
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    state, m = steps.train_step(state, batch)
                    m["loss"].item()
                    times.append((time.perf_counter() - t0) * 1e3)
            turns.append((route, sorted(times)[2]))
        print(f"  base b{BATCH} bf16 {label} step, backward on each route in turns "
              f"(median of 5): " + ", ".join(f"{r} {t:.3f} ms" for r, t in turns)
              + f" [{card}]")
    # each step with its forward held on the CUDA-core route (the earlier
    # kernels) before and after: old, new, new, old
    for pick, label, steps in (("bn_fwd_route", "exact-BN", exact),
                               ("train_fwd_route", "frozen-BN", frozen)):
        held = mock.patch.object(T, pick, lambda *a: "cuda_core")
        turns = []
        for route in ("cuda_core", "tensor_core", "tensor_core", "cuda_core"):
            with held if route == "cuda_core" else contextlib.nullcontext():
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    state, m = steps.train_step(state, batch)
                    m["loss"].item()
                    times.append((time.perf_counter() - t0) * 1e3)
            turns.append((route, sorted(times)[2]))
        print(f"  base b{BATCH} bf16 {label} step, {label} forward on each route in "
              f"turns (median of 5): " + ", ".join(f"{r} {t:.3f} ms" for r, t in turns)
              + f" [{card}]")
        if not min(t for r, t in turns if r == "tensor_core") < min(
                t for r, t in turns if r == "cuda_core"):
            raise AssertionError(f"the {label} step is not faster with the {label} "
                                 f"forward on the tensor cores")
    del model, opt, state, exact, frozen, params0
    torch.cuda.empty_cache()
    compare_train_paths()
    check_shape_gate()
    print(f"  phase 4: {time.perf_counter() - t_phase:.1f} s")
    return launches, step_ms


# One train step at batch 4 with the same weights and dropout seed, so the
# same masks, through the kernel path (f32) and the plain path
# (``flash_train=False``).  Frozen BN: the same f32 math through 12
# re-attention calls and 20 LayerNorms in another order, so loss, running
# statistics and gradients (against the largest gradient) are held at 1e-3.
# Exact BN: its f32 step at base is sensitive to rounding on either path.
# The frozen-BN step with the same weights matches float64, but with the
# batch statistics in the head mix both f32 paths' gradients differ from a
# float64 run by a tenth of the largest gradient or more (PERF.md section
# 7), so no fixed gradient tolerance separates a fault from that noise.
# The step runs at the JAX package's eps for trainable exact BN, 1e-3, and
# both f32 paths are held against the plain path in float64: loss and
# running statistics at EXACT_TOL, and the kernel path's gradient error at
# most EXACT_GRAD_RATIO times the plain path's own.  Each call's exact-BN
# gradients are held at 1e-3 against float64 in phase 2b.  The reading at
# eps 1e-5 (torch's default) is printed, not held.
TRAIN_PATH_TOL = 1e-3
EXACT_EPS = 1e-3
EXACT_TOL = 1e-2
EXACT_GRAD_RATIO = 3.0


def train_step_result(flash, bn_frozen, batch, dtype="float32", **overrides):
    """(loss, grads, running statistics) of one train step, in float64."""
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse

    model = get_vit_unet("base", seed=0, flash_train=flash, device="cuda",
                         dtype=dtype, param_dtype=dtype, **overrides).train()
    opt = adamw(model, 1e-4)
    steps = build_step_functions(model, opt, mse, bn_frozen=bn_frozen)
    _, m = steps.train_step(TrainState.create(model=model, optimizer=opt, seed=7),
                            batch)
    grads = torch.cat([p.grad.double().flatten() for p in model.parameters()])
    stats = torch.cat([b.double() for name, b in model.named_buffers()
                       if "running" in name])
    return m["loss"].item(), grads, stats


def compare_train_paths():
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(4, 3, 224, 224, generator=gen, device="cuda")
    batch = {"x": x, "y": 0.9 * x}
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()

    def diffs(a, b):
        return (abs(a[0] - b[0]) / abs(b[0]), rel(a[1], b[1]), rel(a[2], b[2]))

    kern, plain = (train_step_result(f, True, batch) for f in (True, False))
    l, g, st = diffs(kern, plain)
    print(f"  f32 batch-4 frozen-BN train step, kernel path vs plain path: loss "
          f"rel {l:.2e}, grads rel {g:.2e} of the largest, running stats rel "
          f"{st:.2e} (tol {TRAIN_PATH_TOL:.0e})")
    if not max(l, g, st) <= TRAIN_PATH_TOL:
        raise AssertionError("the frozen-BN kernel train step disagrees with "
                             "the plain path")
    for eps in (1e-5, EXACT_EPS):
        ref = train_step_result(False, False, batch, "float64", attn_bn_eps=eps)
        kern, plain = (train_step_result(f, False, batch, attn_bn_eps=eps)
                       for f in (True, False))
        (kl, kg, ks), (pl, pg, ps) = diffs(kern, ref), diffs(plain, ref)
        held = eps == EXACT_EPS
        print(f"  batch-4 exact-BN (eps {eps:.0e}) train step against the plain "
              f"path in float64: kernel path (f32) loss rel {kl:.2e}, running "
              f"stats rel {ks:.2e}, grads rel {kg:.2e} of the largest; plain path "
              f"(f32) {pl:.2e}, {ps:.2e}, {pg:.2e}; kernel vs plain (f32) grads "
              f"rel {diffs(kern, plain)[1]:.2e} "
              + (f"(tol {EXACT_TOL:.0e} on loss and running stats, kernel grads "
                 f"at most {EXACT_GRAD_RATIO:g}x the plain path's)" if held
                 else "(printed, not held)"))
        if held and not (max(kl, ks, pl, ps) <= EXACT_TOL
                         and kg <= EXACT_GRAD_RATIO * pg):
            raise AssertionError("the exact-BN train step disagrees with the "
                                 "float64 plain path")


# A configuration whose level 0 is wider than the kernels take: at
# im_size 256, patch 64 the head dims are 1536, 384 and 96 (levels 0-2), so
# ``kernel_takes`` sends the dh-1536 calls to the plain path and the others to
# the kernels.  Cut to one block a level and one bottleneck block.
GATE_MODEL = dict(im_size=256, patch_size=64, depth_te=1, size_bottleneck=1)


def check_shape_gate():
    """The gate model on the card, kernel path against the plain path with
    the same weights (one model a dtype, its re-attention layers switched
    to ``use_flash=False`` or ``flash_train=False``): eval forward in float32
    (rel 1e-3) and bfloat16 (2e-2), one frozen-BN float32 train step (loss,
    gradients, running statistics at 1e-3) and one exact-BN bfloat16 step
    (loss and running statistics at 2e-2); launch counts per forward and
    step against the calls ``kernel_takes`` admits."""
    import copy
    import importlib
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse
    TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")

    def layers(model, **flags):
        out = [m for m in model.modules() if isinstance(m, ReAttention)]
        for m in out:
            for name, value in flags.items():
                setattr(m, name, value)
        return out

    gen = torch.Generator(device="cuda").manual_seed(6)
    size = GATE_MODEL["im_size"]
    x = torch.randn(2, 3, size, size, generator=gen, device="cuda")
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()
    for dt in ("float32", "bfloat16"):
        model = get_vit_unet("base", seed=0, dtype=dt, param_dtype=dt, device="cuda",
                             **GATE_MODEL)
        by_dh = {}
        for m in layers(model):
            by_dh[m.dim // m.num_heads] = by_dh.get(m.dim // m.num_heads, 0) + 1
        taken = sum(m._kernels for m in layers(model))
        if not 0 < taken == sum(by_dh.values()) - by_dh[1536]:
            raise AssertionError(f"gate model: {taken} calls the kernels take, calls "
                                 f"by head dim {by_dh}")

        tol = MODEL_TOL if dt == "float32" else MODEL_TOL_BF16
        TK.flash_reattention.launches = 0
        TK.flash_reattention.route_launches = dict.fromkeys(TK.ROUTES, 0)
        with torch.inference_mode():
            got = model(x).float()
            torch.cuda.synchronize()
            launches = TK.flash_reattention.launches
            by_route = dict(TK.flash_reattention.route_launches)
            layers(model, use_flash=False)
            want = model(x).float()
            layers(model, use_flash=True)
        r = rel(got, want)
        print(f"  gate model {GATE_MODEL} {dt} eval: calls by head dim {by_dh}, "
              f"kernel launches {launches} by route {by_route} (dh 1536 on the plain "
              f"path); kernel vs plain path rel {r:.3e} (tol {tol:.0e})")
        if launches != taken or got.shape != x.shape or not r <= tol:
            raise AssertionError(f"gate model {dt} eval: {launches} launches for {taken} "
                                 f"calls, or the kernel path disagrees with the plain path")

        bn_frozen = dt == "float32"
        tol = TRAIN_PATH_TOL if bn_frozen else MODEL_TOL_BF16
        results = []
        for flash in (True, False):
            m = copy.deepcopy(model).train()
            layers(m, flash_train=flash)
            opt = adamw(m, 1e-4)
            steps = build_step_functions(m, opt, mse, bn_frozen=bn_frozen)
            reset_train_launches()
            _, met = steps.train_step(TrainState.create(model=m, optimizer=opt, seed=7),
                                      {"x": x, "y": 0.9 * x})
            results.append((met["loss"].item(),
                            torch.cat([p.grad.double().flatten() for p in m.parameters()]),
                            torch.cat([b.double() for name, b in m.named_buffers()
                                       if "running" in name]),
                            train_launches()))
            del m, opt, steps
        (kl, kg, ks, launches), (pl, pg, ps, _) = results
        diffs = (abs(kl - pl) / abs(pl), rel(kg, pg), rel(ks, ps))
        held = diffs if bn_frozen else (diffs[0], diffs[2])
        fwd = "fwd" if bn_frozen else "bn_fwd"
        print(f"  gate model {dt} {'frozen' if bn_frozen else 'exact'}-BN train step: "
              f"launches {launches} ({taken} calls the kernels take); kernel vs plain "
              f"path loss rel {diffs[0]:.2e}, grads rel {diffs[1]:.2e} of the largest, "
              f"running stats rel {diffs[2]:.2e} (tol {tol:.0e} on "
              f"{'all three' if bn_frozen else 'loss and running stats'})")
        if not (launches[fwd] == launches["bwd"] == taken and max(held) <= tol
                and math.isfinite(kl)):
            raise AssertionError(f"gate model {dt} train step disagrees with the plain "
                                 f"path or launched {launches} for {taken} calls")
        del model, results
        torch.cuda.empty_cache()


TRAIN_KERNELS = [  # (key, name, replaces)
    ("fwd", "flash_reattention_train_fwd",
     "vit_unet_tpu/kernels/flash_reattention_train.py:363"),
    ("bwd", "flash_reattention_train_bwd",
     "vit_unet_tpu/kernels/flash_reattention_train.py:451"),
    ("bn_fwd", "flash_reattention_bn_fwd",
     "vit_unet_tpu/kernels/flash_reattention_train.py:741"),
]

TC_SOURCES = {  # training kernels with a tensor-core route: its source
    "fwd": "vit_unet_tpu_torch/kernels/csrc/reattention_bnfwd_tc.cuh",
    "bwd": "vit_unet_tpu_torch/kernels/csrc/reattention_bwd_tc.cuh",
    "bn_fwd": "vit_unet_tpu_torch/kernels/csrc/reattention_bnfwd_tc.cuh",
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run after phase 1 "
                             f"(default: all of {','.join(PHASES)}); the result "
                             "lines are printed only when all ran")
    phases = parser.parse_args(argv).phases.split(",")
    if not phases or any(ph not in PHASES for ph in phases):
        parser.error(f"--phases takes a comma-separated subset of {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    needs_train = any(ph in phases for ph in ("2b", "4"))
    phase_environment((EVAL_SOURCE, TRAIN_SOURCE) if needs_train else (EVAL_SOURCE,))
    if "2a" in phases:
        k = phase_kernels()
    if "2b" in phases:
        tk = phase_train_kernels()
    if "3" in phases:
        launches = phase_slice()
    if "4" in phases:
        train_launches_, _ = phase_train()
    if set(phases) != set(PHASES):
        print(f"chip_smoke: phases {','.join(phases)} only, "
              f"{time.perf_counter() - t_start:.1f} s; no result lines")
        return 0
    kernels = [{
        "name": "flash_reattention",
        "route": "cuda",
        # the interface and the CUDA-core route; the tensor-core route it
        # includes is csrc/reattention_tc.cuh
        "source": "vit_unet_tpu_torch/kernels/csrc/flash_reattention.cu",
        "replaces": "vit_unet_tpu/kernels/flash_reattention.py:111",
        "launches": launches,
        "max_abs_err": k["err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        # no single PyTorch call mixes attention maps across heads
        # (scaled_dot_product_attention has no head-mix)
        "library_ms": None,
        # which (heads, dh, dtype) classes phase 2a ran on which route
        "routes": k["routes"],
    }]
    for key, name, replaces in TRAIN_KERNELS:
        t = tk[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "vit_unet_tpu_torch/kernels/csrc/flash_reattention_train.cu",
            "replaces": replaces, "launches": train_launches_[key],
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # no single PyTorch call computes re-attention with a head mix,
            # dropout and its BatchNorm moments or their gradients
            "library_ms": None})
        if key in TC_SOURCES:
            # the bf16 tensor-core route it includes, which base classes ran
            # on which route, and the main path's launches by route
            kernels[-1].update(
                tensor_core_source=TC_SOURCES[key],
                routes=t["routes"], cuda_core_ms=t["old_ms"],
                route_launches={r: train_launches_[f"{key}_{r}"]
                                for r in ("cuda_core", "tensor_core")})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
