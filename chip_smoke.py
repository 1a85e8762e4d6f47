#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. environment: card name and power limit, CUDA and nvcc versions; builds
   every kernel of the port from ``vit_unet_tpu_torch/kernels/csrc``;
2. every kernel against its plain PyTorch version on the card, at the
   level shapes of the lite and base presets, one rectangular and one
   16-head case, in float32 (TF32 off) and bfloat16, with times and the
   least time the card could take (``bound``);
3. the slice: the base preset at full width (224², bf16) served through
   ``Predictor(batch_size=64)`` with the kernel launch counts of that run,
   the kernel path held against the plain path in float32, and the
   serving rate;
4. a ``{"kernels": [...]}`` line, then the card's name and power limit,
   then ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX.  Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # max|err| / max|plain|
# f32 model path vs plain path: same weights, same f32 math, but other
# summation orders through 12 re-attention calls and 20 LayerNorms
MODEL_TOL = 1e-3
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
SERVE_SIZES = (1, 17, 64, 70)
BATCH = 64


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


def reattention_inputs(batch, heads, dh, n_q, n_k, dtype, seed):
    """Random kernel inputs on the card: q pre-scaled, a random head mix."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = rnd(batch, heads, n_q, dh) * dh ** -0.5
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


def check_kernel(batch, heads, dh, n_q, n_k, dtype, seed=0, reps=10):
    from vit_unet_tpu_torch.kernels.flash_reattention import (
        flash_reattention, flash_reattention_plain)
    args = reattention_inputs(batch, heads, dh, n_q, n_k, dtype, seed)
    got = flash_reattention(*args, num_heads=heads)
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
    print(f"  B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k} {name}: max_abs_err "
          f"{err:.3e} rel {rel:.3e} (tol {TOL[dtype]:.0e}) | kernel {ms:.4f} ms"
          f" plain {plain:.4f} ms bound {bound:.4f} ms ({by})")
    if not (math.isfinite(rel) and rel <= TOL[dtype]):
        raise AssertionError(f"flash_reattention disagrees with its plain "
                             f"version: rel {rel:.3e} > {TOL[dtype]:.0e}")
    return dict(err=err, ms=ms, plain_ms=plain, t_bytes=t_bytes, t_ops=t_ops)


def phase_environment():
    print("== phase 1: environment")
    print("card:", card_line())
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))
    from vit_unet_tpu_torch.kernels import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    _build.build("flash_reattention.cu", extra_flags=("-Xptxas=-v",))
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")


def phase_kernels():
    print("== phase 2: flash_reattention kernel vs plain on the card")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in CHECK_SHAPES:
            check_kernel(*shape, dtype)
    print(f"  main-path shapes (base, B{BATCH}, bf16), calls per forward:")
    total = dict(err=0.0, ms=0.0, plain_ms=0.0, t_bytes=0.0, t_ops=0.0)
    for heads, dh, n, calls in BASE_LEVELS:
        r = check_kernel(BATCH, heads, dh, n, n, torch.bfloat16, reps=10)
        total["err"] = max(total["err"], r["err"])
        for key in ("ms", "plain_ms", "t_bytes", "t_ops"):
            total[key] += calls * r[key]
    total["bound_ms"], total["bound_by"] = bound_of(total["t_bytes"],
                                                    total["t_ops"])
    print(f"  per base forward (12 calls): kernel {total['ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
          f"({total['bound_by']})")
    return total


def phase_slice():
    print("== phase 3: base ViT-UNet served through Predictor")
    from vit_unet_tpu_torch import Predictor, get_vit_unet
    from vit_unet_tpu_torch.kernels.flash_reattention import flash_reattention

    model = get_vit_unet("base", dtype="bfloat16", param_dtype="bfloat16",
                         seed=0)
    pred = Predictor(model, batch_size=BATCH)
    rng = np.random.default_rng(0)
    requests = [rng.random((n, 3, 224, 224), dtype=np.float32)
                for n in SERVE_SIZES]
    forwards = sum(-(-n // BATCH) for n in SERVE_SIZES)

    flash_reattention.launches = 0
    outs = [pred(x) for x in requests]
    torch.cuda.synchronize()
    launches = flash_reattention.launches
    print(f"  requests {SERVE_SIZES}: {forwards} forwards, "
          f"flash_reattention launches {launches}")
    if launches != 12 * forwards:
        raise AssertionError(f"expected 12 launches per forward "
                             f"({12 * forwards}), counted {launches}")
    for x, y in zip(requests, outs):
        if y.shape != x.shape or not np.isfinite(y).all():
            raise AssertionError(f"bad output for a request of {len(x)}: "
                                 f"shape {y.shape}, finite {np.isfinite(y).all()}")

    # the kernel path against the plain path, f32, same weights
    f32 = get_vit_unet("base", seed=0)
    plain = get_vit_unet("base", seed=0, use_flash=False)
    x = torch.from_numpy(requests[2][:8]).cuda()
    with torch.inference_mode():
        got, want = f32(x), plain(x)
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    print(f"  f32 kernel path vs plain path, batch 8: max_abs_err {err:.3e} "
          f"rel {rel:.3e} (tol {MODEL_TOL:.0e})")
    if not rel <= MODEL_TOL:
        raise AssertionError("kernel path disagrees with the plain path")
    del f32, plain, got, want

    xb = torch.from_numpy(requests[2]).cuda()
    with torch.inference_mode():
        ms = time_ms(lambda: model(xb), reps=20)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        pred(requests[2])
    serve_s = (time.perf_counter() - t0) / reps
    card = card_line()
    print(f"  base b{BATCH} bf16 forward: {ms:.3f} ms/batch, "
          f"{BATCH / ms * 1e3:.1f} img/s (device-resident input) [{card}]")
    print(f"  base b{BATCH} bf16 Predictor (numpy in/out): "
          f"{serve_s * 1e3:.3f} ms/batch, {BATCH / serve_s:.1f} img/s [{card}]")
    device_breakdown(model, xb, ms)
    return launches


def device_breakdown(model, x, forward_ms, reps=3, top=8):
    """Device time per forward by kernel (torch.profiler), and the share
    of the forward's time the device is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            model(x)
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / reps / 1e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(t for t, _ in rows)
    print(f"  device time per forward {busy:.3f} ms of {forward_ms:.3f} ms "
          f"(busy {busy / forward_ms:.1%}); top kernels:")
    for t, name in rows[:top]:
        print(f"    {t:8.3f} ms {t / busy:6.1%}  {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    k = phase_kernels()
    launches = phase_slice()
    print(json.dumps({"kernels": [{
        "name": "flash_reattention",
        "route": "cuda",
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
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
