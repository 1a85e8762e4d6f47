#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # everything, with the result lines
    python3 chip_smoke.py --phases 2a      # phase 1 and the named phases only
                                           # (2a, 2b, 3, ..., 11; no result lines)

Phases, each of which raises (exit code != 0) when it fails:

1. environment: card name and power limit, CUDA and nvcc versions; builds
   every kernel source of the port from ``vit_unet_tpu_torch/kernels/csrc``,
   one nvcc per source, all started together;
2. every kernel against its plain PyTorch version on the card, at the
   level shapes of the lite and base presets, in float32 (TF32 off) and
   bfloat16, with times and the least time the card could take (``bound``):
   the eval kernel (2a: also one rectangular case and 16-head cases, a
   peaked map, a handful of keys and a single query; each on the route
   ``kernel_route`` names, float32 on the CUDA cores, bfloat16 on the tensor
   cores; at the main path's shapes both routes in turns, each pass alone,
   and ``scaled_dot_product_attention`` as a reading of the two products'
   cost; and at lite's three level shapes at b64 against the plain version
   built 8 images at a time, beside its time, the bound and SDPA's), and the
   three training kernels (2b) at dropout rate 0 and 0.2,
   plus the autograd Functions' gradients against torch autograd of the
   N x N forward with the same dropout mask; every kernel and Function also
   at 16 heads (``HEAD16_SHAPES``: dh 48, 12, 192 and 384, the
   classifier's N and a ragged case, on the tensor-core routes in bf16 at
   (16, 48) and (16, 12), else on the CUDA-core routes); every kernel also at HViTUNetTF's
   keras class (``KERAS_SHAPES``: 8 heads x dh 192 at N 256 and ragged
   100 x 130); kernel 1's one-pass identity route as ``KerasMHA`` calls it
   (``IDENTITY_CASES``: (8, 192) and (4, 192) at N 256, 64 queries of 256
   keys, ragged 100 x 130 and 1 x 49; at b64 against the two-pass
   tensor-core route in turns and beside SDPA, the same function there),
   and its float32 form (split-precision MMAs, the same cases at f32's
   tolerance, at b64 against the CUDA-core route in turns and beside SDPA
   in f32); the frozen-BN forward's identity route (bf16, no o_norm,
   ``IDENTITY_FWD_CASES`` at rates 0 and 0.2 against plain and the
   CUDA-core route, its dropout bits read back exactly, with a rank's
   ``head_base`` too, and at b64 timed against the CUDA-core route in turns,
   and at rate 0 against ``scaled_dot_product_attention``'s forward, the
   same function there, in turns) and its float32 form (split-precision MMAs, the same checks at f32's
   tolerance); the backward's identity routes in bf16 and f32
   (``IDENTITY_BWD_CASES``: both classes, 64 queries of 256 keys, ragged
   70 x 130, 1 x 49; rates 0 and 0.2, ``head_base`` 0 and 4; dq, dk, dv
   against plain and the general route with I, twice for the same bits;
   the identity Function against float64 autograd; at b64 timed in turns
   against the route each call took before, beside SDPA's backward);
   both forwards' 16-head tensor-core classes (16, 12) and (16, 48)
   (``BN16_CASES``: the classifier's N, ragged, more queries than keys, a
   single query, and at dh 48 more than 256 keys; rates 0 and 0.2; against
   plain and the CUDA-core route, a second call bit for bit, their dropout
   bits read back);
   kernels 2, 3 and 4 at lite's tensor-core classes (4, 12), (4, 48), (4, 192)
   (``LITE_CASES``: each level's N, N 3,136 at B2, ragged, more queries than
   keys, a single query; rates 0 and 0.2, BN term off and on; against plain
   and the CUDA-core route; both forwards' dropout bits read back, their two
   smaller levels at b64 too), and at b64 at lite's three level
   shapes through the counted wrappers against the plain version (built 8
   images at a time), two calls bit for bit where no atomics sum, per call
   on both routes in turns beside the plain's time and the bound; kernel
   3 in float32 at lite's classes on its split-precision tensor-core route
   (``LITE_CASES``, rates 0 and 0.2, BN term off and on, against plain and
   the CUDA-core route at f32's tolerance; at b64 against plain, two calls,
   and timed in turns against the CUDA-core route on the same f32 inputs,
   the bound counting three bf16 MMAs a product); the
   backward and both forwards
   on the routes ``train_bwd_route``, ``train_fwd_route`` and
   ``bn_fwd_route`` name (bfloat16 at base's level shapes on the tensor
   cores), with
   ragged cases and the two
   routes held against each other (the backward's classes without atomics
   also run twice for the same bits; the forwards also at batch 64, and
   their dropout bits read back exactly), and at the main path's shapes
   both routes timed in turns;
3. serving: the base preset at full width (224², bf16) served through
   ``Predictor(batch_size=64)`` with the eval kernel's launch counts by
   route, the kernel path held against the plain path in float32 and in
   bfloat16, and the serving rate, with the eval kernel held on the
   CUDA-core route before and after for comparison; then the two forms of
   the QKV projection (the conv, and the dense (E, E) operator of
   ``conv_token_matrix``) held against each other and timed per call in
   turns at base's three level widths in bf16 and f32, with the gate
   ``qkv_form`` chose, and the whole forward with each form held in turns;
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
   and the exact-BN step with each QKV form held in turns; then lite (the
   CLI's default model, 224², bf16, b64, dropout 0.2): exact-BN steps with
   their launches by route (kernels 4 and 3 on the tensor cores at all
   three level shapes), step time and peak memory, and the step with
   kernels 3 and 4 held on the CUDA-core routes and as named, in turns;
   then its frozen-BN steps the same way (kernels 2 and 3 on the tensor
   cores), with kernel 2 held on its CUDA-core route and as named, in turns;
   then lite in float32 (the CLI's default dtype) the same way, both steps,
   kernels 2 and 4 on the CUDA cores and kernel 3 on its f32 tensor-core
   route, held on the CUDA cores and as named in turns in both; and lite's
   f32 batch-4 steps of the kernel path against the plain path as base's;
5. the trainer: synthetic uint8 pairs written as TFRecord shards, the base
   preset (224², bf16, batch 64, dropout 0.2) trained through ``Fitter``
   for 2 epochs of 24 steps fed by ``TFRecordStream`` ->
   ``prefetch_to_device`` -> ``device_normalize`` (native codec only),
   with the frozen -> exact BN refold at epoch 1 (after epoch 0, a copy
   refolded as the flip does, its exact-BN forward held against the frozen
   forward before it), the launches of each epoch by route, validation,
   callbacks and checkpoints; a fresh ``Fitter`` resumes from the last
   checkpoint bit for bit and trains one epoch fed by
   ``DeviceResidentData``, between two windows of bare steps; then one
   profiled epoch on each feed.  img/s of each feed and the card's idle
   share over steps 2-24 of an epoch, and the codec's MB/s;
6. the entry point: PNG folders of 96 pairs at 256² for the four tasks
   (every colour type and row filter the reader takes, each file read back
   exactly), ``run_denoising.main`` in this process for denoise (base,
   224², bf16, ``--flash``, batch 16, 2 epochs, the first frozen BN),
   deblur, derain and segment (1 epoch each) and the default lite model
   (1 epoch, every launch of kernels 1, 4 and 3 on the tensor cores, and
   kernel 2's route there named the tensor cores too), with
   each epoch's launches by route, img/s and idle share;
   then ``export_predictor`` / ``load_predictor`` of the trained model at
   b64 against ``Predictor`` (bit for bit, launches through the program),
   an f32 program exported on the CPU run on the card, and the b64 forward
   with kernel 1 behind its operator or called straight, in turns;
7. the TF-flavour model: (a) kernels 1-3 at the keras attention's level-0
   shape (B64, 8 heads x dh 192, N 256) with the identity head mix against
   their plain versions in f32 and bf16 (and ``scaled_dot_product_attention``,
   the same function there), timed with their bounds, kernel 1 called as
   ``KerasMHA`` calls it (its identity route in bf16, timed against the
   two-pass tensor-core route in turns) and kernel 3 timed against the
   CUDA-core route in turns; (b) ``HViTUNetTF`` at
   its default width (128², 1,571,098,944 parameters, bf16, random weights
   from a seed) served at b64 through ``Predictor`` from channels-last numpy,
   every kernel-1 launch on the identity route, the kernel path against
   ``use_flash=False``; (b2) the default config as it is, float32, b64:
   every kernel-1 launch on the f32 identity route, timed in turns against
   kernel 1 held on the CUDA-core route;
   (c) 10 AdamW steps at the config's dropout through
   ``build_step_functions``, launches by route (every kernel-2 and
   kernel-3 launch on its identity route), step time, peak memory and a
   profiler breakdown, then a dropout-free f32 batch-4 step of the kernel
   path against the plain path; (c2) the default config as it is (f32) at
   b64 (or the largest batch that fits), 3 AdamW steps with every kernel-2
   and kernel-3 launch on its f32 identity route, then with both held on
   their old routes in turns, step time, peak memory and a profiler
   breakdown; (d) 3 exact-BN steps of the re-attention
   variant (``original_attn=False``), kernels 4 and 3 on the tensor cores
   (the level-0 skip's keras attention on kernels 2's and 3's identity
   routes);
   (e) base b64 bf16 exact-BN steps with and without ``remat`` (the same
   loss, running statistics and generator state; on the kernel path every
   gradient equal bit for bit with the backward's launches replayed from a
   no-remat step, whose inputs must match bit for bit, and a planted
   recomputation fault caught; on the plain path every gradient equal bit
   for bit; peak memory) and the Fourier block's forward and step;
8. the classifier: (a0) kernels 1-4 at its two 16-head level shapes
   ((16, 48) at N 196, (16, 12) at N 784; b64, f32 and bf16, rate 0.2)
   against their plain versions, timed with their bounds and SDPA beside
   kernel 1, kernels 2-4 in bf16 also on both routes in turns, kernel 1's
   log-sum-exp pass alone; (a) ``ViTClassifier`` at the CLI's default widths (224², 16
   heads, 5,975,984 parameters, bf16, b64, random weights from a seed): the
   forward, exact-BN and frozen-BN steps (Adam, label-smoothed CE) with
   their launches asserted by route (every bf16 call on the tensor cores),
   times, peak memory and profiler breakdowns, each step in turns against
   the same step with its forward's newest tensor-core classes held on the
   CUDA cores (faster as named), the kernel path against
   ``use_flash=False``, and one f32
   batch-4 step of the kernel path against the plain path; (c)
   ``run_classification.main`` in this process on 4 class folders of 24
   images (PNG, 8/24/32-bit BMP bottom-up and top-down, and the committed
   JPEG fixtures, every file read back exactly), bf16, ``--flash``, batch
   16, 2 epochs, each epoch's launches by route, img/s over steps 2-4 and
   the idle share, and the JPEG reader's MB/s;
9. multi-GPU: (a) the plain train paths' dropout (ReAttention and
   KerasMHA, b8, rate 0.2) forward and backward under
   ``torch.cuda.set_sync_debug_mode("error")``; (b) kernels 1-4 at the
   sequence-parallel shard shapes (each rank's 512 / 2048 query rows against
   1024 / 4096 keys, base's (8, 96) and (8, 24), bf16 b8) against their
   plain versions, timed with their bounds; (c) a world of 2 processes on
   this one card over gloo (NCCL refuses two ranks on one device): base's
   widths at 512² (levels N 256 / 1024 / 4096, ``sp_min_tokens`` 1024) split
   over the mesh's model axis, and (the steps being built on that mesh)
   the parameters the partition rules name split over it too, tensor and
   sequence parallelism together: (c1) the bf16 b8 eval forward, exact- and
   frozen-BN steps against the single process on the same inputs (dropout
   0; the exact step's loss and gradients, gathered whole, printed beside
   the single process's own spread over other batch orders), launches by route, ms a
   step and the share in the collectives; (c2) the b2 exact-BN step in float64
   against the single process's; (c3) the exact-BN function split over the
   two ranks' rows on the kernels, f32 and bf16, against float64, and three
   faults planted in its cross-rank sums, each of which must fail; (d) data
   parallelism with ZeRO-1 on a 2 x 1 mesh: base at 224² b64 (bf16 on
   float32 parameters) as two ranks of 32, the loss against the
   single-process step, each gradient bucket the mean of the ranks' own,
   each parameter's update AdamW's first from the averaged gradients, each
   rank's optimizer-state bytes, three planted faults (no all-reduce, no
   ZeRO broadcast, no update) that must fail; (d2) the same split at b8 in
   float64 against the single process's step; (e) NCCL at a world of 1: a
   data-parallel step whose all-reduce hands each bucket back unchanged,
   its update AdamW's first, its loss the step's without a mesh.
   Both ranks share one card, so nothing here measures scaling;
10. tensor parallelism: (a) kernels 1-3 at the keras class a rank runs at
   model 2 (HViTUNetTF's level 0, 4 of its 8 heads x dh 192, N 256, b64,
   f32 and bf16) against their plain versions, timed with their bounds and
   SDPA beside kernel 1, and kernels 2 and 3 at a rank's block of heads
   (``head_base``) with dropout against the whole layer's call; (b) a world
   of 2 on this card over gloo, 1 x 2 mesh: ``HViTUNetTF`` at its default
   width (f32, dropout 0, b4) split by the partition rules (kernels 1-3 on
   their f32 identity routes), its eval
   forward and one AdamW step against the single process (loss, output,
   every gradient gathered whole, by a fixed random projection and its
   norm), each rank's parameter bytes, launches by route, ms a step and the
   share in the collectives; (c) base 224² in float64 b2, its clipped
   gradients (the clip at half the global norm) against the single
   process's, and three faults planted (fc2's all-reduce skipped, a split
   gradient averaged over every rank, the clip norm taken locally), each
   of which must fail; (d) ``train_sp_longcontext.main`` on the mesh, tensor
   and sequence parallel with no change of its own.  Base at 512² with both
   is phase 9's (c1) and (c2);
11. the example scripts: every run of ``convergence_segmentation`` and
   ``convergence_sidd`` through its ``main``, its constants cut to an
   epoch or two of a few steps (the loss must fall: the mean of its last
   four steps below its first four's, over the warmup epoch for the hard
   flip and the tracking warmup, whose flips are the negative controls;
   launches by route, every kernel-2 and kernel-3 launch of the
   ``HViTUNetTF`` SIDD runs on its identity route), the results file
   written (every lite run's kernel-2, kernel-4 and kernel-3 launches on the
   tensor cores); ``convert_tfrecords`` on PNG pairs (the count read back from the
   names, a record read back exactly), ``train_denoising`` on those shards
   (lite 128², bf16, ``--flash``, one epoch, its PSNR probes) and
   ``serve_model`` from a ``Fitter`` checkpoint;
12. a ``{"kernels": [...]}`` line (it fails if a kernel of the list was
   launched no time on the main paths), then the card's name and power
   limit, then ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX.  Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import math
import os
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
# 16 heads: the classifier's two levels at its N, a ragged case, and the two
# wider head dims ``kernel_takes`` admits at 16 heads (JAX's ``_flash_ok``
# takes 16 heads only up to dh 48); kernels 1-4 on the tensor-core routes
# in bf16 at (16, 48) and (16, 12), on the CUDA-core routes in f32 and at
# dh 192 and 384
HEAD16_SHAPES = [  # (batch, heads, dh, n_q, n_k)
    (4, 16, 48, 196, 196), (4, 16, 12, 784, 784), (4, 16, 48, 100, 130),
    (2, 16, 192, 196, 196), (2, 16, 384, 49, 49),
]
CHECK_SHAPES += HEAD16_SHAPES
# HViTUNetTF's level-0 keras attention class (8 heads x dh 192) at its N and
# a ragged case over more than one 64-key tile; bf16 on the tensor cores for
# kernels 1 and 3 (kernel 2 on the CUDA cores)
KERAS_SHAPES = [(4, 8, 192, 256, 256), (2, 8, 192, 100, 130)]
CHECK_SHAPES += KERAS_SHAPES
# kernel 1's identity-mix route (KerasMHA's calls, bf16): its two classes at
# N 256, the level-0 skip's 64 queries of 256 keys, ragged, a single query
IDENTITY_CASES = [(4, 8, 192, 256, 256), (4, 4, 192, 256, 256), (4, 8, 192, 64, 256),
                  (2, 8, 192, 100, 130), (2, 8, 192, 1, 49)]
EDGE_CASES = [  # (label, batch, heads, dh, n_q, n_k, q scale), bf16
    ("peaked", 4, 8, 96, 196, 196, 8.0),      # large lse, far from uniform maps
    ("few keys", 4, 8, 24, 100, 9, 1.0),      # Nk < 16
    ("one query", 4, 8, 384, 1, 49, 1.0),     # Nq = 1
]
SERVE_SIZES = (1, 17, 64, 70)
BATCH = 64
PHASES = ("2a", "2b", "3", "4", "5", "6", "7", "8", "9", "10", "11")
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


def reattention_inputs(batch, heads, dh, n_q, n_k, dtype, seed, q_scale=1.0,
                       identity=False):
    """Random kernel inputs on the card: q pre-scaled, a random head mix
    (``identity``: KerasMHA's, m_eff = I and c_eff = 0)."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = rnd(batch, heads, n_q, dh) * (q_scale * dh ** -0.5)
    k = rnd(batch, heads, n_k, dh)
    v = rnd(batch, n_k, heads * dh)
    m_eff = rnd(heads, heads) * heads ** -0.5
    c_eff = rnd(heads) * 0.1
    if identity:
        m_eff, c_eff = torch.eye(heads), torch.zeros(heads)
    from vit_unet_tpu_torch.kernels.flash_reattention import (
        expand_reattention_affine)
    w, b = expand_reattention_affine(m_eff, c_eff, dh=dh)
    dev = "cuda"
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            w.to(dev), b.to(dev))


def bound_parts(batch, heads, dh, n_q, n_k, dtype, mix=True,
                split=False) -> tuple[float, float]:
    """Least time for one call: bytes (inputs read once, output written
    once) over HBM bandwidth vs operations (scores, head mix, product with
    V) over the peak rate for the input type.  ``mix=False``: the identity
    mix, which the function does not need (no w, b, no mix operations).
    ``split``: the f32 identity route, whose products are issued as three
    bf16 MMAs each on the tensor cores: its operations are those it issues,
    3 x 4 A dh, over the bf16 peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (item * (batch * heads * (n_q + n_k) * dh + batch * n_k * heads * dh
                      + batch * n_q * heads * dh)
              + (4 * (heads * heads * dh + heads * dh) if mix else 0))
    ops = 2.0 * batch * heads * n_q * n_k * (2 * dh + (heads if mix else 0))
    if split:
        return nbytes / PEAK_BYTES * 1e3, 3 * ops / PEAK_FLOPS[torch.bfloat16] * 1e3
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
                 q_scale=1.0, label="", identity=False, identity_mix=False):
    """Kernel 1 against its plain version on the route ``kernel_route``
    names; ``identity_mix``: called as KerasMHA calls it, with the identity
    mix and the flag that says so (``identity`` inputs without the flag)."""
    from vit_unet_tpu_torch.kernels.flash_reattention import (
        flash_reattention, flash_reattention_plain, kernel_route)
    args = reattention_inputs(batch, heads, dh, n_q, n_k, dtype, seed, q_scale,
                              identity or identity_mix)
    route = kernel_route(dtype, heads, dh, identity_mix)
    before = flash_reattention.route_launches[route]
    got = flash_reattention(*args, num_heads=heads, identity_mix=identity_mix)
    if flash_reattention.route_launches[route] != before + 1:
        raise AssertionError(f"the call did not take the {route} route")
    want = flash_reattention_plain(*args, num_heads=heads)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    ms = time_ms(lambda: flash_reattention(*args, num_heads=heads,
                                           identity_mix=identity_mix), reps)
    plain = time_ms(lambda: flash_reattention_plain(*args, num_heads=heads), reps)
    t_bytes, t_ops = bound_parts(batch, heads, dh, n_q, n_k, dtype, mix=not identity_mix,
                                 split=route == "identity_f32")
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


def time_identity(batch, heads, dh, n, dtype=torch.bfloat16, reps=10):
    """At an identity-mix class: the route the call took before the
    identity route (bf16: the two-pass tensor-core route; float32: the
    CUDA cores) and the one-pass identity route on the same inputs in turns
    (old, new, new, old), held against each other, each one's error
    against the plain version printed.  Returns dict(old=, new=) ms."""
    from vit_unet_tpu_torch.kernels.flash_reattention import (
        flash_reattention_plain, kernel_route, launch_passes)
    q, k, v, w, b = reattention_inputs(batch, heads, dh, n, n, dtype, 0, identity=True)
    routes = (kernel_route(dtype, heads, dh), kernel_route(dtype, heads, dh, True))
    outs = {r: torch.empty(batch, n, heads * dh, dtype=dtype, device="cuda") for r in routes}
    lses = {r: torch.empty(batch, heads, n, device="cuda") for r in routes}
    run = lambda r: launch_passes(q, k, v, w, b, lses[r], outs[r], route=r)
    turns = [(r, time_ms(lambda: run(r), reps)) for r in routes + routes[::-1]]
    d_out = rel_err(outs[routes[1]], outs[routes[0]])[1]
    d_lse = (lses[routes[1]] - lses[routes[0]]).abs().max().item()
    old = min(t for r, t in turns if r == routes[0])
    new = min(t for r, t in turns if r == routes[1])
    want = flash_reattention_plain(q, k, v, w, b, num_heads=heads)
    rels = {r: rel_err(outs[r], want)[1] for r in routes}
    print(f"    H{heads} dh{dh} N{n} {str(dtype)[6:]} identity mix in turns: "
          + ", ".join(f"{r} {t:.4f} ms" for r, t in turns)
          + f"; {routes[0]} / {routes[1]} {old / new:.2f}x; out rel {d_out:.3e}, "
          f"lse abs {d_lse:.3e}; against plain: "
          + ", ".join(f"{r} out rel {x:.3e}" for r, x in rels.items()))
    if not (d_out <= TOL[dtype] and d_lse <= (1e-3 if dtype == torch.bfloat16 else 1e-4)):
        raise AssertionError(f"the identity route disagrees with {routes[0]}")
    return dict(old=old, new=new)


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


def lite_eval():
    """Kernel 1 at lite's three level shapes at b64, bf16, through its
    counted wrapper on the route ``kernel_route`` names, against its plain
    version built LITE_SLICE images at a time (eval draws no dropout, so a
    slice is the call's own), per call beside the plain version's time, the
    bound and ``scaled_dot_product_attention``'s (not the same function:
    what the two products alone cost).  Returns {class: row}."""
    from vit_unet_tpu_torch.kernels.flash_reattention import (
        flash_reattention, flash_reattention_plain, kernel_route)
    res = {}
    card = card_line()
    dtype = torch.bfloat16
    for heads, dh, n, calls in LITE_LEVELS:
        q, k, v, w, b = reattention_inputs(BATCH, heads, dh, n, n, dtype, 0)
        route = kernel_route(dtype, heads, dh)
        before = flash_reattention.route_launches[route]
        run = lambda: flash_reattention(q, k, v, w, b, num_heads=heads)
        got = run()
        if flash_reattention.route_launches[route] != before + 1:
            raise AssertionError(f"lite eval H{heads} dh{dh}: the call did not take the "
                                 f"{route} route")
        sliced = lambda: torch.cat([
            flash_reattention_plain(q[i:i + LITE_SLICE], k[i:i + LITE_SLICE],
                                    v[i:i + LITE_SLICE], w, b, num_heads=heads)
            for i in range(0, BATCH, LITE_SLICE)])
        err, rel = rel_err(got, sliced())
        require(f"lite eval [{route}] B{BATCH} H{heads} dh{dh} N{n}", rel, TOL[dtype])
        del got
        vh = v.view(BATCH, n, heads, dh).transpose(1, 2)
        row = dict(route=route, err=err, ms=time_ms(run, 10),
                   plain_ms=time_ms(sliced, 2, warmup=0),
                   sdpa_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                       q, k, vh, scale=1.0), 10),
                   bound=bound_of(*bound_parts(BATCH, heads, dh, n, n, dtype)),
                   calls_per_forward=calls)
        res[f"H{heads} dh{dh} N{n}"] = row
        print(f"    lite H{heads} dh{dh} N{n} B{BATCH} bf16 eval [{route}]: {row['ms']:.4f} ms "
              f"a call, plain {row['plain_ms']:.4f} ms (by {LITE_SLICE} images), bound "
              f"{row['bound'][0]:.4f} ms ({row['bound'][1]}), sdpa {row['sdpa_ms']:.4f} ms; "
              f"max_abs_err {err:.3e} rel {rel:.3e} [{card}]")
    return res


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
    print(f"  lite's level shapes (B{BATCH}, bf16), a call:")
    total["lite"] = lite_eval()
    print("  the identity-mix route (KerasMHA's calls), bf16:")
    ident = [check_kernel(*shape, torch.bfloat16, identity_mix=True, label="identity")
             for shape in IDENTITY_CASES]
    total["identity"] = dict(err=max(r["err"] for r in ident), classes={})
    for heads in (8, 4):
        r = check_kernel(BATCH, heads, 192, 256, 256, torch.bfloat16, identity_mix=True,
                         label="identity")
        ident.append(r)
        r["tensor_core_ms"] = time_identity(BATCH, heads, 192, 256)["old"]
        r["sdpa_ms"] = sdpa_ms(BATCH, heads, 192, 256, torch.bfloat16)
        r["bound_ms"], r["bound_by"] = bound_of(r["t_bytes"], r["t_ops"])
        print(f"    H{heads} dh192 N256 B{BATCH} identity_tc {r['ms']:.4f} ms a call, "
              f"two-pass tensor_core {r['tensor_core_ms']:.4f}, sdpa {r['sdpa_ms']:.4f}, "
              f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']})")
        total["identity"]["classes"][f"H{heads} dh192 N256"] = r
    checks += ident
    print("  the float32 identity route (KerasMHA's f32 calls, split-precision MMAs):")
    ident32 = [check_kernel(*shape, torch.float32, identity_mix=True, label="identity")
               for shape in IDENTITY_CASES]
    total["identity_f32"] = dict(err=max(r["err"] for r in ident32), classes={})
    for heads in (8, 4):
        r = check_kernel(BATCH, heads, 192, 256, 256, torch.float32, identity_mix=True,
                         label="identity")
        ident32.append(r)
        r["cuda_core_ms"] = time_identity(BATCH, heads, 192, 256, torch.float32)["old"]
        r["sdpa_ms"] = sdpa_ms(BATCH, heads, 192, 256, torch.float32)
        r["bound_ms"], r["bound_by"] = bound_of(r["t_bytes"], r["t_ops"])
        print(f"    H{heads} dh192 N256 B{BATCH} f32 identity_f32 {r['ms']:.4f} ms a call, "
              f"cuda_core {r['cuda_core_ms']:.4f}, sdpa {r['sdpa_ms']:.4f}, "
              f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"[{card_line()}]")
        total["identity_f32"]["classes"][f"H{heads} dh192 N256"] = r
    checks += ident32
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


# --- the QKV forms ------------------------------------------------------------

QKV_LEVELS = [(192, 784), (768, 196), (3072, 49)]   # base's level (E, N)
# the two forms of the same Q/K/V in bf16: each rounds its product's output
# to bf16 once, from f32 sums in another order
QKV_TOL = 2e-2


def check_qkv_forms(e, n, dtype, reps=10):
    """Both forms of one layer's Q/K/V at (B64, N, E): agreement for self-
    and cross-attention, and the forward and forward+backward per call in
    turns (conv, matmul, matmul, conv)."""
    from vit_unet_tpu_torch.nn.reattention import ReAttention, qkv_form
    layer = ReAttention(e, num_heads=8, dtype=dtype).to("cuda", dtype)
    g = torch.Generator(device="cuda").manual_seed(e)
    x, x2 = (torch.randn(BATCH, n, e, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    forms = {"conv": layer._qkv_conv, "matmul": layer._qkv_matmul}
    with torch.no_grad():
        for args in ((x, x, x), (x2, x, x)):
            a, b = (forms[f](*args) for f in ("conv", "matmul"))
            rel = max(rel_err(u, v)[1] for u, v in zip(b, a))
            if not rel <= QKV_TOL:
                raise AssertionError(f"QKV forms disagree at E={e} {dtype}: "
                                     f"rel {rel:.3e} > {QKV_TOL:.0e}")
    xg = x.detach().requires_grad_()
    grads = [torch.randn(BATCH, 8, n, e // 8, generator=g, device="cuda").to(dtype)
             for _ in range(3)]

    def fwd_bwd(form):
        torch.autograd.backward(forms[form](xg, xg, xg), grads)

    def fwd(form):
        with torch.no_grad():
            forms[form](x, x, x)

    turns = {label: [(f, time_ms(lambda: run(f), reps))
                     for f in ("conv", "matmul", "matmul", "conv")]
             for label, run in (("fwd", fwd), ("fwd+bwd", fwd_bwd))}
    name = str(dtype).replace("torch.", "")
    print(f"  QKV E{e} N{n} B{BATCH} {name} (forms agree, rel {rel:.2e}; gate: "
          f"{qkv_form(e, dtype)}): " + "; ".join(
              f"{label} " + ", ".join(f"{f} {t:.4f}" for f, t in pairs) + " ms"
              for label, pairs in turns.items()))


def qkv_forms_in_turns(time_one, label):
    """``time_one()`` (ms) with the QKV form held on each form in turns
    (conv, matmul, matmul, conv)."""
    import importlib
    RA = importlib.import_module("vit_unet_tpu_torch.nn.reattention")
    turns = []
    for form in ("conv", "matmul", "matmul", "conv"):
        with mock.patch.object(RA, "qkv_form", lambda e, dt, f=form: f):
            turns.append((form, time_one()))
    print(f"  {label}, QKV form held in turns: "
          + ", ".join(f"{f} {t:.3f} ms" for f, t in turns) + f" [{card_line()}]")


def phase_qkv():
    """Per call, both forms at base's three level widths in bf16 and f32."""
    print("  QKV forms per call (ms, both forms in turns):")
    for dtype in (torch.bfloat16, torch.float32):
        for e, n in QKV_LEVELS:
            check_qkv_forms(e, n, dtype)


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
    if by_route != {**dict.fromkeys(TK.ROUTES, 0), "tensor_core": 12 * forwards}:
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
    phase_qkv()
    with torch.inference_mode():
        qkv_forms_in_turns(lambda: time_ms(lambda: model(xb), 20),
                           f"base b{BATCH} bf16 forward")
    print(f"  phase 3: {time.perf_counter() - t_phase:.1f} s")
    return launches


def device_rows(run, reps=3, inference=False) -> dict:
    """Device time per ``run()`` by kernel name (torch.profiler), ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ctx = torch.inference_mode() if inference else torch.enable_grad()
    with ctx, profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / reps / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def device_breakdown(run, total_ms, what, reps=3, top=8, inference=False):
    """Device time per ``run()`` by kernel (torch.profiler), and the share
    of its time the device is busy."""
    rows = sorted(((t, k) for k, t in device_rows(run, reps, inference).items()),
                  reverse=True)
    busy = sum(t for t, _ in rows)
    print(f"  device time per {what} {busy:.3f} ms of {total_ms:.3f} ms "
          f"(busy {busy / total_ms:.1%}); top kernels:")
    for t, name in rows[:top]:
        print(f"    {t:8.3f} ms {t / busy:6.1%}  {name[:90]}")


def qkv_breakdown(run, what, top=12):
    """Device time per ``run()`` by kernel with the QKV form held on the
    conv and then on the matmul form, side by side, the kernels whose time
    moved most first; the rest summed on one line."""
    import importlib
    RA = importlib.import_module("vit_unet_tpu_torch.nn.reattention")
    rows = {}
    for form in ("conv", "matmul"):
        with mock.patch.object(RA, "qkv_form", lambda e, dt, f=form: f):
            run()
            rows[form] = device_rows(run, reps=2)
    names = sorted(set(rows["conv"]) | set(rows["matmul"]),
                   key=lambda k: -abs(rows["conv"].get(k, 0) - rows["matmul"].get(k, 0)))
    tot = {f: sum(r.values()) for f, r in rows.items()}
    print(f"  device time per {what} by QKV form: conv {tot['conv']:.3f} ms, matmul "
          f"{tot['matmul']:.3f} ms, conv - matmul {tot['conv'] - tot['matmul']:.3f} ms; "
          f"by kernel (conv ms, matmul ms, difference):")
    for name in names[:top]:
        a, b = rows["conv"].get(name, 0.0), rows["matmul"].get(name, 0.0)
        print(f"    {a:8.3f} {b:8.3f} {a - b:+8.3f}  {name[:80]}")
    rest = [(rows["conv"].get(k, 0.0), rows["matmul"].get(k, 0.0)) for k in names[top:]]
    a, b = sum(x for x, _ in rest), sum(y for _, y in rest)
    print(f"    {a:8.3f} {b:8.3f} {a - b:+8.3f}  the other {len(rest)} kernels")


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
] + HEAD16_SHAPES + KERAS_SHAPES
RATE = 0.2
# the backward's tensor-core route at ragged and rectangular sizes: (batch,
# heads, dh, n_q, n_k); a key tile with fewer valid keys than one MMA tile,
# a single query, more keys than queries and the other way round
BWD_EDGE_CASES = [
    (4, 8, 24, 100, 9), (4, 8, 24, 1, 49), (4, 8, 96, 1, 49), (4, 8, 384, 1, 49),
    (4, 8, 96, 96, 200), (4, 8, 24, 200, 96), (2, 8, 384, 70, 130),
]
# the backward's 16-head classes (the classifier's) at its N and ragged: more
# keys than queries over 9 key tiles of 16, more queries than keys over 3
# tiles of 32, and a single query
BWD16_CASES = HEAD16_SHAPES[:3] + [(2, 16, 12, 200, 96), (2, 16, 12, 1, 49)]
# the forwards also with more keys than the chunked form keeps A of (256),
# so A is recomputed for every column chunk
FWD_EDGE_CASES = BWD_EDGE_CASES + [(2, 8, 96, 40, 300), (2, 8, 384, 17, 270)]
# both forwards' 16-head classes on the tensor cores, (16, 12) and (16, 48),
# kernel 2 and kernel 4 alike: the classifier's N, ragged over partial key
# tiles, more queries than keys, a single query, and at dh 48 more keys
# than the chunked form keeps A of (256), so A is recomputed for every
# column chunk (their b64 calls are phase 8's)
BN16_CASES = [(4, 16, 12, 784, 784), (2, 16, 12, 100, 130), (2, 16, 12, 200, 96),
              (2, 16, 12, 1, 49), (4, 16, 48, 196, 196), (2, 16, 48, 100, 130),
              (2, 16, 48, 200, 96), (2, 16, 48, 1, 49), (2, 16, 48, 40, 300)]
# (batch, heads, dh, N) of their dropout-bit read-back: counts of keys m =
# j mod P at (16, 12), each bit at (16, 48) over more than 256 keys
HEAD16_BITS = [(4, 16, 12, 784), (2, 16, 48, 300)]
# (heads, dh) classes of the backward's tensor-core route in its maps +
# products form: no atomics, so a call repeats bit for bit
ATOMIC_FREE_BWD = {(8, 384)}
# lite's classes on the tensor cores (kernels 3 and 4): each at its level N
# (N 3,136 at B2; at b64 ``lite_b64`` holds it by LITE_SLICE images),
# ragged over partial key tiles and dropout windows, more queries than
# keys, a single query
LITE_CASES = [(2, 4, 12, 3136, 3136), (2, 4, 12, 100, 130), (2, 4, 12, 200, 96),
              (2, 4, 12, 1, 49), (4, 4, 48, 784, 784), (2, 4, 48, 100, 130),
              (2, 4, 48, 1, 49), (4, 4, 192, 196, 196), (2, 4, 192, 70, 130),
              (2, 4, 192, 1, 49)]
# the forwards at b64 against their plain versions: lite's two smaller levels
LITE_B64_FWD = [(BATCH, 4, 48, 784, 784), (BATCH, 4, 192, 196, 196)]
# (batch, heads, dh, N) of the exact-BN forward's dropout-bit read-back at
# lite's classes: each bit where P >= N, counts of keys m = j mod P at dh 12
LITE_BITS = [(2, 4, 12, 300), (2, 4, 48, 192), (2, 4, 192, 196)]
# lite's levels at 224²: (heads, dh, N, calls a train step or forward)
LITE_LEVELS = [(4, 192, 196, 2), (4, 48, 784, 3), (4, 12, 3136, 3)]
# images a plain version holds at a time at b64: at N 3,136 one f32 N x N
# map of 8 images is 1.3 GB
LITE_SLICE = 8
# the frozen-BN forward's identity route (KerasMHA's training calls, bf16):
# its two classes at N 256, the level-0 skip's 64 queries of 256 keys,
# ragged over a partial dropout window, a single query
IDENTITY_FWD_CASES = [(4, 8, 192, 256, 256), (4, 4, 192, 256, 256), (4, 8, 192, 64, 256),
                      (2, 8, 192, 100, 130), (2, 8, 192, 1, 49)]
# (batch, heads, N, head_base) of its dropout-bit read-back: every bit where
# N <= dh, counts at N 256, a rank's block of heads
IDENTITY_BITS = [(2, 8, 192, 0), (2, 4, 100, 4), (2, 8, 256, 0)]


def train_inputs(batch, heads, dh, n_q, n_k, dtype, seed=0, identity=False):
    """Training-kernel inputs on the card.  Scores have std ~3, so the maps
    are peaked and the batch variance of the head mix stays far above the
    BatchNorm epsilon.  ``identity``: KerasMHA's head mix, I and 0."""
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
    if identity:
        m_eff = torch.eye(heads, device=dev)
        c_eff = torch.zeros(heads, device=dev)
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
        # the identity mix: no o_norm, the two products of each head
        "fwd_identity": (qkv + item * batch * n_q * proj + lse, 4.0 * area * dh),
        "bn_fwd": (qkv + onorm + lse + 4 * batch * heads * (heads + 1) * n_q,
                   fwd_ops + area * (heads + 1)),
        "bwd": (qkv + item * batch * n_q * proj + 2 * lse
                + 4 * (batch * heads * (n_q + n_k) * dh + batch * n_k * proj),
                2.0 * area * (5 * dh + 2 * heads) + 2.0 * area * heads),
    }
    # the identity mix's backward: no head mix or BN term, five products
    parts["bwd_identity"] = (parts["bwd"][0], 10.0 * area * dh)
    bounds = {k: (b / PEAK_BYTES * 1e3, o / PEAK_FLOPS[dtype] * 1e3)
              for k, (b, o) in parts.items()}
    if dtype == torch.float32:
        # the f32 identity routes: the bf16 MMAs they issue, three a product
        for key in ("fwd_identity", "bwd_identity"):
            bounds[key] = (bounds[key][0], 3 * parts[key][1] / PEAK_FLOPS[torch.bfloat16] * 1e3)
        # kernel 3's f32 tensor-core route: its five products as three bf16
        # MMAs each, the mixes and the BN term counted as the bf16 route's
        mixes = parts["bwd"][1] - 10.0 * area * dh
        bounds["bwd_tc_f32"] = (bounds["bwd"][0], (3 * 10.0 * area * dh + mixes)
                                / PEAK_FLOPS[torch.bfloat16] * 1e3)
    return bounds


def rel_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def require(name, rel, tol):
    if not (math.isfinite(rel) and rel <= tol):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"rel {rel:.3e} > {tol:.0e}")


def check_train_kernels(batch, heads, dh, n_q, n_k, dtype, rate, reps=0,
                        identity=False):
    """Each training kernel against its plain version on the same inputs;
    with ``reps``, their times.  Returns {kernel: dict(err, ms, plain_ms)}."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, m_eff, c_eff, g_out, seed = train_inputs(batch, heads, dh, n_q,
                                                      n_k, dtype, identity=identity)
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
    # by LITE_SLICE images at a time: at lite's b64 N 3,136 one f32 score map
    # of all 64 is 10 GiB
    lse = torch.cat([torch.logsumexp(qb.float() @ kb.float().transpose(-1, -2), -1)
                     for qb, kb in zip(q.split(LITE_SLICE), k.split(LITE_SLICE))])
    gen = torch.Generator(device="cuda").manual_seed(4)
    d = torch.randn(batch, heads, n_q, generator=gen, device="cuda")
    extra = ((torch.randn(heads, heads, generator=gen, device="cuda") * 0.1,
              torch.randn(heads, generator=gen, device="cuda") * 0.1) if bn else None)
    return q, k, v, lse, g_out, m_eff, d, seed, rate, extra


def check_bwd_routes(batch, heads, dh, n_q, n_k, rate, bn, dtype=torch.bfloat16):
    """The backward (bf16, or f32 at lite's classes) on the route
    ``train_bwd_route`` names against its plain version, and against the
    CUDA-core route on the same inputs; f32 gradients, so both at
    F32_OUT_TOL of the input type."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    args = bwd_inputs(batch, heads, dh, n_q, n_k, dtype, rate, bn)
    route = T.train_bwd_route(dtype, heads, dh)
    before = dict(T.train_bwd.route_launches)
    got = T.train_bwd(*args)
    if T.train_bwd.route_launches[route] != before[route] + 1:
        raise AssertionError(f"the call did not take the {route} route")
    want = T.train_bwd_plain(*args)
    other = T.launch_bwd(*args, route="cuda_core") if route != "cuda_core" else None
    repeat = (T.launch_bwd(*args, route=route)
              if route == "tensor_core" and (heads, dh) in ATOMIC_FREE_BWD else None)
    torch.cuda.synchronize()
    tol = F32_OUT_TOL[dtype]
    rels = [rel_err(a, b)[1] for a, b in zip(got, want)]
    for r in rels:
        require(f"bwd [{route}] B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k}", r, tol)
    msg = (f"  bwd [{route}] B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k} rate {rate} "
           f"bn {bn}: dq dk dv rel " + " ".join(f"{r:.2e}" for r in rels))
    if repeat:
        if not all(torch.equal(a, b) for a, b in zip(got, repeat)):
            raise AssertionError(f"bwd [{route}] H{heads} dh{dh}: two calls on the same "
                                 f"inputs differ, where the class has no atomics")
        msg += " | repeat bit for bit"
    if other is not None:
        routes = [rel_err(a, b)[1] for a, b in zip(got, other)]
        for r in routes:
            require(f"bwd {route} vs cuda_core", r, tol)
        msg += " | vs cuda_core " + " ".join(f"{r:.2e}" for r in routes)
    print(msg)
    return max(rel_err(a, b)[0] for a, b in zip(got, want))


def lite_b64(heads, dh, n, keys, dtype=torch.bfloat16):
    """Kernels ``keys`` of 2 ("fwd"), 4 ("bn_fwd") and 3 ("bwd") at one of
    lite's level shapes at b64 (rate 0.2, the backward with the BN term),
    each through its counted wrapper, whose route count must rise by one,
    against its plain version on the same inputs: out, lse and o_norm at
    FWD_TOLS, S, C, lse and o_norm at BN_FWD_TOLS, dq, dk and dv at
    F32_OUT_TOL.  The plain versions are built LITE_SLICE images at a time
    (each image group draws the call's own dropout bits) and timed so.  A
    second call on the launch function must give the outputs no atomics
    sum (the forwards' every output; the backward's dk and dv) bit for bit,
    and dq within F32_OUT_TOL.  Returns {kernel: (max_abs_err, plain_ms)}."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    args = bwd_inputs(BATCH, heads, dh, n, n, dtype, RATE, True)
    q, k, v, lse, g, m_eff, d, seed, _, extra = args
    vsum = v.float().sum(1)
    c_eff = torch.randn(heads, generator=torch.Generator(device="cuda").manual_seed(5),
                        device="cuda") * 0.1
    fwd2_route = T.train_fwd_route(dtype, heads, dh)
    fwd_route = T.bn_fwd_route(dtype, heads, dh)
    bwd_route = T.train_bwd_route(dtype, heads, dh)
    kernels = {
        "fwd": (T.train_fwd, fwd2_route,
                lambda: T.train_fwd(q, k, v, vsum, m_eff, c_eff, seed, RATE),
                lambda: T.launch_train_fwd(q, k, v, vsum, m_eff, c_eff, seed, RATE,
                                           route=fwd2_route),
                lambda s, i: T.train_fwd_plain(q[s], k[s], v[s], vsum[s], m_eff, c_eff, seed,
                                               RATE, batch_base=i),
                [t[dtype] for t in FWD_TOLS], (0, 1, 2)),
        "bn_fwd": (T.bn_fwd, fwd_route, lambda: T.bn_fwd(q, k, v, seed, RATE),
                   lambda: T.launch_bn_fwd(q, k, v, seed, RATE, route=fwd_route),
                   lambda s, i: T.bn_fwd_plain(q[s], k[s], v[s], seed, RATE, batch_base=i),
                   [t[dtype] for t in BN_FWD_TOLS], (0, 1, 2, 3)),
        "bwd": (T.train_bwd, bwd_route, lambda: T.train_bwd(*args),
                lambda: T.launch_bwd(*args, route=bwd_route),
                lambda s, i: T.train_bwd_plain(q[s], k[s], v[s], lse[s], g[s], m_eff, d[s],
                                               seed, RATE, extra, batch_base=i),
                [F32_OUT_TOL[dtype]] * 3, (1, 2)),
    }
    res = {}
    for key in keys:
        wrapper, route, counted, launch, plain, tols, exact = kernels[key]
        before = wrapper.route_launches[route]
        got = counted()
        if wrapper.route_launches[route] != before + 1:
            raise AssertionError(f"lite {key} H{heads} dh{dh} B{BATCH}: the call did not "
                                 f"take the {route} route")
        again = launch()
        sliced = lambda: [torch.cat(parts) for parts in zip(
            *(plain(slice(i, i + LITE_SLICE), i) for i in range(0, BATCH, LITE_SLICE)))]
        want = sliced()
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        for (_, rel), tol in zip(errs, tols):
            require(f"lite {key} [{route}] B{BATCH} H{heads} dh{dh} N{n}", rel, tol)
        same = all(torch.equal(got[i], again[i]) for i in exact)
        rest = [rel_err(got[i], again[i])[1] for i in range(len(got)) if i not in exact]
        print(f"    H{heads} dh{dh} N{n} B{BATCH} {key} [{route}] vs plain (by {LITE_SLICE} "
              f"images): rel " + " ".join(f"{r:.2e}" for _, r in errs)
              + f"; two calls bit for bit {same}"
              + "".join(f", dq rel {r:.2e} (atomics)" for r in rest))
        if not same:
            raise AssertionError(f"lite {key} H{heads} dh{dh}: two b64 calls differ where "
                                 f"no atomics sum")
        for r in rest:
            require(f"lite {key} dq of two calls", r, F32_OUT_TOL[dtype])
        del got, again, want
        res[key] = (max(e for e, _ in errs), time_ms(sliced, 2, warmup=0))
    return res


def lite_kernels(cases_err, dtype=torch.bfloat16):
    """Kernels 2, 4 and 3 at lite's three level shapes at b64, rate 0.2 (the
    backward with the BN term), bf16; in float32 kernel 3 alone, on its
    split-precision route (kernels 2 and 4 take the CUDA cores in f32):
    each held against its plain version (``lite_b64``), then per call on
    the CUDA-core route and on the route its route function names, in
    turns on the same inputs, beside the plain version's time and the bound
    (f32: three bf16 MMAs a product).  ``cases_err``: the worst max_abs_err
    of each kernel over LITE_CASES.  Returns {class: {kernel: row}}, the
    row's ``err`` the b64 call's."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    keys = ("bwd",) if dtype == torch.float32 else ("fwd", "bn_fwd", "bwd")
    name = str(dtype)[6:]
    res = {}
    card = card_line()
    for heads, dh, n, calls in LITE_LEVELS:
        shape = f"H{heads} dh{dh} N{n}"
        bounds = train_bounds(BATCH, heads, dh, n, n, dtype)
        held = lite_b64(heads, dh, n, keys, dtype)
        torch.cuda.empty_cache()
        turns = {key: (time_bwd_routes(BATCH, heads, dh, n, reps=5, dtype=dtype) if key == "bwd"
                       else time_fwd_routes(key, BATCH, heads, dh, n, reps=5))
                 for key in reversed(keys)}
        res[shape] = {}
        for key in keys:
            (old, new), (err, plain_ms) = turns[key], held[key]
            route = getattr(T, TRAIN_ROUTE_PICKS[key][0])(dtype, heads, dh)
            bound = bounds["bwd_tc_f32" if route == T.F32_TC_ROUTE else key]
            row = dict(route=route, ms=new, cuda_core_ms=old, plain_ms=plain_ms,
                       bound=bound_of(*bound), err=err, cases_err=cases_err[key],
                       calls_per_step=calls)
            res[shape][key] = row
            print(f"    lite {shape} B{BATCH} {name} {key} [{route}]: {new:.4f} ms a call "
                  f"(cuda_core {old:.4f} ms in turns, {old / new:.2f}x), plain "
                  f"{plain_ms:.4f} ms (by {LITE_SLICE} images), bound {row['bound'][0]:.4f} ms "
                  f"({row['bound'][1]}), max_abs_err {err:.3e} at B{BATCH} "
                  f"({cases_err[key]:.3e} over LITE_CASES) [{card}]")
    return res


def time_bwd_routes(batch, heads, dh, n, reps=10, dtype=torch.bfloat16):
    """At one main-path shape, rate 0.2, BN term on: the backward on the
    CUDA-core route and on the tensor-core route ``train_bwd_route`` names
    for ``dtype`` in turns (old, new, new, old), on the same inputs."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    args = bwd_inputs(batch, heads, dh, n, n, dtype, RATE, True)
    route = T.train_bwd_route(dtype, heads, dh)
    turns = [(r, time_ms(lambda: T.launch_bwd(*args, route=r), reps))
             for r in ("cuda_core", route, route, "cuda_core")]
    old = min(t for r, t in turns if r == "cuda_core")
    new = min(t for r, t in turns if r == route)
    print(f"    N{n} dh{dh} {str(dtype)[6:]} bwd in turns: "
          + ", ".join(f"{r} {t:.4f} ms" for r, t in turns)
          + f"; cuda_core / {route} {old / new:.2f}x")
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
    output at its tolerance, and a second call on its route for the same
    bits.  Returns the worst max_abs_err against the plain version."""
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
    again = f.launch(*args, route=route)
    torch.cuda.synchronize()
    label = f"{key} [{route}] B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k} rate {rate}"
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    routes = [rel_err(a, b)[1] for a, b in zip(got, other)]
    for (_, rel), r, tol in zip(errs, routes, f.tols):
        require(label, rel, tol[dtype])
        require(f"{label} against the cuda_core route", r, tol[dtype])
    if not all(torch.equal(a, b) for a, b in zip(got, again)):   # no atomics sum
        raise AssertionError(f"{label}: two calls on the same inputs differ")
    print(f"  {label}: {FWD_OUTPUTS[key]} rel " + " ".join(f"{r:.2e}" for _, r in errs)
          + " | vs cuda_core " + " ".join(f"{r:.2e}" for r in routes) + " | repeat bit for bit")
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


def fwd_identity_turns(batch, heads, dh, n_q, n_k, rate, seed=0, dtype=torch.bfloat16):
    """The frozen-BN forward with the identity mix, as KerasMHA calls it
    (``train_fwd_identity``), on its identity route for ``dtype`` against
    its plain version and against the CUDA-core route (the general forward
    with I and 0) on the same inputs: out at TRAIN_TOL, lse at F32_OUT_TOL.
    Returns the worst max_abs_err against the plain version."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, eye, zero, _, sd = train_inputs(batch, heads, dh, n_q, n_k, dtype, seed,
                                             identity=True)
    route = T.train_fwd_route(dtype, heads, dh, identity_mix=True)
    before = dict(T.train_fwd.route_launches)
    got = T.train_fwd_identity(q, k, v, sd, rate)
    if (route not in T.IDENTITY_ROUTES
            or T.train_fwd.route_launches[route] != before[route] + 1):
        raise AssertionError(f"the call did not take an identity route ({route})")
    want = T.train_fwd_identity_plain(q, k, v, sd, rate)
    other = T.launch_train_fwd(q, k, v, v.float().sum(1), eye, zero, sd, rate,
                               route="cuda_core")[:2]
    torch.cuda.synchronize()
    label = f"fwd [{route}] B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k} rate {rate}"
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    routes = [rel_err(a, b)[1] for a, b in zip(got, other)]
    for (_, rel), r, tol in zip(errs, routes, (TRAIN_TOL, F32_OUT_TOL)):
        require(label, rel, tol[dtype])
        require(f"{label} against the cuda_core route", r, tol[dtype])
    print(f"  {label}: out lse rel " + " ".join(f"{r:.2e}" for _, r in errs)
          + " | vs cuda_core " + " ".join(f"{r:.2e}" for r in routes))
    return max(e for e, _ in errs)


def check_fwd_identity_bits(batch, heads, n, head_base, dtype=torch.bfloat16):
    """An identity route's dropout bits, read back exactly: with q = 0
    every probability is 1/Nk, and with V_h[m, d] = 1 where m = d mod dh,
    out_h[n, d] Nk / scale counts the kept keys m = d mod dh of row n, which
    must equal the count from ``dropout_mask`` of heads head_base.. (each
    bit itself where Nk <= dh)."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    dh = 192
    q = torch.zeros(batch, heads, n, dh, device="cuda", dtype=dtype)
    k = torch.randn(batch, heads, n, dh, device="cuda").to(dtype)
    vh = (torch.arange(n, device="cuda")[:, None] % dh
          == torch.arange(dh, device="cuda")[None, :]).float()
    v = vh.repeat(1, heads).expand(batch, n, heads * dh).to(dtype).contiguous()
    sd = torch.tensor([77], dtype=torch.int64, device="cuda")
    out, _ = T.train_fwd_identity(q, k, v, sd, RATE, head_base)
    mask = T.dropout_mask(77, RATE, batch, heads, n, n, "cuda", head_base) > 0
    want = torch.einsum("bhnm,md->bnhd", mask.float(), vh).flatten(-2)
    got = torch.round(out.float() * n * (1 - RATE))
    if not torch.equal(got, want):
        raise AssertionError(f"the identity forward's dropout bits differ from dropout_mask "
                             f"(H{heads} N{n} head_base {head_base}): "
                             f"{int((got != want).sum())} counts")
    print(f"  fwd [{T.train_fwd_route(dtype, heads, dh, True)}] dropout bits H{heads} dh{dh} "
          f"N{n} B{batch} head_base "
          f"{head_base}: all {mask.numel()} identical to dropout_mask "
          f"({'each bit' if n <= dh else 'counts of keys m = d mod dh'})")


def time_fwd_identity(batch, heads, dh, n, reps=10, dtype=torch.bfloat16):
    """At an identity class, rate 0.2: the frozen-BN forward through its
    wrapper held against its plain version and the CUDA-core route
    (``fwd_identity_turns``, out at TRAIN_TOL, lse at F32_OUT_TOL), then on
    the CUDA-core route (the general forward with I and 0, which writes
    o_norm) and on the identity route for ``dtype`` in turns (old, new, new,
    old), beside its plain version and its bound.  Returns dict(err, ms,
    cuda_core_ms, plain_ms, bound)."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, eye, zero, _, sd = train_inputs(batch, heads, dh, n, n, dtype, identity=True)
    vsum = v.float().sum(1)
    route = T.train_fwd_route(dtype, heads, dh, identity_mix=True)
    calls = {"cuda_core": lambda: T.launch_train_fwd(q, k, v, vsum, eye, zero, sd, RATE,
                                                     route="cuda_core"),
             route: lambda: T.launch_train_fwd_identity(q, k, v, sd, RATE)}
    turns = [(r, time_ms(calls[r], reps)) for r in ("cuda_core", route, route, "cuda_core")]
    old = min(t for r, t in turns if r == "cuda_core")
    new = min(t for r, t in turns if r == route)
    plain = time_ms(lambda: T.train_fwd_identity_plain(q, k, v, sd, RATE), 2, warmup=1)
    err = fwd_identity_turns(batch, heads, dh, n, n, RATE, dtype=dtype)
    bound = bound_of(*train_bounds(batch, heads, dh, n, n, dtype)["fwd_identity"])
    # at rate 0 scaled_dot_product_attention's forward computes the same out
    # (the library call beside the route; the port never calls it): held
    # against the route's out, the two timed in turns (sdpa, route, route, sdpa)
    vh = v.view(batch, n, heads, dh).transpose(1, 2)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, vh, scale=1.0)
    rate0 = lambda: T.launch_train_fwd_identity(q, k, v, sd, 0.0)
    rel = rel_err(sdpa().transpose(1, 2).reshape(batch, n, heads * dh), rate0()[0])[1]
    require(f"sdpa against the {route} route at rate 0", rel, TRAIN_TOL[dtype])
    lib = [(name, time_ms(fn, reps)) for name, fn in
           (("sdpa", sdpa), (route, rate0), (route, rate0), ("sdpa", sdpa))]
    sdpa_t = min(t for r, t in lib if r == "sdpa")
    rate0_t = min(t for r, t in lib if r == route)
    print(f"    H{heads} dh{dh} N{n} B{batch} {str(dtype)[6:]} fwd identity mix in turns: "
          + ", ".join(f"{r} {t:.4f} ms" for r, t in turns)
          + f"; cuda_core / {route} {old / new:.2f}x; plain {plain:.4f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]}); at rate 0 in turns: "
          + ", ".join(f"{r} {t:.4f} ms" for r, t in lib)
          + f" (out rel {rel:.2e}) [{card_line()}]")
    return dict(err=err, ms=new, cuda_core_ms=old, plain_ms=plain, bound=bound,
                rate0_ms=rate0_t, sdpa_ms=sdpa_t)


# the backward's identity routes (KerasMHA's calls, bf16 and f32): its two
# classes at N 256, the level-0 skip's 64 queries of 256 keys, ragged 70
# queries of 130 keys (partial query and key tiles and dropout windows), a
# single query
IDENTITY_BWD_CASES = [(4, 8, 192, 256, 256), (4, 4, 192, 256, 256), (4, 8, 192, 64, 256),
                      (2, 8, 192, 70, 130), (2, 4, 192, 1, 49)]


def identity_bwd_inputs(batch, heads, dh, n_q, n_k, dtype, rate, seed=0):
    """The identity backward's arguments on the card as KerasMHA's Function
    forms them: lse and D = sum g * out from the plain forward at ``rate``.
    Returns (q, k, v, lse, g, d, seed tensor)."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, _, _, g_out, sd = train_inputs(batch, heads, dh, n_q, n_k, dtype, seed,
                                            identity=True)
    out, lse = T.train_fwd_identity_plain(q, k, v, sd, rate)
    d = (g_out.float() * out.float()).reshape(batch, n_q, heads, dh).sum(-1).transpose(1, 2)
    return q, k, v, lse, g_out, d.contiguous(), sd


def check_bwd_identity(batch, heads, dh, n_q, n_k, dtype, rate, head_base=0):
    """The backward as KerasMHA's Function calls it (``train_bwd_identity``,
    counted on the route ``train_bwd_route(..., identity_mix=True)`` names)
    and the identity route for ``dtype`` called by name, against the plain
    version and the general route with I (dq, dk, dv at F32_OUT_TOL); the
    identity route twice on the same inputs, for the same bits (it writes
    every output once)."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, lse, g, d, sd = identity_bwd_inputs(batch, heads, dh, n_q, n_k, dtype, rate)
    args = (q, k, v, lse, g, d, sd, rate)
    route = T.train_bwd_route(dtype, heads, dh, identity_mix=True)
    before = dict(T.train_bwd.route_launches)
    got = T.train_bwd_identity(*args, head_base)
    if T.train_bwd.route_launches[route] != before[route] + 1:
        raise AssertionError(f"the call did not take the {route} route")
    ident = T.launch_bwd_identity(*args, head_base=head_base)
    again = T.launch_bwd_identity(*args, head_base=head_base)
    want = T.train_bwd_identity_plain(*args, head_base)
    general = T.train_bwd_route(dtype, heads, dh)
    other = T.launch_bwd(q, k, v, lse, g, torch.eye(heads, device="cuda"), d, sd, rate,
                         route=general, head_base=head_base)
    torch.cuda.synchronize()
    tol = F32_OUT_TOL[dtype]
    label = (f"bwd [{T.IDENTITY_ROUTES[dtype == torch.float32]}] B{batch} H{heads} dh{dh} "
             f"Nq{n_q} Nk{n_k} rate {rate} head_base {head_base}")
    errs = [rel_err(a, b) for a, b in zip(ident, want)]
    checks = [r for _, r in errs] + [rel_err(a, b)[1] for a, b in zip(got, want)]
    against = [rel_err(a, b)[1] for a, b in zip(ident, other)]
    for r in checks + against:
        require(label, r, tol)
    if not all(torch.equal(a, b) for a, b in zip(ident, again)):
        raise AssertionError(f"{label}: two calls on the same inputs differ")
    print(f"  {label}: dq dk dv rel " + " ".join(f"{r:.2e}" for _, r in errs)
          + f" | vs {general} " + " ".join(f"{r:.2e}" for r in against)
          + f" | repeat bit for bit | wrapper on {route}")
    return max(e for e, _ in errs)


def sdpa_bwd_ms(batch, heads, dh, n, dtype, reps=10):
    """``scaled_dot_product_attention``'s backward at an identity class, rate
    0 (forward and backward minus forward): autograd of the same function as
    the identity backward, its dq, dk, dv held against the plain version at
    GRAD_TOL.  A reading beside the kernel; the port never calls it."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, lse, g, d, sd = identity_bwd_inputs(batch, heads, dh, n, n, dtype, 0.0)
    heads_view = lambda t: t.view(batch, n, heads, dh).transpose(1, 2)
    leaves = [q.clone().requires_grad_(), k.clone().requires_grad_(),
              heads_view(v).contiguous().requires_grad_()]
    g_h = heads_view(g).contiguous()
    fwd = lambda: torch.nn.functional.scaled_dot_product_attention(*leaves, scale=1.0)
    both = lambda: torch.autograd.grad(fwd(), leaves, g_h)
    dq, dk, dvh = both()
    want = T.train_bwd_identity_plain(q, k, v, lse, g, d, sd, 0.0)
    got = (dq, dk, dvh.transpose(1, 2).reshape(batch, n, heads * dh))
    rel = max(rel_err(a, b)[1] for a, b in zip(got, want))
    require("scaled_dot_product_attention's backward (identity mix)", rel, GRAD_TOL[dtype])
    return time_ms(both, reps) - time_ms(fwd, reps)


def time_bwd_identity(batch, heads, dh, n, dtype, reps=10):
    """At an identity class, rate 0.2: the identity route for ``dtype`` and
    the route the call took before it (``train_bwd_route`` without the
    flag, with I) in turns (old, new, new, old); the wrapper
    ``train_bwd_identity``'s b64 outputs, counted on the identity route,
    against the plain version at F32_OUT_TOL; beside its plain version, its
    bound and SDPA's backward (rate 0).  Returns dict(err, ms, old_ms,
    old_route, plain_ms, bound, sdpa_ms)."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, lse, g, d, sd = identity_bwd_inputs(batch, heads, dh, n, n, dtype, RATE)
    args = (q, k, v, lse, g, d, sd, RATE)
    route, old_route = T.IDENTITY_ROUTES[dtype == torch.float32], T.train_bwd_route(dtype, heads, dh)
    eye = torch.eye(heads, device="cuda")
    calls = {old_route: lambda: T.launch_bwd(q, k, v, lse, g, eye, d, sd, RATE, route=old_route),
             route: lambda: T.launch_bwd_identity(*args)}
    turns = [(r, time_ms(calls[r], reps)) for r in (old_route, route, route, old_route)]
    old = min(t for r, t in turns if r == old_route)
    new = min(t for r, t in turns if r == route)
    want = T.train_bwd_identity_plain(*args)
    before = T.train_bwd.route_launches[route]
    got = T.train_bwd_identity(*args)
    torch.cuda.synchronize()
    if T.train_bwd.route_launches[route] != before + 1:
        raise AssertionError(f"train_bwd_identity B{batch} H{heads} did not take {route}")
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    for _, r in errs:
        require(f"bwd [{route}] B{batch} H{heads} dh{dh} N{n}", r, F32_OUT_TOL[dtype])
    del got, want
    plain = time_ms(lambda: T.train_bwd_identity_plain(*args), 2, warmup=1)
    bound = bound_of(*train_bounds(batch, heads, dh, n, n, dtype)["bwd_identity"])
    sdpa = sdpa_bwd_ms(batch, heads, dh, n, dtype)
    print(f"    H{heads} dh{dh} N{n} B{batch} {str(dtype)[6:]} bwd identity mix in turns: "
          + ", ".join(f"{r} {t:.4f} ms" for r, t in turns)
          + f"; {old_route} / {route} {old / new:.2f}x; dq dk dv rel "
          + " ".join(f"{r:.2e}" for _, r in errs)
          + f"; plain {plain:.4f} ms; sdpa backward (rate 0) {sdpa:.4f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]}) [{card_line()}]")
    return dict(err=max(e for e, _ in errs), ms=new, old_ms=old, old_route=old_route,
                plain_ms=plain, bound=bound, sdpa_ms=sdpa)


def check_functions(batch, heads, dh, n, dtype, rate=RATE):
    """Both autograd Functions at ``rate`` against torch autograd of the
    N x N forward (``reattention_nxn``) with the same mask, in float64 on
    the same inputs.  The loss takes the BN moments too, so the conv bias's
    gradient is d(sum mu)/d cb = 1: BatchNorm removes a uniform shift of the
    map, and the reference's other terms cancel to its float64 rounding."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, m_eff, c_eff, g_out, seed = train_inputs(batch, heads, dh, n, n, dtype, 1)
    mask = T.dropout_mask(int(seed.item()), rate, batch, heads, n, n, "cuda")
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
            got = (T.flash_reattention_train(*kl, seed, num_heads=heads, rate=rate),)
            want = (T.reattention_nxn(*rl, mask)[0],)
        else:
            got = T.flash_reattention_train_bn(*kl, seed, num_heads=heads, rate=rate)
            out, moments = T.reattention_nxn(*rl[:5], mask, norm=rl[5:])
            want = (out, *moments)
        loss = lambda outs: ((outs[0] * g_out.to(outs[0].dtype)).sum()
                             + sum(o.sum() for o in outs[1:]))
        gk = torch.autograd.grad(loss(got), kl)
        gr = torch.autograd.grad(loss(want), rl)
        rels = [rel_err(a, b)[1] for a, b in zip((got[0],) + tuple(gk), (want[0],) + tuple(gr))]
        print(f"  {mode} Function B{batch} H{heads} dh{dh} N{n} "
              f"{str(dtype).replace('torch.', '')} rate {rate}: out and grads rel "
              + " ".join(f"{r:.1e}" for r in rels))
        for r in rels:
            require(f"{mode} Function gradients", r, GRAD_TOL[dtype])
        worst = max(worst, *rels)
    return worst


def check_identity_function(batch, heads, n, rate, dtype=torch.bfloat16):
    """The identity-mix autograd Function as KerasMHA calls it
    (``flash_reattention_train(..., identity_mix=True)``, dh 192): its
    forward and its backward (D from the saved out) each on the route its
    route choice names with the flag, each launch counted there; out and
    the gradients of q, k and v against torch autograd of the N x N forward
    (``reattention_nxn`` with I and 0) with the same mask, in float64 on the
    same inputs, at GRAD_TOL."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    q, k, v, eye, zero, g_out, seed = train_inputs(batch, heads, 192, n, n, dtype, 1,
                                                   identity=True)
    mask = T.dropout_mask(int(seed.item()), rate, batch, heads, n, n, "cuda")
    kl = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    rl = [t.detach().double().requires_grad_() for t in (q, k, v)]
    fwd_route = T.train_fwd_route(dtype, heads, 192, identity_mix=True)
    bwd_route = T.train_bwd_route(dtype, heads, 192, identity_mix=True)
    before = dict(T.train_fwd.route_launches), dict(T.train_bwd.route_launches)
    got = T.flash_reattention_train(*kl, eye, zero, seed, num_heads=heads, rate=rate,
                                    identity_mix=True)
    want = T.reattention_nxn(*rl, eye.double(), zero.double(), mask)[0]
    gk = torch.autograd.grad((got * g_out.to(got.dtype)).sum(), kl)
    gr = torch.autograd.grad((want * g_out.to(want.dtype)).sum(), rl)
    if (T.train_fwd.route_launches[fwd_route] != before[0][fwd_route] + 1
            or T.train_bwd.route_launches[bwd_route] != before[1][bwd_route] + 1):
        raise AssertionError(f"the identity Function did not take {fwd_route} / {bwd_route}")
    rels = [rel_err(a, b)[1] for a, b in zip((got, *gk), (want, *gr))]
    label = (f"identity Function B{batch} H{heads} dh192 N{n} {str(dtype)[6:]} rate {rate} "
             f"[fwd {fwd_route}, bwd {bwd_route}]")
    print(f"  {label}: out dq dk dv rel " + " ".join(f"{r:.1e}" for r in rels)
          + f" (tol {GRAD_TOL[dtype]:.0e})")
    for r in rels:
        require(label, r, GRAD_TOL[dtype])
    return max(rels)


def phase_train_kernels():
    print("== phase 2b: training kernels vs plain on the card")
    t_phase = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for shape in TRAIN_SHAPES:
            for rate in (0.0, RATE):
                check_train_kernels(*shape, dtype, rate)
        for batch, heads, dh, n, _ in TRAIN_SHAPES[:3]:
            check_functions(batch, heads, dh, n, dtype)
        for batch, heads, dh, n, n_k in HEAD16_SHAPES:
            if n == n_k:
                for rate in (0.0, RATE):
                    check_functions(batch, heads, dh, n, dtype, rate)
    # both Functions at lite's tensor-core classes (N 1,024 at dh 12: the
    # float64 reference's N x N maps stay near a gigabyte)
    for heads, dh, n, _ in LITE_LEVELS:
        for dtype in (torch.bfloat16, torch.float32):
            check_functions(2, heads, dh, min(n, 1024), dtype)
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    print("  the backward in bf16 on the route train_bwd_route names:")
    tc_err = 0.0
    lite_err = dict.fromkeys(("bwd", "fwd", "bn_fwd"), 0.0)
    for shape in ([s for s in TRAIN_SHAPES[:3] if s[1:3] in T.TRAIN_BWD_TC_SHAPES]
                  + BWD_EDGE_CASES + KERAS_SHAPES + BWD16_CASES + LITE_CASES):
        for rate in (0.0, RATE):
            for bn in (False, True):
                err = check_bwd_routes(*shape, rate, bn)
                tc_err = max(tc_err, err)
                if shape in LITE_CASES:
                    lite_err["bwd"] = max(lite_err["bwd"], err)
    print("  the backward in f32 at lite's classes on the route train_bwd_route names "
          "(split precision), against plain and the CUDA-core route:")
    lite_f32_err = 0.0
    for shape in LITE_CASES:
        for rate in (0.0, RATE):
            for bn in (False, True):
                lite_f32_err = max(lite_f32_err,
                                   check_bwd_routes(*shape, rate, bn, torch.float32))
    fwd_err = {}
    for key, classes in (("fwd", T.TRAIN_FWD_TC_SHAPES), ("bn_fwd", T.BN_FWD_TC_SHAPES)):
        print(f"  the {'frozen' if key == 'fwd' else 'exact'}-BN forward in bf16 on the "
              f"route its route choice names:")
        fwd_err[key] = 0.0
        shapes = [s for s in TRAIN_SHAPES[:3] if s[1:3] in classes]
        head16 = [s for s in BN16_CASES if s[1:3] in classes]
        lite = [s for s in LITE_CASES + LITE_B64_FWD if s[1:3] in classes]
        for shape in (shapes + [(BATCH,) + s[1:] for s in shapes] + FWD_EDGE_CASES + head16
                      + lite):
            for rate in (0.0, RATE):
                err = fwd_turns(key, *shape, rate)
                fwd_err[key] = max(fwd_err[key], err)
                if shape in lite:
                    lite_err[key] = max(lite_err[key], err)
        for batch, heads, dh, n, _ in shapes:
            check_fwd_bits(key, batch, heads, dh, n)
        for batch, heads, dh, n in HEAD16_BITS:
            if (heads, dh) in classes:
                check_fwd_bits(key, batch, heads, dh, n)
        for batch, heads, dh, n in LITE_BITS:
            if (heads, dh) in classes:
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
    print(f"  lite's level shapes (B{BATCH}, bf16, rate {RATE}), kernels 2, 4 and 3 a call:")
    total["lite"] = lite_kernels(lite_err)
    print(f"  lite's level shapes (B{BATCH}, f32, rate {RATE}), kernel 3 on its f32 route a "
          "call:")
    total["lite_f32"] = lite_kernels({"bwd": lite_f32_err}, torch.float32)
    print("  the frozen-BN forward's identity route (KerasMHA's bf16 calls):")
    ident_err = 0.0
    for shape in IDENTITY_FWD_CASES:
        for rate in (0.0, RATE):
            ident_err = max(ident_err, fwd_identity_turns(*shape, rate))
    for bits in IDENTITY_BITS:
        check_fwd_identity_bits(*bits)
    total["fwd_identity"] = dict(err=ident_err, classes={
        f"H{heads} dh192 N256": time_fwd_identity(BATCH, heads, 192, 256) for heads in (8, 4)})
    print("  the frozen-BN forward's f32 identity route (KerasMHA's f32 calls, split "
          "precision):")
    ident_err = 0.0
    for shape in IDENTITY_FWD_CASES:
        for rate in (0.0, RATE):
            ident_err = max(ident_err, fwd_identity_turns(*shape, rate, dtype=torch.float32))
    for bits in IDENTITY_BITS:
        check_fwd_identity_bits(*bits, dtype=torch.float32)
    total["fwd_identity_f32"] = dict(err=ident_err, classes={
        f"H{heads} dh192 N256": time_fwd_identity(BATCH, heads, 192, 256, dtype=torch.float32)
        for heads in (8, 4)})
    print("  the backward's identity routes (KerasMHA's calls), bf16 and f32:")
    for dtype in (torch.bfloat16, torch.float32):
        ident_err = 0.0
        for shape in IDENTITY_BWD_CASES:
            for rate, head_base in ((0.0, 0), (RATE, 0), (RATE, 4)):
                ident_err = max(ident_err, check_bwd_identity(*shape, dtype, rate, head_base))
        for heads in (8, 4):
            for rate in (0.0, RATE):
                check_identity_function(4, heads, 256, rate, dtype)
        total[f"bwd_identity_{str(dtype)[6:]}"] = dict(err=ident_err, classes={
            f"H{heads} dh192 N256": time_bwd_identity(BATCH, heads, 192, 256, dtype)
            for heads in (8, 4)})
    for dtype in (torch.bfloat16, torch.float32):     # HViTUNetTF's level-0 step shape
        check_identity_function(BATCH, 8, 256, RATE, dtype)
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
    for kname, pick, counter in (("fwd", T.train_fwd_route, T.train_fwd),
                                 ("bn_fwd", T.bn_fwd_route, T.bn_fwd),
                                 ("bwd", T.train_bwd_route, T.train_bwd)):
        per.update({f"{kname}_{r}": 0 for r in counter.route_launches})
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
    held = mock.patch.object(T, "train_bwd_route", lambda *a, **k: "cuda_core")
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
        held = mock.patch.object(T, pick, lambda *a, **k: "cuda_core")
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
    def exact_step_ms():
        nonlocal state
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            state, m = exact.train_step(state, batch)
            m["loss"].item()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[2]
    qkv_forms_in_turns(exact_step_ms, f"base b{BATCH} bf16 exact-BN step (median of 5)")
    qkv_breakdown(lambda: exact.train_step(state, batch), "exact-BN train step")
    del model, opt, state, exact, frozen, params0
    torch.cuda.empty_cache()
    lite = lite_step()
    lite["f32"] = lite_step("float32")
    lite["launches"] = dict(collections.Counter(lite["launches"])
                            + collections.Counter(lite["f32"]["launches"]))
    compare_train_paths()
    compare_train_paths("lite")
    check_shape_gate()
    print(f"  phase 4: {time.perf_counter() - t_phase:.1f} s")
    return launches, step_ms, lite


# the training kernels by key: their route functions and numbers.  At lite's
# three level classes in bf16 each route function names the tensor cores
TRAIN_ROUTE_PICKS = {"fwd": ("train_fwd_route", "2"), "bn_fwd": ("bn_fwd_route", "4"),
                     "bwd": ("train_bwd_route", "3")}


def lite_steps(label, steps, state, batch, routes, held, card, dtype="bf16"):
    """Lite's ``steps`` (2 warm-up, then 5 with the launches counted from 0:
    each of its 8 re-attention calls a step through the kernels of
    ``routes`` ({key: the route every launch of it takes}), and no other
    kernel), their median time and peak memory; then the step with the
    kernels ``held`` held on the CUDA cores (their route functions patched)
    and as named, in turns (old, new, new, old, each the median of 3),
    faster as named.  Returns (state, dict(launches, ms, peak_gib, turns))."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    calls = sum(c for *_, c in LITE_LEVELS)
    state, _, _ = timed_steps(steps, state, batch, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_launches()
    state, losses, ms = timed_steps(steps, state, batch, 5)
    launches = train_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict.fromkeys(launches, 0)
    for key, route in routes.items():
        want[key] = want[f"{key}_{route}"] = 5 * calls
    print(f"  lite b{BATCH} {dtype} {label} step (224², {calls} re-attention calls): median "
          f"{ms:.3f} ms, {BATCH / ms * 1e3:.1f} img/s, peak memory {peak:.2f} GiB, losses "
          f"{losses[0]:.5f} .. {losses[-1]:.5f}; launches {launches} [{card}]")
    if launches != want:
        raise AssertionError(f"lite {label} step: launches {launches}, expected {want}")
    patches = [mock.patch.object(T, TRAIN_ROUTE_PICKS[key][0], lambda *a, **k: "cuda_core")
               for key in held]
    named = "/".join(sorted({routes[key] for key in held}))
    turns = []
    for route in ("cuda_core", named, named, "cuda_core"):
        with contextlib.ExitStack() as stack:
            if route == "cuda_core":
                for patch in patches:
                    stack.enter_context(patch)
            torch.cuda.reset_peak_memory_stats()
            state, _, t = timed_steps(steps, state, batch, 3)
            turns.append((route, t, torch.cuda.max_memory_allocated() / 2 ** 30))
    names = ("kernels " if len(held) > 1 else "kernel ") + " and ".join(
        TRAIN_ROUTE_PICKS[key][1] for key in held)
    print(f"  lite b{BATCH} {dtype} {label} step, {names} on each route in turns "
          "(median of 3; peak): " + ", ".join(f"{r} {t:.3f} ms ({g:.2f} GiB)"
                                              for r, t, g in turns) + f" [{card}]")
    if not min(t for r, t, _ in turns if r == named) < min(
            t for r, t, _ in turns if r == "cuda_core"):
        raise AssertionError(f"lite's {dtype} {label} step is not faster with {names} on "
                             f"the {named} route")
    device_breakdown(lambda: steps.train_step(state, batch), ms,
                     f"lite {dtype} {label} step", reps=1)
    return state, dict(launches=launches, ms=ms, peak_gib=peak, turns=turns)


def lite_step(dtype="bfloat16"):
    """Lite (the CLI's default model) at 224², b64, dropout 0.2, AdamW
    1e-4, in ``dtype``: its exact-BN step (kernels 4 and 3) and then its
    frozen-BN step (kernels 2 and 3), each through ``lite_steps``.  bf16:
    every call on the tensor cores, kernels 4 and 3 held in the exact
    step's turns, kernel 2 in the frozen one's; float32 (the CLI's
    default): kernels 2 and 4 on the CUDA cores, kernel 3 on its f32
    tensor-core route and held in both steps' turns.  Returns
    dict(launches: both steps' counted launches summed, exact, frozen)."""
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse

    card = card_line()
    f32 = dtype == "float32"
    routes = ({"fwd": "cuda_core", "bn_fwd": "cuda_core", "bwd": T.F32_TC_ROUTE} if f32
              else dict.fromkeys(TRAIN_ROUTE_PICKS, "tensor_core"))
    named = {key: {getattr(T, pick)(getattr(torch, dtype), h, d) for h, d, _, _ in LITE_LEVELS}
             for key, (pick, _) in TRAIN_ROUTE_PICKS.items()}
    if named != {key: {r} for key, r in routes.items()}:
        raise AssertionError(f"lite's levels in {dtype}: routes named {named}, expected "
                             f"{routes}")
    model = get_vit_unet("lite", dtype=dtype, param_dtype=dtype, seed=0, device="cuda")
    model.train()
    opt = adamw(model, 1e-4)
    state = TrainState.create(model=model, optimizer=opt, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, 3, 224, 224, generator=gen, device="cuda")
    batch = {"x": x, "y": 0.9 * x}
    res = {}
    tag = "f32" if f32 else "bf16"
    pick = lambda *keys: {key: routes[key] for key in keys}
    state, res["exact"] = lite_steps("exact-BN", build_step_functions(model, opt, mse), state,
                                     batch, pick("bn_fwd", "bwd"),
                                     ("bwd",) if f32 else ("bn_fwd", "bwd"), card, tag)
    state, res["frozen"] = lite_steps(
        "frozen-BN", build_step_functions(model, opt, mse, bn_frozen=True), state, batch,
        pick("fwd", "bwd"), ("bwd",) if f32 else ("fwd",), card, tag)
    res["launches"] = dict(collections.Counter(res["exact"]["launches"])
                           + collections.Counter(res["frozen"]["launches"]))
    del model, opt, state
    torch.cuda.empty_cache()
    return res


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


def train_step_result(flash, bn_frozen, batch, dtype="float32", preset="base", **overrides):
    """(loss, grads, running statistics) of one train step, in float64."""
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse

    model = get_vit_unet(preset, seed=0, flash_train=flash, device="cuda",
                         dtype=dtype, param_dtype=dtype, **overrides).train()
    opt = adamw(model, 1e-4)
    steps = build_step_functions(model, opt, mse, bn_frozen=bn_frozen)
    _, m = steps.train_step(TrainState.create(model=model, optimizer=opt, seed=7),
                            batch)
    grads = torch.cat([p.grad.double().flatten() for p in model.parameters()])
    stats = torch.cat([b.double() for name, b in model.named_buffers()
                       if "running" in name])
    return m["loss"].item(), grads, stats


def compare_train_paths(preset="base"):
    """The f32 batch-4 train steps of ``preset`` on the kernel path against
    the plain path (frozen BN) and against the plain path in float64
    (exact BN), as the comment above says.  Lite's f32 steps run kernel 3
    on its f32 tensor-core route, kernels 2 and 4 on the CUDA cores."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(4, 3, 224, 224, generator=gen, device="cuda")
    batch = {"x": x, "y": 0.9 * x}
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()
    step = lambda *a, **k: train_step_result(*a, preset=preset, **k)

    def diffs(a, b):
        return (abs(a[0] - b[0]) / abs(b[0]), rel(a[1], b[1]), rel(a[2], b[2]))

    kern, plain = (step(f, True, batch) for f in (True, False))
    l, g, st = diffs(kern, plain)
    print(f"  {preset} f32 batch-4 frozen-BN train step, kernel path vs plain path: loss "
          f"rel {l:.2e}, grads rel {g:.2e} of the largest, running stats rel "
          f"{st:.2e} (tol {TRAIN_PATH_TOL:.0e})")
    if not max(l, g, st) <= TRAIN_PATH_TOL:
        raise AssertionError(f"the {preset} frozen-BN kernel train step disagrees "
                             "with the plain path")
    for eps in (1e-5, EXACT_EPS):
        ref = step(False, False, batch, "float64", attn_bn_eps=eps)
        kern, plain = (step(f, False, batch, attn_bn_eps=eps) for f in (True, False))
        (kl, kg, ks), (pl, pg, ps) = diffs(kern, ref), diffs(plain, ref)
        held = eps == EXACT_EPS
        print(f"  {preset} batch-4 exact-BN (eps {eps:.0e}) train step against the plain "
              f"path in float64: kernel path (f32) loss rel {kl:.2e}, running "
              f"stats rel {ks:.2e}, grads rel {kg:.2e} of the largest; plain path "
              f"(f32) {pl:.2e}, {ps:.2e}, {pg:.2e}; kernel vs plain (f32) grads "
              f"rel {diffs(kern, plain)[1]:.2e} "
              + (f"(tol {EXACT_TOL:.0e} on loss and running stats, kernel grads "
                 f"at most {EXACT_GRAD_RATIO:g}x the plain path's)" if held
                 else "(printed, not held)"))
        if held and not (max(kl, ks, pl, ps) <= EXACT_TOL
                         and kg <= EXACT_GRAD_RATIO * pg):
            raise AssertionError(f"the {preset} exact-BN train step disagrees with "
                                 "the float64 plain path")


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


# --- phase 5: the trainer entry point -----------------------------------------

FIT_BATCHES = 8          # synthetic pairs stored: FIT_BATCHES x BATCH
IMAGE = (224, 224, 3)    # base's input, one stored uint8 image
FIT_STEPS = 24           # train steps per epoch; timed over steps 2..FIT_STEPS
FEED_PASSES = 4          # passes over the stored pairs a feed gives per epoch
FIT_VAL_STEPS = 2        # validation batches per epoch
# the refolded model's exact-BN forward against the frozen forward before
# the refold on the calibration batch, dropout off, in float32 copies of the
# bf16 model (kernel 4 against kernel 1, each within 1e-6 of its plain
# version in f32): what is left is the refolded BatchNorm affine rounded to
# the model's bf16 parameters, 2^-9 relative, carried through 12 layers.
# The same comparison in bf16 adds the two kernels' own bf16 roundings and
# is printed only.
REFOLD_TOL = 1e-2


def eval_launches():
    import importlib
    TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
    return {"eval": TK.flash_reattention.launches,
            **{f"eval_{r}": n for r, n in TK.flash_reattention.route_launches.items()}}


def all_launches():
    return {**train_launches(), **eval_launches()}


def zero_launches():
    """Every kernel's counts to 0, before a path runs."""
    import importlib
    TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
    reset_train_launches()
    TK.flash_reattention.launches = 0
    TK.flash_reattention.route_launches = dict.fromkeys(
        TK.flash_reattention.route_launches, 0)


def expected_epoch(frozen: bool, val_steps: int) -> dict:
    """Launches of one Fitter epoch: FIT_STEPS train steps (kernel 2 or 4,
    and 3, 12 each a step) and ``val_steps`` validation forwards (kernel 1,
    12 each), every one on its tensor-core route."""
    want = dict.fromkeys(all_launches(), 0)
    for key in ("fwd" if frozen else "bn_fwd", "bwd"):
        want[key] = want[f"{key}_tensor_core"] = 12 * FIT_STEPS
    want["eval"] = want["eval_tensor_core"] = 12 * val_steps
    return want


def repeated(data, passes=FEED_PASSES):
    """A feed of ``passes`` passes over the re-iterable ``data``."""
    return lambda: itertools.chain.from_iterable(itertools.repeat(data, passes))


def busy_ms(prof) -> float:
    """The union of the card's kernel and copy intervals in a profile, ms."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


class EpochProbe:
    """A Fitter callback with a hook on the train steps: the launches of
    each epoch by route (counts set to 0 as the epoch begins, read as it
    ends) and, over the steady window from the end of step 1 to the end of
    step FIT_STEPS (the card synchronised at both), the img/s and, for the
    epochs named in ``profiled``, the card's busy time under the profiler.
    The window leaves out the feed's start-up before step 1 and the batch
    the loop fetches after the last step."""

    def __init__(self, profiled=()):
        self.profiled = set(profiled)
        self.launches, self.rates, self.busy = {}, {}, {}
        self._epoch, self._n, self._t0, self._prof = None, 0, None, None

    def wrap(self, fitter):
        for steps in (fitter.steps, fitter._frozen_steps):
            if steps is not None:
                steps.train_step = self._timed(steps.train_step)

    def _timed(self, step):
        def run(state, batch):
            out = step(state, batch)
            self._n += 1
            if self._n in (1, FIT_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if self._n == 1:
                    self._t0 = t
                    if self._epoch in self.profiled:
                        from torch.profiler import ProfilerActivity, profile
                        self._prof = profile(activities=[ProfilerActivity.CUDA])
                        self._prof.start()
                else:
                    wall = t - self._t0
                    self.rates[self._epoch] = (FIT_STEPS - 1) * BATCH / wall
                    if self._prof is not None:
                        self._prof.stop()
                        self.busy[self._epoch] = (wall * 1e3, busy_ms(self._prof))
                        self._prof = None
            return out
        return run

    def on_train_begin(self, fitter): ...
    def on_train_end(self, fitter): ...

    def on_epoch_begin(self, fitter, epoch):
        self._epoch, self._n = epoch, 0
        zero_launches()

    def on_epoch_end(self, fitter, epoch, logs):
        self.launches[epoch] = all_launches()
        if self._n != FIT_STEPS:
            raise AssertionError(f"epoch {epoch} took {self._n} steps, not {FIT_STEPS}")


class RefoldCheck:
    """A Fitter callback that, at the end of the last frozen-BN epoch (after
    the probe before it has read the epoch's launches), refolds a copy of
    the model as the flip does (``estimate_bn_moments`` on ``batch``, then
    ``bn_refold``) and holds its exact-BN forward against the frozen
    forward before the refold, both on ``batch``, dropout off.  The model
    being trained is left as it is."""

    def __init__(self, batch):
        self.batch = batch
        self.result = {}

    def on_train_begin(self, fitter): ...
    def on_train_end(self, fitter): ...
    def on_epoch_begin(self, fitter, epoch): ...

    def on_epoch_end(self, fitter, epoch, logs):
        if epoch != fitter.bn_freeze_epochs - 1:
            return
        import copy
        from vit_unet_tpu_torch.train.bn_refold import bn_refold, estimate_bn_moments
        xb = fitter._device_batch(self.batch)["x"]
        model = copy.deepcopy(fitter.model)
        with torch.no_grad():
            before = [m(xb, deterministic=True, use_running_average=True).float()
                      for m in (model, f32_copy(model))]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bn_refold(model, estimate_bn_moments(model, [xb]))
            torch.cuda.synchronize()
            self.result["s"] = time.perf_counter() - t0
            after = [m(xb, deterministic=True, use_running_average=False).float()
                     for m in (model, f32_copy(model))]
        self.result["bf16"], self.result["rel"] = (
            rel_err(a, b)[1] for a, b in zip(after, before))


def f32_copy(model):
    """The bf16 model's weights (as rounded) in a float32 model."""
    import dataclasses
    from vit_unet_tpu_torch.models.vit_unet import ViTUNet
    cfg = dataclasses.replace(model.config, dtype="float32", param_dtype="float32")
    with torch.device("cuda"):
        copy = ViTUNet(cfg)
    copy.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    return copy


def synthetic_pairs(n):
    """``n`` uint8 ``IMAGE`` pairs from a numpy seed: y a smooth clean
    image, x = y + Gaussian noise (sigma 20), clipped."""
    rng = np.random.default_rng(0)
    h, w, _ = IMAGE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / np.float32(h)
    base = np.stack([yy, xx, yy * xx], -1) * 200
    phase = rng.uniform(0, 55, (n, 1, 1, 3)).astype(np.float32)
    clean = (base[None] + phase).astype(np.uint8)
    noisy = np.clip(clean + rng.normal(0, 20, clean.shape).astype(np.float32),
                    0, 255).astype(np.uint8)
    return noisy, clean


def codec_rates(paths):
    """MB/s of the native codec: CRC32C over one 64 MB buffer, the whole-
    shard scan with CRCs, and the streaming reader (CRCs per record)."""
    from vit_unet_tpu_torch.data import tfrecord as tfr
    buf = np.random.default_rng(1).integers(0, 256, 64 << 20, dtype=np.uint8).tobytes()
    out = {}
    t0 = time.perf_counter()
    tfr.crc32c(buf)
    out["crc32c"] = len(buf) / (time.perf_counter() - t0) / 1e6
    for label, reader in (("scan", tfr.read_records),
                          ("streaming", tfr.read_records_streaming)):
        t0 = time.perf_counter()
        nbytes = sum(len(r) + 16 for p in paths for r in reader(p))
        out[label] = nbytes / (time.perf_counter() - t0) / 1e6
    return out


def bare_window(train_step, state, batch, profiled=False):
    """FIT_STEPS - 1 bare train steps on one batch, after one untimed step:
    the Fitter's steady window without its loop or feed.  Returns the img/s
    and, under the profiler, (wall ms, device-busy ms)."""
    from torch.profiler import ProfilerActivity, profile
    state, m = train_step(state, batch)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else None
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    for _ in range(FIT_STEPS - 1):
        state, m = train_step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is None:
        return (FIT_STEPS - 1) * BATCH / wall, None
    prof.stop()
    return (FIT_STEPS - 1) * BATCH / wall, (wall * 1e3, busy_ms(prof))


def phase_trainer():
    print("== phase 5: base ViT-UNet trained through Fitter, fed from TFRecord "
          "shards and from the card")
    t_phase = time.perf_counter()
    import tempfile
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.data import _native
    from vit_unet_tpu_torch.data import tfrecord as tfr
    from vit_unet_tpu_torch.data.loader import (
        DeviceResidentData, TFRecordStream, device_normalize, prefetch_to_device)
    from vit_unet_tpu_torch.train.callbacks import JSONLLogger, ReduceLROnPlateau
    from vit_unet_tpu_torch.train.fitter import Fitter

    card = card_line()
    noisy, clean = synthetic_pairs(FIT_BATCHES * BATCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as tmp:
        codec = _native.codec()
        calls0 = dict(codec.calls)
        t0 = time.perf_counter()
        paths = tfr.convert(({"x": a.tobytes(), "y": b.tobytes()}
                             for a, b in zip(noisy, clean)),
                            f"{tmp}/shards", "synthetic_", lambda it: it, max_mb=64)
        write_s = time.perf_counter() - t0
        shard_mb = sum(os.path.getsize(p) for p in paths) / 1e6
        print(f"  wrote {tfr.count_data_items(paths)} pairs into {len(paths)} shards, "
              f"{shard_mb:.1f} MB in {write_s:.2f} s; each epoch takes {FIT_STEPS} "
              f"steps from {FEED_PASSES} passes over them")
        stream = TFRecordStream(paths, IMAGE, BATCH, host_convert=False,
                                shuffle_buffer=BATCH, seed=0)
        passes = repeated(stream)
        feed = lambda: prefetch_to_device(passes(), transform=device_normalize())
        resident = DeviceResidentData(noisy, clean, BATCH, seed=0)
        val = DeviceResidentData(noisy[:FIT_VAL_STEPS * BATCH],
                                 clean[:FIT_VAL_STEPS * BATCH], BATCH, shuffle=False)

        def fitter_for(seed):
            model = get_vit_unet("base", dtype="bfloat16", param_dtype="bfloat16",
                                 seed=seed)
            return Fitter(model, learning_rate=1e-4, bn_freeze_epochs=1,
                          bn_warmup="refold", checkpoint_dir=f"{tmp}/ckpt")

        probe = EpochProbe()
        refold = RefoldCheck(next(iter(val)))
        log_path = f"{tmp}/log.jsonl"
        fitter = fitter_for(0)
        fitter.init_state()
        probe.wrap(fitter)
        python_crc = mock.patch.object(
            tfr, "_crc32c_py", side_effect=AssertionError("the Python CRC ran"))
        with python_crc:
            hist = fitter.fit(feed, val, n_epochs=2, steps_per_epoch=FIT_STEPS,
                              validation_steps=FIT_VAL_STEPS,
                              callbacks=[probe, refold, ReduceLROnPlateau(),
                                         JSONLLogger(log_path)],
                              save_best=True, save_last=True, verbose=False)
        calls = {k: codec.calls[k] - calls0[k] for k in calls0}
        print(f"  native codec: {calls} (the Python CRC ran on no record)")
        if not (calls["crc"] > 0 and calls["crc_bytes"] >= noisy.nbytes + clean.nbytes):
            raise AssertionError("the TFRecord stream did not check its records "
                                 "with the native codec")
        for epoch, frozen in ((0, True), (1, False)):
            got, want = probe.launches[epoch], expected_epoch(frozen, FIT_VAL_STEPS)
            print(f"  epoch {epoch} ({'frozen' if frozen else 'exact'} BN, TFRecord "
                  f"stream): launches {got}")
            if got != want:
                raise AssertionError(f"epoch {epoch}: launches {got}, expected {want}")
        losses = hist["loss"] + hist["val_loss"]
        r = refold.result
        print(f"  history: loss {hist['loss']}, val_loss {hist['val_loss']}, "
              f"lr {hist['lr']}; after epoch 0, a copy refolded on one batch in "
              f"{r['s']:.2f} s: exact-BN forward after it vs frozen forward before "
              f"it, f32 copies: rel {r['rel']:.3e} (tol {REFOLD_TOL:.0e}); bf16: rel "
              f"{r['bf16']:.3e}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"loss not finite: {losses}")
        if not r.get("rel", math.inf) <= REFOLD_TOL:
            raise AssertionError("the refold did not preserve the forward")
        with open(log_path) as f:
            if len(f.readlines()) != 2:
                raise AssertionError("JSONLLogger did not write one line an epoch")

        # resume into a fresh Fitter (other weights), bit for bit
        saved = torch.load(fitter._ckpt_path("last-checkpoint"), map_location="cpu",
                           weights_only=True)
        fitter2 = fitter_for(1)
        fitter2.init_state()
        start = fitter2.resume()
        st1, st2 = fitter.state, fitter2.state
        same = [start == 2, st2.step == st1.step == saved["step"] == 2 * FIT_STEPS,
                torch.equal(st2.generator.get_state(), saved["generator"])]
        sd2 = fitter2.model.state_dict()
        same += [torch.equal(sd2[k].cpu(), v) for k, v in saved["model"].items()]
        same += [torch.equal(sd2[k], v) for k, v in fitter.model.state_dict().items()]
        opt2 = fitter2.optimizer.state_dict()["state"]
        same += [torch.equal(torch.as_tensor(opt2[i][k]).cpu(), torch.as_tensor(v))
                 for i, entry in saved["optimizer"]["state"].items()
                 for k, v in entry.items()]
        print(f"  resume: epoch {start}, step {st2.step}, {len(same)} checks, "
              f"all bit for bit: {all(same)}")
        if not all(same):
            raise AssertionError("resume did not restore the saved state bit for bit")
        del fitter

        # epoch 2 on the resident set, between two bare-step windows; then one
        # profiled epoch on each feed (3: TFRecord stream, 4: resident) and
        # one profiled bare window
        probe2 = EpochProbe(profiled=(3, 4))
        bare_step = fitter2.steps.train_step
        probe2.wrap(fitter2)
        one = next(iter(resident))
        bare = [bare_window(bare_step, fitter2.state, one)[0]]
        hist2 = fitter2.fit(repeated(resident), val, n_epochs=3,
                            steps_per_epoch=FIT_STEPS, validation_steps=FIT_VAL_STEPS,
                            callbacks=[probe2], initial_epoch=start, save_best=False,
                            verbose=False)
        bare.append(bare_window(bare_step, fitter2.state, one)[0])
        for label, data, epoch in (("TFRecord stream", feed, 3),
                                   ("resident", repeated(resident), 4)):
            hist2 = fitter2.fit(data, n_epochs=epoch + 1, steps_per_epoch=FIT_STEPS,
                                initial_epoch=epoch, callbacks=[probe2],
                                save_best=False, verbose=False)
        bare_rate, (bare_wall, bare_busy) = bare_window(bare_step, fitter2.state, one,
                                                        profiled=True)
        for epoch, label, val_steps in ((2, "resident", FIT_VAL_STEPS),
                                        (3, "TFRecord stream", 0), (4, "resident", 0)):
            got, want = probe2.launches[epoch], expected_epoch(False, val_steps)
            print(f"  epoch {epoch} (exact BN, {label}): launches {got}")
            if got != want:
                raise AssertionError(f"epoch {epoch}: launches {got}, expected {want}")
        if not all(math.isfinite(v) for v in hist2["loss"]):
            raise AssertionError(f"loss not finite: {hist2['loss']}")
        steps = f"steps 2-{FIT_STEPS}"
        print(f"  Fitter img/s over {steps} of each epoch: TFRecord stream "
              f"{probe.rates[0]:.1f} (epoch 0, frozen BN), {probe.rates[1]:.1f} "
              f"(epoch 1, exact BN); resident {probe2.rates[2]:.1f} (epoch 2, exact "
              f"BN); bare exact-BN steps on one resident batch, before and after "
              f"epoch 2: {bare[0]:.1f}, {bare[1]:.1f} [{card}]")
        for epoch, label in ((3, "TFRecord stream"), (4, "resident")):
            wall, busy = probe2.busy[epoch]
            print(f"  exact-BN epoch {epoch}, {label}, {steps} profiled: wall "
                  f"{wall:.1f} ms, device busy {busy:.1f} ms, idle "
                  f"{1 - busy / wall:.1%}, {probe2.rates[epoch]:.1f} img/s under "
                  f"the profiler [{card}]")
        print(f"  bare exact-BN steps on one resident batch, {steps} profiled: wall "
              f"{bare_wall:.1f} ms, device busy {bare_busy:.1f} ms, idle "
              f"{1 - bare_busy / bare_wall:.1%}, {bare_rate:.1f} img/s under the "
              f"profiler [{card}]")
        rates = codec_rates(paths)
        print("  native codec MB/s: " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
              + f" [{card}]")
    del fitter2
    torch.cuda.empty_cache()
    print(f"  phase 5: {time.perf_counter() - t_phase:.1f} s")
    return probe.launches, probe2.launches


# --- phase 6: the entry point ---------------------------------------------------

CLI_PAIRS = 96           # PNG pairs written per task
CLI_SIDE = 256           # stored image side; the CLI resizes to 224
CLI_BATCH = 16
CLI_LAYOUTS = {"denoise": ("clean", "noisy"), "deblur": ("sharp", "blur"),
               "derain": ("norain", "rain"), "segment": ("images", "masks")}
# (colour type, bit depth) of the stored images, in turn over the files:
# RGB, RGBA, gray, gray + alpha and palette, at 8 and 16 bits
IMAGE_KINDS = [(2, 8), (6, 8), (0, 8), (4, 8), (3, 8), (2, 16), (6, 16),
               (0, 16), (4, 16)]
# masks: gray at 1 and 8 bits, a two-entry palette at 2 bits
MASK_KINDS = [(0, 1), (0, 8), (3, 2)]
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# an f32 program exported on the CPU, run on the card against the CPU's
# result (TF32 off): the same f32 math in other summation orders through
# 12 re-attention calls and 20 LayerNorms, as MODEL_TOL
EXPORT_TOL = MODEL_TOL
EXPORT_BATCH_CPU = 2


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    import struct
    import zlib
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def png_bytes(samples, ctype, depth, palette=None) -> bytes:
    """A PNG of (H, W, C) samples (palette indices for colour type 3), its
    rows filtered with None, Sub, Up, Average and Paeth in turn."""
    import struct
    import zlib
    h, w = samples.shape[:2]
    flat = samples.reshape(h, -1)
    if depth == 16:
        raw = flat.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        raw = flat.astype(np.uint8)
    else:
        per = 8 // depth
        v = np.pad(flat.astype(np.uint8), ((0, 0), (0, (-flat.shape[1]) % per)))
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        raw = np.bitwise_or.reduce(v.reshape(h, -1, per) << shifts, axis=-1)
    bpp = max(1, PNG_CHANNELS[ctype] * depth // 8)
    x = raw.astype(np.int16)
    left, up, ul = (np.zeros_like(x) for _ in range(3))
    left[:, bpp:], up[1:], ul[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    types = np.arange(h) % 5
    rows = np.concatenate([types[:, None], (x - preds[types, np.arange(h)]) & 0xFF],
                          axis=1).astype(np.uint8)
    data = b"\x89PNG\r\n\x1a\n" + _png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if palette is not None:
        data += _png_chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
    return data + _png_chunk(b"IEND", b"")


def _gray(rgb):
    """libpng's (and so the reader's) gray of 8-bit RGB."""
    return ((rgb.astype(np.int64) @ np.array([9797, 19234, 3737])) >> 15).astype(np.uint8)


def encode_image(img, kind, rng):
    """(PNG bytes, the RGB the reader must return) for the uint8 RGB
    ``img`` stored as ``kind``: 16-bit samples carry ``img`` in their high
    byte and noise in the low one, alpha is noise, gray is ``img``'s gray,
    a palette holds ``img`` quantised to 6 levels a channel."""
    ctype, depth = kind
    h, w, _ = img.shape
    if ctype == 3:
        q = (img.astype(np.int64) * 6) // 256
        levels = np.arange(6) * 51
        palette = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                           -1).reshape(-1, 3)
        idx = (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2])[..., None]
        return png_bytes(idx, 3, 8, palette), palette[idx[..., 0]].astype(np.uint8)
    base = img if ctype in (2, 6) else _gray(img)[..., None]
    want = base if ctype in (2, 6) else np.repeat(base, 3, -1)
    samples = base.astype(np.int64)
    if depth == 16:
        samples = samples * 256 + rng.integers(0, 256, samples.shape)
    if ctype in (4, 6):
        samples = np.concatenate(
            [samples, rng.integers(0, 1 << depth, (h, w, 1))], -1)
    return png_bytes(samples, ctype, depth), want


def encode_mask(mask, kind):
    """(PNG bytes, the gray the reader must return) for a 0/1 mask."""
    ctype, depth = kind
    if ctype == 3:
        palette = np.array([[0, 0, 0], [255, 255, 255], [9, 9, 9], [200, 0, 0]])
        return png_bytes(mask[..., None], 3, depth, palette), mask * np.uint8(255)
    top = (1 << depth) - 1
    return png_bytes(mask[..., None] * top, 0, depth), mask * np.uint8(255)


def write_cli_folders(root):
    """PNG folders of CLI_PAIRS pairs at CLI_SIDE² for every task, from
    numpy seeds; returns [(path, kind, expected array)] of every file."""
    rng = np.random.default_rng(6)
    s = CLI_SIDE
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / np.float32(s)
    smooth = np.stack([yy, xx, yy * xx], -1) * 200
    files = []
    for t, (task, (first, second)) in enumerate(CLI_LAYOUTS.items()):
        for d in (first, second):
            os.makedirs(os.path.join(root, task, d))
        for i in range(CLI_PAIRS):
            clean = (smooth + rng.uniform(0, 55, 3)).astype(np.uint8)
            pair = [(first, clean)]
            if task == "segment":
                cy, cx = rng.uniform(0.3, 0.7, 2) * s
                r = rng.uniform(0.1, 0.3) * s
                mask = (((yy * s - cy) ** 2 + (xx * s - cx) ** 2) < r * r).astype(np.uint8)
                kind = MASK_KINDS[i % len(MASK_KINDS)]
                data, want = encode_mask(mask, kind)
                path = os.path.join(root, task, second, f"{i:03d}.png")
                with open(path, "wb") as f:
                    f.write(data)
                files.append((path, kind, want, "gray"))
            else:
                noisy = np.clip(clean + rng.normal(0, 20, clean.shape), 0, 255)
                pair.append((second, noisy.astype(np.uint8)))
            for j, (d, img) in enumerate(pair):
                kind = IMAGE_KINDS[(i + j + t) % len(IMAGE_KINDS)]
                data, want = encode_image(img, kind, rng)
                path = os.path.join(root, task, d, f"{i:03d}.png")
                with open(path, "wb") as f:
                    f.write(data)
                files.append((path, kind, want, "rgb"))
    return files


def check_reader(files, card):
    """Every written file read back as the reader must return it, and the
    reader's ms per image and MB/s of decoded pixels."""
    from vit_unet_tpu_torch.data import image_io
    t0 = time.perf_counter()
    decoded = 0
    for path, kind, want, mode in files:
        got = (image_io.imread_rgb if mode == "rgb" else image_io.imread_gray)(path)
        decoded += got.nbytes
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{path} (colour type {kind[0]}, {kind[1]} bits) "
                                 f"did not read back as written")
    wall = time.perf_counter() - t0
    kinds = sorted({k for _, k, _, _ in files})
    print(f"  PNG reader: {len(files)} files of {CLI_SIDE}x{CLI_SIDE} (colour "
          f"type, bits) {kinds}, every row filter type, all read back exactly: "
          f"{wall / len(files) * 1e3:.3f} ms per image, {decoded / wall / 1e6:.1f} "
          f"MB/s of decoded pixels, one thread [{card}]")


class CliProbe:
    """A Fitter callback with a hook on the train steps, for a CLI run: the
    launches of each epoch by route (counts set to 0 as the epoch begins,
    read as it ends, validation included) and of the final evaluation
    (set to 0 as training ends, read after the CLI returns); over the
    window from the end of step 1 to the end of the epoch's last step (the
    card synchronised at both), the img/s and, under the profiler, the
    card's busy time."""

    def __init__(self, steps: int, profiled: bool):
        self.steps, self.profiled = steps, profiled
        self.launches, self.rates, self.busy = {}, {}, {}
        self._epoch, self._n, self._t0, self._prof = None, 0, None, None

    def wrap(self, fitter):
        for steps in (fitter.steps, fitter._frozen_steps):
            if steps is not None:
                steps.train_step = self._timed(steps.train_step)

    def _timed(self, step):
        def run(state, batch):
            out = step(state, batch)
            self._n += 1
            if self._n in (1, self.steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if self._n == 1:
                    self._t0 = t
                    if self.profiled:
                        from torch.profiler import ProfilerActivity, profile
                        self._prof = profile(activities=[ProfilerActivity.CUDA])
                        self._prof.start()
                else:
                    wall = t - self._t0
                    self.rates[self._epoch] = (self.steps - 1) * CLI_BATCH / wall
                    if self._prof is not None:
                        self._prof.stop()
                        self.busy[self._epoch] = (wall * 1e3, busy_ms(self._prof))
                        self._prof = None
            return out
        return run

    def on_train_begin(self, fitter): ...

    def on_epoch_begin(self, fitter, epoch):
        self._epoch, self._n = epoch, 0
        zero_launches()

    def on_epoch_end(self, fitter, epoch, logs):
        self.launches[epoch] = all_launches()
        if self._n != self.steps:
            raise AssertionError(f"epoch {epoch} took {self._n} steps, not {self.steps}")

    def on_train_end(self, fitter):
        zero_launches()


def run_cli(task, root, extra, probe, name=None):
    """``run_denoising.main`` in this process on ``root``'s PNG folder of
    ``task``, its ``Fitter`` probed, its checkpoints and log under ``name``
    (default: the task); returns (result, the trained model, seconds)."""
    from vit_unet_tpu_torch.cli import run_denoising
    from vit_unet_tpu_torch.train import fitter as fitter_mod
    fitted = []

    class Probed(fitter_mod.Fitter):
        def fit(self, *a, callbacks=(), **kw):
            self.init_state()
            probe.wrap(self)
            fitted.append(self)
            return super().fit(*a, callbacks=[probe, *callbacks], **kw)

    ck = os.path.join(root, f"models_{name or task}")
    log = os.path.join(root, f"log_{name or task}.jsonl")
    argv = ["--task", task, "--input_folder", os.path.join(root, task),
            "--checkpoint_dir", ck, "--log_jsonl", log, *extra]
    t0 = time.perf_counter()
    with mock.patch.object(fitter_mod, "Fitter", Probed):
        result = run_denoising.main(argv)
    seconds = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in result.values()):
        raise AssertionError(f"{task}: result not finite: {result}")
    if not os.path.isfile(os.path.join(ck, "fold0", "best-checkpoint.pt")):
        raise AssertionError(f"{task}: no best checkpoint written")
    with open(log) as f:
        lines = f.readlines()
    n_epochs = int(extra[extra.index("--n_epochs") + 1])
    if len(lines) != n_epochs:
        raise AssertionError(f"{task}: {len(lines)} log lines for {n_epochs} epochs")
    return result, fitted[-1].model, seconds


def cli_expected(kernel_routes: dict, steps: int, val_batches: int) -> dict:
    """Launches of one CLI epoch: ``steps`` train steps through the named
    training kernels and ``val_batches`` validation forwards through kernel
    1, each on the route given, 12 a forward (base's calls)."""
    want = dict.fromkeys(all_launches(), 0)
    for key, route in kernel_routes.items():
        n = 12 * (val_batches if key == "eval" else steps)
        want[key] = want[f"{key}_{route}"] = n
    return want


def phase_entry():
    print("== phase 6: the entry point: run_denoising on PNG folders, export "
          "and load_predictor")
    t_phase = time.perf_counter()
    import importlib
    import tempfile
    from vit_unet_tpu_torch import Predictor, get_vit_unet
    from vit_unet_tpu_torch.data.datasets import kfold_split
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    from vit_unet_tpu_torch.serving import export_predictor, load_predictor
    TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")

    card = card_line()
    train_idx, val_idx = next(kfold_split(CLI_PAIRS, 5))
    steps = len(train_idx) // CLI_BATCH
    val_batches = -(-len(val_idx) // CLI_BATCH)
    base = ["--model_string", "base", "--im_size", "224", "--dtype", "bfloat16",
            "--flash", "--batch_size", str(CLI_BATCH)]
    tc = "tensor_core"
    counts = collections.Counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        t0 = time.perf_counter()
        files = write_cli_folders(root)
        print(f"  wrote {len(files)} PNG files for {len(CLI_LAYOUTS)} tasks in "
              f"{time.perf_counter() - t0:.1f} s")
        check_reader(files, card)

        # denoise: epoch 0 frozen BN (kernels 2 + 3), the refold, epoch 1
        # exact BN (4 + 3); validation and the final evaluation kernel 1
        probe = CliProbe(steps, profiled=True)
        result, model, secs = run_cli(
            "denoise", root, [*base, "--n_epochs", "2", "--bn_freeze_epochs", "1"],
            probe)
        final = all_launches()
        for epoch, fwd in ((0, "fwd"), (1, "bn_fwd")):
            want = cli_expected({fwd: tc, "bwd": tc, "eval": tc}, steps, val_batches)
            got = probe.launches[epoch]
            print(f"  denoise epoch {epoch} ({'frozen' if epoch == 0 else 'exact'} "
                  f"BN): launches {got}")
            if got != want:
                raise AssertionError(f"denoise epoch {epoch}: launches {got}, "
                                     f"expected {want}")
            counts.update(got)
        want = cli_expected({"eval": tc}, 0, val_batches)
        if final != want:
            raise AssertionError(f"final evaluation: launches {final}, expected {want}")
        counts.update(final)
        print(f"  denoise: {result} in {secs:.1f} s; final evaluation launches "
              f"{final['eval_tensor_core']} on the tensor cores")
        for epoch in (0, 1):
            wall, busy = probe.busy[epoch]
            print(f"  denoise epoch {epoch}, steps 2-{steps} of {CLI_BATCH} PNG pairs "
                  f"(resize, ShiftScaleRotate, 2 loader threads), profiled: "
                  f"{probe.rates[epoch]:.1f} img/s, wall {wall:.1f} ms, device busy "
                  f"{busy:.1f} ms, idle {1 - busy / wall:.1%} [{card}]")

        # the other tasks, one exact-BN epoch each
        for task in ("deblur", "derain", "segment"):
            p = CliProbe(steps, profiled=False)
            result, _, secs = run_cli(task, root, [*base, "--n_epochs", "1"], p)
            want = cli_expected({"bn_fwd": tc, "bwd": tc, "eval": tc}, steps,
                                val_batches)
            if p.launches[0] != want:
                raise AssertionError(f"{task}: launches {p.launches[0]}, "
                                     f"expected {want}")
            counts.update(p.launches[0])
            counts.update(all_launches())      # its final evaluation
            print(f"  {task}: {result} in {secs:.1f} s, epoch {p.rates[0]:.1f} "
                  f"img/s over steps 2-{steps}; launches as expected [{card}]")

        # the CLI's default model, lite, bf16: every one of its level shapes
        # takes the tensor cores in kernels 1, 2, 4 and 3 (an exact-BN epoch
        # runs no kernel 2)
        lite_levels = [(h, d) for h, d, _, _ in LITE_LEVELS]
        routes = {"bn_fwd": {T.bn_fwd_route(torch.bfloat16, h, d) for h, d in lite_levels},
                  "bwd": {T.train_bwd_route(torch.bfloat16, h, d) for h, d in lite_levels},
                  "eval": {TK.kernel_route(torch.bfloat16, h, d) for h, d in lite_levels},
                  "fwd": {T.train_fwd_route(torch.bfloat16, h, d) for h, d in lite_levels}}
        if routes != {k: {"tensor_core"} for k in routes}:
            raise AssertionError(f"lite's levels: routes named {routes}, expected the "
                                 "tensor cores for kernels 1, 2, 4 and 3")
        routes = {k: r.pop() for k, r in routes.items() if k != "fwd"}
        p = CliProbe(steps, profiled=False)
        result, _, secs = run_cli(
            "denoise", root, ["--dtype", "bfloat16", "--flash", "--n_epochs", "1"],
            p, name="lite")
        got = p.launches[0]
        print(f"  lite (the CLI's default model), bf16: {result} in {secs:.1f} s; "
              f"launches {got}, routes named {routes}")
        if got["fwd"] or not all(got[k] > 0 and got[f"{k}_{r}"] == got[k]
                                 for k, r in routes.items()):
            raise AssertionError(f"lite: launches {got} are not all on {routes}")
        counts.update(got)
        counts.update(all_launches())

        # export: the trained base model (f32 parameters, bf16 compute) at b64
        rng = np.random.default_rng(1)
        x = rng.random((BATCH + 6, 3, 224, 224), dtype=np.float32)
        path = os.path.join(root, "program_b64")
        t0 = time.perf_counter()
        export_predictor(model, path, batch_size=BATCH)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_predictor(path)
        t_load = time.perf_counter() - t0
        pred = Predictor(model, batch_size=BATCH)
        want_y = pred(x)
        zero_launches()
        got_y = loaded(x)
        torch.cuda.synchronize()
        via = all_launches()
        diff = float(np.abs(got_y - want_y).max())
        print(f"  export of the trained base model at b{BATCH}: {t_export:.1f} s, "
              f"load {t_load:.1f} s; loaded program vs Predictor on {len(x)} inputs: "
              f"bit for bit {np.array_equal(got_y, want_y)}, max|diff| {diff:.3e}; "
              f"kernel 1 launches through the program {via['eval']}, by route "
              f"{ {r: via[f'eval_{r}'] for r in TK.ROUTES} }")
        if via["eval"] != 24 or via["eval_tensor_core"] != 24:
            raise AssertionError(f"the loaded program launched kernel 1 {via}, "
                                 "expected 12 a forward on the tensor cores")
        if not np.isfinite(got_y).all() or diff > 0:
            raise AssertionError("the loaded program disagrees with Predictor")
        counts.update(via)

        def serve_rate(fn):
            t0 = time.perf_counter()
            for _ in range(3):
                fn(x[:BATCH])
            return (time.perf_counter() - t0) / 3 * 1e3
        turns = [(label, serve_rate(fn)) for label, fn in
                 (("Predictor", pred), ("load_predictor", loaded),
                  ("load_predictor", loaded), ("Predictor", pred))]
        print("  b64 batch, numpy in and out, in turns: " + ", ".join(
            f"{label} {ms:.3f} ms" for label, ms in turns) + f" [{card}]")

        # an f32 program exported on the CPU, loaded onto the card
        cpu_model = get_vit_unet("base", device="cpu", seed=0)
        xs = x[:EXPORT_BATCH_CPU]
        want_cpu = Predictor(cpu_model, batch_size=EXPORT_BATCH_CPU, device="cpu")(xs)
        cpu_path = os.path.join(root, "program_cpu")
        export_predictor(cpu_model, cpu_path, batch_size=EXPORT_BATCH_CPU)
        zero_launches()
        got_card = load_predictor(cpu_path)(xs)
        torch.cuda.synchronize()
        via = all_launches()
        rel = float(np.abs(got_card - want_cpu).max() / np.abs(want_cpu).max())
        print(f"  f32 program exported on the CPU, run on the card (TF32 off) vs "
              f"the CPU: rel {rel:.3e} (tol {EXPORT_TOL:.0e}); kernel 1 launches "
              f"{via['eval']}, by route {({r: via[f'eval_{r}'] for r in TK.ROUTES})}")
        if not rel <= EXPORT_TOL or via["eval_cuda_core"] != 12:
            raise AssertionError("the CPU-exported program disagrees on the card")
        counts.update(via)
        del cpu_model

    # the b64 bf16 forward with kernel 1 behind the operator or called
    # straight, in turns (op, direct, direct, op)
    from vit_unet_tpu_torch.nn import reattention
    fresh = get_vit_unet("base", dtype="bfloat16", param_dtype="bfloat16", seed=0)
    xb = torch.from_numpy(x[:BATCH]).cuda()
    via_op = mock.patch.object(
        reattention, "flash_reattention",
        lambda q, k, v, w, b, num_heads: TK.flash_reattention_op(q, k, v, w, b, num_heads))
    turns = []
    for through in (True, False, False, True):
        with via_op if through else contextlib.nullcontext(), torch.inference_mode():
            turns.append(("operator" if through else "direct", time_ms(lambda: fresh(xb), 20)))
    print("  base b64 bf16 forward, kernel 1 through the operator or direct, in "
          "turns: " + ", ".join(f"{label} {ms:.3f} ms" for label, ms in turns)
          + f" [{card}]")
    del fresh, model
    torch.cuda.empty_cache()
    print(f"  phase 6: {time.perf_counter() - t_phase:.1f} s")
    return counts


# --- phase 7: the TF-flavour model ---------------------------------------------

# HViTUNetTF at its default full width (128², patches 8/16/32, keras
# attention, 1,571,098,944 parameters), bf16, batch 64.  Its level-0 keras
# attention (8 heads x dh 192 at N = 256) is the kernels' only caller there:
# levels 1 and 2 (dh 768 and 3072) are wider than ``kernel_takes``.
TF_CONFIG = dict(img_size=128)
TF_BF16 = dict(TF_CONFIG, dtype="bfloat16", param_dtype="bfloat16")
TF_SHAPE = (8, 192, 256)      # (heads, dh, N) of the level-0 keras attention
TF_STEPS = 10
# keras-attention calls at level 0 a forward: 4 encoder and 4 decoder
# layers and the level-0 skip connection
TF_CALLS = 9
# original_attn=False: re-attention calls a forward (4 a level: encoder 0
# and 1, bottleneck, decoder 1 and 0), and keras-attention skips the kernels
# take (the level-0 one; level 1's key_dim 768 is wider than they take)
TF_RS_CALLS = 20
TF_RS_SKIPS = 1
TF_VARIANT_STEPS = 3
TF_F32_STEPS = 3              # (c2): steps a window of the default (f32) config


def tf_batch(n, seed=2):
    s = TF_CONFIG.get("img_size", 128)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(n, s, s, 3, generator=gen, device="cuda")


def path_launches(run):
    """``run()`` with every kernel's counts set to 0 just before it; the
    counts just after, and its result."""
    zero_launches()
    out = run()
    torch.cuda.synchronize()
    return all_launches(), out


def require_launches(label, got, want):
    """``want``: {count: n}, every other count of ``got`` must be 0."""
    full = {k: want.get(k, 0) for k in got}
    print(f"  {label}: launches {dict((k, v) for k, v in got.items() if v)}")
    if got != full:
        raise AssertionError(f"{label}: launches {got}, expected {full}")


def timed_steps(steps, state, batch, n):
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = steps.train_step(state, batch)
        losses.append(m["loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"loss not finite: {losses}")
    return state, losses, sorted(times)[len(times) // 2]


def sdpa_ms(batch, heads, dh, n, dtype):
    """``scaled_dot_product_attention`` on kernel 1's identity-mix inputs:
    the same function (softmax attention, q pre-scaled), held against the
    plain version at kernel 1's tolerance, and its time."""
    from vit_unet_tpu_torch.kernels.flash_reattention import flash_reattention_plain
    q, k, v, w, b = reattention_inputs(batch, heads, dh, n, n, dtype, 0,
                                       identity=True)
    vh = v.view(batch, n, heads, dh).transpose(1, 2)
    run = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, vh, scale=1.0)
    got = run().transpose(1, 2).reshape(batch, n, heads * dh)
    want = flash_reattention_plain(q, k, v, w, b, num_heads=heads)
    rel = rel_err(got, want)[1]
    require("scaled_dot_product_attention (identity mix)", rel, TOL[dtype])
    return time_ms(run, 10)


def tf_kernels(shape=TF_SHAPE, tag="(a)"):
    """``tag`` kernels 1-3 at a keras attention class (heads, dh, N) with
    the identity mix, each called as KerasMHA calls it (the flag that says
    so), on its identity route for the dtype: the level-0 class by default.
    Each is timed against the route it took before its identity route in
    turns (``cuda_core_ms`` / ``tensor_core_ms``: the faster of its two
    turns); kernels 2-4 on their general routes with I and 0 are held
    against their plain versions too."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    heads, dh, n = shape
    print(f"  {tag} kernels 1-3 at B{BATCH} H{heads} dh{dh} N{n}, identity head mix:")
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        k1 = check_kernel(BATCH, heads, dh, n, n, dtype, reps=10, identity_mix=True,
                          label="identity")
        check_train_kernels(BATCH, heads, dh, n, n, dtype, RATE, identity=True)
        row = {"flash_reattention": dict(err=k1["err"], ms=k1["ms"],
                                         plain_ms=k1["plain_ms"],
                                         bound=bound_of(k1["t_bytes"], k1["t_ops"]),
                                         library_ms=sdpa_ms(BATCH, heads, dh, n, dtype),
                                         route=k1["route"])}
        # kernel 2 keeps lse for the backward and draws the Philox mask: no
        # single library call computes that.  Kernel 3 at rate 0 is the
        # backward of scaled_dot_product_attention, timed beside it.
        fwd = time_fwd_identity(BATCH, heads, dh, n, dtype=dtype)
        row["train_fwd"] = dict(err=fwd["err"], ms=fwd["ms"], plain_ms=fwd["plain_ms"],
                                bound=fwd["bound"], cuda_core_ms=fwd["cuda_core_ms"],
                                library_ms=None,
                                route=T.train_fwd_route(dtype, heads, dh, identity_mix=True))
        bwd = time_bwd_identity(BATCH, heads, dh, n, dtype)
        row["train_bwd"] = {"err": bwd["err"], "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
                            "bound": bwd["bound"], f"{bwd['old_route']}_ms": bwd["old_ms"],
                            "library_ms": bwd["sdpa_ms"],
                            "route": T.train_bwd_route(dtype, heads, dh, identity_mix=True)}
        k1_route = row["flash_reattention"]["route"]
        if k1_route == "identity_tc":
            row["flash_reattention"]["tensor_core_ms"] = time_identity(BATCH, heads, dh, n)["old"]
        if k1_route == "identity_f32":
            row["flash_reattention"]["cuda_core_ms"] = time_identity(
                BATCH, heads, dh, n, torch.float32)["old"]
        for label, r in row.items():
            lib = "" if r["library_ms"] is None else f", sdpa {r['library_ms']:.4f} ms"
            old = "".join(f", {key[:-3]} route in turns {r[key]:.4f} ms"
                          for key in ("cuda_core_ms", "tensor_core_ms") if key in r)
            print(f"    {name} {label} [{r['route']}]: "
                  f"{r['ms']:.4f} ms a call, plain {r['plain_ms']:.4f} ms{lib}{old}, bound "
                  f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max_abs_err {r['err']:.3e}")
        res[name] = row
    return res


def tf_serving():
    """(b) the default model served through Predictor from channels-last
    numpy; the kernel path against use_flash=False on the same weights."""
    from vit_unet_tpu_torch import Predictor, get_hvit_unet_tf
    from vit_unet_tpu_torch.nn.mha import KerasMHA
    model = get_hvit_unet_tf(device="cuda", seed=0, **TF_BF16)
    n_params = sum(p.numel() for p in model.parameters())
    pred = Predictor(model, batch_size=BATCH, device="cuda")
    x_np = tf_batch(BATCH).cpu().numpy()
    pred(x_np)                                        # warm-up
    launches, y = path_launches(lambda: pred(x_np))
    # every keras-attention eval call on kernel 1's identity route
    require_launches("(b) serving b64", launches,
                     {"eval": TF_CALLS, "eval_identity_tc": TF_CALLS})
    if y.shape != x_np.shape or not np.isfinite(y).all():
        raise AssertionError(f"bad served output: {y.shape}")
    card = card_line()
    xb = torch.from_numpy(x_np).to("cuda")
    with torch.inference_mode():
        ms = time_ms(lambda: model(xb), reps=10)
    t0 = time.perf_counter()
    for _ in range(3):
        pred(x_np)
    serve_s = (time.perf_counter() - t0) / 3
    print(f"  (b) HViTUNetTF ({n_params:,} parameters) b{BATCH} bf16 forward: "
          f"{ms:.3f} ms/batch, {BATCH / ms * 1e3:.1f} img/s (input on the card); "
          f"Predictor (numpy in/out) {serve_s * 1e3:.3f} ms/batch, "
          f"{BATCH / serve_s:.1f} img/s [{card}]")
    device_breakdown(lambda: model(xb), ms, "HViTUNetTF forward", reps=2,
                     inference=True, top=8)
    xs = xb[:8]
    with torch.inference_mode():
        got = (model(xs) - xs).float()
        mhas = [m for m in model.modules() if isinstance(m, KerasMHA)]
        for m in mhas:
            m.use_flash = False
        want = (model(xs) - xs).float()
        for m in mhas:
            m.use_flash = True
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    print(f"  (b) bf16 decoded output (y - x), kernel path vs use_flash=False, "
          f"batch 8: max_abs_err {err:.3e} rel {rel:.3e} (tol {MODEL_TOL_BF16:.0e})")
    if not rel <= MODEL_TOL_BF16:
        raise AssertionError("HViTUNetTF's kernel path disagrees with its plain path")
    del model, pred
    torch.cuda.empty_cache()
    return launches, dict(ms=ms, serve_ms=serve_s * 1e3)


def tf_training():
    """(c) TF_STEPS AdamW steps with dropout at the config's rates, then
    one dropout-free f32 step of the kernel path against the plain path."""
    from vit_unet_tpu_torch import get_hvit_unet_tf
    from vit_unet_tpu_torch.nn.mha import KerasMHA
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse
    model = get_hvit_unet_tf(device="cuda", seed=0, **TF_BF16).train()
    opt = adamw(model, 1e-4)
    state = TrainState.create(model=model, optimizer=opt, seed=1)
    steps = build_step_functions(model, opt, mse)
    x = tf_batch(BATCH)
    batch = {"x": x, "y": 0.9 * x}
    state, _, _ = timed_steps(steps, state, batch, 1)       # warm-up
    torch.cuda.reset_peak_memory_stats()
    launches, (state, losses, step_ms) = path_launches(
        lambda: timed_steps(steps, state, batch, TF_STEPS))
    n = TF_STEPS * TF_CALLS
    # every kernel-2 and kernel-3 launch on its identity route, no o_norm
    # written or kept, no map workspace
    require_launches(f"(c) {TF_STEPS} keras-attention train steps", launches,
                     {"fwd": n, "fwd_identity_tc": n, "bwd": n, "bwd_identity_tc": n})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card = card_line()
    print(f"  (c) HViTUNetTF b{BATCH} bf16 train step (dropout 0.2/0.2/0.4): median "
          f"{step_ms:.3f} ms, {BATCH / step_ms * 1e3:.1f} img/s, losses "
          f"{losses[0]:.5f} .. {losses[-1]:.5f}, peak memory {peak:.2f} GiB [{card}]")
    device_breakdown(lambda: steps.train_step(state, batch), step_ms,
                     "HViTUNetTF train step", reps=1, top=12)
    del model, opt, state, steps
    torch.cuda.empty_cache()

    # one dropout-free f32 step at batch 4: kernel path vs plain path
    model = get_hvit_unet_tf(device="cuda", seed=0, **TF_CONFIG, drop_attn=0.0,
                             drop_proj=0.0, drop_linear=0.0).train()
    xs = tf_batch(4, seed=5)
    mhas = [m for m in model.modules() if isinstance(m, KerasMHA)]
    res = []
    for flash in (True, False):
        for m in mhas:
            m.use_flash = flash
        model.zero_grad(set_to_none=True)
        loss = mse(model(xs, deterministic=False).float(), 0.9 * xs)
        loss.backward()
        res.append((loss.item(), [p.grad.clone() for p in model.parameters()]
                    if flash else [p.grad for p in model.parameters()]))
    (lk, gk), (lp, gp) = res
    gmax = max(g.abs().max().item() for g in gp)
    grel = max((a - b).abs().max().item() for a, b in zip(gk, gp)) / gmax
    lrel = abs(lk - lp) / abs(lp)
    print(f"  (c) f32 batch-4 dropout-free step, kernel path vs plain path: loss rel "
          f"{lrel:.2e}, grads rel {grel:.2e} of the largest (tol {TRAIN_PATH_TOL:.0e})")
    if not max(lrel, grel) <= TRAIN_PATH_TOL:
        raise AssertionError("HViTUNetTF's kernel train step disagrees with its plain path")
    del model, res, gk, gp
    torch.cuda.empty_cache()
    return launches, dict(step_ms=step_ms, peak_gib=peak)


def tf_variant():
    """(d) original_attn=False, flash_train=True, exact BN: kernels 4 and 3
    on the tensor cores at (8, 24/96/384); the level-0 skip's keras
    attention on kernel 2's and kernel 3's identity routes at (8, 192)."""
    from vit_unet_tpu_torch import get_hvit_unet_tf
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse
    model = get_hvit_unet_tf(device="cuda", seed=0, **TF_BF16,
                             original_attn=False).train()
    opt = adamw(model, 1e-4)
    state = TrainState.create(model=model, optimizer=opt, seed=1)
    steps = build_step_functions(model, opt, mse)
    x = tf_batch(BATCH)
    batch = {"x": x, "y": 0.9 * x}
    launches, (state, losses, step_ms) = path_launches(
        lambda: timed_steps(steps, state, batch, TF_VARIANT_STEPS))
    n, r = TF_VARIANT_STEPS * TF_RS_SKIPS, TF_VARIANT_STEPS * TF_RS_CALLS
    require_launches(f"(d) re-attention variant, {TF_VARIANT_STEPS} exact-BN steps",
                     launches,
                     {"bn_fwd": r, "bn_fwd_tensor_core": r, "bwd": r + n,
                      "bwd_tensor_core": r, "bwd_identity_tc": n, "fwd": n,
                      "fwd_identity_tc": n})
    print(f"  (d) HViTUNetTF(original_attn=False) b{BATCH} bf16 exact-BN step: "
          f"median {step_ms:.3f} ms, {BATCH / step_ms * 1e3:.1f} img/s, losses "
          f"{losses[0]:.5f} .. {losses[-1]:.5f} [{card_line()}]")
    device_breakdown(lambda: steps.train_step(state, batch), step_ms,
                     "re-attention variant train step", reps=1, top=10)
    del model, opt, state, steps
    torch.cuda.empty_cache()
    return launches


def tf_f32_forward():
    """(b2) the default config as it is (float32), b64 at 128²: the forward
    with every kernel-1 launch on the f32 identity route, timed in turns
    against the same forward with kernel 1 held on the CUDA-core route
    (old, new, new, old), the two outputs held against each other."""
    import importlib
    from vit_unet_tpu_torch import get_hvit_unet_tf
    TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
    model = get_hvit_unet_tf(device="cuda", seed=0, **TF_CONFIG)
    x = tf_batch(BATCH)
    fwd = lambda: model(x)
    with torch.inference_mode():
        fwd()
        launches, y_new = path_launches(fwd)
        require_launches("(b2) f32 forward b64", launches,
                         {"eval": TF_CALLS, "eval_identity_f32": TF_CALLS})
        route = TK.kernel_route
        held = mock.patch.object(TK, "kernel_route",
                                 lambda dt, h, d, identity_mix=False: route(dt, h, d))
        with held:
            y_old = fwd()
        turns = []
        for name in ("cuda_core", "identity_f32", "identity_f32", "cuda_core"):
            with held if name == "cuda_core" else contextlib.nullcontext():
                turns.append((name, time_ms(fwd, reps=3, warmup=1)))
    rel = rel_err(y_new - x, y_old - x)[1]
    old = min(t for r, t in turns if r == "cuda_core")
    new = min(t for r, t in turns if r == "identity_f32")
    print(f"  (b2) HViTUNetTF default config (f32) b{BATCH} forward, kernel 1 in turns: "
          + ", ".join(f"{r} {t:.3f} ms" for r, t in turns)
          + f"; {old - new:.3f} ms faster; output (y - x) rel {rel:.2e} (tol {MODEL_TOL:.0e}) "
          f"[{card_line()}]")
    require("the f32 forward on the identity route against route 0", rel, MODEL_TOL)
    del model
    torch.cuda.empty_cache()
    return launches, dict(ms=new, cuda_core_ms=old)


@contextlib.contextmanager
def old_identity_routes():
    """Kernels 2 and 3 held on the routes they took before their identity
    routes: their route choices with the caller's flag ignored."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    fwd, bwd = T.train_fwd_route, T.train_bwd_route
    with mock.patch.object(T, "train_fwd_route",
                           lambda dt, h, d, identity_mix=False: fwd(dt, h, d)), \
            mock.patch.object(T, "train_bwd_route",
                              lambda dt, h, d, identity_mix=False: bwd(dt, h, d)):
        yield


def tf_f32_training():
    """(c2) the default config as it is (float32, the config's dropout),
    TF_F32_STEPS AdamW steps at b64, or the largest power-of-two batch that
    fits: every kernel-2 and kernel-3 launch on its f32 identity route;
    median ms, img/s and peak memory; then steps with kernels 2 and 3 held
    on their old routes (the CUDA cores) and on the identity routes in
    turns (old, new, new, old)."""
    from vit_unet_tpu_torch import get_hvit_unet_tf
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse
    model = get_hvit_unet_tf(device="cuda", seed=0, **TF_CONFIG).train()
    opt = adamw(model, 1e-4)
    state = TrainState.create(model=model, optimizer=opt, seed=1)
    steps = build_step_functions(model, opt, mse)
    n_img = BATCH
    while True:
        x = tf_batch(n_img)
        batch = {"x": x, "y": 0.9 * x}
        torch.cuda.reset_peak_memory_stats()
        try:
            state, _, _ = timed_steps(steps, state, batch, 1)       # warm-up
            break
        except torch.cuda.OutOfMemoryError:
            model.zero_grad(set_to_none=True)
            del x, batch
            torch.cuda.empty_cache()
            if n_img <= 8:
                raise
            print(f"  (c2) b{n_img} does not fit; halving the batch")
            n_img //= 2
    launches, (state, losses, step_ms) = path_launches(
        lambda: timed_steps(steps, state, batch, TF_F32_STEPS))
    n = TF_F32_STEPS * TF_CALLS
    require_launches(f"(c2) {TF_F32_STEPS} f32 train steps", launches,
                     {"fwd": n, "fwd_identity_f32": n, "bwd": n, "bwd_identity_f32": n})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    turns = []
    for name in ("old", "new", "new", "old"):
        with old_identity_routes() if name == "old" else contextlib.nullcontext():
            state, _, ms = timed_steps(steps, state, batch, TF_F32_STEPS)
        turns.append((name, ms))
    old = min(t for r, t in turns if r == "old")
    new = min(t for r, t in turns if r == "new")
    print(f"  (c2) HViTUNetTF default config (f32) b{n_img} train step (dropout 0.2/0.2/0.4): "
          f"median {step_ms:.3f} ms, {n_img / step_ms * 1e3:.1f} img/s, losses "
          f"{losses[0]:.5f} .. {losses[-1]:.5f}, peak memory {peak:.2f} GiB; kernels 2 and 3 "
          "in turns: " + ", ".join(f"{r} {t:.3f} ms" for r, t in turns)
          + f"; {old - new:.3f} ms faster [{card_line()}]")
    device_breakdown(lambda: steps.train_step(state, batch), step_ms,
                     "HViTUNetTF f32 train step", reps=1, top=12)
    del model, opt, state, steps
    torch.cuda.empty_cache()
    return launches, dict(step_ms=step_ms, peak_gib=peak, batch=n_img, ms=new, old_ms=old)


def base_step(remat, block_type="reattention", flash_train=True, timed=True,
              spy=None):
    """One base b64 bf16 exact-BN step with dropout on, from seed 0's
    weights: its loss, gradients (by name), running statistics, generator
    state and peak GiB; with ``timed``, also the median ms of 3 steps after
    it and the forward's ms.  ``spy`` (a ``BackwardReplay``) watches that
    one step."""
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse
    model = get_vit_unet("base", dtype="bfloat16", param_dtype="bfloat16", seed=0,
                         remat=remat, block_type=block_type,
                         flash_train=flash_train, device="cuda").train()
    opt = adamw(model, 1e-4)
    state = TrainState.create(model=model, optimizer=opt, seed=3)
    steps = build_step_functions(model, opt, mse)
    s = model.config.im_size
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, 3, s, s, generator=gen, device="cuda")
    batch = {"x": x, "y": 0.9 * x}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with spy or contextlib.nullcontext():
        state, m = steps.train_step(state, batch)
    out = dict(
        loss=m["loss"].item(), peak=torch.cuda.max_memory_allocated() / 2 ** 30,
        grads={n: p.grad.float().clone() for n, p in model.named_parameters()},
        stats=torch.cat([b.float().flatten() for n, b in model.named_buffers()
                         if "running" in n] or [torch.zeros(1, device="cuda")]),
        gen=state.generator.get_state())
    if timed:
        state, _, out["ms"] = timed_steps(steps, state, batch, 3)    # steady steps
        with torch.inference_mode():
            out["fwd_ms"] = time_ms(lambda: model(x, deterministic=True,
                                                  use_running_average=True),
                                    reps=5, warmup=1)
    del model, opt, state, steps
    torch.cuda.empty_cache()
    return out


# remat against no remat, base b64 bf16 exact BN with dropout on.  The loss
# and running statistics come from the forward, which is deterministic, and
# must be equal bit for bit, as must the generator's state.  The kernel
# path's backward sums one gradient by f32 atomics whose order varies from
# run to run, and exact BN at random init magnifies those last bits to
# about 1e-2 of the largest gradient, so two no-remat runs' gradients
# differ too.  A bound on that spread is a statistic and can miss or flag
# anything; instead the backward is made repeatable (``BackwardReplay``):
# a no-remat step records every backward launch's inputs and outputs, and
# the remat step's launches, whose inputs (the recomputed q, k, v_cat, lse
# and seed among them) must each equal a recorded launch's bit for bit,
# return the recorded outputs.  Then every gradient of remat must equal no
# remat's bit for bit.  A planted fault (the recomputation not setting the
# generator and buffers back) must fail the same check.  The plain path's
# backward (flash_train=False) is deterministic in bf16: there remat's
# gradients must equal no remat's bit for bit as they come.


class BackwardReplay:
    """Watches ``launch_bwd``, the kernel backward's one launch.  Without
    ``recorded`` it keeps each launch's inputs and outputs (``records``);
    with a recording ``BackwardReplay``, each launch still runs, and where
    its inputs equal an unused recorded launch's bit for bit it returns
    copies of that launch's outputs, else its own (``unmatched`` counts
    those).  Only the atomics' summation order, which varies from run to
    run, is taken out of the backward so."""

    def __init__(self, recorded=None):
        self.recorded = recorded
        self.records, self.used, self.unmatched, self.calls = [], set(), 0, 0

    def __enter__(self):
        from vit_unet_tpu_torch.kernels import flash_reattention_train as T
        self.launch = T.launch_bwd
        self.patch = mock.patch.object(T, "launch_bwd", self)
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()
        del self.patch        # it holds self: free the records without a gc pass

    @staticmethod
    def _inputs(args, kwargs):
        flat = []
        for a in list(args) + sorted(kwargs.items()):
            flat.extend(a if isinstance(a, tuple) else (a,))
        return [a.detach().clone() if torch.is_tensor(a) else a for a in flat]

    @staticmethod
    def _same(a, b) -> bool:
        return len(a) == len(b) and all(
            (torch.is_tensor(x) and torch.is_tensor(y) and x.dtype == y.dtype
             and x.shape == y.shape and torch.equal(x, y))
            or (not torch.is_tensor(x) and not torch.is_tensor(y) and x == y)
            for x, y in zip(a, b))

    def __call__(self, *args, **kwargs):
        out = self.launch(*args, **kwargs)
        inputs = self._inputs(args, kwargs)
        self.calls += 1
        if self.recorded is None:
            self.records.append((inputs, tuple(t.clone() for t in out)))
            return out
        records = self.recorded.records
        order = [self.calls - 1] + list(range(len(records)))
        for i in order:
            if i < len(records) and i not in self.used and self._same(records[i][0], inputs):
                self.used.add(i)
                return tuple(t.clone() for t in records[i][1])
        self.unmatched += 1
        return out

    def complete(self) -> bool:
        """Every launch matched a recorded one, and every recorded one was
        matched."""
        n = len(self.recorded.records)
        return self.unmatched == 0 and self.calls == n and len(self.used) == n


def same_step(a, b) -> bool:
    """Loss, running statistics and generator state equal bit for bit."""
    return (a["loss"] == b["loss"] and torch.equal(a["stats"], b["stats"])
            and torch.equal(a["gen"], b["gen"]))


def unequal_grads(a, b) -> list:
    """The names of the gradients of ``a`` that are not ``b``'s bit for bit."""
    return [n for n, g in a["grads"].items() if not torch.equal(g, b["grads"][n])]


def replayed_remat(record):
    """The remat step replaying ``record``'s backward."""
    replay = BackwardReplay(record)
    out = base_step(True, timed=False, spy=replay)
    out["replay"] = replay
    return out


def tf_remat_fourier():
    """(e) remat against no remat on base, and the Fourier block."""
    from vit_unet_tpu_torch.nn import remat as remat_module
    ref = base_step(False)
    remat = base_step(True)
    record = BackwardReplay()
    again = base_step(False, timed=False, spy=record)
    replayed = replayed_remat(record)
    with mock.patch.object(remat_module, "_set", lambda *a: None):
        planted = replayed_remat(record)
    gmax = max(g.abs().max().item() for g in ref["grads"].values())
    spread = max((again["grads"][n] - g).abs().max().item()
                 for n, g in ref["grads"].items()) / gmax
    off = max((remat["grads"][n] - g).abs().max().item()
              for n, g in ref["grads"].items()) / gmax
    unequal = unequal_grads(replayed, again)
    rep = replayed["replay"]
    card = card_line()
    print(f"  (e) base b{BATCH} bf16 exact-BN step, dropout 0.2, kernel path: remat "
          f"vs no remat: loss, running statistics and generator state equal bit "
          f"for bit {same_step(remat, ref)} (two no-remat runs {same_step(again, ref)}); "
          f"as they come, grads {off:.2e} of the largest apart (two no-remat runs "
          f"{spread:.2e}: the backward's atomics); with the backward replayed, "
          f"{rep.calls - rep.unmatched}/{len(record.records)} launches' inputs "
          f"equal bit for bit and gradients {len(ref['grads']) - len(unequal)}/"
          f"{len(ref['grads'])}; peak memory remat {remat['peak']:.2f} GiB, no "
          f"remat {ref['peak']:.2f} GiB; step (median of 3 after the first) "
          f"{remat['ms']:.3f} / {ref['ms']:.3f} ms [{card}]")
    planted_caught = (not planted["replay"].complete() and bool(unequal_grads(planted, again))
                      and not same_step(planted, again))
    print(f"  (e) planted fault, the recomputation not setting the generator and "
          f"buffers back: {planted['replay'].unmatched}/{planted['replay'].calls} "
          f"launches unmatched, {len(unequal_grads(planted, again))} gradients "
          f"unequal, step equal {same_step(planted, again)}: caught {planted_caught}")
    if not (same_step(again, ref) and same_step(remat, ref) and same_step(replayed, ref)):
        raise AssertionError("remat changed the loss, the running statistics or "
                             "the generator's state")
    if not record.records or not rep.complete() or unequal:
        raise AssertionError(
            f"remat's replayed backward is not no remat's: {rep.unmatched} of "
            f"{rep.calls} launches unmatched ({len(record.records)} recorded), "
            f"gradients unequal: {unequal[:5]}")
    if not planted_caught:
        raise AssertionError("the replay check did not catch a recomputation "
                             "that draws other seeds")
    if not remat["peak"] < ref["peak"]:
        raise AssertionError("remat did not lower the step's peak memory")
    del record, again, replayed, planted, rep    # the records hold GiBs
    plain = [base_step(r, flash_train=False, timed=False) for r in (False, False, True)]
    unequal = [n for n, g in plain[0]["grads"].items()
               if not all(torch.equal(p["grads"][n], g) for p in plain[1:])]
    print(f"  (e) the same on the plain path (flash_train=False): two no-remat "
          f"runs and remat equal bit for bit: step {all(same_step(p, plain[0]) for p in plain[1:])}, "
          f"gradients {len(plain[0]['grads']) - len(unequal)}/{len(plain[0]['grads'])}")
    if unequal or not all(same_step(p, plain[0]) for p in plain[1:]):
        raise AssertionError(f"the plain path's remat step is not no remat's: {unequal[:5]}")
    del plain
    fourier = base_step(False, block_type="fourier")
    finite = (math.isfinite(fourier["loss"])
              and all(torch.isfinite(g).all() for g in fourier["grads"].values()))
    print(f"  (e) base block_type='fourier' b{BATCH} bf16: forward {fourier['fwd_ms']:.3f} ms, "
          f"train step {fourier['ms']:.3f} ms, loss {fourier['loss']:.5f}, finite "
          f"{finite}, peak memory {fourier['peak']:.2f} GiB [{card}]")
    if not finite:
        raise AssertionError("the Fourier model's step is not finite")
    return dict(spread=spread, remat=off,
                peak=(remat["peak"], ref["peak"]), step_ms=(remat["ms"], ref["ms"]),
                fourier=(fourier["fwd_ms"], fourier["ms"]))


def phase_tf():
    print("== phase 7: HViTUNetTF (keras attention on kernels 1-3), its "
          "re-attention variant, remat and the Fourier block")
    t_phase = time.perf_counter()
    kernels = tf_kernels()
    serve, serve_t = tf_serving()
    f32_serve, f32_t = tf_f32_forward()
    train, train_t = tf_training()
    f32_train, f32_train_t = tf_f32_training()
    variant = tf_variant()
    remat = tf_remat_fourier()
    print(f"  phase 7: {time.perf_counter() - t_phase:.1f} s")
    return dict(kernels=kernels, serving=serve, train=train, variant=variant,
                serve_t=serve_t, train_t=train_t, remat=remat, f32_serving=f32_serve,
                f32_t=f32_t, f32_train=f32_train, f32_train_t=f32_train_t)


# --- phase 8: the classifier ----------------------------------------------------

# ViTClassifier at the CLI's default widths: 224², patch 16, 196 patches,
# depth 2 x depth_te 4, hidden 128, 16 heads, head (64, 4); 5,975,984
# parameters (the JAX model's eval_shape count).  Its levels are (16 heads,
# dh 48) at N 196 and (16, 12) at N 784, 4 blocks each: kernels 1-4 on
# their tensor-core routes in bf16 at both.
CLS_CONFIG = dict(num_patches=196)
CLS_BF16 = dict(CLS_CONFIG, dtype="bfloat16", param_dtype="bfloat16")
CLS_PARAMS = 5_975_984
CLS_LEVELS = [(16, 48, 196, 4), (16, 12, 784, 4)]   # (heads, dh, n, calls)
# the classes each forward took to the tensor cores last, held on the
# CUDA cores in phase 8's turns
CLS_NEW_TC = {"fwd": {(16, 12), (16, 48)}, "bn_fwd": {(16, 48)}}
CLS_CALLS = 8               # re-attention calls a forward or step
CLS_STEPS = 5
CLS_SMOOTHING = 0.05
# the CLI: 4 classes of 24 images, PNG, BMP and the committed JPEG fixtures
CLS_CLASSES = 4
CLS_PER_CLASS = 24
CLS_IMAGE = (150, 200)      # stored PNG and BMP images (height, width)
JPEG_FIXTURES = os.path.join("tests", "data", "jpeg")


def cls_batch(n, seed=2):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(n, 3, 224, 224, generator=gen, device="cuda")
    labels = torch.randint(0, 4, (n,), generator=gen, device="cuda")
    return {"x": x, "y": torch.eye(4, device="cuda")[labels]}


def cls_loss(logits, target):
    from vit_unet_tpu_torch.train.losses import categorical_crossentropy
    return categorical_crossentropy(logits, target, label_smoothing=CLS_SMOOTHING)


def cls_expected(routes: dict, n: int) -> dict:
    """{count: n * calls}: each kernel of ``routes`` (kernel -> {route:
    calls a forward or step}) CLS_CALLS times a forward or step, and each of
    its routes its calls."""
    want = {}
    for key, per_route in routes.items():
        want[key] = n * CLS_CALLS
        for route, calls in per_route.items():
            want[f"{key}_{route}"] = n * calls
    return want


def cls_routes():
    """The routes the route functions name for the classifier's levels in
    bf16, {kernel: {route: calls a forward or step}}, or the phase fails:
    every kernel takes the tensor cores at both levels."""
    import importlib
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
    routes = {"eval": TK.kernel_route, "fwd": T.train_fwd_route,
              "bn_fwd": T.bn_fwd_route, "bwd": T.train_bwd_route}
    named = {}
    for key, pick in routes.items():
        named[key] = collections.Counter()
        for h, d, _, calls in CLS_LEVELS:
            named[key][pick(torch.bfloat16, h, d)] += calls
        named[key] = dict(named[key])
    if named != dict.fromkeys(routes, {"tensor_core": CLS_CALLS}):
        raise AssertionError(f"unexpected routes for the classifier: {named}")
    return named


def cls_kernels():
    """(a0) kernels 1-4 at the classifier's two level shapes, b64, rate 0.2,
    f32 and bf16: kernel / plain / bound ms per call; SDPA's time beside
    kernel 1 as a reading (no head mix); in bf16 kernels 2-4 also on both
    routes in turns, and kernel 1's log-sum-exp pass alone (both forwards'
    first launch at (16, 48); at (16, 12) their sweep takes the log-sum-exp
    itself)."""
    import importlib
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
    res = {}
    for heads, dh, n, _ in CLS_LEVELS:
        shape = f"H{heads} dh{dh} N{n}"
        res[shape] = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            k1 = check_kernel(BATCH, heads, dh, n, n, dtype, reps=10)
            tk = check_train_kernels(BATCH, heads, dh, n, n, dtype, RATE, reps=5)
            bounds = train_bounds(BATCH, heads, dh, n, n, dtype)
            row = {"flash_reattention": dict(
                err=k1["err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
                bound=bound_of(k1["t_bytes"], k1["t_ops"]), route=k1["route"],
                sdpa_ms=sdpa_ms(BATCH, heads, dh, n, dtype))}
            for key, route_of in (("fwd", T.train_fwd_route), ("bn_fwd", T.bn_fwd_route),
                                  ("bwd", T.train_bwd_route)):
                row[key] = dict(err=tk[key]["err"], ms=tk[key]["ms"],
                                plain_ms=tk[key]["plain_ms"],
                                bound=bound_of(*bounds[key]),
                                route=route_of(dtype, heads, dh))
            if row["bwd"]["route"] == "tensor_core":
                row["bwd"]["cuda_core_ms"], _ = time_bwd_routes(BATCH, heads, dh, n)
            for key in ("fwd", "bn_fwd"):
                if row[key]["route"] == "tensor_core":
                    row[key]["cuda_core_ms"], _ = time_fwd_routes(key, BATCH, heads, dh, n)
            if dtype == torch.bfloat16:
                q, k, v, w, b = reattention_inputs(BATCH, heads, dh, n, n, dtype, 0)
                lse = torch.empty(BATCH, heads, n, device="cuda")
                out = torch.empty(BATCH, n, heads * dh, device="cuda", dtype=dtype)
                row["flash_reattention"]["lse_pass_ms"] = time_ms(
                    lambda: TK.launch_passes(q, k, v, w, b, lse, out, route="tensor_core",
                                             passes=1), 10)
            for label, r in row.items():
                extra = f", sdpa {r['sdpa_ms']:.4f} ms" if "sdpa_ms" in r else ""
                extra += (f", its LSE pass alone {r['lse_pass_ms']:.4f} ms"
                          if "lse_pass_ms" in r else "")
                extra += (f", cuda_core in turns {r['cuda_core_ms']:.4f} ms"
                          if "cuda_core_ms" in r else "")
                print(f"    {shape} {name} {label} [{r['route']}]: {r['ms']:.4f} ms a "
                      f"call, plain {r['plain_ms']:.4f} ms{extra}, bound "
                      f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max_abs_err "
                      f"{r['err']:.3e} [{card_line()}]")
            res[shape][name] = row
    return res


def held_on_cuda_cores(key, classes):
    """A patch of forward ``key``'s route function (``TRAIN_ROUTE_PICKS``)
    that names the CUDA-core route at the (heads, dh) ``classes`` and what
    it named before everywhere else."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    name = TRAIN_ROUTE_PICKS[key][0]
    pick = getattr(T, name)
    return mock.patch.object(
        T, name, lambda dtype, heads, dh, *a, **k: (
            "cuda_core" if (heads, dh) in classes else pick(dtype, heads, dh, *a, **k)))


def cls_model_runs(routes):
    """(a) the bf16 b64 forward and train steps with their launches by
    route; the kernel path against use_flash=False; each step in turns
    with the forward's classes of CLS_NEW_TC held on the CUDA cores and as
    named (held, new, new, held, each the median of 3), faster as named."""
    from vit_unet_tpu_torch import get_vit_classifier
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    from vit_unet_tpu_torch.parallel.train_step import TrainState, build_step_functions
    card = card_line()
    model = get_vit_classifier(device="cuda", seed=0, **CLS_BF16)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != CLS_PARAMS:
        raise AssertionError(f"the classifier has {n_params:,} parameters, "
                             f"not {CLS_PARAMS:,}")
    batch = cls_batch(BATCH)
    x = batch["x"]
    launches = collections.Counter()
    with torch.inference_mode():
        model(x)                                          # warm-up
        got, logits = path_launches(lambda: model(x))
        require_launches("(a) forward b64", got, cls_expected({"eval": routes["eval"]}, 1))
        launches.update(got)
        ms = time_ms(lambda: model(x), reps=10)
    if logits.shape != (BATCH, 4) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: {tuple(logits.shape)}")
    print(f"  (a) ViTClassifier ({n_params:,} parameters) b{BATCH} bf16 forward: "
          f"{ms:.3f} ms, {BATCH / ms * 1e3:.1f} img/s (input on the card) [{card}]")
    device_breakdown(lambda: model(x), ms, "classifier forward", reps=3,
                     inference=True, top=8)
    layers = [m for m in model.modules() if isinstance(m, ReAttention)]
    with torch.inference_mode():
        for layer in layers:
            layer.use_flash = False
        want = model(x[:8]).float()
        for layer in layers:
            layer.use_flash = True
        rel = rel_err(model(x[:8]).float(), want)[1]
    print(f"  (a) bf16 logits, kernel path vs use_flash=False, batch 8: rel {rel:.3e} "
          f"(tol {MODEL_TOL_BF16:.0e})")
    require("the classifier's kernel path", rel, MODEL_TOL_BF16)

    res = dict(fwd_ms=ms)
    for frozen in (False, True):
        label = "frozen" if frozen else "exact"
        m = get_vit_classifier(device="cuda", seed=0, **CLS_BF16).train()
        opt = torch.optim.Adam(m.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
        state = TrainState.create(model=m, optimizer=opt, seed=1)
        steps = build_step_functions(m, opt, cls_loss, bn_frozen=frozen)
        state, _, _ = timed_steps(steps, state, batch, 1)           # warm-up
        torch.cuda.reset_peak_memory_stats()
        got, (state, losses, step_ms) = path_launches(
            lambda: timed_steps(steps, state, batch, CLS_STEPS))
        fwd = "fwd" if frozen else "bn_fwd"
        require_launches(f"(a) {CLS_STEPS} {label}-BN steps", got,
                         cls_expected({fwd: routes[fwd], "bwd": routes["bwd"]}, CLS_STEPS))
        launches.update(got)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  (a) {label}-BN b{BATCH} bf16 step (Adam 1e-4, CE with label "
              f"smoothing {CLS_SMOOTHING}, dropout 0.2): median {step_ms:.3f} ms, "
              f"{BATCH / step_ms * 1e3:.1f} img/s, losses {losses[0]:.5f} .. "
              f"{losses[-1]:.5f}, peak memory {peak:.2f} GiB [{card}]")
        device_breakdown(lambda: steps.train_step(state, batch), step_ms,
                         f"classifier {label}-BN step", reps=1, top=10)
        res[f"{label}_ms"], res[f"{label}_peak"] = step_ms, peak
        classes = CLS_NEW_TC[fwd]
        turns = []
        for route in ("cuda_core", "tensor_core", "tensor_core", "cuda_core"):
            with (held_on_cuda_cores(fwd, classes) if route == "cuda_core"
                  else contextlib.nullcontext()):
                state, _, t = timed_steps(steps, state, batch, 3)
            turns.append((route, t))
        held_ms = min(t for r, t in turns if r == "cuda_core")
        new_ms = min(t for r, t in turns if r == "tensor_core")
        print(f"  (a) {label}-BN b{BATCH} bf16 step, kernel {TRAIN_ROUTE_PICKS[fwd][1]} at "
              f"{sorted(classes)} on each route in turns (median of 3): "
              + ", ".join(f"{r} {t:.3f} ms" for r, t in turns)
              + f"; held / as named {held_ms / new_ms:.2f}x [{card}]")
        if not new_ms < held_ms:
            raise AssertionError(f"the classifier's {label}-BN step is not faster with "
                                 f"kernel {TRAIN_ROUTE_PICKS[fwd][1]} at {sorted(classes)} "
                                 "on the tensor cores")
        res[f"{label}_turns"] = turns
        del m, opt, state, steps
    del model
    torch.cuda.empty_cache()
    return launches, res


def cls_step_result(flash, bn_frozen, batch, dtype="float32", eps=None):
    """(loss, grads, running statistics) of one classifier train step in
    float64, dropout on, from seed 0's weights and dropout seed 7; ``eps``:
    the head-mix BatchNorm's (the config keeps JAX's 1e-5)."""
    from vit_unet_tpu_torch import get_vit_classifier
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    from vit_unet_tpu_torch.parallel.train_step import TrainState, build_step_functions
    model = get_vit_classifier(device="cuda", seed=0, flash_train=flash, dtype=dtype,
                               param_dtype=dtype, **CLS_CONFIG).train()
    for layer in model.modules():
        if isinstance(layer, ReAttention) and eps is not None:
            layer.bn_eps = layer.var_norm.eps = eps
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    steps = build_step_functions(model, opt, cls_loss, bn_frozen=bn_frozen)
    _, m = steps.train_step(TrainState.create(model=model, optimizer=opt, seed=7), batch)
    grads = torch.cat([p.grad.double().flatten() for p in model.parameters()])
    stats = torch.cat([b.double() for name, b in model.named_buffers()
                       if "running" in name])
    return m["loss"].item(), grads, stats


def cls_compare_paths():
    """(a) one f32 batch-4 step of the kernel path against the plain path
    with the same weights and dropout seed.  Frozen BN: loss, running
    statistics and gradients held at TRAIN_PATH_TOL.  Exact BN, against a
    float64 plain run at the config's eps and at EXACT_EPS: loss and
    running statistics held at EXACT_TOL; the gradients are printed, not
    held.  The largest gradient of the fresh model, the first block's
    head-mix BatchNorm bias, is a sum over B·N·N map entries, and the kernel
    path's f32 error there is 3-7x the plain path's (PERF.md); every
    other tensor, and each call's exact-BN gradients at 16 heads (phase 2b,
    against float64), agree far more closely."""
    batch = cls_batch(4, seed=5)
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()
    diffs = lambda a, b: (abs(a[0] - b[0]) / abs(b[0]), rel(a[1], b[1]), rel(a[2], b[2]))
    kern, plain = (cls_step_result(f, True, batch) for f in (True, False))
    l, g, st = diffs(kern, plain)
    print(f"  (a) f32 batch-4 frozen-BN step, kernel path vs plain path: loss rel "
          f"{l:.2e}, grads rel {g:.2e} of the largest, running stats rel {st:.2e} "
          f"(tol {TRAIN_PATH_TOL:.0e})")
    if not max(l, g, st) <= TRAIN_PATH_TOL:
        raise AssertionError("the classifier's frozen-BN kernel step disagrees "
                             "with the plain path")
    exact = {}
    for eps in (1e-5, EXACT_EPS):
        ref = cls_step_result(False, False, batch, "float64", eps)
        kern, plain = (cls_step_result(f, False, batch, eps=eps) for f in (True, False))
        (kl, kg, ks), (pl, pg, ps) = diffs(kern, ref), diffs(plain, ref)
        print(f"  (a) f32 batch-4 exact-BN (eps {eps:.0e}) step against the plain path "
              f"in float64: kernel path loss {kl:.2e}, stats {ks:.2e}, grads {kg:.2e}; "
              f"plain path loss {pl:.2e}, stats {ps:.2e}, grads {pg:.2e} (loss and "
              f"stats tol {EXACT_TOL:.0e}; grads printed)")
        if not max(kl, ks) <= EXACT_TOL:
            raise AssertionError("the classifier's exact-BN kernel step's loss or "
                                 "running statistics are off float64")
        exact[eps] = (kl, kg, ks, pl, pg, ps)
    return dict(frozen=(l, g, st), exact=exact)


def bmp_bytes(rgb, bpp, top_down) -> bytes:
    """A BMP of (H, W, 3) RGB: 24-bit, 32-bit (BI_RGB, alpha 255), or 8-bit
    with a palette of the image's own colours (at most 256)."""
    import struct
    h, w = rgb.shape[:2]
    table = b""
    if bpp == 8:
        colours, index = np.unique(rgb.reshape(-1, 3), axis=0, return_inverse=True)
        if len(colours) > 256:
            raise ValueError("more than 256 colours for an 8-bit BMP")
        pixels = index.reshape(h, w).astype(np.uint8)
        table = np.concatenate([colours[:, ::-1], np.zeros((len(colours), 1), np.uint8)],
                               axis=1).astype(np.uint8).tobytes()
    else:
        bgr = rgb[..., ::-1]
        if bpp == 32:
            bgr = np.concatenate([bgr, np.full((h, w, 1), 255, np.uint8)], axis=-1)
        pixels = bgr.reshape(h, -1)
    pitch = (w * bpp + 31) // 32 * 4
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, :pixels.shape[1]] = pixels
    body = (rows if top_down else rows[::-1]).tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, 0,
                       len(body), 2835, 2835, len(table) // 4, 0)
    offset = 14 + len(info) + len(table)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info
            + table + body)


def jpeg_fixtures():
    """[(path, rgb, gray)] of the committed JPEG fixtures: what cv2.imread
    gives for each, recorded where cv2 is."""
    import glob
    here = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(here, JPEG_FIXTURES, "*.jpg")))
    if len(paths) < 12:
        raise AssertionError(f"{len(paths)} JPEG fixtures under {JPEG_FIXTURES}")
    return [(p, np.load(p[:-4] + ".rgb.npy"), np.load(p[:-4] + ".gray.npy"))
            for p in paths]


def write_class_folders(root, fixtures):
    """CLS_CLASSES class folders of CLS_PER_CLASS images: PNG of every
    colour type, BMP at 8, 24 and 32 bits bottom-up and top-down, and the
    JPEG fixtures in turn; returns [(path, what, expected RGB)]."""
    import shutil
    rng = np.random.default_rng(8)
    h, w = CLS_IMAGE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    files = []
    for c in range(CLS_CLASSES):
        folder = os.path.join(root, f"class_{c}")
        os.makedirs(folder)
        for i in range(CLS_PER_CLASS):
            stem = os.path.join(folder, f"{i:03d}")
            k = i % 3
            if k == 2:                          # a JPEG fixture, copied
                src, want, _ = fixtures[(c * CLS_PER_CLASS + i) % len(fixtures)]
                shutil.copyfile(src, stem + ".jpg")
                files.append((stem + ".jpg", "jpeg", want))
                continue
            # a smooth pattern whose frequency depends on the class
            base = np.stack([np.sin(xx * (c + 1) / 17), np.cos(yy * (c + 1) / 13),
                             np.sin((xx + yy) / 23)], -1) * 90 + 128
            img = np.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
            if k == 0:
                kind = IMAGE_KINDS[i % len(IMAGE_KINDS)]
                data, want = encode_image(img, kind, rng)
                path, what = stem + ".png", f"png {kind}"
            else:
                bpp = (8, 24, 32)[(i // 3) % 3]
                if bpp == 8:
                    img = (img // 64 * 64 + 32).astype(np.uint8)   # 64 colours
                top_down = bool((i // 9) % 2)
                data, want = bmp_bytes(img, bpp, top_down), img
                path, what = stem + ".bmp", f"bmp {bpp}-bit{' top-down' if top_down else ''}"
            with open(path, "wb") as f:
                f.write(data)
            files.append((path, what, want))
    return files


def check_class_files(files, fixtures, card):
    """Every written file and every fixture (colour and gray) read back as
    it must; the JPEG reader's MB/s of decoded pixels over the fixtures."""
    from vit_unet_tpu_torch.data import image_io
    for path, what, want in files:
        got = image_io.imread_rgb(path)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{path} ({what}) did not read back as expected")
    for path, rgb, gray in fixtures:
        for got, want in ((image_io.imread_rgb(path), rgb),
                          (image_io.imread_gray(path), gray)):
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{path} does not read back as cv2.imread reads it")
    passes = 20
    t0 = time.perf_counter()
    decoded = 0
    for _ in range(passes):
        for path, _, _ in fixtures:
            decoded += image_io.imread_rgb(path).nbytes
    wall = time.perf_counter() - t0
    kinds = collections.Counter(what.split()[0] for _, what, _ in files)
    print(f"  (c) wrote {len(files)} images ({dict(kinds)}), all read back exactly; "
          f"{len(fixtures)} JPEG fixtures read back as cv2.imread reads them (RGB and "
          f"gray, bit for bit); JPEG reader {wall / (passes * len(fixtures)) * 1e3:.3f} "
          f"ms per fixture, {decoded / wall / 1e6:.1f} MB/s of decoded pixels, one "
          f"thread [{card}]")
    return decoded / wall / 1e6


def run_cls_cli(root, extra, probe):
    """``run_classification.main`` in this process on ``root``, its
    ``Fitter`` probed; returns (result, seconds)."""
    from vit_unet_tpu_torch.cli import run_classification
    from vit_unet_tpu_torch.train import fitter as fitter_mod

    class Probed(fitter_mod.Fitter):
        def fit(self, *a, callbacks=(), **kw):
            self.init_state()
            probe.wrap(self)
            return super().fit(*a, callbacks=[probe, *callbacks], **kw)

    ck = os.path.join(root, "models_cls")
    log = os.path.join(root, "log_cls.jsonl")
    argv = ["--input_folder", os.path.join(root, "classes"), "--checkpoint_dir", ck,
            "--log_jsonl", log, *extra]
    t0 = time.perf_counter()
    with mock.patch.object(fitter_mod, "Fitter", Probed):
        result = run_classification.main(argv)
    seconds = time.perf_counter() - t0
    if not all(math.isfinite(float(v)) for v in result.values()):
        raise AssertionError(f"classification: result not finite: {result}")
    if not os.path.isfile(os.path.join(ck, "best-checkpoint.pt")):
        raise AssertionError("classification: no best checkpoint written")
    return result, seconds


def cls_cli(routes):
    """(c) the CLI on class folders written here, 2 epochs, launches by
    route per epoch, img/s over steps 2-4 and the idle share."""
    import tempfile
    card = card_line()
    n = CLS_CLASSES * CLS_PER_CLASS
    n_val = max(1, int(n * 0.2))
    steps, val_batches = (n - n_val) // CLI_BATCH, -(-n_val // CLI_BATCH)
    fixtures = jpeg_fixtures()
    launches = collections.Counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_") as root:
        files = write_class_folders(os.path.join(root, "classes"), fixtures)
        mbps = check_class_files(files, fixtures, card)
        probe = CliProbe(steps, profiled=True)
        result, secs = run_cls_cli(root, ["--im_size", "224", "--dtype", "bfloat16",
                                          "--flash", "--batch_size", str(CLI_BATCH),
                                          "--n_epochs", "2"], probe)
        final = all_launches()
    want = {**cls_expected({"bn_fwd": routes["bn_fwd"], "bwd": routes["bwd"]}, steps),
            **cls_expected({"eval": routes["eval"]}, val_batches)}
    for epoch in (0, 1):
        got = probe.launches[epoch]
        require_launches(f"(c) epoch {epoch}", got, want)
        launches.update(got)
        wall, busy = probe.busy[epoch]
        print(f"  (c) epoch {epoch}, steps 2-{steps} of {CLI_BATCH} images (PNG, BMP, "
              f"JPEG; resize, ShiftScaleRotate, 2 loader threads), profiled: "
              f"{probe.rates[epoch]:.1f} img/s, wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms, idle {1 - busy / wall:.1%} [{card}]")
    require_launches("(c) final evaluation", final,
                     cls_expected({"eval": routes["eval"]}, val_batches))
    launches.update(final)
    print(f"  (c) run_classification: {result} in {secs:.1f} s")
    return launches, dict(rates=probe.rates, busy=probe.busy, mbps=mbps, secs=secs)


def phase_classifier():
    print("== phase 8: ViTClassifier (16 heads) and run_classification")
    t_phase = time.perf_counter()
    routes = cls_routes()
    print(f"  (a0) kernels 1-4 at the classifier's levels, B{BATCH}, rate {RATE}:")
    kernels = cls_kernels()
    model_launches, model_t = cls_model_runs(routes)
    paths = cls_compare_paths()
    cli_launches, cli_t = cls_cli(routes)
    print(f"  phase 8: {time.perf_counter() - t_phase:.1f} s")
    return dict(kernels=kernels, model=model_launches, cli=cli_launches,
                model_t=model_t, cli_t=cli_t, paths=paths)


# --- phase 9: multi-GPU ------------------------------------------------------------

# base's widths at 512² (the long-context geometry of
# examples/train_sp_longcontext.py): levels N 256 (dh 384) x3, 1024 (dh 96)
# x5 and 4096 (dh 24) x4; the two longer ones split over two ranks
SP_MODEL = dict(im_size=512, attn_drop=0.0, proj_drop=0.0, sp_min_tokens=1024)
SP_BATCH = 8
SP_CALLS = 12                # re-attention calls a forward or step
SP_SHARD_SHAPES = [(SP_BATCH, 8, 96, 512, 1024), (SP_BATCH, 8, 24, 2048, 4096)]
# At random initialisation the exact-BN step's f32 and bf16 gradients are
# set by rounding: the head mix's batch variance is tiny beside its mean, so
# its layers cancel large terms, and the single process's own step with
# only the batch in another order (BATCH_ORDERS: the same function) moves
# them by more than the largest gradient (PERF.md section 7).  No bound at
# those precisions tells a fault from that, so the split steps' gradients
# are printed beside that spread, and held instead (c2, d2) in float64,
# where split and unsplit steps agree to F64_TOL, and (c3) through the
# kernels at the function level, on inputs whose maps are peaked, against
# float64 at GRAD_TOL, where faults planted in the cross-rank sums must
# fail.  (d1) holds the data-parallel step's all-reduce and update exactly.
SP_EXACT_BATCH = 2           # the float64 exact-BN step
F64 = dict(flash_train=False, attn_bn_eps=EXACT_EPS, dtype="float64",
           param_dtype="float64")
F64_TOL = 1e-8
BATCH_ORDERS = ("roll", "flip")
DP_F64_BATCH = 8             # the float64 data-parallel step, b4 a rank
SP_FN_SHAPES = [(2, 8, 96, 1024), (1, 8, 24, 4096)]   # (B, H, dh, N): N/2 rows a rank
SP_TIMED_STEPS = 3
# data parallelism: bf16 compute on float32 parameters, so that the first
# AdamW update shows in every parameter and is held against its formula
DP_MODEL = dict(attn_drop=0.0, proj_drop=0.0, dtype="bfloat16", param_dtype="float32")
DP_F64 = dict(attn_drop=0.0, proj_drop=0.0, flash_train=False, dtype="float64",
              param_dtype="float64")
LR = 1e-4
WORLD = 2
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")


def sync_free_dropout():
    """The plain train paths of ReAttention (base's (8, 96) level, N 196) and
    KerasMHA (HViTUNetTF's (8, 192) level, N 256) at b8 with dropout 0.2:
    forward and backward with any host synchronisation an error; the mask
    drawn from the seed tensor equals the int seed's bit for bit."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    from vit_unet_tpu_torch.nn.mha import KerasMHA
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    torch.manual_seed(0)
    ra = ReAttention(768, num_heads=8, attn_drop=RATE, flash_train=False).cuda()
    mha = KerasMHA(192, 8, key_dim=192, dropout=RATE, use_flash=False).cuda()
    x_ra = torch.randn(SP_BATCH, 196, 768, device="cuda")
    x_mha = torch.randn(SP_BATCH, 256, 192, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    seed = torch.tensor([2 ** 40 + 9], dtype=torch.int64, device="cuda")
    want = T.dropout_mask(2 ** 40 + 9, RATE, SP_BATCH, 8, 196, 196, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = T.dropout_mask(seed, RATE, SP_BATCH, 8, 196, 196)
        ra(x_ra, deterministic=False, use_running_average=False,
           generator=gen).square().sum().backward()
        mha(x_mha, x_mha, deterministic=False, generator=gen).square().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.equal(got, want):
        raise AssertionError("the seed tensor's dropout mask differs from the int seed's")
    print(f"  (a) plain train paths (ReAttention (8, 96) N 196, KerasMHA (8, 192) "
          f"N 256, b{SP_BATCH}, rate {RATE}) forward and backward under "
          f"set_sync_debug_mode('error'): no host synchronisation; the mask "
          f"from the seed tensor equals the int seed's ({want.numel()} entries)")


def sp_shard_kernels():
    """Kernels 1-4 at the shard shapes (each rank's query rows against every
    key) in bf16, rate 0.2 for the training kernels, against their plain
    versions, timed with their bounds, each on the route its function names."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    rows = {}
    for batch, heads, dh, n_q, n_k in SP_SHARD_SHAPES:
        shape = f"B{batch} H{heads} dh{dh} Nq{n_q} Nk{n_k}"
        k1 = check_kernel(batch, heads, dh, n_q, n_k, torch.bfloat16, reps=10,
                          label="shard")
        tk = check_train_kernels(batch, heads, dh, n_q, n_k, torch.bfloat16, RATE,
                                 reps=10)
        bounds = train_bounds(batch, heads, dh, n_q, n_k, torch.bfloat16)
        row = {"flash_reattention": dict(
            max_abs_err=k1["err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
            bound_ms=bound_of(k1["t_bytes"], k1["t_ops"])[0], route=k1["route"])}
        for key in ("fwd", "bn_fwd", "bwd"):
            pick = {"fwd": T.train_fwd_route, "bn_fwd": T.bn_fwd_route,
                    "bwd": T.train_bwd_route}[key]
            row[key] = dict(max_abs_err=tk[key]["err"], ms=tk[key]["ms"],
                            plain_ms=tk[key]["plain_ms"],
                            bound_ms=bound_of(*bounds[key])[0],
                            route=pick(torch.bfloat16, heads, dh))
            print(f"    {key} [{row[key]['route']}]: kernel {row[key]['ms']:.4f} ms, "
                  f"plain {row[key]['plain_ms']:.4f} ms, bound "
                  f"{row[key]['bound_ms']:.4f} ms")
        square = square_call_ms(batch, heads, dh, n_k)
        for key, ms in square.items():
            row[key]["square_ms"] = ms
        print(f"    the square call at N {n_k} (kernels only): "
              + ", ".join(f"{key} {ms:.4f} ms" for key, ms in square.items()))
        rows[shape] = row
    return rows


def square_call_ms(batch, heads, dh, n, reps=10) -> dict:
    """Each kernel's time at the unsplit call, Nq = Nk = n, for the shard
    calls beside it."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    from vit_unet_tpu_torch.kernels.flash_reattention import flash_reattention
    args = reattention_inputs(batch, heads, dh, n, n, torch.bfloat16, 0)
    q, k, v, m_eff, c_eff, g_out, seed = train_inputs(batch, heads, dh, n, n,
                                                      torch.bfloat16)
    vsum = v.float().sum(1)
    lse = T.train_fwd(q, k, v, vsum, m_eff, c_eff, seed, RATE)[1]
    d = torch.randn(batch, heads, n, device="cuda")
    return {"flash_reattention": time_ms(lambda: flash_reattention(*args, num_heads=heads), reps),
            "fwd": time_ms(lambda: T.train_fwd(q, k, v, vsum, m_eff, c_eff, seed, RATE), reps),
            "bn_fwd": time_ms(lambda: T.bn_fwd(q, k, v, seed, RATE), reps),
            "bwd": time_ms(lambda: T.train_bwd(q, k, v, lse, g_out, m_eff, d, seed, RATE),
                           reps)}


def sp_model(mesh=None, **overrides):
    from vit_unet_tpu_torch import get_vit_unet
    return get_vit_unet("base", mesh, device="cuda", seed=0,
                        **{**SP_MODEL, **overrides})


def image_batch(n, side, seed=3):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, 3, side, side, generator=gen, device="cuda")
    return {"x": x, "y": 0.9 * x}


def reorder(batch, how):
    """The batch in another order, rolled by one or reversed: the same
    step, since the loss and the batch statistics take every sample alike."""
    idx = torch.arange(next(iter(batch.values())).shape[0], device="cuda")
    idx = idx.roll(1) if how == "roll" else idx.flip(0)
    return {k: v[idx] for k, v in batch.items()}


def one_step(model, batch, mesh=None, bn_frozen=False, zero=False, plant=None):
    """One AdamW step at LR: (metrics, steps, state, seen).  ``seen`` holds
    the parameters before the step (``before``) and the gradients the
    optimizer stepped with (``grads``: after the average over ranks).
    ``plant``: a fault, a function of the step's optimizer returning the
    context that plants it for the step."""
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse
    model.train()
    steps = build_step_functions(model, adamw(model, LR), mse, mesh=mesh,
                                 bn_frozen=bn_frozen, zero_sharding=zero)
    state = TrainState.create(model=model, optimizer=steps.optimizer, seed=7)
    params = list(model.parameters())
    seen = dict(before=[p.detach().clone() for p in params])
    opt_step = steps.optimizer.step

    def step(*args, **kwargs):
        seen["grads"] = [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                         for p in params]
        return opt_step(*args, **kwargs)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(steps.optimizer, "step", step))
        if plant is not None:
            stack.enter_context(plant(steps.optimizer))
        state, m = steps.train_step(state, batch)
    return m, steps, state, seen


def whole_grads(model, grads, mesh) -> list:
    """``grads`` (one a parameter, in ``parameters()`` order) with the
    blocks of the parameters the step split over ``mesh``'s model axis
    gathered whole."""
    from vit_unet_tpu_torch.parallel.partition import gather_tensor, placements
    split = placements(model)
    return [gather_tensor(g, mesh, split[n]) if n in split else g
            for (n, _), g in zip(model.named_parameters(), grads)]


def step_record(model, m, seen, mesh=None) -> dict:
    """Loss, each parameter's gradient (float32, or float64 for float64;
    whole, where ``mesh`` split it) and the running statistics, on the
    host."""
    wide = lambda t: t.double() if t.dtype == torch.float64 else t.float()
    grads = seen["grads"] if mesh is None else whole_grads(model, seen["grads"], mesh)
    return dict(
        loss=m["loss"].item(),
        grads=[wide(g).cpu() for g in grads],
        stats=torch.cat([b.double().flatten() for n, b in model.named_buffers()
                         if "running" in n]).cpu())


def rel_to_largest(a, b) -> float:
    return (a - b).abs().max().item() / b.abs().max().item()


def leaf_rel(a, b) -> float:
    """The largest |a - b| over tensor lists, relative to the largest |b|."""
    return (max((x - y).abs().max().item() for x, y in zip(a, b))
            / max(y.abs().max().item() for y in b))


def order_spread(make, batch, grads, loss) -> tuple:
    """The single process's own spread: the largest change, over steps of a
    fresh model from ``make`` on the batch in the BATCH_ORDERS, from
    ``grads`` (the step on the batch as it is), relative to the largest of
    ``grads``, and from its ``loss``, relative."""
    ref = [g.float() for g in grads]
    spread = loss_spread = 0.0
    for how in BATCH_ORDERS:
        m, _, _, seen = one_step(make(), reorder(batch, how))
        spread = max(spread, leaf_rel([g.float() for g in seen["grads"]], ref))
        loss_spread = max(loss_spread, abs(m["loss"].item() - loss) / abs(loss))
    return spread, loss_spread


def all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def adamw_update_margin(before, after, grads, wd=1e-4, eps=1e-8) -> float:
    """The largest ratio, over every float32 parameter, of its distance
    from AdamW's first update to the tolerance.  The first update from p
    with gradient g is p (1 - LR wd) - LR g / (|g| + eps) (the moments
    (1 - b1) g and (1 - b2) g^2 after their bias corrections), computed in
    float64; the tolerance is 1e-3 LR plus two float32 roundings of p.  A
    parameter that kept its value or moved the wrong way is off by about
    LR, a thousand times the tolerance."""
    worst = 0.0
    for p0, p1, g in zip(before, after, grads):
        p0, p1, g = p0.double(), p1.detach().double(), g.double()
        want = p0 * (1 - LR * wd) - LR * g / (g.abs() + eps)
        tol = 1e-3 * LR + 2 * torch.finfo(torch.float32).eps * p0.abs()
        worst = max(worst, ((p1 - want).abs() / tol).max().item())
    return worst


class BucketSpy:
    """The train step's flatten of a gradient bucket, watched: each bucket
    is kept as it was before the all-reduce, beside the bucket itself,
    which the step then sums over the ranks and divides in place."""

    def __init__(self, flatten):
        self.flatten, self.buckets = flatten, []

    def __call__(self, tensors):
        flat = self.flatten(tensors)
        self.buckets.append((flat.clone(), flat))
        return flat


def allreduce_margin(spy, world) -> float:
    """The largest ratio, over the gradient buckets of the step ``spy``
    watched, of |world sum(w after) - sum over ranks of sum(w before)| to
    its rounding bound (two roundings of the bucket's dtype on each rank's
    sum |w before|), w a fixed random weight per entry: each rank's
    averaged bucket must be the mean of every rank's own."""
    import torch.distributed as dist
    if not spy.buckets:
        return math.inf
    pre, post, tol = [], [], []
    for i, (before, after) in enumerate(spy.buckets):
        gen = torch.Generator(device="cuda").manual_seed(11 + i)
        w = torch.randn(before.numel(), generator=gen, device="cuda", dtype=torch.float64)
        pre.append((w * before.double()).sum())
        post.append((w * after.double()).sum())
        tol.append(2 * torch.finfo(before.dtype).eps * (w * before.double()).abs().sum())
    sums = torch.stack(pre + tol)
    if world > 1:
        dist.all_reduce(sums)
    n = len(pre)
    return ((world * torch.stack(post) - sums[:n]).abs() / sums[n:]).max().item()


def parallel_references(path):
    """The single-process results the world of two is held against, on this
    card: base at 512² bf16 b8 (eval forward, exact- and frozen-BN steps,
    the exact step's spread over other batch orders), the b2 exact-BN step
    (eps 1e-3) in float64, and base at 224²: b64 in DP_MODEL (one exact-BN
    step and its spread) and b8 in float64.  Returns the spreads."""
    from vit_unet_tpu_torch import get_vit_unet
    refs = {}
    batch = image_batch(SP_BATCH, 512)
    model = sp_model(**BF16)
    with torch.no_grad():
        refs["eval"] = model(batch["x"]).float().cpu()
    m, _, _, seen = one_step(model, batch)
    refs["exact"] = step_record(model, m, seen)
    refs["exact"]["spread"], refs["exact"]["loss_spread"] = order_spread(
        lambda: sp_model(**BF16), batch, seen["grads"], refs["exact"]["loss"])
    model = sp_model(**BF16)
    m, _, _, seen = one_step(model, batch, bn_frozen=True)
    refs["frozen"] = step_record(model, m, seen)
    small = image_batch(SP_EXACT_BATCH, 512, seed=4)
    model = sp_model(**F64)
    m, _, _, seen = one_step(model, {k: v.double() for k, v in small.items()})
    refs["exact_f64"] = step_record(model, m, seen)
    dp_batch = image_batch(BATCH, 224, seed=6)
    make_dp = lambda: get_vit_unet("base", device="cuda", seed=0, **DP_MODEL)
    model = make_dp()
    m, _, _, seen = one_step(model, dp_batch)
    refs["dp"] = step_record(model, m, seen)
    refs["dp"]["spread"], refs["dp"]["loss_spread"] = order_spread(
        make_dp, dp_batch, seen["grads"], refs["dp"]["loss"])
    model = get_vit_unet("base", device="cuda", seed=0, **DP_F64)
    f64_batch = {k: v.double() for k, v in image_batch(DP_F64_BATCH, 224, seed=9).items()}
    m, _, _, seen = one_step(model, f64_batch)
    refs["dp_f64"] = step_record(model, m, seen)
    del model, seen
    torch.save(refs, os.path.join(path, "refs.pt"))
    torch.cuda.empty_cache()
    return {key: refs[key]["spread"] for key in ("exact", "dp")}


class CollectiveClock:
    """``torch.distributed`` as ``parallel/sequence.py`` calls it, with the
    host time of each collective summed (the card synchronised around it)."""

    TIMED = ("all_gather", "all_reduce", "reduce_scatter")

    def __init__(self, real):
        self.real, self.ms = real, 0.0

    def __getattr__(self, name):
        fn = getattr(self.real, name)
        if name not in self.TIMED:
            return fn

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1e3
            return out
        return timed


class PlantedShards:
    """A fault planted in the exact-BN functions' cross-rank sums: the
    all-reduce calls numbered in ``skip`` (0: the forward's moments, 1: the
    backward's statistics terms) return the rank's own part, and
    ``row_shards`` may be a wrong count."""

    def __init__(self, real, skip=(), row_shards=None):
        self.real, self.skip, self.calls = real, skip, 0
        self.size = real.size
        self.row_shards = real.row_shards if row_shards is None else row_shards

    def all_reduce(self, t):
        call, self.calls = self.calls, self.calls + 1
        return t if call in self.skip else self.real.all_reduce(t)


PLANTED_SHARDS = {"the backward's statistics terms not summed": dict(skip=(1,)),
                  "the forward's moments not summed": dict(skip=(0,)),
                  "row_shards 1 for 2": dict(row_shards=1)}
FN_OUTPUTS = ("out", "mean", "var", "dq", "dk", "dv", "dW", "dcb", "dgamma", "dbeta")


def exact_fn_inputs(batch, heads, dh, n, dtype):
    """Inputs of the exact-BN function at N tokens (``train_inputs``: the
    maps are peaked, so the batch variance of the head mix stays far above
    the BatchNorm epsilon), its BatchNorm parameters and the output's
    cotangent."""
    q, k, v_cat, _, _, g_out, _ = train_inputs(batch, heads, dh, n, n, dtype)
    gen = torch.Generator().manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=gen).cuda()
    return (q, k, v_cat, rnd(heads, heads) * 0.4, rnd(heads) * 0.2,
            1 + 0.3 * rnd(heads), rnd(heads) * 0.2, g_out)


def exact_fn_run(inputs, mesh=None, plant=None, reference=False):
    """The exact-BN function's output, moments and gradients (FN_OUTPUTS)
    under a loss on the output and both moments: split over ``mesh``'s
    model line through ``sequence_parallel_reattention_train`` on the
    kernels (``plant``: a PlantedShards fault), unsplit on the kernels
    (no mesh), or the unsplit N x N version in float64 (``reference``)."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    from vit_unet_tpu_torch.parallel import sequence as PS
    q, k, v_cat, cm, cb, ga, be, g_out = inputs
    b, h, n, dh = q.shape
    if reference:
        leaves = [t.detach().double().requires_grad_() for t in inputs[:7]]
        out, (mu, var) = T.reattention_nxn(*leaves[:5], None, norm=leaves[5:])
    elif mesh is None:
        leaves = [t.detach().clone().requires_grad_() for t in inputs[:7]]
        out, mu, var = T.flash_reattention_train_bn(*leaves, num_heads=h)
    else:
        v = v_cat.view(b, n, h, dh).transpose(1, 2).contiguous()
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, cm, cb, ga, be)]
        shards = mesh.shards
        with (mock.patch.object(mesh, "shards", lambda axes: PlantedShards(
                shards(axes), **plant)) if plant else contextlib.nullcontext()):
            out, mu, var = PS.sequence_parallel_reattention_train(
                *leaves, mesh, use_flash=True, data_axis=None)
    loss = (out * g_out.to(out.dtype)).sum() + mu.sum() + var.sum()
    grads = list(torch.autograd.grad(loss, leaves))
    if grads[2].ndim == 4:
        grads[2] = grads[2].transpose(1, 2).reshape(b, n, h * dh)
    return [out, mu, var, *grads]


def fn_worst(got, want) -> tuple:
    rels = [rel_err(a, b)[1] for a, b in zip(got, want)]
    i = max(range(len(rels)), key=lambda j: rels[j])
    return rels[i], FN_OUTPUTS[i]


def sp_exact_functions(mesh, say) -> dict:
    """(c3) The exact-BN function split over the two ranks' rows on the
    kernels (each rank N/2 query rows against the N gathered keys), f32 and
    bf16 at SP_FN_SHAPES, against the unsplit N x N version in float64,
    every output and gradient at GRAD_TOL of its largest entry, as phase
    2b holds the unsplit call (whose error is printed beside it).  Then
    each PLANTED_SHARDS fault, in f32 at the first shape, must fail."""
    held, planted = {}, {}
    for batch, heads, dh, n in SP_FN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = exact_fn_inputs(batch, heads, dh, n, dtype)
            want = exact_fn_run(inputs, reference=True)
            split = fn_worst(exact_fn_run(inputs, mesh), want)
            alone = fn_worst(exact_fn_run(inputs), want)
            label = f"B{batch} H{heads} dh{dh} Nq{n // 2} Nk{n} {str(dtype)[6:]}"
            held[label] = dict(split=split[0], unsplit=alone[0])
            say(f"  (c3) exact-BN function split over 2 ranks, {label}: worst "
                f"{split[1]} rel {split[0]:.2e} against float64 (tol "
                f"{GRAD_TOL[dtype]:.0e}); the unsplit call's {alone[0]:.2e}")
            if not split[0] <= GRAD_TOL[dtype]:
                raise AssertionError(f"the split exact-BN function disagrees at {label}")
            if dtype == torch.float32 and not planted:
                for name, plant in PLANTED_SHARDS.items():
                    rel, at = fn_worst(exact_fn_run(inputs, mesh, plant), want)
                    planted[name] = rel
                    say(f"  (c3) planted fault, {name}: worst {at} rel {rel:.2e} "
                        f"(must fail the {GRAD_TOL[dtype]:.0e} check)")
                    if rel <= GRAD_TOL[dtype]:
                        raise AssertionError(f"the check cannot see a planted fault: {name}")
            del inputs, want
    torch.cuda.empty_cache()
    return dict(held=held, planted=planted)


PLANTED_DP = {
    # the gradients' (and the moments') all-reduce does nothing
    "no all-reduce": ("reduce", lambda opt: mock.patch(
        "torch.distributed.all_reduce", lambda *a, **k: None)),
    # ZeRO-1 does not send the shard a rank updated
    "no broadcast": ("update", lambda opt: mock.patch.object(opt, "_sync_params", lambda: None)),
    # the local optimizer step does nothing
    "no update": ("update", lambda opt: mock.patch.object(opt, "_local_step",
                                                          lambda *a, **k: None)),
}


def dp_step(dev, mesh, batch, plant=None) -> dict:
    """One DP + ZeRO-1 step of base 224² (DP_MODEL) on ``mesh`` with its
    gradient buckets watched: the metrics, the step's optimizer, the
    launches, the gradients stepped with, and the all-reduce and update
    margins (each <= 1 when right)."""
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.parallel import train_step as TS
    model = get_vit_unet("base", device=dev, seed=0, **DP_MODEL)
    spy = BucketSpy(TS._flatten_dense_tensors)
    zero_launches()
    with mock.patch.object(TS, "_flatten_dense_tensors", spy):
        m, steps, _, seen = one_step(model, batch, mesh, zero=True, plant=plant)
    torch.cuda.synchronize()
    return dict(metrics=m, optimizer=steps.optimizer, launches=all_launches(),
                model=model, seen=seen, reduce=allreduce_margin(spy, mesh.size),
                update=adamw_update_margin(seen["before"], model.parameters(),
                                           seen["grads"]))


def parallel_worker(rank, world, port, root) -> int:
    """One rank of phase 9's world (both on this card, over gloo): the
    sequence-parallel model on 1 x 2 and the data-parallel ZeRO-1 step on
    2 x 1, each held against the references; writes rank<r>.json."""
    from vit_unet_tpu_torch.parallel import mesh as PM
    from vit_unet_tpu_torch.parallel import partition as PP
    from vit_unet_tpu_torch.parallel import sequence as PS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    dev = PM.initialize_distributed(f"localhost:{port}", world, rank, device="cuda")
    import torch.distributed as dist
    out["backend"] = dist.get_backend()
    refs = torch.load(os.path.join(root, "refs.pt"), weights_only=False)
    sp = PM.create_mesh(2, device=dev)
    lead = rank == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"  (c) world of {world} on {torch.cuda.get_device_name(dev)}, backend "
        f"{out['backend']}; sequence-parallel mesh {sp.shape}")

    # (c1) base at 512² bf16 b8 split over model: eval, exact and frozen steps
    batch = image_batch(SP_BATCH, 512)
    model = sp_model(sp, sequence_parallel=True, **BF16)
    zero_launches()
    with torch.no_grad():
        ev = model(batch["x"]).float().cpu()
    torch.cuda.synchronize()
    launches = {"eval": all_launches()}
    rel = rel_to_largest(ev, refs["eval"])
    say(f"  (c1) eval forward b{SP_BATCH} against the single process: rel {rel:.2e} "
        f"(tol {MODEL_TOL_BF16:.0e})")
    if not rel <= MODEL_TOL_BF16:
        raise AssertionError(f"sequence-parallel eval forward off by {rel:.2e}")
    held = {}
    for mode, frozen in (("exact", False), ("frozen", True)):
        model = sp_model(sp, sequence_parallel=True, **BF16)
        zero_launches()
        m, steps, state, seen = one_step(model, batch, sp, bn_frozen=frozen)
        torch.cuda.synchronize()
        launches[mode] = all_launches()
        got, want = step_record(model, m, seen, sp), refs[mode]
        lrel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        grel = leaf_rel(got["grads"], want["grads"])
        srel = rel_to_largest(got["stats"], want["stats"])
        if frozen:
            gok = grel <= GRAD_TOL[torch.bfloat16] and lrel <= MODEL_TOL_BF16
            gline = (f"loss rel {lrel:.2e} (tol {MODEL_TOL_BF16:.0e}), grads rel "
                     f"{grel:.2e} of the largest (tol {GRAD_TOL[torch.bfloat16]:.0e})")
        else:
            # the exact step at init is set by rounding, and the split
            # FeedForward and proj round their sums otherwise than one GEMM
            gok = all_finite(got["grads"]) and math.isfinite(got["loss"])
            gline = (f"loss rel {lrel:.2e}, grads rel {grel:.2e} of the largest "
                     f"(finite; not bounded: the single process's own spread over "
                     f"{len(BATCH_ORDERS)} other batch orders is {want['loss_spread']:.2e} "
                     f"in the loss and {want['spread']:.2e} in the gradients; held in "
                     f"float64 in (c2) and on the kernels in (c3))")
        held[mode] = dict(grads=grel)
        say(f"  (c1) {mode}-BN step b{SP_BATCH} bf16 against the single process: "
            f"running stats rel {srel:.2e} (tol {MODEL_TOL_BF16:.0e}), {gline}")
        if not (srel <= MODEL_TOL_BF16 and gok):
            raise AssertionError(f"sequence-parallel {mode}-BN step disagrees")
        times = []
        for _ in range(SP_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steps.train_step(state, batch)
            m["loss"].item()
            times.append((time.perf_counter() - t0) * 1e3)
        clock = CollectiveClock(PS.dist)
        with mock.patch.object(PS, "dist", clock), mock.patch.object(PP, "dist", clock):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steps.train_step(state, batch)
            m["loss"].item()
            clocked = (time.perf_counter() - t0) * 1e3
        held[mode].update(loss=lrel, stats=srel,
                          step_ms=sorted(times)[len(times) // 2],
                          collective_ms=clock.ms, clocked_ms=clocked)
        say(f"  (c1) {mode}-BN step: median {held[mode]['step_ms']:.3f} ms of "
            f"{SP_TIMED_STEPS}; a step with each token and tensor-parallel "
            f"collective timed alone (card synchronised around it): {clocked:.3f} ms, "
            f"{clock.ms:.3f} ms of it in the collectives ({clock.ms / clocked:.1%})"
            f" [{card_line()}]")
        del model, steps, state, seen
    out["launches"] = launches
    out["sp"] = held

    # (c2) the b2 exact-BN step (eps 1e-3) in float64, split and unsplit
    small = image_batch(SP_EXACT_BATCH, 512, seed=4)
    model = sp_model(sp, sequence_parallel=True, **F64)
    m, _, _, seen = one_step(model, {k: v.double() for k, v in small.items()}, sp)
    got, ref = step_record(model, m, seen, sp), refs["exact_f64"]
    kl = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    kg, ks = leaf_rel(got["grads"], ref["grads"]), rel_to_largest(got["stats"], ref["stats"])
    say(f"  (c2) float64 b{SP_EXACT_BATCH} exact-BN (eps {EXACT_EPS:.0e}) step split "
        f"over 2 ranks against the single process: loss rel {kl:.2e}, running "
        f"stats rel {ks:.2e}, grads rel {kg:.2e} of the largest (tol {F64_TOL:.0e})")
    if not max(kl, ks, kg) <= F64_TOL:
        raise AssertionError("the float64 sequence-parallel exact-BN step disagrees")
    out["sp_exact_f64"] = dict(loss=kl, stats=ks, grads=kg)
    del model, seen
    torch.cuda.empty_cache()

    # (c3) the exact-BN function on the kernels at the shard shapes
    out["sp_functions"] = sp_exact_functions(sp, say)

    # (d) data parallelism + ZeRO-1: base 224² b64 as two ranks of 32
    dp = PM.create_mesh(1, device=dev)
    dp_batch = image_batch(BATCH, 224, seed=6)
    run = dp_step(dev, dp, dp_batch)
    launches["dp_zero"] = run["launches"]
    want = refs["dp"]
    lrel = abs(run["metrics"]["loss"].item() - want["loss"]) / abs(want["loss"])
    grads = [g.float().cpu() for g in run["seen"]["grads"]]
    grel = leaf_rel(grads, want["grads"])
    local = run["optimizer"].optim
    share = sum(t.numel() * t.element_size() for st in local.state.values()
                for t in st.values() if torch.is_tensor(t) and t.ndim > 0)
    total = 2 * sum(p.numel() * p.element_size() for p in run["model"].parameters())
    print(f"  (d) rank {rank}: DP + ZeRO-1 step b{BATCH} (b{BATCH // world} a rank), "
          f"bf16 on float32 parameters: loss rel {lrel:.2e} against the single "
          f"process (tol 1e-2); gradient all-reduce at {run['reduce']:.3f} of its "
          f"rounding bound; update at {run['update']:.3f} of its tolerance from "
          f"AdamW's first step on the averaged gradients; averaged gradients "
          f"finite, rel {grel:.2e} of the single process's largest (not bounded: "
          f"its own spread over other batch orders is {want['spread']:.2e}; held "
          f"in float64 in (d2)); optimizer state {share} bytes of the unsharded "
          f"{total} ({share / total:.1%})")
    if not (lrel <= 1e-2 and run["reduce"] <= 1.0 and run["update"] <= 1.0
            and all_finite(grads) and share < 0.6 * total):
        raise AssertionError("the data-parallel ZeRO-1 step disagrees")
    out["dp"] = dict(loss=lrel, reduce=run["reduce"], update=run["update"],
                     grads=grel, state_bytes=share, total_bytes=total)
    del run

    # (d2) the same split, with ZeRO-1, in float64 at b8 (b4 a rank)
    from vit_unet_tpu_torch import get_vit_unet
    model = get_vit_unet("base", device=dev, seed=0, **DP_F64)
    f64_batch = {k: v.double() for k, v in image_batch(DP_F64_BATCH, 224, seed=9).items()}
    m, _, _, seen = one_step(model, f64_batch, dp, zero=True)
    got, ref = step_record(model, m, seen), refs["dp_f64"]
    kl = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    kg, ks = leaf_rel(got["grads"], ref["grads"]), rel_to_largest(got["stats"], ref["stats"])
    say(f"  (d2) float64 b{DP_F64_BATCH} DP + ZeRO-1 exact-BN step (b{DP_F64_BATCH // world} "
        f"a rank) against the single process: loss rel {kl:.2e}, running stats rel "
        f"{ks:.2e}, averaged grads rel {kg:.2e} of the largest (tol {F64_TOL:.0e})")
    if not max(kl, ks, kg) <= F64_TOL:
        raise AssertionError("the float64 data-parallel step disagrees")
    out["dp_f64"] = dict(loss=kl, stats=ks, grads=kg)
    del model, seen
    planted = {}
    for name, (check, plant) in PLANTED_DP.items():
        margin = dp_step(dev, dp, dp_batch, plant)[check]
        planted[name] = margin
        say(f"  (d) planted fault, {name}: {check} margin {margin:.3e} (must exceed 1)")
        if not margin > 1.0:
            raise AssertionError(f"the data-parallel check cannot see a planted fault: {name}")
    out["dp"]["planted"] = planted
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def run_world(root, worker="--parallel-worker", phase="9") -> list:
    """The world of two, both ranks on card 0, started together (each
    ``chip_smoke.py <worker> ...``); each rank's results."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(WORLD), CUDA_VISIBLE_DEVICES=
               os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               worker, str(r), str(WORLD), str(port), root],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if r == 0 or p.returncode:
            print("\n".join(f"  [rank {r}] {line}" if p.returncode else line
                            for line in log.rstrip().splitlines()))
        if p.returncode:
            raise AssertionError(f"phase {phase} rank {r} failed (exit {p.returncode})")
    print("\n".join(line for line in logs[1].rstrip().splitlines()
                    if line.startswith("  (d) rank 1") or line.startswith("  (b) rank 1")))
    results = []
    for r in range(WORLD):
        with open(os.path.join(root, f"rank{r}.json")) as fh:
            results.append(json.load(fh))
    return results


def nccl_world_of_one():
    """NCCL at a world of one: a data-parallel step of base 224² b8
    (DP_MODEL) through the mesh.  Its gradient all-reduce must hand each
    bucket back unchanged, its update must be AdamW's first update from the
    gradients it stepped with, and its loss must equal the loss of the same
    step without a mesh (the backward's dq atomics leave the gradients
    themselves free to differ in their last bits)."""
    import socket
    import torch.distributed as dist
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.parallel import mesh as PM
    from vit_unet_tpu_torch.parallel import train_step as TS
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    PM.initialize_distributed(f"localhost:{port}", 1, 0, device="cuda", backend="nccl")
    try:
        mesh = PM.create_mesh(1)
        batch = image_batch(8, 224, seed=8)
        model = get_vit_unet("base", device="cuda", seed=0, **DP_MODEL)
        spy = BucketSpy(TS._flatten_dense_tensors)
        zero_launches()
        with mock.patch.object(TS, "_flatten_dense_tensors", spy):
            metrics, _, _, seen = one_step(model, batch, mesh)
        torch.cuda.synchronize()
        launches = all_launches()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    unchanged = bool(spy.buckets) and all(torch.equal(b, a) for b, a in spy.buckets)
    update = adamw_update_margin(seen["before"], model.parameters(), seen["grads"])
    lone = get_vit_unet("base", device="cuda", seed=0, **DP_MODEL)
    lone_loss = one_step(lone, batch)[0]["loss"].item()
    lrel = abs(metrics["loss"].item() - lone_loss) / abs(lone_loss)
    print(f"  (e) backend {backend}, world of 1: a data-parallel step of base 224² "
          f"b8, bf16 on float32 parameters: {len(spy.buckets)} gradient buckets "
          f"through the NCCL all-reduce, "
          f"{'each unchanged' if unchanged else 'CHANGED'}; update at {update:.3f} of "
          f"its tolerance from AdamW's first step; loss {metrics['loss'].item():.6f}, "
          f"rel {lrel:.2e} against the step without a mesh (tol 1e-5)")
    if backend != "nccl" or not (unchanged and update <= 1.0 and lrel <= 1e-5):
        raise AssertionError("the NCCL world of one disagrees")
    return launches


def phase_parallel():
    print("== phase 9: multi-GPU: sequence and data parallelism (a world of 2 on "
          "one card over gloo), NCCL at a world of 1")
    import tempfile
    t_phase = time.perf_counter()
    sync_free_dropout()
    print(f"  (b) kernels 1-4 at the sequence-parallel shard shapes, bf16, rate {RATE}:")
    shards = sp_shard_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as root:
        spread = parallel_references(root)
        print(f"  (c) references written; the single process's own gradient spread "
              f"over {len(BATCH_ORDERS)} other batch orders: "
              f"{spread['exact']:.2e} of the largest (512² b{SP_BATCH} bf16 exact BN), "
              f"{spread['dp']:.2e} (224² b{BATCH}, bf16 on float32 parameters)")
        t_world = time.perf_counter()
        ranks = run_world(root)
        world_s = time.perf_counter() - t_world
    for r in ranks:
        if r["backend"] != "gloo":
            raise AssertionError(f"the world of two ran on {r['backend']}")
    want = {"eval": {"eval": SP_CALLS, "eval_tensor_core": SP_CALLS},
            "exact": {"bn_fwd": SP_CALLS, "bn_fwd_tensor_core": SP_CALLS,
                      "bwd": SP_CALLS, "bwd_tensor_core": SP_CALLS},
            "frozen": {"fwd": SP_CALLS, "fwd_tensor_core": SP_CALLS,
                       "bwd": SP_CALLS, "bwd_tensor_core": SP_CALLS},
            "dp_zero": {"bn_fwd": 12, "bn_fwd_tensor_core": 12,
                        "bwd": 12, "bwd_tensor_core": 12}}
    launches = collections.Counter()
    for r, res in enumerate(ranks):
        for path, counts in res["launches"].items():
            require_launches(f"rank {r} {path}", counts, want[path])
            launches.update(counts)
    nccl = nccl_world_of_one()
    require_launches("(e) NCCL step", nccl, want["dp_zero"])
    launches.update(nccl)
    print(f"  the world of two: {world_s:.1f} s (start-up included); phase 9: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(shards=shards, launches=dict(launches), ranks=ranks, spread=spread)


# --- phase 10: tensor parallelism ----------------------------------------------

# HViTUNetTF's level-0 keras attention at model 2: a rank's 4 of the 8 heads
TP_HEADS = (4, 192, 256)
TP_BATCH = 4                  # the full-width TF model's step, float32
TP_TF = dict(drop_attn=0.0, drop_proj=0.0, drop_linear=0.0)
TP_BASE_BATCH = 2             # base 224² in float64, where the faults are planted
TP_CLIP = 0.5                 # the clip at this share of the reference's norm
TP_CLI_STEPS = 3
TP_KERNELS = {"tf_eval": ("eval",), "tf_step": ("fwd", "bwd"), "cli": ("fwd", "bwd")}


def tp_head_base():
    """Kernels 2 and 3 at a rank's block of heads (4 of 8, ``head_base`` 4,
    identity mix, rate 0.2, B8 N 256 dh 192): the forward equals the 8-head
    call's heads 4-7, the gradients equal that call's, f32 and bf16, so a
    rank draws its block of the whole layer's mask."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    batch, heads, dh, n, h = 8, 8, 192, 256, 4
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, eye, zero, g_out, seed = train_inputs(batch, heads, dh, n, n, dtype,
                                                       identity=True)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        full = T.flash_reattention_train(*leaves, eye, zero, seed, num_heads=heads,
                                         rate=RATE)
        grads = torch.autograd.grad((full.float() * g_out.float()).sum(), leaves)
        cut = lambda t: t.view(batch, n, heads, dh)[:, :, h:].reshape(batch, n, h * dh)
        part_in = [t.detach()[:, h:].contiguous().requires_grad_() for t in (q, k)]
        part_in.append(cut(v.detach()).contiguous().requires_grad_())
        part = T.flash_reattention_train(*part_in, eye[:h, :h], zero[:h], seed,
                                         num_heads=h, rate=RATE, head_base=h)
        pgrads = torch.autograd.grad((part.float() * cut(g_out).float()).sum(), part_in)
        errs = [rel_err(part, cut(full))[1],
                rel_err(pgrads[0], grads[0][:, h:])[1], rel_err(pgrads[1], grads[1][:, h:])[1],
                rel_err(pgrads[2], cut(grads[2]))[1]]
        name = str(dtype)[6:]
        worst[name] = max(errs)
        print(f"    {name}: heads 4-7 with head_base 4 against the 8-head call, rate "
              f"{RATE}: out rel {errs[0]:.2e}, dq/dk/dv rel {max(errs[1:]):.2e} "
              f"(tol {TRAIN_TOL[dtype]:.0e})")
        require(f"head_base {name}", worst[name], TRAIN_TOL[dtype])
    return worst


def tp_build(model, mesh=None, clip=None):
    """AdamW at LR with ``clip``, the steps built on ``mesh`` (which splits
    the model there): (steps, state)."""
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse
    steps = build_step_functions(model, adamw(model, LR), mse, mesh=mesh,
                                 clip_norm=clip)
    return steps, TrainState.create(model=model, optimizer=steps.optimizer, seed=7)


def tp_step(model, batch, mesh=None, clip=None, built=None):
    """One step of ``tp_build``'s (or ``built``'s) steps: (metrics, steps,
    state, the gradients the optimizer stepped with, after the average and
    the clip)."""
    steps, state = built or tp_build(model, mesh, clip)
    model.train()
    seen, opt_step = {}, steps.optimizer.step

    def step(*args, **kwargs):
        seen["grads"] = [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                         for p in model.parameters()]
        return opt_step(*args, **kwargs)
    with mock.patch.object(steps.optimizer, "step", step):
        state, m = steps.train_step(state, batch)
    return m, steps, state, seen


def grad_digest(grads, seed=21) -> tuple:
    """Per gradient (an iterable, one at a time), its dot with a fixed
    N(0, 1) tensor and its norm (float64): a whole gradient's fingerprint,
    whose error is about the error's L2 norm."""
    dots, norms = [], []
    for i, g in enumerate(grads):
        gen = torch.Generator(device=g.device).manual_seed(seed + i)
        w = torch.randn(g.shape, generator=gen, device=g.device, dtype=torch.float64)
        dots.append((w * g.double()).sum())
        norms.append(g.double().norm())
        del w
    return torch.stack(dots).cpu(), torch.stack(norms).cpu()


def tp_tf_batch() -> dict:
    x = tf_batch(TP_BATCH)
    return {"x": x, "y": 0.9 * x}


def tf_full_width(dev):
    from vit_unet_tpu_torch.models.hvit_unet_tf import get_hvit_unet_tf
    return get_hvit_unet_tf(device=dev, seed=0, **TF_CONFIG, **TP_TF)


def tp_references(path) -> dict:
    """The single process's results the world of two is held against:
    HViTUNetTF at its default width (128², f32, dropout 0) at b4, its eval
    forward and one AdamW step (loss, the gradients' digests and norms);
    base 224² in float64 at b2, the global gradient norm, then one clipped
    step at TP_CLIP of it (loss, clipped gradients)."""
    from vit_unet_tpu_torch import get_vit_unet
    refs = {}
    model = tf_full_width("cuda")
    refs["tf_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    refs["tf_params"] = sum(p.numel() for p in model.parameters())
    batch = tp_tf_batch()
    with torch.no_grad():
        refs["tf_eval"] = model(batch["x"], deterministic=True,
                                use_running_average=True).float().cpu()
    m, _, _, seen = tp_step(model, batch)
    refs["tf_loss"] = m["loss"].item()
    refs["tf_digest"], refs["tf_norms"] = grad_digest(seen["grads"])
    del model, seen
    torch.cuda.empty_cache()
    base = lambda: get_vit_unet("base", device="cuda", seed=0, **DP_F64)
    f64 = {k: v.double() for k, v in image_batch(TP_BASE_BATCH, 224, seed=12).items()}
    seen = tp_step(base(), f64)[3]
    norm = torch.sqrt(sum(g.square().sum() for g in seen["grads"])).item()
    refs["clip"] = TP_CLIP * norm
    m, _, _, seen = tp_step(base(), f64, clip=refs["clip"])
    refs["base_loss"] = m["loss"].item()
    refs["base_grads"] = [g.cpu() for g in seen["grads"]]
    torch.save(refs, os.path.join(path, "tp_refs.pt"))
    torch.cuda.empty_cache()
    return dict(norm=norm, clip=refs["clip"])


def _no_model_reduce(ctx, x, mesh):
    return x.contiguous().clone()


def planted_tp(PP, TS):
    """The three tensor-parallel faults, each a context."""
    avg, norm = TS.average_gradients, TS.global_grad_norm
    return {
        "fc2's all-reduce skipped": lambda: mock.patch.object(
            PP._ReduceFromModel, "forward", staticmethod(_no_model_reduce)),
        "a split gradient averaged over every rank": lambda: mock.patch.object(
            TS, "average_gradients", lambda rep, split, mesh: avg(rep + split, [], mesh)),
        "the clip norm taken locally": lambda: mock.patch.object(
            TS, "global_grad_norm", lambda rep, split, mesh: norm(rep, split, None)),
    }


def tp_worker(rank, world, port, root) -> int:
    """One rank of phase 10's world (both on this card, over gloo), on the
    1 x 2 mesh: HViTUNetTF at full width split by the rules, base 224² in
    float64 with the planted faults, and ``train_sp_longcontext``."""
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.cli import train_sp_longcontext
    from vit_unet_tpu_torch.parallel import mesh as PM
    from vit_unet_tpu_torch.parallel import partition as PP
    from vit_unet_tpu_torch.parallel import sequence as PS
    from vit_unet_tpu_torch.parallel import train_step as TS
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = PM.initialize_distributed(f"localhost:{port}", world, rank, device="cuda")
    refs = torch.load(os.path.join(root, "tp_refs.pt"), weights_only=False)
    mesh = PM.create_mesh(2, device=dev)
    lead = rank == 0
    say = print if lead else (lambda *a, **k: None)
    out = {"backend": dist.get_backend()}
    say(f"  (b) world of {world}, backend {out['backend']}, mesh {mesh.shape}")

    # (b) HViTUNetTF at full width, f32, split over model
    model = tf_full_width(dev)
    batch = tp_tf_batch()
    built = tp_build(model, mesh)           # splits the model
    zero_launches()
    with torch.no_grad():
        ev = model(batch["x"], deterministic=True, use_running_average=True).float().cpu()
    torch.cuda.synchronize()
    launches = {"tf_eval": all_launches()}
    erel = rel_to_largest(ev, refs["tf_eval"])
    zero_launches()
    m, steps, state, seen = tp_step(model, batch, built=built)
    torch.cuda.synchronize()
    launches["tf_step"] = all_launches()
    split = PP.placements(model)
    local = sum(p.numel() * p.element_size() for p in model.parameters())
    split_local = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                      if n in split)
    names = [n for n, _ in model.named_parameters()]
    digest, norms = grad_digest(
        PP.gather_tensor(g, mesh, split[n]) if n in split else g
        for n, g in zip(names, seen["grads"]))
    lrel = abs(m["loss"].item() - refs["tf_loss"]) / abs(refs["tf_loss"])
    grel = ((digest - refs["tf_digest"]).abs().max() / refs["tf_norms"].max()).item()
    # against the largest: some gradients are rounding alone (a key bias
    # shifts a score row, which the softmax undoes)
    nrel = ((norms - refs["tf_norms"]).abs().max() / refs["tf_norms"].max()).item()
    print(f"  (b) rank {rank}: HViTUNetTF f32 b{TP_BATCH}, {len(split)} tensors split: "
          f"parameters {local / 2**30:.3f} GiB of the whole {refs['tf_bytes'] / 2**30:.3f} "
          f"GiB ({local / refs['tf_bytes']:.1%}; the split tensors "
          f"{split_local / 2**30:.3f} GiB here)")
    say(f"  (b) against the single process: eval rel {erel:.2e}, loss rel {lrel:.2e}, "
        f"gradient digests and norms rel {grel:.2e} and {nrel:.2e} of the largest "
        f"norm (tol {MODEL_TOL:.0e})")
    if not (max(erel, lrel, grel, nrel) <= MODEL_TOL and local < 0.75 * refs["tf_bytes"]):
        raise AssertionError("the split HViTUNetTF disagrees or holds too much")
    times = []
    for _ in range(SP_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = steps.train_step(state, batch)
        m["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
    clock = CollectiveClock(PS.dist)
    with mock.patch.object(PS, "dist", clock), mock.patch.object(PP, "dist", clock), \
            mock.patch.object(TS, "dist", clock):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = steps.train_step(state, batch)
        m["loss"].item()
        clocked = (time.perf_counter() - t0) * 1e3
    step_ms = sorted(times)[len(times) // 2]
    say(f"  (b) step: median {step_ms:.3f} ms of {SP_TIMED_STEPS}; a step with each "
        f"collective timed alone (card synchronised around it): {clocked:.3f} ms, "
        f"{clock.ms:.3f} ms of it in the collectives ({clock.ms / clocked:.1%}) "
        f"[{card_line()}]")
    out["tf"] = dict(eval=erel, loss=lrel, digest=grel, norms=nrel, bytes=local,
                     whole_bytes=refs["tf_bytes"], split_bytes=split_local,
                     n_split=len(split), step_ms=step_ms, collective_ms=clock.ms,
                     clocked_ms=clocked)
    del model, steps, state, seen, built
    torch.cuda.empty_cache()

    # (c) base 224² float64 b2 with the clip at TP_CLIP of the norm, and the
    # planted faults
    f64 = {k: v.double() for k, v in image_batch(TP_BASE_BATCH, 224, seed=12).items()}

    def base_rel():
        model = get_vit_unet("base", device=dev, seed=0, **DP_F64)
        m, _, _, seen = tp_step(model, f64, mesh, clip=refs["clip"])
        got = whole_grads(model, seen["grads"], mesh)
        lr_ = abs(m["loss"].item() - refs["base_loss"]) / abs(refs["base_loss"])
        return max(lr_, leaf_rel([g.cpu() for g in got], refs["base_grads"])), model
    rel, model = base_rel()
    n_split = len(PP.placements(model))
    say(f"  (c) base 224² float64 b{TP_BASE_BATCH}, {n_split} tensors split, clip at "
        f"{refs['clip']:.4e}: loss and clipped gradients rel {rel:.2e} of the largest "
        f"against the single process (tol {F64_TOL:.0e})")
    if not rel <= F64_TOL:
        raise AssertionError("the split base step disagrees")
    planted = {}
    for name, plant in planted_tp(PP, TS).items():
        with plant():
            planted[name] = base_rel()[0]
        say(f"  (c) planted fault, {name}: rel {planted[name]:.2e} (must fail the "
            f"{F64_TOL:.0e} check)")
        if not planted[name] > F64_TOL:
            raise AssertionError(f"the tensor-parallel check cannot see a planted fault: {name}")
    out["base"] = dict(rel=rel, planted=planted, n_split=n_split)
    del model
    torch.cuda.empty_cache()

    # (d) the long-context CLI on this mesh: its layout split, no change of its own
    zero_launches()
    losses = train_sp_longcontext.main(["--steps", str(TP_CLI_STEPS)])
    torch.cuda.synchronize()
    launches["cli"] = all_launches()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_sp_longcontext losses {losses}")
    out["cli"] = losses
    out["launches"] = launches
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def phase_tensor_parallel():
    print("== phase 10: tensor parallelism (a world of 2 on one card over gloo)")
    import tempfile
    t_phase = time.perf_counter()
    kernels = tf_kernels(TP_HEADS, "(a)")
    print("  (a) the dropout of a rank's block of heads:")
    head_base = tp_head_base()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as root:
        ref = tp_references(root)
        print(f"  (b) references written: base 224² f64 global gradient norm "
              f"{ref['norm']:.4e}, clip {ref['clip']:.4e}")
        t_world = time.perf_counter()
        ranks = run_world(root, "--tp-worker", "10")
        world_s = time.perf_counter() - t_world
    launches = collections.Counter()
    for r, res in enumerate(ranks):
        if res["backend"] != "gloo":
            raise AssertionError(f"the world of two ran on {res['backend']}")
        for path, counts in res["launches"].items():
            for key in TP_KERNELS[path]:
                if not counts.get(key):
                    raise AssertionError(f"rank {r} {path}: kernel {key} never launched")
            launches.update(counts)
        # the f32 split model's keras calls at (4, 192): kernels 1-3 on
        # their f32 identity routes
        ev, st = res["launches"]["tf_eval"], res["launches"]["tf_step"]
        if not (ev["eval"] == ev["eval_identity_f32"] and st["fwd"] == st["fwd_identity_f32"]
                and st["bwd"] == st["bwd_identity_f32"]):
            raise AssertionError(f"rank {r}: the split model's routes {ev} {st}")
        if r == 0:
            print(f"  launches by route, rank 0: " + "; ".join(
                f"{path} {dict(c)}" for path, c in res["launches"].items()))
    print(f"  (d) train_sp_longcontext on 1 x 2, {TP_CLI_STEPS} steps: losses "
          f"{ranks[0]['cli']} (rank 1 {ranks[1]['cli']})")
    print(f"  the world of two: {world_s:.1f} s (start-up included); phase 10: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(kernels=kernels, head_base=head_base, launches=dict(launches),
                ranks=ranks, refs=ref)


# --- phase 11: the example scripts ----------------------------------------------

# the convergence scripts cut to a couple of epochs of a few steps (their
# constants, as the CPU tests cut them): the loss must fall in each run
EX_SEG = dict(N_TRAIN=256, N_VAL=64, EPOCHS=2, WARMUP_EPOCHS=2, FREEZE_EPOCHS=1,
              WARMUP_STEPS=4)
EX_SIDD = dict(N_TRAIN=640, N_VAL=128, WARMUP_STEPS=4,
               EPOCHS={"matched": 1, "ours": 1, "denoise": 1})
EX_PAIRS = 24                 # PNG pairs at 128² for convert_tfrecords
EX_HEAD = 4                   # steps averaged at a run's start and end
EX_WARMUP_ONLY = ("warmup", "track")   # the loss is held over the warmup phase
EX_TF_RUNS = ("matched", "ours")       # the SIDD runs of HViTUNetTF (bf16)
EX_KERNELS = {  # the kernels each run must launch
    "frozen": ("fwd", "bwd", "eval"), "exact": ("bn_fwd", "bwd", "eval"),
    "warmup": ("fwd", "bn_fwd", "bwd", "eval"), "track": ("fwd", "bn_fwd", "bwd", "eval"),
    "refold": ("fwd", "bn_fwd", "bwd", "eval"), "matched": ("fwd", "bwd", "eval"),
    "ours": ("fwd", "bwd", "eval"), "denoise": ("fwd", "bwd", "eval")}


class StepLosses:
    """``_convergence.train_epoch`` with every step's loss kept, by run."""

    def __init__(self, real):
        self.real, self.runs = real, []

    def start(self):
        self.runs.append([])

    def __call__(self, steps, state, *args, **kwargs):
        inner, losses = steps.train_step, self.runs[-1]

        def step(state, batch):
            state, m = inner(state, batch)
            losses.append(m["loss"])
            return state, m
        import dataclasses
        return self.real(dataclasses.replace(steps, train_step=step), state,
                         *args, **kwargs)


def falls(losses) -> tuple:
    vals = [float(x) for x in losses]
    head, tail = np.mean(vals[:EX_HEAD]), np.mean(vals[-EX_HEAD:])
    return head, tail, bool(np.isfinite(vals).all() and tail < head)


def ex_convergence(root):
    """Each convergence run, cut short, through its script's ``main``: the
    mean loss of its last EX_HEAD steps below its first EX_HEAD's, the
    launches by route, the results file written."""
    from vit_unet_tpu_torch.cli import _convergence as C
    from vit_unet_tpu_torch.cli import convergence_segmentation as S
    from vit_unet_tpu_torch.cli import convergence_sidd as D
    rec = StepLosses(C.train_epoch)
    results, launches = {}, {}
    patches = [mock.patch.object(C, "CONVERGENCE_PATH", os.path.join(root, "conv.json")),
               mock.patch.object(C, "train_epoch", rec)]
    patches += [mock.patch.object(S, k, v) for k, v in EX_SEG.items()]
    patches += [mock.patch.object(D, k, v) for k, v in EX_SIDD.items()]
    runs = [("segmentation", S, key) for key in S.RUNS] + [
        ("sidd", D, key) for key in D.RUNS]
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        for script, mod, key in runs:
            rec.start()
            zero_launches()
            t0 = time.perf_counter()
            mod.main([key])
            torch.cuda.synchronize()
            launches[key] = all_launches()
            # the hard flip and the tracking warmup end in a normalisation
            # shock or drift (the runs' point): their loss falls over the warmup
            held = rec.runs[-1]
            if key in EX_WARMUP_ONLY:
                held = held[:EX_SEG["FREEZE_EPOCHS"] * (EX_SEG["N_TRAIN"] // S.BATCH)]
            head, tail, ok = falls(held)
            results[key] = dict(first=head, last=tail, steps=len(rec.runs[-1]),
                                s=time.perf_counter() - t0)
            print(f"  (a) {script} {key}: {len(rec.runs[-1])} steps, mean loss of the "
                  f"first {EX_HEAD} {head:.5f}, of the last {EX_HEAD} {tail:.5f}"
                  f"{' of the warmup' if key in EX_WARMUP_ONLY else ''}; "
                  f"{results[key]['s']:.1f} s; launches {dict(launches[key])}")
            if not ok:
                raise AssertionError(f"{script} {key}: the loss did not fall")
            missing = [k for k in EX_KERNELS[key] if not launches[key].get(k)]
            if missing:
                raise AssertionError(f"{script} {key}: kernels {missing} never launched")
            # HViTUNetTF's bf16 runs: every kernel-2 and kernel-3 launch on
            # its identity route
            if key in EX_TF_RUNS and (
                    launches[key]["fwd"] != launches[key]["fwd_identity_tc"]
                    or launches[key]["bwd"] != launches[key]["bwd_identity_tc"]):
                raise AssertionError(f"sidd {key}: kernels 2-3 off their identity routes: "
                                     f"{launches[key]}")
            # the lite runs (bf16): every kernel-2, kernel-4 and kernel-3 launch
            # on the tensor cores
            if key not in EX_TF_RUNS and any(
                    launches[key][k] != launches[key][f"{k}_tensor_core"]
                    for k in ("fwd", "bn_fwd", "bwd")):
                raise AssertionError(f"{script} {key} (lite): kernels 2-4 off the tensor "
                                     f"cores: {launches[key]}")
        with open(os.path.join(root, "conv.json")) as fh:
            written = json.load(fh)
    if not {"segmentation_demo", "runs", "denoise_beyond_identity"} <= set(written):
        raise AssertionError(f"CONVERGENCE_torch.json sections {sorted(written)}")
    return results, launches


def ex_pairs(root, n=EX_PAIRS, side=128):
    """``n`` clean / noisy PNG pairs (RGB, 8 bits) under ``root``."""
    rng = np.random.default_rng(4)
    for d in ("clean", "noisy"):
        os.makedirs(os.path.join(root, d))
    for i in range(n):
        img = (np.cumsum(rng.integers(0, 9, (side, side, 3)), axis=0) % 256).astype(np.uint8)
        noisy = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
        for d, a in (("clean", img), ("noisy", noisy)):
            with open(os.path.join(root, d, f"{i:03d}.png"), "wb") as fh:
                fh.write(png_bytes(a, 2, 8))


def ex_entry_points(root):
    """(b) convert_tfrecords on PNG pairs (the count back from the names, a
    record read back exactly), (c) train_denoising on those shards (lite,
    bf16, --flash, one process), (d) serve_model from its best checkpoint."""
    from vit_unet_tpu_torch.cli import convert_tfrecords, serve_model, train_denoising
    from vit_unet_tpu_torch.data import image_io, tfrecord
    src, out = os.path.join(root, "pairs"), os.path.join(root, "tfrec")
    ex_pairs(src)
    t0 = time.perf_counter()
    total = convert_tfrecords.main(["--input_folder", src, "--output_folder", out])
    shards = sorted(os.path.join(out, p) for p in os.listdir(out))
    first = next(tfrecord.read_examples(shards[0]))["y"][0]
    stored = {image_io.imread_rgb(os.path.join(src, "clean", f)).tobytes()
              for f in os.listdir(os.path.join(src, "clean"))}
    print(f"  (b) convert_tfrecords: {total} pairs into {len(shards)} fold shards, "
          f"count from the names {tfrecord.count_data_items(shards)}, a record's y "
          f"{'is' if first in stored else 'IS NOT'} a clean image; "
          f"{time.perf_counter() - t0:.1f} s")
    if total != EX_PAIRS or tfrecord.count_data_items(shards) != EX_PAIRS or first not in stored:
        raise AssertionError("convert_tfrecords round trip failed")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        zero_launches()
        t0 = time.perf_counter()
        probes = train_denoising.main([
            "--tfrec", os.path.join(out, "*.tfrec"), "--epochs", "1",
            "--per_replica_batch", "8", "--model", "lite", "--flash"])
        torch.cuda.synchronize()
        train_launches = all_launches()
        train_s = time.perf_counter() - t0
        print(f"  (c) train_denoising: lite 128² bf16 --flash, 1 epoch: probes "
              + ", ".join(f"{k} {v:.2f} dB" for k, v in probes.items())
              + f"; launches {dict(train_launches)}; {train_s:.1f} s")
        if not all(math.isfinite(v) for v in probes.values()) or not all(
                train_launches.get(k) for k in ("bn_fwd", "bwd", "eval")):
            raise AssertionError("train_denoising failed")
        # a Fitter checkpoint of lite at its preset size, as serve_model builds it
        from vit_unet_tpu_torch import get_vit_unet
        from vit_unet_tpu_torch.train.fitter import Fitter
        fitter = Fitter(get_vit_unet("lite", seed=5), checkpoint_dir=os.path.join(root, "ck"))
        fitter.init_state()
        ck = fitter.save()
        del fitter
        zero_launches()
        t0 = time.perf_counter()
        served = serve_model.main(["--checkpoint", ck, "--model", "lite",
                                   "--out", os.path.join(root, "exported"),
                                   "--flash", "--batch_size", "8"])
        torch.cuda.synchronize()
        serve_launches = all_launches()
    finally:
        os.chdir(cwd)
    print(f"  (d) serve_model: lite 224² from a Fitter checkpoint, exported "
          f"and served {served.shape}, finite {bool(np.isfinite(served).all())}; "
          f"launches {dict(serve_launches)}; {time.perf_counter() - t0:.1f} s")
    if not (np.isfinite(served).all() and serve_launches.get("eval")):
        raise AssertionError("serve_model failed")
    return {"train_denoising": train_launches, "serve_model": serve_launches}


def phase_examples():
    print("== phase 11: the example scripts (convergence runs cut short, "
          "convert_tfrecords, train_denoising, serve_model)")
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ex_") as root:
        results, launches = ex_convergence(root)
        launches.update(ex_entry_points(root))
    total = collections.Counter()
    for counts in launches.values():
        total.update(counts)
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
    return dict(results=results, launches=dict(total))


TRAIN_KERNELS = [  # (key, name, replaces)
    ("fwd", "flash_reattention_train_fwd",
     "vit_unet_tpu/kernels/flash_reattention_train.py:363"),
    ("bwd", "flash_reattention_train_bwd",
     "vit_unet_tpu/kernels/flash_reattention_train.py:451"),
    ("bn_fwd", "flash_reattention_bn_fwd",
     "vit_unet_tpu/kernels/flash_reattention_train.py:741"),
]

TF_KERNEL_ROWS = {"fwd": "train_fwd", "bwd": "train_bwd"}  # phase 7a's rows

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
    # one rank of phase 9's (10's) world, started by phase 9 (10) itself
    parser.add_argument("--parallel-worker", nargs=4, help=argparse.SUPPRESS)
    parser.add_argument("--tp-worker", nargs=4, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    for worker, fn in ((args.parallel_worker, parallel_worker), (args.tp_worker, tp_worker)):
        if worker:
            rank, world, port, root = worker
            return fn(int(rank), int(world), port, root)
    phases = args.phases.split(",")
    if not phases or any(ph not in PHASES for ph in phases):
        parser.error(f"--phases takes a comma-separated subset of {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    needs_train = any(ph in phases for ph in ("2b", "4", "5", "6", "7", "8", "9", "10", "11"))
    phase_environment((EVAL_SOURCE, TRAIN_SOURCE) if needs_train else (EVAL_SOURCE,))
    if "2a" in phases:
        k = phase_kernels()
    if "2b" in phases:
        tk = phase_train_kernels()
    if "3" in phases:
        launches = phase_slice()
    if "4" in phases:
        train_launches_, _, lite = phase_train()
    if "5" in phases:
        fit_launches = phase_trainer()
    if "6" in phases:
        cli_launches = phase_entry()
    if "7" in phases:
        tf = phase_tf()
    if "8" in phases:
        cls = phase_classifier()
    if "9" in phases:
        par = phase_parallel()
    if "10" in phases:
        tp = phase_tensor_parallel()
    if "11" in phases:
        ex = phase_examples()
    if set(phases) != set(PHASES):
        print(f"chip_smoke: phases {','.join(phases)} only, "
              f"{time.perf_counter() - t_start:.1f} s; no result lines")
        return 0
    # each path's launches, counted from 0 just before it ran: serving
    # (phase 3), the bare train step (phase 4) and the Fitter's epochs
    # (phase 5: TFRecord stream epochs 0, 1 and 3, resident epochs 2 and 4)
    fit_total = collections.Counter()
    for per_epoch in fit_launches:
        for counts in per_epoch.values():
            fit_total.update(counts)
    # the entry point (phase 6: the CLI's runs, the loaded programs), the
    # TF-flavour model (phase 7: serving, the keras-attention steps and the
    # re-attention variant's steps) and the classifier (phase 8)
    model_paths = {"lite_step": lite["launches"],   # phase 4's lite b64 steps
                   "tf_serving": tf["serving"], "tf_f32_serving": tf["f32_serving"],
                   "tf_train": tf["train"], "tf_f32_train": tf["f32_train"],
                   "tf_variant": tf["variant"],
                   # the classifier (phase 8): its forward and steps, the CLI
                   "classifier": cls["model"], "classifier_cli": cls["cli"]}
    # phase 9: both ranks' sequence- and data-parallel paths and the NCCL step
    model_paths["parallel"] = par["launches"]
    # phase 10: both ranks' tensor-parallel steps and the long-context CLI;
    # phase 11: the example scripts
    model_paths["tensor_parallel"] = tp["launches"]
    model_paths["examples"] = ex["launches"]
    by_path = {"flash_reattention": {"serving": launches, "fitter": fit_total["eval"],
                                     "entry": cli_launches["eval"],
                                     **{p: c.get("eval", 0) for p, c in model_paths.items()}}}
    for key, _, _ in TRAIN_KERNELS:
        by_path[key] = {"train_step": train_launches_[key], "fitter": fit_total[key],
                        "entry": cli_launches[key],
                        **{p: c.get(key, 0) for p, c in model_paths.items()}}
    tf_shape = "H{} dh{} N{}".format(*TF_SHAPE)
    tp_shape = "H{} dh{} N{}".format(*TP_HEADS)
    kernels = [{
        "name": "flash_reattention",
        "route": "cuda",
        # the interface and the CUDA-core route; the tensor-core route it
        # includes is csrc/reattention_tc.cuh
        "source": "vit_unet_tpu_torch/kernels/csrc/flash_reattention.cu",
        "replaces": "vit_unet_tpu/kernels/flash_reattention.py:111",
        "launches": sum(by_path["flash_reattention"].values()),
        "launches_by_path": by_path["flash_reattention"],
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
        # the keras attention's level-0 shape (phase 7a), bf16 and f32
        "tf_level0": {tf_shape: {dt: r["flash_reattention"]
                                 for dt, r in tf["kernels"].items()}},
        # the classifier's 16-head levels at b64 (phase 8a0)
        "head16": {shape: {dt: r["flash_reattention"] for dt, r in rows.items()}
                   for shape, rows in cls["kernels"].items()},
        # the sequence-parallel shard shapes, bf16 b8 (phase 9b)
        "sp_shards": {shape: row["flash_reattention"]
                      for shape, row in par["shards"].items()},
        # a rank's keras heads at model 2 (phase 10a), bf16 and f32
        "tp_heads": {tp_shape: {dt: r["flash_reattention"]
                                for dt, r in tp["kernels"].items()}},
        # lite's level shapes at b64, bf16 (phase 2a)
        "lite": k["lite"],
    }]
    # kernel 1's identity route: KerasMHA's bf16 eval calls (phases 7, 11)
    ident = k["identity"]
    i8 = ident["classes"]["H8 dh192 N256"]
    kernels.append({
        "name": "flash_reattention_identity",
        "route": "cuda",
        "source": "vit_unet_tpu_torch/kernels/csrc/attention_identity_tc.cuh",
        "replaces": "vit_unet_tpu/kernels/flash_reattention.py:111",
        "launches": sum(c.get("eval_identity_tc", 0) for c in model_paths.values()),
        "launches_by_path": {p: c.get("eval_identity_tc", 0) for p, c in model_paths.items()},
        "max_abs_err": ident["err"],
        # HViTUNetTF's level 0, (8, 192) at N 256, b64 bf16 (phase 2a)
        "ms": i8["ms"], "plain_ms": i8["plain_ms"],
        "bound_ms": i8["bound_ms"], "bound_by": i8["bound_by"],
        # with the identity mix scaled_dot_product_attention is the same function
        "library_ms": i8["sdpa_ms"],
        # the two-pass tensor-core route on the same inputs, in turns
        "tensor_core_ms": i8["tensor_core_ms"],
        "classes": {shape: {key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                                     "sdpa_ms", "tensor_core_ms")}
                    for shape, r in ident["classes"].items()},
    })
    # kernel 1's float32 identity route: KerasMHA's f32 eval calls (phase 7's
    # default-config forward, phase 10's split model at (4, 192))
    ident32 = k["identity_f32"]
    f8 = ident32["classes"]["H8 dh192 N256"]
    kernels.append({
        "name": "flash_reattention_identity_f32",
        "route": "cuda",
        "source": "vit_unet_tpu_torch/kernels/csrc/attention_identity_f32.cuh",
        "replaces": "vit_unet_tpu/kernels/flash_reattention.py:111",
        "launches": sum(c.get("eval_identity_f32", 0) for c in model_paths.values()),
        "launches_by_path": {p: c.get("eval_identity_f32", 0) for p, c in model_paths.items()},
        "max_abs_err": ident32["err"],
        # (8, 192) at N 256, b64 f32 (phase 2a); the bound counts the bf16
        # MMAs it issues, three a product
        "ms": f8["ms"], "plain_ms": f8["plain_ms"],
        "bound_ms": f8["bound_ms"], "bound_by": f8["bound_by"],
        "library_ms": f8["sdpa_ms"],
        # the CUDA-core route (route 0) on the same inputs, in turns
        "cuda_core_ms": f8["cuda_core_ms"],
        "classes": {shape: {key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                                     "sdpa_ms", "cuda_core_ms")}
                    for shape, r in ident32["classes"].items()},
    })
    # kernel 2's identity route: KerasMHA's bf16 training calls (phase 7's
    # steps and variant, phase 11's SIDD runs)
    fid = tk["fwd_identity"]
    t8 = fid["classes"]["H8 dh192 N256"]
    kernels.append({
        "name": "flash_reattention_train_fwd_identity",
        "route": "cuda",
        "source": "vit_unet_tpu_torch/kernels/csrc/attention_identity_tc.cuh",
        "replaces": "vit_unet_tpu/kernels/flash_reattention_train.py:363",
        "launches": sum(c.get("fwd_identity_tc", 0) for c in model_paths.values()),
        "launches_by_path": {p: c.get("fwd_identity_tc", 0) for p, c in model_paths.items()},
        "max_abs_err": fid["err"],
        # (8, 192) at N 256, b64 bf16, rate 0.2 (phase 2b)
        "ms": t8["ms"], "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound"][0], "bound_by": t8["bound"][1],
        # no single PyTorch call draws the Philox mask inside the map; at rate
        # 0 scaled_dot_product_attention's forward computes the same out:
        # its time, beside the route's own at rate 0 (``rate0_ms``)
        "library_ms": t8["sdpa_ms"], "rate0_ms": t8["rate0_ms"],
        # the CUDA-core route (the general forward with I and 0) in turns
        "cuda_core_ms": t8["cuda_core_ms"],
        "classes": {shape: {key: r[key] for key in ("ms", "plain_ms", "cuda_core_ms", "bound",
                                                     "rate0_ms", "sdpa_ms")}
                    for shape, r in fid["classes"].items()},
    })
    # kernel 2's f32 identity route: KerasMHA's f32 training calls (phase 7's
    # default-config steps, phase 10's split model)
    fid32 = tk["fwd_identity_f32"]
    t8 = fid32["classes"]["H8 dh192 N256"]
    kernels.append({
        "name": "flash_reattention_train_fwd_identity_f32",
        "route": "cuda",
        "source": "vit_unet_tpu_torch/kernels/csrc/attention_identity_f32.cuh",
        "replaces": "vit_unet_tpu/kernels/flash_reattention_train.py:363",
        "launches": sum(c.get("fwd_identity_f32", 0) for c in model_paths.values()),
        "launches_by_path": {p: c.get("fwd_identity_f32", 0) for p, c in model_paths.items()},
        "max_abs_err": fid32["err"],
        # (8, 192) at N 256, b64 f32, rate 0.2 (phase 2b); the bound counts
        # the bf16 MMAs it issues, three a product
        "ms": t8["ms"], "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound"][0], "bound_by": t8["bound"][1],
        # SDPA's f32 forward at rate 0, as for the bf16 route
        "library_ms": t8["sdpa_ms"], "rate0_ms": t8["rate0_ms"],
        "cuda_core_ms": t8["cuda_core_ms"],
        "classes": {shape: {key: r[key] for key in ("ms", "plain_ms", "cuda_core_ms", "bound",
                                                     "rate0_ms", "sdpa_ms")}
                    for shape, r in fid32["classes"].items()},
    })
    # kernel 3's identity routes: KerasMHA's training calls, bf16 (phase 7's
    # steps and variant, phase 11's SIDD runs) and f32 (phase 7's
    # default-config steps, phase 10's split model)
    for dt, route in (("bfloat16", "identity_tc"), ("float32", "identity_f32")):
        bid = tk[f"bwd_identity_{dt}"]
        b8 = bid["classes"]["H8 dh192 N256"]
        kernels.append({
            "name": "flash_reattention_train_bwd_identity" + ("_f32" if dt == "float32" else ""),
            "route": "cuda",
            "source": "vit_unet_tpu_torch/kernels/csrc/attention_identity_bwd.cuh",
            "replaces": "vit_unet_tpu/kernels/flash_reattention_train.py:451",
            "launches": sum(c.get(f"bwd_{route}", 0) for c in model_paths.values()),
            "launches_by_path": {p: c.get(f"bwd_{route}", 0) for p, c in model_paths.items()},
            "max_abs_err": bid["err"],
            # (8, 192) at N 256, b64, rate 0.2 (phase 2b); f32: the bound
            # counts the bf16 MMAs it issues, three a product
            "ms": b8["ms"], "plain_ms": b8["plain_ms"],
            "bound_ms": b8["bound"][0], "bound_by": b8["bound"][1],
            # with the identity mix, at rate 0, the backward of
            # scaled_dot_product_attention computes the same gradients
            "library_ms": b8["sdpa_ms"],
            # the route the call took before, on the same inputs, in turns
            "old_route": b8["old_route"], "old_ms": b8["old_ms"],
            "classes": {shape: {key: r[key] for key in ("ms", "plain_ms", "old_route", "old_ms",
                                                         "bound", "sdpa_ms")}
                        for shape, r in bid["classes"].items()},
        })
    for key, name, replaces in TRAIN_KERNELS:
        t = tk[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "vit_unet_tpu_torch/kernels/csrc/flash_reattention_train.cu",
            "replaces": replaces, "launches": sum(by_path[key].values()),
            "launches_by_path": by_path[key],
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # no single PyTorch call computes re-attention with a head mix,
            # dropout and its BatchNorm moments or their gradients
            "library_ms": None})
        if key in TF_KERNEL_ROWS:      # the keras attention's shapes (phases 7a, 10a)
            kernels[-1]["tf_level0"] = {tf_shape: {
                dt: r[TF_KERNEL_ROWS[key]] for dt, r in tf["kernels"].items()}}
            kernels[-1]["tp_heads"] = {tp_shape: {
                dt: r[TF_KERNEL_ROWS[key]] for dt, r in tp["kernels"].items()}}
        kernels[-1]["head16"] = {shape: {dt: r[key] for dt, r in rows.items()}
                                 for shape, rows in cls["kernels"].items()}
        kernels[-1]["sp_shards"] = {shape: row[key] for shape, row in par["shards"].items()}
        if key in TC_SOURCES:
            # the bf16 tensor-core route it includes, which base classes ran
            # on which route, and the main path's launches by route
            kernels[-1].update(
                tensor_core_source=TC_SOURCES[key],
                routes=t["routes"], cuda_core_ms=t["old_ms"],
                route_launches={r: train_launches_[f"{key}_{r}"] + fit_total[f"{key}_{r}"]
                                + cli_launches[f"{key}_{r}"]
                                + sum(c.get(f"{key}_{r}", 0) for c in model_paths.values())
                                for r in [c[len(key) + 1:] for c in train_launches_
                                          if c.startswith(key + "_")]})
    # kernels 2, 4 and 3 at lite's classes: phase 4's lite steps (exact and
    # frozen BN), whose every launch is a lite call on the tensor cores; the
    # numbers are (4, 12)'s at b64 (phase 2b), where lite spends most, the
    # other classes beside; the plain version's time is its b64 call's, by
    # LITE_SLICE images
    for key, name, source, replaces in (
            ("fwd", "flash_reattention_train_fwd_lite", TC_SOURCES["fwd"],
             "vit_unet_tpu/kernels/flash_reattention_train.py:363"),
            ("bn_fwd", "flash_reattention_bn_fwd_lite", TC_SOURCES["bn_fwd"],
             "vit_unet_tpu/kernels/flash_reattention_train.py:741"),
            ("bwd", "flash_reattention_train_bwd_lite", TC_SOURCES["bwd"],
             "vit_unet_tpu/kernels/flash_reattention_train.py:451")):
        rows = {shape: r[key] for shape, r in tk["lite"].items()}
        r12 = rows["H4 dh12 N3136"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": lite["launches"][f"{key}_tensor_core"],
            "launches_by_path": {"lite_step": lite["launches"][f"{key}_tensor_core"]},
            "max_abs_err": r12["err"], "ms": r12["ms"], "plain_ms": r12["plain_ms"],
            "bound_ms": r12["bound"][0], "bound_by": r12["bound"][1],
            # no single PyTorch call computes re-attention with a head mix
            "library_ms": None,
            # the CUDA-core route on the same inputs, in turns
            "cuda_core_ms": r12["cuda_core_ms"], "classes": rows})
    # kernel 3's f32 tensor-core route (split precision) at lite's classes:
    # phase 4's lite f32 steps (exact and frozen BN, the CLI's default dtype)
    # are its main path; the numbers are (4, 12)'s at b64 f32 (phase 2b),
    # the other classes beside; the bound counts three bf16 MMAs a product
    rows = {shape: r["bwd"] for shape, r in tk["lite_f32"].items()}
    r12 = rows["H4 dh12 N3136"]
    f32_launches = lite["launches"]["bwd_tensor_core_f32"]
    kernels.append({
        "name": "flash_reattention_train_bwd_lite_f32", "route": "cuda",
        "source": TC_SOURCES["bwd"],
        "replaces": "vit_unet_tpu/kernels/flash_reattention_train.py:451",
        "launches": f32_launches, "launches_by_path": {"lite_step": f32_launches},
        "max_abs_err": r12["err"], "ms": r12["ms"], "plain_ms": r12["plain_ms"],
        "bound_ms": r12["bound"][0], "bound_by": r12["bound"][1],
        # no single PyTorch call computes re-attention with a head mix
        "library_ms": None,
        # the CUDA-core route on the same f32 inputs, in turns
        "cuda_core_ms": r12["cuda_core_ms"], "classes": rows})
    # kernels 4 and 2 at 16 heads, reattention_bnfwd16_tc.cuh's exact and
    # frozen modes at (16, 12) and (16, 48): the classifier's steps and
    # CLI (phase 8) are the only paths at 16 heads, and every bf16 call
    # there takes the tensor cores; the numbers are (16, 12)'s at N 784,
    # b64 bf16, rate 0.2 (phase 8a0), the larger call, (16, 48)'s beside
    cls_paths = ("classifier", "classifier_cli")
    for key, name, replaces in (
            ("bn_fwd", "flash_reattention_bn_fwd16",
             "vit_unet_tpu/kernels/flash_reattention_train.py:741"),
            ("fwd", "flash_reattention_train_fwd16",
             "vit_unet_tpu/kernels/flash_reattention_train.py:363")):
        rows = {shape: r["bfloat16"][key] for shape, r in cls["kernels"].items()}
        b16 = rows["H16 dh12 N784"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "vit_unet_tpu_torch/kernels/csrc/reattention_bnfwd16_tc.cuh",
            "replaces": replaces,
            "launches": sum(model_paths[p].get(f"{key}_tensor_core", 0) for p in cls_paths),
            "launches_by_path": {p: model_paths[p].get(f"{key}_tensor_core", 0)
                                 for p in cls_paths},
            "max_abs_err": max(r["err"] for r in rows.values()), "ms": b16["ms"],
            "plain_ms": b16["plain_ms"],
            "bound_ms": b16["bound"][0], "bound_by": b16["bound"][1],
            # no single PyTorch call computes re-attention with a head mix,
            # dropout and the map's BatchNorm moments
            "library_ms": None,
            # the CUDA-core route on the same inputs, in turns
            "cuda_core_ms": b16["cuda_core_ms"],
            "classes": rows,
        })
    idle = [kern["name"] for kern in kernels if not kern["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on a main path: {idle}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
