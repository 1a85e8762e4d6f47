"""Beyond-identity convergence on the card: binary shape segmentation to
high Dice, the port's counterpart of ``examples/convergence_segmentation.py``
(the same task, constants, runs and recipes; ``--device`` added).

The reference's denoising task has an identity fixed point
(``cli/convergence_sidd.py``), so a model that copies its input scores
well there.  Here identity is worthless: the target is the union mask of
1-4 tinted ellipses over a low-frequency cluttered background, and the
best Dice of thresholding the per-pixel intensity (the ``threshold_floor``
printed) is far below what a model reaches by learning.  ViTUNet lite at
128² with a one-channel logits head and soft-Dice + BCE (the CLI's
``--task segment``), dropout off, AdamW on a warmup-cosine schedule after
``clip_by_global_norm(1.0)`` (the step's ``clip_norm``).

Runs (argv selects, none = all): ``frozen`` (frozen-BN kernels), ``exact``
(exact batch-statistics BN from scratch), ``warmup`` (frozen warmup, then
a hard flip to exact BN: ``bn-hard-flip``), ``track`` (a tracking warmup:
``bn-track-warmup``) and ``refold`` (frozen warmup, then the moments
refolded into the BatchNorms through ``train/bn_refold.py`` and the
optimizer made anew: ``bn-refold``).  Each run merges into the
``segmentation_demo`` section of ``CONVERGENCE_torch.json``.

    python -m vit_unet_tpu_torch.cli.convergence_segmentation frozen refold
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from vit_unet_tpu_torch.cli import _convergence as C
from vit_unet_tpu_torch.ops.resize import resize_cubic

IM = 128
N_TRAIN, N_VAL = 1280, 256
BATCH = 32
EPOCHS = 40
WARMUP_EPOCHS, FREEZE_EPOCHS = 50, 20     # run_warmup's epochs and flip
WARMUP_STEPS = 50                          # the schedule's linear warmup
RUNS = {"frozen": "frozen-bn", "exact": "exact-bn", "warmup": "bn-hard-flip",
        "track": "bn-track-warmup", "refold": "bn-refold"}


def make_dataset(n: int, seed: int):
    """(images (N, 3, IM, IM) in [0,1], masks (N, 1, IM, IM) in {0,1})."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, 3, 8, 8)).astype(np.float32)
    imgs = resize_cubic(base, (n, 3, IM, IM))
    lo = imgs.min(axis=(1, 2, 3), keepdims=True)
    hi = imgs.max(axis=(1, 2, 3), keepdims=True)
    imgs = (imgs - lo) / np.maximum(hi - lo, 1e-6)
    masks = np.zeros((n, 1, IM, IM), np.float32)
    yy, xx = np.mgrid[0:IM, 0:IM].astype(np.float32)
    for i in range(n):
        for _ in range(rng.integers(1, 5)):
            cy, cx = rng.uniform(16, IM - 16, size=2)
            ry, rx = rng.uniform(8, 28, size=2)
            theta = rng.uniform(0, np.pi)
            c, s = np.cos(theta), np.sin(theta)
            u = (c * (yy - cy) + s * (xx - cx)) / ry
            v = (-s * (yy - cy) + c * (xx - cx)) / rx
            inside = u * u + v * v <= 1.0
            tint = (rng.choice([-1.0, 1.0], size=3)
                    * rng.uniform(0.25, 0.5, size=3)).astype(np.float32)
            imgs[i] += tint[:, None, None] * inside[None].astype(np.float32)
            masks[i, 0][inside] = 1.0
        imgs[i] += rng.normal(scale=0.02, size=(3, IM, IM)).astype(np.float32)
    return np.clip(imgs, 0.0, 1.0), masks


def threshold_floor(imgs: np.ndarray, masks: np.ndarray) -> float:
    """Best Dice of thresholding the per-pixel mean intensity: the 'no
    learning needed' floor this task is designed to defeat."""
    inten = imgs.mean(axis=1, keepdims=True)
    best = 0.0
    for t in np.linspace(0.05, 0.95, 37):
        for sign in (1, -1):
            pred = ((inten - t) * sign > 0).astype(np.float32)
            inter = (pred * masks).sum()
            dice = 2 * inter / max(pred.sum() + masks.sum(), 1e-6)
            best = max(best, float(dice))
    return best


def _model(device, frozen_bn: bool):
    from vit_unet_tpu_torch.models.vit_unet import get_vit_unet
    # dropout off: at this 1280-image budget the preset's 0.2 attention and
    # projection dropout keeps spatial features from forming (the JAX
    # script's probe)
    return get_vit_unet("lite", device=device, seed=0, im_size=IM,
                        out_channels=1, dtype="bfloat16", param_dtype="bfloat16",
                        use_flash=True, flash_train=True,
                        flash_frozen_bn=frozen_bn, attn_drop=0.0, proj_drop=0.0)


def _setup(model, epochs: int, peak_lr: float, bn_frozen: bool = False):
    """(steps, state, step count) of AdamW on the warmup-cosine schedule
    after the global-norm clip at 1.0."""
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import dice_bce
    from vit_unet_tpu_torch.train.metrics import dice_from_logits
    from vit_unet_tpu_torch.train.schedules import warmup_cosine_decay_schedule

    opt = adamw(model, 0.0)
    metrics = {"dice": dice_from_logits}
    steps = build_step_functions(model, opt, dice_bce, metrics=metrics, clip_norm=1.0)
    frozen = (build_step_functions(model, opt, dice_bce, metrics=metrics,
                                   clip_norm=1.0, bn_frozen=True)
              if bn_frozen else None)
    state = TrainState.create(model=model, optimizer=opt, seed=1)
    count = C.StepCount(warmup_cosine_decay_schedule(
        0.0, peak_lr, WARMUP_STEPS, epochs * (N_TRAIN // BATCH)))
    return steps, frozen, state, count


def run(tag: str, xs, ys, xv, yv, *, frozen_bn: bool, epochs=None,
        peak_lr: float = 1e-3, device=None):
    epochs = EPOCHS if epochs is None else epochs
    steps, _, state, count = _setup(_model(device, frozen_bn), epochs, peak_lr)
    t0 = time.time()
    hist = []
    for ep in range(epochs):
        state, m = C.train_epoch(steps, state, xs, ys, BATCH, ep, count)
        train_loss = float(m["loss"])
        vd = C.evaluate(steps, state, xv, yv, BATCH)["dice"]
        hist.append({"epoch": ep + 1, "train_loss": round(train_loss, 5),
                     "val_dice": round(vd, 4)})
        print(f"[{tag}] epoch {ep+1}: train {train_loss:.5f}, val Dice "
              f"{vd:.4f}", flush=True)
    return {"tag": tag, "epochs": epochs, "history": hist,
            "best_val_dice": max(h["val_dice"] for h in hist),
            "wall_s": round(time.time() - t0, 1)}


def run_warmup(tag: str, xs, ys, xv, yv, *, freeze_epochs=None, epochs=None,
               peak_lr: float = 1e-3, mode: str = "freeze", device=None):
    """The frozen -> exact BN schedule, driven directly (``Fitter``'s
    ``bn_freeze_epochs`` / ``bn_warmup``): ``freeze_epochs`` epochs with the
    head-mix BatchNorm not yet on batch statistics, then exact BN.

    ``mode='freeze'``: the warmup runs frozen at the running statistics; at
    the flip they have never moved (a normalisation shock).
    ``mode='track'``: the warmup normalises with the running statistics
    while pulling them toward each batch's moments (``bn_track``).
    ``mode='refold'``: frozen warmup, then the measured batch moments are
    folded into each BatchNorm's affine and running statistics
    (``train/bn_refold.py``) so the exact forward computes the warmed
    function, and the optimizer is made anew (its moments and the
    schedule's count, as ``tx.init`` does)."""
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    from vit_unet_tpu_torch.train.bn_refold import bn_refold, estimate_bn_moments

    epochs = WARMUP_EPOCHS if epochs is None else epochs
    freeze_epochs = FREEZE_EPOCHS if freeze_epochs is None else freeze_epochs
    model = _model(device, False)
    steps, frozen_steps, state, count = _setup(model, epochs, peak_lr,
                                               bn_frozen=mode != "track")
    if mode == "track":
        frozen_steps = steps            # batch statistics, bn_track forward
    layers = [m for m in model.modules() if isinstance(m, ReAttention)]
    t0 = time.time()
    hist = []
    for ep in range(epochs):
        frozen = ep < freeze_epochs
        if mode == "refold" and ep == freeze_epochs:
            calib = [xs[i * BATCH:(i + 1) * BATCH]
                     for i in range(min(4, len(xs) // BATCH))]
            moments = estimate_bn_moments(model, calib)
            bn_refold(model, moments)
            state.optimizer.state.clear()
            count.count = 0
            print(f"[{tag}] refold flip after epoch {ep}: {len(moments)} "
                  "BN sites refolded, optimizer reset", flush=True)
        for layer in layers:
            layer.bn_track = frozen and mode == "track"
        state, m = C.train_epoch(frozen_steps if frozen else steps, state, xs, ys,
                                 BATCH, ep, count)
        for layer in layers:
            layer.bn_track = False
        train_loss = float(m["loss"])
        vd = C.evaluate(steps, state, xv, yv, BATCH)["dice"]
        phase = mode if frozen else "exact"
        hist.append({"epoch": ep + 1, "phase": phase,
                     "train_loss": round(train_loss, 5), "val_dice": round(vd, 4)})
        print(f"[{tag}] epoch {ep+1} ({phase}): train {train_loss:.5f}, "
              f"val Dice {vd:.4f}", flush=True)
    exact_hist = [h for h in hist if h["phase"] == "exact"]
    return {"tag": tag, "epochs": epochs, "freeze_epochs": freeze_epochs,
            "history": hist, "best_val_dice": max(h["val_dice"] for h in hist),
            "best_val_dice_exact_phase": max(
                (h["val_dice"] for h in exact_hist), default=None),
            "final_val_dice": hist[-1]["val_dice"],
            "wall_s": round(time.time() - t0, 1)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("runs", nargs="*", help=f"of {sorted(RUNS)} (none: all)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    unknown = set(args.runs) - set(RUNS)
    if unknown:
        p.error(f"unknown runs {sorted(unknown)}; choose from {sorted(RUNS)}")
    from vit_unet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    which = set(args.runs) or set(RUNS)
    xs, ys = make_dataset(N_TRAIN, 0)
    xv, yv = make_dataset(N_VAL, 777)
    floor = threshold_floor(xv, yv)
    print(f"threshold-on-intensity Dice floor (val): {floor:.3f}", flush=True)
    xs, ys, xv, yv = (C.on_device(a, device) for a in (xs, ys, xv, yv))

    runs = []
    for key in RUNS:
        if key not in which:
            continue
        if key in ("frozen", "exact"):
            runs.append(run(RUNS[key], xs, ys, xv, yv, frozen_bn=key == "frozen",
                            device=device))
        else:
            mode = {"warmup": "freeze", "track": "track", "refold": "refold"}[key]
            runs.append(run_warmup(RUNS[key], xs, ys, xv, yv, mode=mode,
                                   device=device))

    results = {}
    if os.path.exists(C.CONVERGENCE_PATH):
        with open(C.CONVERGENCE_PATH) as f:
            results = json.load(f)
    section = results.get("segmentation_demo", {})
    section["scenario"] = (
        "binary shape segmentation at 128^2 on ViTUNet lite (out_channels=1 "
        "logits head, dice_bce: the CLI's --task segment), synthetic "
        "tinted-ellipse dataset where identity is worthless and per-pixel "
        "thresholding fails; the port on the card")
    section["threshold_floor_val_dice"] = round(floor, 4)
    section["device"] = C.card(device)
    by_tag = {r["tag"]: r for r in section.get("runs", [])}
    for r in runs:
        by_tag[r["tag"]] = r
    section["runs"] = list(by_tag.values())
    C.merge_into_convergence({"segmentation_demo": section})
    summary = {r["tag"]: r["best_val_dice"] for r in runs} | {"threshold_floor": floor}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
