"""Reference-task convergence on the card: the SIDD denoising scenario of
``ViT_UNet_TF_TPU.ipynb`` cell 23, the port's counterpart of
``examples/convergence_sidd.py`` (the same constants, runs and recipes;
``--device`` added).

128² crops, global batch 64, MSE, val PSNR, on the reference's TPU model
(``HViTUNetTF``: keras-style attention, global residual) with
``use_flash=True`` (its attention on kernels 1-3).  Real SIDD is not here,
so structured synthetic clean images carry AWGN calibrated to the
reference's measured noisy<->clean 20.4 dB.  Runs (argv selects, none =
all):

  matched — the notebook recipe: Adam 8e-6, 10 epochs, the notebook's
            dropouts, bfloat16, channels-last.
  ours    — AdamW on a warmup-cosine schedule to 3e-4, clip 1.0, no
            dropout, 30 epochs.
  denoise — beyond identity: ViTUNet lite with ``input_skip`` and a
            three-block conv head (``head_blocks=3``, ``head_dim=48``),
            frozen-BN kernels, the AWGN drawn anew every epoch (from
            ``1000 + epoch``) on the same clean images, 40 epochs.

Each merges its sections into ``CONVERGENCE_torch.json``.

    python -m vit_unet_tpu_torch.cli.convergence_sidd denoise
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from vit_unet_tpu_torch.cli import _convergence as C
from vit_unet_tpu_torch.ops.resize import resize_cubic

IM = 128
N_TRAIN, N_VAL = 1280, 256          # the notebook's SIDD-1280 scale
BATCH = 64
NOISE_SIGMA = 0.0955                # calibrated: noisy<->clean ~ 20.4 dB
EPOCHS = {"matched": 10, "ours": 30, "denoise": 40}
WARMUP_STEPS = 50                   # the schedules' linear warmup
TF_CONFIG: dict = {}                # HViTUNetTF fields: its default config
RUNS = ("matched", "ours", "denoise")


def clean_images(n: int, seed: int) -> np.ndarray:
    """Structured clean content (N, 3, IM, IM) in [0, 1]: low-frequency
    fields plus random rectangles."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, 3, 8, 8)).astype(np.float32)
    imgs = resize_cubic(base, (n, 3, IM, IM))
    for i in range(n):
        for _ in range(rng.integers(2, 6)):
            y0, x0 = rng.integers(0, IM - 16, size=2)
            h, w = rng.integers(8, 48, size=2)
            imgs[i, :, y0:y0 + h, x0:x0 + w] += rng.normal(
                scale=0.5, size=(3, 1, 1)).astype(np.float32)
    lo, hi = imgs.min(axis=(1, 2, 3), keepdims=True), imgs.max(
        axis=(1, 2, 3), keepdims=True)
    return (imgs - lo) / np.maximum(hi - lo, 1e-6)


def make_pairs(n: int, seed: int):
    clean = clean_images(n, seed)
    rng = np.random.default_rng(seed + 1)
    noisy = clean + rng.normal(scale=NOISE_SIGMA,
                               size=clean.shape).astype(np.float32)
    return noisy.astype(np.float32), clean.astype(np.float32)


def _noisy_psnr(xv: np.ndarray, yv: np.ndarray) -> float:
    return float(np.mean([10 * math.log10(1.0 / max(np.mean((a - b) ** 2), 1e-12))
                          for a, b in zip(xv, yv)]))


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _steps(model, optimizer, clip_norm=None):
    from vit_unet_tpu_torch.parallel.train_step import TrainState, build_step_functions
    from vit_unet_tpu_torch.train.losses import mse
    from vit_unet_tpu_torch.train.metrics import psnr, ssim
    steps = build_step_functions(model, optimizer, mse,
                                 metrics={"psnr": psnr, "ssim": ssim},
                                 clip_norm=clip_norm)
    return steps, TrainState.create(model=model, optimizer=optimizer, seed=1)


def _warmup_cosine(peak: float, epochs: int) -> C.StepCount:
    from vit_unet_tpu_torch.train.schedules import warmup_cosine_decay_schedule
    return C.StepCount(warmup_cosine_decay_schedule(
        0.0, peak, WARMUP_STEPS, epochs * (N_TRAIN // BATCH)))


def run(tag: str, recipe: str, epochs: int, drops=None, device=None):
    """The reference's model at 128², bfloat16, on the kernels: ``recipe``
    'adam' (Adam 8e-6) or 'ours' (AdamW warmup-cosine 3e-4, clip 1.0)."""
    from vit_unet_tpu_torch.models.hvit_unet_tf import get_hvit_unet_tf
    from vit_unet_tpu_torch.parallel.train_step import adamw

    kw = {} if drops is None else dict(drop_attn=drops, drop_proj=drops,
                                       drop_linear=drops)
    model = get_hvit_unet_tf(device=device, seed=0, **{
        **TF_CONFIG, "img_size": IM, "dtype": "bfloat16", "param_dtype": "bfloat16",
        "use_flash": True, **kw})
    xs, ys = make_pairs(N_TRAIN, 0)
    xv, yv = make_pairs(N_VAL, 777)
    noisy_psnr = _noisy_psnr(xv, yv)
    # channels-last (the TF model's orientation, tf/model.py)
    xs, ys, xv, yv = (C.on_device(a.transpose(0, 2, 3, 1), device)
                      for a in (xs, ys, xv, yv))
    if recipe == "adam":
        opt = torch.optim.Adam(model.parameters(), lr=8e-6, betas=(0.9, 0.999), eps=1e-8)
        (steps, state), count = _steps(model, opt), None
    else:
        opt = adamw(model, 0.0)
        (steps, state), count = _steps(model, opt, 1.0), _warmup_cosine(3e-4, epochs)
    t0 = time.time()
    hist = []
    for ep in range(epochs):
        state, m = C.train_epoch(steps, state, xs, ys, BATCH, ep, count)
        train_loss = float(m["loss"])
        v = C.evaluate(steps, state, xv, yv, BATCH)
        hist.append({"epoch": ep + 1, "train_loss": round(train_loss, 5),
                     "val_psnr": round(v["psnr"], 3), "val_ssim": round(v["ssim"], 4),
                     "val_loss": round(v["loss"], 6)})
        print(f"[{tag}] epoch {ep+1}: train {train_loss:.5f}, val PSNR "
              f"{v['psnr']:.2f} dB, SSIM {v['ssim']:.4f}", flush=True)
    return {"tag": tag, "device": C.card(_device_of(model)),
            "noisy_val_psnr_db": round(noisy_psnr, 2),
            "noise_var": round(NOISE_SIGMA ** 2, 5), "epochs": epochs,
            "kernel_path": "use_flash=True: KerasMHA on kernels 1-3",
            "history": hist,
            "best_val_psnr_db": max(h["val_psnr"] for h in hist),
            "best_val_ssim": max(h["val_ssim"] for h in hist),
            "wall_s": round(time.time() - t0, 1)}


def run_denoise(epochs=None, head_blocks: int = 3, head_dim: int = 48,
                peak_lr: float = 1e-3, device=None):
    """ViTUNet lite with ``input_skip`` and a nonlinear conv head, frozen-BN
    kernels, the AWGN drawn anew every epoch on the same clean content (so
    lowering the train loss needs denoising, not memorising), fixed val
    pairs."""
    from vit_unet_tpu_torch.models.vit_unet import get_vit_unet
    from vit_unet_tpu_torch.parallel.train_step import adamw
    from vit_unet_tpu_torch.train.metrics import ssim

    epochs = EPOCHS["denoise"] if epochs is None else epochs
    model = get_vit_unet("lite", device=device, seed=0, im_size=IM,
                         dtype="bfloat16", param_dtype="bfloat16", use_flash=True,
                         flash_train=True, flash_frozen_bn=True, attn_drop=0.0,
                         proj_drop=0.0, input_skip=True, head_blocks=head_blocks,
                         head_dim=head_dim)
    clean = clean_images(N_TRAIN, 0)
    xv, yv = make_pairs(N_VAL, 777)
    noisy_psnr = _noisy_psnr(xv, yv)
    clean_d = C.on_device(clean, device)
    xv, yv = C.on_device(xv, device), C.on_device(yv, device)
    steps, state = _steps(model, adamw(model, 0.0), 1.0)
    count = _warmup_cosine(peak_lr, epochs)
    t0 = time.time()
    hist = []
    tag = f"denoise-head{head_blocks}"
    for ep in range(epochs):
        rng = np.random.default_rng(1000 + ep)
        xs = C.on_device(clean + rng.normal(scale=NOISE_SIGMA, size=clean.shape)
                         .astype(np.float32), device)
        state, m = C.train_epoch(steps, state, xs, clean_d, BATCH, ep, count)
        train_loss = float(m["loss"])
        v = C.evaluate(steps, state, xv, yv, BATCH)
        hist.append({"epoch": ep + 1, "train_loss": round(train_loss, 5),
                     "val_psnr": round(v["psnr"], 3), "val_ssim": round(v["ssim"], 4)})
        print(f"[{tag}] epoch {ep+1}: train {train_loss:.5f}, val PSNR "
              f"{v['psnr']:.2f} dB (noisy {noisy_psnr:.2f}), SSIM {v['ssim']:.4f}",
              flush=True)
    with torch.no_grad():
        noisy_ssim = float(np.mean([float(ssim(xv[s * BATCH:(s + 1) * BATCH],
                                               yv[s * BATCH:(s + 1) * BATCH]))
                                    for s in range(len(xv) // BATCH)]))
    best = max(h["val_psnr"] for h in hist)
    return {
        "tag": tag,
        "device": C.card(_device_of(model)),
        "scenario": ("the 128^2 synthetic-SIDD recreation, ViTUNet lite on the "
                     "frozen-BN training kernels with input_skip + "
                     f"head_blocks={head_blocks} (head_dim={head_dim}); AWGN "
                     "drawn anew each epoch on fixed clean content, fixed val "
                     "pairs"),
        "recipe": {"model": f"lite + input_skip + head_blocks={head_blocks}, "
                            f"head_dim={head_dim}, use_flash + flash_train + "
                            "flash_frozen_bn, bf16 params/compute, dropout 0",
                   "optimizer": f"AdamW warmup-cosine peak {peak_lr}, "
                                f"{WARMUP_STEPS}-step warmup, grad clip 1.0",
                   "batch": BATCH, "epochs": epochs,
                   "noise": f"AWGN sigma={NOISE_SIGMA} drawn each epoch "
                            "(train); fixed (val)"},
        "noisy_val_psnr_db": round(noisy_psnr, 2),
        "noisy_val_ssim": round(noisy_ssim, 4),
        "epochs": epochs,
        "history": hist,
        "best_val_psnr_db": best,
        "best_val_ssim": max(h["val_ssim"] for h in hist),
        "gain_db_over_noisy": round(best - noisy_psnr, 2),
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("runs", nargs="*", help=f"of {list(RUNS)} (none: all)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    unknown = set(args.runs) - set(RUNS)
    if unknown:
        p.error(f"unknown runs {sorted(unknown)}; choose from {list(RUNS)}")
    from vit_unet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    which = set(args.runs) or set(RUNS)
    update: dict = {}
    runs = []
    if {"matched", "ours"} & which:
        update["scenario"] = (
            "SIDD 128^2 denoising recreation on the reference's TPU model "
            "(HViTUNetTF), KerasMHA on the kernels, synthetic AWGN at the "
            "reference's measured noisy<->clean 20.4 dB; the port on the card")
        update["reference"] = {
            "val_psnr_db": 25.90, "pred_vs_noisy_db": 37.41,
            "noisy_vs_clean_db": 20.39,
            "reading": ("pred==input identity: 25.90 dB is the val set's "
                        "own noisy<->clean level")}
    if "matched" in which:
        runs.append(run("matched-recipe", "adam", EPOCHS["matched"], device=device))
    if "ours" in which:
        runs.append(run("ours", "ours", EPOCHS["ours"], drops=0.0, device=device))
    if runs:
        update["runs"] = runs
    if "denoise" in which:
        update["denoise_beyond_identity"] = run_denoise(device=device)
    C.merge_into_convergence(update)
    summary = {r["tag"]: r["best_val_psnr_db"] for r in runs}
    if "denoise_beyond_identity" in update:
        d = update["denoise_beyond_identity"]
        summary[d["tag"]] = d["best_val_psnr_db"]
        summary["gain_db_over_noisy"] = d["gain_db_over_noisy"]
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
