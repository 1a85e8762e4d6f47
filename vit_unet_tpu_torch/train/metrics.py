"""Evaluation metrics on the device, the counterpart of
``vit_unet_tpu/train/metrics.py``: PSNR, SSIM, Dice, P/R/F1, accuracy."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Per-image PSNR (dB) over (C, H, W), averaged over the batch."""
    axes = tuple(range(1, pred.ndim))
    mse = torch.mean(torch.square(pred - target), dim=axes)
    return torch.mean(10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity with the Gaussian (11, 1.5) window.  Takes
    (B, C, H, W), or (B, H, W, C) when the last axis is thin (<= 8)."""
    if pred.ndim == 4 and pred.shape[-1] <= 8 and pred.shape[-1] < pred.shape[1]:
        pred, target = pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)
    pred, target = pred.float(), target.float()
    c = pred.shape[1]
    kernel = _gaussian_kernel(device=pred.device)[None, None].repeat(c, 1, 1, 1)
    filt = lambda x: F.conv2d(x, kernel, groups=c)
    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_pp = filt(pred * pred) - mu_pp
    sigma_tt = filt(target * target) - mu_tt
    sigma_pt = filt(pred * target) - mu_pt
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    num = (2 * mu_pt + c1) * (2 * sigma_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sigma_pp + sigma_tt + c2)
    return torch.mean(num / den)


def dice_score(pred: torch.Tensor, target: torch.Tensor,
               smooth: float = 1.0) -> torch.Tensor:
    """Soft Dice coefficient (1 - dice loss)."""
    p, t = pred.reshape(-1), target.reshape(-1)
    return (2.0 * torch.sum(p * t) + smooth) / (p.sum() + t.sum() + smooth)


def precision_recall_f1(pred: torch.Tensor, target: torch.Tensor,
                        threshold: float = 0.5) -> dict:
    """Binary precision, recall and F1."""
    p = (pred >= threshold).float()
    t = (target >= threshold).float()
    tp = torch.sum(p * t)
    fp = torch.sum(p * (1 - t))
    fn = torch.sum((1 - p) * t)
    precision = tp / (tp + fp).clamp_min(1.0)
    recall = tp / (tp + fn).clamp_min(1.0)
    f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-12)
    return {"precision": precision, "recall": recall, "f1": f1}


def accuracy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Categorical accuracy from logits against one-hot targets."""
    return torch.mean((logits.argmax(-1) == target.argmax(-1)).float())


def f1(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """F1 of the rounded softmax probabilities over all entries."""
    p = torch.round(torch.clamp(torch.softmax(logits, dim=-1), 0, 1))
    return precision_recall_f1(p, target)["f1"]


def dice_from_logits(logits: torch.Tensor, target: torch.Tensor,
                     threshold: float = 0.5) -> torch.Tensor:
    """Hard Dice of the thresholded sigmoid probabilities."""
    pred = (torch.sigmoid(logits) >= threshold).float()
    return dice_score(pred, target, smooth=1e-6)


METRICS = {
    "psnr": psnr,
    "ssim": ssim,
    "dice": dice_score,
    "dice_logits": dice_from_logits,
    "accuracy": accuracy,
    "f1": f1,
}


def get_metric(name: str):
    if name not in METRICS:
        raise ValueError(f"unknown metric {name!r}; choose from {sorted(METRICS)}")
    return METRICS[name]
