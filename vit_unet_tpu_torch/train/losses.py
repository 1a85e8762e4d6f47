"""Losses, the counterpart of ``vit_unet_tpu/train/losses.py``: MSE (the
reference's training objective), the README soft-Dice, and the usual
restoration and segmentation extras.  Each takes (pred, target) tensors and
returns a scalar."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def charbonnier(pred: torch.Tensor, target: torch.Tensor,
                eps: float = 1e-3) -> torch.Tensor:
    """Robust L1 variant used by SIDD/GoPro restoration."""
    return torch.mean(torch.sqrt(torch.square(pred - target) + eps * eps))


def soft_dice_loss(pred: torch.Tensor, target: torch.Tensor,
                   smooth: float = 1.0) -> torch.Tensor:
    """1 - (2 * intersection + s) / (sum(p) + sum(t) + s), flattened."""
    p, t = pred.reshape(-1), target.reshape(-1)
    return 1.0 - (2.0 * torch.sum(p * t) + smooth) / (p.sum() + t.sum() + smooth)


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy from logits."""
    log_p = logits.clamp(max=0) - torch.log1p(torch.exp(-torch.abs(logits)))
    log_not_p = log_p - logits
    return -torch.mean(target * log_p + (1.0 - target) * log_not_p)


def categorical_crossentropy(logits: torch.Tensor, target: torch.Tensor,
                             label_smoothing: float = 0.0) -> torch.Tensor:
    """Softmax cross-entropy from logits against one-hot targets, with
    label smoothing."""
    if label_smoothing:
        target = target * (1.0 - label_smoothing) + label_smoothing / logits.shape[-1]
    return -torch.mean(torch.sum(target * F.log_softmax(logits, dim=-1), dim=-1))


def ssim_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - SSIM on (B, C, H, W) images."""
    from vit_unet_tpu_torch.train.metrics import ssim
    return 1.0 - ssim(pred, target)


def charbonnier_ssim(pred: torch.Tensor, target: torch.Tensor,
                     alpha: float = 0.84) -> torch.Tensor:
    """alpha (1 - SSIM) + (1 - alpha) Charbonnier."""
    return alpha * ssim_loss(pred, target) + (1.0 - alpha) * charbonnier(pred, target)


def dice_bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft-Dice on sigmoid probabilities plus BCE with logits."""
    return soft_dice_loss(torch.sigmoid(logits), target) + bce_with_logits(logits, target)


LOSSES = {
    "mse": mse,
    "mae": mae,
    "charbonnier": charbonnier,
    "ssim": ssim_loss,
    "charbonnier_ssim": charbonnier_ssim,
    "soft_dice": soft_dice_loss,
    "bce": bce_with_logits,
    "dice_bce": dice_bce,
    "categorical_crossentropy": categorical_crossentropy,
}


def get_loss(name: str):
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r}; choose from {sorted(LOSSES)}")
    return LOSSES[name]
