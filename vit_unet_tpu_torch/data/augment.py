"""Image augmentations: the counterpart of ``vit_unet_tpu/data/augment.py``.

Per-sample transforms run on the host in numpy, with the port's own
``cv2`` equivalents (``data/image_io.py``), and draw from the sample
stream's ``np.random.Generator`` in the JAX package's order, so one seed
gives the same geometry in both packages.  Paired transforms apply the same
geometry to image and target.

Batch transforms (``mixup``, ``cutmix``, ``batch_transforms``) run where
the batch lies (the card) and draw from a ``torch.Generator`` on its
device.  Each is its draws followed by a deterministic apply
(``_mixup_apply``, ``_cutmix_apply``, ``_pick_apply``); the draws differ
from the JAX PRNG's by design.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from vit_unet_tpu_torch.data.image_io import (
    resize_linear, rotation_matrix_2d, warp_affine_reflect101,
)


@dataclasses.dataclass
class ShiftScaleRotate:
    """Random affine jitter, matching albumentations' parameter surface."""

    shift_limit: float = 0.0625
    scale_limit: float = 0.1
    rotate_limit: float = 45.0
    p: float = 0.5

    def __call__(self, rng: np.random.Generator,
                 image: np.ndarray, target: Optional[np.ndarray] = None):
        if rng.random() >= self.p:
            return image, target
        h, w = image.shape[:2]
        angle = rng.uniform(-self.rotate_limit, self.rotate_limit)
        scale = 1.0 + rng.uniform(-self.scale_limit, self.scale_limit)
        dx = rng.uniform(-self.shift_limit, self.shift_limit) * w
        dy = rng.uniform(-self.shift_limit, self.shift_limit) * h
        m = rotation_matrix_2d((w / 2, h / 2), angle, scale)
        m[0, 2] += dx
        m[1, 2] += dy
        image = warp_affine_reflect101(image, m, (w, h))
        if target is not None:
            target = warp_affine_reflect101(target, m, (w, h))
        return image, target


@dataclasses.dataclass
class HorizontalFlip:
    p: float = 0.5

    def __call__(self, rng, image, target=None):
        if rng.random() < self.p:
            image = image[:, ::-1]
            target = target[:, ::-1] if target is not None else None
        return image, target


@dataclasses.dataclass
class Resize:
    height: int
    width: int

    def __call__(self, rng, image, target=None):
        image = resize_linear(image, (self.width, self.height))
        if target is not None:
            target = resize_linear(target, (self.width, self.height))
        return image, target


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, rng, image, target=None):
        for t in self.transforms:
            image, target = t(rng, image, target)
        return image, target


def train_transforms(im_size: int) -> Compose:
    """The reference's train-time pipeline: resize, then the affine jitter."""
    return Compose([Resize(im_size, im_size), ShiftScaleRotate(p=0.5)])


def eval_transforms(im_size: int) -> Compose:
    return Compose([Resize(im_size, im_size)])


# --------------------------------------------------------------------------
# Batch transforms (the reference notebook's cutmix / mixup hooks, off by
# default): on the batch's device, drawn from a torch.Generator there.
# --------------------------------------------------------------------------

def _gamma(shape: float, n: int, generator: torch.Generator,
           device) -> torch.Tensor:
    """n draws of Gamma(shape, 1) (Marsaglia and Tsang's rejection method;
    shape < 1 through Gamma(shape + 1) · U^(1/shape)), from ``generator``."""
    boost = shape < 1.0
    d = (shape + 1.0 if boost else shape) - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    out = torch.empty(n, device=device)
    todo = torch.ones(n, dtype=torch.bool, device=device)
    while bool(todo.any()):
        z = torch.randn(n, generator=generator, device=device)
        u = torch.rand(n, generator=generator, device=device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo &= ~ok
    if boost:
        u = torch.rand(n, generator=generator, device=device)
        out = out * u ** (1.0 / shape)
    return out


def _beta(alpha: float, n: int, generator: torch.Generator,
          device) -> torch.Tensor:
    """n draws of Beta(alpha, alpha), float32."""
    a = _gamma(alpha, n, generator, device)
    b = _gamma(alpha, n, generator, device)
    return a / (a + b)


def _per_sample(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((v.shape[0],) + (1,) * (like.ndim - 1)).to(like.dtype)


def _mixup_apply(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor):
    """Per-sample convex mix with the batch rolled by one, weights ``lam``
    (B,), for images and targets alike."""
    lx, ly = _per_sample(lam, x), _per_sample(lam, y)
    x2, y2 = torch.roll(x, 1, dims=0), torch.roll(y, 1, dims=0)
    return lx * x + (1 - lx) * x2, ly * y + (1 - ly) * y2


def mixup(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
          alpha: float = 0.2, prob: float = 0.5):
    """Mixup: lam ~ Beta(alpha, alpha) for the samples a uniform draw below
    ``prob`` picks, 1 (no mix) for the others."""
    b = x.shape[0]
    lam = _beta(alpha, b, generator, x.device)
    apply = torch.rand(b, generator=generator, device=x.device) < prob
    return _mixup_apply(x, y, torch.where(apply, lam, torch.ones_like(lam)))


def _cutmix_apply(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
                  cx: torch.Tensor, cy: torch.Tensor):
    """CutMix on (B, C, H, W): paste the box of side sqrt(1 - lam) · (W, H)
    centred at (cx, cy), clipped to the image, from the batch rolled by one;
    targets mix by the pasted area's share."""
    b, _, h, w = x.shape
    cut = torch.sqrt(1.0 - lam.float())
    cw = (cut * w).to(torch.int64)
    ch = (cut * h).to(torch.int64)
    cx, cy = cx.to(torch.int64), cy.to(torch.int64)
    x1 = torch.clamp(cx - cw // 2, 0, w)
    x2 = torch.clamp(cx + cw // 2, 0, w)
    y1 = torch.clamp(cy - ch // 2, 0, h)
    y2 = torch.clamp(cy + ch // 2, 0, h)
    cols = torch.arange(w, device=x.device)[None, None, None, :]
    rows = torch.arange(h, device=x.device)[None, None, :, None]
    box = lambda v: v[:, None, None, None]
    in_box = ((cols >= box(x1)) & (cols < box(x2))
              & (rows >= box(y1)) & (rows < box(y2)))
    mixed_x = torch.where(in_box, torch.roll(x, 1, dims=0), x)
    area = ((x2 - x1) * (y2 - y1)).float() / float(h * w)
    ly = _per_sample(1.0 - area, y)
    return mixed_x, ly * y + (1 - ly) * torch.roll(y, 1, dims=0)


def cutmix(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
           alpha: float = 1.0, prob: float = 0.5):
    """CutMix with lam ~ Beta(alpha, alpha) where a uniform draw below
    ``prob`` picks the sample (1, an empty box, elsewhere) and a box centre
    uniform over the pixels."""
    b, _, h, w = x.shape
    lam = _beta(alpha, b, generator, x.device)
    apply = torch.rand(b, generator=generator, device=x.device) < prob
    lam = torch.where(apply, lam, torch.ones_like(lam))
    cx = torch.randint(0, w, (b,), generator=generator, device=x.device)
    cy = torch.randint(0, h, (b,), generator=generator, device=x.device)
    return _cutmix_apply(x, y, lam, cx, cy)


def _pick_apply(pick: torch.Tensor, first: tuple, second: tuple):
    """Per sample, ``first`` where ``pick`` (B,) holds, else ``second``."""
    return tuple(torch.where(_per_sample(pick, a).bool(), a, b)
                 for a, b in zip(first, second))


def batch_transforms(generator: torch.Generator, x: torch.Tensor,
                     y: torch.Tensor, prob: float = 0.66):
    """The notebook's combined hook: the cutmix and the mixup variant of
    the batch, one of them per sample with probability 1/2 each."""
    cut = cutmix(generator, x, y, prob=prob)
    mix = mixup(generator, x, y, prob=prob)
    pick = torch.rand(x.shape[0], generator=generator, device=x.device) <= 0.5
    return _pick_apply(pick, cut, mix)
