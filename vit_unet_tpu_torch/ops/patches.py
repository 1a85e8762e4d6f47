"""Patch-space shape algebra, channel-major (torch flavour), in PyTorch.

Images are ``(B, C, H, W)``; a flattened patch vector is ordered
``(C, ph, pw)``; the patch index is row-major over the patch grid.  Every
function is a pure layout change (reshape + permute through einops), the
counterpart of ``vit_unet_tpu/ops/patches.py``.  The channels-last half of
that module belongs to the TF-flavour family and is not ported yet.
"""
from __future__ import annotations

import torch
from einops import rearrange

__all__ = [
    "patchify",
    "unpatchify",
    "flatten_patches",
    "unflatten",
    "split_patches",
    "merge_patches",
    "change_patch_size",
]


def _grid(n: int) -> int:
    g = round(n ** 0.5)
    if g * g != n:
        raise ValueError(f"num_patches={n} is not a perfect square")
    return g


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, N, C, p, p), row-major patch grid."""
    if x.ndim == 5:  # (B, 1, C, H, W), the reference's unpatch output
        x = x.squeeze(1)
    h, w = x.shape[-2], x.shape[-1]
    if h % patch_size or w % patch_size:
        raise ValueError(f"patch_size={patch_size} must divide image {h}x{w}")
    return rearrange(
        x, "b c (gh p1) (gw p2) -> b (gh gw) c p1 p2", p1=patch_size, p2=patch_size
    )


def unpatchify(x: torch.Tensor, num_channels: int | None = None) -> torch.Tensor:
    """(B, N, C, p, p) or (B, N, C*p*p) -> (B, C, H, W)."""
    if x.ndim == 3:
        if num_channels is None:
            raise ValueError("num_channels required for flattened input")
        x = unflatten(x, num_channels)
    g = _grid(x.shape[1])
    return rearrange(x, "b (gh gw) c p1 p2 -> b c (gh p1) (gw p2)", gh=g, gw=g)


def flatten_patches(x: torch.Tensor) -> torch.Tensor:
    """(B, N, C, p, p) -> (B, N, C*p*p)."""
    return rearrange(x, "b n c p1 p2 -> b n (c p1 p2)")


def unflatten(x: torch.Tensor, num_channels: int) -> torch.Tensor:
    """(B, N, C*p*p) -> (B, N, C, p, p)."""
    b, n, e = x.shape
    p = _grid(e // num_channels)
    return x.reshape(b, n, num_channels, p, p)


def split_patches(x: torch.Tensor, num_channels: int, factor: int = 2) -> torch.Tensor:
    """Halve the patch size: (B, N, C*p*p) -> (B, N*factor², C*(p/factor)²)."""
    return change_patch_size(x, num_channels, down_factor=factor)


def merge_patches(x: torch.Tensor, num_channels: int, factor: int = 2) -> torch.Tensor:
    """Double the patch size: (B, N, E) -> (B, N/factor², E*factor²)."""
    return change_patch_size(x, num_channels, up_factor=factor)


def change_patch_size(
    x: torch.Tensor,
    num_channels: int,
    *,
    down_factor: int = 1,
    up_factor: int = 1,
) -> torch.Tensor:
    """Repatch flat patch tokens (B, N, E) at a new patch size.

    ``down_factor=k`` splits each patch into k×k sub-patches (N*k², E/k²);
    ``up_factor=k`` merges k×k patch neighbourhoods (N/k², E*k²).  At most
    one may be > 1.
    """
    if down_factor > 1 and up_factor > 1:
        raise ValueError("choose either down_factor or up_factor, not both")
    b, n, e = x.shape
    g = _grid(n)
    p = _grid(e // num_channels)
    if down_factor > 1:
        k = down_factor
        if p % k:
            raise ValueError(f"patch size {p} not divisible by {k}")
        return rearrange(
            x.reshape(b, g, g, num_channels, p, p),
            "b r s c (i q1) (j q2) -> b (r i s j) (c q1 q2)",
            i=k, j=k,
        )
    if up_factor > 1:
        k = up_factor
        if g % k:
            raise ValueError(f"patch grid {g} not divisible by {k}")
        return rearrange(
            x.reshape(b, g // k, k, g // k, k, num_channels, p, p),
            "b r i s j c q1 q2 -> b (r s) (c i q1 j q2)",
        )
    return x
