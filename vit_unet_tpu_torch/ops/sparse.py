"""Sparse attention utilities: the counterpart of
``vit_unet_tpu/ops/sparse.py``.

``softmax_top`` is the reference's top-k sparse softmax: keep the k largest
scores of each row, softmax over them, exact zeros elsewhere, as a mask
and a dense softmax.
"""
from __future__ import annotations

import torch


def softmax_top(x: torch.Tensor, top: int, axis: int = -1) -> torch.Tensor:
    """Top-k sparse softmax along ``axis``: softmax over the k largest
    entries, exact zeros elsewhere.  Entries tied with the k-th largest
    all survive, as in the JAX version (ties are measure-zero for float
    inputs)."""
    if top >= x.shape[axis]:
        return torch.softmax(x, dim=axis)
    moved = x.movedim(axis, -1)
    kth = torch.topk(moved, top, dim=-1).values[..., -1:]
    mask = moved >= kth
    out = torch.softmax(moved.masked_fill(~mask, float("-inf")), dim=-1)
    return out.masked_fill(~mask, 0.0).movedim(-1, axis)
