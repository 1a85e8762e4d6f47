"""Cubic image resize, the counterpart of ``jax.image.resize(x, shape,
"cubic")`` (``jax._src.image.scale``): Keys' cubic convolution with
a = -0.5, one weight matrix a resized axis, applied as a separable
contraction.  Where taps fall outside the image their weight is dropped
and each output's weights are renormalised to sum to one (no edge
clamping); output samples outside the input range are zero.  Shrinking
widens the kernel by the scale (JAX's ``antialias=True``).

``torch.nn.functional.interpolate(mode="bicubic")`` is not this function:
it uses a = -0.75 and clamps at the edges.
"""
from __future__ import annotations

import numpy as np


def keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel (a = -0.5) at distances ``x`` >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near)).astype(x.dtype)


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights: output j = sum_i w[i, j] input i, as
    JAX's ``compute_weight_mat`` builds them in float32."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = keys_cubic(dist.astype(f32))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_cubic(x: np.ndarray, shape) -> np.ndarray:
    """``x`` resized to ``shape`` (same rank) in float32: every axis whose
    size changes goes through ``cubic_weights``.  Bit for bit JAX's where
    the weights are exact in float32 (8 -> 128); elsewhere XLA's jitted
    weights may differ from these by an ulp or two."""
    out = np.asarray(x, np.float32)
    if len(shape) != out.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match rank {out.ndim}")
    for axis, n_out in enumerate(shape):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        w = cubic_weights(n_in, n_out)
        out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return np.ascontiguousarray(out, np.float32)
