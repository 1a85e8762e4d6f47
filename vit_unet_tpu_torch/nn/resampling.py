"""TF-flavour Resampling layer, the counterpart of
``vit_unet_tpu/nn/resampling.py``: changes the patch size between levels
of the TF-flavour model, then adds a position embedding.

* ``max`` / ``avg``: merge each k x k neighbourhood of patches into one by
  its max or mean; split by nearest-neighbour token upsampling.
* ``standard``: repatch (a relayout), then Dense.
* ``conv``: a strided conv whose spatial axes are the intra-patch pixels
  and whose channel axis is the token axis (N_from -> N_to), shared by every
  image channel, then Dense.  Merging is a conv; splitting is flax's
  ``ConvTranspose`` with a kernel as large as its stride, which is
  ``conv_transpose2d`` with the kernel flipped in both spatial axes
  (``utils/jax_import.py`` flips it when it carries JAX weights across).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from einops import rearrange, reduce
from torch import nn

from vit_unet_tpu_torch.nn.patch_encoder import position_table
from vit_unet_tpu_torch.ops.patches import change_patch_size_cl, unflatten_cl

RESAMPLING_TYPES = ("max", "avg", "standard", "conv")


def _same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax's SAME padding (low, high) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Resampling(nn.Module):
    """(B, N_from, E_in) tokens at patch size ``patch_size[0]`` -> (B, N_to,
    dim) at ``patch_size[1]``.  E_in is ``projection_dim`` when given, else
    C·p_from²; dim is ``projection_dim`` or C·p_to².  Split over a mesh's
    ``model`` axis (``tp_mesh``), it holds its block of the position
    embedding's tokens (``patch_encoder.position_table``)."""

    tp_mesh = None

    def __init__(self, img_size: int, patch_size: Sequence[int],
                 num_channels: int = 3, projection_dim: int | None = None,
                 resampling_type: str = "standard",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if resampling_type not in RESAMPLING_TYPES:
            raise ValueError(f"resampling_type must be one of "
                             f"{RESAMPLING_TYPES}, got {resampling_type!r}")
        p_from, p_to = patch_size
        big, small = max(p_from, p_to), min(p_from, p_to)
        if big % small:
            raise ValueError(
                f"patch sizes {tuple(patch_size)} must be integer multiples "
                "of each other: a non-integer resampling ratio has no token "
                "merge/split interpretation")
        if resampling_type in ("max", "avg") and projection_dim is None:
            raise ValueError("max/avg resampling needs projection_dim")
        self.img_size = img_size
        self.p_from, self.p_to = p_from, p_to
        self.num_channels = c = num_channels
        self.resampling_type = resampling_type
        self.dtype = dtype
        self.n_from = (img_size // p_from) ** 2
        self.n_to = n_to = (img_size // p_to) ** 2
        dim = projection_dim or c * p_to ** 2
        if resampling_type == "standard":
            self.linear = nn.Linear(c * p_to ** 2, dim)
        elif resampling_type == "conv":
            p_in = round(((projection_dim or c * p_from ** 2) // c) ** 0.5)
            if n_to < self.n_from:
                k = (self.n_from // n_to) // 2
                self.conv = nn.Conv2d(self.n_from, n_to, k, stride=k)
                p_out = -(-p_in // k)
            else:
                k = (n_to // self.n_from) // 2
                self.conv = nn.ConvTranspose2d(self.n_from, n_to, k, stride=k)
                p_out = p_in * k
            self.linear = nn.Linear(c * p_out ** 2, dim)
        self.position_embedding = nn.Embedding(n_to, dim)

    def _dense(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x, self.linear.weight.to(dt), self.linear.bias.to(dt))

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        """x (B·C, N_from, p, p) -> (B·C, N_to, p', p')."""
        dt, conv = self.dtype, self.conv
        w, b = conv.weight.to(dt), conv.bias.to(dt)
        k = conv.kernel_size[0]
        if isinstance(conv, nn.ConvTranspose2d):
            return F.conv_transpose2d(x, w, b, stride=k)
        ph, pw = _same_pad(x.shape[-2], k, k), _same_pad(x.shape[-1], k, k)
        return F.conv2d(F.pad(x, (*pw, *ph)), w, b, stride=k)

    def forward(self, encoded: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = encoded.to(dt)
        pos = position_table(self, dt)
        if self.resampling_type in ("max", "avg"):
            g = self.img_size // self.p_from
            grid = x.reshape(x.shape[0], g, g, -1)
            if self.p_to > self.p_from:      # merge (encoder direction)
                k = self.p_to // self.p_from
                op = "max" if self.resampling_type == "max" else "mean"
                out = reduce(grid, "b (r i) (s j) e -> b (r s) e", op, i=k, j=k)
            else:                            # split: nearest-neighbour tokens
                k = self.p_from // self.p_to
                b, _, _, e = grid.shape
                out = grid[:, :, None, :, None, :].expand(b, g, k, g, k, e)
                out = out.reshape(b, -1, e)
            return out + pos
        if self.resampling_type == "standard":
            up = self.p_to > self.p_from
            factor = self.p_to // self.p_from if up else self.p_from // self.p_to
            out = change_patch_size_cl(x, self.num_channels,
                                       up_factor=factor if up else 1,
                                       down_factor=1 if up else factor)
            return self._dense(out) + pos
        b = x.shape[0]
        pats = unflatten_cl(x, self.num_channels)          # (B, N, p, p, C)
        y = self._conv(rearrange(pats, "b n h w c -> (b c) n h w"))
        out = rearrange(y, "(b c) m h w -> b m (h w c)", b=b)
        return self._dense(out) + pos
