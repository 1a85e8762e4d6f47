"""Transformer encoder block (torch flavour), the counterpart of
``vit_unet_tpu/nn/blocks.py::ReAttentionEncoderBlock``: post-norm with a
joint LayerNorm over (tokens, features), eps 1e-5.  ``ln_mode='shared'``
applies one LayerNorm's weights after both residuals (the README parameter
counts); ``'dual'`` uses separate LN1/LN2.  The Fourier and TF-flavour
blocks are not ported yet."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.nn.feedforward import FeedForward
from vit_unet_tpu_torch.nn.reattention import ReAttention


class ReAttentionEncoderBlock(nn.Module):
    def __init__(self, num_patches: int, projection_dim: int, hidden_dim: int,
                 num_heads: int, num_channels: int = 3, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, linear_drop: float = 0.0,
                 qkv_kernel: int = 3, ln_mode: str = "shared",
                 use_flash: bool = True, flash_train: bool = True,
                 flash_frozen_bn: bool = False, bn_track: bool = False,
                 bn_eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        if ln_mode not in ("shared", "dual"):
            raise ValueError(f"ln_mode must be 'shared' or 'dual', got {ln_mode!r}")
        self.ln_mode = ln_mode
        self.dtype = dtype
        self.ReAttn = ReAttention(
            projection_dim, num_channels=num_channels, num_heads=num_heads,
            qkv_kernel=qkv_kernel, attn_drop=attn_drop, proj_drop=proj_drop,
            use_flash=use_flash, flash_train=flash_train,
            flash_frozen_bn=flash_frozen_bn, bn_track=bn_track, bn_eps=bn_eps,
            dtype=dtype)
        shape = (num_patches, projection_dim)
        if ln_mode == "shared":
            self.LN = nn.LayerNorm(shape, eps=1e-5)
        else:
            self.LN1 = nn.LayerNorm(shape, eps=1e-5)
            self.LN2 = nn.LayerNorm(shape, eps=1e-5)
        self.FeedForward = FeedForward(projection_dim, hidden_dim,
                                       dropout=linear_drop, dtype=dtype)

    def _norm(self, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.layer_norm(x, ln.normalized_shape, ln.weight.to(dt),
                            ln.bias.to(dt), ln.eps)

    def forward(self, x, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        ln1 = self.LN if self.ln_mode == "shared" else self.LN1
        ln2 = self.LN if self.ln_mode == "shared" else self.LN2
        x = self._norm(ln1, self.ReAttn(
            x, deterministic=deterministic,
            use_running_average=use_running_average, generator=generator) + x)
        ff = self.FeedForward(x, deterministic=deterministic, generator=generator)
        return self._norm(ln2, ff + x)
