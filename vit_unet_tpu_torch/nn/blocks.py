"""Transformer encoder blocks, the counterparts of
``vit_unet_tpu/nn/blocks.py``.

* ``ReAttentionEncoderBlock`` (torch flavour): post-norm with a joint
  LayerNorm over (tokens, features), eps 1e-5.  ``ln_mode='shared'``
  applies one LayerNorm's weights after both residuals (the README
  parameter counts); ``'dual'`` uses separate LN1/LN2.
* ``FourierEncoderBlock``: the attention sublayer replaced by
  ``x + Re(fft2(x))`` over (tokens, features), one joint LayerNorm applied
  after both residuals.
* ``TFTransformerEncoder`` (TF flavour): ``num_layers`` post-norm blocks
  with a last-axis LayerNorm at eps 1e-3, keras-style attention
  (``KerasMHA``) or re-attention on channels-last tokens."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.nn.feedforward import FeedForward
from vit_unet_tpu_torch.nn.mha import KerasMHA
from vit_unet_tpu_torch.nn.reattention import ReAttention


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(dtype),
                        ln.bias.to(dtype), ln.eps)


class ReAttentionEncoderBlock(nn.Module):
    def __init__(self, num_patches: int, projection_dim: int, hidden_dim: int,
                 num_heads: int, num_channels: int = 3, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, linear_drop: float = 0.0,
                 qkv_kernel: int = 3, ln_mode: str = "shared",
                 use_flash: bool = True, flash_train: bool = True,
                 flash_frozen_bn: bool = False, bn_track: bool = False,
                 bn_eps: float = 1e-5, sequence_parallel: bool = False,
                 sp_mesh=None, sp_min_tokens: int = 1024,
                 dtype: torch.dtype = torch.float32):
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
            sequence_parallel=sequence_parallel, sp_mesh=sp_mesh,
            sp_min_tokens=sp_min_tokens, dtype=dtype)
        shape = (num_patches, projection_dim)
        if ln_mode == "shared":
            self.LN = nn.LayerNorm(shape, eps=1e-5)
        else:
            self.LN1 = nn.LayerNorm(shape, eps=1e-5)
            self.LN2 = nn.LayerNorm(shape, eps=1e-5)
        self.FeedForward = FeedForward(projection_dim, hidden_dim,
                                       dropout=linear_drop, dtype=dtype)

    def forward(self, x, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        ln1 = self.LN if self.ln_mode == "shared" else self.LN1
        ln2 = self.LN if self.ln_mode == "shared" else self.LN2
        x = _layer_norm(ln1, self.ReAttn(
            x, deterministic=deterministic,
            use_running_average=use_running_average, generator=generator) + x,
            self.dtype)
        ff = self.FeedForward(x, deterministic=deterministic, generator=generator)
        return _layer_norm(ln2, ff + x, self.dtype)


class FourierEncoderBlock(nn.Module):
    """The FNet-style block: the FFT in float32 (``torch.fft`` takes no
    bfloat16), its real part cast back to the block's dtype."""

    def __init__(self, num_patches: int, projection_dim: int, hidden_dim: int,
                 linear_drop: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.LN = nn.LayerNorm((num_patches, projection_dim), eps=1e-5)
        self.FeedForward = FeedForward(projection_dim, hidden_dim,
                                       dropout=linear_drop, dtype=dtype)

    def forward(self, x, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        del use_running_average   # no BatchNorm; kept for a uniform call
        x = x.to(self.dtype)
        x = _layer_norm(self.LN, x + torch.fft.fft2(x.float()).real.to(x.dtype),
                        self.dtype)
        ff = self.FeedForward(x, deterministic=deterministic, generator=generator)
        return _layer_norm(self.LN, x + ff, self.dtype)


class TFTransformerEncoder(nn.Module):
    """``num_layers`` post-norm blocks: attention, LayerNorm of the
    residual, FeedForward with its final GELU, LayerNorm of the residual.
    ``original_attn=True``: ``KerasMHA`` self-attention (``attn``);
    ``False``: ``ReAttention`` with GELU'd 3x3 QKV convs on channels-last
    tokens (``reattn``).  The JAX module's ``num_patches`` is not taken: a
    last-axis LayerNorm holds no token count."""

    def __init__(self, projection_dim: int, hidden_dim: int, num_heads: int,
                 num_layers: int, num_channels: int = 3, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, original_attn: bool = True,
                 use_flash: bool = True, flash_train: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.original_attn = original_attn
        self.dtype = dtype
        layers = range(num_layers)
        if original_attn:
            self.attn = nn.ModuleList(
                KerasMHA(projection_dim, num_heads, key_dim=projection_dim,
                         dropout=attn_drop, use_flash=use_flash, dtype=dtype)
                for _ in layers)
        else:
            self.reattn = nn.ModuleList(
                ReAttention(projection_dim, num_channels=num_channels,
                            num_heads=num_heads, qkv_kernel=3, qkv_gelu=True,
                            token_layout="cl", attn_drop=attn_drop,
                            use_flash=use_flash, flash_train=flash_train,
                            dtype=dtype)
                for _ in layers)
        # eps 1e-3: keras LayerNormalization's default
        self.ln1 = nn.ModuleList(nn.LayerNorm(projection_dim, eps=1e-3)
                                 for _ in layers)
        self.ff = nn.ModuleList(
            FeedForward(projection_dim, hidden_dim, dropout=proj_drop,
                        final_gelu=True, dtype=dtype)
            for _ in layers)
        self.ln2 = nn.ModuleList(nn.LayerNorm(projection_dim, eps=1e-3)
                                 for _ in layers)

    def forward(self, x, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        for i, (ln1, ff, ln2) in enumerate(zip(self.ln1, self.ff, self.ln2)):
            if self.original_attn:
                a = self.attn[i](x, x, deterministic=deterministic,
                                 generator=generator)
            else:
                a = self.reattn[i](x, deterministic=deterministic,
                                   use_running_average=use_running_average,
                                   generator=generator)
            x = _layer_norm(ln1, a + x, self.dtype)
            x = _layer_norm(ln2, ff(x, deterministic=deterministic,
                                    generator=generator) + x, self.dtype)
        return x
