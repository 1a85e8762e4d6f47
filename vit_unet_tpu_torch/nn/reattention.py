"""Re-attention (DeepViT-style) with conv-QKV in patch space, eval path.

Counterpart of ``vit_unet_tpu/nn/reattention.py``.  Q/K/V come from per-patch
CxC convolutions on the image form of each token (one conv over the fused
(B*N) batch); attention is scaled-dot softmax, re-mixed across heads by a
1x1 conv followed by BatchNorm (running statistics), then multiplied with V.
Both head-mix layers fold into one (H, H) affine, so the whole contraction
is one ``flash_reattention`` call: the hand-written kernel on the card, its
plain version on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.kernels.flash_reattention import (
    expand_reattention_affine, flash_reattention, flash_reattention_plain,
    fold_reattention_compact,
)
from vit_unet_tpu_torch.nn.eval_only import EvalOnlyModule
from vit_unet_tpu_torch.ops.patches import unflatten


def conv_tokens(x: torch.Tensor, weight: torch.Tensor,
                num_channels: int) -> torch.Tensor:
    """Apply a bias-free conv to every token's (C, p, p) patch image.

    x: (B, N, C*p*p) channel-major tokens; weight: (O, C, k, k) with O a
    multiple of C.  Returns (B, N, O*p*p): with O = 3C (q/k/v weights
    concatenated) the last axis holds the q, k and v token vectors in turn.
    """
    b, n, _ = x.shape
    pats = unflatten(x, num_channels)
    p = pats.shape[-1]
    out = F.conv2d(pats.reshape(b * n, num_channels, p, p), weight,
                   padding="same")
    return out.reshape(b, n, -1)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, E) -> (B, H, N, E/H); head h owns the contiguous channel-major
    slice [h*E/H, (h+1)*E/H) of the flattened patch."""
    b, n, e = x.shape
    return x.reshape(b, n, num_heads, e // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, dh) -> (B, N, E)."""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


class ReAttention(EvalOnlyModule):
    """Self re-attention over patch tokens, eval mode.

    ``qkv_kernel=3`` matches the packaged model and the README configs,
    ``qkv_kernel=1`` the 512² notebook config.  ``use_flash=False`` runs the
    plain version of the attention contraction on every device (it
    materialises the N x N map); ``True`` runs ``flash_reattention``.
    """

    def __init__(self, dim: int, num_channels: int = 3, num_heads: int = 8,
                 qkv_kernel: int = 3, use_flash: bool = True,
                 bn_eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.num_channels = num_channels
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.bn_eps = bn_eps
        self.dtype = dtype
        c = num_channels
        conv = lambda: nn.Conv2d(c, c, qkv_kernel, padding="same", bias=False)
        self.qconv2d = conv()
        self.kconv2d = conv()
        self.vconv2d = conv()
        self.reatten_matrix = nn.Conv2d(num_heads, num_heads, 1)
        # parameter and running-statistics holder; eval folds it
        self.var_norm = nn.BatchNorm2d(num_heads, eps=bn_eps)
        self.proj = nn.Linear(dim, dim)

    @property
    def scale(self) -> float:
        return (self.dim // self.num_heads) ** -0.5

    def _qkv(self, q_in, k_in, v_in):
        """(B, N, E) inputs -> q, k, v as (B, H, N, dh); one C->3C conv
        when the three inputs are one tensor."""
        dt = self.dtype
        convs = (self.qconv2d, self.kconv2d, self.vconv2d)
        if q_in is k_in and k_in is v_in:
            w = torch.cat([cv.weight for cv in convs]).to(dt)
            ys = conv_tokens(q_in.to(dt), w, self.num_channels).chunk(3, dim=-1)
        else:
            ys = (conv_tokens(t.to(dt), cv.weight.to(dt), self.num_channels)
                  for t, cv in zip((q_in, k_in, v_in), convs))
        return tuple(split_heads(y, self.num_heads) for y in ys)

    def _attend(self, q, k, v):
        """q, k, v (B, H, N, dh) -> merged-head (B, N_q, E)."""
        bn = self.var_norm
        m_eff, c_eff = fold_reattention_compact(
            self.reatten_matrix.weight, self.reatten_matrix.bias, bn.weight,
            bn.bias, bn.running_mean, bn.running_var, eps=self.bn_eps)
        w, b = expand_reattention_affine(m_eff, c_eff,
                                         dh=self.dim // self.num_heads)
        fn = flash_reattention if self.use_flash else flash_reattention_plain
        return fn((q * self.scale).contiguous(), k.contiguous(),
                  merge_heads(v).contiguous(), w, b, num_heads=self.num_heads)

    def _project(self, out):
        dt = self.dtype
        return F.linear(out, self.proj.weight.to(dt), self.proj.bias.to(dt))

    def forward(self, x):
        return self._project(self._attend(*self._qkv(x, x, x)))


class SkipConnection(ReAttention):
    """Cross-attention skip fusion: query = encoder skip, key/value =
    decoder stream.  Its layers sit directly on the module (the reference's
    module tree); the JAX package keeps them under an inner ``attn`` scope."""

    def forward(self, q, k, v):
        return self._project(self._attend(*self._qkv(q, k, v)))
