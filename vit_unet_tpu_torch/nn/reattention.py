"""Re-attention (DeepViT-style) with conv-QKV in patch space.

Counterpart of ``vit_unet_tpu/nn/reattention.py``.  Q/K/V come from per-patch
CxC convolutions on the image form of each token (one conv over the fused
(B*N) batch); attention is scaled-dot softmax, re-mixed across heads by a
1x1 conv followed by BatchNorm, then multiplied with V.

Eval folds both head-mix layers into one (H, H) affine and runs
``flash_reattention``.  Training runs the training kernels
(``kernels/flash_reattention_train.py``) with attention dropout inside them:
exact batch-statistics BatchNorm by default, the frozen running statistics
for ``use_running_average=True`` or ``flash_frozen_bn``, and the ``bn_track``
mode (frozen forward, running statistics pulled toward each batch).  On the
card the kernels run, on the CPU their plain versions.  ``flash_train=False``
(or ``use_flash=False``) runs the plain N x N path, whose dropout draws the
same mask.

The running statistics follow flax's BatchNorm, not torch's: momentum 0.9
on the old value and the *biased* batch variance,
``running = 0.9 * running + 0.1 * batch``; ``nn.BatchNorm2d`` only holds the
parameters and buffers and its own forward never runs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.kernels.flash_reattention import (
    expand_reattention_affine, flash_reattention, flash_reattention_plain,
    fold_reattention_compact,
)
from vit_unet_tpu_torch.kernels.flash_reattention_train import (
    dropout_mask, flash_bn_batch_moments, flash_reattention_train,
    flash_reattention_train_bn, new_seed, reattention_nxn,
)
from vit_unet_tpu_torch.nn.dropout import dropout, require_generator
from vit_unet_tpu_torch.ops.patches import unflatten

BN_MOMENTUM = 0.9


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


class ReAttention(nn.Module):
    """Self re-attention over patch tokens.

    ``qkv_kernel=3`` matches the packaged model and the README configs,
    ``qkv_kernel=1`` the 512² notebook config.  ``use_flash=False`` runs the
    plain version of the attention contraction on every device (it
    materialises the N x N map); ``True`` runs the kernels, and in training
    only with ``flash_train`` (the default here; JAX defaults it to False).
    """

    def __init__(self, dim: int, num_channels: int = 3, num_heads: int = 8,
                 qkv_kernel: int = 3, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, use_flash: bool = True,
                 flash_train: bool = True, flash_frozen_bn: bool = False,
                 bn_track: bool = False, bn_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.num_channels = num_channels
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.use_flash = use_flash
        self.flash_train = flash_train
        self.flash_frozen_bn = flash_frozen_bn
        self.bn_track = bn_track
        self.bn_eps = bn_eps
        self.dtype = dtype
        c = num_channels
        conv = lambda: nn.Conv2d(c, c, qkv_kernel, padding="same", bias=False)
        self.qconv2d = conv()
        self.kconv2d = conv()
        self.vconv2d = conv()
        self.reatten_matrix = nn.Conv2d(num_heads, num_heads, 1)
        # parameter and running-statistics holder (see the module docstring)
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

    def _folded(self):
        """(m_eff, c_eff) from the head-mix conv and the running statistics,
        differentiable in the conv and BatchNorm parameters.  The statistics
        are copied: ``bn_track`` updates them in place before the backward."""
        bn = self.var_norm
        return fold_reattention_compact(
            self.reatten_matrix.weight, self.reatten_matrix.bias, bn.weight,
            bn.bias, bn.running_mean.clone(), bn.running_var.clone(),
            eps=self.bn_eps)

    @torch.no_grad()
    def _update_running(self, mean, var):
        """flax's update: running = 0.9 running + 0.1 batch, biased var."""
        bn = self.var_norm
        bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean.float())
        bn.running_var.mul_(BN_MOMENTUM).add_(
            (1 - BN_MOMENTUM) * var.float().clamp_min(0.0))

    def _attend(self, q, k, v, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        """q, k, v (B, H, N, dh) -> merged-head (B, N_q, E)."""
        qs = (q * self.scale).contiguous()
        k, v_cat = k.contiguous(), merge_heads(v).contiguous()
        if deterministic and use_running_average:
            m_eff, c_eff = self._folded()
            w, b = expand_reattention_affine(m_eff, c_eff,
                                             dh=self.dim // self.num_heads)
            fn = flash_reattention if self.use_flash else flash_reattention_plain
            return fn(qs, k, v_cat, w, b, num_heads=self.num_heads)
        rate = 0.0 if deterministic else float(self.attn_drop)
        seed = None
        if rate > 0.0:
            seed = new_seed(require_generator(generator, rate, "attention dropout"))
        if self.use_flash and self.flash_train:
            return self._attend_flash_train(qs, k, v_cat, seed, rate,
                                            use_running_average)
        return self._attend_plain_train(qs, k, v_cat, seed, rate,
                                        use_running_average)

    def _attend_flash_train(self, q, k, v_cat, seed, rate, use_running_average):
        """The training kernels, selected as the JAX module's
        ``_attend_flash_train`` selects them."""
        heads = self.num_heads
        if use_running_average or self.flash_frozen_bn:
            m_eff, c_eff = self._folded()
            return flash_reattention_train(q, k, v_cat, m_eff, c_eff, seed,
                                           num_heads=heads, rate=rate)
        conv = self.reatten_matrix
        if self.bn_track:
            m_eff, c_eff = self._folded()
            out = flash_reattention_train(q, k, v_cat, m_eff, c_eff, seed,
                                          num_heads=heads, rate=rate)
            mu, var = flash_bn_batch_moments(
                q.detach(), k.detach(), v_cat.detach(), conv.weight.detach(),
                conv.bias.detach(), seed, num_heads=heads, rate=rate)
            self._update_running(mu, var)
            return out
        bn = self.var_norm
        out, mu, var = flash_reattention_train_bn(
            q, k, v_cat, conv.weight, conv.bias, bn.weight, bn.bias, seed,
            num_heads=heads, rate=rate, eps=self.bn_eps)
        self._update_running(mu.detach(), var.detach())
        return out

    def _attend_plain_train(self, q, k, v_cat, seed, rate, use_running_average):
        """The N x N path of the JAX module's XLA branch
        (``reattention_nxn``): dropout with the kernels' mask, BatchNorm by
        the running statistics (frozen, ``bn_track``) or by the batch's,
        which update the running ones unless they are frozen."""
        batch, heads, n_q, _ = q.shape
        mask = None
        if rate > 0.0:
            mask = dropout_mask(int(seed.item()), rate, batch, heads, n_q,
                                k.shape[2], q.device)
        conv, bn = self.reatten_matrix, self.var_norm
        stats = None
        if use_running_average or self.bn_track:
            stats = (bn.running_mean.clone(), bn.running_var.clone())
        out, (mean, var) = reattention_nxn(
            q, k, v_cat, conv.weight[:, :, 0, 0], conv.bias, mask,
            norm=(bn.weight, bn.bias), stats=stats, eps=self.bn_eps)
        if not use_running_average:
            self._update_running(mean.detach(), var.detach())
        return out.to(q.dtype)

    def _project(self, out, deterministic: bool, generator):
        dt = self.dtype
        out = F.linear(out, self.proj.weight.to(dt), self.proj.bias.to(dt))
        return dropout(out, 0.0 if deterministic else self.proj_drop, generator)

    def forward(self, x, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        out = self._attend(*self._qkv(x, x, x), deterministic=deterministic,
                           use_running_average=use_running_average,
                           generator=generator)
        return self._project(out, deterministic, generator)


class SkipConnection(ReAttention):
    """Cross-attention skip fusion: query = encoder skip, key/value =
    decoder stream.  Its layers sit directly on the module (the reference's
    module tree); the JAX package keeps them under an inner ``attn`` scope."""

    def forward(self, q, k, v, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        out = self._attend(*self._qkv(q, k, v), deterministic=deterministic,
                           use_running_average=use_running_average,
                           generator=generator)
        return self._project(out, deterministic, generator)
