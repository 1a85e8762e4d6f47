"""Keras-style multi-head attention, the counterpart of
``vit_unet_tpu/nn/mha.py::KerasMHA`` (the TF-flavour model's attention).

Separate q/k/v projections to (heads, key_dim) with bias, scores scaled by
``key_dim ** -0.5``, softmax over keys, dropout, and an output projection
from (heads, key_dim) back to the query's width.  ``key_dim`` is the full
width of each head (the reference passes the projection dim), so the inner
width is ``num_heads * key_dim``.

On the kernel path the attention is re-attention with an identity head mix
(m_eff = I, c_eff = 0): ``flash_reattention`` in eval and
``flash_reattention_train`` in training, with the dropout drawn inside the
kernels.  The plain path (einsum, softmax, dropout, einsum) draws the same
mask for the same seed (``dropout_mask``), so the two paths agree with
dropout on.  Query and key rows may differ (the skip connections'
cross-attention).

Split over a mesh's ``model`` axis (``tp_mesh``, set by
``parallel/partition.py::shard_module``): each rank holds ``query``,
``key`` and ``value`` for its own block of heads and the matching columns
of ``out``; it projects and attends to those heads only (kernels 1-3 at
heads / model heads), and ``out`` is row-parallel with one all-reduce, its
bias added once after it.  This is exact only because the head mix here is
the identity: no head reads another's map.  The rank's dropout is its
heads' block of the whole layer's mask (the kernels' ``head_base``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.kernels.flash_reattention import (
    expand_reattention_affine, flash_reattention, kernel_takes,
)
from vit_unet_tpu_torch.kernels.flash_reattention_train import (
    dropout_mask, flash_reattention_train, new_seed,
)
from vit_unet_tpu_torch.nn.dropout import require_generator
from vit_unet_tpu_torch.parallel.partition import copy_to_model, reduce_from_model


class KerasMHA(nn.Module):
    """``dim``: the width of the query, key and value inputs and of the
    output.  ``use_flash=False`` runs the plain path on every device; a
    (heads, key_dim) beyond the kernels' limits (``kernel_takes``) does so
    whatever the flag says."""

    tp_mesh = None

    def __init__(self, dim: int, num_heads: int, key_dim: int,
                 value_dim: Optional[int] = None, dropout: float = 0.0,
                 use_flash: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.value_dim = value_dim or key_dim
        self.dropout = dropout
        self.use_flash = use_flash
        self.dtype = dtype
        self.query = nn.Linear(dim, num_heads * key_dim)
        self.key = nn.Linear(dim, num_heads * key_dim)
        self.value = nn.Linear(dim, num_heads * self.value_dim)
        self.out = nn.Linear(num_heads * self.value_dim, dim)

    @property
    def _heads(self) -> tuple[int, int]:
        """(heads this rank attends to, the first one's index in the
        layer): all of them, or under ``tp_mesh`` its block."""
        mesh = self.tp_mesh
        if mesh is None:
            return self.num_heads, 0
        local = self.num_heads // mesh.shape["model"]
        return local, local * mesh.index("model")

    @property
    def _kernels(self) -> bool:
        """Whether this layer's calls run the kernels."""
        return (self.use_flash and self.value_dim == self.key_dim
                and kernel_takes(self._heads[0], self.key_dim))

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                key: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, Nq, dim) queries, (B, Nk, dim) values (and keys, default the
        values) -> (B, Nq, dim).  ``deterministic=False`` turns the
        attention dropout on, drawn from ``generator``."""
        if key is None:
            key = value
        mesh = self.tp_mesh
        if mesh is not None:
            # column-parallel inputs: each rank's part of their cotangents
            # is summed over the line (a tensor fed to several projections
            # once)
            copies: dict = {}
            for t in (query, key, value):
                if id(t) not in copies:
                    copies[id(t)] = copy_to_model(t, mesh)
            query, key, value = (copies[id(t)] for t in (query, key, value))
        q = self._dense(self.query, query)
        k = self._dense(self.key, key)
        v = self._dense(self.value, value)
        rate = 0.0 if deterministic else float(self.dropout)
        seed = None
        if rate > 0.0:
            seed = new_seed(require_generator(generator, rate, "attention dropout"))
        if self._kernels:
            ctx = self._attend_kernels(q, k, v, deterministic, seed, rate)
        else:
            ctx = self._attend_plain(q, k, v, seed, rate)
        if mesh is None:
            return self._dense(self.out, ctx)
        dt = self.dtype
        out = reduce_from_model(F.linear(ctx.to(dt), self.out.weight.to(dt)), mesh)
        return out + self.out.bias.to(dt)

    def _heads_first(self, t: torch.Tensor, dh: int) -> torch.Tensor:
        b, n, _ = t.shape
        return t.reshape(b, n, self._heads[0], dh).transpose(1, 2)

    def _attend_plain(self, q, k, v, seed, rate):
        """Einsum, softmax, dropout with the kernels' mask, einsum, in
        float32 from q scaled in the model's dtype, as the kernels take it;
        (B, Nq, H*Dv) in the model's dtype."""
        h, base = self._heads
        qh = (self._heads_first(q, self.key_dim) * self.key_dim ** -0.5).float()
        kh = self._heads_first(k, self.key_dim).float()
        vh = self._heads_first(v, self.value_dim).float()
        probs = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", qh, kh), dim=-1)
        if rate > 0.0:
            b, _, n_q, n_k = probs.shape
            probs = probs * dropout_mask(seed, rate, b, h, n_q, n_k,
                                         probs.device, base)
        ctx = torch.einsum("bhnm,bhmd->bnhd", probs, vh)
        return ctx.reshape(ctx.shape[0], ctx.shape[1], -1).to(self.dtype)

    def _attend_kernels(self, q, k, v, deterministic, seed, rate):
        """Kernel 1 in eval, kernels 2 and 3 in training, each told that its
        head mix is the identity (so that kernels 1 and 2 may take their
        one-pass identity routes, and the training forward keeps no
        o_norm); the scale goes onto q before the call."""
        (h, base), dk = self._heads, self.key_dim
        qh = (self._heads_first(q, dk) * dk ** -0.5).contiguous()
        kh = self._heads_first(k, dk).contiguous()
        v_cat = v.contiguous()
        eye = torch.eye(h, device=q.device)
        zero = torch.zeros(h, device=q.device)
        if deterministic:
            w, b = expand_reattention_affine(eye, zero, dh=dk)
            return flash_reattention(qh, kh, v_cat, w, b, num_heads=h,
                                     identity_mix=True)
        return flash_reattention_train(qh, kh, v_cat, eye, zero, seed,
                                       num_heads=h, rate=rate, head_base=base,
                                       identity_mix=True)
