"""Sequence (token-axis) parallelism for re-attention: the counterpart of
``vit_unet_tpu/parallel/sequence.py`` (:36-330) on ``torch.distributed``.

The ranks of one line of the mesh's ``model`` axis hold the same batch and
compute the layers around the attention alike.  Each takes its block of
query rows (``Nq = N / s`` of N tokens over s ranks) and its block of key
and value rows, all-gathers K and V along the token axis (one collective a
layer, where a ring would take s), and runs re-attention of its rows
against every key: the rectangular calls of the four kernels, or their
plain versions.  The output rows are all-gathered back, so the layers
after it see the whole sequence.

Gradients follow JAX's ``shard_map`` boundary: a rank's query-row block
takes its own cotangent, the K/V gather's backward sums the rows'
cotangents over the line and hands each rank its block (a reduce_scatter;
gloo has none for CUDA tensors, so there an all_reduce and the rank's
slice, which gives the same numbers), the full-sequence cotangents are
gathered back, and the head-mix parameters' cotangents are summed over the
line.  Exact batch-statistics BatchNorm sums its moments, and the terms of
its backward that pass through them, over every rank that holds part of
the (batch, row) plane (``shards`` of ``kernels/flash_reattention_train``).

Dropout: each rank's kernels draw their rows with local row indices, so
the seed is strided by the rank's shard index, ``seed + idx * 2^20`` with
idx = model index + s * data index, as the JAX package strides it
(:155-160).  The plain body draws ``dropout_mask`` with the same seed, so
the two bodies agree with dropout on.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from vit_unet_tpu_torch.kernels.flash_reattention import (
    expand_reattention_affine, flash_reattention, flash_reattention_plain,
    fold_reattention_compact,
)
from vit_unet_tpu_torch.kernels.flash_reattention_train import (
    dropout_mask, flash_bn_batch_moments, flash_reattention_train,
    flash_reattention_train_bn, reattention_nxn,
)
from vit_unet_tpu_torch.parallel.mesh import Mesh, has_reduce_scatter

__all__ = ["gather_tokens", "scatter_tokens", "unshard_tokens",
           "sum_grad_over_line", "sequence_parallel_reattention",
           "sequence_parallel_reattention_train", "SEED_STRIDE"]

#: the dropout seed's stride between shards (``kseed + idx * 2^20``)
SEED_STRIDE = 1 << 20


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return torch.cat(parts, dim)


def _block(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    return x.chunk(mesh.shape[axis], dim)[mesh.index(axis)]


class _GatherTokens(torch.autograd.Function):
    """Blocks -> the whole axis; backward: the cotangents summed over the
    line, each rank's block of them."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, reduce_scatter):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.reduce_scatter = reduce_scatter
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        if ctx.reduce_scatter:
            parts = [c.contiguous() for c in g.chunk(mesh.shape[axis], dim)]
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=mesh.group(axis))
            return out, None, None, None, None
        total = g.contiguous().clone()
        dist.all_reduce(total, group=mesh.group(axis))
        return _block(total, mesh, axis, dim).contiguous(), None, None, None, None


class _ScatterTokens(torch.autograd.Function):
    """The whole axis (alike on the line) -> this rank's block; backward:
    the blocks' cotangents gathered, alike on the line."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _UnshardTokens(torch.autograd.Function):
    """Blocks -> the whole axis, alike on the line (the layers after run
    alike there); backward: each rank's block of the (alike) cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


class _SumGradOverLine(torch.autograd.Function):
    """A replicated input of the shard body (identity); backward: its
    cotangents summed over the line, as shard_map's boundary sums them."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group(ctx.axis))
        return g, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def gather_tokens(x, mesh: Mesh, axis: str = "model", dim: int = 2,
                  reduce_scatter: Optional[bool] = None) -> torch.Tensor:
    """All-gather this rank's block of ``dim`` over the line of ``axis``,
    differentiably (backward: reduce_scatter, or all_reduce and slice where
    the backend has no reduce_scatter for the tensor's device; the
    default picks by ``has_reduce_scatter``)."""
    if reduce_scatter is None:
        reduce_scatter = has_reduce_scatter(mesh.group(axis), x.device)
    return _GatherTokens.apply(x, mesh, axis, dim, reduce_scatter)


def scatter_tokens(x, mesh: Mesh, axis: str = "model", dim: int = 2) -> torch.Tensor:
    """This rank's block of ``dim`` of a tensor alike on the line."""
    return _ScatterTokens.apply(x, mesh, axis, dim)


def unshard_tokens(x, mesh: Mesh, axis: str = "model", dim: int = 1) -> torch.Tensor:
    """The blocks of ``dim`` gathered into a tensor alike on the line."""
    return _UnshardTokens.apply(x, mesh, axis, dim)


def sum_grad_over_line(x, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """``x`` (alike on the line) as it is; its cotangents summed over the
    line."""
    return _SumGradOverLine.apply(x, mesh, axis)


def _merge(v: torch.Tensor) -> torch.Tensor:
    b, h, n, dh = v.shape
    return v.transpose(1, 2).reshape(b, n, h * dh).contiguous()


def _check_tokens(n: int, mesh: Mesh, axis: str) -> int:
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(f"token count {n} not divisible by mesh axis "
                         f"{axis!r} of size {size}")
    return size


def sequence_parallel_reattention(q, k, v, m_eff, c_eff, mesh: Mesh,
                                  axis: str = "model",
                                  use_flash: bool = False) -> torch.Tensor:
    """Eval re-attention with the token axis split over ``axis``.

    q (pre-scaled), k, v: (B, H, N, dh), this rank's batch with every
    token, alike on the line of ``axis``; m_eff (H, H), c_eff (H,): the
    folded head mix.  Each rank runs its N/s query rows against the
    gathered K/V, on kernel 1 with ``use_flash`` (else its plain version).
    Returns the merged-head (B, N, H*dh), alike on the line."""
    _check_tokens(q.shape[2], mesh, axis)
    heads, dh = q.shape[1], q.shape[3]
    q_l, k_l, v_l = (scatter_tokens(t, mesh, axis) for t in (q, k, v))
    k_full = gather_tokens(k_l, mesh, axis)
    v_cat = _merge(gather_tokens(v_l, mesh, axis))
    w, b = expand_reattention_affine(m_eff, c_eff, dh=dh)
    fn = flash_reattention if use_flash else flash_reattention_plain
    out = fn(q_l, k_full, v_cat, w, b, num_heads=heads)
    return unshard_tokens(out, mesh, axis)


def sequence_parallel_reattention_train(
        q, k, v, conv_m, conv_c, gamma, beta, mesh: Mesh, seed=None,
        rate: float = 0.0, axis: str = "model", data_axis: Optional[str] = "data",
        eps: float = 1e-5, reatten_scale: float = 1.0, running_stats=None,
        use_flash: bool = False, track_stats: bool = False):
    """Training re-attention with the token axis split over ``axis``:
    softmax, attention dropout, the head-mix conv (``conv_m`` (H, H)
    [h_out, h_in], ``conv_c``), BatchNorm (``gamma``, ``beta``), @ V.

    q (pre-scaled), k, v: (B, H, N, dh) as ``sequence_parallel_reattention``
    takes them.  ``data_axis``: the batch is split over that axis too (each
    of its ranks holds other rows), so batch statistics are taken over
    it as well; None when every rank holds the whole batch.  ``seed``: the
    one-element int64 dropout seed, alike on the line (``new_seed``).

    Modes, as the JAX function's: ``running_stats`` None: exact batch
    statistics over the whole (batch, row) plane (``use_flash``: kernels 4
    and 3); ``running_stats`` = (mean, var): frozen, folded into the head
    mix (kernels 2 and 3); with ``track_stats`` the returned moments are
    then this batch's own (no gradient), for the running-average update.
    Returns (out (B, N, H*dh), mean (H,), var (H,)), alike on the line."""
    batch, heads, n, _ = q.shape
    size = _check_tokens(n, mesh, axis)
    if rate > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    if track_stats and running_stats is None:
        raise ValueError("track_stats needs running_stats (the tracking "
                         "warmup normalises with the frozen averages)")
    if data_axis is not None and mesh.shape[data_axis] == 1:
        data_axis = None
    kseed = None
    if seed is not None:
        idx = mesh.index(axis)
        if data_axis is not None:
            idx += size * mesh.index(data_axis)
        kseed = seed + idx * SEED_STRIDE
    q_l, k_l, v_l = (scatter_tokens(t, mesh, axis) for t in (q, k, v))
    k_full = gather_tokens(k_l, mesh, axis)
    v_cat = _merge(gather_tokens(v_l, mesh, axis))
    conv_m, conv_c, gamma, beta = (sum_grad_over_line(t, mesh, axis)
                                   for t in (conv_m, conv_c, gamma, beta))
    shards = mesh.shards((axis,) if data_axis is None else (axis, data_axis))
    if running_stats is not None:
        rm, rv = (t.detach().float() for t in running_stats)
        mean, var = rm, rv
        if use_flash:
            m_eff, c_eff = fold_reattention_compact(
                conv_m, conv_c, gamma, beta, rm, rv, eps=eps,
                reatten_scale=reatten_scale)
            out = flash_reattention_train(q_l, k_full, v_cat, m_eff, c_eff, kseed,
                                          num_heads=heads, rate=rate)
            if track_stats:
                mean, var = flash_bn_batch_moments(
                    q_l.detach(), k_full.detach(), v_cat.detach(),
                    conv_m.detach(), conv_c.detach(), kseed, num_heads=heads,
                    rate=rate, shards=shards)
            return unshard_tokens(out, mesh, axis), mean, var
        mask = (dropout_mask(kseed, rate, batch, heads, q_l.shape[2], n, q.device)
                if rate > 0.0 else None)
        out, moments = reattention_nxn(
            q_l, k_full, v_cat, conv_m, conv_c, mask, norm=(gamma, beta),
            stats=(rm, rv), eps=eps, shards=shards if track_stats else None)
        if track_stats:
            mean, var = (t.detach() for t in moments)
        out = (out * reatten_scale).to(q.dtype)
        return unshard_tokens(out, mesh, axis), mean, var
    if use_flash:
        out, mean, var = flash_reattention_train_bn(
            q_l, k_full, v_cat, conv_m, conv_c, gamma, beta, kseed,
            num_heads=heads, rate=rate, eps=eps, reatten_scale=reatten_scale,
            shards=shards)
        return unshard_tokens(out, mesh, axis), mean, var
    mask = (dropout_mask(kseed, rate, batch, heads, q_l.shape[2], n, q.device)
            if rate > 0.0 else None)
    out, (mean, var) = reattention_nxn(q_l, k_full, v_cat, conv_m, conv_c, mask,
                                       norm=(gamma, beta), eps=eps, shards=shards)
    out = (out * reatten_scale).to(q.dtype)
    # the moments are each batch part's output on its row_shards ranks,
    # as the kernel path's are (its backward divides their cotangents)
    if shards is not None:
        mean, var = (_ScaleGrad.apply(t, 1.0 / shards.row_shards)
                     for t in (mean, var))
    return unshard_tokens(out, mesh, axis), mean, var
