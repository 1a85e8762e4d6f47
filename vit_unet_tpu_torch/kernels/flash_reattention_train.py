"""Training flash re-attention: the three hand-written Hopper kernels, their
plain PyTorch versions, the dropout mask, and the autograd Functions.

Counterpart of ``vit_unet_tpu/kernels/flash_reattention_train.py``.  The
public functions keep the JAX layouts: ``q`` (B, H, Nq, dh), pre-scaled;
``k`` (B, H, Nk, dh); ``v_cat`` (B, Nk, H*dh), heads concatenated.

Kernels (``csrc/flash_reattention_train.cu``), each with a plain version
beside it and a launch counter:

* ``train_fwd``  <- ``_fwd`` (:363): frozen-BN forward, writes the mixed
  ``out``, the pre-dropout ``lse`` (B, H, Nq) f32 and ``o_norm``
  (B, H, Nq, H*dh) = A_h @ V_cat per head, in the storage type.  Five
  routes, named by ``train_fwd_route``: for the identity head mix (M = I,
  c = 0, the keras attention's, where the caller says so with
  ``identity_mix=True``) at ``IDENTITY_TC_SHAPES``, ``identity_tc``
  (``csrc/attention_identity_tc.cuh``, one pass, the flash-attention
  forward with the dropout) in bfloat16 and ``identity_f32``
  (``csrc/attention_identity_f32.cuh``, the same pass with every product as
  three bf16 MMAs of hi + lo pairs) in float32: they write out and lse and
  no o_norm (``train_fwd_identity``); ``tensor_core``
  (``csrc/reattention_bnfwd_tc.cuh``, the exact-BN sweep below without S
  and C, with the head mix as its epilogue, taken from the f32 o_norm as
  the TPU epilogue takes it; at lite's 4-head levels with two warps a head,
  at (4, 12) and (4, 48) with the log-sum-exp taken in the sweep; at the
  classifier's (16, 12) and (16, 48), ``csrc/reattention_bnfwd16_tc.cuh``'s
  frozen mode, at (16, 12) with the log-sum-exp taken in the sweep) for
  bfloat16 at ``TRAIN_FWD_TC_SHAPES``; ``tensor_core_f32`` (the same sweep
  in split precision, below) for float32 at ``TRAIN_FWD_F32_SHAPES``;
  ``cuda_core`` (f32 FMAs, the mix from the stored o_norm) for every other
  float32 call and every other shape;
* ``bn_fwd``     <- ``_bn_fwd`` (:741): exact-BN sweep, writes ``lse``,
  ``o_norm`` and the rows S (B, H, Nq) = sum_m A_h, C (B, H, H, Nq) =
  sum_m A_h2 A_h3, f32, with no head mix.  Three routes, named by
  ``bn_fwd_route`` from the input dtype and (heads, dh): ``tensor_core``
  (``csrc/reattention_bnfwd_tc.cuh``, at lite's 4-head levels with two warps
  a head, at (4, 12) and (4, 48) with the log-sum-exp taken in the sweep
  rather than by a pass before it; at the classifier's (16, 12) and
  (16, 48), ``csrc/reattention_bnfwd16_tc.cuh``, at (16, 12) with the
  log-sum-exp in the sweep too) for bfloat16 at ``BN_FWD_TC_SHAPES``,
  the scores and A @ V_cat as bf16 MMAs, S and C from the f32
  probabilities (at 16 heads C as an MMA of A carried as bf16 pairs
  hi + lo), A rounded to bf16 once for the product; ``tensor_core_f32``
  for float32 at lite's (4, 12), (4, 48), (4, 192) (``BN_FWD_F32_SHAPES``,
  C route 4: the same sweep with q, K, V_cat and A carried as bf16 triples
  hi, mid, lo, every product as six bf16 MMAs, o_norm in f32; no TF32);
  ``cuda_core`` (f32 FMAs) for every other float32 call and every other
  shape;
* ``train_bwd``  <- ``_bwd`` (:451): dq, dk, dv (f32) from the residuals,
  the softmax-dot term D and, for exact BN, the dA correction (G, kappa).
  ``train_bwd_route`` names the route a call takes from the input dtype,
  (heads, dh) and the caller's ``identity_mix`` flag, nothing else: for the
  identity head mix at ``IDENTITY_TC_SHAPES`` (``train_bwd_identity``,
  no BN term), ``identity_tc`` in bfloat16 and ``identity_f32`` in float32
  (``csrc/attention_identity_bwd.cuh``: the flash-attention backward with
  the dropout regenerated, a dq kernel and a dk / dv kernel, each output
  written once, no workspace; the map side of each product as bf16 hi + lo,
  f32 inputs split the same way); ``tensor_core``
  (``csrc/reattention_bwd_tc.cuh``) for bfloat16 at ``TRAIN_BWD_TC_SHAPES``
  (base's and large's levels, lite's 4-head levels and the classifier's
  16-head levels (16, 12) and (16, 48)), every product a bf16 MMA with dS
  and the head-mixed map B carried as bf16 pairs hi + lo: one fused kernel
  at (8, 24), (8, 96) and lite's (4, 12), (4, 48), (4, 192) (there two
  warps a head, one keeping dk, one dv), the same steps with the
  probabilities and g.v staged through shared memory at 16 heads, and at
  dh 384 a kernel that writes dS and B to a bf16 workspace and one that
  forms dq, dk and dv from it; ``tensor_core_f32`` for float32 at lite's
  classes (``TRAIN_BWD_F32_SHAPES``): the same fused kernel with every f32
  operand carried as a bf16 pair hi + lo and every product as three bf16
  MMAs; ``cuda_core`` (f32 FMAs) for float32 and every other shape (a
  general-mix call at (8, 192) too).

A_h = softmax(q_h k_h^T) * mask, where the dropout mask keeps an entry iff
the top 24 of its Philox bits reach ceil(f32(rate) * 2^24) and scales it by
1/(1 - rate).  The bits are keyed on (seed, b, h, row, column group),
absolute indices, one Philox call for four entries (``dropout_bits``), so
every kernel draws the same mask whatever its tiling and ``dropout_mask``
here regenerates it exactly with integer torch ops, from the seed tensor on
its device (no host synchronisation).  The normaliser uses the pre-dropout
probabilities, as on the TPU.

Where a call's (batch, row) plane is split over ranks (data or sequence
parallelism), the exact-BN functions take ``shards``: an object with
``all_reduce(t)`` (sum in place over the ranks that hold the plane's
parts), ``size`` (those ranks) and ``row_shards`` (how many of them split
the rows of one batch part; the rest split the batch).  Every part must be
the same size.  The moments and the through-the-statistics gradient terms
are then summed over the ranks, so each equals the unsplit call's; the
parameter gradients come back divided by ``size``, so that summing them
over the ranks gives the unsplit call's.

The math the JAX package computes outside its ``pallas_call`` stays plain
torch: R, D and dm_eff from ``o_norm``, vsum and the c_eff terms, the BN
moments, the batch-stat head mix, and the fold's VJP.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch

from vit_unet_tpu_torch.kernels.flash_reattention import (
    IDENTITY_TC_SHAPES, MAX_HEAD_DIM, MAX_HEADS, SUPPORTED_DTYPES,
    TENSOR_CORE_F32_SHAPES, fold_reattention_compact,
)

ROUTES = ("cuda_core", "tensor_core")      # the C interface's route 0 and 1
#: the identity mix's routes (bf16, f32): routes 2 and 3 of the frozen-BN
#: forward and of the backward
IDENTITY_ROUTES = ("identity_tc", "identity_f32")
#: the f32 route at lite's classes: route 4 of each of the three kernels
F32_TC_ROUTE = "tensor_core_f32"
#: every route, at its index in the C interface
FWD_ROUTES = BWD_ROUTES = ROUTES + IDENTITY_ROUTES + (F32_TC_ROUTE,)
#: the routes for a general head mix (the exact-BN forward's, and
#: ``launch_bwd``'s)
BN_FWD_ROUTES = GENERAL_BWD_ROUTES = ROUTES + (F32_TC_ROUTE,)

#: (heads, dh) classes of each training kernel's tensor-core route: the
#: level shapes of base and large, lite's (4, 12), (4, 48), (4, 192) and the
#: classifier's (16, 12), (16, 48)
LITE_TC_SHAPES = frozenset({(4, 12), (4, 48), (4, 192)})
HEAD16_TC_SHAPES = frozenset({(16, 12), (16, 48)})
TRAIN_FWD_TC_SHAPES = BN_FWD_TC_SHAPES = TRAIN_BWD_TC_SHAPES = (
    frozenset({(8, 24), (8, 96), (8, 384)}) | LITE_TC_SHAPES | HEAD16_TC_SHAPES)
#: (heads, dh) classes of each training kernel's f32 tensor-core route: lite's,
#: the set of kernel 1's
TRAIN_FWD_F32_SHAPES = BN_FWD_F32_SHAPES = TRAIN_BWD_F32_SHAPES = TENSOR_CORE_F32_SHAPES


def _route(shapes, f32_shapes, dtype: torch.dtype, heads: int, dh: int) -> str:
    if dtype == torch.float32 and (heads, dh) in f32_shapes:
        return F32_TC_ROUTE
    return ("tensor_core" if dtype == torch.bfloat16 and (heads, dh) in shapes
            else "cuda_core")


def _identity_route(dtype: torch.dtype) -> str:
    return IDENTITY_ROUTES[dtype == torch.float32]


def train_fwd_route(dtype: torch.dtype, heads: int, dh: int,
                    identity_mix: bool = False) -> str:
    """The route a CUDA frozen-BN forward with these inputs takes: the only
    place it is chosen, by dtype, shape and the caller's ``identity_mix``
    flag alone (never by reading the head mix).  The flag matters only at
    ``IDENTITY_TC_SHAPES``; elsewhere float32 at ``TRAIN_FWD_F32_SHAPES``
    takes the f32 tensor-core route."""
    if identity_mix and (heads, dh) in IDENTITY_TC_SHAPES:
        return _identity_route(dtype)
    return _route(TRAIN_FWD_TC_SHAPES, TRAIN_FWD_F32_SHAPES, dtype, heads, dh)


def bn_fwd_route(dtype: torch.dtype, heads: int, dh: int) -> str:
    """The route a CUDA ``bn_fwd`` call with these inputs takes: the only
    place it is chosen, and by dtype and shape alone."""
    return _route(BN_FWD_TC_SHAPES, BN_FWD_F32_SHAPES, dtype, heads, dh)


def train_bwd_route(dtype: torch.dtype, heads: int, dh: int,
                    identity_mix: bool = False) -> str:
    """The route a CUDA backward with these inputs takes: the only place it
    is chosen, by dtype, shape and the caller's ``identity_mix`` flag alone
    (``train_bwd_identity`` passes it; ``train_bwd`` never does).  The flag
    matters only at ``IDENTITY_TC_SHAPES``; elsewhere a call takes its
    class's general route, float32 at ``TRAIN_BWD_F32_SHAPES`` the f32
    tensor-core route."""
    if identity_mix and (heads, dh) in IDENTITY_TC_SHAPES:
        return _identity_route(dtype)
    return _route(TRAIN_BWD_TC_SHAPES, TRAIN_BWD_F32_SHAPES, dtype, heads, dh)


# --- the dropout mask ---------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit halves of m * a for uint32 values held in int64; the
    64-bit product would overflow int64, so a is split into 16-bit halves."""
    t1 = m * (a & 0xFFFF)
    t2 = m * (a >> 16)
    u = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (u >> 32), u & _MASK32


def philox4(seed, b, h, row, grp):
    """Philox-4x32-10 with key (seed lo, seed hi) and counter
    (grp, row, h, b): int64 tensors broadcast together; ``seed`` an int or
    an int64 tensor (one element, on the indices' device), read there, so
    no value goes to the host.  Returns the four output words, values in
    [0, 2^32).  Bit for bit the generator of ``reattention_common.cuh``."""
    if torch.is_tensor(seed):
        seed = seed.reshape(())
    c0, c1, c2, c3 = grp, row, h, b
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def _column_call(cols):
    """(group, word) of map columns: entry (row, col) takes word
    (col >> 4) & 3 of the Philox call with group (col >> 6) * 16 + (col & 15),
    as the kernels draw them."""
    return (cols >> 6) * 16 + (cols & 15), (cols >> 4) & 3


def dropout_bits(seed, b, h, rows, n_k: int) -> torch.Tensor:
    """The 32 random bits of map entries (b, h, row, col) for columns
    0..n_k-1: (len(b), len(h), len(rows), n_k), for 1-D int64 tensors of
    absolute indices b, h and rows (a block of rows is drawn on its own);
    ``seed`` as ``philox4`` takes it.  One Philox call per group: the
    groups of those columns are exactly 0..G-1, G = 16 * (n_k // 64) +
    min(16, n_k % 64) (the lanes col & 15 of each 64-column block fill up
    from 0), so group g sits at slot g and no search over the groups is
    needed."""
    n_groups = 16 * (n_k // 64) + min(16, n_k % 64)
    groups = torch.arange(n_groups, dtype=torch.int64, device=rows.device)
    words = torch.stack(philox4(seed, b[:, None, None, None],
                                h[None, :, None, None], rows[None, None, :, None],
                                groups[None, None, None, :]), dim=-1)
    grp, word = _column_call(torch.arange(n_k, dtype=torch.int64, device=rows.device))
    return words.flatten(-2)[..., grp * 4 + word]


def keep_threshold(rate: float) -> int:
    """ceil(f32(rate) * 2^24): keep iff bits >> 8 reaches it."""
    rate32 = struct.unpack("f", struct.pack("f", rate))[0]
    return int(math.ceil(rate32 * float(1 << 24)))


def _keep_scale(rate: float) -> float:
    return struct.unpack("f", struct.pack("f", 1.0 / (1.0 - rate)))[0]


def dropout_mask(seed, rate: float, batch: int, heads: int, n_q: int,
                 n_k: int, device=None, head_base: int = 0, *,
                 batch_base: int = 0) -> torch.Tensor:
    """The (B, H, Nq, Nk) f32 dropout scale, 0 or 1/(1 - rate).  ``seed``:
    an int, or the one-element int64 seed tensor the kernels take
    (``new_seed``), read on its device: drawing the mask then needs no
    value from the host, so the card runs it without a synchronisation.
    ``device`` defaults to the seed tensor's.  ``head_base``: the heads
    are heads head_base.. of a wider layer (a tensor-parallel rank's), and
    draw that layer's bits.  ``batch_base``: the images are images
    batch_base.. of a larger batch, and draw that batch's bits."""
    if device is None and torch.is_tensor(seed):
        device = seed.device
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    bits = dropout_bits(seed, ar(batch) + batch_base, ar(heads) + head_base, ar(n_q), n_k)
    keep = (bits >> 8) >= keep_threshold(rate)
    return torch.where(keep, _keep_scale(rate), 0.0).to(torch.float32)


def new_seed(generator: torch.Generator) -> torch.Tensor:
    """A dropout seed drawn from ``generator``, as a one-element int64
    tensor on the generator's device (the kernels read it there, so drawing
    it does not synchronise)."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device, dtype=torch.int64)


# --- plain versions -----------------------------------------------------------

def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' working type: float32, or float64 for float64."""
    return t if t.dtype == torch.float64 else t.float()


def _probs_plain(q, k, seed, rate, head_base=0, batch_base=0):
    """(p, A, lse): pre-dropout probabilities, masked ones, and the LSE, f32."""
    s = torch.einsum("bhnd,bhmd->bhnm", _wide(q), _wide(k))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if rate > 0.0:
        b, h, n_q, n_k = p.shape
        a = p * dropout_mask(seed, rate, b, h, n_q, n_k, p.device, head_base,
                             batch_base=batch_base)
    else:
        a = p
    return p, a, lse


def _mix(onorm, m_eff, c_eff, vsum, dh: int):
    """out[b,n,j] = sum_h2 M[head(j),h2] o_norm[b,h2,n,j] + c[head(j)] vsum[b,j],
    f32."""
    w = torch.repeat_interleave(_wide(m_eff).t(), dh, dim=1)      # (H2, P)
    c = torch.repeat_interleave(_wide(c_eff), dh)                 # (P,)
    return (torch.einsum("hj,bhnj->bnj", w, _wide(onorm))
            + (c[None, :] * _wide(vsum))[:, None, :])


def train_fwd_plain(q, k, v_cat, vsum, m_eff, c_eff, seed, rate: float,
                    head_base: int = 0, *, batch_base: int = 0):
    """Plain version of ``train_fwd``: (out, lse, o_norm).  ``batch_base``
    as ``bn_fwd_plain`` takes it."""
    _, a, lse = _probs_plain(q, k, seed, rate, head_base, batch_base)
    onorm = torch.einsum("bhnm,bmj->bhnj", a, _wide(v_cat)).to(q.dtype)
    out = _mix(onorm, m_eff, c_eff, vsum, q.shape[-1]).to(q.dtype)
    return out, lse, onorm


def train_fwd_identity_plain(q, k, v_cat, seed, rate: float, head_base: int = 0):
    """Plain version of ``train_fwd_identity``: (out, lse), each head's
    attention A_h @ V_h with A_h = softmax(q_h k_h^T) * mask, the head mix
    the identity."""
    batch, heads, n_q, dh = q.shape
    _, a, lse = _probs_plain(q, k, seed, rate, head_base)
    vh = _wide(v_cat).reshape(batch, -1, heads, dh)
    out = torch.einsum("bhnm,bmhd->bnhd", a, vh).reshape(batch, n_q, heads * dh)
    return out.to(q.dtype), lse


def bn_fwd_plain(q, k, v_cat, seed, rate: float, *, batch_base: int = 0):
    """Plain version of ``bn_fwd``: (S rows, C rows, lse, o_norm).
    ``batch_base``: the images are images batch_base.. of the kernel's call
    (their dropout bits are that call's), so a large call is held image
    group by image group."""
    _, a, lse = _probs_plain(q, k, seed, rate, batch_base=batch_base)
    onorm = torch.einsum("bhnm,bmj->bhnj", a, _wide(v_cat)).to(q.dtype)
    s_rows = a.sum(-1)
    c_rows = torch.einsum("bgnm,bhnm->bghn", a, a)
    return s_rows, c_rows, lse, onorm


def train_bwd_plain(q, k, v_cat, lse, g, m_eff, d, seed, rate: float,
                    bn_extra=None, head_base: int = 0, *, batch_base: int = 0):
    """Plain version of ``train_bwd``: (dq, dk, dv), f32, with the N x N
    maps materialised; ``batch_base`` as ``bn_fwd_plain`` takes it."""
    batch, heads, n_q, dh = q.shape
    n_k = k.shape[2]
    s = torch.einsum("bhnd,bhmd->bhnm", _wide(q), _wide(k))
    p = torch.exp(s - lse[..., None])
    mask = (dropout_mask(seed, rate, batch, heads, n_q, n_k, p.device, head_base,
                         batch_base=batch_base) if rate > 0.0 else None)
    a = p * mask if mask is not None else p
    m32 = _wide(m_eff)
    gh = _wide(g).reshape(batch, n_q, heads, dh)
    vh = _wide(v_cat).reshape(batch, n_k, heads, dh)
    t = torch.einsum("bnpd,bmpd->bpnm", gh, vh)
    da = torch.einsum("ph,bpnm->bhnm", m32, t)
    if bn_extra is not None:
        g_mat, kappa = bn_extra
        da = (da + _wide(kappa)[None, :, None, None]
              + torch.einsum("fh,bfnm->bhnm", _wide(g_mat), a))
    if mask is not None:
        da = da * mask
    ds = p * (da - _wide(d)[..., None])
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, _wide(k))
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, _wide(q))
    bmix = torch.einsum("ph,bhnm->bpnm", m32, a)
    dv = torch.einsum("bpnm,bnpd->bmpd", bmix, gh).reshape(batch, n_k, heads * dh)
    return dq, dk, dv


def train_bwd_identity_plain(q, k, v_cat, lse, g, d, seed, rate: float,
                             head_base: int = 0):
    """Plain version of ``train_bwd_identity``: ``train_bwd_plain`` with
    the identity mix and no BN term."""
    eye = torch.eye(q.shape[1], dtype=_wide(q).dtype, device=q.device)
    return train_bwd_plain(q, k, v_cat, lse, g, eye, d, seed, rate, None, head_base)


def mixed_map(q, k, conv_m, conv_c, mask=None):
    """The plain N x N head-mixed map c = conv_m (softmax(q k^T) * mask) +
    conv_c, (B, H, Nq, Nk) in float32 (float64 for float64 inputs), with
    conv_m (H, H) [h_out, h_in]: the input of the head-mix BatchNorm."""
    wide = _wide(q).dtype
    attn = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", q.to(wide), k.to(wide)), -1)
    if mask is not None:
        attn = attn * mask.to(wide)
    return (torch.einsum("gh,bhnm->bgnm", conv_m.to(wide), attn)
            + conv_c.to(wide)[None, :, None, None])


def apply_mixed_map(c, v_cat, norm=None, stats=None, eps: float = 1e-5):
    """out (B, Nq, H*dh) = per head (BatchNorm of c) @ V, in c's dtype:
    with ``norm`` = (gamma, beta), c normalised by ``stats`` = (mean, var)
    per head; without, c as it is."""
    batch, heads, n_q, n_k = c.shape
    col = lambda t: t.to(c.dtype)[None, :, None, None]
    if norm is not None:
        mu, sig2 = stats
        c = (c - col(mu)) * col(norm[0].to(c.dtype) * torch.rsqrt(sig2.to(c.dtype) + eps)) \
            + col(norm[1])
    vh = v_cat.to(c.dtype).reshape(batch, n_k, heads, -1)
    out = torch.einsum("bhnm,bmhd->bnhd", c, vh)
    return out.reshape(batch, n_q, -1)


class _Summed(torch.autograd.Function):
    """A tensor summed over ``shards``' ranks; its cotangent too (each
    rank's part of the sum feeds every rank's use of it)."""

    @staticmethod
    def forward(ctx, t, shards):
        ctx.shards = shards
        return shards.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.shards.all_reduce(g.clone()), None


def batch_moments(c, shards=None):
    """flax's batch moments of c (B, H, Nq, Nk) per head: (mean, E[c^2] -
    mean^2 clamped at 0), over every rank's part with ``shards``
    (differentiable, one all-reduce)."""
    if shards is None:
        mean = c.mean((0, 2, 3))
        return mean, ((c * c).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
    heads = c.shape[1]
    cnt = c.numel() // heads * shards.size
    sums = _Summed.apply(torch.cat([c.sum((0, 2, 3)), (c * c).sum((0, 2, 3))]),
                         shards) / cnt
    mean = sums[:heads]
    return mean, (sums[heads:] - mean * mean).clamp_min(0.0)


def reattention_nxn(q, k, v_cat, conv_m, conv_c, mask=None, *, norm=None,
                    stats=None, eps: float = 1e-5, shards=None):
    """Plain N x N re-attention, differentiable in every input, in float32
    (float64 for float64 inputs): ``apply_mixed_map`` of ``mixed_map``.
    With ``norm`` = (gamma, beta), BatchNorm of c by ``stats`` = (mean,
    var), or by c's batch moments over (B, Nq, Nk) when ``stats`` is None
    (over every rank's part with ``shards``, as the kernels take it).
    Returns (out (B, Nq, H*dh), moments): with ``norm``, moments are c's
    batch (mean, var) as flax takes them (E[c^2] - E[c]^2, clamped at 0),
    else None.

    With (conv_m, conv_c) = (m_eff, c_eff) and no ``norm`` this is the
    function of ``flash_reattention_train``; with ``norm`` and no
    ``stats``, that of ``flash_reattention_train_bn``."""
    c = mixed_map(q, k, conv_m, conv_c, mask)
    moments = None
    if norm is not None:
        moments = batch_moments(c, shards)
    out = apply_mixed_map(c, v_cat, norm, moments if stats is None else stats, eps)
    return out, moments


# --- kernel wrappers ----------------------------------------------------------

def _check(q, k, v_cat) -> None:
    if q.ndim != 4 or k.ndim != 4 or v_cat.ndim != 3:
        raise ValueError("expected q, k (B, H, N, dh) and v_cat (B, N, H*dh)")
    batch, heads, n_q, dh = q.shape
    n_k = k.shape[2]
    if k.shape != (batch, heads, n_k, dh):
        raise ValueError(f"k shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if v_cat.shape != (batch, n_k, heads * dh):
        raise ValueError(f"v_cat shape {tuple(v_cat.shape)}, expected "
                         f"{(batch, n_k, heads * dh)}")
    if n_q == 0 or n_k == 0 or batch == 0:
        raise ValueError("the training kernels take at least one query, key "
                         "and batch row")
    if k.device != q.device or v_cat.device != q.device:
        raise ValueError("all inputs must lie on one device")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"no training re-attention kernel for device {q.device}")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or v_cat.dtype != q.dtype:
        raise TypeError(f"the kernels take float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v_cat.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v_cat)):
        raise ValueError("the kernels take contiguous inputs")
    if heads > MAX_HEADS or dh > MAX_HEAD_DIM or batch > 65535:
        raise ValueError(f"the kernels take at most {MAX_HEADS} heads, head "
                         f"dim {MAX_HEAD_DIM} and batch 65535, got H={heads}, "
                         f"dh={dh}, B={batch}")


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


def _library():
    from vit_unet_tpu_torch.kernels import _build
    lib = _build.load("flash_reattention_train.cu")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vit_train_fwd.argtypes = [p] * 7 + [i, f] + [p] * 3 + [i] * 7 + [p]
        lib.vit_bn_fwd.argtypes = [p] * 4 + [i, f] + [p] * 4 + [i] * 7 + [p]
        lib.vit_train_bwd.argtypes = [p] * 10 + [i, f] + [p] * 3 + [i] * 7 + [p, p]
        lib.vit_train_set_head_base.argtypes = [i, p]
        lib.vit_train_bwd_workspace.argtypes = [i] * 6
        lib.vit_train_bwd_workspace.restype = ctypes.c_int64
        for fn in (lib.vit_train_fwd, lib.vit_bn_fwd, lib.vit_train_bwd,
                   lib.vit_train_set_head_base):
            fn.restype = i
        lib.vit_train_error_string.argtypes = [i]
        lib.vit_train_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _library().vit_train_error_string(rc).decode())


#: the dropout counter's first head last set on each (card, stream)
_HEAD_BASE: dict = {}


def _dropout_args(seed, rate: float, device, head_base: int = 0):
    """(seed pointer, threshold, scale) of a launch; no seed without
    dropout.  With dropout, the launch's stream gets ``head_base`` (the
    kernels' ``g_head_base``) unless it holds that value already."""
    if rate <= 0.0:
        return None, 0, 1.0
    if not (torch.is_tensor(seed) and seed.device == device
            and seed.dtype == torch.int64 and seed.numel() == 1):
        raise ValueError("with dropout the kernels take the seed as a "
                         "one-element int64 tensor on the inputs' device")
    stream = _stream(device)
    if _HEAD_BASE.get((device.index, stream)) != head_base:
        lib = _library()
        with torch.cuda.device(device):
            _launch("set_head_base", lib.vit_train_set_head_base, int(head_base),
                    stream)
        _HEAD_BASE[(device.index, stream)] = head_base
    return seed.data_ptr(), keep_threshold(rate), _keep_scale(rate)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _require_aligned(route: str, **tensors) -> None:
    """The tensor-core routes copy 16 bytes at a time."""
    if route != "cuda_core" and any(t.data_ptr() % 16 for t in tensors.values()):
        raise ValueError(f"the {route} route copies 16 bytes at a time: "
                         + ", ".join(tensors) + " must start at 16-byte aligned "
                         "addresses")


def launch_train_fwd(q, k, v_cat, vsum, m_eff, c_eff, seed, rate: float = 0.0,
                     *, route: str, head_base: int = 0):
    """The frozen-BN forward's kernels on ``route``, on CUDA inputs that
    ``_check`` took: (out, lse, o_norm).  Only the measurements and the
    route-against-route tests name a route themselves; it counts no
    launch."""
    batch, heads, n_q, dh = q.shape
    dev = q.device
    _require_aligned(route, q=q, k=k, v_cat=v_cat)
    out = torch.empty((batch, n_q, heads * dh), dtype=q.dtype, device=dev)
    lse = torch.empty((batch, heads, n_q), dtype=torch.float32, device=dev)
    onorm = torch.empty((batch, heads, n_q, heads * dh), dtype=q.dtype, device=dev)
    vsum, m32, c32 = _f32(vsum, dev), _f32(m_eff, dev), _f32(c_eff, dev)
    seed_ptr, thr, scale = _dropout_args(seed, rate, dev, head_base)
    lib = _library()
    with torch.cuda.device(dev):
        _launch(f"train_fwd ({route})", lib.vit_train_fwd, q.data_ptr(),
                k.data_ptr(), v_cat.data_ptr(), vsum.data_ptr(), m32.data_ptr(),
                c32.data_ptr(), seed_ptr, thr, scale, lse.data_ptr(),
                onorm.data_ptr(), out.data_ptr(), batch, heads, n_q,
                k.shape[2], dh, SUPPORTED_DTYPES[q.dtype], FWD_ROUTES.index(route),
                _stream(dev))
    return out, lse, onorm


def launch_train_fwd_identity(q, k, v_cat, seed, rate: float = 0.0, *,
                              head_base: int = 0):
    """The identity route's kernel for q's dtype (route 2 or 3 of
    ``vit_train_fwd``) on CUDA inputs that ``_check`` took:
    (out, lse), no o_norm.  Only the measurements and the route-against-
    route tests call it themselves; it counts no launch."""
    batch, heads, n_q, dh = q.shape
    dev = q.device
    route = _identity_route(q.dtype)
    _require_aligned(route, q=q, k=k, v_cat=v_cat)
    out = torch.empty((batch, n_q, heads * dh), dtype=q.dtype, device=dev)
    lse = torch.empty((batch, heads, n_q), dtype=torch.float32, device=dev)
    seed_ptr, thr, scale = _dropout_args(seed, rate, dev, head_base)
    lib = _library()
    with torch.cuda.device(dev):
        _launch(f"train_fwd ({route})", lib.vit_train_fwd, q.data_ptr(),
                k.data_ptr(), v_cat.data_ptr(), None, None, None, seed_ptr, thr,
                scale, lse.data_ptr(), None, out.data_ptr(), batch, heads, n_q,
                k.shape[2], dh, SUPPORTED_DTYPES[q.dtype],
                FWD_ROUTES.index(route), _stream(dev))
    return out, lse


def train_fwd(q, k, v_cat, vsum, m_eff, c_eff, seed, rate: float = 0.0,
              head_base: int = 0):
    """Frozen-BN training forward: (out (B, Nq, H*dh), lse (B, H, Nq) f32,
    o_norm (B, H, Nq, H*dh)).  ``vsum`` (B, H*dh) f32 is sum_m v_cat[:, m].
    CUDA tensors take the route ``train_fwd_route`` names.  ``head_base``
    as ``dropout_mask`` takes it."""
    _check(q, k, v_cat)
    if q.device.type == "cpu":
        return train_fwd_plain(q, k, v_cat, vsum, m_eff, c_eff, seed, rate,
                               head_base)
    route = train_fwd_route(q.dtype, q.shape[1], q.shape[3])
    out = launch_train_fwd(q, k, v_cat, vsum, m_eff, c_eff, seed, rate,
                           route=route, head_base=head_base)
    train_fwd.launches += 1
    train_fwd.route_launches[route] += 1
    return out


def train_fwd_identity(q, k, v_cat, seed, rate: float = 0.0, head_base: int = 0):
    """The frozen-BN forward with the identity head mix (M = I, c = 0):
    (out (B, Nq, H*dh), lse (B, H, Nq) f32), no o_norm.  CUDA tensors take
    the route ``train_fwd_route(..., identity_mix=True)`` names: a
    one-pass identity route, or another route of ``train_fwd`` with I and 0
    as the mix, its o_norm dropped.  Counted as a ``train_fwd`` launch."""
    _check(q, k, v_cat)
    if q.device.type == "cpu":
        return train_fwd_identity_plain(q, k, v_cat, seed, rate, head_base)
    batch, heads, _, dh = q.shape
    route = train_fwd_route(q.dtype, heads, dh, identity_mix=True)
    if route in IDENTITY_ROUTES:
        out, lse = launch_train_fwd_identity(q, k, v_cat, seed, rate,
                                             head_base=head_base)
    else:
        zero = torch.zeros(heads, device=q.device)
        out, lse, _ = launch_train_fwd(
            q, k, v_cat, torch.zeros(batch, heads * dh, device=q.device),
            torch.eye(heads, device=q.device), zero, seed, rate, route=route,
            head_base=head_base)
    train_fwd.launches += 1
    train_fwd.route_launches[route] += 1
    return out, lse


def launch_bn_fwd(q, k, v_cat, seed, rate: float = 0.0, *, route: str):
    """The exact-BN forward's kernels on ``route``, on CUDA inputs that
    ``_check`` took: (S, C, lse, o_norm).  Only the measurements and the
    route-against-route tests name a route themselves; it counts no
    launch."""
    batch, heads, n_q, dh = q.shape
    dev = q.device
    _require_aligned(route, q=q, k=k, v_cat=v_cat)
    lse = torch.empty((batch, heads, n_q), dtype=torch.float32, device=dev)
    s_rows = torch.empty((batch, heads, n_q), dtype=torch.float32, device=dev)
    c_rows = torch.empty((batch, heads, heads, n_q), dtype=torch.float32, device=dev)
    onorm = torch.empty((batch, heads, n_q, heads * dh), dtype=q.dtype, device=dev)
    seed_ptr, thr, scale = _dropout_args(seed, rate, dev)
    lib = _library()
    with torch.cuda.device(dev):
        _launch(f"bn_fwd ({route})", lib.vit_bn_fwd, q.data_ptr(), k.data_ptr(),
                v_cat.data_ptr(), seed_ptr, thr, scale, lse.data_ptr(),
                onorm.data_ptr(), s_rows.data_ptr(), c_rows.data_ptr(), batch,
                heads, n_q, k.shape[2], dh, SUPPORTED_DTYPES[q.dtype],
                FWD_ROUTES.index(route), _stream(dev))
    return s_rows, c_rows, lse, onorm


def bn_fwd(q, k, v_cat, seed, rate: float = 0.0):
    """Exact-BN forward sweep: (S (B, H, Nq), C (B, H, H, Nq), lse
    (B, H, Nq), all f32, o_norm (B, H, Nq, H*dh)).  CUDA tensors take the
    route ``bn_fwd_route`` names."""
    _check(q, k, v_cat)
    if q.device.type == "cpu":
        return bn_fwd_plain(q, k, v_cat, seed, rate)
    route = bn_fwd_route(q.dtype, q.shape[1], q.shape[3])
    out = launch_bn_fwd(q, k, v_cat, seed, rate, route=route)
    bn_fwd.launches += 1
    bn_fwd.route_launches[route] += 1
    return out


def launch_bwd(q, k, v_cat, lse, g, m_eff, d, seed, rate: float = 0.0,
               bn_extra=None, *, route: str, head_base: int = 0):
    """The backward's kernels on ``route``, on CUDA inputs that ``_check``
    took: (dq, dk, dv), f32.  Only the measurements and the route-against-
    route tests name a route themselves; it counts no launch."""
    batch, heads, n_q, dh = q.shape
    n_k = k.shape[2]
    dev = q.device
    g = g.to(q.dtype).contiguous()
    if g.shape != (batch, n_q, heads * dh):
        raise ValueError(f"g shape {tuple(g.shape)}, expected {(batch, n_q, heads * dh)}")
    _require_aligned(route, q=q, k=k, v_cat=v_cat, g=g)
    lse, d, m32 = _f32(lse, dev), _f32(d, dev), _f32(m_eff, dev)
    g_mat = kappa = None
    if bn_extra is not None:
        g_mat, kappa = (_f32(t, dev) for t in bn_extra)
    if route not in GENERAL_BWD_ROUTES:
        raise ValueError(f"launch_bwd takes a general-mix route "
                         f"{GENERAL_BWD_ROUTES}, got {route!r}")
    lib = _library()
    r = BWD_ROUTES.index(route)
    nbytes = lib.vit_train_bwd_workspace(batch, heads, n_q, n_k, dh, r)
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    # the fused tensor-core forms (bf16 and f32) add each key tile's dq into
    # a zeroed dq, the CUDA-core route dk by atomics; the form with a
    # workspace (maps, then products) writes every output once
    dq = (torch.zeros if route != "cuda_core" and not nbytes else torch.empty)(
        (batch, heads, n_q, dh), dtype=torch.float32, device=dev)
    dk = (torch.empty if nbytes else torch.zeros)(
        (batch, heads, n_k, dh), dtype=torch.float32, device=dev)
    dv = torch.empty((batch, n_k, heads * dh), dtype=torch.float32, device=dev)
    seed_ptr, thr, scale = _dropout_args(seed, rate, dev, head_base)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        _launch(f"train_bwd ({route})", lib.vit_train_bwd, q.data_ptr(),
                k.data_ptr(), v_cat.data_ptr(), g.data_ptr(), lse.data_ptr(),
                d.data_ptr(), m32.data_ptr(), ptr(g_mat), ptr(kappa), seed_ptr,
                thr, scale, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), batch,
                heads, n_q, n_k, dh, SUPPORTED_DTYPES[q.dtype], r, ptr(work),
                _stream(dev))
    return dq, dk, dv


def train_bwd(q, k, v_cat, lse, g, m_eff, d, seed, rate: float = 0.0,
              bn_extra=None, head_base: int = 0):
    """Backward: (dq (B, H, Nq, dh), dk (B, H, Nk, dh), dv (B, Nk, H*dh)),
    f32.  ``g`` is the cotangent of ``out``, ``d`` (B, H, Nq) the softmax-
    dot term, ``bn_extra`` the exact-BN (G (H, H), kappa (H,)) or None.
    CUDA tensors take the route ``train_bwd_route`` names.  One gradient is
    summed with f32 atomics (dk on the CUDA-core route, dq on the tensor-
    core routes at dh 12, 24, 48, 96 and lite's 192, bf16 and f32), so its
    last bits vary from run to run; the tensor-core class at dh 384 uses no atomics and
    repeats bit for bit, and so do the identity routes
    (``train_bwd_identity``)."""
    _check(q, k, v_cat)
    if q.device.type == "cpu":
        return train_bwd_plain(q, k, v_cat, lse, g, m_eff, d, seed, rate,
                               bn_extra, head_base)
    route = train_bwd_route(q.dtype, q.shape[1], q.shape[3])
    out = launch_bwd(q, k, v_cat, lse, g, m_eff, d, seed, rate, bn_extra,
                     route=route, head_base=head_base)
    train_bwd.launches += 1
    train_bwd.route_launches[route] += 1
    return out


def launch_bwd_identity(q, k, v_cat, lse, g, d, seed, rate: float = 0.0, *,
                        head_base: int = 0):
    """The identity route's kernels for q's dtype (route 2 or 3 of
    ``vit_train_bwd``) on CUDA inputs that ``_check`` took:
    (dq, dk, dv), f32, each written once.  Only the measurements and the
    route-against-route tests call it themselves; it counts no launch."""
    batch, heads, n_q, dh = q.shape
    n_k = k.shape[2]
    dev = q.device
    route = _identity_route(q.dtype)
    g = g.to(q.dtype).contiguous()
    if g.shape != (batch, n_q, heads * dh):
        raise ValueError(f"g shape {tuple(g.shape)}, expected {(batch, n_q, heads * dh)}")
    _require_aligned(route, q=q, k=k, v_cat=v_cat, g=g)
    lse, d = _f32(lse, dev), _f32(d, dev)
    dq = torch.empty((batch, heads, n_q, dh), dtype=torch.float32, device=dev)
    dk = torch.empty((batch, heads, n_k, dh), dtype=torch.float32, device=dev)
    dv = torch.empty((batch, n_k, heads * dh), dtype=torch.float32, device=dev)
    seed_ptr, thr, scale = _dropout_args(seed, rate, dev, head_base)
    lib = _library()
    with torch.cuda.device(dev):
        _launch(f"train_bwd ({route})", lib.vit_train_bwd, q.data_ptr(),
                k.data_ptr(), v_cat.data_ptr(), g.data_ptr(), lse.data_ptr(),
                d.data_ptr(), None, None, None, seed_ptr, thr, scale, dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), batch, heads, n_q, n_k, dh,
                SUPPORTED_DTYPES[q.dtype], BWD_ROUTES.index(route), None, _stream(dev))
    return dq, dk, dv


def train_bwd_identity(q, k, v_cat, lse, g, d, seed, rate: float = 0.0,
                       head_base: int = 0):
    """The backward with the identity head mix (M = I, c = 0) and no BN
    term: (dq, dk, dv), f32, as ``train_bwd`` with I.  CUDA tensors take
    the route ``train_bwd_route(..., identity_mix=True)`` names: an identity
    route, whose outputs are each written once, so two calls give the same
    bits, or another route of ``train_bwd`` with I as the mix.  Counted as a
    ``train_bwd`` launch."""
    _check(q, k, v_cat)
    if q.device.type == "cpu":
        return train_bwd_identity_plain(q, k, v_cat, lse, g, d, seed, rate, head_base)
    heads, dh = q.shape[1], q.shape[3]
    route = train_bwd_route(q.dtype, heads, dh, identity_mix=True)
    if route in IDENTITY_ROUTES:
        out = launch_bwd_identity(q, k, v_cat, lse, g, d, seed, rate,
                                  head_base=head_base)
    else:
        out = launch_bwd(q, k, v_cat, lse, g, torch.eye(heads, device=q.device), d,
                         seed, rate, route=route, head_base=head_base)
    train_bwd.launches += 1
    train_bwd.route_launches[route] += 1
    return out


#: kernel launches since the last reset (the plain versions do not count),
#: also by route
train_fwd.launches = 0
train_fwd.route_launches = dict.fromkeys(FWD_ROUTES, 0)
bn_fwd.launches = 0
bn_fwd.route_launches = dict.fromkeys(BN_FWD_ROUTES, 0)
train_bwd.launches = 0
train_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)


# --- plain torch around the kernels -------------------------------------------

def _r_rows(onorm, g, heads: int, dh: int):
    """R[b,h2,n,hp] = sum_d g[b,n,hp*dh+d] o_norm[b,h2,n,hp*dh+d], f32."""
    batch, _, n_q, proj = onorm.shape
    return torch.einsum("bhnpd,bnpd->bhnp",
                        _wide(onorm).reshape(batch, heads, n_q, heads, dh),
                        _wide(g).reshape(batch, n_q, heads, dh))


def _c_terms(g, vsum, c_eff, heads: int, dh: int):
    """(dc_eff (H,), the c_eff * gsum term of dv (B, 1, P))."""
    gsum = _wide(g).sum(1)                                       # (B, P)
    dc_eff = (gsum * vsum).reshape(g.shape[0], heads, dh).sum((0, 2))
    c_rep = torch.repeat_interleave(_wide(c_eff), dh)
    return dc_eff, (c_rep[None, :] * gsum)[:, None, :]


def _bn_moments(s_rows, c_rows, conv_m, conv_c, cnt: int, shards=None):
    """(mu, var, sum S, sum C) of c = W A + cb over (B, Nq, Nk), taken about
    cb (``_bn_moments`` :805).  With ``shards`` the row sums are every
    rank's (one all-reduce) and ``cnt`` the whole plane's count."""
    ssum = s_rows.sum((0, 2))                                     # (H,)
    csum = c_rows.sum((0, 3))                                     # (H2, H3)
    if shards is not None:
        h = ssum.shape[0]
        both = shards.all_reduce(torch.cat([ssum, csum.reshape(-1)]))
        ssum, csum = both[:h], both[h:].reshape(h, h)
    w = _wide(conv_m)
    cb = _wide(conv_c)
    dev = (w @ ssum) / cnt
    var = torch.einsum("ha,hb,ab->h", w, w, csum) / cnt - dev * dev
    return dev + cb, var, ssum, csum


def _conv_matrix(conv_m):
    return conv_m[:, :, 0, 0] if conv_m.ndim == 4 else conv_m


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v_cat, m_eff, c_eff, seed, rate, head_base):
        vsum = _wide(v_cat).sum(1)
        out, lse, onorm = train_fwd(q, k, v_cat, vsum, m_eff, c_eff, seed, rate,
                                    head_base)
        ctx.save_for_backward(q, k, v_cat, m_eff, c_eff, lse, vsum, onorm)
        ctx.seed, ctx.rate, ctx.head_base = seed, rate, head_base
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v_cat, m_eff, c_eff, lse, vsum, onorm = ctx.saved_tensors
        heads, dh = q.shape[1], q.shape[3]
        r = _r_rows(onorm, g, heads, dh)
        m32 = _wide(m_eff)
        dm_eff = r.sum((0, 2)).t()                                # (Hp, H2)
        d = torch.einsum("ph,bhnp->bhn", m32, r)
        dq, dk, dv = train_bwd(q, k, v_cat, lse, g, m32, d, ctx.seed, ctx.rate,
                               head_base=ctx.head_base)
        dc_eff, dv_c = _c_terms(g, vsum, c_eff, heads, dh)
        return (dq.to(q.dtype), dk.to(k.dtype), (dv + dv_c).to(v_cat.dtype),
                dm_eff.to(m_eff.dtype), dc_eff.to(c_eff.dtype), None, None, None)


class _FlashTrainIdentity(torch.autograd.Function):
    """``_FlashTrain`` with the identity head mix: out is saved in place of
    o_norm, there is no vsum, and the softmax-dot term is
    D[b, h, n] = sum_d g_h * out_h, which equals ``_FlashTrain``'s
    sum_d g_h * o_norm_h up to the summation order (out is o_norm's own
    head, rounded once).  No gradient for the mix."""

    @staticmethod
    def forward(ctx, q, k, v_cat, seed, rate, head_base):
        out, lse = train_fwd_identity(q, k, v_cat, seed, rate, head_base)
        ctx.save_for_backward(q, k, v_cat, lse, out)
        ctx.seed, ctx.rate, ctx.head_base = seed, rate, head_base
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v_cat, lse, out = ctx.saved_tensors
        batch, heads, n_q, dh = q.shape
        d = (_wide(g) * _wide(out)).reshape(batch, n_q, heads, dh).sum(-1).transpose(1, 2)
        dq, dk, dv = train_bwd_identity(q, k, v_cat, lse, g, d, ctx.seed, ctx.rate,
                                        ctx.head_base)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v_cat.dtype), None, None, None


def flash_reattention_train(q, k, v_cat, m_eff, c_eff, seed=None, *,
                            num_heads: int, rate: float = 0.0,
                            head_base: int = 0, identity_mix: bool = False):
    """Frozen-BN training re-attention with dropout, differentiable in q, k,
    v_cat, m_eff (H, H) and c_eff (H,) (``fold_reattention_compact``).
    ``seed``: a one-element int64 tensor (``new_seed``), needed when
    rate > 0.  ``head_base``: the heads are heads head_base.. of a wider
    layer and draw its dropout bits (``dropout_mask``).  ``identity_mix``:
    the caller's promise that m_eff = I and c_eff = 0, which need no
    gradient; the forward then writes no o_norm (``train_fwd_identity``).
    Returns (B, Nq, H*dh) in q's dtype."""
    if q.shape[1] != num_heads:
        raise ValueError(f"q has {q.shape[1]} heads, num_heads={num_heads}")
    if identity_mix:
        if m_eff.requires_grad or c_eff.requires_grad:
            raise ValueError("identity_mix=True takes a fixed mix: m_eff and c_eff "
                             "must not require a gradient")
        return _FlashTrainIdentity.apply(q, k, v_cat, seed, float(rate), int(head_base))
    return _FlashTrain.apply(q, k, v_cat, m_eff, c_eff, seed, float(rate),
                             int(head_base))


class _FlashTrainBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v_cat, conv_m, conv_c, gamma, beta, seed, rate,
                eps, reatten_scale, shards):
        batch, heads, n_q, dh = q.shape
        cnt = batch * n_q * k.shape[2] * (1 if shards is None else shards.size)
        vsum = _wide(v_cat).sum(1)
        s_rows, c_rows, lse, onorm = bn_fwd(q, k, v_cat, seed, rate)
        mu, var, ssum, csum = _bn_moments(s_rows, c_rows, conv_m, conv_c, cnt,
                                          shards)
        m_eff, c_eff = fold_reattention_compact(
            conv_m, conv_c, gamma, beta, mu, var, eps=eps,
            reatten_scale=reatten_scale)
        out = _mix(onorm, m_eff, c_eff, vsum, dh).to(q.dtype)
        ctx.save_for_backward(q, k, v_cat, conv_m, conv_c, gamma, beta,
                              s_rows, c_rows, lse, vsum, onorm, m_eff, c_eff,
                              mu, var, ssum, csum)
        ctx.seed, ctx.rate, ctx.eps, ctx.reatten_scale = seed, rate, eps, reatten_scale
        ctx.shards, ctx.cnt = shards, cnt
        return out, mu, var

    @staticmethod
    def backward(ctx, g, g_mu, g_var):
        (q, k, v_cat, conv_m, conv_c, gamma, beta, s_rows, c_rows, lse, vsum,
         onorm, m_eff, c_eff, mu, var, ssum, csum) = ctx.saved_tensors
        batch, heads, n_q, dh = q.shape
        shards, cnt = ctx.shards, ctx.cnt
        g_mu = torch.zeros_like(mu) if g_mu is None else _wide(g_mu)
        g_var = torch.zeros_like(var) if g_var is None else _wide(g_var)
        w32, cb32 = _wide(conv_m), _wide(conv_c)

        # fixed-stats cotangents of the folded affine
        r = _r_rows(onorm, g, heads, dh)
        dm_eff = r.sum((0, 2)).t()
        dc_eff, dv_c = _c_terms(g, vsum, c_eff, heads, dh)
        if shards is not None:
            # every rank's rows into the affine's cotangents; mu and var
            # are each batch part's output on its row_shards ranks, so
            # their summed cotangents count each part that many times
            hh = heads * heads
            both = shards.all_reduce(torch.cat([
                dm_eff.reshape(-1), dc_eff, g_mu, g_var]))
            dm_eff, dc_eff = both[:hh].reshape(heads, heads), both[hh:hh + heads]
            g_mu = both[hh + heads:hh + 2 * heads] / shards.row_shards
            g_var = both[hh + 2 * heads:] / shards.row_shards

        # cotangents into (W, cb, gamma, beta, mu, var) through the fold
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in
                      (conv_m, conv_c, gamma, beta, mu, var)]
            fm, fc = fold_reattention_compact(
                *leaves, eps=ctx.eps, reatten_scale=ctx.reatten_scale)
            d_cm, _, d_ga, d_be, u, wv = torch.autograd.grad(
                (fm, fc), leaves, (dm_eff.to(fm.dtype), dc_eff.to(fc.dtype)),
                allow_unused=True)
        u = _wide(u) + g_mu
        wv = _wide(wv) + g_var

        # stats-gradient correction coefficients (:951-959)
        e1 = (u - 2.0 * wv * mu) / cnt
        e2 = 2.0 * wv / cnt
        kappa = torch.einsum("hg,h->g", w32, e1 + e2 * cb32)
        g_mat = torch.einsum("hg,h,hf->fg", w32, e2, w32)
        d = (torch.einsum("ph,bhnp->bhn", _wide(m_eff), r)
             + kappa[None, :, None] * s_rows
             + torch.einsum("fh,bfhn->bhn", g_mat, c_rows))
        dq, dk, dv = train_bwd(q, k, v_cat, lse, g, m_eff, d, ctx.seed,
                               ctx.rate, bn_extra=(g_mat, kappa))

        # direct d(mu, var)/d(W, cb) terms (:968-984)
        d_cm = _wide(d_cm) + (
            u[:, None] * ssum[None, :] / cnt
            + 2.0 * wv[:, None] * (w32 @ csum
                                   + (cb32 - mu)[:, None] * ssum[None, :]) / cnt)
        # batch normalisation removes any uniform shift of the map, so only
        # the direct mu-output cotangent reaches cb; assembling it from the
        # fold's two cancelling terms would keep only their rounding noise
        d_cc = g_mu
        part = 1.0 if shards is None else 1.0 / shards.size
        return (dq.to(q.dtype), dk.to(k.dtype), (dv + dv_c).to(v_cat.dtype),
                (d_cm * part).reshape(conv_m.shape).to(conv_m.dtype),
                (d_cc * part).to(conv_c.dtype), (d_ga * part).to(gamma.dtype),
                (d_be * part).to(beta.dtype), None, None, None, None, None)


def flash_reattention_train_bn(q, k, v_cat, conv_m, conv_c, gamma, beta,
                               seed=None, *, num_heads: int, rate: float = 0.0,
                               eps: float = 1e-5, reatten_scale: float = 1.0,
                               shards=None):
    """Training re-attention with exact batch-statistics BatchNorm in the
    head mix.  conv_m: (H, H) [h_out, h_in] (or torch's (H, H, 1, 1));
    conv_c, gamma, beta: (H,).  Returns (out (B, Nq, H*dh), mu (H,),
    var (H,)): the batch moments of the mixed map (biased variance) for the
    caller's running-average update.  ``shards``: the ranks this call's
    (batch, row) plane is split over (module docstring); the moments are
    then the whole plane's."""
    if q.shape[1] != num_heads:
        raise ValueError(f"q has {q.shape[1]} heads, num_heads={num_heads}")
    return _FlashTrainBN.apply(q, k, v_cat, _conv_matrix(conv_m), conv_c,
                               gamma, beta, seed, float(rate), float(eps),
                               float(reatten_scale), shards)


@torch.no_grad()
def flash_bn_batch_moments(q, k, v_cat, conv_m, conv_c, seed=None, *,
                           num_heads: int, rate: float = 0.0, shards=None):
    """Batch moments (mu, var) of the head-mixed map without normalising
    with them (the ``bn_track`` side channel); no gradient.  ``seed`` and
    ``rate`` must be those of the paired forward; ``shards`` as
    ``flash_reattention_train_bn`` takes it."""
    if q.shape[1] != num_heads:
        raise ValueError(f"q has {q.shape[1]} heads, num_heads={num_heads}")
    cnt = q.shape[0] * q.shape[2] * k.shape[2] * (1 if shards is None else shards.size)
    s_rows, c_rows, _, _ = bn_fwd(q, k, v_cat, seed, rate)
    mu, var, _, _ = _bn_moments(s_rows, c_rows, _conv_matrix(conv_m), conv_c,
                                cnt, shards)
    return mu, var
