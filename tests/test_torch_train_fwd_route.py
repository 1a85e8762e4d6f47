"""The frozen-BN forward's route choice, its CPU path, the port's frozen-BN
forward at base's and lite's head counts against the JAX package, and CPU
emulations of the rounding its tensor-core route does (at 16 heads too),
and of both forwards' float32 route at lite's classes (split precision).

``train_fwd_route`` picks the frozen-BN forward's kernels on the card by
dtype and (heads, dh) alone; on the CPU ``train_fwd`` is the plain version
and counts no launch.  The JAX package's ``_fwd`` runs in interpret mode
without dropout, as its own tests run it.  The kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_unet_tpu_torch.models import get_config
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_train_route import _classifier_levels, _prod3, _prod6

JT = importlib.import_module("vit_unet_tpu.kernels.flash_reattention_train")
TT = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")


def _level_shapes():
    """(preset, level, heads, dh) of every re-attention level of lite, base
    and large, and of the classifier at the CLI's defaults."""
    out = []
    for preset in ("lite", "base", "large"):
        cfg = get_config(preset)
        for level in range(cfg.depth + 1):
            dh = cfg.level_geometry(level)["projection_dim"] // cfg.num_heads
            out.append((preset, level, cfg.num_heads, dh))
    # sorted by dh: level 0 (N 196) has the wider heads
    for level, (heads, dh) in enumerate(sorted(_classifier_levels(), key=lambda x: -x[1])):
        out.append(("ViTClassifier", level, heads, dh))
    return out


# lite's, base's and large's levels and the classifier's two levels run on
# the tensor cores in bf16; in float32 lite's levels alone (split precision)
TENSOR_CORE = {(4, 12), (4, 48), (4, 192), (8, 24), (8, 96), (8, 384), (16, 12), (16, 48)}
TENSOR_CORE_F32 = {(4, 12), (4, 48), (4, 192)}


@pytest.mark.parametrize("preset,level,heads,dh", _level_shapes())
def test_train_fwd_route_by_dtype_and_shape(preset, level, heads, dh):
    want32 = "tensor_core_f32" if (heads, dh) in TENSOR_CORE_F32 else "cuda_core"
    assert TT.train_fwd_route(torch.float32, heads, dh) == want32
    want = "tensor_core" if (heads, dh) in TENSOR_CORE else "cuda_core"
    assert TT.train_fwd_route(torch.bfloat16, heads, dh) == want
    assert TT.TRAIN_FWD_TC_SHAPES == TENSOR_CORE
    assert TT.TRAIN_FWD_F32_SHAPES == TENSOR_CORE_F32


def test_train_fwd_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(6)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, k, v = f(1, 8, 40, 24).bfloat16(), f(1, 8, 40, 24).bfloat16(), f(1, 40, 192).bfloat16()
    args = (q, k, v, v.float().sum(1), f(8, 8), f(8), torch.tensor([5]), 0.2)
    before = TT.train_fwd.launches, dict(TT.train_fwd.route_launches)
    got = TT.train_fwd(*args)
    assert (TT.train_fwd.launches, TT.train_fwd.route_launches) == before
    for a, b in zip(got, TT.train_fwd_plain(*args)):
        assert torch.equal(a, b)


def _matches_jax_fwd(heads, dh, seed):
    """The port's frozen-BN forward (its plain version here) against the TPU
    kernel it replaces, ``_fwd``, in interpret mode, rate 0: out, lse and
    o_norm in f32.  Blocks of 32 over 48 rows and keys, so the JAX kernel
    takes two key steps of its online softmax and masks padded keys; its
    lse and o_norm come back in the kernel's blocked layout (B, q blocks,
    H, 32, ...)."""
    n, block = 48, 32
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k = f(2, heads, n, dh) * 0.5, f(2, heads, n, dh) * 0.5
    v, m, c = f(2, n, heads * dh), f(heads, heads) * 0.4, f(heads) * 0.2
    out_w, lse_w, _, onorm_w = JT._fwd(*map(jnp.asarray, (q, k, v, m, c)), 0,
                                       num_heads=heads, rate=0.0, block_q=block,
                                       block_k=block, interpret=True)
    lse_w = np.asarray(lse_w).transpose(0, 2, 1, 3).reshape(2, heads, -1)[..., :n]
    onorm_w = np.asarray(onorm_w).transpose(0, 2, 1, 3, 4).reshape(
        2, heads, -1, heads * dh)[:, :, :n]
    t = torch.from_numpy
    got = TT.train_fwd(t(q), t(k), t(v), t(v).sum(1), t(m), t(c), None, 0.0)
    for name, a, b in zip(("out", "lse", "o_norm"), got, (out_w, lse_w, onorm_w)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_train_fwd_matches_jax_fwd_at_base_heads():
    """``_fwd`` against the port at base's 8 heads, dh 24."""
    _matches_jax_fwd(8, 24, 7)


def test_train_fwd_matches_jax_fwd_at_lite_heads():
    """``_fwd`` against the port at lite's 4 heads, dh 12: the head mix over
    4 heads of 12 columns, whose tensor-core class splits a head's columns
    over two warps."""
    _matches_jax_fwd(4, 12, 8)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh,n", [(24, 128), (96, 64), (384, 49)])
def test_train_fwd_tensor_core_rounding_stays_within_tolerance(dh, n, rate):
    """The tensor-core route's rounding, emulated on the CPU with bf16
    inputs: A = P * mask from f32 scores in the exp2 form, rounded to bf16
    once for the product with V_cat (f32 accumulation), and the head mix
    taken from that f32 o_norm, as the TPU epilogue takes it, where
    ``train_fwd_plain`` mixes the bf16-rounded o_norm.  out and o_norm stay
    within 2e-2 of the plain version (max|err| / max|plain|, the card's
    tolerance for bf16 outputs)."""
    heads, batch, seed = 8, 2, 13
    g = torch.Generator().manual_seed(dh + n)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = (rnd(batch, heads, n, dh) * 3 * dh ** -0.5).bfloat16()
    k = rnd(batch, heads, n, dh).bfloat16()
    v = rnd(batch, n, heads * dh).bfloat16()
    m, c = rnd(heads, heads) * heads ** -0.5, rnd(heads) * 0.1
    vsum = v.float().sum(1)
    out_w, _, onorm_w = TT.train_fwd_plain(q, k, v, vsum, m, c, seed, rate)

    s = q.float() @ k.float().transpose(-1, -2)
    log2e = 1.4426950408889634
    p = torch.exp2(s * log2e - (torch.logsumexp(s, -1) * log2e)[..., None])
    a = p * TT.dropout_mask(seed, rate, batch, heads, n, n) if rate > 0 else p
    onorm = torch.einsum("bhnm,bmj->bhnj", a.bfloat16().float(), v.float())
    out = TT._mix(onorm, m, c, vsum, dh).bfloat16()
    assert _rel(onorm.bfloat16(), onorm_w) <= 2e-2
    assert _rel(out, out_w) <= 2e-2


@pytest.mark.parametrize("dh,n,rate", [(12, 200, 0.2), (12, 64, 0.0), (48, 130, 0.2),
                                       (192, 70, 0.2), (192, 130, 0.0)])
def test_train_fwd_lite_rounding_stays_within_tolerance(dh, n, rate):
    """Lite's tensor-core classes (4 heads, two warps a head), emulated on
    the CPU with bf16 inputs.  At dh 12 and 48 the sweep takes the
    log-sum-exp itself: per 64-key tile each row's running max m of the
    scores (log2 units) and normaliser l, A relative to m rounded to bf16
    unnormalised for the product with V_cat, the f32 o_norm rescaled by
    2^(m_old - m_new) when m moves, and divided by l before the mix.  At dh
    192 the log-sum-exp pass comes first and A = P * mask is rounded once.
    Each of a head's two warps holds half of its f32 o_norm columns (of the
    block's 128-column chunk at dh 192) and leaves them for the head mix,
    which is taken from f32; o_norm is written in bf16.  out and o_norm
    stay within 2e-2 of ``train_fwd_plain`` and lse within 1e-4 (the card
    holds them at 2e-2 and 1e-3)."""
    heads, batch, seed = 4, 2, 9
    g = torch.Generator().manual_seed(dh + n)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = (rnd(batch, heads, n, dh) * 3 * dh ** -0.5).bfloat16()
    k = rnd(batch, heads, n, dh).bfloat16()
    v = rnd(batch, n, heads * dh).bfloat16()
    m, c = rnd(heads, heads) * heads ** -0.5, rnd(heads) * 0.1
    vsum = v.float().sum(1)
    out_w, lse_w, onorm_w = TT.train_fwd_plain(q, k, v, vsum, m, c, seed, rate)

    log2e = 1.4426950408889634
    x_all = (q.float() @ k.float().transpose(-1, -2)) * log2e
    mask = (TT.dropout_mask(seed, rate, batch, heads, n, n) if rate > 0
            else torch.ones(batch, heads, n, n))
    proj = heads * dh
    chunk = proj if dh < 192 else 128          # a block's o_norm columns at a time
    halves = [(c0 + w * chunk // 2, c0 + (w + 1) * chunk // 2)
              for c0 in range(0, proj, chunk) for w in range(2)]
    if dh < 192:
        m_run = torch.full((batch, heads, n), -float("inf"))
        l = torch.zeros(batch, heads, n)
        parts = [torch.zeros(batch, heads, n, hi - lo) for lo, hi in halves]
        for k0 in range(0, n, 64):
            x = x_all[..., k0:k0 + 64]
            m_new = torch.maximum(m_run, x.amax(-1))
            alpha = torch.exp2(m_run - m_new)
            m_run = m_new
            p = torch.exp2(x - m_run[..., None])
            a = (p * mask[..., k0:k0 + 64]).bfloat16().float()
            l = l * alpha + p.sum(-1)
            vt = v[:, k0:k0 + 64].float()
            parts = [acc * alpha[..., None] + torch.einsum("bhnm,bmj->bhnj", a, vt[..., lo:hi])
                     for acc, (lo, hi) in zip(parts, halves)]
        onorm = torch.cat(parts, -1) / l[..., None]
        lse = (m_run + torch.log2(l)) / log2e
    else:
        lse = torch.logsumexp(x_all / log2e, -1)
        a = (torch.exp2(x_all - (lse * log2e)[..., None]) * mask).bfloat16().float()
        onorm = torch.cat([torch.einsum("bhnm,bmj->bhnj", a, v[..., lo:hi].float())
                           for lo, hi in halves], -1)
    out = TT._mix(onorm, m, c, vsum, dh).bfloat16()
    assert _rel(onorm.bfloat16(), onorm_w) <= 2e-2
    assert _rel(out, out_w) <= 2e-2
    assert _rel(lse, lse_w) <= 1e-4


@pytest.mark.parametrize("dh,n,rate", [(12, 130, 0.2), (12, 64, 0.0), (48, 100, 0.0),
                                       (48, 300, 0.2)])
def test_train_fwd16_mix_from_f32_stays_within_tolerance(dh, n, rate):
    """The classifier's 16-head classes, emulated on the CPU with bf16
    inputs.  At dh 12 the sweep takes the log-sum-exp itself: per 64-key
    tile each row's running max m of the scores (log2 units) and normaliser
    l, A relative to m rounded to bf16 unnormalised, the f32 o_norm
    rescaled by 2^(m_old - m_new) when m moves and divided by l at the end.
    At dh 48 the log-sum-exp pass comes first, A = P * mask is rounded to
    bf16 once and o_norm is summed a 192-column chunk at a time (A of up to
    256 keys kept, recomputed past them).  Each warp leaves its two heads'
    f32 o_norm in the exchange, and the head mix over all 16 heads is taken
    from it, as the TPU epilogue mixes its f32 o_norm, where
    ``train_fwd_plain`` mixes the bf16-rounded o_norm; o_norm is written in
    bf16 from the same f32.  out and o_norm stay within 2e-2 of the plain
    version and lse within 1e-4 (the card holds them at 2e-2 and 1e-3), and
    out from the f32 o_norm is closer to the unrounded mix than the plain
    version's."""
    heads, batch, seed = 16, 2, 17
    g = torch.Generator().manual_seed(dh + n)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = (rnd(batch, heads, n, dh) * 3 * dh ** -0.5).bfloat16()
    k = rnd(batch, heads, n, dh).bfloat16()
    v = rnd(batch, n, heads * dh).bfloat16()
    m, c = rnd(heads, heads) * heads ** -0.5, rnd(heads) * 0.1
    vsum = v.float().sum(1)
    out_w, lse_w, onorm_w = TT.train_fwd_plain(q, k, v, vsum, m, c, seed, rate)

    log2e = 1.4426950408889634
    x_all = (q.float() @ k.float().transpose(-1, -2)) * log2e
    mask = (TT.dropout_mask(seed, rate, batch, heads, n, n) if rate > 0
            else torch.ones(batch, heads, n, n))
    proj = heads * dh
    if dh == 12:
        m_run = torch.full((batch, heads, n), -float("inf"))
        l = torch.zeros(batch, heads, n)
        acc = torch.zeros(batch, heads, n, proj)
        for k0 in range(0, n, 64):
            x = x_all[..., k0:k0 + 64]
            m_new = torch.maximum(m_run, x.amax(-1))
            alpha = torch.exp2(m_run - m_new)
            m_run = m_new
            p = torch.exp2(x - m_run[..., None])
            a = (p * mask[..., k0:k0 + 64]).bfloat16().float()
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhnm,bmj->bhnj", a,
                                                        v[:, k0:k0 + 64].float())
        onorm = acc / l[..., None]
        lse = (m_run + torch.log2(l)) / log2e
    else:
        lse = torch.logsumexp(x_all / log2e, -1)
        a = (torch.exp2(x_all - (lse * log2e)[..., None]) * mask).bfloat16().float()
        chunks = []
        for c0 in range(0, proj, 192):
            acc = torch.zeros(batch, heads, n, 192)
            for k0 in range(0, n, 64):
                acc = acc + torch.einsum("bhnm,bmj->bhnj", a[..., k0:k0 + 64],
                                         v[:, k0:k0 + 64, c0:c0 + 192].float())
            chunks.append(acc)
        onorm = torch.cat(chunks, -1)
    out = TT._mix(onorm, m, c, vsum, dh)
    assert _rel(onorm.bfloat16(), onorm_w) <= 2e-2
    assert _rel(out.bfloat16(), out_w) <= 2e-2
    assert _rel(lse, lse_w) <= 1e-4
    exact = TT._mix(onorm.double(), m.double(), c.double(), vsum.double(), dh)
    assert _rel(out, exact) < _rel(out_w, exact)


@pytest.mark.parametrize("dtype,heads,dh,flag,want", [
    (torch.float32, 4, 12, False, "tensor_core_f32"),   # lite's levels
    (torch.float32, 4, 48, False, "tensor_core_f32"),
    (torch.float32, 4, 192, False, "tensor_core_f32"),
    (torch.float32, 4, 12, True, "tensor_core_f32"),    # no identity class there
    (torch.float32, 4, 192, True, "identity_f32"),      # the identity flag still wins
    (torch.float32, 8, 192, True, "identity_f32"),
    (torch.float32, 8, 24, False, "cuda_core"),         # base's, the classifier's, other
    (torch.float32, 16, 12, False, "cuda_core"),
    (torch.float32, 4, 24, False, "cuda_core"),
    (torch.float32, 8, 48, False, "cuda_core"),
    (torch.bfloat16, 4, 12, False, "tensor_core"),      # bf16 keeps its routes
    (torch.bfloat16, 4, 192, True, "identity_tc"),
])
def test_only_lites_f32_forwards_take_the_f32_tensor_core_route(dtype, heads, dh, flag, want):
    """Float32 calls of both forwards take the f32 tensor-core route (C
    route 4, counted under its own key) at lite's three classes alone, the
    classes of the backward's f32 route; with the identity flag the
    frozen-BN forward's identity route still wins at (4, 192)."""
    assert TT.train_fwd_route(dtype, heads, dh, identity_mix=flag) == want
    assert (TT.bn_fwd_route(dtype, heads, dh) == TT.train_fwd_route(dtype, heads, dh)
            == TT.train_bwd_route(dtype, heads, dh))
    for wrapper, routes in ((TT.train_fwd, TT.FWD_ROUTES), (TT.bn_fwd, TT.BN_FWD_ROUTES)):
        assert tuple(wrapper.route_launches) == routes
        assert routes.index("cuda_core") == 0 and routes[1] == "tensor_core"
    assert TT.FWD_ROUTES.index(TT.F32_TC_ROUTE) == 4   # the C interface's route 4


LOG2E = 1.4426950408889634


def _f32_inputs(seed, batch, heads, dh, n):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = rnd(batch, heads, n, dh) * 3 * dh ** -0.5
    k, v = rnd(batch, heads, n, dh), rnd(batch, n, heads * dh)
    m, c = rnd(heads, heads) * heads ** -0.5, rnd(heads) * 0.1
    return q, k, v, m, c


def _f32_route_forward(q, k, v, m, c, seed, rate, scores, prod, online):
    """(S, C, lse, o_norm, out) as the f32 tensor-core route forms them: the
    scores q k^T by ``scores``, A = P * mask in f32 and A @ V_cat by
    ``prod``, S and C from the f32 A, and out mixed from the f32 o_norm.
    ``online`` (lite's (4, 12) and (4, 48)): per 64-key tile each row's
    running max m (log2 units) and normaliser l, A, S, C and o_norm taken
    relative to m and rescaled by 2^(m_old - m_new) when it moves, divided
    by l at the end; else (4, 192): the log-sum-exp of the row first, from
    the same scores.  N_q (q's) may differ from N_k (k's and v's)."""
    batch, heads, n, dh = q.shape
    n_k = k.shape[2]
    x_all = scores(q, k, "bhnd,bhmd->bhnm") * LOG2E
    mask = (TT.dropout_mask(seed, rate, batch, heads, n, n_k) if rate > 0
            else torch.ones(batch, heads, n, n_k))
    av = lambda a, v_: prod(a, v_, "bhnm,bmj->bhnj")
    if online:
        m_run = torch.full((batch, heads, n), -float("inf"))
        l, s_acc = torch.zeros(batch, heads, n), torch.zeros(batch, heads, n)
        c_acc = torch.zeros(batch, heads, heads, n)
        acc = torch.zeros(batch, heads, n, heads * dh)
        for k0 in range(0, n_k, 64):
            x = x_all[..., k0:k0 + 64]
            m_new = torch.maximum(m_run, x.amax(-1))
            alpha = torch.exp2(m_run - m_new)
            m_run = m_new
            p = torch.exp2(x - m_run[..., None])
            a = p * mask[..., k0:k0 + 64]
            l = l * alpha + p.sum(-1)
            s_acc = s_acc * alpha + a.sum(-1)
            c_acc = (c_acc * alpha[:, :, None] * alpha[:, None]
                     + torch.einsum("bgnm,bhnm->bghn", a, a))
            acc = acc * alpha[..., None] + av(a, v[:, k0:k0 + 64])
        s_rows, c_rows = s_acc / l, c_acc / (l[:, :, None] * l[:, None])
        onorm, lse2 = acc / l[..., None], m_run + torch.log2(l)
    else:
        lse2 = torch.logsumexp(x_all / LOG2E, -1) * LOG2E
        a = torch.exp2(x_all - lse2[..., None]) * mask
        s_rows, c_rows = a.sum(-1), torch.einsum("bgnm,bhnm->bghn", a, a)
        onorm = av(a, v)
    out = TT._mix(onorm, m, c, v.sum(1), dh)
    return s_rows, c_rows, lse2 / LOG2E, onorm, out


def _once(a, b, eq):
    """einsum ``eq`` of a and b rounded to bf16 once: one bf16 MMA."""
    return torch.einsum(eq, a.bfloat16().float(), b.bfloat16().float())


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh,n", [(12, 130), (48, 100), (192, 70)],
                         ids=["12-130", "48-100", "192-70"])
def test_split_precision_keeps_both_f32_forwards_within_their_tolerance(dh, n, rate):
    """Both forwards' f32 tensor-core route at lite's classes, emulated on
    the CPU with f32 inputs over partial key tiles: q, K, V_cat and A (after
    the exp) carried as bf16 triples and both products, q k^T and A @
    V_cat, as six MMAs (csrc/reattention_bnfwd_tc.cuh, Cfg::F32), the
    log-sum-exp in the sweep at dh 12 and 48 and before it at dh 192.  S,
    C, lse, o_norm and out stay within 1e-4 (max|err| / max|plain|, the
    card's f32 tolerance) of ``bn_fwd_plain`` and ``train_fwd_plain``; the
    same steps on inputs rounded to bf16 once (one MMA a product) put them
    more than 1e-4 off."""
    heads, batch, seed = 4, 2, 9
    q, k, v, m, c = _f32_inputs(dh + n, batch, heads, dh, n)
    s_w, c_w, lse_w, onorm_w = TT.bn_fwd_plain(q, k, v, seed, rate)
    out_w, lse_f, onorm_f = TT.train_fwd_plain(q, k, v, v.sum(1), m, c, seed, rate)
    assert torch.equal(lse_f, lse_w) and torch.equal(onorm_f, onorm_w)
    want = (s_w, c_w, lse_w, onorm_w, out_w)
    worst = {}
    for split in (False, True):
        prod = _prod6 if split else _once
        got = _f32_route_forward(q, k, v, m, c, seed, rate, prod, prod, online=dh < 192)
        worst[split] = max(_rel(a, b) for a, b in zip(got, want))
    assert worst[False] > 1e-4 and worst[True] < 1e-4, worst


def test_f32_forward_scores_take_triples_at_lites_long_rows():
    """Why the forwards' scores take q and K as triples: a score's error
    moves lse, A, and through A S and C directly, and its bound grows with
    the row's keys.  At 2,048 keys (lite's level has
    3,136; the card holds 64 images), rate 0, the log-sum-exp in the sweep:
    from q and K rounded to bf16 once, S, C and lse are more than ten times
    the f32 tolerance off ``bn_fwd_plain``; from pairs within it, but C by
    more than a fifth of it; from triples by less than a twentieth."""
    heads, dh, n = 4, 12, 2048
    q, k, v, _, _ = _f32_inputs(0, 1, heads, dh, n)
    # one column of V_cat: o_norm is not held here
    s_w, c_w, lse_w, _ = TT.bn_fwd_plain(q, k, v[..., :1], None, 0.0)
    rel = {}
    for name, scores in (("once", _once), ("pairs", _prod3), ("triples", _prod6)):
        x = scores(q, k, "bhnd,bhmd->bhnm")
        lse = torch.logsumexp(x, -1)
        a = torch.exp(x - lse[..., None])
        got = (a.sum(-1), torch.einsum("bgnm,bhnm->bghn", a, a), lse)
        rel[name] = max(_rel(g, w) for g, w in zip(got, (s_w, c_w, lse_w)))
    assert rel["once"] > 1e-3 and 2e-5 < rel["pairs"] < 1e-4 and rel["triples"] < 5e-6, rel


@pytest.mark.parametrize("dh,n", [(48, 256), (192, 196)], ids=["48-256", "192-196"])
def test_f32_forward_carries_a_and_v_cat_as_triples(dh, n):
    """Why the f32 route carries A and V_cat as triples too (six MMAs for
    A @ V_cat, not three of pairs): emulated on the CPU at rate 0.2, o_norm
    from pairs is more than five times as far from float64 as the plain f32
    path's own o_norm, from triples less than twice.  The exact-BN step
    centres o_norm's head mix by the map's batch mean, which nearly cancels
    it where the maps are nearly uniform, as at initialisation: with A and
    V_cat as pairs at (4, 192) the gradients of lite's f32 batch-4 exact-BN
    step were 0.85-2.6 of the largest off float64, against the plain f32
    path's 0.17 (tools/torch_lite_f32_bn_probe.py, H100 80GB HBM3, 700 W)."""
    q, k, v, _, _ = _f32_inputs(dh, 2, 4, dh, n)
    want = TT.bn_fwd_plain(q.double(), k.double(), v.double(), 7, 0.2)[3]
    plain = _rel(TT.bn_fwd_plain(q, k, v, 7, 0.2)[3], want)
    x = _prod6(q, k, "bhnd,bhmd->bhnm")
    a = torch.exp(x - torch.logsumexp(x, -1)[..., None]) * TT.dropout_mask(7, 0.2, 2, 4, n, n)
    pairs = _rel(_prod3(a, v, "bhnm,bmj->bhnj"), want)
    triples = _rel(_prod6(a, v, "bhnm,bmj->bhnj"), want)
    assert pairs > 5 * plain and triples < 2 * plain, (plain, pairs, triples)

