"""The frozen-BN forward's route choice, its CPU path, the port's frozen-BN
forward at base's and lite's head counts against the JAX package, and CPU
emulations of the rounding its tensor-core route does (at 16 heads too).

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
from tests.test_torch_train_route import _classifier_levels

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
# the tensor cores in bf16
TENSOR_CORE = {(4, 12), (4, 48), (4, 192), (8, 24), (8, 96), (8, 384), (16, 12), (16, 48)}


@pytest.mark.parametrize("preset,level,heads,dh", _level_shapes())
def test_train_fwd_route_by_dtype_and_shape(preset, level, heads, dh):
    assert TT.train_fwd_route(torch.float32, heads, dh) == "cuda_core"
    want = "tensor_core" if (heads, dh) in TENSOR_CORE else "cuda_core"
    assert TT.train_fwd_route(torch.bfloat16, heads, dh) == want
    assert TT.TRAIN_FWD_TC_SHAPES == TENSOR_CORE


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
