"""The training backward's route choice, its CPU path, and the port's
training backward at base's head count against the JAX package.

``train_bwd_route`` picks the backward's kernels on the card by dtype and
(heads, dh) alone; on the CPU ``train_bwd`` is the plain version and counts
no launch.  At 8 heads the JAX package's backward kernel takes its fused
form at dh 24 and its legacy form at dh 96 (``_fused_ghat``); the port's
backward is held against both, run in interpret mode without dropout.
(JAX traces an 8-head Pallas kernel in about 4 s, so the file holds the
backward kernel alone; the autograd Functions are held against JAX at 4
heads in ``tests/test_torch_train_kernels.py``.)  A CPU emulation shows
why the tensor-core route keeps dS and the mixed map in bf16 pairs.  The
kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_unet_tpu_torch.models import get_config
from vit_unet_tpu_torch.models.hvit_unet_tf import HViTUNetTFConfig
from tests.test_torch_model import one_torch_thread  # noqa: F401

JT = importlib.import_module("vit_unet_tpu.kernels.flash_reattention_train")
TT = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")


def _classifier_levels():
    """(heads, dh) of ``ViTClassifier``'s re-attention levels at
    ``run_classification``'s defaults (224², patch 16), built on the meta
    device as the CLI builds it."""
    from vit_unet_tpu_torch.cli.run_classification import build_parser
    from vit_unet_tpu_torch.models.vit_classifier import get_vit_classifier
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    a = build_parser().parse_args(["--input_folder", "unused"])
    side = a.im_size // a.patch_size
    model = get_vit_classifier(
        device="meta", depth=a.depth, depth_te=a.depth_te,
        linear_list=(a.head_width, 4), num_patches=side * side,
        patch_size=a.patch_size, hidden_dim=a.hidden_dim, num_heads=a.num_heads)
    return sorted({(m.num_heads, m.dim // m.num_heads) for m in model.modules()
                   if isinstance(m, ReAttention)})


def _level_shapes():
    """(preset, level, heads, dh) of every re-attention level of lite, base
    and large, of HViTUNetTF's level-0 keras attention (key_dim C * p0^2;
    its wider levels do not take the kernels) and of the classifier at the
    CLI's defaults."""
    out = []
    for preset in ("lite", "base", "large"):
        cfg = get_config(preset)
        for level in range(cfg.depth + 1):
            dh = cfg.level_geometry(level)["projection_dim"] // cfg.num_heads
            out.append((preset, level, cfg.num_heads, dh))
    tf = HViTUNetTFConfig()
    out.append(("HViTUNetTF", 0, tf.num_heads, tf.num_channels * tf.patch_size[0] ** 2))
    # sorted by dh: level 0 (N 196) has the wider heads
    for level, (heads, dh) in enumerate(sorted(_classifier_levels(), key=lambda x: -x[1])):
        out.append(("ViTClassifier", level, heads, dh))
    return out


# base's, large's and lite's levels and the classifier's two levels run on
# the tensor cores in bf16; a general-mix call at HViTUNetTF's level 0 stays
# on the CUDA cores (its keras attention takes the identity route).  In f32
# lite's levels alone run on the tensor cores (split precision)
TENSOR_CORE = {(8, 24), (8, 96), (8, 384), (4, 12), (4, 48), (4, 192), (16, 12), (16, 48)}
TENSOR_CORE_F32 = {(4, 12), (4, 48), (4, 192)}


@pytest.mark.parametrize("preset,level,heads,dh", _level_shapes())
def test_train_bwd_route_by_dtype_and_shape(preset, level, heads, dh):
    want32 = "tensor_core_f32" if (heads, dh) in TENSOR_CORE_F32 else "cuda_core"
    assert TT.train_bwd_route(torch.float32, heads, dh) == want32
    want = "tensor_core" if (heads, dh) in TENSOR_CORE else "cuda_core"
    assert TT.train_bwd_route(torch.bfloat16, heads, dh) == want
    assert TT.TRAIN_BWD_TC_SHAPES == TENSOR_CORE
    assert TT.TRAIN_BWD_F32_SHAPES == TENSOR_CORE_F32


@pytest.mark.parametrize("heads,dh", sorted(TENSOR_CORE | {(8, 192), (4, 24), (4, 96), (2, 48)}))
def test_only_lites_f32_backward_takes_the_tensor_cores(heads, dh):
    """Float32: the backward's own route at lite's three classes, counted
    under its own key; every other f32 class on the CUDA cores, and both
    forwards on the CUDA cores in f32 everywhere."""
    want = "tensor_core_f32" if (heads, dh) in TENSOR_CORE_F32 else "cuda_core"
    assert TT.train_bwd_route(torch.float32, heads, dh) == want
    assert TT.train_fwd_route(torch.float32, heads, dh) == "cuda_core"
    assert TT.bn_fwd_route(torch.float32, heads, dh) == "cuda_core"
    assert "tensor_core_f32" in TT.train_bwd.route_launches
    assert "tensor_core_f32" not in TT.train_fwd.route_launches
    assert TT.BWD_ROUTES.index("tensor_core_f32") == 4   # the C interface's route 4


def test_classifier_levels_at_the_cli_defaults():
    assert _classifier_levels() == [(16, 12), (16, 48)]


@pytest.mark.parametrize("heads,dh", [(16, 192), (16, 384), (16, 24), (16, 96),
                                      (8, 12), (8, 48)])
def test_untaken_classes_stay_on_the_cuda_cores(heads, dh):
    """The 16-head classes the classifier does not run, and the classifier's
    head dims at 8 heads, have no tensor-core class: CUDA cores in bf16 too,
    and the kernels still take them (``kernel_takes`` is unchanged)."""
    TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
    assert TK.kernel_takes(heads, dh)
    for dtype in (torch.float32, torch.bfloat16):
        assert TT.train_bwd_route(dtype, heads, dh) == "cuda_core"


def test_train_bwd_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    batch, heads, n, dh = 1, 8, 40, 24
    f = lambda *s, scale=1.0: torch.from_numpy(
        rng.normal(size=s).astype(np.float32) * scale)
    q = f(batch, heads, n, dh, scale=0.5).bfloat16()
    k = f(batch, heads, n, dh).bfloat16()
    v = f(batch, n, heads * dh).bfloat16()
    g = f(batch, n, heads * dh).bfloat16()
    lse = torch.logsumexp(q.float() @ k.float().transpose(-1, -2), -1)
    args = (q, k, v, lse, g, f(heads, heads), f(batch, heads, n),
            torch.tensor([5]), 0.2, (f(heads, heads) * 0.1, f(heads) * 0.1))
    before = TT.train_bwd.launches, dict(TT.train_bwd.route_launches)
    got = TT.train_bwd(*args)
    assert (TT.train_bwd.launches, TT.train_bwd.route_launches) == before
    for a, b in zip(got, TT.train_bwd_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dh,keras", [
    pytest.param(24, False, id="24"),    # JAX: fused form
    pytest.param(96, False, id="96"),    # JAX: legacy form
    pytest.param(192, True, id="192-identity"),   # HViTUNetTF's keras class
])
def test_train_bwd_matches_jax_bwd_at_base_heads(dh, keras):
    """The port's backward (its plain version here) against the TPU kernel
    it replaces, ``_bwd``, in interpret mode, with the exact-BN term on (G,
    kappa and the D addition), which covers every term of the frozen-BN
    backward too.  ``keras``: as ``KerasMHA`` calls it, the identity head
    mix and no BN term.  The residuals lse and o_norm come from the port's
    plain forward and go to both in the JAX kernel's blocked layout (one q
    block).  Tolerance as ``test_frozen_function_matches_jax``'s gradients."""
    n, heads = 32, 8
    rng = np.random.default_rng(dh)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k = f(1, heads, n, dh) * 0.5, f(1, heads, n, dh) * 0.5
    v, g = f(1, n, heads * dh), f(1, n, heads * dh)
    m, c = f(heads, heads) * 0.4, f(heads) * 0.2
    g_mat, kappa, d_extra = f(heads, heads) * 0.1, f(heads) * 0.1, f(1, heads, n)
    if keras:
        m, c = np.eye(heads, dtype=np.float32), np.zeros(heads, np.float32)
        d_extra = np.zeros_like(d_extra)
    t = torch.from_numpy
    _, lse, onorm = TT.train_fwd_plain(t(q), t(k), t(v), t(v).sum(1), t(m), t(c),
                                       None, 0.0)
    d = (torch.einsum("ph,bhnp->bhn", t(m), TT._r_rows(onorm, t(g), heads, dh))
         + t(d_extra))
    want = JT._bwd(*map(jnp.asarray, (q, k, v, m)), 0,
                   jnp.asarray(lse.numpy()[:, None]),
                   jnp.asarray(onorm.numpy()[:, None]), jnp.asarray(g),
                   num_heads=heads, rate=0.0, block_q=n, block_k=n, interpret=True,
                   d_extra=None if keras else jnp.asarray(d_extra[:, None]),
                   bn_extra=None if keras else (jnp.asarray(g_mat), jnp.asarray(kappa)))[:3]
    got = TT.train_bwd(t(q), t(k), t(v), lse, t(g), t(m), d, None, 0.0,
                       None if keras else (t(g_mat), t(kappa)))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def _round(x, pairs):
    """x through bf16 once, or as the pair hi + lo the kernels keep."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if pairs else hi


@pytest.mark.parametrize("heads,dh,n", [
    pytest.param(heads, dh, n, id=f"{dh}-{n}" if heads == 8 else f"h{heads}-{dh}-{n}")
    for heads, dh, n in [(8, 24, 128), (8, 96, 64), (8, 192, 130), (16, 12, 200), (16, 48, 100),
                         (4, 12, 256), (4, 48, 128), (4, 192, 100)]])
def test_bf16_pairs_keep_the_backward_within_its_tolerance(heads, dh, n):
    """Why the tensor-core backward carries dS and the mixed map B as bf16
    pairs: emulated on the CPU with bf16 inputs, rate 0.2 and the BN term,
    rounding both once to bf16 (as the TPU kernel does) puts dq, dk or dv
    more than 1e-3 (max|err| / max|plain|, the card's tolerance for these
    f32 outputs) off the plain version; the pairs keep them under 1e-4.
    Every class rounds alike: the 16-head classes keep P and g.v in f32
    (staged through shared memory) and round only dS and B, to pairs, and
    so do lite's 4-head classes, in registers."""
    rate = 0.2
    g = torch.Generator().manual_seed(dh)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = (rnd(1, heads, n, dh) * 3 * dh ** -0.5).bfloat16().float()
    k = rnd(1, heads, n, dh).bfloat16().float()
    v = rnd(1, n, heads * dh).bfloat16().float()
    gout = rnd(1, n, heads * dh).bfloat16().float()
    m, d = rnd(heads, heads) * heads ** -0.5, rnd(1, heads, n)
    g_mat, kappa = rnd(heads, heads) * 0.1, rnd(heads) * 0.1
    s = q @ k.transpose(-1, -2)
    lse = torch.logsumexp(s, -1)
    want = TT.train_bwd_plain(q, k, v, lse, gout, m, d, 7, rate, (g_mat, kappa))
    p = torch.exp(s - lse[..., None])
    mask = TT.dropout_mask(7, rate, 1, heads, n, n)
    a = p * mask
    gh, vh = gout.reshape(1, n, heads, dh), v.reshape(1, n, heads, dh)
    da = (torch.einsum("ph,bpnm->bhnm", m, torch.einsum("bnpd,bmpd->bpnm", gh, vh))
          + kappa[None, :, None, None] + torch.einsum("fh,bfnm->bhnm", g_mat, a))
    ds = p * (da * mask - d[..., None])
    bmix = torch.einsum("ph,bhnm->bpnm", m, a)
    worst = {}
    for pairs in (False, True):
        dsr, br = _round(ds, pairs), _round(bmix, pairs)
        got = (dsr @ k, dsr.transpose(-1, -2) @ q,
               torch.einsum("bpnm,bnpd->bmpd", br, gh).reshape(1, n, heads * dh))
        worst[pairs] = max(((x - y).abs().max() / y.abs().max()).item()
                           for x, y in zip(got, want))
    assert worst[False] > 1e-3 and worst[True] < 1e-4, worst


def _split(x, parts=2):
    """x as the bf16 pair (hi, lo) the f32 tensor-core route keeps, or as the
    triple (hi, mid, lo) with mid = bf16(x - hi), lo = bf16(x - hi - mid)."""
    out, rest = [], x
    for _ in range(parts):
        out.append(rest.bfloat16().float())
        rest = rest - out[-1]
    return out


def _prod3(a, b, eq):
    """einsum ``eq`` of a and b as three bf16 MMAs of their pairs with f32
    sums: lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b left out)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _prod6(a, b, eq):
    """The same as six bf16 MMAs of their triples: the 2^-16 terms lo hi,
    hi lo, mid mid, then mid hi, hi mid, hi hi."""
    (ah, am, al), (bh, bm, bl) = _split(a, 3), _split(b, 3)
    e = lambda x, y: torch.einsum(eq, x, y)
    return e(al, bh) + e(ah, bl) + e(am, bm) + e(am, bh) + e(ah, bm) + e(ah, bh)


def _f32_route_grads(q, k, v, gout, lse, m, d, g_mat, kappa, mask, score_prod, prod):
    """dq, dk, dv as the f32 tensor-core route forms them, with the scores
    q k^T by ``score_prod``, g v^T and the three products by ``prod``, dS
    and B as pairs."""
    _, heads, n, dh = q.shape
    gh, vh = gout.reshape(1, n, heads, dh), v.reshape(1, n, heads, dh)
    p = torch.exp(score_prod(q, k, "bhnd,bhmd->bhnm") - lse[..., None])
    a = p if mask is None else p * mask
    da = (torch.einsum("ph,bpnm->bhnm", m, prod(gh, vh, "bnpd,bmpd->bpnm"))
          + kappa[None, :, None, None] + torch.einsum("fh,bfnm->bhnm", g_mat, a))
    ds = _round(p * ((da if mask is None else da * mask) - d[..., None]), True)
    bmix = _round(torch.einsum("ph,bhnm->bpnm", m, a), True)
    return (prod(ds, k, "bhnm,bhmd->bhnd"), prod(ds, q, "bhnm,bhnd->bhmd"),
            prod(bmix, gh, "bpnm,bnpd->bmpd").reshape(1, n, heads * dh))


def _f32_inputs(seed, heads, dh, n):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = rnd(1, heads, n, dh) * 3 * dh ** -0.5
    k, v, gout = rnd(1, heads, n, dh), rnd(1, n, heads * dh), rnd(1, n, heads * dh)
    m, d = rnd(heads, heads) * heads ** -0.5, rnd(1, heads, n)
    g_mat, kappa = rnd(heads, heads) * 0.1, rnd(heads) * 0.1
    lse = torch.logsumexp(q @ k.transpose(-1, -2), -1)
    return q, k, v, gout, lse, m, d, g_mat, kappa


# the f32 route's classes whose scores take q and K as triples (Cfg::TRIPLE
# in csrc/reattention_bwd_tc.cuh); (4, 192)'s tiles have no room for them
F32_TRIPLES = {(4, 12), (4, 48)}


@pytest.mark.parametrize("heads,dh,n", [(4, 12, 256), (4, 48, 128), (4, 192, 100)],
                         ids=["12-256", "48-128", "192-100"])
def test_split_precision_keeps_the_f32_backward_within_its_tolerance(heads, dh, n):
    """Why the f32 tensor-core route at lite's classes carries every f32
    operand as bf16 parts and takes each product as several bf16 MMAs:
    emulated on the CPU with f32 inputs, rate 0.2 and the BN term, the
    scores q k^T (six MMAs of triples where the class has them, else
    three of pairs) and g v^T, and dq = dS K, dk = dS^T q, dv = B^T g
    from dS and B as pairs (three MMAs), keep dq, dk and dv within 1e-4
    (max|err| / max|plain|, the card's tolerance for f32 gradients) of the
    plain version; the same steps on inputs rounded to bf16 once (one MMA
    a product) put them more than 1e-4 off."""
    rate = 0.2
    q, k, v, gout, lse, m, d, g_mat, kappa = _f32_inputs(100 + dh, heads, dh, n)
    want = TT.train_bwd_plain(q, k, v, lse, gout, m, d, 7, rate, (g_mat, kappa))
    mask = TT.dropout_mask(7, rate, 1, heads, n, n)
    once = lambda a, b, eq: torch.einsum(eq, _round(a, False), _round(b, False))
    scores = _prod6 if (heads, dh) in F32_TRIPLES else _prod3
    worst = {}
    for split in (False, True):
        got = _f32_route_grads(q, k, v, gout, lse, m, d, g_mat, kappa, mask,
                               scores if split else once, _prod3 if split else once)
        worst[split] = max(((x - y).abs().max() / y.abs().max()).item()
                           for x, y in zip(got, want))
    assert worst[False] > 1e-4 and worst[True] < 1e-4, worst


def test_scores_take_triples_at_lites_long_rows():
    """Why the scores take six MMAs of triples at (4, 12): the pairs'
    16 significant bits leave an error in S that reaches dS through
    P = exp(S - lse) times dA - D, and it grows with the row's keys.  At
    2,048 keys (lite's level has 3,136, where the card's b64 call with
    pairs put dq at 1.0e-4 of max|plain|, on the tolerance), rate 0, the
    BN term on: with the scores from pairs dq is more than half the f32
    tolerance off the plain version; from triples less than a quarter."""
    heads, dh, n = 4, 12, 2048
    q, k, v, gout, lse, m, d, g_mat, kappa = _f32_inputs(0, heads, dh, n)
    want = TT.train_bwd_plain(q, k, v, lse, gout, m, d, None, 0.0, (g_mat, kappa))[0]
    rel = {}
    for name, scores in (("pairs", _prod3), ("triples", _prod6)):
        dq = _f32_route_grads(q, k, v, gout, lse, m, d, g_mat, kappa, None, scores, _prod3)[0]
        rel[name] = ((dq - want).abs().max() / want.abs().max()).item()
    assert rel["pairs"] > 5e-5 and rel["triples"] < 2.5e-5, rel
