"""The shape gate between the kernels and the plain path, the exact-BN
forward's route choice and CPU path, and a CPU emulation of the rounding
its tensor-core route does.

``kernel_takes`` decides from (heads, dh) alone whether ``ReAttention``
runs the kernels, against the kernels' own limits (at most 16 heads, head
dim at most 384), as the JAX module's ``_flash_ok`` sends its wide shapes
to XLA.  ``bn_fwd_route`` picks the exact-BN forward's kernels on the card
by dtype and (heads, dh) alone.  ``bn_fwd_plain`` is held against the JAX
package's ``_bn_fwd`` through the autograd Function in
``tests/test_torch_train_kernels.py``; the kernels themselves against the
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import importlib
from unittest import mock

import numpy as np
import pytest
import torch

from vit_unet_tpu_torch.models import get_config
from vit_unet_tpu_torch.nn import reattention as RA
from tests.test_torch_model import one_torch_thread  # noqa: F401

TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
TT = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")


@pytest.mark.parametrize("heads,dh,takes", [
    (8, 24, True), (8, 384, True), (16, 48, True), (16, 384, True),
    (8, 1536, False), (32, 12, False),
])
def test_kernel_takes_by_shape(heads, dh, takes):
    assert TK.kernel_takes(heads, dh) is takes


def test_every_preset_level_takes_the_kernels():
    for preset in ("lite", "base", "large", "notebook512"):
        cfg = get_config(preset)
        for level in range(cfg.depth + 1):
            dh = cfg.level_geometry(level)["projection_dim"] // cfg.num_heads
            assert TK.kernel_takes(cfg.num_heads, dh), (preset, level)


def _kernel_called(*args, **kwargs):
    raise AssertionError("a kernel wrapper was called")


@pytest.mark.parametrize("dh", [24, 1536])
def test_attend_routes_wide_heads_to_the_plain_path(dh):
    """``_attend`` with ``use_flash`` on: at dh 1536 (level 0 of
    ``ViTUNetConfig(im_size=256, patch_size=64)``) it never reaches a
    kernel wrapper and gives the plain path's result, in eval and in
    training; at dh 24 it reaches the wrappers.  The layer is built narrow
    and given the wide head dim: ``_attend`` reads only ``dim``, the
    head-mix conv and BatchNorm, and a (12288, 12288) projection would take
    600 MB."""
    heads, n = 8, 3
    rng = np.random.default_rng(dh)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, k, v = t(2, heads, n, dh), t(2, heads, n, dh), t(2, heads, n, dh)
    layers = []
    for use_flash in (True, False):
        torch.manual_seed(0)
        layer = RA.ReAttention(48, num_heads=heads, attn_drop=0.2, use_flash=use_flash)
        layer.dim = heads * dh
        layers.append(layer)
    kernels = ("flash_reattention", "flash_reattention_train", "flash_reattention_train_bn",
               "flash_bn_batch_moments")
    modes = [dict(deterministic=True, use_running_average=True),
             dict(deterministic=False, use_running_average=False)]
    for mode in modes:
        outs = []
        for layer in layers:
            with mock.patch.multiple(RA, **dict.fromkeys(kernels, _kernel_called)):
                gen = torch.Generator().manual_seed(1)
                if dh == 1536 or not layer.use_flash:
                    outs.append(layer._attend(q, k, v, generator=gen, **mode))
                else:
                    with pytest.raises(AssertionError, match="kernel wrapper"):
                        layer._attend(q, k, v, generator=gen, **mode)
        if dh == 1536:
            torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# base's, large's and lite's levels and the classifier's (16, 12) level run
# the exact-BN forward on the tensor cores in bf16; the classifier's
# (16, 48) and every float32 call stay on the CUDA cores
TENSOR_CORE = {(8, 24), (8, 96), (8, 384), (4, 12), (4, 48), (4, 192), (16, 12)}


@pytest.mark.parametrize("heads,dh", [(8, 24), (8, 96), (8, 384), (4, 12), (4, 48),
                                      (4, 192), (16, 48), (8, 48), (16, 12)])
def test_bn_fwd_route_by_dtype_and_shape(heads, dh):
    assert TT.bn_fwd_route(torch.float32, heads, dh) == "cuda_core"
    want = "tensor_core" if (heads, dh) in TENSOR_CORE else "cuda_core"
    assert TT.bn_fwd_route(torch.bfloat16, heads, dh) == want
    assert TT.BN_FWD_TC_SHAPES == TENSOR_CORE


def test_bn_fwd_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
    q, k, v = f(1, 8, 40, 24), f(1, 8, 40, 24), f(1, 40, 192)
    before = TT.bn_fwd.launches, dict(TT.bn_fwd.route_launches)
    got = TT.bn_fwd(q, k, v, torch.tensor([5]), 0.2)
    assert (TT.bn_fwd.launches, TT.bn_fwd.route_launches) == before
    for a, b in zip(got, TT.bn_fwd_plain(q, k, v, torch.tensor([5]), 0.2)):
        assert torch.equal(a, b)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh,n", [(24, 128), (96, 64), (384, 49)])
def test_bn_fwd_tensor_core_rounding_stays_within_tolerance(dh, n, rate):
    """The tensor-core route's rounding, emulated on the CPU with bf16
    inputs: A = P * mask from f32 scores, rounded to bf16 once for the
    product with V_cat (f32 accumulation), S and C from the f32 A.  o_norm
    stays within 2e-2 of ``bn_fwd_plain`` (max|err| / max|plain|, the
    card's tolerance for bf16 outputs), and S, C and the BN moments mu,
    sigma^2 they give within 1e-4.  Taken from the bf16-rounded A instead,
    S and C would move by more than 1e-4 (sigma^2 by up to 3.5e-4 here): why
    the kernel keeps S and C in f32."""
    heads, batch, seed = 8, 2, 11
    g = torch.Generator().manual_seed(dh + n)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = (rnd(batch, heads, n, dh) * 3 * dh ** -0.5).bfloat16()
    k = rnd(batch, heads, n, dh).bfloat16()
    v = rnd(batch, n, heads * dh).bfloat16()
    w, cb = rnd(heads, heads) * 0.4, rnd(heads) * 0.2
    s_w, c_w, lse_w, onorm_w = TT.bn_fwd_plain(q, k, v, seed, rate)

    s = q.float() @ k.float().transpose(-1, -2)
    log2e = 1.4426950408889634
    p = torch.exp2(s * log2e - (torch.logsumexp(s, -1) * log2e)[..., None])
    a = p * TT.dropout_mask(seed, rate, batch, heads, n, n) if rate > 0 else p
    onorm = torch.einsum("bhnm,bmj->bhnj", a.bfloat16().float(), v.float()).bfloat16()
    assert _rel(onorm, onorm_w) <= 2e-2

    cnt = batch * n * n
    mu_w, var_w, _, _ = TT._bn_moments(s_w, c_w, w, cb, cnt)
    worst = {}
    for rounded in (False, True):
        x = a.bfloat16().float() if rounded else a
        # the kernel's order: a thread sums keys c + 16 j over j, then the
        # row's 16 threads and the 64-key tiles are added
        x = torch.nn.functional.pad(x, (0, -n % 64)).unflatten(-1, (-1, 4, 16))
        s_rows = x.sum(-2).sum(-1).sum(-1)
        c_rows = torch.einsum("bgntjc,bhntjc->bghntc", x, x).sum(-1).sum(-1)
        mu, var, _, _ = TT._bn_moments(s_rows, c_rows, w, cb, cnt)
        worst[rounded] = max(_rel(s_rows, s_w), _rel(c_rows, c_w), _rel(mu, mu_w),
                             _rel(var, var_w))
    assert worst[False] <= 1e-4 and worst[True] > 1e-4, worst


@pytest.mark.parametrize("n,rate", [(64, 0.0), (130, 0.2)])
def test_bn_fwd16_pair_rounding_stays_within_tolerance(n, rate):
    """The 16-head tensor-core class (16, 12) takes C by an MMA of A carried
    as bf16 pairs hi = bf16(A), lo = bf16(A - hi): hi hi^T + hi lo^T +
    lo hi^T, emulated here in f32 (each product of two bf16 exact).  C and
    the BN variance it gives stay within 1e-4 of ``bn_fwd_plain``'s (the
    card's tolerance for C is 1e-3); C from hi alone misses 1e-3: why the
    kernel carries the pair."""
    heads, dh, batch, seed = 16, 12, 2, 11
    g = torch.Generator().manual_seed(n)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = (rnd(batch, heads, n, dh) * 3 * dh ** -0.5).bfloat16()
    k = rnd(batch, heads, n, dh).bfloat16()
    v = rnd(batch, n, heads * dh).bfloat16()
    w, cb = rnd(heads, heads) * 0.4, rnd(heads) * 0.2
    s_w, c_w, _, _ = TT.bn_fwd_plain(q, k, v, seed, rate)

    s = q.float() @ k.float().transpose(-1, -2)
    p = torch.exp(s - torch.logsumexp(s, -1)[..., None])
    a = p * TT.dropout_mask(seed, rate, batch, heads, n, n) if rate > 0 else p
    hi = a.bfloat16().float()
    lo = (a - hi).bfloat16().float()
    prod = lambda x, y: torch.einsum("bgnm,bhnm->bghn", x, y)
    cnt = batch * n * n
    _, var_w, _, _ = TT._bn_moments(s_w, c_w, w, cb, cnt)
    c_pair = prod(hi, hi) + prod(hi, lo) + prod(lo, hi)
    _, var, _, _ = TT._bn_moments(a.sum(-1), c_pair, w, cb, cnt)
    assert _rel(c_pair, c_w) <= 1e-4 and _rel(var, var_w) <= 1e-4
    assert _rel(prod(hi, hi), c_w) > 1e-3


@pytest.mark.parametrize("dh,n,rate", [(12, 200, 0.2), (12, 64, 0.0), (48, 130, 0.2)])
def test_bn_fwd_online_lse_matches_the_plain_version(dh, n, rate):
    """Lite's register classes (4, 12), (4, 48) take the log-sum-exp in the
    sweep, emulated here on the CPU with bf16 inputs: per 64-key tile each
    row's running max m of the scores (log2 units), its normaliser l, A, S
    and C taken relative to m and their sums rescaled by 2^(m_old - m_new)
    when it moves, A rounded to bf16 unnormalised for the product with V_cat,
    and at the end o_norm, S and C divided by l, lse = (m + log2 l) ln 2.
    S, C and lse stay within 1e-4 of ``bn_fwd_plain`` (the card holds them
    at 1e-3) and o_norm within 2e-2: folding the pass into the sweep costs
    no accuracy."""
    heads, batch, seed = 4, 2, 5
    g = torch.Generator().manual_seed(dh + n)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = (rnd(batch, heads, n, dh) * 3 * dh ** -0.5).bfloat16()
    k = rnd(batch, heads, n, dh).bfloat16()
    v = rnd(batch, n, heads * dh).bfloat16()
    s_w, c_w, lse_w, onorm_w = TT.bn_fwd_plain(q, k, v, seed, rate)

    log2e = 1.4426950408889634
    x_all = (q.float() @ k.float().transpose(-1, -2)) * log2e
    mask = (TT.dropout_mask(seed, rate, batch, heads, n, n) if rate > 0
            else torch.ones(batch, heads, n, n))
    m = torch.full((batch, heads, n), -float("inf"))
    l, s_acc = torch.zeros(batch, heads, n), torch.zeros(batch, heads, n)
    c_acc = torch.zeros(batch, heads, heads, n)
    acc = torch.zeros(batch, heads, n, heads * dh)
    for k0 in range(0, n, 64):
        x = x_all[..., k0:k0 + 64]
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        m = m_new
        p = torch.exp2(x - m[..., None])
        a = p * mask[..., k0:k0 + 64]
        l = l * alpha + p.sum(-1)
        s_acc = s_acc * alpha + a.sum(-1)
        c_acc = (c_acc * alpha[:, :, None] * alpha[:, None]
                 + torch.einsum("bgnm,bhnm->bghn", a, a))
        acc = (acc * alpha[..., None]
               + torch.einsum("bhnm,bmj->bhnj", a.bfloat16().float(), v[:, k0:k0 + 64].float()))
    onorm = (acc / l[..., None]).bfloat16()
    lse = (m + torch.log2(l)) / log2e
    assert _rel(onorm, onorm_w) <= 2e-2
    worst = max(_rel(s_acc / l, s_w), _rel(c_acc / (l[:, :, None] * l[:, None]), c_w),
                _rel(lse, lse_w))
    assert worst <= 1e-4, worst
