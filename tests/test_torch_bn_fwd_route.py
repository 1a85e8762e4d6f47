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


# base's and large's levels run the exact-BN forward on the tensor cores in
# bf16; lite's (4 heads) and every float32 call stay on the CUDA cores
TENSOR_CORE = {(8, 24), (8, 96), (8, 384)}


@pytest.mark.parametrize("heads,dh", [(8, 24), (8, 96), (8, 384), (4, 12), (4, 48),
                                      (4, 192), (16, 48), (8, 48)])
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
