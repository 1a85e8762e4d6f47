"""Kernel 1's float32 tensor-core route at lite's classes: which calls take
it, a CPU emulation of its rounding against the JAX package's kernel, and
the CPU path.

``kernel_route`` names ``tensor_core_f32`` (C route 4 of
``vit_flash_reattention``) for float32 at lite's (4, 12), (4, 48), (4, 192).
The route runs the frozen-BN training forward's f32 sweep
(``csrc/reattention_bnfwd_tc.cuh``, ``Cfg::F32``) in its eval form: rate 0,
no o_norm, ``out = sum_h2 M o_norm_h2 + c vsum``.  The JAX package's
``flash_reattention`` runs in interpret mode, as its own tests run it; the
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 2a, 3 and 6).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_train_fwd_route import _f32_route_forward, _once
from tests.test_torch_train_route import _prod6

JK = importlib.import_module("vit_unet_tpu.kernels.flash_reattention")
TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
TT = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")

TOL = 1e-4   # max|err| / max|plain|, the card's f32 tolerance


@pytest.mark.parametrize("dtype,heads,dh,flag,want", [
    (torch.float32, 4, 12, False, "tensor_core_f32"),    # lite's levels
    (torch.float32, 4, 48, False, "tensor_core_f32"),
    (torch.float32, 4, 192, False, "tensor_core_f32"),
    (torch.float32, 4, 12, True, "tensor_core_f32"),     # no identity class there
    (torch.float32, 4, 192, True, "identity_f32"),       # the identity flag still wins
    (torch.float32, 8, 24, False, "cuda_core"),          # base's, large's levels
    (torch.float32, 8, 96, False, "cuda_core"),
    (torch.float32, 8, 384, False, "cuda_core"),
    (torch.float32, 16, 12, False, "cuda_core"),         # the classifier's
    (torch.float32, 16, 48, False, "cuda_core"),
    (torch.float32, 4, 24, False, "cuda_core"),          # other shapes
    (torch.float32, 8, 48, False, "cuda_core"),
    (torch.bfloat16, 4, 12, False, "tensor_core"),       # bf16 keeps its routes
    (torch.bfloat16, 4, 192, False, "tensor_core"),
    (torch.bfloat16, 4, 192, True, "identity_tc"),
    (torch.bfloat16, 4, 24, False, "cuda_core"),
])
def test_only_lites_f32_calls_take_the_f32_tensor_core_route(dtype, heads, dh, flag, want):
    """The route by dtype, (heads, dh) and the identity flag alone; the
    f32 classes are the one set the three training kernels' f32 routes
    take; the route is C route 4, counted under its own key."""
    assert TK.kernel_route(dtype, heads, dh, identity_mix=flag) == want
    assert TK.TENSOR_CORE_F32_SHAPES == {(4, 12), (4, 48), (4, 192)}
    assert (TT.TRAIN_FWD_F32_SHAPES is TT.BN_FWD_F32_SHAPES is TT.TRAIN_BWD_F32_SHAPES
            is TK.TENSOR_CORE_F32_SHAPES)
    assert TK.ROUTES.index("tensor_core_f32") == 4
    assert tuple(TK.flash_reattention.route_launches) == TK.ROUTES
    assert TK.ONE_PASS_ROUTES == {"identity_tc", "identity_f32", "tensor_core_f32"}


def _inputs(seed, heads, dh, n_q, n_k, batch=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q = f(batch, heads, n_q, dh) * np.float32(3 * dh ** -0.5)
    k, v = f(batch, heads, n_k, dh), f(batch, n_k, heads * dh)
    m, c = f(heads, heads) * np.float32(heads ** -0.5), f(heads) * np.float32(0.1)
    return q, k, v, m, c


@pytest.mark.parametrize("dh,n_q,n_k", [(12, 60, 150), (48, 100, 100), (192, 70, 70)],
                         ids=["12-60x150", "48-100", "192-70"])
def test_eval_split_precision_matches_the_jax_kernel_and_plain(dh, n_q, n_k):
    """The route's arithmetic emulated on the CPU: q, K, A and V_cat as bf16
    triples, both products as six MMAs, the frozen forward's sweep at rate 0
    (the log-sum-exp in the sweep at dh 12 and 48, before it at dh 192),
    the mix from the f32 o_norm and ``vsum``.  Its output is within 1e-4 of
    the JAX kernel (interpret mode, key blocks of 64, so the online softmax
    takes two or three steps; at dh 12 more keys than queries) and of ``flash_reattention_plain``, its lse of
    the scores' log-sum-exp; the same steps from operands rounded to bf16
    once (one MMA a product) are more than 1e-4 off."""
    heads = 4
    q, k, v, m, c = _inputs(dh + n_q + n_k, heads, dh, n_q, n_k, batch=1)
    tq, tk, tv, tm, tc = (torch.from_numpy(a) for a in (q, k, v, m, c))
    w, b = TK.expand_reattention_affine(tm, tc, dh=dh)
    jax_out = torch.from_numpy(np.array(JK.flash_reattention(
        *(jnp.asarray(a) for a in (q, k, v, w.numpy(), b.numpy())), num_heads=heads,
        block_q=64, block_k=64, interpret=True)))
    plain = TK.flash_reattention_plain(tq, tk, tv, w, b, num_heads=heads)
    lse_want = torch.logsumexp(torch.einsum("bhnd,bhmd->bhnm", tq, tk), -1)
    rel = lambda got, want: ((got - want).abs().max() / want.abs().max()).item()
    worst = {}
    for name, prod in (("once", _once), ("triples", _prod6)):
        _, _, lse, _, out = _f32_route_forward(tq, tk, tv, tm, tc, None, 0.0, prod, prod,
                                               online=dh < 192)
        assert out.shape == (1, n_q, heads * dh)
        worst[name] = max(rel(out, jax_out), rel(out, plain), rel(lse, lse_want))
    assert rel(plain, jax_out) < TOL
    assert worst["triples"] < TOL < worst["once"], worst


@pytest.mark.parametrize("dh", [12, 48, 192])
def test_cpu_float32_takes_the_plain_version(dh):
    """On CPU tensors a float32 call at lite's classes is the plain version,
    bit for bit, and counts no launch on any route."""
    q, k, v, m, c = (torch.from_numpy(a) for a in _inputs(dh, 4, dh, 40, 50))
    w, b = TK.expand_reattention_affine(m, c, dh=dh)
    before = TK.flash_reattention.launches, dict(TK.flash_reattention.route_launches)
    got = TK.flash_reattention(q, k, v, w, b, num_heads=4)
    assert (TK.flash_reattention.launches, TK.flash_reattention.route_launches) == before
    assert got.dtype == torch.float32
    assert torch.equal(got, TK.flash_reattention_plain(q, k, v, w, b, num_heads=4))
