"""Kernel 2's identity-mix route: which calls take it, who asks for it, and
the identity training forward (its plain version on CPU tensors) against
the JAX package's Pallas ``flash_reattention_train`` in interpret mode and
against the port's general Function.

The route's CUDA kernel (``csrc/attention_identity_tc.cuh``, route 2 of
``vit_train_fwd``) runs only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against the plain version there.  JAX's interpret
mode cannot draw ``pltpu.prng_*`` bits, so the JAX comparison runs at rate
0; the port's dropout is held by comparing with its own general path.
"""
import importlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.test_torch_model import one_torch_thread  # noqa: F401

JT = importlib.import_module("vit_unet_tpu.kernels.flash_reattention_train")
TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
TT = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")
mha = importlib.import_module("vit_unet_tpu_torch.nn.mha")
RA = importlib.import_module("vit_unet_tpu_torch.nn.reattention")

TOL = 1e-4


@pytest.mark.parametrize("dtype,heads,dh,flag,want", [
    (torch.bfloat16, 8, 192, True, "identity_tc"),     # HViTUNetTF's level 0
    (torch.bfloat16, 4, 192, True, "identity_tc"),     # a rank's heads at model 2
    (torch.bfloat16, 8, 192, False, "cuda_core"),      # without the flag
    (torch.bfloat16, 4, 192, False, "tensor_core"),    # lite's level class
    (torch.float32, 8, 192, True, "identity_f32"),     # f32: split precision
    (torch.float32, 4, 192, True, "identity_f32"),
    (torch.float32, 8, 192, False, "cuda_core"),       # without the flag
    (torch.bfloat16, 8, 96, True, "tensor_core"),      # other classes keep theirs
    (torch.bfloat16, 8, 24, True, "tensor_core"),
    (torch.bfloat16, 2, 192, True, "cuda_core"),
    (torch.bfloat16, 16, 12, True, "tensor_core"),     # the classifier's level class
    (torch.bfloat16, 16, 192, True, "cuda_core"),
])
def test_train_fwd_route_names_the_identity_route_only_with_the_flag(dtype, heads, dh, flag,
                                                                    want):
    assert TT.train_fwd_route(dtype, heads, dh, identity_mix=flag) == want
    assert TT.train_fwd_route(dtype, heads, dh) == TT.train_fwd_route(dtype, heads, dh, False)
    assert want in TT.FWD_ROUTES
    assert TT.IDENTITY_TC_SHAPES is TK.IDENTITY_TC_SHAPES


def _recording(module, calls):
    real = module.flash_reattention_train

    def record(*args, identity_mix=False, **kwargs):
        calls.append(identity_mix)
        return real(*args, identity_mix=identity_mix, **kwargs)
    return mock.patch.object(module, "flash_reattention_train", record)


def test_keras_mha_training_passes_the_identity_flag():
    calls = []
    torch.manual_seed(0)
    layer = mha.KerasMHA(dim=16, num_heads=4, key_dim=8, dropout=0.2)
    with _recording(mha, calls):
        out = layer(torch.randn(2, 10, 16), torch.randn(2, 6, 16), deterministic=False,
                    generator=torch.Generator().manual_seed(1))
    out.sum().backward()
    assert calls == [True]
    assert all(p.grad is not None for p in layer.parameters())


@pytest.mark.parametrize("use_running_average,bn_track", [(True, False), (False, True)])
def test_reattention_never_passes_the_flag(use_running_average, bn_track):
    """ReAttention's mix is its folded head-mix conv and BatchNorm, never
    promised to be the identity (frozen BN, and the tracking side channel)."""
    calls = []
    torch.manual_seed(0)
    layer = RA.ReAttention(32, num_heads=4, attn_drop=0.2, bn_track=bn_track)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 4, 6, 8)).astype(np.float32))
               for _ in range(3))
    with _recording(RA, calls):
        layer._attend(q, k, v, generator=torch.Generator().manual_seed(1), deterministic=False,
                      use_running_average=use_running_average)
    assert calls == [False]


def _inputs(seed, batch, heads, n_q, n_k, dh):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(batch, heads, n_q, dh) * np.float32(dh ** -0.5), f(batch, heads, n_k, dh), \
        f(batch, n_k, heads * dh)


@pytest.mark.parametrize("n_q,n_k", [(64, 64), (16, 64)])
def test_identity_forward_matches_the_jax_kernel(n_q, n_k):
    """(4 heads, dh 48) with the identity mix, rate 0: the port's identity
    training forward and its Function on CPU tensors against the JAX
    ``flash_reattention_train`` in interpret mode (blocks of 32, so two key
    steps of its online softmax), f32; no launch counted."""
    heads, dh = 4, 48
    q, k, v = _inputs(11, 2, heads, n_q, n_k, dh)
    want = np.asarray(JT.flash_reattention_train(
        *map(jnp.asarray, (q, k, v)), jnp.eye(heads, dtype=jnp.float32),
        jnp.zeros(heads, jnp.float32), 0, num_heads=heads, rate=0.0, block_q=32,
        block_k=32, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    before = TT.train_fwd.launches, dict(TT.train_fwd.route_launches)
    out, lse = TT.train_fwd_identity(*t, None, 0.0)
    got = TT.flash_reattention_train(*t, torch.eye(heads), torch.zeros(heads), None,
                                     num_heads=heads, identity_mix=True)
    assert (TT.train_fwd.launches, TT.train_fwd.route_launches) == before
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)
    s = torch.einsum("bhnd,bhmd->bhnm", t[0], t[1])
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=TOL, atol=TOL)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("n_q,n_k,head_base", [(40, 40, 0), (24, 70, 4)])
def test_identity_function_matches_the_general_function_with_dropout(n_q, n_k, head_base):
    """Rate 0.2 with the port's dropout mask: out and the gradients of q, k
    and v with identity_mix=True against the general Function with I and 0,
    f32, within 1e-5 of the largest entry."""
    heads, dh = 4, 16
    q, k, v = _inputs(12, 2, heads, n_q, n_k, dh)
    g_out = torch.from_numpy(np.random.default_rng(13).normal(
        size=(2, n_q, heads * dh)).astype(np.float32))
    seed = torch.tensor([21])
    res = []
    for flag in (True, False):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = TT.flash_reattention_train(*leaves, torch.eye(heads), torch.zeros(heads), seed,
                                         num_heads=heads, rate=0.2, head_base=head_base,
                                         identity_mix=flag)
        res.append((out.detach(), torch.autograd.grad((out * g_out).sum(), leaves)))
    (out1, g1), (out0, g0) = res
    assert _rel(out1, out0) <= 1e-5
    for a, b in zip(g1, g0):
        assert _rel(a, b) <= 1e-5
    # the mask is really there: without dropout the output moves
    plain0 = TT.train_fwd_identity_plain(*map(torch.from_numpy, (q, k, v)), seed, 0.0)[0]
    assert _rel(out1, plain0) > 1e-2


def test_identity_function_saves_no_onorm():
    heads, dh, n = 4, 8, 12
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(14, 2, heads, n, n, dh))
    eye, zero = torch.eye(heads), torch.zeros(heads)
    onorm = (2, heads, n, heads * dh)
    ident = TT.flash_reattention_train(q, k, v, eye, zero, None, num_heads=heads,
                                       identity_mix=True)
    general = TT.flash_reattention_train(q, k, v, eye, zero, None, num_heads=heads)
    shapes = lambda out: [tuple(t.shape) for t in out.grad_fn.saved_tensors]
    assert onorm not in shapes(ident) and onorm in shapes(general)
    assert (2, n, heads * dh) in shapes(ident)     # out, for the softmax-dot term


def test_identity_flag_refuses_a_mix_that_needs_a_gradient():
    heads = 4
    q, k, v = (torch.from_numpy(a) for a in _inputs(15, 1, heads, 8, 8, 8))
    for m, c in ((torch.eye(heads).requires_grad_(), torch.zeros(heads)),
                 (torch.eye(heads), torch.zeros(heads).requires_grad_())):
        with pytest.raises(ValueError, match="identity_mix"):
            TT.flash_reattention_train(q, k, v, m, c, None, num_heads=heads,
                                       identity_mix=True)
