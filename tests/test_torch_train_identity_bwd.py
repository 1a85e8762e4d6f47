"""Kernel 3's identity-mix routes: which calls take them, who reaches them,
and the identity backward (its plain version on CPU tensors) against the
JAX package's Pallas ``flash_reattention_train`` VJP in interpret mode and
against the port's general backward.

The routes' CUDA kernels (``csrc/attention_identity_bwd.cuh``, routes 2 and
3 of ``vit_train_bwd``) run only on the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold them against the plain version there.  JAX's
interpret mode cannot draw ``pltpu.prng_*`` bits, so the JAX comparison runs
at rate 0; the port's dropout is held against its own general backward.
"""
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.test_torch_model import one_torch_thread  # noqa: F401

JT = importlib.import_module("vit_unet_tpu.kernels.flash_reattention_train")
TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
TT = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")

TOL = 1e-4


@pytest.mark.parametrize("dtype,heads,dh,flag,want", [
    (torch.bfloat16, 8, 192, True, "identity_tc"),     # HViTUNetTF's level 0
    (torch.bfloat16, 4, 192, True, "identity_tc"),     # a rank's heads at model 2
    (torch.float32, 8, 192, True, "identity_f32"),     # the default (f32) config
    (torch.float32, 4, 192, True, "identity_f32"),
    (torch.bfloat16, 8, 192, False, "cuda_core"),      # without the flag
    (torch.bfloat16, 4, 192, False, "tensor_core"),    # lite's level 0, a general mix
    (torch.float32, 8, 192, False, "cuda_core"),
    (torch.bfloat16, 8, 96, True, "tensor_core"),      # other classes keep theirs
    (torch.bfloat16, 16, 12, True, "tensor_core"),
    (torch.bfloat16, 2, 192, True, "cuda_core"),
    (torch.float32, 16, 48, True, "cuda_core"),
])
def test_train_bwd_route_names_the_identity_route_only_with_the_flag(dtype, heads, dh, flag,
                                                                    want):
    assert TT.train_bwd_route(dtype, heads, dh, identity_mix=flag) == want
    assert TT.train_bwd_route(dtype, heads, dh) == TT.train_bwd_route(dtype, heads, dh, False)
    assert want in TT.BWD_ROUTES
    assert TT.IDENTITY_TC_SHAPES is TK.IDENTITY_TC_SHAPES


def _inputs(seed, batch, heads, n_q, n_k, dh):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(batch, heads, n_q, dh) * np.float32(dh ** -0.5), f(batch, heads, n_k, dh),
            f(batch, n_k, heads * dh), f(batch, n_q, heads * dh))


def _recording(calls):
    real = TT.train_bwd_identity

    def record(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    return mock.patch.object(TT, "train_bwd_identity", record)


def test_only_the_identity_function_reaches_the_identity_backward():
    """``_FlashTrainIdentity.backward`` calls ``train_bwd_identity``; the
    general Function and the exact-BN Function never do."""
    heads, dh, n = 4, 8, 12
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(3, 2, heads, n, n, dh))
    eye, zero, seed = torch.eye(heads), torch.zeros(heads), torch.tensor([9])
    runs = {
        "identity": lambda *t: TT.flash_reattention_train(
            *t, eye, zero, seed, num_heads=heads, rate=0.2, identity_mix=True),
        "general": lambda *t: TT.flash_reattention_train(
            *t, eye, zero, seed, num_heads=heads, rate=0.2),
        "exact_bn": lambda *t: TT.flash_reattention_train_bn(
            *t, eye, zero, torch.ones(heads), zero, seed, num_heads=heads, rate=0.2)[0],
    }
    seen = {}
    for name, run in runs.items():
        calls = []
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with _recording(calls):
            out = run(*leaves)
            torch.autograd.grad((out * g).sum(), leaves)
        seen[name] = len(calls)
    assert seen == {"identity": 1, "general": 0, "exact_bn": 0}


@pytest.mark.parametrize("n_q,n_k", [(64, 64), (16, 64)])
def test_identity_backward_matches_the_jax_kernel(n_q, n_k):
    """(4 heads, dh 48) with the identity mix, rate 0: dq, dk, dv of the
    identity Function on CPU tensors, and of ``train_bwd_identity`` from the
    same lse and D, against the VJP of the JAX ``flash_reattention_train``
    in interpret mode (blocks of 32, so two key steps of its backward), f32;
    no launch counted."""
    heads, dh = 4, 48
    q, k, v, g = _inputs(17, 2, heads, n_q, n_k, dh)
    eye, zero = jnp.eye(heads, dtype=jnp.float32), jnp.zeros(heads, jnp.float32)
    fn = lambda q_, k_, v_: JT.flash_reattention_train(
        q_, k_, v_, eye, zero, 0, num_heads=heads, rate=0.0, block_q=32, block_k=32,
        interpret=True)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]

    t = [torch.from_numpy(a) for a in (q, k, v)]
    g_t = torch.from_numpy(g)
    before = TT.train_bwd.launches, dict(TT.train_bwd.route_launches)
    leaves = [a.clone().requires_grad_() for a in t]
    out = TT.flash_reattention_train(*leaves, torch.eye(heads), torch.zeros(heads), None,
                                      num_heads=heads, identity_mix=True)
    got_fn = torch.autograd.grad((out * g_t).sum(), leaves)
    _, lse = TT.train_fwd_identity(*t, None, 0.0)
    d = (g_t * out.detach()).reshape(2, n_q, heads, dh).sum(-1).transpose(1, 2)
    got = TT.train_bwd_identity(*t, lse, g_t, d, None, 0.0)
    assert (TT.train_bwd.launches, TT.train_bwd.route_launches) == before
    for a, b, w in zip(got_fn, got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(b.numpy(), w, rtol=TOL, atol=TOL)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("n_q,n_k,head_base", [(40, 40, 0), (24, 70, 4)])
def test_identity_backward_plain_matches_the_general_plain(n_q, n_k, head_base):
    """Rate 0.2 with a rank's ``head_base``: ``train_bwd_identity_plain``
    (and ``train_bwd_identity`` on CPU tensors) against ``train_bwd_plain``
    with I and no BN term, within 1e-5 of the largest entry; the mask is
    really there (without dropout dq moves)."""
    heads, dh = 4, 16
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(19, 2, heads, n_q, n_k, dh))
    lse = torch.logsumexp(torch.einsum("bhnd,bhmd->bhnm", q, k), -1)
    d = torch.from_numpy(np.random.default_rng(20).normal(
        size=(2, heads, n_q)).astype(np.float32))
    seed = torch.tensor([23])
    want = TT.train_bwd_plain(q, k, v, lse, g, torch.eye(heads), d, seed, 0.2,
                              head_base=head_base)
    for got in (TT.train_bwd_identity_plain(q, k, v, lse, g, d, seed, 0.2, head_base),
                TT.train_bwd_identity(q, k, v, lse, g, d, seed, 0.2, head_base)):
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-5
    dq0 = TT.train_bwd_identity_plain(q, k, v, lse, g, d, seed, 0.0, head_base)[0]
    assert _rel(dq0, want[0]) > 1e-2
