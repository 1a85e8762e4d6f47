"""The port's flash re-attention, plain version, against the JAX package's
Pallas kernel run in interpret mode, and the head-mix folding around it.

The CUDA kernel itself runs only on the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold it against this plain version there.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages re-export the function under the module's name
JK = importlib.import_module("vit_unet_tpu.kernels.flash_reattention")
TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")

TOL = 1e-4


def inputs(seed, batch, heads, n_q, n_k, dh):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q = f(batch, heads, n_q, dh) * np.float32(dh ** -0.5)
    k, v = f(batch, heads, n_k, dh), f(batch, n_k, heads * dh)
    m, c = f(heads, heads), f(heads)
    w, b = (np.asarray(a) for a in JK.expand_reattention_affine(
        jnp.asarray(m), jnp.asarray(c), dh=dh))
    return q, k, v, w, b


@pytest.mark.parametrize("n_q,n_k,heads,dh", [
    (128, 128, 4, 8), (200, 200, 8, 4), (49, 49, 8, 24), (196, 196, 4, 192),
    (96, 200, 4, 8),    # rectangular (sequence-parallel / cross shapes)
])
def test_plain_flash_matches_jax_kernel(n_q, n_k, heads, dh):
    args = inputs(0, 2, heads, n_q, n_k, dh)
    want = np.asarray(JK.flash_reattention(
        *(jnp.asarray(a) for a in args), num_heads=heads, block_q=128,
        block_k=128, interpret=True))
    before = TK.flash_reattention.launches
    got = TK.flash_reattention(*(torch.from_numpy(a) for a in args),
                               num_heads=heads)
    assert TK.flash_reattention.launches == before   # CPU: plain, no launch
    assert got.shape == (2, n_q, heads * dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_fold_and_expand_match_jax():
    rng = np.random.default_rng(1)
    heads, dh = 4, 8
    ck = rng.standard_normal((1, 1, heads, heads)).astype(np.float32)  # flax
    cb, scale, bias, mean = (rng.standard_normal(heads).astype(np.float32)
                             for _ in range(4))
    var = rng.uniform(0.5, 2.0, heads).astype(np.float32)
    want_m, want_c = JK.fold_reattention_compact(
        jnp.asarray(ck), *(jnp.asarray(a) for a in (cb, scale, bias, mean, var)),
        eps=1e-5, reatten_scale=0.5)
    # torch conv weight (out, in, 1, 1) = flax kernel (1, 1, in, out) transposed
    tw = torch.from_numpy(ck.transpose(3, 2, 0, 1).copy())
    got_m, got_c = TK.fold_reattention_compact(
        tw, *(torch.from_numpy(a) for a in (cb, scale, bias, mean, var)),
        eps=1e-5, reatten_scale=0.5)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6, atol=1e-6)

    want_w, want_b = JK.expand_reattention_affine(want_m, want_c, dh=dh)
    got_w, got_b = TK.expand_reattention_affine(got_m, got_c, dh=dh)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["k_shape", "v_shape", "heads", "w_shape"])
def test_wrapper_rejects_bad_shapes(bad):
    q, k, v, w, b = (torch.from_numpy(a) for a in inputs(2, 1, 4, 16, 16, 8))
    heads = 4
    if bad == "k_shape":
        k = k[:, :, :, :4]
    elif bad == "v_shape":
        v = v[:, :8]
    elif bad == "heads":
        heads = 2
    else:
        w = w[:, :16]
    with pytest.raises(ValueError):
        TK.flash_reattention(q, k, v, w, b, num_heads=heads)
