"""The port's training re-attention, plain versions, against the JAX
package's Pallas kernels run in interpret mode (which run without dropout),
and the port's dropout mask on its own.

With dropout on, JAX's TPU random stream cannot be matched; there the
autograd Functions are held against torch autograd of the N x N plain
forward with the same mask.  The CUDA kernels run only on the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them against these
plain versions there.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.test_torch_model import one_torch_thread  # noqa: F401

JT = importlib.import_module("vit_unet_tpu.kernels.flash_reattention_train")
TT = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")


def _frozen_inputs(n, heads, dh, batch=2, seed=0):
    """As tests/test_kernels_train.py::_random_inputs."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (f(batch, heads, n, dh) * 0.5, f(batch, heads, n, dh) * 0.5,
            f(batch, n, heads * dh), f(heads, heads) * 0.3, f(heads) * 0.1)


def _bn_inputs(n, heads, dh, batch=2, seed=7):
    """As tests/test_kernels_train.py::_bn_inputs: peaked maps keep the map
    variance far above BN's eps."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (f(batch, heads, n, dh) * 1.5, f(batch, heads, n, dh) * 1.5,
            f(batch, n, heads * dh), f(heads, heads) * 0.4, f(heads) * 0.2,
            (1.0 + 0.3 * f(heads)).astype(np.float32), f(heads) * 0.2)


def _t(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _cotangent_loss(out):
    return (out * torch.cos(out)).sum()


# (4, 12) and (4, 48): lite's two deeper levels (kernels 3 and 4 take the
# tensor cores there in bf16), at a small N; (16, 48): the classifier's
# N = 196 level (kernels 2 and 4 take the tensor cores there in bf16)
@pytest.mark.parametrize("n,heads,dh", [(128, 4, 8), (200, 4, 16), (96, 4, 12), (64, 4, 48),
                                        (64, 16, 48)])
def test_frozen_function_matches_jax(n, heads, dh):
    args = _frozen_inputs(n, heads, dh, seed=1)
    jargs = [jnp.asarray(a) for a in args]

    def jloss(*a):
        out = JT.flash_reattention_train(*a, 0, heads, 0.0, 128, 128, True)
        return jnp.sum(out * jnp.cos(out)), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                           has_aux=True)(*jargs)
    targs = _t(args, grad=True)
    before = TT.train_fwd.launches, TT.train_bwd.launches
    out = TT.flash_reattention_train(*targs, num_heads=heads)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    _cotangent_loss(out).backward()
    assert (TT.train_fwd.launches, TT.train_bwd.launches) == before  # CPU: plain
    for name, t, jg in zip("qkvmc", targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=5e-4,
                                   atol=5e-4, err_msg=f"grad d{name}")


@pytest.mark.parametrize("n,heads,dh", [(128, 4, 8), (200, 4, 16), (96, 4, 12), (64, 4, 48),
                                        (64, 16, 48)])
def test_bn_function_and_moments_match_jax(n, heads, dh):
    args = _bn_inputs(n, heads, dh)
    jargs = [jnp.asarray(a) for a in args]
    want, mu_w, var_w = JT.flash_reattention_train_bn(
        *jargs, 0, heads, 0.0, 128, 128, True)
    q, k, v, cm, cc, ga, be = _t(args)
    out, mu, var = TT.flash_reattention_train_bn(q, k, v, cm, cc, ga, be,
                                                 num_heads=heads)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_w), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=5e-4, atol=2e-3)
    mu_m, var_m = TT.flash_bn_batch_moments(q, k, v, cm, cc, num_heads=heads)
    jm, jv = JT.flash_bn_batch_moments(*jargs[:5], 0, heads, 0.0, 128, 128, True)
    np.testing.assert_allclose(mu_m.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var_m.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)


def test_bn_function_grads_match_jax():
    n, heads, dh = 160, 4, 8
    args = _bn_inputs(n, heads, dh, seed=11)

    def jloss(*a):
        out, mu, var = JT.flash_reattention_train_bn(*a, 0, heads, 0.0, 128,
                                                     128, True)
        return jnp.sum(out * jnp.cos(out)) + jnp.sum(mu) + jnp.sum(var)

    jgrads = jax.grad(jloss, argnums=tuple(range(7)))(*(jnp.asarray(a) for a in args))
    targs = _t(args, grad=True)
    out, mu, var = TT.flash_reattention_train_bn(*targs, num_heads=heads)
    (_cotangent_loss(out) + mu.sum() + var.sum()).backward()
    for name, t, jg in zip(["q", "k", "v", "conv_m", "conv_c", "gamma", "beta"],
                           targs, jgrads):
        a, b = t.grad.numpy(), np.asarray(jg)
        tol = 5e-3 * (np.abs(b).max() + 1e-3)
        assert np.abs(a - b).max() <= tol, f"grad d{name}: {np.abs(a - b).max():.3e}"


# --- the dropout mask ----------------------------------------------------------

def test_philox_known_answers():
    """Philox-4x32-10 test vectors."""
    cases = [((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, 0xFFFFFFFFFFFFFFFF,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              0x299F31D0A4093822, (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for (c0, c1, c2, c3), key, want in cases:
        t = lambda x: torch.tensor([x], dtype=torch.int64)
        got = TT.philox4(key, t(c3), t(c2), t(c1), t(c0))
        assert tuple(int(w) for w in got) == want


def test_dropout_keep_rate_and_scale():
    rate = 0.2
    mask = TT.dropout_mask(123, rate, 4, 4, 64, 100)
    kept = (mask > 0).float().mean().item()
    count = mask.numel()
    sigma = (rate * (1 - rate) / count) ** 0.5
    assert abs(kept - (1 - rate)) < 4 * sigma
    assert set(mask.unique().tolist()) == {0.0, np.float32(1 / (1 - rate)).item()}
    assert not torch.equal(mask, TT.dropout_mask(124, rate, 4, 4, 64, 100))


def test_dropout_mask_does_not_depend_on_the_tiling():
    """Any block of rows of the map, generated on its own from its absolute
    row indices, equals that block of the whole map; any block of columns
    is that block of a wider map's."""
    ar = lambda *a: torch.arange(*a)
    full = TT.dropout_bits(99, ar(2), ar(3), ar(70), 150)
    for r0, r1, c0, c1 in [(0, 32, 0, 64), (32, 70, 64, 150), (5, 37, 17, 81)]:
        block = TT.dropout_bits(99, ar(2), ar(3), ar(r0, r1), c1)[..., c0:]
        assert torch.equal(block, full[:, :, r0:r1, c0:c1])
    # the four words of one call go to four columns, 16 apart
    words = TT.philox4(99, ar(1)[:, None], ar(1)[:, None], ar(70)[:, None], ar(16)[None, :])
    for w, word in enumerate(words):
        assert torch.equal(full[0, 0, :, 16 * w:16 * w + 16], word)


@pytest.mark.parametrize("kernel", ["bn_fwd", "bwd"])
def test_plain_versions_by_image_groups(kernel):
    """A plain version of images i.. of a call, given batch_base i, draws
    that call's dropout bits: its groups of images, concatenated, equal the
    whole call's plain version (how a b64 call is held on the card)."""
    batch, heads, n, dh = 5, 4, 70, 12
    q, k, v, m_eff, _, _, _ = _bn_inputs(n, heads, dh, batch=batch)
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, k, v, m_eff = _t((q, k, v, m_eff))
    lse, g, d, g_mat, kappa = (f(batch, heads, n), f(batch, n, heads * dh),
                               f(batch, heads, n), f(heads, heads), f(heads))
    if kernel == "bn_fwd":
        call = lambda s, i: TT.bn_fwd_plain(q[s], k[s], v[s], 17, 0.2, batch_base=i)
    else:
        call = lambda s, i: TT.train_bwd_plain(q[s], k[s], v[s], lse[s], g[s], m_eff, d[s],
                                               17, 0.2, (g_mat, kappa), batch_base=i)
    whole = call(slice(0, batch), 0)
    groups = [call(slice(i, i + 2), i) for i in range(0, batch, 2)]
    for got, want in zip(zip(*groups), whole):
        torch.testing.assert_close(torch.cat(got), want, rtol=1e-6, atol=1e-6)
    # without the base, a later group draws the first group's bits
    first = call(slice(2, 4), 0)
    assert not all(torch.allclose(a, b[2:4]) for a, b in zip(first, whole))


@pytest.mark.parametrize("mode", ["frozen", "bn"])
def test_dropout_grads_match_nxn_autograd(mode):
    """At rate 0.2 the Functions' outputs and grads equal torch autograd of
    the N x N forward (``reattention_nxn``) with the same mask (float64, so
    only the algebra is compared).  The conv bias's gradient is
    d(sum mu)/d cb = 1: BatchNorm removes a uniform shift of the map, so
    the reference's other terms cancel to its rounding."""
    n, heads, dh, rate, seed = 40, 3, 8, 0.2, 77
    if mode == "frozen":
        args = _frozen_inputs(n, heads, dh, seed=4)
    else:
        args = _bn_inputs(n, heads, dh, seed=5)
    targs = [t.double() for t in _t(args)]
    for t in targs:
        t.requires_grad_()
    mask = TT.dropout_mask(seed, rate, 2, heads, n, n).double()
    seed_t = torch.tensor([seed])
    if mode == "frozen":
        got = TT.flash_reattention_train(*targs, seed_t, num_heads=heads, rate=rate)
        want = TT.reattention_nxn(*targs, mask)[0]
        extra_got = extra_want = 0.0
    else:
        got, mu, var = TT.flash_reattention_train_bn(*targs, seed_t,
                                                     num_heads=heads, rate=rate)
        want, (mu_w, var_w) = TT.reattention_nxn(*targs[:5], mask, norm=targs[5:])
        extra_got, extra_want = mu.sum() + var.sum(), mu_w.sum() + var_w.sum()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    g_got = torch.autograd.grad(_cotangent_loss(got) + extra_got, targs)
    g_want = torch.autograd.grad(_cotangent_loss(want) + extra_want, targs)
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=f"grad {i}")
