"""The QKV projection's two forms in the port, on the CPU, float32: the
conv written as a dense (E, E) operator (``conv_token_matrix``) against the
JAX package's, and ``ReAttention`` / ``SkipConnection`` forward and
gradients in the matmul form against JAX (which takes the matmul form at
E <= 256 and the conv at wider levels) and against the port's conv form,
all at 1e-4 of the largest value, with randomised BatchNorm statistics."""
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import randomised, one_torch_thread  # noqa: F401
from vit_unet_tpu.nn import reattention as JR
from vit_unet_tpu_torch.nn.reattention import (
    ReAttention, SkipConnection, conv_token_matrix, conv_tokens, qkv_form,
)
from vit_unet_tpu_torch.utils.jax_import import flax_to_state_dict, load_flax_variables

RA = importlib.import_module("vit_unet_tpu_torch.nn.reattention")
TOL = 1e-4      # of the largest value: f32 sums in other orders


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f"{what}: {err:.3e}"


@pytest.mark.parametrize("c,p,k", [(3, 8, 3), (3, 4, 1), (2, 5, 3), (3, 16, 3)])
def test_conv_token_matrix_matches_jax_and_the_conv(c, p, k):
    w = np.random.default_rng(k * p).standard_normal((c, c, k, k)).astype(np.float32)
    want = np.asarray(JR.conv_token_matrix(jnp.asarray(w.transpose(2, 3, 1, 0)), c, p))
    got = conv_token_matrix(torch.from_numpy(w), c, p)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 5, c * p * p)).astype(np.float32))
    _close(x @ got.T, conv_tokens(x, torch.from_numpy(w), c), 1e-6, "x M^T vs conv")


def test_qkv_form_is_one_function_of_width_and_dtype():
    """Base's level widths, by dtype: bf16 takes the matmul form at every
    level of the presets, f32 at E <= 192 only."""
    assert [qkv_form(e, torch.bfloat16) for e in (48, 192, 768, 3072)] == ["matmul"] * 4
    assert [qkv_form(e, torch.float32) for e in (48, 192, 193, 768, 3072)] == [
        "matmul", "matmul", "conv", "conv", "conv"]
    assert qkv_form(12288, torch.bfloat16) == "conv"
    assert qkv_form(192, torch.float16) == "conv"


@pytest.mark.parametrize("form", ["matmul", "conv"])
def test_qkv_follows_the_gate(form):
    layer = ReAttention(48, num_heads=4)
    x = torch.randn(2, 16, 48)
    with mock.patch.object(RA, "qkv_form", lambda e, dt: form), \
            mock.patch.object(ReAttention, f"_qkv_{form}", autospec=True,
                              side_effect=lambda self, *a: ("picked",)) as pick:
        assert layer._qkv(x, x, x) == ("picked",)
    pick.assert_called_once()


def _jax_fwd_grads(jmod, variables, args, cot):
    """JAX eval forward, and the gradients of sum(out * cot) in the
    parameters (port names) and in each input."""
    def f(params, *xs):
        out = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                         *xs, deterministic=True, use_running_average=True)
        return jnp.sum(out * cot), out
    jargs = [jnp.asarray(a) for a in args]
    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(args) + 1)), has_aux=True))(variables["params"], *jargs)
    return np.asarray(out), grads


def _port_fwd_grads(tmod, args, cot, form):
    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    if len(xs) == 3 and args[1] is args[2]:
        xs[2] = xs[1]                       # key and value: one tensor
    with mock.patch.object(RA, "qkv_form", lambda e, dt: form):
        out = tmod(*xs)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = {k: p.grad.numpy() for k, p in tmod.named_parameters() if p.grad is not None}
    tmod.zero_grad(set_to_none=True)
    return out.detach().numpy(), grads, [x.grad.numpy() for x in xs[:len(set(map(id, xs)))]]


@pytest.mark.parametrize("dim,heads", [(48, 4), (192, 8), (768, 8)])
def test_reattention_matmul_form_matches_jax_and_conv_form(dim, heads):
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((2, 16, dim)).astype(np.float32)
    cot = rng.standard_normal((2, 16, dim)).astype(np.float32)
    jmod = JR.ReAttention(dim=dim, num_heads=heads, use_flash=False)
    variables = randomised(jmod.init(jax.random.key(0), jnp.asarray(x)))
    want, jgrads = _jax_fwd_grads(jmod, variables, (x,), cot)
    want_p = flax_to_state_dict({"params": jgrads[0]})
    tmod = load_flax_variables(ReAttention(dim, num_heads=heads), variables)
    got = {form: _port_fwd_grads(tmod, (x,), cot, form) for form in ("matmul", "conv")}
    out, grads, (gx,) = got["matmul"]
    _close(out, want, what="forward vs JAX")
    _close(gx, np.asarray(jgrads[1]), what="dx vs JAX")
    gmax = max(np.abs(g.numpy()).max() for g in want_p.values())
    for key, g in want_p.items():
        _close(grads[key] / gmax, g.numpy() / gmax, what=f"{key} vs JAX")
    c_out, c_grads, (c_gx,) = got["conv"]
    _close(out, c_out, what="matmul vs conv form")
    _close(gx, c_gx, what="dx, matmul vs conv form")
    for key in ("qconv2d.weight", "kconv2d.weight", "vconv2d.weight"):
        _close(grads[key], c_grads[key], what=f"{key}, matmul vs conv form")


@pytest.mark.parametrize("dim", [48, 768])
def test_skip_connection_matmul_form_matches_jax_and_conv_form(dim):
    rng = np.random.default_rng(dim + 1)
    q, k = (rng.standard_normal((2, 16, dim)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal((2, 16, dim)).astype(np.float32)
    jmod = JR.SkipConnection(dim=dim, num_heads=4)
    variables = randomised(jmod.init(jax.random.key(0), *(jnp.asarray(a) for a in (q, k, k))))
    want, jgrads = _jax_fwd_grads(jmod, variables, (q, k, k), cot)
    want_p = flax_to_state_dict({"params": jgrads[0]["attn"]})
    inner = {col: tree["attn"] for col, tree in variables.items()}
    tmod = load_flax_variables(SkipConnection(dim, num_heads=4), inner)
    got = {form: _port_fwd_grads(tmod, (q, k, k), cot, form) for form in ("matmul", "conv")}
    out, grads, (gq, gk) = got["matmul"]
    _close(out, want, what="forward vs JAX")
    _close(gq, np.asarray(jgrads[1]), what="dq vs JAX")
    _close(gk, np.asarray(jgrads[2]) + np.asarray(jgrads[3]), what="dk+dv vs JAX")
    gmax = max(np.abs(g.numpy()).max() for g in want_p.values())
    for key, g in want_p.items():
        _close(grads[key] / gmax, g.numpy() / gmax, what=f"{key} vs JAX")
    c_out, c_grads, (c_gq, c_gk) = got["conv"]
    _close(out, c_out, what="matmul vs conv form")
    _close(gq, c_gq, what="dq, matmul vs conv form")
    _close(gk, c_gk, what="dk, matmul vs conv form")
    for key in ("qconv2d.weight", "kconv2d.weight", "vconv2d.weight"):
        _close(grads[key], c_grads[key], what=f"{key}, matmul vs conv form")


def test_matmul_form_trains_after_inference():
    """The operator's cached window basis, first made under inference_mode
    (serving), serves a training step after it."""
    layer = ReAttention(27, num_channels=3, num_heads=3)
    x = torch.randn(2, 4, 27)
    with torch.inference_mode():
        layer._qkv_matmul(x, x, x)
    q, k, v = layer._qkv_matmul(x, x, x)
    (q.sum() + k.sum() + v.sum()).backward()
    assert layer.qconv2d.weight.grad is not None
