"""Kernel 1's identity-mix routes (bfloat16 and float32): which calls take
them, who asks for them, and the plain version against the JAX package's
Pallas kernel (interpret mode) with the identity head mix.

The routes' CUDA kernels (``csrc/attention_identity_tc.cuh``,
``csrc/attention_identity_f32.cuh``) run only on the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them against the
plain version there.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.test_torch_model import one_torch_thread  # noqa: F401

JK = importlib.import_module("vit_unet_tpu.kernels.flash_reattention")
TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
mha = importlib.import_module("vit_unet_tpu_torch.nn.mha")

TOL = 1e-4


@pytest.mark.parametrize("dtype,heads,dh,flag,want", [
    (torch.bfloat16, 8, 192, True, "identity_tc"),     # HViTUNetTF's level 0
    (torch.bfloat16, 4, 192, True, "identity_tc"),     # a rank's heads at model 2
    (torch.bfloat16, 8, 192, False, "tensor_core"),    # without the flag: two passes
    (torch.bfloat16, 4, 192, False, "tensor_core"),
    (torch.float32, 8, 192, True, "identity_f32"),     # f32: split precision
    (torch.float32, 4, 192, True, "identity_f32"),
    (torch.float32, 8, 192, False, "cuda_core"),       # f32 without the flag
    (torch.bfloat16, 8, 96, True, "tensor_core"),      # other classes keep theirs
    (torch.bfloat16, 16, 12, True, "tensor_core"),
    (torch.bfloat16, 2, 192, True, "cuda_core"),
    (torch.bfloat16, 8, 128, True, "cuda_core"),
])
def test_kernel_route_names_the_identity_route_only_with_the_flag(dtype, heads, dh, flag,
                                                                   want):
    assert TK.kernel_route(dtype, heads, dh, identity_mix=flag) == want
    assert TK.kernel_route(dtype, heads, dh) == TK.kernel_route(dtype, heads, dh, False)
    assert want in TK.ROUTES
    assert TK.IDENTITY_TC_SHAPES == {(8, 192), (4, 192)}


def _recorded(monkeypatch):
    calls = []

    def fake(q, k, v_cat, w, b, *, num_heads, identity_mix=False):
        calls.append(identity_mix)
        return TK.flash_reattention_plain(q, k, v_cat, w, b, num_heads=num_heads)
    monkeypatch.setattr(mha, "flash_reattention", fake)
    return calls


def test_keras_mha_eval_tells_kernel_1_its_mix_is_the_identity(monkeypatch):
    calls = _recorded(monkeypatch)
    torch.manual_seed(0)
    layer = mha.KerasMHA(dim=16, num_heads=4, key_dim=8)
    x, y = torch.randn(2, 10, 16), torch.randn(2, 6, 16)
    with torch.no_grad():
        got = layer(x, y)                      # cross-attention, Nq 10 of Nk 6
        layer.use_flash = False
        want = layer(x, y)
    assert calls == [True]
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_keras_mha_training_does_not_call_kernel_1(monkeypatch):
    calls = _recorded(monkeypatch)
    layer = mha.KerasMHA(dim=16, num_heads=4, key_dim=8, dropout=0.2)
    gen = torch.Generator().manual_seed(1)
    layer(torch.randn(2, 10, 16), torch.randn(2, 10, 16), deterministic=False,
          generator=gen).sum().backward()
    assert calls == []


def _identity_inputs(seed, batch, heads, n_q, n_k, dh):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q = f(batch, heads, n_q, dh) * np.float32(dh ** -0.5)
    k, v = f(batch, heads, n_k, dh), f(batch, n_k, heads * dh)
    w, b = (np.array(a) for a in JK.expand_reattention_affine(
        jnp.eye(heads, dtype=jnp.float32), jnp.zeros(heads, jnp.float32), dh=dh))
    return q, k, v, w, b


@pytest.mark.parametrize("n_q,n_k", [(64, 64), (16, 64)])
def test_identity_call_matches_the_jax_kernel(n_q, n_k):
    """(4 heads, dh 48) with the identity affine, as the keras attention
    calls it (the 16-query case as the skip connections' cross-attention):
    the port's call with ``identity_mix=True`` on CPU tensors (its plain
    version) against the JAX Pallas kernel in interpret mode, f32."""
    heads, dh = 4, 48
    args = _identity_inputs(5, 2, heads, n_q, n_k, dh)
    want = np.asarray(JK.flash_reattention(
        *(jnp.asarray(a) for a in args), num_heads=heads, block_q=128, block_k=128,
        interpret=True))
    before = TK.flash_reattention.launches, dict(TK.flash_reattention.route_launches)
    got = TK.flash_reattention(*(torch.from_numpy(a) for a in args), num_heads=heads,
                               identity_mix=True)
    assert (TK.flash_reattention.launches, TK.flash_reattention.route_launches) == before
    assert got.shape == (2, n_q, heads * dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # with the identity mix the function is each head's softmax attention
    q, k, v = (torch.from_numpy(a) for a in args[:3])
    vh = v.view(2, n_k, heads, dh).transpose(1, 2)
    attn = torch.softmax(q @ k.transpose(-1, -2), -1) @ vh
    np.testing.assert_allclose(got.numpy(), attn.transpose(1, 2).reshape(2, n_q, -1).numpy(),
                               rtol=TOL, atol=TOL)


class _Identity(torch.nn.Module):
    def forward(self, q, k, v, w, b):
        return TK.flash_reattention(q, k, v, w, b, num_heads=4, identity_mix=True)


def test_export_records_the_identity_flag():
    """An exported program keeps the flag on the operator, so that a loaded
    program takes the identity route on the card; on the CPU it runs the
    plain version."""
    args = tuple(torch.from_numpy(a) for a in _identity_inputs(6, 1, 4, 16, 16, 8))
    program = torch.export.export(_Identity(), args)
    ops = [n for n in program.graph.nodes
           if n.op == "call_function" and "flash_reattention" in str(n.target)]
    assert len(ops) == 1
    node = ops[0]
    flag = node.kwargs.get("identity_mix", node.args[6] if len(node.args) > 6 else None)
    assert flag is True
    torch.testing.assert_close(program.module()(*args),
                               TK.flash_reattention_plain(*args, num_heads=4), rtol=0, atol=0)
