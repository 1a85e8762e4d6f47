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
from tests.test_torch_model import one_torch_thread  # noqa: F401

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


# --- the kernel's two routes ---------------------------------------------------

def _level_shapes():
    """(preset, heads, dh) of every re-attention level of the presets, and
    the 16-head cases the card run holds."""
    from vit_unet_tpu_torch.models import get_config
    cases = []
    for name in ("lite", "base", "large"):
        cfg = get_config(name)
        for level in range(cfg.depth + 1):
            dim = cfg.level_geometry(level)["projection_dim"]
            cases.append((name, cfg.num_heads, dim // cfg.num_heads))
    from vit_unet_tpu_torch.models.hvit_unet_tf import HViTUNetTFConfig
    tf = HViTUNetTFConfig()   # level 0's keras attention: key_dim C * p0^2
    return cases + [("16 heads", 16, 12), ("16 heads", 16, 48),
                    ("HViTUNetTF", tf.num_heads, tf.num_channels * tf.patch_size[0] ** 2)]


@pytest.mark.parametrize("preset,heads,dh", _level_shapes())
def test_kernel_route_by_dtype_and_shape(preset, heads, dh):
    # float32: lite's levels on the split-precision tensor-core route, every
    # other level on the CUDA cores
    want32 = "tensor_core_f32" if preset == "lite" else "cuda_core"
    assert TK.kernel_route(torch.float32, heads, dh) == want32
    assert ((heads, dh) in TK.TENSOR_CORE_F32_SHAPES) == (preset == "lite")
    route = TK.kernel_route(torch.bfloat16, heads, dh)
    assert route in TK.ROUTES
    # every level shape of the presets has a tensor-core kernel
    assert route == "tensor_core"
    assert (heads, dh) in TK.TENSOR_CORE_SHAPES
    if preset == "base":
        assert (heads, dh) in {(8, 384), (8, 96), (8, 24)}
    # the route depends on nothing but dtype and (heads, dh)
    assert TK.kernel_route(torch.bfloat16, heads, dh + 4) == "cuda_core"
    assert TK.kernel_route(torch.bfloat16, heads + 1, dh) == "cuda_core"


@pytest.mark.parametrize("n_q,n_k,heads,dh", [(49, 49, 8, 24), (20, 9, 4, 12)])
def test_cpu_bf16_takes_the_plain_version(n_q, n_k, heads, dh):
    args = [torch.from_numpy(a) for a in inputs(3, 2, heads, n_q, n_k, dh)]
    args = [t.bfloat16() for t in args[:3]] + args[3:]
    before = (TK.flash_reattention.launches,
              dict(TK.flash_reattention.route_launches))
    got = TK.flash_reattention(*args, num_heads=heads)
    want = TK.flash_reattention_plain(*args, num_heads=heads)
    assert (TK.flash_reattention.launches,
            TK.flash_reattention.route_launches) == before
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# --- the build: a library's hash follows its own includes only -----------------

def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    from vit_unet_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n#include <cuda.h>\nint a;\n')
    (tmp_path / "b.cu").write_text('  #  include "other.cuh"\nint b;\n')
    (tmp_path / "common.cuh").write_text('#pragma once\n#include "deep.cuh"\n')
    (tmp_path / "deep.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    assert [p.name for p in _build.source_closure("a.cu")] == [
        "a.cu", "common.cuh", "deep.cuh"]
    a0, b0 = _build.library_path("a.cu"), _build.library_path("b.cu")
    assert a0.name.startswith("a-") and a0 != b0

    (tmp_path / "deep.cuh").write_text("// v2\n")     # included through common.cuh
    a1 = _build.library_path("a.cu")
    assert a1 != a0 and _build.library_path("b.cu") == b0
    (tmp_path / "other.cuh").write_text("// v2\n")    # not included by a.cu
    assert _build.library_path("a.cu") == a1 and _build.library_path("b.cu") != b0
    (tmp_path / "a.cu").write_text('#include "common.cuh"\nint a2;\n')
    assert _build.library_path("a.cu") != a1


def test_each_library_hashes_its_own_headers():
    from vit_unet_tpu_torch.kernels import _build
    names = lambda src: [p.name for p in _build.source_closure(src)]
    # the eval source includes the training forward's header for kernel 1's
    # f32 route at lite's classes, and through it the backward's helpers
    assert names("flash_reattention.cu") == [
        "flash_reattention.cu", "attention_identity_f32.cuh", "attention_identity_tc.cuh",
        "reattention_bnfwd_tc.cuh", "reattention_bwd_tc.cuh", "reattention_common.cuh",
        "reattention_mma.cuh", "reattention_tc.cuh", "reattention_tiles.cuh"]
    assert names("flash_reattention_train.cu") == [
        "flash_reattention_train.cu", "attention_identity_bwd.cuh",
        "attention_identity_f32.cuh", "attention_identity_tc.cuh",
        "reattention_bnfwd16_tc.cuh", "reattention_bnfwd_tc.cuh", "reattention_bwd_tc.cuh",
        "reattention_common.cuh", "reattention_mma.cuh", "reattention_tc.cuh",
        "reattention_tiles.cuh"]
