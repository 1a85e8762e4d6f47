"""The port's model export (``torch.export``) and ``load_predictor`` on the
CPU, against ``Predictor``."""
import importlib

import numpy as np
import pytest
import torch

from vit_unet_tpu_torch import Predictor, get_hvit_unet_tf, get_vit_unet
from vit_unet_tpu_torch.nn import reattention as R
from vit_unet_tpu_torch.serving import PROGRAM, export_predictor, load_predictor
from tests.test_torch_model import one_torch_thread  # noqa: F401

FR = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")
TINY = dict(depth=2, depth_te=1, size_bottleneck=1, im_size=64, patch_size=16,
            hidden_dim=32, num_heads=4, attn_drop=0.0, proj_drop=0.0)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A model, its outputs on fixed inputs before any export, and its
    program exported at batch 4 with the window-basis cache empty."""
    model = get_vit_unet("lite", device="cpu", seed=3, **TINY)
    x = np.random.default_rng(0).standard_normal((9, 3, 64, 64)).astype(np.float32)
    before = Predictor(model, batch_size=4, device="cpu")(x)
    R._window_basis_cached.cache_clear()
    path = str(tmp_path_factory.mktemp("program"))
    export_predictor(model, path, batch_size=4)
    return model, x, before, path


@pytest.fixture(scope="module")
def loaded(exported):
    return load_predictor(exported[-1], device="cpu")


def test_program_records_the_kernel_op(exported):
    *_, path = exported
    program = torch.export.load(f"{path}/{PROGRAM}")
    ops = [n.target for n in program.graph.nodes
           if n.op == "call_function" and "flash_reattention" in str(n.target)]
    assert ops and all(op._name == "vit_unet_tpu_torch::flash_reattention"
                       for op in ops)
    assert FR.flash_reattention_op._opoverload in ops


@pytest.mark.parametrize("n", [1, 4, 9, 0])
def test_loaded_program_matches_predictor(exported, loaded, n):
    _, x, before, _ = exported
    got = loaded(x[:n])
    assert got.shape == (n, 3, 64, 64) and got.dtype == np.float32
    np.testing.assert_array_equal(got, before[:n])


def test_loaded_program_single_sample(exported, loaded):
    _, x, before, _ = exported
    got = loaded(x[2])
    assert got.shape == (3, 64, 64)
    np.testing.assert_array_equal(got, before[2])


def test_eager_forward_unchanged_after_export(exported):
    """Tracing must not leave a placeholder tensor in the window-basis
    cache: the eager forward after the export gives the same numbers."""
    model, x, before, _ = exported
    after = Predictor(model, batch_size=4, device="cpu")(x)
    np.testing.assert_array_equal(after, before)
    assert R._window_basis_cached.cache_info().currsize > 0
    for p in (4, 8):
        basis = R._window_basis(3, p, torch.device("cpu"), torch.float32)
        assert type(basis) is torch.Tensor


def test_load_predictor_needs_cuda_unless_told(exported, monkeypatch):
    *_, path = exported
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor(path)


def test_op_matches_plain_and_counts_nothing_on_cpu():
    rng = np.random.default_rng(1)
    b, h, n, dh = 2, 4, 9, 8
    q, k = (torch.from_numpy(rng.standard_normal((b, h, n, dh)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((b, n, h * dh)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((h, h)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(h).astype(np.float32))
    w, bias = FR.expand_reattention_affine(m, c, dh=dh)
    before = FR.flash_reattention.launches
    want = FR.flash_reattention_plain(q, k, v, w, bias, num_heads=h)
    torch.testing.assert_close(FR.flash_reattention(q, k, v, w, bias, num_heads=h),
                               want, rtol=0, atol=0)
    torch.testing.assert_close(
        torch.ops.vit_unet_tpu_torch.flash_reattention(q, k, v, w, bias, h),
        want, rtol=0, atol=0)
    assert FR.flash_reattention.launches == before


# --- the rest of the model family ---------------------------------------------

TF_SMALL = dict(img_size=32, patch_size=(4, 8), transformer_layers=(1,),
                size_bottleneck=1, num_heads=2)
FAMILY = {   # name -> (a function making the model, per-sample input shape)
    "tf_default": (lambda: get_hvit_unet_tf(device="cpu", seed=4, **TF_SMALL),
                   (32, 32, 3)),
    "tf_reattention": (lambda: get_hvit_unet_tf(device="cpu", seed=5, **TF_SMALL,
                                                original_attn=False), (32, 32, 3)),
    "tf_conv_resampling": (lambda: get_hvit_unet_tf(device="cpu", seed=6, **TF_SMALL,
                                                    resampling_type="conv"),
                           (32, 32, 3)),
    "fourier": (lambda: get_vit_unet("lite", device="cpu", seed=7, **TINY,
                                     block_type="fourier"), (3, 64, 64)),
    "remat": (lambda: get_vit_unet("lite", device="cpu", seed=8, **TINY, remat=True),
              (3, 64, 64)),
    "bf16": (lambda: get_vit_unet("lite", device="cpu", seed=9, **TINY,
                                  dtype="bfloat16"), (3, 64, 64)),
}


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_family_round_trips_bit_for_bit(name, tmp_path):
    """``HViTUNetTF`` in its default, re-attention and conv-resampling
    forms, and ViTUNet with the Fourier block, ``remat`` and bf16: each
    program loads back and serves what ``Predictor`` serves, bit for bit."""
    build, shape = FAMILY[name]
    model = build()
    x = np.random.default_rng(2).standard_normal((5, *shape)).astype(np.float32)
    before = Predictor(model, batch_size=2, device="cpu")(x)
    export_predictor(model, str(tmp_path), batch_size=2)
    got = load_predictor(str(tmp_path), device="cpu")(x)
    assert got.shape == before.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, before)
