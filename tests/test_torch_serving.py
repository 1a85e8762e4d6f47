"""The port's Predictor, its device rule, and the port's import hygiene."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from vit_unet_tpu_torch import Predictor, get_vit_unet
from tests.test_torch_model import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(depth=2, depth_te=1, size_bottleneck=1, im_size=64, patch_size=16,
            hidden_dim=32, num_heads=4, attn_drop=0.0, proj_drop=0.0)


@pytest.fixture(scope="module")
def model():
    return get_vit_unet("lite", device="cpu", seed=3, **TINY)


@pytest.mark.parametrize("n", [0, 1, 5, 9])
def test_predictor_matches_model(model, n):
    x = np.random.default_rng(n).standard_normal((n, 3, 64, 64)).astype(np.float32)
    got = Predictor(model, batch_size=4, device="cpu")(x)
    assert got.shape == x.shape and got.dtype == np.float32
    if n:
        with torch.no_grad():
            want = model(torch.from_numpy(x)).numpy()
        # padding rows never leak into real ones: same numbers as unpadded
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_predictor_single_sample(model):
    x = np.random.default_rng(7).standard_normal((3, 64, 64)).astype(np.float32)
    pred = Predictor(model, batch_size=4, device="cpu")
    np.testing.assert_allclose(pred(x), pred(x[None])[0], rtol=0, atol=0)


def test_entry_points_need_cuda_unless_told(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_vit_unet("lite", **TINY)


def test_same_seed_same_weights():
    a = get_vit_unet("lite", device="cpu", seed=11, **TINY).state_dict()
    b = get_vit_unet("lite", device="cpu", seed=11, **TINY).state_dict()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


def test_port_never_imports_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax, flax, optax, orbax or the JAX package, and without
    building anything."""
    code = (
        "import pkgutil, sys, importlib, vit_unet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'orbax', 'vit_unet_tpu')]\n"
        "from vit_unet_tpu_torch.data import _native\n"
        "assert _native._codec is None\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_port_sources_do_not_name_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|vit_unet_tpu)\b"
                         r"|vit_unet_tpu\.(?!\w*torch)", re.M)
    sources = [*(REPO / "vit_unet_tpu_torch").rglob("*.py"),
               REPO / "chip_smoke.py"]
    hits = [str(p) for p in sources
            if pattern.search(re.sub(r"vit_unet_tpu_torch", "", p.read_text()))]
    assert not hits, hits
