"""The port's utilities: ``softmax_top`` against JAX, ``seed_everything``,
``StageTimer``, ``annotate``/``trace`` and ``visualize`` (Agg)."""
import json
import os
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_unet_tpu.ops.sparse import softmax_top as jax_softmax_top
from vit_unet_tpu_torch.ops.sparse import softmax_top
from vit_unet_tpu_torch.utils import profiling, visualize
from vit_unet_tpu_torch.utils.seeding import seed_everything
from tests.test_torch_model import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape,top,axis", [((4, 10), 3, -1), ((2, 3, 7), 2, 1),
                                            ((5, 6), 6, -1), ((3, 8), 1, 0)])
def test_softmax_top_matches_jax(shape, top, axis):
    x = np.random.default_rng(top).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_softmax_top(jnp.asarray(x), top, axis=axis))
    got = softmax_top(torch.from_numpy(x), top, axis=axis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert ((got > 0).sum(axis=axis) == min(top, shape[axis])).all()


def test_seed_everything_reproducible():
    draws = []
    for _ in range(2):
        gen = seed_everything(7, device="cpu")
        assert isinstance(gen, torch.Generator) and gen.device.type == "cpu"
        draws.append((random.random(), np.random.random(), torch.rand(3).tolist(),
                      torch.rand(3, generator=gen).tolist()))
    assert draws[0] == draws[1]
    assert os.environ["PYTHONHASHSEED"] == "7"


def test_seed_everything_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seed_everything(1)


def test_stage_timer():
    t = profiling.StageTimer()
    for _ in range(3):
        with t.stage("a"):
            time.sleep(0.01)
    with t.stage("b"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert 0.03 <= s["a"]["total_s"] < 1.0
    assert abs(s["a"]["mean_s"] - s["a"]["total_s"] / 3) < 1e-3
    assert "a: n=3" in t.report()


def test_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("stage_one"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "stage_one" in names
    with open(tmp_path / "trace.json") as f:
        assert "stage_one" in json.dumps(json.load(f))


def test_device_memory_report_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_memory_report()


def test_visualize_writes_files(tmp_path):
    rng = np.random.default_rng(0)
    xs = rng.random((3, 3, 16, 16)).astype(np.float32)
    fig = visualize.prediction_grid(xs, torch.from_numpy(xs), xs, n=2,
                                    path=str(tmp_path / "grid.png"))
    assert fig is not None and (tmp_path / "grid.png").stat().st_size > 0
    visualize.plot_history({"loss": [1.0, 0.5], "val_loss": [1.1, 0.6],
                            "lr": [1e-3, 1e-3]}, path=str(tmp_path / "h.png"))
    visualize.pair_grid(xs[:, :1], xs, n=3, path=str(tmp_path / "p.png"))
    assert (tmp_path / "h.png").exists() and (tmp_path / "p.png").exists()
