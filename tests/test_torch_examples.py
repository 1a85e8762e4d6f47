"""The port's example scripts (``vit_unet_tpu_torch/cli/``) on the CPU: the
cubic resize against ``jax.image.resize``, the warmup-cosine schedule
against optax, the synthetic data against the JAX scripts' own functions
from the same seeds, and each script's ``main`` with its constants made
tiny, writing ``CONVERGENCE_torch.json`` under ``tmp_path``.

The JAX scripts are loaded from ``examples/`` by path; they set JAX's
compilation-cache options when imported, which are put back after.
"""
import importlib.util
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax._src.image import scale as jax_scale

from tests.test_torch_model import one_torch_thread  # noqa: F401
from vit_unet_tpu_torch.cli import _convergence
from vit_unet_tpu_torch.cli import convergence_segmentation as TSEG
from vit_unet_tpu_torch.cli import convergence_sidd as TSIDD
from vit_unet_tpu_torch.cli import convert_tfrecords, serve_model, train_denoising
from vit_unet_tpu_torch.data import tfrecord
from vit_unet_tpu_torch.ops.resize import cubic_weights, resize_cubic
from vit_unet_tpu_torch.train.schedules import warmup_cosine_decay_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_OPTIONS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")


def _jax_example(name: str):
    saved = {k: getattr(jax.config, k) for k in _CACHE_OPTIONS}
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def jax_examples():
    return _jax_example("convergence_segmentation"), _jax_example("convergence_sidd")


# --- the cubic resize and the schedule ------------------------------------------

@pytest.mark.parametrize("shape,out,tol", [
    ((3, 2, 8, 8), (3, 2, 128, 128), 1e-6),     # the data generators' resize
    ((2, 5, 11), (2, 13, 4), 2e-6),             # odd sizes, up and down
])
def test_cubic_resize_is_jax_image_resize(shape, out, tol):
    """At odd sizes XLA's jitted weights differ from the eager weight
    matrix by up to ~5e-7 each, so the whole resize is held at 2e-6 there
    and the weights bit for bit against the eager matrix."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, "cubic"))
    got = resize_cubic(x, out)
    assert got.dtype == np.float32 and got.shape == out
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for n_in, n_out in zip(shape, out):
        if n_in != n_out:
            eager = jax_scale.compute_weight_mat(
                n_in, n_out, n_out / n_in, 0.0, jax_scale._fill_keys_cubic_kernel, True)
            np.testing.assert_array_equal(cubic_weights(n_in, n_out), np.asarray(eager))


def test_cubic_resize_is_not_torch_bicubic():
    x = np.random.default_rng(1).standard_normal((1, 1, 8, 8)).astype(np.float32)
    torch_bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=(32, 32), mode="bicubic", align_corners=False)
    assert np.abs(resize_cubic(x, (1, 1, 32, 32)) - torch_bicubic.numpy()).max() > 1e-2


@pytest.mark.parametrize("args", [(0.0, 1e-3, 5, 20), (1e-4, 3e-4, 3, 11, 1e-5, 2.0)])
def test_warmup_cosine_is_optax(args):
    """Every step of the schedule and a few past its end, to optax's
    float32 rounding (1e-6 of the peak)."""
    mine = warmup_cosine_decay_schedule(*args)
    theirs = optax.warmup_cosine_decay_schedule(*args)
    for step in range(args[3] + 5):
        np.testing.assert_allclose(mine(step), float(theirs(step)), rtol=1e-6,
                                   atol=1e-6 * args[1], err_msg=str(step))


# --- the synthetic data ----------------------------------------------------------

def test_datasets_are_the_jax_scripts(jax_examples, monkeypatch):
    """The same images (to the resize's rounding), masks, pairs and floor
    from the same seeds."""
    jseg, jsidd = jax_examples
    imgs, masks = TSEG.make_dataset(4, 0)
    jimgs, jmasks = jseg.make_dataset(4, 0)
    np.testing.assert_allclose(imgs, jimgs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(masks, jmasks)
    assert TSEG.threshold_floor(imgs, masks) == pytest.approx(
        jseg.threshold_floor(jimgs, jmasks), abs=1e-6)
    for got, want in zip(TSIDD.make_pairs(3, 777), jsidd.make_pairs(3, 777)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for name in ("IM", "N_TRAIN", "N_VAL", "BATCH", "EPOCHS"):
        assert getattr(TSEG, name) == getattr(jseg, name), name
    for name in ("IM", "N_TRAIN", "N_VAL", "BATCH", "NOISE_SIGMA"):
        assert getattr(TSIDD, name) == getattr(jsidd, name), name


# --- the scripts ------------------------------------------------------------------

@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """The convergence scripts at 32², a few images, one or two epochs, the
    results under ``tmp_path``."""
    path = tmp_path / "CONVERGENCE_torch.json"
    path.write_text(json.dumps({"other": 1}))
    monkeypatch.setattr(_convergence, "CONVERGENCE_PATH", str(path))
    for mod in (TSEG, TSIDD):
        monkeypatch.setattr(mod, "IM", 32)
        monkeypatch.setattr(mod, "N_TRAIN", 4)
        monkeypatch.setattr(mod, "N_VAL", 2)
        monkeypatch.setattr(mod, "BATCH", 2)
        monkeypatch.setattr(mod, "WARMUP_STEPS", 1)
    monkeypatch.setattr(TSEG, "EPOCHS", 1)
    monkeypatch.setattr(TSEG, "WARMUP_EPOCHS", 2)
    monkeypatch.setattr(TSEG, "FREEZE_EPOCHS", 1)
    monkeypatch.setattr(TSIDD, "EPOCHS", {"matched": 1, "ours": 1, "denoise": 2})
    monkeypatch.setattr(TSIDD, "TF_CONFIG", dict(
        patch_size=(4, 8), transformer_layers=(1,), size_bottleneck=1, num_heads=2))
    return path


def test_convergence_scripts_write_their_sections(tiny):
    seg = TSEG.main(["--device", "cpu"])
    assert set(seg) == set(TSEG.RUNS.values()) | {"threshold_floor"}
    sidd = TSIDD.main(["--device", "cpu"])
    assert set(sidd) == {"matched-recipe", "ours", "denoise-head3", "gain_db_over_noisy"}
    results = json.loads(tiny.read_text())
    assert results["other"] == 1
    demo = results["segmentation_demo"]
    assert [r["tag"] for r in demo["runs"]] == list(TSEG.RUNS.values())
    refold = next(r for r in demo["runs"] if r["tag"] == "bn-refold")
    assert [h["phase"] for h in refold["history"]] == ["refold", "exact"]
    assert demo["device"] == {"name": "cpu"}
    assert [r["tag"] for r in results["runs"]] == ["matched-recipe", "ours"]
    assert len(results["denoise_beyond_identity"]["history"]) == 2
    for r in [*demo["runs"], *results["runs"], results["denoise_beyond_identity"]]:
        assert all(np.isfinite(h["train_loss"]) for h in r["history"]), r["tag"]
    with pytest.raises(SystemExit):
        TSEG.main(["--device", "cpu", "nonsense"])


def _pairs(root, n=6, size=(32, 32)):
    rng = np.random.default_rng(0)
    for d in ("clean", "noisy"):
        os.makedirs(os.path.join(root, d))
    for i in range(n):
        img = rng.integers(0, 256, (*size, 3)).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "clean", f"{i:02d}.png"), img)
        noisy = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "noisy", f"{i:02d}.png"), noisy)


def test_convert_then_train_denoising(tmp_path, monkeypatch):
    """convert_tfrecords writes the pairs fold-sharded with their count in
    the names (count_data_items reads it back, and each record is the
    images as cv2 reads them); train_denoising trains lite on them for an
    epoch and probes PSNR."""
    src, out = str(tmp_path / "pairs"), str(tmp_path / "tfrec")
    _pairs(src)
    assert convert_tfrecords.main(["--input_folder", src, "--output_folder", out]) == 6
    paths = sorted(os.listdir(out))
    assert len(paths) == 5 and all(p.startswith("ssid_fold_") for p in paths)
    assert tfrecord.count_data_items([os.path.join(out, p) for p in paths]) == 6
    noisy = {cv2.cvtColor(cv2.imread(os.path.join(src, "noisy", f)), cv2.COLOR_BGR2RGB)
             .tobytes() for f in os.listdir(os.path.join(src, "noisy"))}
    records = [ex for p in paths for ex in tfrecord.read_examples(os.path.join(out, p))]
    assert {ex["x"][0] for ex in records} == noisy
    monkeypatch.chdir(tmp_path)            # the Fitter's checkpoints
    probes = train_denoising.main(
        ["--tfrec", os.path.join(out, "*.tfrec"), "--shape", "32", "32", "3",
         "--epochs", "1", "--per_replica_batch", "2", "--model", "lite",
         "--dtype", "float32", "--device", "cpu"])
    assert set(probes) == {"noisy_vs_clean", "pred_vs_clean", "pred_vs_noisy"}
    assert all(np.isfinite(v) for v in probes.values())
    assert os.path.isfile(tmp_path / "models" / "best-checkpoint.pt")


def test_serve_model_from_a_fitter_checkpoint(tmp_path, monkeypatch):
    """serve_model exports lite (its preset cut to 32², one level) from a
    Fitter checkpoint, loads the artifact and serves a batch: the
    checkpoint's model's output."""
    from vit_unet_tpu_torch.models import vit_unet
    from vit_unet_tpu_torch.train.fitter import Fitter
    monkeypatch.setitem(vit_unet.PRESETS, "lite", dict(
        vit_unet.PRESETS["lite"], im_size=32, depth=1, size_bottleneck=1))
    fitter = Fitter(vit_unet.get_vit_unet("lite", device="cpu", seed=3), device="cpu",
                    checkpoint_dir=str(tmp_path / "models"))
    fitter.init_state()
    ck = fitter.save()
    served = serve_model.main(["--checkpoint", ck, "--out", str(tmp_path / "exported"),
                               "--batch_size", "2", "--device", "cpu"])
    x = np.random.default_rng(0).normal(size=(2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = fitter.predict(x).numpy()
    assert served.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(served, want, rtol=1e-5, atol=1e-5)
