"""The port's classification path against the JAX package's, float32 on the
CPU: ``ViTClassifier`` (eval logits and train-mode gradients, with JAX
variables carried across by ``load_flax_variables``), its config,
``ClassificationDataset`` on a PNG / BMP / JPEG tree, and the CLI
(``python -m vit_unet_tpu_torch.cli.run_classification``): its flags and
a tiny run on ``--device cpu``.  The JAX model runs its plain path
(``use_flash=False``); the port its kernel branch, which takes the
kernels' plain versions on CPU tensors."""
import dataclasses
import json
import math
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_unet_tpu.cli import run_classification as JCLI
from vit_unet_tpu.data import augment as JA
from vit_unet_tpu.data import datasets as JD
from vit_unet_tpu.models import vit_classifier as JVC
from vit_unet_tpu.train.losses import categorical_crossentropy as j_ce
from vit_unet_tpu_torch.cli import run_classification as TCLI
from vit_unet_tpu_torch.data import augment as TA
from vit_unet_tpu_torch.data import datasets as TD
from vit_unet_tpu_torch.data import loader as TL
from vit_unet_tpu_torch.models import vit_classifier as TVC
from vit_unet_tpu_torch.train.losses import categorical_crossentropy as t_ce
from vit_unet_tpu_torch.utils.jax_import import flax_to_state_dict, load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_tf_model import init

TOL = 1e-4
# 32² images, patch 8, two levels of one block at 16 heads: head dims 12
# (16 tokens of 192) and 3 (64 tokens of 48); a (8, 3) head
SMALL = dict(depth=2, depth_te=1, linear_list=(8, 3), num_patches=16,
             patch_size=8, hidden_dim=16, num_heads=16)
NO_DROP = dict(attn_drop=0.0, proj_drop=0.0, linear_drop=0.0)
SMOOTHING = 0.05


def _models(seed=0, **fields):
    cfg = {**SMALL, **NO_DROP, **fields}
    jmod = JVC.ViTClassifier(JVC.ViTClassifierConfig(**cfg))
    x = np.random.default_rng(seed).standard_normal((4, 3, 32, 32)).astype(np.float32)
    v = init(jmod, x, seed=seed)
    tmod = load_flax_variables(TVC.get_vit_classifier(device="cpu", **cfg), v)
    return jmod, v, tmod, x


def test_config_matches_jax_but_the_kernel_defaults():
    port = {f.name: f.default for f in dataclasses.fields(TVC.ViTClassifierConfig)}
    jax_ = {f.name: f.default for f in dataclasses.fields(JVC.ViTClassifierConfig)}
    assert (port.pop("use_flash"), port.pop("flash_train")) == (True, True)
    jax_.pop("use_flash"), jax_.pop("flash_train")
    assert port == jax_
    for bad in (dict(depth=5), dict(num_patches=15), dict(linear_list=())):
        with pytest.raises(ValueError):
            TVC.ViTClassifierConfig(**bad)
    cfg = TVC.ViTClassifierConfig(num_patches=196)
    assert (cfg.im_size, cfg.projection_dim, cfg.num_classes) == (224, 768, 4)


def test_cli_default_model_has_the_jax_parameter_count():
    """The CLI's default classifier (224², patch 16, 196 patches, 16
    heads, head (64, 4)): 5,975,984 parameters, as the JAX model's
    ``eval_shape`` counts them."""
    model = TVC.get_vit_classifier(device="meta", num_patches=196)
    assert sum(p.numel() for p in model.parameters()) == 5_975_984
    heads = {(m.num_heads, m.dim // m.num_heads) for m in model.modules()
             if type(m).__name__ == "ReAttention"}
    assert heads == {(16, 48), (16, 12)}


@pytest.mark.parametrize("im", [32, 48])
def test_eval_logits_match_jax(im):
    """Eval logits (running statistics randomised), at the model's size
    and through the antialiased resize from 48²."""
    jmod, v, tmod, _ = _models()
    x = np.random.default_rng(1).standard_normal((3, 3, im, im)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v_, x_: jmod.apply(v_, x_))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("frozen", [False, True])
def test_train_gradients_match_jax(frozen):
    """One dropout-free label-smoothed CE loss in train mode, with exact
    (batch-statistics) BN in the head mix or frozen BN: the loss, the
    updated running statistics and every gradient at 1e-4 of the largest
    gradient.  Under exact BN the head-mix conv bias has an exactly zero
    gradient (BatchNorm removes a uniform shift): the port's is held below
    1e-4 of the largest, JAX's rounding noise of a true zero is not
    compared."""
    jmod, v, tmod, x = _models(seed=2, flash_frozen_bn=frozen)
    y = np.eye(3, dtype=np.float32)[[0, 2, 1, 2]]

    def jloss(params):
        logits, upd = jmod.apply({"params": params, "batch_stats": v["batch_stats"]},
                                 jnp.asarray(x), deterministic=True,
                                 use_running_average=frozen, mutable=["batch_stats"])
        return j_ce(logits, jnp.asarray(y), label_smoothing=SMOOTHING), upd
    (jl, jupd), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])

    tmod.train()
    logits = tmod(torch.from_numpy(x), deterministic=True,
                  use_running_average=frozen)
    loss = t_ce(logits, torch.from_numpy(y), label_smoothing=SMOOTHING)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= TOL * abs(float(jl))
    stats = flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, jupd["batch_stats"])})
    for name, want in stats.items():
        np.testing.assert_allclose(tmod.state_dict()[name].numpy(), want.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, jg)}, tmod)
    got = {n: p.grad for n, p in tmod.named_parameters()}
    assert set(got) == set(want)
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        if name.endswith("reatten_matrix.bias") and not frozen:
            assert float(got[name].abs().max()) <= TOL * gmax, name
            continue
        np.testing.assert_allclose(got[name].numpy() / gmax, w.numpy() / gmax,
                                   rtol=0, atol=TOL, err_msg=name)


def test_head_dropout_draws_from_the_generator():
    """linear_drop sits between the head's Dense layers only: a train
    forward with only it on is reproducible from the generator's seed and
    differs from the eval forward."""
    _, _, tmod, x = _models(linear_drop=0.5)
    xt = torch.from_numpy(x)
    run = lambda seed: tmod(xt, deterministic=False, use_running_average=True,
                            generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a, b, c = run(3), run(3), run(4)
        evaluated = tmod(xt)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, evaluated)
    with pytest.raises(ValueError, match="generator"):
        tmod(xt, deterministic=False)


def test_factory_is_reproducible_and_casts_parameters():
    a = TVC.get_vit_classifier(device="cpu", seed=5, **SMALL)
    b = TVC.get_vit_classifier(TVC.ViTClassifierConfig(**SMALL), device="cpu", seed=5)
    c = TVC.get_vit_classifier(device="cpu", seed=6, **SMALL)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    bf = TVC.get_vit_classifier(device="cpu", dtype="bfloat16",
                                param_dtype="bfloat16", **SMALL)
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}
    assert not bf.training
    with torch.no_grad():
        out = bf(torch.zeros(2, 3, 32, 32))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3)


# --- the dataset and the CLI ----------------------------------------------------

def _class_tree(root, per_class=4, classes=("cat", "dog", "eel")):
    """Class folders of mixed sizes and formats: PNG, 24-bit BMP, baseline
    and progressive JPEG, and a file the readers skip."""
    rng = np.random.default_rng(0)
    for ci, name in enumerate(classes):
        os.makedirs(os.path.join(root, name))
        for i in range(per_class):
            h, w = (40, 52) if i % 2 else (36, 30)
            img = (np.cumsum(rng.integers(0, 9, (h, w, 3)), axis=1) * (ci + 1) % 256
                   ).astype(np.uint8)
            ext = ("png", "BMP", "jpg", "jpeg")[i % 4]
            params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1] if ext == "jpeg" else []
            assert cv2.imwrite(os.path.join(root, name, f"{i:02d}.{ext}"), img, params)
        with open(os.path.join(root, name, "notes.txt"), "w") as f:
            f.write("not an image")


@pytest.mark.parametrize("train", [False, True])
def test_classification_dataset_matches_jax(tmp_path, train):
    root = str(tmp_path / "tree")
    _class_tree(root)
    idx = [7, 0, 5, 11, 2]
    size = 24
    j = JD.ClassificationDataset.from_folder(
        root, im_size=size, indices=idx,
        transforms=(JA.train_transforms if train else JA.eval_transforms)(size))
    t = TD.ClassificationDataset.from_folder(
        root, im_size=size, indices=idx,
        transforms=(TA.train_transforms if train else TA.eval_transforms)(size))
    assert (t.paths, t.labels, t.class_names, t.num_classes) == \
        (j.paths, j.labels, j.class_names, j.num_classes)
    for i in range(len(t)):
        got, want = t[i], j[i]
        assert got["x"].shape == (3, size, size) and got["x"].dtype == np.float32
        np.testing.assert_array_equal(got["y"], want["y"])
        # uint8 warps agree within one level (tests/test_torch_image_io.py)
        np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1.0 / 255 + 1e-7)
        if not train:
            np.testing.assert_array_equal(got["x"], want["x"])


def test_restoration_datasets_read_bmp_and_jpeg(tmp_path):
    root = str(tmp_path / "pairs")
    for d in ("clean", "noisy"):
        os.makedirs(os.path.join(root, d))
    rng = np.random.default_rng(1)
    for i, ext in enumerate(("bmp", "jpg")):
        img = rng.integers(0, 256, (20, 24, 3)).astype(np.uint8)
        for d in ("clean", "noisy"):
            cv2.imwrite(os.path.join(root, d, f"{i}.{ext}"), img)
    t = TD.DenoisingDataset.from_folder(root, im_size=16)
    j = JD.DenoisingDataset.from_folder(root, im_size=16)
    for i in range(2):
        np.testing.assert_array_equal(t[i]["x"], j[i]["x"])


def _actions(parser):
    return {a.dest: (a.default, a.type, a.choices, a.nargs, a.const,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax_but_device():
    port, jax_ = _actions(TCLI.build_parser()), _actions(JCLI.build_parser())
    assert port.pop("device")[0] == "cuda"
    assert port == jax_


def test_main_trains_on_cpu(tmp_path, monkeypatch):
    """Two epochs of a 16-head model at 32² on a 3-class tree: the JAX
    CLI's split (default_rng(42), n_val = max(1, int(n * 0.2))), the
    learning-rate schedule, the best checkpoint reloaded and evaluated."""
    root = str(tmp_path / "tree")
    _class_tree(root)
    seen = []

    class Recording(TL.DataLoader):
        def __init__(self, dataset, *a, **kw):
            seen.append(list(dataset.paths))
            super().__init__(dataset, *a, **kw)

    monkeypatch.setattr(TL, "DataLoader", Recording)
    ck, log = str(tmp_path / "models"), str(tmp_path / "log.jsonl")
    result = TCLI.main(["--input_folder", root, "--n_epochs", "2", "--im_size", "32",
                        "--patch_size", "8", "--depth_te", "1", "--hidden_dim", "16",
                        "--head_width", "8", "--batch_size", "3", "--num_workers", "0",
                        "--device", "cpu", "--flash", "--rampup_epochs", "1",
                        "--checkpoint_dir", ck, "--log_jsonl", log])
    assert set(result) == {"val_loss", "val_accuracy", "val_f1"}
    assert all(math.isfinite(float(v)) for v in result.values())
    assert os.path.isfile(os.path.join(ck, "best-checkpoint.pt"))
    with open(log) as f:
        lines = [json.loads(line) for line in f]
    assert [line["epoch"] for line in lines] == [0, 1]
    assert [line["lr"] for line in lines] == pytest.approx([1e-5, 5e-5])
    probe = JD.ClassificationDataset.from_folder(root)
    order = np.random.default_rng(42).permutation(len(probe))
    n_val = max(1, int(len(probe) * 0.2))
    assert seen == [[probe.paths[i] for i in order[n_val:]],
                    [probe.paths[i] for i in order[:n_val]]]


def test_data_parallel_raises_before_training(tmp_path, monkeypatch):
    """--data_parallel starts the process group first: a world of two
    without a rank is an error before any data is read."""
    monkeypatch.setenv("VIT_UNET_NUM_PROCESSES", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK"):
        TCLI.main(["--input_folder", str(tmp_path), "--data_parallel",
                   "--device", "cpu"])
