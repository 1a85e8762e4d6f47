"""The port's image datasets, augmentations, folds and ``tfdata_pipeline``
against the JAX package's (which read with ``cv2`` and ``tf.data``), per
sample, for the same seeds."""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_unet_tpu.data import augment as JA
from vit_unet_tpu.data import datasets as JD
from vit_unet_tpu.data import loader as JL
from vit_unet_tpu_torch.data import augment as TA
from vit_unet_tpu_torch.data import datasets as TD
from vit_unet_tpu_torch.data import loader as TL
from vit_unet_tpu_torch.data import tfrecord as tfr
from tests.test_torch_model import one_torch_thread  # noqa: F401

#: share of mask pixels allowed to differ from JAX after the warp and the
#: 0.5 threshold: cv2's float warp rounds in another order (about 1e-5,
#: tests/test_torch_image_io.py), which can flip a pixel whose interpolated
#: value lies at 0.5 (measured 0 over the cases below)
MASK_SHARE = 1e-3

LAYOUTS = {
    "DenoisingDataset": ("clean", "noisy"),
    "DeblurringDataset": ("sharp", "blur"),
    "DerainingDataset": ("norain", "rain"),
    "SegmentationFolderDataset": ("images", "masks"),
}


def _write_folder(root, cls_name, n=6, seed=0):
    """n pairs of PNGs of mixed sizes and colour types in the layout of
    ``cls_name``; masks are 0/255 gray."""
    rng = np.random.default_rng(seed)
    first, second = LAYOUTS[cls_name]
    for d in (first, second):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        h, w = (48, 56) if i % 2 else (70, 64)
        img = (np.cumsum(rng.integers(0, 9, (h, w, 3)), axis=1) % 256).astype(np.uint8)
        cv2.imwrite(os.path.join(root, first, f"{i:03d}.png"), img)
        if cls_name == "SegmentationFolderDataset":
            yy, xx = np.mgrid[:h, :w]
            mask = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 3) ** 2) * 255
            other = mask.astype(np.uint8)
        else:
            other = np.clip(img + rng.normal(0, 25, img.shape), 0, 255).astype(np.uint8)
            if i % 3 == 0:
                other = cv2.cvtColor(other, cv2.COLOR_BGR2GRAY)
        cv2.imwrite(os.path.join(root, second, f"{i:03d}.png"), other)


@pytest.mark.parametrize("cls_name", sorted(LAYOUTS))
@pytest.mark.parametrize("train", [True, False])
def test_dataset_matches_jax_per_sample(tmp_path, cls_name, train):
    _write_folder(str(tmp_path), cls_name, seed=len(cls_name))
    im = 32
    jt = JA.train_transforms(im) if train else JA.eval_transforms(im)
    tt = TA.train_transforms(im) if train else TA.eval_transforms(im)
    jds = getattr(JD, cls_name).from_folder(str(tmp_path), im_size=im,
                                            transforms=jt, seed=5,
                                            indices=[0, 2, 3, 5, 1, 4])
    tds = getattr(TD, cls_name).from_folder(str(tmp_path), im_size=im,
                                            transforms=tt, seed=5,
                                            indices=[0, 2, 3, 5, 1, 4])
    assert len(jds) == len(tds) == 6
    for _ in range(2):           # two passes: the random streams move on
        for i in range(len(tds)):
            want, got = jds[i], tds[i]
            assert got["x"].dtype == got["y"].dtype == np.float32
            assert got["x"].shape == want["x"].shape
            assert got["y"].shape == want["y"].shape
            np.testing.assert_array_equal(got["x"], want["x"])
            if cls_name == "SegmentationFolderDataset":
                assert set(np.unique(got["y"])) <= {0.0, 1.0}
                assert np.mean(got["y"] != want["y"]) <= MASK_SHARE
            else:
                np.testing.assert_array_equal(got["y"], want["y"])


def test_dataset_without_transforms_and_channels_last(tmp_path):
    _write_folder(str(tmp_path), "DenoisingDataset", n=3)
    j = JD.DenoisingDataset.from_folder(str(tmp_path), im_size=40,
                                        channels_first=False)
    t = TD.DenoisingDataset.from_folder(str(tmp_path), im_size=40,
                                        channels_first=False)
    for i in range(3):
        np.testing.assert_array_equal(t[i]["x"], j[i]["x"])
        np.testing.assert_array_equal(t[i]["y"], j[i]["y"])
        assert t[i]["x"].shape == (40, 40, 3)


def test_unpaired_folder_raises(tmp_path):
    _write_folder(str(tmp_path), "DenoisingDataset", n=3)
    os.remove(os.path.join(str(tmp_path), "noisy", "001.png"))
    with pytest.raises(ValueError, match="unpaired dataset: 3 clean vs 2 noisy"):
        TD.DenoisingDataset.from_folder(str(tmp_path))
    with pytest.raises(ValueError, match="unpaired"):
        JD.DenoisingDataset.from_folder(str(tmp_path))
    with pytest.raises(ValueError, match="path counts differ"):
        TD.PairedImageDataset(["a"], [], im_size=8)


def test_segmentation_dataset_gate():
    with pytest.raises(ImportError, match="pydicom and nibabel"):
        TD.SegmentationDataset(["a.dcm"], ["a.nii"], [0])
    with pytest.raises(ImportError, match="pydicom and nibabel"):
        JD.SegmentationDataset(["a.dcm"], ["a.nii"], [0])


@pytest.mark.parametrize("n,folds,seed", [(96, 5, 42), (8, 5, 42), (23, 4, 7)])
def test_kfold_split_identical(n, folds, seed):
    for (jt, jv), (tt, tv) in zip(JD.kfold_split(n, folds, seed),
                                  TD.kfold_split(n, folds, seed), strict=True):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tv, jv)
    with pytest.raises(ValueError):
        next(TD.kfold_split(3, 5))
    with pytest.raises(ValueError):
        next(TD.kfold_split(10, 1))


def test_flip_and_resize_transforms_match_jax():
    rng_img = np.random.default_rng(3)
    img = rng_img.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    tgt = rng_img.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    pipe = lambda m: m.Compose([m.HorizontalFlip(p=0.5), m.Resize(24, 20),
                                m.ShiftScaleRotate(p=0.9)])
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(8):
        jx, jy = pipe(JA)(jr, img, tgt)
        tx, ty = pipe(TA)(tr, img, tgt)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    # one stream: both packages consumed the same number of draws
    assert jr.random() == tr.random()


# --------------------------------------------------------------------------
# batch transforms: the port's apply fed JAX's draws
# --------------------------------------------------------------------------

def _batch(seed=0, b=6, c=3, h=16, w=12):
    rng = np.random.default_rng(seed)
    x = rng.random((b, c, h, w)).astype(np.float32)
    y = rng.random((b, c, h, w)).astype(np.float32)
    return x, y


def _mixup_draws(key, b, alpha, prob):
    _, lk, pk = jax.random.split(key, 3)
    lam = jax.random.beta(lk, alpha, alpha, (b,))
    return np.asarray(jnp.where(jax.random.uniform(pk, (b,)) < prob, lam, 1.0))


def _cutmix_draws(key, b, h, w, alpha, prob):
    bk, xk, yk, pk = jax.random.split(key, 4)
    lam = jax.random.beta(bk, alpha, alpha, (b,))
    lam = jnp.where(jax.random.uniform(pk, (b,)) < prob, lam, 1.0)
    cx = jax.random.randint(xk, (b,), 0, w)
    cy = jax.random.randint(yk, (b,), 0, h)
    return [np.asarray(a) for a in (lam, cx, cy)]


T = lambda a: torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_apply_matches_jax(seed):
    x, y = _batch(seed)
    key = jax.random.key(seed)
    want = JA.mixup(key, jnp.asarray(x), jnp.asarray(y), alpha=0.2, prob=0.5)
    lam = _mixup_draws(key, x.shape[0], 0.2, 0.5)
    got = TA._mixup_apply(T(x), T(y), T(lam))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cutmix_apply_matches_jax(seed):
    x, y = _batch(seed)
    key = jax.random.key(seed)
    want = JA.cutmix(key, jnp.asarray(x), jnp.asarray(y), prob=0.9)
    lam, cx, cy = _cutmix_draws(key, x.shape[0], 16, 12, 1.0, 0.9)
    got = TA._cutmix_apply(T(x), T(y), T(lam), T(cx), T(cy))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_batch_transforms_apply_matches_jax(seed):
    x, y = _batch(seed)
    b = x.shape[0]
    key = jax.random.key(seed)
    want = JA.batch_transforms(key, jnp.asarray(x), jnp.asarray(y), prob=0.66)
    ck, mk, pk = jax.random.split(key, 3)
    lam_c, cx, cy = _cutmix_draws(ck, b, 16, 12, 1.0, 0.66)
    lam_m = _mixup_draws(mk, b, 0.2, 0.66)
    pick = np.asarray(jax.random.uniform(pk, (b,)) <= 0.5)
    cut = TA._cutmix_apply(T(x), T(y), T(lam_c), T(cx), T(cy))
    mix = TA._mixup_apply(T(x), T(y), T(lam_m))
    got = TA._pick_apply(T(pick), cut, mix)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6, atol=1e-6)


def test_batch_transforms_draws():
    """The port's own draws: reproducible from the generator, Beta draws in
    [0, 1] with the right mean and variance, shapes and dtypes kept."""
    x, y = _batch(0, b=64)
    tx, ty = T(x), T(y)
    a = TA.batch_transforms(torch.Generator().manual_seed(4), tx, ty)
    b = TA.batch_transforms(torch.Generator().manual_seed(4), tx, ty)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
        assert u.shape == tx.shape and u.dtype == tx.dtype
    for alpha in (0.2, 1.0, 2.5):
        lam = TA._beta(alpha, 20000, torch.Generator().manual_seed(1), "cpu")
        assert lam.min() >= 0 and lam.max() <= 1
        assert abs(lam.mean().item() - 0.5) < 0.01
        var = 1.0 / (4 * (2 * alpha + 1))
        assert abs(lam.var().item() - var) < 0.1 * var
    mx, my = TA.mixup(torch.Generator().manual_seed(2), tx, ty, prob=0.0)
    torch.testing.assert_close(mx, tx, rtol=0, atol=0)
    cx_, cy_ = TA.cutmix(torch.Generator().manual_seed(2), tx, ty, prob=0.0)
    torch.testing.assert_close(cx_, tx, rtol=0, atol=0)


# --------------------------------------------------------------------------
# tfdata_pipeline
# --------------------------------------------------------------------------

def _shards(tmp_path, n, shape, n_shards):
    rng = np.random.default_rng(9)
    paths = []
    for s in range(n_shards):
        path = str(tmp_path / f"shard{s}.tfrec")
        with tfr.TFRecordWriter(path) as w:
            for _ in range(n):
                x = rng.integers(0, 256, shape, dtype=np.uint8)
                w.write_example({"x": x.tobytes(), "y": (255 - x).tobytes()})
        paths.append(path)
    return paths


@pytest.mark.parametrize("n_shards,drop,channels_first", [
    (1, True, True), (3, False, True), (3, True, False)])
def test_tfdata_pipeline_matches_jax(tmp_path, n_shards, drop, channels_first):
    shape = (6, 5, 3)
    paths = _shards(tmp_path, 7 - n_shards, shape, n_shards)
    kw = dict(batch_size=4, drop_remainder=drop, channels_first=channels_first)
    want = list(JL.tfdata_pipeline(paths, shape, **kw))
    got = list(TL.tfdata_pipeline(paths, shape, **kw))
    assert len(got) == len(want) > 0
    for g, w_ in zip(got, want):
        assert set(g) == set(w_) == {"x", "y"}
        for k in g:
            assert g[k].dtype == w_[k].dtype
            np.testing.assert_array_equal(g[k], w_[k])


def test_tfdata_pipeline_repeat_shuffle_and_remote(tmp_path):
    shape = (2, 2, 1)
    paths = _shards(tmp_path, 5, shape, 2)
    once = np.concatenate([b["x"] for b in TL.tfdata_pipeline(
        paths, shape, batch_size=3, drop_remainder=False, normalize=False)])
    assert once.shape == (10, 1, 2, 2)
    stream = TL.tfdata_pipeline(paths, shape, batch_size=3, repeat=True,
                                normalize=False)
    thrice = np.concatenate([next(stream)["x"] for _ in range(10)])
    np.testing.assert_array_equal(thrice, np.concatenate([once] * 3))
    shuffled = np.concatenate([b["x"] for b in TL.tfdata_pipeline(
        paths, shape, batch_size=3, drop_remainder=False, normalize=False,
        shuffle=True)])
    key = lambda a: sorted(map(bytes, a.reshape(len(a), -1)))
    assert key(shuffled) == key(once)
    with pytest.raises(ValueError, match="local files only"):
        next(TL.tfdata_pipeline(["gs://bucket/a.tfrec"], shape))
