"""Dataset readers for the README's tasks and for classification: the
counterpart of ``vit_unet_tpu/data/datasets.py``, reading PNG, BMP and JPEG
folders with the port's own decoders and resize (``data/image_io.py``)
instead of ``cv2``.

* ``DenoisingDataset`` (clean/noisy), ``DeblurringDataset`` (sharp/blur),
  ``DerainingDataset`` (norain/rain): paired images matched by sorted
  order, unequal counts raise;
* ``SegmentationFolderDataset``: images/masks folders, binary masks
  that stay binary after the geometric transforms;
* ``SegmentationDataset``: Pancreas-CT DICOM slices and NIfTI masks, gated
  on pydicom and nibabel;
* ``ClassificationDataset``: ``root/<class>/*`` image trees, one-hot
  labels;
* ``kfold_split``: the reference's 5-fold protocol, the same folds as the
  JAX package's for the same seed.

Samples are numpy float32 in [0, 1], (C, H, W) by default.  Transforms draw
from the dataset's ``np.random.Generator``, as the JAX datasets do.
"""
from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np

from vit_unet_tpu_torch.data.image_io import (
    imread_gray, imread_rgb, resize_linear, resize_nearest,
)


class PairedImageDataset:
    """Generic (input, target) image pairs with paired augmentation.

    Returns dict {'x', 'y'}: float32 in [0, 1].  ``channels_first=True``
    yields (C, H, W); False yields (H, W, C).
    """

    def __init__(self, input_paths: Sequence[str], target_paths: Sequence[str],
                 im_size: int = 224, transforms=None, channels_first: bool = True,
                 seed: int = 0):
        if len(input_paths) != len(target_paths):
            raise ValueError("input/target path counts differ "
                             f"({len(input_paths)} vs {len(target_paths)})")
        self.input_paths = list(input_paths)
        self.target_paths = list(target_paths)
        self.im_size = im_size
        self.transforms = transforms
        self.channels_first = channels_first
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.input_paths)

    def __getitem__(self, idx: int) -> dict:
        x = imread_rgb(self.input_paths[idx])
        y = imread_rgb(self.target_paths[idx])
        if self.transforms is not None:
            x, y = self.transforms(self.rng, x, y)
        else:
            x = resize_linear(x, (self.im_size, self.im_size))
            y = resize_linear(y, (self.im_size, self.im_size))
        x = x.astype(np.float32) / 255.0
        y = y.astype(np.float32) / 255.0
        if self.channels_first:
            x = x.transpose(2, 0, 1)
            y = y.transpose(2, 0, 1)
        return {"x": x, "y": y}


def _paired_paths(root: str, first: str, second: str,
                  indices: Optional[Sequence[int]]):
    """The sorted files of ``root/first`` and ``root/second``, paired by
    position and taken at ``indices``."""
    a = sorted(glob.glob(os.path.join(root, first, "*")))
    b = sorted(glob.glob(os.path.join(root, second, "*")))
    if len(a) != len(b):
        raise ValueError(f"unpaired dataset: {len(a)} {first} vs {len(b)} "
                         f"{second}")
    if indices is not None:
        a = [a[i] for i in indices]
        b = [b[i] for i in indices]
    return a, b


class DenoisingDataset(PairedImageDataset):
    """SIDD pairs: x = noisy, y = clean."""

    @classmethod
    def from_folder(cls, root: str, im_size: int = 224, transforms=None,
                    channels_first: bool = True,
                    clean_dir: str = "clean", noisy_dir: str = "noisy",
                    indices: Optional[Sequence[int]] = None, **kw):
        clean, noisy = _paired_paths(root, clean_dir, noisy_dir, indices)
        return cls(noisy, clean, im_size=im_size, transforms=transforms,
                   channels_first=channels_first, **kw)


class DeblurringDataset(DenoisingDataset):
    """GoPro pairs: x = blur, y = sharp."""

    @classmethod
    def from_folder(cls, root: str, **kw):
        kw.setdefault("clean_dir", "sharp")
        kw.setdefault("noisy_dir", "blur")
        return super().from_folder(root, **kw)


class DerainingDataset(DenoisingDataset):
    """Rain100H/L-style pairs: x = rain, y = norain."""

    @classmethod
    def from_folder(cls, root: str, **kw):
        kw.setdefault("clean_dir", "norain")
        kw.setdefault("noisy_dir", "rain")
        return super().from_folder(root, **kw)


class SegmentationDataset:
    """Pancreas-CT: DICOM slice -> image, NIfTI slice -> binary mask.
    Requires pydicom and nibabel, and raises ``ImportError`` without
    them."""

    def __init__(self, dicom_paths: Sequence[str], label_paths: Sequence[str],
                 slices: Sequence[int], im_size: int = 224, transforms=None,
                 channels_first: bool = True, seed: int = 0):
        try:
            import nibabel  # noqa: F401
            import pydicom  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "SegmentationDataset needs pydicom and nibabel "
                "(pip install pydicom nibabel)") from e
        self.dicom_paths = list(dicom_paths)
        self.label_paths = list(label_paths)
        self.slices = list(slices)
        self.im_size = im_size
        self.transforms = transforms
        self.channels_first = channels_first
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dicom_paths)

    def __getitem__(self, idx: int) -> dict:
        import nibabel as nib
        import pydicom

        ds = pydicom.dcmread(self.dicom_paths[idx])
        img = ds.pixel_array.astype(np.float32)
        img = (img - img.min()) / max(img.max() - img.min(), 1e-8)
        nii = nib.load(self.label_paths[idx])
        mask = np.asanyarray(nii.dataobj)[..., self.slices[idx]]
        mask = (np.asarray(mask) > 0).astype(np.float32)
        img = resize_linear(img, (self.im_size, self.im_size))
        mask = resize_nearest(mask, (self.im_size, self.im_size))
        if self.transforms is not None:
            img, mask = self.transforms(self.rng, img, mask)
            mask = (mask > 0.5).astype(np.float32)   # stays binary
        x = np.repeat(img[..., None], 3, axis=-1)     # grayscale -> 3ch
        y = mask[..., None]
        if self.channels_first:
            x = x.transpose(2, 0, 1)
            y = y.transpose(2, 0, 1)
        return {"x": x.astype(np.float32), "y": y.astype(np.float32)}


class SegmentationFolderDataset(PairedImageDataset):
    """Binary segmentation from image folders (``{root}/images/*`` and
    ``{root}/masks/*``, matched by sorted order).  Yields x (3, H, W) in
    [0, 1] and y (1, H, W) binary."""

    @classmethod
    def from_folder(cls, root: str, im_size: int = 224, transforms=None,
                    channels_first: bool = True,
                    image_dir: str = "images", mask_dir: str = "masks",
                    indices: Optional[Sequence[int]] = None, **kw):
        images, masks = _paired_paths(root, image_dir, mask_dir, indices)
        return cls(images, masks, im_size=im_size, transforms=transforms,
                   channels_first=channels_first, **kw)

    def __getitem__(self, idx: int) -> dict:
        x = imread_rgb(self.input_paths[idx])
        mask = imread_gray(self.target_paths[idx])
        x = resize_linear(x, (self.im_size, self.im_size))
        mask = resize_nearest(mask, (self.im_size, self.im_size))
        mask = (mask.astype(np.float32) > 0).astype(np.float32)
        if self.transforms is not None:
            x, mask = self.transforms(self.rng, x, mask)
            mask = (np.asarray(mask) > 0.5).astype(np.float32)   # stays binary
        x = x.astype(np.float32) / 255.0
        y = mask[..., None]
        if self.channels_first:
            x = x.transpose(2, 0, 1)
            y = y.transpose(2, 0, 1)
        return {"x": x, "y": y.astype(np.float32)}


class ClassificationDataset:
    """Image-classification pairs from a class-subdirectory tree
    (``root/<class_name>/*.png|jpg|jpeg|bmp``).  Yields {'x': (C, H, W)
    float32 in [0, 1], 'y': one-hot (num_classes,) float32}: each image
    resized to ``im_size`` (``resize_linear``, as the JAX dataset's
    ``cv2.resize``), then ``transforms(rng, img, None)``."""

    EXTS = (".png", ".jpg", ".jpeg", ".bmp")

    def __init__(self, paths: Sequence[str], labels: Sequence[int],
                 num_classes: int, im_size: int = 224, transforms=None,
                 channels_first: bool = True, seed: int = 0):
        if len(paths) != len(labels):
            raise ValueError("paths/labels length mismatch")
        self.paths = list(paths)
        self.labels = list(labels)
        self.num_classes = num_classes
        self.im_size = im_size
        self.transforms = transforms
        self.channels_first = channels_first
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_folder(cls, root: str, im_size: int = 224, transforms=None,
                    indices: Optional[Sequence[int]] = None, **kw):
        """Classes from the sorted subdirectories of ``root``, files from
        each one's sorted listing, taken where their lower-cased name ends
        in ``EXTS``, then at ``indices``."""
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"no class subdirectories under {root!r}")
        paths, labels = [], []
        for ci, cname in enumerate(classes):
            for p in sorted(glob.glob(os.path.join(root, cname, "*"))):
                if p.lower().endswith(cls.EXTS):
                    paths.append(p)
                    labels.append(ci)
        if indices is not None:
            paths = [paths[i] for i in indices]
            labels = [labels[i] for i in indices]
        ds = cls(paths, labels, num_classes=len(classes), im_size=im_size,
                 transforms=transforms, **kw)
        ds.class_names = classes
        return ds

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        img = resize_linear(imread_rgb(self.paths[idx]),
                            (self.im_size, self.im_size))
        if self.transforms is not None:
            img, _ = self.transforms(self.rng, img, None)
        x = img.astype(np.float32) / 255.0
        if self.channels_first:
            x = x.transpose(2, 0, 1)
        y = np.zeros(self.num_classes, np.float32)
        y[self.labels[idx]] = 1.0
        return {"x": x, "y": y}


def kfold_split(n: int, n_folds: int = 5, seed: int = 42):
    """Yield (train_idx, val_idx) per fold: KFold(5, shuffle, seed 42) as
    the reference's entry point splits, with numpy's generator."""
    if n_folds < 2:
        raise ValueError("kfold_split needs n_folds >= 2 (a single fold has "
                         "no train/val split)")
    if n < n_folds:
        raise ValueError(f"cannot split {n} samples into {n_folds} folds")
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    folds = np.array_split(order, n_folds)
    for k in range(n_folds):
        val = folds[k]
        train = np.concatenate([folds[j] for j in range(n_folds) if j != k])
        yield np.sort(train), np.sort(val)
