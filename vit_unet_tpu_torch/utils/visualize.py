"""Visualization utilities, the notebooks' inspection cells as functions:
the counterpart of ``vit_unet_tpu/utils/visualize.py``.

The reference inspects results with ad-hoc matplotlib cells: the
noisy/predicted/clean image grid (``ViT_UNet_TF_TPU.ipynb`` cell 24), loss
curves from the keras History (cell 23), and the EDA pair viewers
(``EDA ssid.ipynb``, ``EDA prostate.ipynb``).  Matplotlib is imported
lazily so headless training never pays for it.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np


def _to_hwc(img: np.ndarray) -> np.ndarray:
    """Accept (C, H, W) or (H, W, C) or (H, W), numpy or a tensor on any
    device; return displayable HWC."""
    if hasattr(img, "detach"):
        img = img.detach().float().cpu().numpy()
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[0] < img.shape[-1]:
        img = img.transpose(1, 2, 0)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    return np.clip(img, 0.0, 1.0)


def prediction_grid(noisy, pred, clean, n: int = 4, path: Optional[str] = None,
                    titles: Sequence[str] = ("input", "predicted", "target")):
    """The notebook's 3-row inspection grid (nb TF_TPU cell 24): input /
    prediction / target for the first ``n`` samples.  Returns the figure;
    saves to ``path`` if given."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(n, len(noisy))
    fig, axes = plt.subplots(3, n, figsize=(3 * n, 9))
    axes = np.atleast_2d(axes)
    for col in range(n):
        for row, batch in enumerate((noisy, pred, clean)):
            ax = axes[row, col]
            ax.imshow(_to_hwc(batch[col]),
                      cmap="gray" if _to_hwc(batch[col]).ndim == 2 else None)
            ax.set_axis_off()
            if col == 0:
                ax.set_title(titles[row], loc="left")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100, bbox_inches="tight")
    return fig


def plot_history(history: Mapping[str, Sequence[float]],
                 keys: Optional[Sequence[str]] = None,
                 path: Optional[str] = None):
    """Loss/metric curves from a ``Fitter`` history dict (the keras History
    plot of nb TF_TPU cell 23).  Pairs ``k``/``val_k`` on the same axes."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if keys is None:
        keys = [k for k in history
                if not k.startswith("val_")
                and k not in ("epoch_time_s", "lr", "checkpoint_saved",
                              "early_stopped", "lr_reduced_to")]
    fig, axes = plt.subplots(1, max(len(keys), 1),
                             figsize=(5 * max(len(keys), 1), 4))
    axes = np.atleast_1d(axes)
    for ax, k in zip(axes, keys):
        ax.plot(history[k], label=k)
        if f"val_{k}" in history:
            ax.plot(history[f"val_{k}"], label=f"val_{k}")
        ax.set_xlabel("epoch")
        ax.set_title(k)
        ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100, bbox_inches="tight")
    return fig


def pair_grid(xs, ys, n: int = 4, path: Optional[str] = None,
              titles: Sequence[str] = ("x", "y")):
    """EDA pair viewer (EDA ssid.ipynb): two rows of paired images."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(n, len(xs))
    fig, axes = plt.subplots(2, n, figsize=(3 * n, 6))
    axes = np.atleast_2d(axes)
    for col in range(n):
        for row, batch in enumerate((xs, ys)):
            img = _to_hwc(batch[col])
            ax = axes[row, col]
            ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
            ax.set_axis_off()
            if col == 0:
                ax.set_title(titles[row], loc="left")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100, bbox_inches="tight")
    return fig
