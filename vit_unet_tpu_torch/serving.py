"""Serving: an eval-mode Predictor on one fixed batch shape.

Counterpart of ``vit_unet_tpu/serving.py::Predictor``: numpy in, numpy out;
every request is cut into chunks of ``batch_size`` and the last chunk is
padded, so the model always sees one batch shape.  Outputs come back as
float32.  Model export (``torch.export``) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vit_unet_tpu_torch.utils.device import resolve_device


def _eval_fn(model: torch.nn.Module, device: torch.device) -> Callable:
    """The one eval-mode forward: numpy batch -> numpy float32 batch."""
    def fwd(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            y = model(torch.from_numpy(x).to(device),
                      deterministic=True, use_running_average=True)
            return y.float().cpu().numpy()
    return fwd


def _infer_input_shape(model) -> tuple:
    """Per-sample (C, H, W) input shape from the model's config."""
    cfg = getattr(model, "config", None)
    if not hasattr(cfg, "im_size"):
        raise ValueError("input_shape required: the model has no config "
                         "with im_size")
    return (cfg.num_channels, cfg.im_size, cfg.im_size)


def _micro_batched(fn: Callable[[np.ndarray], np.ndarray], batch_size: int,
                   sample_ndim: int) -> Callable[[np.ndarray], np.ndarray]:
    """Wrap a fixed-batch fn into one taking any leading batch (padding the
    last chunk) or a single unbatched sample."""
    def call(x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        squeeze = x.ndim == sample_ndim
        if squeeze:
            x = x[None]
        n = x.shape[0]
        if n == 0:
            probe = np.zeros((batch_size, *x.shape[1:]), x.dtype)
            return fn(probe)[:0]
        outs = []
        for i in range(0, n, batch_size):
            chunk = x[i:i + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            out = fn(np.ascontiguousarray(chunk))
            outs.append(out[:batch_size - pad] if pad else out)
        result = np.concatenate(outs, axis=0)
        return result[0] if squeeze else result
    return call


class Predictor:
    """Eval-mode inference on a fixed batch shape, on ``device`` (default:
    the card; the model is moved there).

    >>> p = Predictor(model, batch_size=8)
    >>> y = p(x)          # any leading batch; padded/micro-batched inside
    """

    def __init__(self, model: torch.nn.Module, batch_size: int = 8,
                 input_shape: Optional[tuple] = None, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.input_shape = tuple(input_shape if input_shape is not None
                                 else _infer_input_shape(model))
        self._call = _micro_batched(_eval_fn(self.model, self.device),
                                    batch_size,
                                    sample_ndim=len(self.input_shape))

    def __call__(self, x) -> np.ndarray:
        return self._call(x)
