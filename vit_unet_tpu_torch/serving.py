"""Serving: an eval-mode Predictor on one fixed batch shape, and model
export.  The counterpart of ``vit_unet_tpu/serving.py``.

* ``Predictor``: numpy in, numpy out; every request is cut into chunks of
  ``batch_size`` and the last chunk is padded, so the model always sees one
  batch shape.  Outputs come back as float32.
* ``export_predictor`` / ``load_predictor``: the eval forward at one fixed
  batch as a ``torch.export`` program saved with its weights
  (``{path}/program.pt2``), in place of the JAX package's StableHLO and
  orbax parameters; the loaded program pads and micro-batches as
  ``Predictor`` does.  The program records kernel 1 as the operator
  ``vit_unet_tpu_torch::flash_reattention``, so loading it registers that
  operator by importing the port's kernels module: unlike the JAX
  artifact, it needs the package (not the model code) where it runs.
"""
from __future__ import annotations

import os
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
    """Per-sample input shape from the model's config: channels-first
    (C, H, W) for ViTUNet (``im_size``), channels-last (H, W, C) for the
    TF-flavour family (``img_size``)."""
    cfg = getattr(model, "config", None)
    if hasattr(cfg, "im_size"):
        return (cfg.num_channels, cfg.im_size, cfg.im_size)
    if hasattr(cfg, "img_size"):
        return (cfg.img_size, cfg.img_size, cfg.num_channels)
    raise ValueError("input_shape required: the model has no config with "
                     "im_size or img_size")


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


PROGRAM = "program.pt2"


class _EvalForward(torch.nn.Module):
    """The eval-mode forward as a module of one tensor argument, float32
    out: what ``export_predictor`` records."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, deterministic=True,
                          use_running_average=True).float()


def export_predictor(model: torch.nn.Module, path: str, batch_size: int = 8,
                     input_shape: Optional[tuple] = None) -> str:
    """Record the eval forward at batch ``batch_size`` (float32 input of
    per-sample ``input_shape``, by default from the model's config) with
    ``torch.export`` on the device the model lies on, and save it with its
    weights as ``{path}/program.pt2``.  Returns ``path``."""
    if input_shape is None:
        input_shape = _infer_input_shape(model)
    device = next(model.parameters()).device
    example = torch.zeros((batch_size, *input_shape), device=device)
    model.eval()
    with torch.no_grad():
        program = torch.export.export(_EvalForward(model), (example,),
                                      strict=False)
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, PROGRAM))
    return path


def _input_spec(program) -> torch.Tensor:
    """The placeholder tensor (shape, dtype, device) of the program's one
    input."""
    for node in program.graph.nodes:
        if node.op == "placeholder" and node.name in program.graph_signature.user_inputs:
            return node.meta["val"]
    raise ValueError("the exported program has no input")


def _devices_named(program) -> set:
    """Every device the program's tensors and device arguments name."""
    found = {t.device for t in program.state_dict.values()}
    found |= {t.device for t in program.constants.values()
              if isinstance(t, torch.Tensor)}
    for node in program.graph.nodes:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor):
            found.add(val.device)
        dev = node.kwargs.get("device")
        if dev is not None:
            found.add(torch.device(dev))
    return found


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def load_predictor(path: str, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """Load ``export_predictor``'s program onto ``device`` (default: the
    card) and return f(x), numpy in and float32 numpy out, with
    ``Predictor``'s any-batch padding and micro-batching.  A program
    exported on another device is moved (``move_to_device_pass``); if a
    device other than the target remains in it, this raises."""
    from torch.export.passes import move_to_device_pass

    # the program calls the operator this module registers
    import vit_unet_tpu_torch.kernels.flash_reattention  # noqa: F401

    dev = resolve_device(device)
    program = torch.export.load(os.path.join(path, PROGRAM))
    spec = _input_spec(program)
    if not _same_device(spec.device, dev):
        program = move_to_device_pass(program, dev)
        stray = [d for d in _devices_named(program) if not _same_device(d, dev)]
        if stray:
            raise RuntimeError(f"moving the exported program to {dev} left "
                               f"tensors or arguments on {stray}")
    forward = program.module()

    def fwd(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return forward(torch.from_numpy(x).to(dev)).cpu().numpy()

    return _micro_batched(fwd, spec.shape[0], sample_ndim=spec.ndim - 1)
