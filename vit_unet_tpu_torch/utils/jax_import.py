"""Carry the JAX model's weights into the port.

``load_flax_variables`` takes the flax ``{"params", "batch_stats"}`` tree of
``vit_unet_tpu``'s ViTUNet, HViTUNetTF or ViTClassifier (or one of their
submodules), as nested dicts of numpy arrays, and fills the port's module
of the same structure.  For ViTUNet it is the inverse of
``vit_unet_tpu/utils/torch_import.py``:

* Dense ``kernel`` (in, out)          -> Linear ``weight`` (out, in)
* DenseGeneral ``kernel`` (in, H, D)  -> Linear ``weight`` (H*D, in); the
  one named ``out`` (H, D, out)       -> Linear ``weight`` (out, H*D); its
  ``bias`` (H, D)                     -> ``bias`` (H*D,)
* Conv ``kernel`` (kh, kw, I, O)      -> Conv2d ``weight`` (O, I, kh, kw)
* ConvTranspose ``kernel`` (kh, kw, I, O) -> ConvTranspose2d ``weight``
  (I, O, kh, kw), flipped in both spatial axes: flax's
  ``transpose_kernel=False`` convolves the dilated input with the kernel as
  it is, torch's with the kernel flipped (needs the ``model``)
* Embed ``embedding``                 -> Embedding ``weight``
* LayerNorm/BatchNorm ``scale``       -> ``weight``
* batch_stats ``mean``/``var``        -> ``running_mean``/``running_var``
* module ``Encoders_0`` / ``head_0``  -> ``Encoders.0`` / ``head.0``; SkipConnection's
  inner ``attn`` scope is dropped (the port keeps its layers on the module).
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LEAVES = {"embedding": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}
#: KerasMHA's DenseGeneral projections into (heads, key_dim)
_HEAD_PROJECTIONS = ("query", "key", "value")


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _module_name(part: str) -> str:
    m = re.fullmatch(r"(.+)_(\d+)", part)
    return f"{m.group(1)}.{m.group(2)}" if m else part


def _transposed_convs(model) -> set[str]:
    if model is None:
        return set()
    return {name for name, mod in model.named_modules()
            if isinstance(mod, torch.nn.ConvTranspose2d)}


def _weight(arr: np.ndarray, module: str, transposed: bool) -> np.ndarray:
    """A flax ``kernel`` as the port's ``weight``."""
    if transposed:
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 3:           # DenseGeneral: (in, H, D), or (H, D, out)
        flat = (arr.reshape(-1, arr.shape[-1]) if module == "out"
                else arr.reshape(arr.shape[0], -1))
        return flat.T
    return arr.T


def flax_to_state_dict(variables: Mapping,
                       model: torch.nn.Module | None = None
                       ) -> dict[str, torch.Tensor]:
    """The flax variables as a torch ``state_dict`` of the port's names.
    ``model``, the port module they are for, tells a transposed conv's
    kernel from a conv's; without it every 4-D kernel is a conv's."""
    transposed = _transposed_convs(model)
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})):
            *mods, leaf = path
            mods = [m for i, m in enumerate(mods)
                    if not (m == "attn" and i > 0
                            and mods[i - 1].startswith("SkipConnections_"))]
            prefix = ".".join(_module_name(m) for m in mods)
            if leaf == "kernel":
                name = "weight"
                arr = _weight(arr, mods[-1] if mods else "", prefix in transposed)
            elif not mods:               # a bare parameter, e.g. residual_gain
                name = leaf
            else:
                name = _LEAVES[leaf]
                if leaf == "bias" and mods[-1] in _HEAD_PROJECTIONS:
                    arr = arr.reshape(-1)
            key = ".".join([prefix, name]) if prefix else name
            out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Fill ``model`` from flax variables; every parameter and running
    statistic must be present, and nothing else."""
    sd = flax_to_state_dict(variables, model)
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
    if missing or extra:
        raise KeyError(f"flax variables do not match the model: missing "
                       f"{missing[:8]}, unexpected {extra[:8]}")
    model.load_state_dict(sd, strict=False)
    return model
