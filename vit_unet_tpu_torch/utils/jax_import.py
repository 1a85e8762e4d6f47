"""Carry the JAX model's weights into the port.

``load_flax_variables`` takes the flax ``{"params", "batch_stats"}`` tree of
``vit_unet_tpu``'s ViTUNet (or one of its submodules), as nested dicts of
numpy arrays, and fills the port's module of the same structure.  It is the
inverse of ``vit_unet_tpu/utils/torch_import.py``:

* Dense ``kernel`` (in, out)          -> Linear ``weight`` (out, in)
* Conv ``kernel`` (kh, kw, I, O)      -> Conv2d ``weight`` (O, I, kh, kw)
* Embed ``embedding``                 -> Embedding ``weight``
* LayerNorm/BatchNorm ``scale``       -> ``weight``
* batch_stats ``mean``/``var``        -> ``running_mean``/``running_var``
* module ``Encoders_0``               -> ``Encoders.0``; SkipConnection's
  inner ``attn`` scope is dropped (the port keeps its layers on the module).
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LEAVES = {"embedding": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _module_name(part: str) -> str:
    m = re.fullmatch(r"(.+)_(\d+)", part)
    return f"{m.group(1)}.{m.group(2)}" if m else part


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """The flax variables as a torch ``state_dict`` of the port's names."""
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})):
            *mods, leaf = path
            mods = [m for i, m in enumerate(mods)
                    if not (m == "attn" and i > 0
                            and mods[i - 1].startswith("SkipConnections_"))]
            if leaf == "kernel":
                name = "weight"
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            elif not mods:               # a bare parameter, e.g. residual_gain
                name = leaf
            else:
                name = _LEAVES[leaf]
            key = ".".join([_module_name(m) for m in mods] + [name])
            out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Fill ``model`` from flax variables; every parameter and running
    statistic must be present, and nothing else."""
    sd = flax_to_state_dict(variables)
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
    if missing or extra:
        raise KeyError(f"flax variables do not match the model: missing "
                       f"{missing[:8]}, unexpected {extra[:8]}")
    model.load_state_dict(sd, strict=False)
    return model
