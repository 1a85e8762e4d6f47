"""Stat-matched BN refold: a function-preserving frozen -> exact-BN flip,
the counterpart of ``vit_unet_tpu/train/bn_refold.py``.

The head-mix BatchNorm of re-attention normalises attention maps whose
variance is near 1e-6 at init, so exact batch-statistics training from
scratch stalls at the init plateau; frozen BN (the running statistics)
trains, but a hard flip to batch statistics afterwards is a normalisation
shock.  The refold makes the flip preserve the function.  For each
head-mix BN with frozen statistics (mu_r, var_r) and affine (g, b), measure
the batch moments (mu_b, var_b) of its input under the current parameters,
then set

    g' = g * sqrt(var_b + eps) / sqrt(var_r + eps)
    b' = b + g * (mu_b - mu_r) / sqrt(var_r + eps)

so that g' (a - mu_b) / sqrt(var_b + eps) + b' equals
g (a - mu_r) / sqrt(var_r + eps) + b for every input a: the exact-BN
forward at the flip computes the function the frozen forward did, up to
the fluctuation of a batch's moments around the measured ones.  The running
statistics become the measured moments, so eval is unchanged too.

The moments are measured on the plain N x N path (``mixed_map``, not the
kernels), with dropout off and frozen-BN semantics, in float32: the mean
and the two-pass variance mean((c - mean)^2) of each head's mixed map c
over (batch, query, key), averaged over the calibration batches in
float64.  (E[c^2] - E[c]^2 would cancel at var ~ 1e-6 in float32.)  For a
bfloat16 model the JAX package takes c from the head-mix conv's output in
the model's dtype; here c is the plain path's float32 map.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn

from vit_unet_tpu_torch.kernels.flash_reattention_train import (
    apply_mixed_map, mixed_map,
)
from vit_unet_tpu_torch.nn.reattention import ReAttention, merge_heads

__all__ = ["estimate_bn_moments", "bn_refold"]


def _head_mix_layers(model: nn.Module) -> dict[str, ReAttention]:
    return {name: mod for name, mod in model.named_modules()
            if isinstance(mod, ReAttention)}


def _capturing_attend(mod: ReAttention, record):
    """An ``_attend`` for ``mod`` that runs the frozen-BN forward on the
    plain path and hands its mixed map's float32 moments to ``record``."""
    def attend(q, k, v, **_):
        conv, bn = mod.reatten_matrix, mod.var_norm
        c = mixed_map(q * mod.scale, k, conv.weight[:, :, 0, 0], conv.bias)
        c32 = c.float()
        mean = c32.mean((0, 2, 3))
        var = (c32 - mean[None, :, None, None]).square().mean((0, 2, 3))
        record(mean, var)
        out = apply_mixed_map(c, merge_heads(v), (bn.weight, bn.bias),
                              (bn.running_mean, bn.running_var), mod.bn_eps)
        return out.to(q.dtype)
    return attend


@torch.no_grad()
def estimate_bn_moments(model: nn.Module, batches: Iterable,
                        max_batches: Optional[int] = None
                        ) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Each head-mix BatchNorm's input moments under the current parameters.

    ``batches``: input tensors or {'x': ...} dicts on the model's device.
    Forward semantics: frozen BN (running statistics), dropout off, the
    plain path.  Returns ``{module name: (mean, var)}``, float32 per-head
    tensors on the CPU, keyed by the ``ReAttention`` / ``SkipConnection``
    module's name in ``model.named_modules()``.
    """
    layers = _head_mix_layers(model)
    sums: dict[str, list] = {}
    batch_moments: dict[str, tuple] = {}

    def recorder(name):
        return lambda mean, var: batch_moments.__setitem__(name, (mean, var))

    for name, mod in layers.items():
        mod._attend = _capturing_attend(mod, recorder(name))
    n = 0
    try:
        for i, b in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            x = b["x"] if isinstance(b, dict) else b
            batch_moments.clear()
            model(x, deterministic=True, use_running_average=True)
            for name, (mean, var) in batch_moments.items():
                smu, svar = sums.get(name, (0.0, 0.0))
                sums[name] = (smu + mean.double().cpu(), svar + var.double().cpu())
            n += 1
    finally:
        for mod in layers.values():
            del mod._attend
    if n == 0:
        raise ValueError("estimate_bn_moments received no batches")
    return {name: ((smu / n).float(), (svar / n).float())
            for name, (smu, svar) in sums.items()}


@torch.no_grad()
def bn_refold(model: nn.Module, moments: dict, eps: Optional[float] = None
              ) -> nn.Module:
    """Fold the measured moments into every matched head-mix BatchNorm's
    affine (``var_norm.weight`` / ``bias``) and running statistics, in
    place, dtypes preserved (formulas above).  ``eps`` defaults to each
    layer's own.  Raises if no layer matched."""
    layers = _head_mix_layers(model)
    done = 0
    for name, (mu_b, var_b) in moments.items():
        mod = layers.get(name)
        if mod is None:
            continue
        bn = mod.var_norm
        e = mod.bn_eps if eps is None else eps
        g, b = bn.weight.double(), bn.bias.double()
        mu_r, var_r = bn.running_mean.double(), bn.running_var.double()
        mu_b = torch.as_tensor(mu_b, dtype=torch.float64, device=g.device)
        var_b = torch.as_tensor(var_b, dtype=torch.float64, device=g.device)
        s_r = torch.sqrt(var_r + e)
        s_b = torch.sqrt(var_b + e)
        bn.weight.copy_(g * s_b / s_r)
        bn.bias.copy_(b + g * (mu_b - mu_r) / s_r)
        bn.running_mean.copy_(mu_b)
        bn.running_var.copy_(var_b)
        done += 1
    if done == 0:
        raise ValueError("bn_refold matched no head-mix BatchNorm (var_norm) "
                         "module: the model has nothing to refold")
    return model
