"""Transformer MLP, the counterpart of ``vit_unet_tpu/nn/feedforward.py``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.nn.dropout import dropout
from vit_unet_tpu_torch.parallel.partition import copy_to_model, reduce_from_model


class FeedForward(nn.Module):
    """Linear(hidden) -> GELU -> Drop -> Linear(proj) -> [GELU] -> Drop.
    GELU is the exact (erf) form.  ``final_gelu=True`` is the TF flavour's
    extra activation after the second layer.  Dropout (``drop1``/``drop2``
    in the JAX module) runs when ``deterministic`` is False.

    Split over a mesh's ``model`` axis (``tp_mesh``, set by
    ``parallel/partition.py::shard_module``): fc1 column-parallel, GELU and
    the first dropout on the rank's slice of the hidden features (with that
    slice of the whole mask), fc2 row-parallel with one all-reduce, and
    fc2's bias added once after it."""

    tp_mesh = None

    def __init__(self, projection_dim: int, hidden_dim: int,
                 dropout: float = 0.0, final_gelu: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.final_gelu = final_gelu
        self.dtype = dtype
        self.fc1 = nn.Linear(projection_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, projection_dim)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        rate = 0.0 if deterministic else self.dropout
        mesh = self.tp_mesh
        x = x.to(dt)
        if mesh is not None:
            x = copy_to_model(x, mesh)
        x = F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        block = None if mesh is None else (-1, mesh.index("model"), mesh.shape["model"])
        x = dropout(F.gelu(x), rate, generator, block)
        if mesh is None:
            x = F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        else:
            x = (reduce_from_model(F.linear(x, self.fc2.weight.to(dt)), mesh)
                 + self.fc2.bias.to(dt))
        if self.final_gelu:
            x = F.gelu(x)
        return dropout(x, rate, generator)
