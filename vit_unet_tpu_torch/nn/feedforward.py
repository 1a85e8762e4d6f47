"""Transformer MLP, the counterpart of ``vit_unet_tpu/nn/feedforward.py``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.nn.dropout import dropout


class FeedForward(nn.Module):
    """Linear(hidden) -> GELU -> Drop -> Linear(proj) -> [GELU] -> Drop.
    GELU is the exact (erf) form.  ``final_gelu=True`` is the TF flavour's
    extra activation after the second layer.  Dropout (``drop1``/``drop2``
    in the JAX module) runs when ``deterministic`` is False."""

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
        x = F.linear(x.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        x = dropout(F.gelu(x), rate, generator)
        x = F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        if self.final_gelu:
            x = F.gelu(x)
        return dropout(x, rate, generator)
