"""Transformer MLP, the counterpart of ``vit_unet_tpu/nn/feedforward.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.nn.eval_only import EvalOnlyModule


class FeedForward(EvalOnlyModule):
    """Linear(hidden) -> GELU -> Linear(proj) -> [GELU], eval mode (no
    dropout).  GELU is the exact (erf) form.  ``final_gelu=True`` is the TF
    flavour's extra activation after the second layer."""

    def __init__(self, projection_dim: int, hidden_dim: int,
                 final_gelu: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.final_gelu = final_gelu
        self.dtype = dtype
        self.fc1 = nn.Linear(projection_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, projection_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.linear(x.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        x = F.gelu(x)
        x = F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        if self.final_gelu:
            x = F.gelu(x)
        return x
