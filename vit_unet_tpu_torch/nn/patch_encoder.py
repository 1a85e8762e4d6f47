"""Patch encoder (torch flavour), the counterpart of
``vit_unet_tpu/nn/patch_encoder.py::PatchEncoder``: optional conv/fourier
preprocessing on the image, patchify at the finest hierarchy level, add a
learned position embedding over the fine tokens, then regroup fine patches
into the coarse entry-level patches with one relayout."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.nn.eval_only import EvalOnlyModule
from vit_unet_tpu_torch.ops.patches import (
    change_patch_size, flatten_patches, patchify,
)


class PatchEncoder(EvalOnlyModule):
    def __init__(self, depth: int, num_patches: int, patch_size: int,
                 num_channels: int = 3, preprocessing: str = "conv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if preprocessing not in ("conv", "fourier", "none"):
            raise ValueError(f"unknown preprocessing {preprocessing!r}")
        self.depth = depth
        self.num_channels = num_channels
        self.preprocessing = preprocessing
        self.dtype = dtype
        self.patch_size_final = patch_size // 2 ** depth
        num_patches_final = num_patches * 4 ** depth
        if preprocessing == "conv":
            self.conv2d = nn.Conv2d(num_channels, num_channels, 3,
                                    padding="same")
        self.position_embedding = nn.Embedding(
            num_patches_final, num_channels * self.patch_size_final ** 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        if self.preprocessing == "conv":
            x = F.conv2d(x, self.conv2d.weight.to(dt),
                         self.conv2d.bias.to(dt), padding="same")
        elif self.preprocessing == "fourier":
            x = torch.fft.fft2(x.float()).real.to(dt)
        flat = flatten_patches(patchify(x, self.patch_size_final))
        encoded = flat + self.position_embedding.weight.to(dt)
        return change_patch_size(encoded, self.num_channels,
                                 up_factor=2 ** self.depth)
