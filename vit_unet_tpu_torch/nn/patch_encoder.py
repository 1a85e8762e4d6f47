"""Patch encoders, the counterparts of ``vit_unet_tpu/nn/patch_encoder.py``.

* ``PatchEncoder`` (torch flavour): optional conv/fourier preprocessing on
  the image, patchify at the finest hierarchy level, add a learned position
  embedding over the fine tokens, then regroup fine patches into the coarse
  entry-level patches with one relayout.
* ``PatchEncoderCL`` (TF flavour): patchify a channels-last image, then a
  Dense projection and a learned position embedding.

Split over a mesh's ``model`` axis (``tp_mesh``, set by
``parallel/partition.py::shard_module``), each holds its block of the
position embedding's tokens and all-gathers it before the add."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.ops.patches import (
    change_patch_size, flatten_patches, patchify, patchify_cl,
)
from vit_unet_tpu_torch.parallel.partition import gather_from_model


def position_table(layer: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """``layer.position_embedding``'s whole table in ``dtype``, gathered
    over ``layer.tp_mesh`` where its tokens are split."""
    table = layer.position_embedding.weight.to(dtype)
    if layer.tp_mesh is not None:
        table = gather_from_model(table, layer.tp_mesh, 0)
    return table


class PatchEncoder(nn.Module):
    tp_mesh = None

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
        encoded = flat + position_table(self, dt)
        return change_patch_size(encoded, self.num_channels,
                                 up_factor=2 ** self.depth)


class PatchEncoderCL(nn.Module):
    """(B, H, W, C) -> (B, N, projection_dim), N = (img_size / p)²."""

    tp_mesh = None

    def __init__(self, img_size: int, patch_size: int, num_channels: int = 3,
                 projection_dim: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        num_patches = (img_size // patch_size) ** 2
        proj_dim = projection_dim or num_channels * patch_size ** 2
        self.projection = nn.Linear(num_channels * patch_size ** 2, proj_dim)
        self.position_embedding = nn.Embedding(num_patches, proj_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        pats = patchify_cl(x.to(dt), self.patch_size)
        flat = pats.reshape(pats.shape[0], pats.shape[1], -1)
        proj = F.linear(flat, self.projection.weight.to(dt),
                        self.projection.bias.to(dt))
        return proj + position_table(self, dt)
