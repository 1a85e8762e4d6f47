"""Hierarchical ViT classifier in PyTorch, eval and training: the
counterpart of ``vit_unet_tpu/models/vit_classifier.py``.

Patch-encode, ``depth`` levels of ``depth_te`` re-attention blocks (level
``lvl``: ``num_patches * 4**lvl`` tokens of ``projection_dim // 4**lvl``
features, MLP width ``hidden_dim // 2**lvl``, ``num_heads`` heads at every
level) with ``split_patches`` between levels, the mean over tokens, and a
Dense head of widths ``linear_list``: exact GELU and ``linear_drop``
dropout between its layers, the last layer's output the logits.  Parameter
names follow the JAX module (``PE``, ``Encoders.i``, ``head.i``), so
``utils/jax_import.py`` carries its variables over.

At the CLI's default size (224², patch 16, 196 patches, 16 heads) the
levels are (16 heads, dh 48) at N 196 and (16, 12) at N 784: every
re-attention runs the kernels (``kernel_takes``), kernel 1 on its
tensor-core route in bf16, kernels 2-4 on their CUDA-core routes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.models.vit_unet import _torch_dtype, flax_init_
from vit_unet_tpu_torch.nn.blocks import ReAttentionEncoderBlock
from vit_unet_tpu_torch.nn.dropout import dropout
from vit_unet_tpu_torch.nn.patch_encoder import PatchEncoder
from vit_unet_tpu_torch.ops.patches import split_patches
from vit_unet_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTClassifierConfig:
    """The JAX package's config, field for field, with its checks.
    ``use_flash`` and ``flash_train`` default to True here, as in the
    port's other configs: every re-attention runs the port's kernels on the
    card."""

    depth: int = 2
    depth_te: int = 4
    linear_list: Sequence[int] = (64, 4)
    preprocessing: str = "conv"
    num_patches: int = 64
    patch_size: int = 16
    num_channels: int = 3
    hidden_dim: int = 128
    num_heads: int = 16
    attn_drop: float = 0.2
    proj_drop: float = 0.2
    linear_drop: float = 0.2
    qkv_kernel: int = 3
    ln_mode: str = "shared"
    use_flash: bool = True
    flash_train: bool = True
    flash_frozen_bn: bool = False
    dtype: str = "float32"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.patch_size % 2 ** self.depth:
            raise ValueError("depth incompatible: 2^depth must divide patch_size")
        side = round(self.num_patches ** 0.5)
        if side * side != self.num_patches:
            raise ValueError("num_patches must be a perfect square")
        if not self.linear_list:
            raise ValueError("linear_list needs at least the class count")

    @property
    def im_size(self) -> int:
        return self.patch_size * round(self.num_patches ** 0.5)

    @property
    def projection_dim(self) -> int:
        return self.num_channels * self.patch_size ** 2

    @property
    def num_classes(self) -> int:
        return int(self.linear_list[-1])


class ViTClassifier(nn.Module):
    """(B, C, H, W) -> (B, num_classes) logits.  Starts in eval mode;
    ``train()`` makes ``forward`` default to the training semantics."""

    def __init__(self, config: ViTClassifierConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dt = _torch_dtype(cfg.dtype)
        self.PE = PatchEncoder(cfg.depth, cfg.num_patches, cfg.patch_size,
                               cfg.num_channels, cfg.preprocessing, dtype=dt)
        self.Encoders = nn.ModuleList(
            ReAttentionEncoderBlock(
                cfg.num_patches * 4 ** lvl, cfg.projection_dim // 4 ** lvl,
                cfg.hidden_dim // 2 ** lvl, cfg.num_heads,
                num_channels=cfg.num_channels, attn_drop=cfg.attn_drop,
                proj_drop=cfg.proj_drop, linear_drop=cfg.linear_drop,
                qkv_kernel=cfg.qkv_kernel, ln_mode=cfg.ln_mode,
                use_flash=cfg.use_flash, flash_train=cfg.flash_train,
                flash_frozen_bn=cfg.flash_frozen_bn, dtype=dt)
            for lvl in range(cfg.depth) for _ in range(cfg.depth_te))
        widths = [cfg.projection_dim // 4 ** (cfg.depth - 1), *cfg.linear_list]
        self.head = nn.ModuleList(nn.Linear(a, b)
                                  for a, b in zip(widths, widths[1:]))
        self.eval()

    def init_weights(self, generator: torch.Generator) -> "ViTClassifier":
        """flax's default initialisers, drawn from ``generator``
        (``flax_init_``)."""
        return flax_init_(self, generator)

    def forward(self, x: torch.Tensor, *, deterministic: Optional[bool] = None,
                use_running_average: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``deterministic=False`` turns dropout on, drawn from
        ``generator``; ``use_running_average=False`` normalises the head-mix
        BatchNorms with batch statistics.  Both default to
        ``not self.training``."""
        if deterministic is None:
            deterministic = not self.training
        if use_running_average is None:
            use_running_average = not self.training
        kw = dict(deterministic=deterministic,
                  use_running_average=use_running_average, generator=generator)
        cfg = self.config
        dt = self.dtype
        if x.shape[-1] != cfg.im_size or x.shape[-2] != cfg.im_size:
            # jax.image.resize(..., 'bilinear') antialiases when it shrinks
            x = F.interpolate(x.float(), size=(cfg.im_size, cfg.im_size),
                              mode="bilinear", align_corners=False,
                              antialias=True)
        h = self.PE(x.to(dt))
        for i, enc in enumerate(self.Encoders):
            h = enc(h, **kw)
            if (i + 1) % cfg.depth_te == 0 and i + 1 < len(self.Encoders):
                h = split_patches(h, cfg.num_channels)
        h = h.mean(dim=1)                           # global token pool
        rate = 0.0 if deterministic else cfg.linear_drop
        for i, dense in enumerate(self.head):
            h = F.linear(h, dense.weight.to(dt), dense.bias.to(dt))
            if i + 1 < len(self.head):
                h = dropout(F.gelu(h), rate, generator)
        return h


def get_vit_classifier(config: Optional[ViTClassifierConfig] = None, *,
                       device: str | torch.device | None = None, seed: int = 0,
                       **fields) -> ViTClassifier:
    """Config (or its fields) -> model on ``device`` (default: the card), in
    eval mode.  It is built there and its weights are drawn there, from
    ``torch.Generator(device).manual_seed(seed)``, then cast to
    ``param_dtype`` in place, as ``get_hvit_unet_tf`` does: one seed gives
    one model per device type.  ``device='meta'`` builds shapes only."""
    dev = resolve_device(device)
    cfg = (dataclasses.replace(config, **fields) if config is not None
           else ViTClassifierConfig(**fields))
    with torch.device(dev):
        model = ViTClassifier(cfg)
    if dev.type == "meta":
        return model
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    pdt = _torch_dtype(cfg.param_dtype)
    for p in model.parameters():     # BN running statistics stay float32
        p.data = p.data.to(pdt)
    return model
