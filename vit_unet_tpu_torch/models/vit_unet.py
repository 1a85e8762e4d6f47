"""ViT-UNet in PyTorch, eval and training: the counterpart of
``vit_unet_tpu/models/vit_unet.py``.

Patch-encode, ``depth`` levels of ``depth_te`` re-attention blocks with patch
size fluctuation (split patches going down: tokens x4, features /4), a
transformer bottleneck, a mirrored decoder, and cross-attention skip
connections from encoder level i to decoder level depth-i.  Parameter names
follow the reference module tree (``tests/oracle/torch_oracle.py``), so a
``state_dict`` loads into the JAX model through the JAX package's
``utils/torch_import.py``; ``utils/jax_import.py`` goes the other way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.nn.blocks import ReAttentionEncoderBlock
from vit_unet_tpu_torch.nn.patch_encoder import PatchEncoder
from vit_unet_tpu_torch.nn.reattention import SkipConnection
from vit_unet_tpu_torch.ops.patches import merge_patches, split_patches, unpatchify
from vit_unet_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTUNetConfig:
    """The JAX package's config, field for field.  ``remat``,
    ``block_type='fourier'`` and sequence parallelism raise
    ``NotImplementedError`` when the model is built.  ``use_flash`` and
    ``flash_train`` default to True here: every re-attention, eval and
    training, runs the port's kernels on the card; ``use_flash=False`` (or
    ``flash_train=False`` for training) runs their plain versions, which
    materialise the N x N map."""

    depth: int = 2
    depth_te: int = 2
    size_bottleneck: int = 2
    preprocessing: str = "conv"      # 'conv' | 'fourier' | 'none'
    im_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    hidden_dim: int = 128
    num_heads: int = 8
    attn_drop: float = 0.2
    proj_drop: float = 0.2
    linear_drop: float = 0.0
    qkv_kernel: int = 3              # 3 = packaged/README, 1 = notebook 512²
    ln_mode: str = "shared"          # 'shared' (README counts) | 'dual'
    block_type: str = "reattention"  # 'reattention' | 'fourier'
    remat: bool = False
    out_channels: Optional[int] = None
    global_residual: bool = False    # Y = X + decoded
    residual_gain: bool = False      # Y = X + g * decoded, g zero-init
    input_skip: bool = False         # concat the input before the output conv
    head_blocks: int = 0             # (Conv 3x3 head_dim, GELU) blocks
    head_dim: int = 32
    use_flash: bool = True
    flash_train: bool = True
    flash_frozen_bn: bool = False
    bn_track: bool = False
    attn_bn_eps: float = 1e-5
    sequence_parallel: bool = False
    sp_min_tokens: int = 1024
    dtype: str = "float32"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.patch_size % 2 ** self.depth:
            raise ValueError("depth incompatible: 2^depth must divide patch_size")
        if self.patch_size // 2 ** self.depth < 4:
            raise ValueError("depth too large: final patch size < 4")
        if self.im_size % self.patch_size:
            raise ValueError("patch_size must divide im_size")
        if self.block_type not in ("reattention", "fourier"):
            raise ValueError("block_type must be 'reattention' or 'fourier'")
        if (self.global_residual and self.out_channels
                and self.out_channels != self.num_channels):
            raise ValueError(
                "global_residual requires out_channels == num_channels")
        if self.residual_gain and not self.global_residual:
            raise ValueError("residual_gain requires global_residual=True")
        if (self.preprocessing == "fourier" and self.out_channels
                and self.out_channels != self.num_channels):
            raise ValueError(
                "preprocessing='fourier' replaces the output with ifft2 of "
                "the input (reference quirk, torch/model.py:429-430) and is "
                "incompatible with out_channels != num_channels")

    @property
    def num_patches(self) -> int:
        return (self.im_size // self.patch_size) ** 2

    @property
    def projection_dim(self) -> int:
        return self.num_channels * self.patch_size ** 2

    def level_geometry(self, level: int) -> dict:
        """Patch/token/feature sizes at hierarchy level ``level``."""
        return dict(
            patch_size=self.patch_size // 2 ** level,
            num_patches=self.num_patches * 4 ** level,
            projection_dim=self.projection_dim // 4 ** level,
            hidden_dim=self.hidden_dim // 2 ** level,
        )


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class ViTUNet(nn.Module):
    """(B, C, H, W) -> (B, C_out, im_size, im_size).  Starts in eval mode;
    ``train()`` makes ``forward`` default to the training semantics."""

    def __init__(self, config: ViTUNetConfig):
        super().__init__()
        cfg = config
        if cfg.sequence_parallel:
            raise NotImplementedError(
                "sequence parallelism belongs to the port's multi-GPU slice "
                "and is not implemented yet")
        if cfg.block_type == "fourier":
            raise NotImplementedError(
                "block_type='fourier' (FourierEncoderBlock) is not ported yet")
        if cfg.remat:
            raise NotImplementedError(
                "remat (activation checkpointing) is not ported yet")
        self.config = cfg
        self.dtype = dt = _torch_dtype(cfg.dtype)
        self.PE = PatchEncoder(cfg.depth, cfg.num_patches, cfg.patch_size,
                               cfg.num_channels, cfg.preprocessing, dtype=dt)
        common = dict(num_channels=cfg.num_channels, num_heads=cfg.num_heads,
                      qkv_kernel=cfg.qkv_kernel, attn_drop=cfg.attn_drop,
                      proj_drop=cfg.proj_drop, use_flash=cfg.use_flash,
                      flash_train=cfg.flash_train,
                      flash_frozen_bn=cfg.flash_frozen_bn,
                      bn_track=cfg.bn_track, bn_eps=cfg.attn_bn_eps, dtype=dt)

        def block(level: int):
            g = cfg.level_geometry(level)
            return ReAttentionEncoderBlock(
                g["num_patches"], g["projection_dim"], g["hidden_dim"],
                linear_drop=cfg.linear_drop, ln_mode=cfg.ln_mode, **common)

        self.Encoders = nn.ModuleList(
            block(lvl) for lvl in range(cfg.depth) for _ in range(cfg.depth_te))
        self.BottleNeck = nn.ModuleList(
            block(cfg.depth) for _ in range(cfg.size_bottleneck))
        self.Decoders = nn.ModuleList(
            block(cfg.depth - lvl)
            for lvl in range(cfg.depth) for _ in range(cfg.depth_te))
        self.SkipConnections = nn.ModuleList(
            SkipConnection(cfg.projection_dim // 4 ** (cfg.depth - lvl - 1),
                           **common)
            for lvl in range(cfg.depth))
        c = cfg.num_channels
        out_ch = cfg.out_channels or c
        conv_in = c + c if cfg.input_skip else c
        if cfg.head_blocks:
            self.head = nn.ModuleList()
            for _ in range(cfg.head_blocks):
                self.head.append(nn.Conv2d(conv_in, cfg.head_dim, 3, padding="same"))
                conv_in = cfg.head_dim
        if self._has_out_conv:
            self.conv2d = nn.Conv2d(conv_in, out_ch, 3, padding="same")
        if cfg.residual_gain:
            self.residual_gain = nn.Parameter(torch.zeros(out_ch))
        self.eval()

    @property
    def _has_out_conv(self) -> bool:
        cfg = self.config
        return (cfg.preprocessing == "conv"
                or (cfg.out_channels or cfg.num_channels) != cfg.num_channels
                or cfg.input_skip or bool(cfg.head_blocks))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ViTUNet":
        """flax's default initialisers, drawn from ``generator``: LeCun
        truncated normal for Linear/Conv weights, zero biases, N(0, 1/d)
        embeddings, unit norms, zero residual gain."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                std = math.sqrt(1.0 / mod.weight[0].numel()) / .87962566103423978
                nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5,
                                   generator=generator)
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                mod.reset_parameters()
        if self.config.residual_gain:
            self.residual_gain.zero_()
        return self

    def forward(self, x: torch.Tensor, *, deterministic: Optional[bool] = None,
                use_running_average: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``deterministic=False`` turns dropout on, drawn from
        ``generator`` (a ``torch.Generator`` on the input's device, needed
        when a dropout rate is above 0); ``use_running_average=False``
        normalises the head-mix BatchNorm with batch statistics and updates
        its running ones.  Both default to ``not self.training``."""
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
        x = x.to(dt)

        h = self.PE(x)
        skips = []
        for i, enc in enumerate(self.Encoders):
            h = enc(h, **kw)
            if (i + 1) % cfg.depth_te == 0:
                skips.append(h)
                h = split_patches(h, cfg.num_channels)
        for bott in self.BottleNeck:
            h = bott(h, **kw)
        for i, dec in enumerate(self.Decoders):
            h = dec(h, **kw)
            if (i + 1) % cfg.depth_te == 0:
                lvl = (i + 1) // cfg.depth_te
                h = merge_patches(h, cfg.num_channels)
                h = self.SkipConnections[lvl - 1](skips[cfg.depth - lvl], h, h,
                                                  **kw)

        out = unpatchify(h, cfg.num_channels)
        if cfg.input_skip:
            out = torch.cat([out, x], dim=1)
        if self._has_out_conv:
            for conv in (self.head if cfg.head_blocks else ()):
                # flax's nn.gelu is the tanh approximation
                out = F.gelu(F.conv2d(out, conv.weight.to(dt), conv.bias.to(dt),
                                      padding="same"), approximate="tanh")
            out = F.conv2d(out, self.conv2d.weight.to(dt),
                           self.conv2d.bias.to(dt), padding="same")
        if cfg.global_residual:
            if cfg.residual_gain:
                out = x + self.residual_gain.to(dt)[None, :, None, None] * out
            else:
                out = x + out
        elif cfg.preprocessing == "fourier":
            # reference quirk (torch/model.py:429-430): ifft2 of the *input*
            out = torch.fft.ifft2(x.float(), norm="ortho").real.to(out.dtype)
        return out


# --- registry (torch/model.py:438-486 presets, README.md:16-68) ---

PRESETS: dict[str, dict] = {
    "lite": dict(depth=2, depth_te=1, size_bottleneck=2, preprocessing="conv",
                 im_size=224, patch_size=16, num_channels=3, hidden_dim=64,
                 num_heads=4, attn_drop=0.2, proj_drop=0.2, linear_drop=0.0),
    "base": dict(depth=2, depth_te=2, size_bottleneck=2, preprocessing="conv",
                 im_size=224, patch_size=32, num_channels=3, hidden_dim=128,
                 num_heads=8, attn_drop=0.2, proj_drop=0.2, linear_drop=0.0),
    "large": dict(depth=2, depth_te=4, size_bottleneck=4, preprocessing="conv",
                  im_size=224, patch_size=32, num_channels=3, hidden_dim=128,
                  num_heads=8, attn_drop=0.2, proj_drop=0.2, linear_drop=0.0),
    # the notebook 512² prototype (ViT_UNet.ipynb cell 45)
    "notebook512": dict(depth=2, depth_te=2, size_bottleneck=1,
                        preprocessing="conv", im_size=512, patch_size=32,
                        num_channels=3, hidden_dim=256, num_heads=8,
                        attn_drop=0.2, proj_drop=0.2, linear_drop=0.0,
                        qkv_kernel=1),
}


def get_config(name: str, **overrides) -> ViTUNetConfig:
    if name.lower() not in PRESETS:
        raise ValueError(f"model string {name!r} not valid; "
                         f"choose from {sorted(PRESETS)}")
    return ViTUNetConfig(**{**PRESETS[name.lower()], **overrides})


def get_vit_unet(name: str, *, device: str | torch.device | None = None,
                 seed: int = 0, **overrides) -> ViTUNet:
    """Preset name -> model on ``device`` (default: the card), in eval
    mode.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (so one seed gives one model on every device), then cast to
    ``param_dtype`` and moved.  ``device='meta'`` builds shapes only.
    """
    dev = resolve_device(device)
    cfg = get_config(name, **overrides)
    if dev.type == "meta":
        with torch.device("meta"):
            return ViTUNet(cfg)
    model = ViTUNet(cfg).init_weights(torch.Generator().manual_seed(seed))
    pdt = _torch_dtype(cfg.param_dtype)
    for p in model.parameters():     # BN running statistics stay float32
        p.data = p.data.to(pdt)
    return model.to(dev)
