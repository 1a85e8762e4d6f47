"""HViT-UNet in the TF notebook's orientation, the counterpart of
``vit_unet_tpu/models/hvit_unet_tf.py`` (the reference's own TPU model).

Channels-last images, a Dense patch projection at the finest patch size,
an ascending patch-size list (the encoder merges patches going down: tokens
256 -> 64 -> 16 at 128²), keras-style attention blocks by default
(``original_attn=True``; re-attention on channels-last tokens otherwise),
``Resampling`` layers between levels, keras-attention skip connections
(query = encoder skip, key/value = decoder stream) and a global residual
output ``Y = X + unpatch(decoded)``, with an optional zero-initialised
per-channel gain on the decoded branch (``residual_gain``).

Module names follow the JAX model's (``Encoder_0`` -> ``Encoder.0``), so
``utils/jax_import.py::load_flax_variables`` carries its weights across.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vit_unet_tpu_torch.models.vit_unet import _torch_dtype, flax_init_
from vit_unet_tpu_torch.nn.blocks import TFTransformerEncoder
from vit_unet_tpu_torch.nn.mha import KerasMHA
from vit_unet_tpu_torch.nn.patch_encoder import PatchEncoderCL
from vit_unet_tpu_torch.nn.resampling import Resampling
from vit_unet_tpu_torch.ops.patches import unpatchify_cl
from vit_unet_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HViTUNetTFConfig:
    """The JAX package's config, field for field and with its checks.
    ``use_flash`` and ``flash_train`` default to True here, as in the
    port's ``ViTUNetConfig``: every attention of a shape the kernels take
    runs them on the card, keras attention with an identity head mix (eval
    and training) and re-attention (``original_attn=False``) in eval, and
    in training too with ``flash_train``.  ``use_flash=False`` runs the
    plain versions."""

    img_size: int = 128
    patch_size: tuple = (8, 16, 32)          # strictly increasing
    projection_dim: Optional[int] = None     # None -> C*p² per level
    num_channels: int = 3
    num_heads: int = 8
    transformer_layers: tuple = (4, 4)
    size_bottleneck: int = 4
    hidden_unit_factor: float = 2.0
    drop_attn: float = 0.2
    drop_proj: float = 0.2
    drop_linear: float = 0.4
    resampling_type: str = "standard"        # 'max' | 'avg' | 'standard' | 'conv'
    original_attn: bool = True
    use_flash: bool = True
    flash_train: bool = True
    residual_gain: bool = False
    dtype: str = "float32"
    param_dtype: str = "float32"

    def __post_init__(self):
        ps = list(self.patch_size)
        if any(self.img_size % p for p in ps):
            raise ValueError("patch sizes must divide image size")
        if any(ps[i] >= ps[i + 1] for i in range(len(ps) - 1)):
            raise ValueError("patch sizes must be strictly increasing")
        if self.resampling_type in ("max", "avg") and self.projection_dim is None:
            raise ValueError("projection_dim required for max/avg resampling")
        if self.projection_dim is not None:
            want = self.num_channels * ps[0] ** 2
            if self.projection_dim != want:
                # the global-residual unpatch needs level 0 at C*p0²
                raise ValueError(
                    f"projection_dim must be num_channels*patch_size[0]^2 = "
                    f"{want} for the residual output to reassemble an image")
        if self.resampling_type == "standard" and self.projection_dim is not None:
            raise ValueError("projection_dim is auto-computed for 'standard'")

    @property
    def num_patches(self) -> list[int]:
        return [(self.img_size // p) ** 2 for p in self.patch_size]

    @property
    def projection_dims(self) -> list[int]:
        if self.projection_dim is not None:
            return [self.projection_dim] * len(self.patch_size)
        return [self.num_channels * p ** 2 for p in self.patch_size]

    @property
    def hidden_units(self) -> list[int]:
        return [int(self.hidden_unit_factor * d) for d in self.projection_dims]


class HViTUNetTF(nn.Module):
    """(B, H, W, C) channels-last -> the same shape.  Starts in eval mode;
    ``train()`` makes ``forward`` default to the training semantics."""

    def __init__(self, config: HViTUNetTFConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dt = _torch_dtype(cfg.dtype)
        ps = list(cfg.patch_size)
        n_levels = len(ps) - 1
        proj, hidden = cfg.projection_dims, cfg.hidden_units
        rs_dim = cfg.projection_dim if cfg.resampling_type != "standard" else None

        def stack(level: int, layers: int):
            return TFTransformerEncoder(
                proj[level], hidden[level], cfg.num_heads, layers,
                num_channels=cfg.num_channels,
                attn_drop=cfg.drop_attn, proj_drop=cfg.drop_proj,
                original_attn=cfg.original_attn, use_flash=cfg.use_flash,
                flash_train=cfg.flash_train, dtype=dt)

        def resampling(pair):
            return Resampling(cfg.img_size, pair, cfg.num_channels, rs_dim,
                              cfg.resampling_type, dtype=dt)

        self.PE = PatchEncoderCL(cfg.img_size, ps[0], cfg.num_channels,
                                 cfg.projection_dim or cfg.num_channels * ps[0] ** 2,
                                 dtype=dt)
        self.Encoder = nn.ModuleList(
            stack(i, cfg.transformer_layers[i]) for i in range(n_levels))
        self.Encoder_RS = nn.ModuleList(
            resampling(ps[i:i + 2]) for i in range(n_levels))
        self.BottleNeck = stack(n_levels, cfg.size_bottleneck)
        ps_rev = ps[::-1]
        levels = [len(ps) - (i + 2) for i in range(n_levels)]  # decoder targets
        self.Decoder_RS = nn.ModuleList(
            resampling(ps_rev[i:i + 2]) for i in range(n_levels))
        self.Decoder = nn.ModuleList(
            stack(lvl, cfg.transformer_layers[lvl]) for lvl in levels)
        self.SkipConnection = nn.ModuleList(
            KerasMHA(proj[lvl], cfg.num_heads, key_dim=proj[lvl],
                     value_dim=proj[lvl], dropout=cfg.drop_attn,
                     use_flash=cfg.use_flash, dtype=dt)
            for lvl in levels)
        if cfg.residual_gain:
            self.residual_gain = nn.Parameter(torch.zeros(cfg.num_channels))
        self.eval()

    def init_weights(self, generator: torch.Generator) -> "HViTUNetTF":
        """flax's default initialisers, drawn from ``generator``
        (``flax_init_``)."""
        return flax_init_(self, generator)

    def forward(self, x: torch.Tensor, *, deterministic: Optional[bool] = None,
                use_running_average: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``deterministic=False`` turns dropout on, drawn from
        ``generator``; ``use_running_average=False`` normalises the
        re-attention head mix with batch statistics (``original_attn=
        False`` only).  Both default to ``not self.training``.  The output
        takes the input's dtype."""
        if deterministic is None:
            deterministic = not self.training
        if use_running_average is None:
            use_running_average = not self.training
        kw = dict(deterministic=deterministic,
                  use_running_average=use_running_average, generator=generator)
        h = self.PE(x)
        skips = []
        for enc, rs in zip(self.Encoder, self.Encoder_RS):
            h = enc(h, **kw)
            skips.append(h)
            h = rs(h)
        h = self.BottleNeck(h, **kw)
        for rs, dec, skip, skip_attn in zip(self.Decoder_RS, self.Decoder,
                                            skips[::-1], self.SkipConnection):
            h = dec(rs(h), **kw)
            h = skip_attn(skip, h, deterministic=deterministic,
                          generator=generator)
        out = unpatchify_cl(h, self.config.num_channels).to(x.dtype)
        if self.config.residual_gain:
            return x + self.residual_gain.to(x.dtype)[None, None, None, :] * out
        return x + out


def get_hvit_unet_tf(*, device: str | torch.device | None = None,
                     seed: int = 0, **overrides) -> HViTUNetTF:
    """Config fields -> model on ``device`` (default: the card), in eval
    mode.  It is built there and its weights are drawn there, from
    ``torch.Generator(device).manual_seed(seed)``, then
    cast to ``param_dtype`` in place: the host is slow to draw the default
    model's 1.57 B weights.  One seed gives one model per device type.  ``device='meta'`` builds shapes only."""
    dev = resolve_device(device)
    cfg = HViTUNetTFConfig(**overrides)
    with torch.device(dev):
        model = HViTUNetTF(cfg)
    if dev.type == "meta":
        return model
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    pdt = _torch_dtype(cfg.param_dtype)
    for p in model.parameters():     # BN running statistics stay float32
        p.data = p.data.to(pdt)
    return model
