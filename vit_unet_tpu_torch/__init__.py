"""vit_unet_tpu_torch — the PyTorch / CUDA port of vit_unet_tpu for NVIDIA
Hopper (H100).

So far it covers the torch-flavour ViT-UNet's eval (serving) path and its
single-device train step (``parallel/train_step.py``), with every
re-attention contraction of a shape the kernels take (``kernel_takes``: at
most 16 heads, head dim 384; every level of the presets) in hand-written
CUDA kernels (``kernels/csrc/flash_reattention.cu`` for eval,
``kernels/csrc/flash_reattention_train.cu`` for training) and wider ones in
plain PyTorch.  It imports torch
and never jax or the JAX package.  Entry points run on the card unless given
``device=``.
"""
__version__ = "0.1.0"

from vit_unet_tpu_torch.models.vit_unet import (      # noqa: E402
    ViTUNet, ViTUNetConfig, get_config, get_vit_unet,
)
from vit_unet_tpu_torch.serving import Predictor      # noqa: E402

__all__ = ["ViTUNet", "ViTUNetConfig", "get_config", "get_vit_unet",
           "Predictor", "__version__"]
