"""vit_unet_tpu_torch — the PyTorch / CUDA port of vit_unet_tpu for NVIDIA
Hopper (H100).

So far it covers the eval (serving) path of the torch-flavour ViT-UNet, with
the re-attention contraction in a hand-written CUDA kernel
(``kernels/csrc/flash_reattention.cu``).  It imports torch and never jax or
the JAX package.  Entry points run on the card unless given ``device=``.
"""
__version__ = "0.1.0"

from vit_unet_tpu_torch.models.vit_unet import (      # noqa: E402
    ViTUNet, ViTUNetConfig, get_config, get_vit_unet,
)
from vit_unet_tpu_torch.serving import Predictor      # noqa: E402

__all__ = ["ViTUNet", "ViTUNetConfig", "get_config", "get_vit_unet",
           "Predictor", "__version__"]
