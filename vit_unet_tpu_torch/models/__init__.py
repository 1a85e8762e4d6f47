from vit_unet_tpu_torch.models.vit_unet import (
    PRESETS, ViTUNet, ViTUNetConfig, get_config, get_vit_unet,
)
