from vit_unet_tpu_torch.models.hvit_unet_tf import (
    HViTUNetTF, HViTUNetTFConfig, get_hvit_unet_tf,
)
from vit_unet_tpu_torch.models.vit_classifier import (
    ViTClassifier, ViTClassifierConfig, get_vit_classifier,
)
from vit_unet_tpu_torch.models.vit_unet import (
    PRESETS, ViTUNet, ViTUNetConfig, get_config, get_vit_unet,
)
