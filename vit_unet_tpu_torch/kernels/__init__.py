from vit_unet_tpu_torch.kernels.flash_reattention import (
    expand_reattention_affine, flash_reattention, flash_reattention_plain,
    fold_reattention_compact,
)
