from vit_unet_tpu_torch.ops.patches import (
    change_patch_size, flatten_patches, merge_patches, patchify,
    split_patches, unflatten, unpatchify,
)
