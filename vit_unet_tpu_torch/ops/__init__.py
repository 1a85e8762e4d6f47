from vit_unet_tpu_torch.ops.patches import (
    change_patch_size, change_patch_size_cl, flatten_patches, merge_patches,
    patchify, patchify_cl, split_patches, unflatten, unflatten_cl,
    unpatchify, unpatchify_cl,
)
