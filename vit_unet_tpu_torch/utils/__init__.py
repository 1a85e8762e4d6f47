from vit_unet_tpu_torch.utils.device import resolve_device
from vit_unet_tpu_torch.utils.jax_import import (
    flax_to_state_dict, load_flax_variables,
)
