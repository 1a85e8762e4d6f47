from vit_unet_tpu_torch.nn.blocks import (
    FourierEncoderBlock, ReAttentionEncoderBlock, TFTransformerEncoder,
)
from vit_unet_tpu_torch.nn.feedforward import FeedForward
from vit_unet_tpu_torch.nn.mha import KerasMHA
from vit_unet_tpu_torch.nn.patch_encoder import PatchEncoder, PatchEncoderCL
from vit_unet_tpu_torch.nn.reattention import (
    ReAttention, SkipConnection, conv_tokens, merge_heads, split_heads,
)
from vit_unet_tpu_torch.nn.resampling import Resampling
