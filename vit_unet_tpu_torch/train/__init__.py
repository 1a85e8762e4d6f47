from vit_unet_tpu_torch.train.losses import LOSSES, get_loss
from vit_unet_tpu_torch.train.metrics import METRICS, get_metric
