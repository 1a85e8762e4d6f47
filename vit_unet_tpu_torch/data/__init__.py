from vit_unet_tpu_torch.data.loader import (
    DataLoader, DeviceResidentData, TFRecordStream, device_normalize,
    prefetch_to_device, tfdata_pipeline, tfrecord_dataset,
)
from vit_unet_tpu_torch.data import tfrecord
