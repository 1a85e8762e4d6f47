from vit_unet_tpu_torch.parallel.train_step import (
    StepFunctions, TrainState, adamw, build_step_functions,
)
