from vit_unet_tpu_torch.parallel.mesh import (
    create_hybrid_mesh, create_mesh, data_sharding, initialize_distributed,
    local_device_count, replica_count, replicated,
)
from vit_unet_tpu_torch.parallel.sequence import (
    sequence_parallel_reattention, sequence_parallel_reattention_train,
)
from vit_unet_tpu_torch.parallel.train_step import (
    StepFunctions, TrainState, adamw, build_step_functions, zero_optimizer,
)
