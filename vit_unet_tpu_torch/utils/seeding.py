"""Global seeding: the counterpart of ``vit_unet_tpu/utils/seeding.py``.

The JAX package seeds python and numpy and returns a root PRNG key; here
python, numpy and torch are seeded, and the root of the explicit random
state is a ``torch.Generator`` on the asked device.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch

from vit_unet_tpu_torch.utils.device import resolve_device


def seed_everything(seed: int = 42, device=None) -> torch.Generator:
    """Seed python, numpy and torch (every CUDA device too); return a
    ``torch.Generator`` on ``device`` (default: the card) seeded with
    ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    # only CHILD processes see it: the running interpreter's hash
    # randomisation is fixed at its start
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen
