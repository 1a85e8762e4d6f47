"""Eval-only guard shared by the port's modules.

The port covers the serving (eval) path so far.  Training needs the
head-mix BatchNorm's update rule (momentum 0.9, biased batch variance, as
flax updates it) and the training kernels, which come with the training
slice; running torch's own BatchNorm in train mode would update the
running statistics by a different rule.  So train mode is refused.
"""
from __future__ import annotations

from torch import nn

TRAINING_SLICE = ("training (dropout, batch-statistics BatchNorm, the "
                  "flash_reattention_train kernels) belongs to the port's "
                  "training slice and is not implemented yet")


def check_eval(deterministic: bool = True,
               use_running_average: bool = True) -> None:
    if not (deterministic and use_running_average):
        raise NotImplementedError(TRAINING_SLICE)


class EvalOnlyModule(nn.Module):
    """An ``nn.Module`` that starts in eval mode and refuses ``train()``."""

    def __init__(self):
        super().__init__()
        self.training = False

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError(TRAINING_SLICE)
        return super().train(False)
