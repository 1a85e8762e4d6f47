"""Per-epoch learning-rate schedules for the port's ``Fitter``: the
counterpart of ``vit_unet_tpu/train/schedules.py``."""
from __future__ import annotations

from typing import Callable

from vit_unet_tpu_torch.train.callbacks import Callback


def rampup_exp_decay(
    start_lr: float = 1e-5,
    max_lr: float = 5e-5,
    min_lr: float = 1e-5,
    rampup_epochs: int = 5,
    sustain_epochs: int = 0,
    exp_decay: float = 0.8,
    replicas: int = 1,
) -> Callable[[int], float]:
    """epoch -> lr; linear ramp to ``max_lr * replicas``, optional sustain,
    then exponential decay toward ``min_lr``."""
    peak = max_lr * replicas

    def lrfn(epoch: int) -> float:
        if epoch < rampup_epochs:
            return (peak - start_lr) / rampup_epochs * epoch + start_lr
        if epoch < rampup_epochs + sustain_epochs:
            return peak
        return ((peak - min_lr)
                * exp_decay ** (epoch - rampup_epochs - sustain_epochs)
                + min_lr)

    return lrfn


class LearningRateScheduler(Callback):
    """Sets ``fitter.learning_rate = schedule(epoch)`` at the start of each
    epoch, so a resumed run (``fit(initial_epoch=fitter.resume())``) gets
    its epoch's rate."""

    def __init__(self, schedule: Callable[[int], float], verbose: bool = False):
        self.schedule = schedule
        self.verbose = verbose

    def on_epoch_begin(self, fitter, epoch: int) -> None:
        lr = float(self.schedule(epoch))
        fitter.learning_rate = lr
        if self.verbose:
            print(f"LearningRateScheduler: epoch {epoch} lr={lr:.3g}",
                  flush=True)
