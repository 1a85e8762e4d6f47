"""Learning-rate schedules: per-epoch ones for the port's ``Fitter`` (the
counterpart of ``vit_unet_tpu/train/schedules.py``), and the port's copy of
optax's per-step ``warmup_cosine_decay_schedule``."""
from __future__ import annotations

import math
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


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable[[int], float]:
    """step -> lr, as ``optax.warmup_cosine_decay_schedule``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps`` (warmup included), constant
    after.  optax applies step k's value to the k-th update (k from 0)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps "
                         f"({warmup_steps})")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - max(step, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


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
