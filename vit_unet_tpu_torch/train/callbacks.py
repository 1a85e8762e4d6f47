"""Training callbacks for the port's ``Fitter``: the counterpart of
``vit_unet_tpu/train/callbacks.py``, with the same hooks, settings and
decisions.  A callback moves the learning rate through
``fitter.learning_rate`` (the optimizer's ``param_groups``)."""
from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Optional


class Callback:
    def on_train_begin(self, fitter) -> None: ...
    def on_epoch_begin(self, fitter, epoch: int) -> None: ...
    def on_epoch_end(self, fitter, epoch: int, logs: dict) -> None: ...
    def on_train_end(self, fitter) -> None: ...


class LambdaCallback(Callback):
    """Wraps a plain function f(fitter, epoch, logs), called at epoch end."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def on_epoch_end(self, fitter, epoch, logs):
        self.fn(fitter, epoch, logs)


def _improved(value: float, best: float, mode: str, min_delta: float) -> bool:
    if mode == "min":
        return value < best - min_delta
    return value > best + min_delta


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "val_loss", mode: str = "min",
                 patience: int = 4, min_delta: float = 0.0):
        self.monitor, self.mode = monitor, mode
        self.patience, self.min_delta = patience, min_delta
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0

    def on_epoch_end(self, fitter, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        if _improved(value, self.best, self.mode, self.min_delta):
            self.best, self.wait = value, 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                fitter.stop_training = True
                logs["early_stopped"] = True


class ReduceLROnPlateau(Callback):
    """Multiply the learning rate by ``factor`` (not below ``min_lr``) after
    ``patience`` epochs without an improvement of ``min_delta``, then wait
    ``cooldown`` epochs."""

    def __init__(self, monitor: str = "val_loss", mode: str = "min",
                 factor: float = 0.5, patience: int = 1,
                 min_delta: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 1e-8):
        self.monitor, self.mode = monitor, mode
        self.factor, self.patience = factor, patience
        self.min_delta, self.cooldown, self.min_lr = min_delta, cooldown, min_lr
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0
        self.cooldown_left = 0

    def on_epoch_end(self, fitter, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.wait = 0
        if _improved(value, self.best, self.mode, self.min_delta):
            self.best, self.wait = value, 0
        elif self.cooldown_left <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                old = fitter.learning_rate
                new = max(old * self.factor, self.min_lr)
                if new < old:
                    fitter.learning_rate = new
                    logs["lr_reduced_to"] = new
                self.cooldown_left = self.cooldown
                self.wait = 0


class JSONLLogger(Callback):
    """One JSON line per epoch: the epoch, the seconds since training began,
    the learning rate the epoch trained with, and the epoch's logs."""

    def __init__(self, path: str):
        self.path = path
        self._t0 = None

    def on_train_begin(self, fitter):
        self._t0 = time.time()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)

    def on_epoch_end(self, fitter, epoch, logs):
        # logs['lr'] (set by the fitter at epoch start) is the LR this epoch
        # trained with; fitter.learning_rate may already hold next epoch's.
        rec = {"epoch": epoch, "elapsed_s": round(time.time() - self._t0, 2),
               "lr": logs.get("lr", fitter.learning_rate), **logs}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")


class WandbCallback(Callback):
    """Optional wandb logging.  Credentials come from the environment only,
    as wandb reads them; without an importable ``wandb`` it does nothing."""

    def __init__(self, project: str = "vit-unet-tpu", config: Optional[dict] = None):
        self.project, self.config = project, config
        self.run = None

    def on_train_begin(self, fitter):
        try:
            import wandb  # optional dependency
        except ImportError:
            return
        self.run = wandb.init(project=self.project, config=self.config)

    def on_epoch_end(self, fitter, epoch, logs):
        if self.run is not None:
            self.run.log(dict(logs, epoch=epoch))

    def on_train_end(self, fitter):
        if self.run is not None:
            self.run.finish()
