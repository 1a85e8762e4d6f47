"""What the convergence runs (``cli/convergence_segmentation.py``,
``cli/convergence_sidd.py``) share: the results file, the card's name and
power limit, and an epoch of steps and of evaluation over arrays that lie
on the device."""
from __future__ import annotations

import json
import os
import subprocess
from typing import Callable, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: the port's results, beside the JAX package's CONVERGENCE.json (which the
#: port never writes)
CONVERGENCE_PATH = os.path.join(REPO, "CONVERGENCE_torch.json")


def merge_into_convergence(update: dict) -> None:
    """Merge ``update``'s sections into ``CONVERGENCE_PATH``, keeping the
    file's other sections."""
    results = {}
    if os.path.exists(CONVERGENCE_PATH):
        with open(CONVERGENCE_PATH) as f:
            results = json.load(f)
    results.update(update)
    with open(CONVERGENCE_PATH, "w") as f:
        json.dump(results, f, indent=1)


def card(device: torch.device) -> dict:
    """The device the runs took: the card's name and power limit as
    ``nvidia-smi`` gives them, or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu"}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    return {"name": torch.cuda.get_device_name(device), "nvidia_smi": limit}


def on_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def train_epoch(steps, state, xs: torch.Tensor, ys: torch.Tensor, batch: int,
                epoch: int, lr_at: Optional[Callable[[], float]] = None):
    """One epoch in the order ``np.random.default_rng(epoch)`` permutes,
    ``len(xs) // batch`` steps; ``lr_at()`` gives each step's learning
    rate.  Returns (state, the last step's metrics)."""
    n_steps = len(xs) // batch
    order = torch.from_numpy(np.random.default_rng(epoch).permutation(len(xs)))
    order = order.to(xs.device)
    metrics = None
    for s in range(n_steps):
        idx = order[s * batch:(s + 1) * batch]
        if lr_at is not None:
            for group in state.optimizer.param_groups:
                group["lr"] = lr_at()
        state, metrics = steps.train_step(state, {"x": xs[idx], "y": ys[idx]})
    return state, metrics


def evaluate(steps, state, xv: torch.Tensor, yv: torch.Tensor, batch: int) -> dict:
    """The eval step's metrics, each the mean over ``len(xv) // batch``
    batches."""
    agg: dict = {}
    for s in range(len(xv) // batch):
        sl = slice(s * batch, (s + 1) * batch)
        for k, v in steps.eval_step(state, {"x": xv[sl], "y": yv[sl]}).items():
            agg.setdefault(k, []).append(float(v))
    return {k: float(np.mean(v)) for k, v in agg.items()}


class StepCount:
    """The optimizer's update count, the schedule's argument (optax counts
    from 0 and restarts when its state is made anew)."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule, self.count = schedule, 0

    def __call__(self) -> float:
        lr = self.schedule(self.count)
        self.count += 1
        return lr
