"""Single-device train and eval steps, the counterpart of
``vit_unet_tpu/parallel/train_step.py``.

One train step: the model's training forward (dropout on, the head-mix
BatchNorm on batch statistics unless ``bn_frozen``), the loss in float32,
the backward through the kernels' autograd Functions, and the optimizer's
update.  Dropout comes from the state's own generator, re-seeded from
(seed, step) before every step, so a step is reproducible on its own.  The
step returns its metrics as tensors on the device and never synchronises.

Meshes, data parallelism and ZeRO sharding belong to the port's multi-GPU
slice: ``mesh`` and ``zero_sharding`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn


def adamw(model: nn.Module, lr: float = 1e-4, *, weight_decay: float = 1e-4,
          b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> torch.optim.AdamW:
    """AdamW with ``optax.adamw``'s defaults (weight decay 1e-4, where
    ``torch.optim.AdamW`` defaults to 0.01), decaying every parameter.
    The moments take the parameters' dtype, as optax's do."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


def step_seed(seed: int, step: int) -> int:
    """The generator seed of train step ``step``."""
    return (seed * 1_000_003 + step) % (1 << 63)


@dataclasses.dataclass
class TrainState:
    """Carried training state: the model (parameters and BatchNorm running
    statistics), its optimizer, the step count and the dropout generator."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    seed: int
    generator: torch.Generator

    @classmethod
    def create(cls, *, model: nn.Module, optimizer: torch.optim.Optimizer,
               seed: int = 0) -> "TrainState":
        device = next(model.parameters()).device
        return cls(model=model, optimizer=optimizer, step=0, seed=seed,
                   generator=torch.Generator(device=device))


@dataclasses.dataclass
class StepFunctions:
    train_step: Callable
    eval_step: Callable


def build_step_functions(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh=None,
    metrics: Optional[dict[str, Callable]] = None,
    zero_sharding: bool = False,
    bn_frozen: bool = False,
) -> StepFunctions:
    """Train and eval steps for ``model`` and ``optimizer`` (which the
    ``TrainState`` passed to the steps must hold).

    ``batch`` is a dict with ``x``, ``y`` and optionally ``w``, per-sample
    loss weights: the weighted mean normalised by sum(w), so w = 1 gives
    the unweighted loss.  ``bn_frozen`` runs the train step with the
    head-mix BatchNorm at its running statistics (no updates) while dropout
    stays on.
    """
    if mesh is not None or zero_sharding:
        raise NotImplementedError(
            "meshes and ZeRO sharding belong to the port's multi-GPU slice "
            "and are not implemented yet")
    metrics = metrics or {}

    def _loss(pred, y, w):
        pred, y = pred.float(), y.float()
        if w is None:
            return loss_fn(pred, y)
        per = torch.func.vmap(loss_fn)(pred, y)
        w = w.float().reshape(-1)
        return torch.sum(per * w) / torch.sum(w).clamp_min(1e-8)

    def _metrics(pred, y):
        with torch.no_grad():
            return {name: fn(pred.detach().float(), y.float())
                    for name, fn in metrics.items()}

    def _check(state: TrainState):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than "
                             "the steps were built for")

    def train_step(state: TrainState, batch: dict):
        _check(state)
        x, y, w = batch["x"], batch["y"], batch.get("w")
        state.generator.manual_seed(step_seed(state.seed, state.step))
        optimizer.zero_grad(set_to_none=True)
        pred = model(x, deterministic=False, use_running_average=bn_frozen,
                     generator=state.generator)
        loss = _loss(pred, y, w)
        loss.backward()
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), **_metrics(pred, y)}

    def eval_step(state: TrainState, batch: dict):
        _check(state)
        x, y, w = batch["x"], batch["y"], batch.get("w")
        with torch.no_grad():
            pred = model(x, deterministic=True, use_running_average=True)
            return {"loss": _loss(pred, y, w), **_metrics(pred, y)}

    return StepFunctions(train_step, eval_step)
