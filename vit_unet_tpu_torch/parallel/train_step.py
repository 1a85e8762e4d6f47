"""Single-device train and eval steps, the counterpart of
``vit_unet_tpu/parallel/train_step.py``.

One train step: the model's training forward (dropout on, the head-mix
BatchNorm on batch statistics unless ``bn_frozen``), the loss in float32,
the backward through the kernels' autograd Functions, and the optimizer's
update.  Dropout comes from the state's own generator, re-seeded from
(seed, step) before every step, so a step is reproducible on its own.  The
step returns its metrics as tensors on the device and never synchronises.

Gradient clipping and accumulation compute what the JAX ``Fitter``'s optax
chain ``MultiSteps(chain(clip_by_global_norm(c), tx), k)`` computes: the
mean of k micro-batch gradients, clipped by its global norm, then one
optimizer update.

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
    statistics), its optimizer, the step count (micro-batches), the dropout
    generator, and how many micro-batch gradients the parameters' ``grad``
    holds toward the next update (``accum``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    seed: int
    generator: torch.Generator
    accum: int = 0

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
    clip_norm: Optional[float] = None,
    accum_steps: int = 1,
) -> StepFunctions:
    """Train and eval steps for ``model`` and ``optimizer`` (which the
    ``TrainState`` passed to the steps must hold).

    ``batch`` is a dict with ``x``, ``y`` and optionally ``w``, per-sample
    loss weights: the weighted mean normalised by sum(w), so w = 1 gives
    the unweighted loss.  ``bn_frozen`` runs the train step with the
    head-mix BatchNorm at its running statistics (no updates) while dropout
    stays on.

    ``accum_steps`` = k > 1: a step adds its gradient to the parameters'
    ``grad``; every k-th step averages them and updates, and the steps
    between leave the parameters and the optimizer alone.  ``clip_norm`` =
    c: before an update the (averaged) gradient g becomes
    g · c / max(|g|, c), |g| the global norm over every parameter (optax's
    ``clip_by_global_norm``).  The optimizer counts only updates.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
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

    params = [p for p in model.parameters() if p.requires_grad]

    @torch.no_grad()
    def _clip():
        norm = torch.sqrt(sum(p.grad.float().square().sum()
                              for p in params if p.grad is not None))
        scale = clip_norm / torch.clamp(norm, min=clip_norm)
        for p in params:
            if p.grad is not None:
                p.grad.mul_(scale)

    def train_step(state: TrainState, batch: dict):
        _check(state)
        x, y, w = batch["x"], batch["y"], batch.get("w")
        state.generator.manual_seed(step_seed(state.seed, state.step))
        if state.accum == 0:
            optimizer.zero_grad(set_to_none=True)
        pred = model(x, deterministic=False, use_running_average=bn_frozen,
                     generator=state.generator)
        loss = _loss(pred, y, w)
        loss.backward()
        state.accum += 1
        if state.accum == accum_steps:
            if accum_steps > 1:
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
            if clip_norm is not None:
                _clip()
            optimizer.step()
            state.accum = 0
        state.step += 1
        return state, {"loss": loss.detach(), **_metrics(pred, y)}

    def eval_step(state: TrainState, batch: dict):
        _check(state)
        x, y, w = batch["x"], batch["y"], batch.get("w")
        with torch.no_grad():
            pred = model(x, deterministic=True, use_running_average=True)
            return {"loss": _loss(pred, y, w), **_metrics(pred, y)}

    return StepFunctions(train_step, eval_step)
