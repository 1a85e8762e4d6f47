"""Train and eval steps, the counterpart of
``vit_unet_tpu/parallel/train_step.py``: on one device, or on a mesh of
processes (``parallel/mesh.py``).

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

On a mesh (the JAX mesh path, :150-236): the batch is split over the
``data`` axis, and the parameters are laid out by the partition rules
(``parallel/partition.py``, as JAX's mesh step lays them out, :191): with a
``model`` axis of more than one rank the steps split the model when they
are built (``shard_module``: each rank keeps its block of every parameter a
rule splits, with its gradient and optimizer state), and every other
parameter is replicated.  Building the steps replicates rank (0, 0)'s
replicated tensors to every rank and each split block from data index 0
to its data line.  The gradients are averaged before clipping and the
update, so ``clip_norm`` and ``accum_steps`` mean what they mean on one
device:

* every gradient is whole on its model line when the backward ends: the
  split layers' collectives sum the partial input cotangents of a
  column-parallel layer over the line (``copy_to_model``), and the
  sequence-parallel re-attention sums its head-mix parameters' (the only
  replicated parameters whose ranks see a part of the tokens) over the
  line itself, so the replicated parameters' gradients are alike on the
  line and each split one is the rank's block of the whole gradient;
* so a replicated gradient is averaged over every rank (its model line's
  copies are alike; the average also keeps them bit-identical where
  per-rank rounding, such as the kernels' atomics, could part them), and a
  split one over its data line only (``average_gradients``);
* the clip takes the global norm (``global_grad_norm``): the squares of
  the split gradients summed over the model line, the replicated ones
  counted once, as ``optax.clip_by_global_norm`` takes it on global arrays.

A whole batch (every rank holds all of it) that the data axis does not
divide runs replicated (:214-220).  The layers see the mesh while the step
runs (``use_mesh``): the exact-BN moments are the whole batch's, as in the
JAX package's one program, and sequence-parallel layers split their tokens
over ``model``.  Loss and metrics are averaged over the ranks (a weighted
loss is normalised by the whole batch's weight).  Each data index draws its
own dropout; the ranks of one model line draw alike.  ``zero_sharding``
(ZeRO-1) holds the optimizer state sharded over ``data``
(``torch.distributed.optim.ZeroRedundancyOptimizer`` around the given
optimizer's class): each rank updates its share of the (split) parameters
and broadcasts it over its data line, as JAX's ``_zero_shard`` puts
``data`` on top of the split (:160-183).
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from vit_unet_tpu_torch.parallel.mesh import Mesh, data_sharding, use_mesh
from vit_unet_tpu_torch.parallel.partition import placements, shard_module


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
    """The steps, and the optimizer the ``TrainState`` must hold (the
    given one, or its ZeRO-1 wrapper with ``zero_sharding``)."""

    train_step: Callable
    eval_step: Callable
    optimizer: Optional[torch.optim.Optimizer] = None


def zero_optimizer(optimizer: torch.optim.Optimizer, mesh: Mesh):
    """``optimizer`` as ZeRO-1 over ``mesh``'s data axis: a
    ``ZeroRedundancyOptimizer`` of the same class, parameter groups and
    hyperparameters, whose state each data rank holds for its share of the
    parameters only.  It must be made before the optimizer has state; a ZeRO
    optimizer comes back as it is."""
    from torch.distributed.optim import ZeroRedundancyOptimizer
    if isinstance(optimizer, ZeroRedundancyOptimizer):
        return optimizer
    if optimizer.state:
        raise ValueError("ZeRO sharding starts from an optimizer without state")
    cls = type(optimizer)
    takes = inspect.signature(cls.__init__).parameters
    defaults = {k: v for k, v in optimizer.defaults.items() if k in takes}
    groups = [dict(g) for g in optimizer.param_groups]
    return ZeroRedundancyOptimizer(groups, optimizer_class=cls,
                                   process_group=mesh.group("data"), **defaults)


GRAD_BUCKET_BYTES = 64 << 20


def _grad_buckets(params):
    """The parameters' gradients in buckets of one dtype, each at most
    ``GRAD_BUCKET_BYTES`` (or one gradient larger than that)."""
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        bucket, size = [], 0
        for g in grads:
            nbytes = g.numel() * g.element_size()
            if bucket and size + nbytes > GRAD_BUCKET_BYTES:
                yield bucket
                bucket, size = [], 0
            bucket.append(g)
            size += nbytes
        yield bucket


def _all_reduce_mean(params, mesh: Mesh, axis: Optional[str]) -> None:
    """Average ``params``' gradients in place over this rank's line along
    ``axis`` (None: every rank, even a world of one), in buckets."""
    n = mesh.size if axis is None else mesh.shape[axis]
    if not params or (axis is not None and n <= 1):
        return
    for bucket in _grad_buckets(params):
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=mesh.group(axis))
        flat /= n
        for g, piece in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(piece)


@torch.no_grad()
def average_gradients(replicated, split, mesh: Mesh) -> None:
    """The mesh's gradient average, in place (module docstring): the
    replicated parameters' over every rank, the split ones' over their
    data line."""
    _all_reduce_mean(replicated, mesh, None)
    _all_reduce_mean(split, mesh, "data")


def _squares(params, device) -> torch.Tensor:
    terms = [p.grad.float().square().sum() for p in params if p.grad is not None]
    return torch.stack(terms).sum() if terms else torch.zeros((), device=device)


@torch.no_grad()
def global_grad_norm(replicated, split, mesh: Optional[Mesh]) -> torch.Tensor:
    """The gradient's global norm: the split gradients' squares summed
    over the model line, the replicated ones counted once."""
    device = (list(replicated) + list(split))[0].device
    part = _squares(split, device)
    if split and mesh is not None:
        mesh.all_reduce(part, "model")
    return torch.sqrt(_squares(replicated, device) + part)


@torch.no_grad()
def _lay_out(model: nn.Module, optimizer: torch.optim.Optimizer, mesh: Mesh) -> dict:
    """The model laid out on ``mesh`` (module docstring): split by the
    rules where the model axis holds several ranks, rank (0, 0)'s
    replicated tensors on every rank, each split block from data index 0
    on its data line.  Returns the placements."""
    split = placements(model)
    if not split and mesh.shape["model"] > 1:
        if optimizer.state:
            raise ValueError("splitting the model starts from an optimizer "
                             "without state")
        split = shard_module(model, mesh)
    for name, t in model.state_dict().items():
        if name not in split:
            dist.broadcast(t, src=int(mesh.grid[0, 0]))
        elif mesh.shape["data"] > 1:
            dist.broadcast(t, src=int(mesh.grid[0, mesh.index("model")]),
                           group=mesh.group("data"))
    return split


def build_step_functions(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh: Optional[Mesh] = None,
    metrics: Optional[dict[str, Callable]] = None,
    zero_sharding: bool = False,
    bn_frozen: bool = False,
    clip_norm: Optional[float] = None,
    accum_steps: int = 1,
    local_batches: bool = False,
) -> StepFunctions:
    """Train and eval steps for ``model`` and ``optimizer``.  The
    ``TrainState`` passed to the steps holds ``steps.optimizer``: the given
    optimizer, or with ``zero_sharding`` its ZeRO-1 form (``zero_optimizer``).

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

    ``mesh``: the steps run on every rank of it (module docstring); a
    model axis of more than one rank splits ``model`` in place.  A batch is
    the whole batch on every rank, or with ``local_batches`` each rank's
    own equal block of it (a loader sharded over the data axis).
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    if zero_sharding and mesh is None:
        raise ValueError("zero_sharding shards over a mesh's data axis: pass mesh")
    metrics = metrics or {}
    distributed = mesh is not None and dist.is_available() and dist.is_initialized()
    split_names = _lay_out(model, optimizer, mesh) if distributed else {}
    step_optimizer = zero_optimizer(optimizer, mesh) if zero_sharding else optimizer

    def _split(batch: dict):
        """(this rank's batch, whether the batch is split over data)."""
        if mesh is None or local_batches:
            return batch, mesh is not None
        if next(iter(batch.values())).shape[0] % mesh.shape["data"]:
            return batch, False
        return data_sharding(mesh).local(batch), True

    def _loss(pred, y, w, split):
        pred, y = pred.float(), y.float()
        if w is None:
            return loss_fn(pred, y)
        per = torch.func.vmap(loss_fn)(pred, y)
        w = w.float().reshape(-1)
        total = torch.sum(w)
        if split and mesh.shape["data"] > 1:
            # the whole batch's weight: each rank's loss is its share of the
            # whole weighted mean, times the ranks it is averaged over
            total = mesh.all_reduce(total.detach().clone(), "data") / mesh.shape["data"]
        return torch.sum(per * w) / total.clamp_min(1e-8)

    def _metrics(pred, y):
        with torch.no_grad():
            return {name: fn(pred.detach().float(), y.float())
                    for name, fn in metrics.items()}

    def _mean_over_ranks(out: dict) -> dict:
        if not distributed or mesh.size == 1:
            return out
        keys = list(out)
        both = torch.stack([out[k].detach().float().reshape(()) for k in keys])
        both = mesh.all_reduce(both) / mesh.size
        return dict(zip(keys, both.unbind()))

    def _check(state: TrainState):
        if state.model is not model or state.optimizer is not step_optimizer:
            raise ValueError("the state holds another model or optimizer than "
                             "the steps were built for (with zero_sharding: "
                             "steps.optimizer)")

    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    split = [p for n, p in named if n in split_names]
    replicated = [p for n, p in named if n not in split_names]

    # The gradients are averaged here, once an update, and not by
    # DistributedDataParallel: DDP averages at every backward, where
    # ``accum_steps`` averages once before the update and ``clip_norm``
    # clips that average, and the split parameters average over their data
    # line only.  It starts after the backward (no overlap with it), in
    # buckets of one dtype that each gradient joins at its own size, so at
    # most GRAD_BUCKET_BYTES are copied at a time.
    @torch.no_grad()
    def _average_grads():
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        average_gradients(replicated, split, mesh)

    @torch.no_grad()
    def _clip():
        norm = global_grad_norm(replicated, split, mesh if distributed else None)
        scale = clip_norm / torch.clamp(norm, min=clip_norm)
        for p in params:
            if p.grad is not None:
                p.grad.mul_(scale)

    def _on_mesh(split: bool):
        return use_mesh(mesh, split) if mesh is not None else contextlib.nullcontext()

    def train_step(state: TrainState, batch: dict):
        _check(state)
        batch, split = _split(batch)
        x, y, w = batch["x"], batch["y"], batch.get("w")
        seed = step_seed(state.seed, state.step)
        if split and mesh.shape["data"] > 1:
            seed = step_seed(seed, mesh.index("data"))
        state.generator.manual_seed(seed)
        if state.accum == 0:
            step_optimizer.zero_grad(set_to_none=True)
        with _on_mesh(split):
            pred = model(x, deterministic=False, use_running_average=bn_frozen,
                         generator=state.generator)
            loss = _loss(pred, y, w, split)
            loss.backward()
        state.accum += 1
        if state.accum == accum_steps:
            if accum_steps > 1:
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
            if distributed:
                _average_grads()
            if clip_norm is not None:
                _clip()
            step_optimizer.step()
            state.accum = 0
        state.step += 1
        return state, _mean_over_ranks({"loss": loss.detach(), **_metrics(pred, y)})

    def eval_step(state: TrainState, batch: dict):
        _check(state)
        batch, split = _split(batch)
        x, y, w = batch["x"], batch["y"], batch.get("w")
        with torch.no_grad(), _on_mesh(split):
            pred = model(x, deterministic=True, use_running_average=True)
            out = {"loss": _loss(pred, y, w, split), **_metrics(pred, y)}
        return _mean_over_ranks(out)

    return StepFunctions(train_step, eval_step, step_optimizer)
