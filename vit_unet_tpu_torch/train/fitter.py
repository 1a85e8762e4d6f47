"""Fitter, the port's trainer: the counterpart of
``vit_unet_tpu/train/fitter.py``, on one device or a mesh of processes.

It owns the epoch loop (with a bounded queue of steps whose metrics are
still on the card), validation weighted by batch size, history, best and
last full-state checkpoints (``torch.save``: parameters, BatchNorm running
statistics, optimizer state, step, seed and dropout generator state),
preemption-safe ``resume``, the callbacks, gradient clipping and
accumulation, and the frozen -> exact BatchNorm warmup of the head mix
(``bn_freeze_epochs`` with ``bn_warmup`` 'freeze', 'track' or 'refold').

On a mesh (``parallel/mesh.py``) every rank runs the same ``Fitter`` on its
own part of each batch (a loader sharded over the data axis, e.g.
``DataLoader(shard_id=mesh.index("data"), num_shards=replica_count(mesh))``);
the steps average gradients, losses and metrics over the ranks, so every
rank logs the same history and takes the same decisions.  Rank 0 alone
writes checkpoints, after ZeRO's shards of the optimizer state are gathered
to it and a partly accumulated gradient is averaged over the ranks; every
rank reads them to resume.  A model split over the mesh's ``model`` axis
(``parallel/partition.py``) is gathered whole first, parameters, optimizer
state and gradient alike, so a checkpoint is the same file whatever the
mesh; loading one splits it again on every rank, so a run can resume on
another mesh.
"""
from __future__ import annotations

import itertools
import math
import os
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from vit_unet_tpu_torch.nn.reattention import ReAttention
from vit_unet_tpu_torch.parallel.mesh import replica_count
from vit_unet_tpu_torch.parallel.partition import (
    gather_tensor, model_block, placements,
)
from vit_unet_tpu_torch.parallel.train_step import (
    StepFunctions, TrainState, build_step_functions, zero_optimizer,
)
from vit_unet_tpu_torch.train import losses as losses_lib
from vit_unet_tpu_torch.train import metrics as metrics_lib
from vit_unet_tpu_torch.train.bn_refold import bn_refold, estimate_bn_moments
from vit_unet_tpu_torch.train.callbacks import Callback
from vit_unet_tpu_torch.utils.device import resolve_device


def _as_loss(loss) -> Callable:
    return losses_lib.get_loss(loss) if isinstance(loss, str) else loss


def _as_metrics(metrics) -> dict:
    out = {}
    for m in metrics or ():
        if isinstance(m, str):
            out[m] = metrics_lib.get_metric(m)
        else:
            out[m.__name__] = m
    return out


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class Fitter:
    def __init__(
        self,
        model: nn.Module,
        learning_rate: float = 1e-4,
        optimizer: str | torch.optim.Optimizer = "adamw",
        loss: str | Callable = "mse",
        metrics: Sequence[str | Callable] = ("psnr",),
        mesh=None,
        scale_lr_by_replicas: bool = False,
        weight_decay: float = 0.0,
        checkpoint_dir: str = "models",
        monitor: str = "val_loss",
        mode: str = "min",
        seed: int = 42,
        gradient_clip_norm: Optional[float] = None,
        grad_accum_steps: int = 1,
        dispatch_depth: int = 8,
        zero_sharding: bool = False,
        bn_freeze_epochs: int = 0,
        bn_warmup: str = "freeze",
        bn_calib_batches: int = 4,
        device=None,
    ):
        """``model``: a built ``nn.Module`` (e.g. ``get_vit_unet``), moved to
        ``device`` (default: the card).  ``optimizer``: ``'adam'``,
        ``'adamw'`` (weight decay ``weight_decay``) or ``'sgd'`` at
        ``learning_rate``, or a ready ``torch.optim.Optimizer`` over the
        model's parameters.  The learning rate lives in the optimizer's
        ``param_groups`` (``learning_rate`` reads and sets it).

        ``gradient_clip_norm``: clip the gradient's global norm before each
        update.  ``grad_accum_steps`` = k > 1: average k micro-batch
        gradients per update.

        ``dispatch_depth``: the most train steps whose metrics are still on
        the card before the host reads back the oldest step's (a scalar
        copy that waits for it).

        ``bn_freeze_epochs`` = K: the first K epochs train with the head-mix
        BatchNorm frozen at its running statistics, then training flips to
        batch statistics.  ``bn_warmup`` says what happens at the flip:

        * ``'refold'`` (recommended): measure each head-mix BatchNorm's
          input moments on the first ``bn_calib_batches`` batches of the
          flip epoch (they are still trained on), fold them into its affine
          and running statistics (``train.bn_refold``) so the exact-BN
          forward computes the function the frozen phase trained, and clear
          the optimizer's state, keeping the live learning rate;
        * ``'freeze'``: a hard flip (the running statistics never moved, so
          it is a normalisation shock);
        * ``'track'``: the warmup epochs normalise with the running
          statistics while pulling them toward each batch's moments (each
          ``ReAttention.bn_track`` on), so the flip is continuous.

        ``mesh``: train on every rank of it (module docstring); ``device``
        then defaults to the mesh's.  ``scale_lr_by_replicas``: the
        reference's ``lr * REPLICAS`` (the data axis's ranks).
        ``zero_sharding``: ZeRO-1, the optimizer state sharded over the data
        axis.
        """
        if zero_sharding and mesh is None:
            raise ValueError("zero_sharding shards over a mesh's data axis: "
                             "pass mesh")
        self.mesh = mesh
        self.zero_sharding = zero_sharding
        if scale_lr_by_replicas and mesh is not None:
            learning_rate = learning_rate * replica_count(mesh)
        if device is None and mesh is not None:
            device = mesh.device
        self.bn_freeze_epochs = int(bn_freeze_epochs)
        self.bn_calib_batches = int(bn_calib_batches)
        if bn_warmup not in ("freeze", "track", "refold"):
            raise ValueError(f"bn_warmup must be 'freeze', 'track' or "
                             f"'refold', got {bn_warmup!r}")
        self.bn_warmup = bn_warmup
        cfg = getattr(model, "config", None)
        if self.bn_freeze_epochs > 0 and getattr(cfg, "flash_frozen_bn", False):
            raise ValueError(
                "bn_freeze_epochs is a frozen->batch-stats warmup; the model "
                "is already permanently frozen (flash_frozen_bn=True) so "
                "there is nothing to flip to")
        if (self.bn_warmup == "track" and self.bn_freeze_epochs > 0
                and (cfg is None or not hasattr(cfg, "bn_track"))):
            raise ValueError(
                "bn_warmup='track' needs a model whose config carries "
                "bn_track (ViTUNetConfig); use bn_warmup='freeze' for "
                "other models")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if isinstance(optimizer, str):
            params = self.model.parameters()
            self.optimizer = {
                "adam": lambda: torch.optim.Adam(params, lr=learning_rate,
                                                 betas=(0.9, 0.999), eps=1e-8),
                "adamw": lambda: torch.optim.AdamW(
                    params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=weight_decay),
                "sgd": lambda: torch.optim.SGD(params, lr=learning_rate),
            }[optimizer]()
        else:
            self.optimizer = optimizer
        if zero_sharding:
            self.optimizer = zero_optimizer(self.optimizer, mesh)
        self.gradient_clip_norm = gradient_clip_norm
        self.grad_accum_steps = int(grad_accum_steps)
        self.dispatch_depth = max(1, int(dispatch_depth))
        self.loss_fn = _as_loss(loss)
        self.metric_fns = _as_metrics(metrics)
        self.checkpoint_dir = checkpoint_dir
        self.monitor, self.mode = monitor, mode
        self.seed = seed
        self.state: Optional[TrainState] = None
        self.steps: Optional[StepFunctions] = None
        self._frozen_steps: Optional[StepFunctions] = None
        self.history: dict[str, list] = {}
        self.stop_training = False
        self.best = math.inf if mode == "min" else -math.inf
        self._writer: Optional[threading.Thread] = None
        self._write_error: list[BaseException] = []

    # -- state management ---------------------------------------------------

    def _build_steps(self, bn_frozen: bool) -> StepFunctions:
        return build_step_functions(
            self.model, self.optimizer, self.loss_fn, mesh=self.mesh,
            metrics=self.metric_fns, zero_sharding=self.zero_sharding,
            bn_frozen=bn_frozen, clip_norm=self.gradient_clip_norm,
            accum_steps=self.grad_accum_steps, local_batches=True)

    def init_state(self) -> TrainState:
        """The training state of the model as it stands (it is built
        already, so no sample batch is needed), and its step functions."""
        self.state = TrainState.create(model=self.model,
                                       optimizer=self.optimizer, seed=self.seed)
        self.steps = self._build_steps(bn_frozen=False)
        self._frozen_steps = None
        if self.bn_freeze_epochs > 0:
            # 'track' trains the warmup epochs with batch statistics while
            # each layer's bn_track keeps the forward at the running ones
            self._frozen_steps = self._build_steps(
                bn_frozen=self.bn_warmup != "track")
        return self.state

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    @learning_rate.setter
    def learning_rate(self, value: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = value

    # -- checkpointing ------------------------------------------------------

    def _ckpt_path(self, name: str) -> str:
        return os.path.abspath(os.path.join(self.checkpoint_dir, f"{name}.pt"))

    def finalize_checkpoints(self) -> None:
        """Wait for the checkpoint write in flight, if any; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error:
            raise self._write_error.pop()

    @property
    def _distributed(self) -> bool:
        return (self.mesh is not None and dist.is_available()
                and dist.is_initialized())

    @property
    def writes_checkpoints(self) -> bool:
        """Whether this process writes checkpoints (rank 0 of a mesh)."""
        return not self._distributed or dist.get_rank() == 0

    def _split_params(self) -> list:
        """(placement or None) of each parameter, in ``parameters()`` order
        (the optimizer's, too)."""
        split = placements(self.model)
        return [split.get(n) for n, _ in self.model.named_parameters()]

    def _optimizer_params(self) -> list:
        """The parameters in the order of the optimizer state's indices."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def _map_optimizer_state(self, sd: dict, fn) -> dict:
        """``sd`` with ``fn(tensor, split, param)`` applied to each state
        tensor of a split parameter."""
        by_id = {id(p): s for p, s in zip(self.model.parameters(), self._split_params())}
        params = self._optimizer_params()
        state = {}
        for idx, entry in sd["state"].items():
            p = params[idx]
            split = by_id[id(p)]
            state[idx] = entry if split is None else {
                k: fn(v, split, p) if torch.is_tensor(v) and v.ndim == p.ndim else v
                for k, v in entry.items()}
        return {**sd, "state": state}

    @torch.no_grad()
    def _payload(self, extra: Optional[dict]) -> Optional[dict]:
        """The checkpoint's content on the writing rank (None on the
        others); on a mesh every rank takes part in gathering it."""
        st = self.state
        splits = self._split_params()
        grads = ([None if p.grad is None else p.grad for p in self.model.parameters()]
                 if st.accum else None)
        if not self._distributed:
            optimizer = self.optimizer.state_dict()
            model = self.model.state_dict()
        else:
            mesh = self.mesh
            if grads is not None:
                # each rank's partial sum, averaged (a split one over its
                # data line) and gathered whole: adding the local rest and
                # averaging at the update gives the same update
                grads = [None if g is None else
                         mesh.all_reduce(g.detach().clone()) / mesh.size if s is None
                         else gather_tensor(mesh.all_reduce(g.detach().clone(), "data")
                                            / mesh.shape["data"], mesh, s)
                         for g, s in zip(grads, splits)]
            if self.zero_sharding:
                # to each data line's first rank: (0, m) for model index m
                self.optimizer.consolidate_state_dict(to=0)
            if mesh.index("data") != 0:
                return None
            split = placements(self.model)
            model = {k: gather_tensor(v, mesh, split[k]) if k in split else v
                     for k, v in self.model.state_dict().items()}
            optimizer = self._map_optimizer_state(
                self.optimizer.state_dict(),
                lambda v, s, p: gather_tensor(v.to(p.device), mesh, s))
            if not self.writes_checkpoints:
                return None
        payload = {"model": model, "optimizer": optimizer,
                   "step": st.step, "accum": st.accum, "grads": grads,
                   "seed": st.seed, "generator": st.generator.get_state()}
        if extra:
            payload["extra"] = dict(extra)
        return _to_host(payload)

    def save(self, name: str = "best-checkpoint",
             extra: Optional[dict] = None, block: bool = True) -> str:
        """Write a full-state checkpoint to ``<checkpoint_dir>/<name>.pt``.
        The state is copied to host memory before this returns; with
        ``block=False`` the file is written by a background thread, one
        write in flight at a time (``finalize_checkpoints`` waits for it)."""
        path = self._ckpt_path(name)
        self.finalize_checkpoints()
        payload = self._payload(extra)
        if payload is None:
            return path

        def write():
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.tmp"
                torch.save(payload, tmp)
                os.replace(tmp, path)
            except BaseException as e:  # raised again by finalize_checkpoints
                self._write_error.append(e)

        self._writer = threading.Thread(target=write, daemon=True)
        self._writer.start()
        if block:
            self.finalize_checkpoints()
        return path

    def load(self, name: str = "best-checkpoint", with_extra: bool = False):
        """Restore the full state from ``<checkpoint_dir>/<name>.pt``."""
        path = self._ckpt_path(name)
        self.finalize_checkpoints()          # don't read a half-written file
        self._barrier()                      # nor one rank 0 still writes
        if self.state is None:
            self.init_state()
        ck = torch.load(path, map_location="cpu", weights_only=True)
        split = placements(self.model)
        mesh = self.mesh
        block = lambda t, s: model_block(t, mesh, s).contiguous()
        self.model.load_state_dict({k: block(v, split[k]) if k in split else v
                                    for k, v in ck["model"].items()})
        optimizer = ck["optimizer"]
        if split:
            optimizer = self._map_optimizer_state(optimizer,
                                                  lambda v, s, p: block(v, s))
        self.optimizer.load_state_dict(optimizer)
        st = self.state
        st.step, st.accum, st.seed = int(ck["step"]), int(ck["accum"]), int(ck["seed"])
        st.generator.set_state(ck["generator"])
        for p, s, g in zip(self.model.parameters(), self._split_params(),
                           ck["grads"] or itertools.repeat(None)):
            p.grad = (None if g is None else
                      (g if s is None else block(g, s)).to(p.device))
        if with_extra:
            return st, ck.get("extra")
        return st

    def resume(self, name: str = "last-checkpoint") -> int:
        """Restore the full training state from a periodic checkpoint and
        return the epoch to continue from (0 if there is no checkpoint).
        Idiom::

            fitter.init_state()
            start = fitter.resume()
            fitter.fit(data, n_epochs=N, save_last=True, initial_epoch=start)
        """
        self.finalize_checkpoints()
        self._barrier()
        if not os.path.isfile(self._ckpt_path(name)):
            return 0
        if self.state is None:
            raise ValueError(
                "resume() needs the training state: call init_state() "
                "before resume()")
        _, extra = self.load(name, with_extra=True)
        if extra:
            self.best = float(extra.get("best", self.best))
            return int(extra.get("epoch", 0)) + 1
        return 0

    def _barrier(self) -> None:
        if self._distributed:
            dist.barrier()

    # -- training loop ------------------------------------------------------

    def _device_batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _run_eval(self, data: Iterable, max_steps: Optional[int]) -> dict:
        # per-batch means weighted by batch size: a short last batch counts
        # for its samples, not for a whole batch
        agg: dict[str, list] = {}
        sizes: list[int] = []
        for i, batch in enumerate(data):
            if max_steps is not None and i >= max_steps:
                break
            db = self._device_batch(batch)
            sizes.append(int(next(iter(db.values())).shape[0]))
            out = self.steps.eval_step(self.state, db)
            for k, v in out.items():
                agg.setdefault(k, []).append(float(v))
        if not agg:
            raise ValueError(
                "validation data yielded no batches — check batch_size vs "
                "dataset size (drop_remainder loaders silently drop short "
                "final batches)")
        w = np.asarray(sizes, np.float64)
        return {f"val_{k}": float(np.sum(np.asarray(v) * w) / np.sum(w))
                for k, v in agg.items()}

    def _set_bn_track(self, on: bool) -> None:
        for mod in self.model.modules():
            if isinstance(mod, ReAttention):
                mod.bn_track = on

    def fit(
        self,
        train_data,
        val_data=None,
        n_epochs: int = 10,
        steps_per_epoch: Optional[int] = None,
        validation_steps: Optional[int] = None,
        callbacks: Sequence[Callback] = (),
        save_best: bool = True,
        save_last: bool = False,
        initial_epoch: int = 0,
        verbose: bool = True,
    ) -> dict:
        """train_data: an iterable (or a callable returning one) of
        {'x': ..., 'y': ...} batches, numpy or tensors.  Returns the history.

        ``save_last=True`` writes a full-state 'last-checkpoint' every epoch;
        pair with ``initial_epoch=fitter.resume()`` for preemption-safe
        restarts.  A one-shot iterator serves one epoch."""
        if self.state is None:
            self.init_state()
        self.stop_training = False
        for cb in callbacks:
            cb.on_train_begin(self)

        for epoch in range(initial_epoch, n_epochs):
            t0 = time.time()
            for cb in callbacks:
                cb.on_epoch_begin(self, epoch)
            lr_this_epoch = self.learning_rate
            agg: dict[str, list] = {}
            data = train_data() if callable(train_data) else train_data
            warmup = self._frozen_steps is not None and epoch < self.bn_freeze_epochs
            if (self._frozen_steps is not None and self.bn_warmup == "refold"
                    and epoch == self.bn_freeze_epochs):
                data = self._bn_refold_flip(data)
            train_step = (self._frozen_steps if warmup else self.steps).train_step
            self._set_bn_track(warmup and self.bn_warmup == "track")
            # bounded queue: step i's metrics are read back (which waits for
            # the card) once step i + depth has been queued
            pending: deque = deque()
            n_steps = 0
            try:
                for i, batch in enumerate(data):
                    if steps_per_epoch is not None and i >= steps_per_epoch:
                        break
                    self.state, out = train_step(self.state,
                                                 self._device_batch(batch))
                    n_steps += 1
                    pending.append(out)
                    if len(pending) > self.dispatch_depth:
                        for k, v in pending.popleft().items():
                            agg.setdefault(k, []).append(float(v))
            finally:
                self._set_bn_track(False)
            while pending:
                for k, v in pending.popleft().items():
                    agg.setdefault(k, []).append(float(v))
            if n_steps == 0:
                raise ValueError(
                    f"train_data yielded no batches for epoch {epoch} — a "
                    "one-shot iterator is exhausted after its first epoch; "
                    "pass a callable returning a fresh iterable (or a "
                    "re-iterable like DataLoader) for multi-epoch training")
            logs = {k: float(np.mean(v)) for k, v in agg.items()}
            if val_data is not None:
                vd = val_data() if callable(val_data) else val_data
                logs.update(self._run_eval(vd, validation_steps))
            logs["epoch_time_s"] = round(time.time() - t0, 2)
            # the LR this epoch trained with (end-of-epoch callbacks may
            # already have moved the live value for the next epoch)
            logs["lr"] = lr_this_epoch

            monitored = logs.get(self.monitor, logs.get("loss"))
            if save_best and monitored is not None and (
                    monitored < self.best if self.mode == "min"
                    else monitored > self.best):
                self.best = monitored
                self.save(block=False)       # the write overlaps the next epoch
                logs["checkpoint_saved"] = True
            if save_last:
                self.save("last-checkpoint", block=False,
                          extra={"epoch": epoch, "best": float(self.best)})

            for k, v in logs.items():
                self.history.setdefault(k, []).append(v)
            for cb in callbacks:
                cb.on_epoch_end(self, epoch, logs)
            if verbose and self.writes_checkpoints:
                msg = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in logs.items())
                print(f"epoch {epoch + 1}/{n_epochs}: {msg}", flush=True)
            if self.stop_training:
                break

        self.finalize_checkpoints()          # commit any write in flight
        for cb in callbacks:
            cb.on_train_end(self)
        return self.history

    def _bn_refold_flip(self, data):
        """The refold at the frozen -> exact flip (``bn_warmup='refold'``):
        measure each head-mix BatchNorm's input moments on the first
        ``bn_calib_batches`` batches, fold them into its affine and running
        statistics, and clear the optimizer's state (the refolded scales
        change by orders of magnitude, so stale Adam moments would mis-size
        the first updates) and any partly accumulated gradient, keeping the
        live learning rate.  The calibration batches are chained back so the
        flip epoch still trains on them."""
        it = iter(data)
        calib = list(itertools.islice(it, max(1, self.bn_calib_batches)))
        if not calib:
            raise ValueError("bn_warmup='refold' flip: train data yielded "
                             "no batches to calibrate on")
        moments = estimate_bn_moments(
            self.model, [self._device_batch(b) for b in calib])
        if self._distributed:
            # every rank's calibration batches (equal counts a rank)
            for name, pair in moments.items():
                both = self.mesh.all_reduce(
                    torch.stack(pair).to(self.mesh.device)) / self.mesh.size
                moments[name] = tuple(both.cpu().unbind())
        bn_refold(self.model, moments)
        self.optimizer.state.clear()
        getattr(self.optimizer, "optim", self.optimizer).state.clear()
        self.optimizer.zero_grad(set_to_none=True)
        self.state.accum = 0
        return itertools.chain(calib, it)

    def evaluate(self, data, max_steps: Optional[int] = None) -> dict:
        return self._run_eval(data() if callable(data) else data, max_steps)

    @torch.no_grad()
    def predict(self, x) -> torch.Tensor:
        """The model's eval forward (running statistics, no dropout) of
        ``x`` on the fitter's device."""
        return self.model(torch.as_tensor(x).to(self.device),
                          deterministic=True, use_running_average=True)
