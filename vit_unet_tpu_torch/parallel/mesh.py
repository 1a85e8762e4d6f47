"""Process meshes and distributed start-up: the counterpart of
``vit_unet_tpu/parallel/mesh.py`` (:27-106) on ``torch.distributed``.

One process drives one card (or the CPU).  ``initialize_distributed``
starts the process group; ``create_mesh`` lays the ranks out on a
(``data``, ``model``) grid, data-major as JAX lays out its devices, with
one process group per line of each axis.  ``data`` splits the batch (data
parallelism, ``parallel/train_step.py``); ``model`` splits the token axis
of long re-attention levels (sequence parallelism,
``parallel/sequence.py``) and the parameters a partition rule names
(tensor parallelism, ``parallel/partition.py``, applied when the train
steps are built on the mesh); every other parameter is replicated.

Backends: NCCL between cards; gloo when the caller asks for the CPU, and
gloo for CUDA tensors where two ranks share one card (NCCL refuses two
ranks on one device).  gloo has CUDA all_reduce, broadcast and all_gather
but no CUDA reduce_scatter; the collectives here take that into account
(``has_reduce_scatter``).

``use_mesh`` makes a mesh the one the layers see while a step runs (the
counterpart of JAX's ambient mesh): ``ReAttention`` reads it to shard its
tokens and to take its exact-BN moments over every rank that holds part of
the batch.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vit_unet_tpu_torch.utils.device import resolve_device

__all__ = ["initialize_distributed", "default_backend", "create_mesh",
           "create_hybrid_mesh", "hybrid_grid", "Mesh", "BatchSplit",
           "data_sharding", "replicated", "local_device_count",
           "replica_count", "use_mesh", "current_layout", "Layout",
           "has_reduce_scatter", "data_parallel_mesh"]

AXES = ("data", "model")


def default_backend(device: torch.device, ranks_per_card: int = 1) -> str:
    """``gloo`` for the CPU and for ranks that share a card, else ``nccl``."""
    if device.type == "cpu" or ranks_per_card > 1:
        return "gloo"
    return "nccl"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None,
                           backend: Optional[str] = None) -> torch.device:
    """Start the process group; return this rank's device.

    ``num_processes`` defaults to ``VIT_UNET_NUM_PROCESSES`` (as in JAX),
    then torch's ``WORLD_SIZE``, then 1; ``process_id`` to ``RANK``.  With
    one process and no ``backend`` asked for, or a process group already
    started, nothing starts (as in JAX).
    ``coordinator_address`` is ``host:port``; without it torch reads
    ``MASTER_ADDR`` / ``MASTER_PORT``.  ``device`` (default: the card):
    ``cpu``, or ``cuda``, which becomes card ``LOCAL_RANK`` modulo the
    host's cards (``LOCAL_RANK`` defaults to the rank).  ``backend``
    defaults to ``default_backend``, with the ranks on this host taken from
    ``LOCAL_WORLD_SIZE`` (default: all of them).  A backend asked for that
    cannot run raises.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("VIT_UNET_NUM_PROCESSES")
                            or os.environ.get("WORLD_SIZE") or 1)
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return _mesh_device(dev)           # started already, by the caller
    if num_processes <= 1 and backend is None:
        return dev
    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError("initialize_distributed needs process_id (or RANK) "
                             f"for {num_processes} processes")
        process_id = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    ranks_per_card = 1
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if dev.index is None:
            dev = torch.device("cuda", local_rank % cards)
        ranks_per_card = -(-local_world // cards)
    if backend is None:
        backend = default_backend(dev, ranks_per_card)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices")
        if ranks_per_card > 1:
            raise ValueError(f"nccl refuses two ranks on one card: {local_world} "
                             f"ranks on this host, {torch.cuda.device_count()} cards")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no nccl backend")
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return dev


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def has_reduce_scatter(group, device: torch.device) -> bool:
    """Whether the group's backend has a reduce_scatter for tensors on
    ``device`` (gloo has none for CUDA tensors)."""
    return device.type == "cpu" or dist.get_backend(group) != "gloo"


class Mesh:
    """A (data, model) grid of ranks: ``grid[d, m]`` is the rank at data
    index d and model index m.  ``shape`` = {"data": D, "model": M}.
    ``group(axis)`` is the process group of this rank's line along
    ``axis`` (``None``: every rank of the grid), or None in a single
    process."""

    def __init__(self, grid: np.ndarray, device: torch.device):
        self.grid = np.asarray(grid, dtype=np.int64)
        self.device = device
        self.rank, world = _world()
        if self.grid.size != world or sorted(self.grid.ravel()) != list(range(world)):
            raise ValueError(f"the grid {self.grid.tolist()} does not hold the "
                             f"{world} ranks once each")
        (d,), (m,) = np.nonzero(self.grid == self.rank)
        self.coords = {"data": int(d), "model": int(m)}
        self._groups = {}
        if world > 1:
            # every rank makes every group, in the same order
            for name, lines in (("model", self.grid), ("data", self.grid.T)):
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if self.rank in line:
                        self._groups[name] = g
            self._groups[None] = dist.group.WORLD

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.grid.shape))

    @property
    def size(self) -> int:
        return int(self.grid.size)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: Optional[str] = None):
        return self._groups.get(axis)

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Sum ``t`` in place over this rank's line along ``axis`` (None:
        every rank); a no-op on a line of one rank."""
        n = self.size if axis is None else self.shape[axis]
        if n > 1:
            dist.all_reduce(t, group=self.group(axis))
        return t

    def shards(self, axes: Sequence[str]) -> Optional["Shards"]:
        """The ``shards`` object of the kernels (``flash_reattention_train``)
        for a plane split over ``axes``; None when they hold one rank."""
        axes = tuple(a for a in AXES if a in axes)
        size = int(np.prod([self.shape[a] for a in axes])) if axes else 1
        if size <= 1:
            return None
        row_shards = self.shape["model"] if "model" in axes else 1
        if len(axes) == 2:
            return Shards(self, None, size, row_shards)
        return Shards(self, axes[0], size, row_shards)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


@dataclasses.dataclass(frozen=True)
class Shards:
    """Ranks that hold equal parts of one (batch, row) plane: ``size`` of
    them, ``row_shards`` of which split the rows of one batch part."""

    mesh: Mesh
    axis: Optional[str]
    size: int
    row_shards: int

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.mesh.group(self.axis))
        return t


def create_mesh(model_parallel: int = 1, *, device=None) -> Mesh:
    """The (data, model) mesh over every rank, data-major: rank
    d * model_parallel + m sits at (d, m), so a model line is consecutive
    ranks.  ``model_parallel=1`` is pure data parallelism.  In a single
    process it is the 1 x 1 mesh."""
    _, world = _world()
    if world % model_parallel:
        raise ValueError(f"{world} ranks not divisible by "
                         f"model_parallel={model_parallel}")
    grid = np.arange(world).reshape(world // model_parallel, model_parallel)
    return Mesh(grid, _mesh_device(device))


def hybrid_grid(nodes: Sequence, model_parallel: int = 1) -> np.ndarray:
    """The (data, model) grid that keeps each model line on one node:
    ``nodes[r]`` names rank r's node.  Each node's ranks, in rank order,
    fill whole model lines; the data axis runs across nodes (node-major,
    as JAX's hybrid mesh puts slices)."""
    names = list(dict.fromkeys(nodes))          # in order of first rank
    order = sorted(range(len(nodes)), key=lambda r: (names.index(nodes[r]), r))
    per_node = {n: list(nodes).count(n) for n in names}
    bad = {n: c for n, c in per_node.items() if c % model_parallel}
    if bad:
        raise ValueError(f"ranks per node {bad} not divisible by "
                         f"model_parallel={model_parallel}")
    return np.asarray(order).reshape(-1, model_parallel)


def create_hybrid_mesh(model_parallel: int = 1, *, device=None) -> Mesh:
    """The mesh of ``hybrid_grid`` over the ranks' host names, gathered from
    every rank: model lines (whose collectives run every layer) inside one
    node, the data axis (one gradient all-reduce a step) across nodes.  One
    node gives ``create_mesh``'s layout.

    It has run on one host only; ``hybrid_grid`` is checked against a
    mocked topology of several nodes in the tests."""
    _, world = _world()
    nodes = [socket.gethostname()]
    if world > 1:
        nodes = [None] * world
        dist.all_gather_object(nodes, socket.gethostname())
    return Mesh(hybrid_grid(nodes, model_parallel), _mesh_device(device))


def data_parallel_mesh(device=None) -> Mesh:
    """The data-parallel mesh of a process started as one rank per card
    (``torchrun`` sets the environment ``initialize_distributed`` reads), or
    the 1 x 1 mesh of a lone process."""
    return create_mesh(1, device=initialize_distributed(device=device))


def _mesh_device(device) -> torch.device:
    """The rank's device: the card (its current one) unless ``device``
    says otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """How a batch lies on the mesh: split over ``axis`` (each rank of the
    axis holds its equal block of rows) or, with ``axis`` None,
    replicated."""

    mesh: Mesh
    axis: Optional[str]

    def local(self, batch: dict) -> dict:
        """This rank's rows of a whole batch (every rank holds all of it)."""
        if self.axis is None:
            return batch
        n, i = self.mesh.shape[self.axis], self.mesh.index(self.axis)
        out = {}
        for key, t in batch.items():
            if t.shape[0] % n:
                raise ValueError(f"batch of {t.shape[0]} does not split over "
                                 f"{n} ranks of {self.axis!r}")
            per = t.shape[0] // n
            out[key] = t[i * per:(i + 1) * per]
        return out


def data_sharding(mesh: Mesh) -> BatchSplit:
    """The batch split over the data axis."""
    return BatchSplit(mesh, "data")


def replicated(mesh: Mesh) -> BatchSplit:
    """The batch whole on every rank."""
    return BatchSplit(mesh, None)


def local_device_count() -> int:
    """Cards on this host (1 on a host without one: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def replica_count(mesh: Mesh) -> int:
    """Data-parallel replicas (the reference's REPLICAS, for its
    ``lr * REPLICAS`` convention)."""
    return mesh.shape["data"]


@dataclasses.dataclass(frozen=True)
class Layout:
    """The mesh a step runs on, and whether its batch is split over the
    data axis (else every rank holds the whole batch)."""

    mesh: Mesh
    batch_split: bool


_LAYOUT: contextvars.ContextVar = contextvars.ContextVar("vit_unet_layout",
                                                         default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh, batch_split: bool = True):
    """Make ``mesh`` the layers' mesh inside the block (forward and
    backward both run inside it, so a recomputation sees it too)."""
    token = _LAYOUT.set(Layout(mesh, batch_split))
    try:
        yield
    finally:
        _LAYOUT.reset(token)


def current_layout() -> Optional[Layout]:
    return _LAYOUT.get()
