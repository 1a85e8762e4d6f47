"""Tensor parallelism over the mesh's ``model`` axis: the counterpart of
``vit_unet_tpu/parallel/partition.py`` (its rules and public names), and
the collectives of the layers' split forms.

Rules map a parameter's dotted ``state_dict`` name (the port's names mirror
flax's paths: ``Encoders.0.FeedForward.fc1.weight`` is
``Encoders_0/FeedForward/fc1/kernel``) to a placement: which dimension of
the *torch* tensor is split over ``model``, or None (replicated).
``nn.Linear.weight`` is (out, in) where flax's kernel is (in, out), and the
keras projections are flat ``nn.Linear``s over heads x key_dim, so the JAX
specs read transposed (as ``utils/jax_import.py::_weight`` transposes):

* FeedForward: fc1 column-parallel (weight and bias dim 0), fc2
  row-parallel (weight dim 1; its bias replicated, added once after the
  all-reduce);
* the re-attention output projection ``proj``: column-parallel (dim 0),
  its output all-gathered over features;
* the keras projections: ``query`` / ``key`` / ``value`` weight and bias
  dim 0 and ``out.weight`` dim 1, in whole-head blocks: each rank projects
  and attends to its own heads only;
* ``position_embedding``: its tokens (dim 0), all-gathered before the add.

``shard_module`` splits a model's parameters in place (the train step does
it when it is built on a mesh whose ``model`` axis holds more than one
rank) and hands each layer that owns a split parameter the mesh
(``tp_mesh``): from then on the layer runs its split form
(``nn/feedforward.py``, ``nn/reattention.py``, ``nn/mha.py``,
``nn/patch_encoder.py``, ``nn/resampling.py``), whose collectives are
``copy_to_model`` / ``reduce_from_model`` / ``gather_from_model`` here.
The layers around them run alike on the ranks of a model line (the same
batch, the same generator), so a split layer's output is whole and alike
again on every rank of the line, and so is the cotangent that reaches it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from vit_unet_tpu_torch.parallel.mesh import Mesh
from vit_unet_tpu_torch.parallel.sequence import sum_grad_over_line, unshard_tokens

__all__ = ["Split", "DEFAULT_RULES", "FALLBACK", "spec_for_path",
           "partition_specs", "sharding_tree", "shard_tree", "gather_tensor",
           "head_counts", "shard_module", "placements", "copy_to_model",
           "reduce_from_model", "gather_from_model", "model_block"]


@dataclasses.dataclass(frozen=True)
class Split:
    """Dimension ``dim`` of a torch tensor split over ``model`` in equal
    contiguous blocks; ``heads``: the dimension is heads x key_dim and
    splits in whole heads (so the head count must divide, not only the
    dimension)."""

    dim: int
    heads: bool = False


# (regex on the dotted parameter name, placement): first match wins.  Each
# is JAX's rule of the same row, transposed to the torch layout.
DEFAULT_RULES: list[tuple[str, Split]] = [
    # FeedForward: column-parallel fc1, row-parallel fc2
    (r".*FeedForward\.fc1\.weight$", Split(0)),      # P(None, "model")
    (r".*FeedForward\.fc1\.bias$", Split(0)),        # P("model")
    (r".*FeedForward\.fc2\.weight$", Split(1)),      # P("model", None)
    # attention output projection: column-parallel
    (r".*\.proj\.weight$", Split(0)),                # P(None, "model")
    (r".*\.proj\.bias$", Split(0)),                  # P("model")
    # keras-MHA projections (TF flavour): shard the heads axis
    (r".*(query|key|value)\.weight$", Split(0, heads=True)),  # P(None, "model", None)
    (r".*(query|key|value)\.bias$", Split(0, heads=True)),    # P("model", None)
    (r".*out\.weight$", Split(1, heads=True)),       # P("model", None, None)
    # position embeddings can be large at fine levels: shard tokens
    (r".*position_embedding\.weight$", Split(0)),    # P("model", None)
]

FALLBACK: Optional[Split] = None  # replicate


def spec_for_path(path: str, rules=None) -> Optional[Split]:
    """The placement of the parameter named ``path`` (None: replicated)."""
    for pattern, spec in (rules or DEFAULT_RULES):
        if re.match(pattern, path):
            return spec
    return FALLBACK


def partition_specs(tree: Mapping[str, torch.Tensor], rules=None) -> dict:
    """{name: placement} for a ``state_dict``-like mapping, by the rules
    alone (whatever the mesh)."""
    return {name: spec_for_path(name, rules) for name in tree}


def _divides(split: Split, shape, size: int, heads: Optional[int]) -> bool:
    """Whether ``size`` ranks split ``shape`` as ``split`` says.  A
    dimension (or head count) that ``size`` does not divide stays
    replicated; JAX raises there instead (``device_put`` and ``jit`` take
    no uneven sharding: "should be divisible"), and pads nothing."""
    if split.dim >= len(shape):
        return False
    n = heads if split.heads and heads is not None else shape[split.dim]
    return n % size == 0 and n >= size


def _owner(name: str) -> str:
    """The layer a parameter belongs to: the parent of its Linear or
    Embedding (``a.FeedForward.fc1.weight`` -> ``a.FeedForward``)."""
    return name.rsplit(".", 2)[0] if name.count(".") >= 2 else ""


def head_counts(model: nn.Module) -> dict:
    """{layer name: head count} of the layers with keras head projections,
    for the placements whose blocks are whole heads."""
    return {name: mod.num_heads for name, mod in model.named_modules()
            if hasattr(mod, "num_heads") and hasattr(mod, "query")}


def sharding_tree(tree: Mapping[str, torch.Tensor], mesh: Mesh, rules=None,
                  heads: Optional[Mapping[str, int]] = None) -> dict:
    """{name: placement} that apply on ``mesh``: the rules' placements
    where the ``model`` axis divides the dimension (``heads``, from
    ``head_counts``: by whole heads), else None."""
    size = mesh.shape["model"]
    out = {}
    for name, t in tree.items():
        split = spec_for_path(name, rules)
        if size > 1 and split is not None and _divides(
                split, t.shape, size, (heads or {}).get(_owner(name))):
            out[name] = split
        else:
            out[name] = None
    return out


def model_block(t: torch.Tensor, mesh: Mesh, split: Split) -> torch.Tensor:
    """This rank's block of a whole tensor (a view)."""
    return t.chunk(mesh.shape["model"], split.dim)[mesh.index("model")]


def shard_tree(tree: Mapping[str, torch.Tensor], mesh: Mesh, rules=None,
               heads: Optional[Mapping[str, int]] = None) -> dict:
    """Each rank's own slice of the whole tensors of ``tree`` (the whole
    tensor where it stays replicated), as contiguous copies."""
    specs = sharding_tree(tree, mesh, rules, heads)
    return {name: (t if specs[name] is None
                   else model_block(t, mesh, specs[name]).contiguous().clone())
            for name, t in tree.items()}


def gather_tensor(t: torch.Tensor, mesh: Mesh, split: Split,
                  group_axis: str = "model") -> torch.Tensor:
    """The whole tensor from every rank's block along the model line (no
    gradient; every rank of the line takes part)."""
    parts = [torch.empty_like(t) for _ in range(mesh.shape[group_axis])]
    dist.all_gather(parts, t.contiguous(), group=mesh.group(group_axis))
    return torch.cat(parts, split.dim)


def placements(model: nn.Module) -> dict:
    """{parameter name: Split} of the parameters ``shard_module`` split
    (empty for a whole model)."""
    return getattr(model, "_tp_placements", {})


@torch.no_grad()
def shard_module(model: nn.Module, mesh: Mesh, rules=None) -> dict:
    """Split ``model``'s parameters over ``mesh``'s ``model`` axis in place:
    each keeps its ``Parameter`` object (an optimizer made before keeps
    it) with this rank's block as its data.  Each layer that owns a split
    parameter gets ``tp_mesh`` and runs its split form; a layer that has
    none raises.  Returns the placements; a model split already comes back
    as it is."""
    done = placements(model)
    if done:
        if getattr(model, "_tp_mesh", None) is not mesh:
            raise ValueError("the model is split over another mesh already")
        return done
    params = dict(model.named_parameters())
    specs = {k: s for k, s in sharding_tree(params, mesh, rules,
                                            head_counts(model)).items()
             if s is not None}
    layers = dict(model.named_modules())
    for name in specs:
        layer = layers[_owner(name)]
        if not hasattr(type(layer), "tp_mesh"):
            raise ValueError(f"{type(layer).__name__} ({_owner(name)!r}) has no "
                             f"split form for {name!r}")
        layer.tp_mesh = mesh
    for name, split in specs.items():
        p = params[name]
        p.data = model_block(p.data, mesh, split).contiguous().clone()
    model._tp_placements = specs
    model._tp_mesh = mesh
    return specs


# --- the split forms' collectives ------------------------------------------------

def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a column-parallel layer: the identity; its backward
    sums the ranks' partial cotangents over the model line."""
    return sum_grad_over_line(x, mesh, "model")


class _ReduceFromModel(torch.autograd.Function):
    """Partial sums -> their sum over the model line (alike on every rank);
    backward: the (alike) cotangent as it is, each rank's partial feeding
    the sum once."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=mesh.group("model"))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The output of a row-parallel layer, summed over the model line."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``dim`` gathered into the whole tensor, alike on
    the line.  Its backward is this rank's block of the cotangent: the
    layers after it run alike on the line, so the cotangent is whole and
    alike on every rank already, and a reduce-scatter (the sequence-
    parallel K/V gather's backward, where each rank's query rows give a
    part) would count it once per rank."""
    return unshard_tokens(x, mesh, "model", dim)
