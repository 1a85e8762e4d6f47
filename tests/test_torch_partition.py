"""The port's partition rules (``vit_unet_tpu_torch/parallel/partition.py``)
against the JAX package's, on the CPU: for every parameter of tiny
ViTUNet, HViTUNetTF (keras heads, re-attention and conv resampling) and
ViTClassifier, the port's placement of the torch tensor is JAX's
``spec_for_path`` of the flax path, read through the transpose
``utils/jax_import.py`` applies; and ``shard_tree``'s slices are JAX
``shard_tree``'s addressable shards on a 2-device CPU mesh, converted the
same way.  The shapes come from ``jax.eval_shape``; nothing is trained.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.conftest import cpu_devices
from tests.test_torch_classifier import SMALL as CLS_SMALL
from tests.test_torch_model import TINY, one_torch_thread  # noqa: F401
from tests.test_torch_tf_model import SMALL as TF_SMALL
from vit_unet_tpu.models import hvit_unet_tf as JTF
from vit_unet_tpu.models import vit_classifier as JVC
from vit_unet_tpu.models import vit_unet as JM
from vit_unet_tpu.parallel import partition as JP
from vit_unet_tpu_torch.models import hvit_unet_tf as TTF
from vit_unet_tpu_torch.models import vit_classifier as TVC
from vit_unet_tpu_torch.models import vit_unet as TM
from vit_unet_tpu_torch.parallel import partition as PP
from vit_unet_tpu_torch.utils.jax_import import flax_to_state_dict

FAMILIES = {
    "vit_unet": (lambda: JM.ViTUNet(JM.ViTUNetConfig(**TINY)),
                 lambda: TM.ViTUNet(TM.ViTUNetConfig(**TINY)), (1, 3, 64, 64)),
    "hvit_tf": (lambda: JTF.HViTUNetTF(JTF.HViTUNetTFConfig(**TF_SMALL)),
                lambda: TTF.HViTUNetTF(TTF.HViTUNetTFConfig(**TF_SMALL)),
                (1, 32, 32, 3)),
    "hvit_tf_reattention_conv": (
        lambda: JTF.HViTUNetTF(JTF.HViTUNetTFConfig(
            **TF_SMALL, original_attn=False, resampling_type="conv")),
        lambda: TTF.HViTUNetTF(TTF.HViTUNetTFConfig(
            **TF_SMALL, original_attn=False, resampling_type="conv")),
        (1, 32, 32, 3)),
    "classifier": (lambda: JVC.ViTClassifier(JVC.ViTClassifierConfig(**CLS_SMALL)),
                   lambda: TVC.ViTClassifier(TVC.ViTClassifierConfig(**CLS_SMALL)),
                   (1, 3, 32, 32)),
}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _one(path, arr):
    """The torch (name, tensor) of one flax parameter leaf."""
    tree = node = {}
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = arr
    ((name, t),) = flax_to_state_dict({"params": tree}).items()
    return name, t


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(flax parameter shapes by path, the port's model)."""
    make_jax, make_torch, shape = FAMILIES[request.param]
    shapes = jax.eval_shape(lambda: make_jax().init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros(shape)))["params"]
    return dict(_leaves(jax.tree.map(lambda s: s.shape, shapes,
                                     is_leaf=lambda s: hasattr(s, "shape")))), make_torch()


def _fake_mesh(model: int, index: int):
    """What ``shard_tree`` reads of a mesh, without a process group."""
    return types.SimpleNamespace(shape={"data": 1, "model": model},
                                 index=lambda axis: {"data": 0, "model": index}[axis])


def test_placements_are_jax_rules_transposed(family):
    """Mark each flax element with its block index along JAX's model axis
    (2 blocks), carry the marks through the port's transpose, and read them
    back along the port's split dimension."""
    shapes, model = family
    port_names = set(dict(model.named_parameters()))
    seen = set()
    for path, shape in shapes.items():
        spec = JP.spec_for_path("/".join(path))
        marks = np.zeros(shape, np.float32)
        axis = next((i for i, s in enumerate(spec) if s == "model"), None)
        if axis is not None:
            idx = [slice(None)] * len(shape)
            idx[axis] = slice(shape[axis] // 2, None)
            marks[tuple(idx)] = 1.0
        name, t = _one(path, marks)
        seen.add(name)
        split = PP.spec_for_path(name)
        if axis is None:
            assert split is None, (name, split)
            continue
        assert split is not None, name
        assert split.heads == (len(shape) == 3 or path[-2] in ("query", "key", "value")), name
        for i, block in enumerate(t.chunk(2, split.dim)):
            assert torch.all(block == i), (name, split)
    assert seen == port_names


def test_shard_tree_is_jax_shards(family):
    """Each rank's slice of ``shard_tree`` is the flax shard of JAX's
    ``shard_tree`` on the device of that model index, converted."""
    shapes, model = family
    rng = np.random.default_rng(0)
    flat = {path: rng.standard_normal(shape).astype(np.float32)
            for path, shape in shapes.items()}
    tree = {}
    for path, arr in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(arr)
    jmesh = JMesh(np.asarray(cpu_devices(2)).reshape(1, 2), ("data", "model"))
    sharded = JP.shard_tree(tree, jmesh)
    whole = dict(_one(path, arr) for path, arr in flat.items())
    heads = PP.head_counts(model)
    for m, device in enumerate(jmesh.devices.ravel()):
        local = PP.shard_tree(whole, _fake_mesh(2, m), heads=heads)
        for path, arr in _leaves(sharded):
            shard = next(s.data for s in arr.addressable_shards if s.device == device)
            name, want = _one(path, np.asarray(shard))
            np.testing.assert_array_equal(local[name].numpy(), want.numpy(), err_msg=name)


def test_undivided_dimensions_stay_replicated():
    """A model axis that does not divide a dimension (or a head count)
    leaves it whole on every rank; JAX raises there."""
    tree = {"a.FeedForward.fc1.weight": torch.zeros(6, 4),
            "a.FeedForward.fc2.weight": torch.zeros(4, 6),
            "b.query.weight": torch.zeros(12, 4),
            "PE.position_embedding.weight": torch.zeros(8, 3)}
    specs = PP.sharding_tree(tree, _fake_mesh(4, 1), heads={"b": 2})
    assert specs == {"a.FeedForward.fc1.weight": None,
                     "a.FeedForward.fc2.weight": None,
                     "b.query.weight": None,          # 12 rows, but 2 heads
                     "PE.position_embedding.weight": PP.Split(0)}
    local = PP.shard_tree(tree, _fake_mesh(4, 1), heads={"b": 2})
    assert local["a.FeedForward.fc1.weight"] is tree["a.FeedForward.fc1.weight"]
    assert local["PE.position_embedding.weight"].shape == (2, 3)
    jmesh = JMesh(np.asarray(cpu_devices(4)).reshape(1, 4), ("data", "model"))
    with pytest.raises(ValueError, match="divisible"):
        jax.device_put(jnp.zeros((4, 6)), NamedSharding(jmesh, P(None, "model")))
