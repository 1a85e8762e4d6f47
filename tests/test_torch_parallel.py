"""The port's multi-process paths against the JAX package's, float32 on the
CPU: meshes, sequence parallelism (eval, and training in the frozen,
exact-BN and tracking modes, with and without a data axis), ViTUNet with
``sequence_parallel`` and its parameters split over ``model`` (tensor
parallelism: each rank's blocks against JAX's mesh step, which applies
the same rules), the data-parallel step, ZeRO-1 (also over a split
model), the ``Fitter`` with checkpoint and resume (also across meshes),
and both CLIs' ``--data_parallel``.

The parent computes the JAX side here, on conftest's 8-device CPU mesh,
and hands numpy inputs to torch-only worker processes
(``tests/_torch_parallel_worker.py``): one world of 2 ranks and one of 4,
over gloo, started together, each serving every check of its world.  The
JAX side runs its plain (XLA) path; the port both its kernel branch (the
kernels' plain versions on CPU tensors) and its plain N x N body.

The dropout mask (drawn on the seed tensor's device, with no host
synchronisation) is held bit for bit against the form that searched the
Philox groups with ``torch.unique``.
"""
import os
import pickle
import re
import socket
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tests.conftest import cpu_devices
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_train import STEP_CFG
from vit_unet_tpu.models import vit_unet as JM
from vit_unet_tpu.parallel import mesh as JPM
from vit_unet_tpu.parallel import sequence as JPS
from vit_unet_tpu.parallel import train_step as JS
from vit_unet_tpu.train import losses as JL
from vit_unet_tpu.utils.torch_import import import_torch_state_dict
from vit_unet_tpu_torch.kernels import flash_reattention_train as TT
from vit_unet_tpu_torch.models import vit_unet as TM
from vit_unet_tpu_torch.parallel import mesh as PM
from vit_unet_tpu_torch.utils.jax_import import flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_MIN_TOKENS = 64          # TINY's levels: 16, 64 and 256 tokens
B, H, N, DH = 2, 4, 64, 8   # the functions' inputs
WORLDS = (2, 4)


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _function_inputs():
    rng = np.random.default_rng(7)
    f = lambda s, *shape: (rng.standard_normal(shape) * s).astype(np.float32)
    q, k, v = f(1.5, B, H, N, DH), f(1.5, B, H, N, DH), f(1.0, B, H, N, DH)
    mix = f(0.3, H, H)                          # flax [h_in, h_out]
    out = dict(q=q, k=k, v=v, mix=mix, conv_m=np.ascontiguousarray(mix.T),
               conv_c=f(0.1, H), gamma=(1 + f(0.3, H)).astype(np.float32),
               beta=f(0.2, H), m_eff=f(0.3, H, H), c_eff=f(0.1, H),
               rm=f(0.05, H), rv=(1 + f(0.2, H) ** 2).astype(np.float32))
    return out


def _weights():
    """The model's weights as a torch state_dict in numpy (the JAX side
    takes them through ``import_torch_state_dict``), with random head-mix
    BatchNorm statistics and affine, so that every fold is exercised."""
    model = TM.ViTUNet(TM.ViTUNetConfig(**STEP_CFG)).init_weights(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    for key, val in state.items():
        if "var_norm" not in key or key.endswith("num_batches_tracked"):
            continue
        draw = {"running_mean": lambda: rng.normal(0, 0.5, val.shape),
                "running_var": lambda: rng.uniform(0.5, 2.0, val.shape),
                "weight": lambda: rng.uniform(0.5, 1.5, val.shape),
                "bias": lambda: rng.normal(0, 0.3, val.shape)}[key.rsplit(".", 1)[1]]
        state[key] = draw().astype(np.float32)
    return state


def _folders(root):
    rng = np.random.default_rng(0)
    pairs, classes = os.path.join(root, "pairs"), os.path.join(root, "classes")
    for d in ("clean", "noisy"):
        os.makedirs(os.path.join(pairs, d))
    for i in range(8):
        img = (np.cumsum(rng.integers(0, 12, (72, 80, 3)), axis=0) % 256).astype(np.uint8)
        cv2.imwrite(os.path.join(pairs, "clean", f"{i:03d}.png"), img)
        noisy = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(pairs, "noisy", f"{i:03d}.png"), noisy)
    for c in range(4):
        os.makedirs(os.path.join(classes, f"c{c}"))
        for i in range(5):
            img = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)
            cv2.imwrite(os.path.join(classes, f"c{c}", f"{i}.png"), img)
    return dict(pairs=pairs, classes=classes)


def _jax_mesh(data, model):
    return JMesh(np.asarray(cpu_devices(data * model)).reshape(data, model),
                 ("data", "model"))


def _jax_functions(f):
    """JAX's sequence-parallel functions (XLA bodies) on 1 x 2 and 2 x 2."""
    J = {k: jnp.asarray(v) for k, v in f.items()}
    want = {"eval": np.asarray(JPS.sequence_parallel_reattention(
        J["q"], J["k"], J["v"], J["m_eff"], J["c_eff"], _jax_mesh(1, 2)))}
    params = (J["mix"], J["conv_c"], J["gamma"], J["beta"])
    for world, data in ((2, 1), (4, 2)):
        mesh = _jax_mesh(data, 2)
        for mode in ("frozen", "exact", "track"):
            running = None if mode == "exact" else (J["rm"], J["rv"])

            def run(q, k, v, *p):
                return JPS.sequence_parallel_reattention_train(
                    q, k, v, *p, mesh, rate=0.0, running_stats=running,
                    track_stats=mode == "track")

            def loss(*a):
                o, mu, var = run(*a)
                return jnp.sum(o * jnp.cos(o)) + jnp.sum(mu) + jnp.sum(var)

            args = (J["q"], J["k"], J["v"], *params)
            o, mu, var = jax.jit(run)(*args)
            grads = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*args)
            grads = [np.asarray(g) for g in grads]
            grads[3] = grads[3].T                 # flax [in, out] -> [out, in]
            want[(world, mode)] = dict(out=np.asarray(o), mu=np.asarray(mu),
                                       var=np.asarray(var), grads=grads)
    return want


def _jax_model(variables, batch):
    """The JAX model's loss, gradients and BatchNorm updates of the whole
    batch in training mode and its eval forward, sequence-parallel on
    2 x 2, and one step of the unsharded model on the 4 x 1 DP mesh (AdamW
    1e-4).  The sequence-parallel model computes the unsharded function,
    so its gradients stand for the DP step's too."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    sp = JM.ViTUNet(JM.ViTUNetConfig(**STEP_CFG, use_flash=False,
                                     sequence_parallel=True,
                                     sp_min_tokens=SP_MIN_TOKENS),
                    mesh=JPM.create_mesh(model_parallel=2, devices=cpu_devices(4)))

    def loss(params):
        pred, upd = sp.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             jb["x"], deterministic=False,
                             use_running_average=False,
                             rngs={"dropout": jax.random.key(0)},
                             mutable=["batch_stats"])
        return JL.mse(pred, jb["y"]), upd

    (value, upd), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    named = lambda tree: {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}
    want = {"sp": dict(
        loss=float(value),
        grads={k: v.numpy() for k, v in flax_to_state_dict({"params": grads}).items()},
        stats={k: v.numpy() for k, v in flax_to_state_dict(
            {"batch_stats": upd["batch_stats"]}).items()},
        eval=np.asarray(jax.jit(lambda v, x: sp.apply(
            v, x, deterministic=True, use_running_average=True))(variables, jb["x"])))}
    tx = optax.adamw(1e-4)
    state = JS.TrainState.create(params=variables["params"], tx=tx,
                                 batch_stats=variables["batch_stats"])
    steps = JS.build_step_functions(JM.ViTUNet(JM.ViTUNetConfig(**STEP_CFG, use_flash=False)),
                                    tx, JL.mse,
                                    mesh=JPM.create_mesh(1, devices=cpu_devices(4)),
                                    donate=False)
    state, m = steps.train_step(state, jb)
    want["step"] = dict(loss=float(m["loss"]), state={
        k: v.numpy() for k, v in flax_to_state_dict(
            {"params": state.params, "batch_stats": state.batch_stats}).items()})
    # the sequence-parallel model's mesh step on 2 x 2: the partition rules
    # split its parameters and moments over 'model'
    state = JS.TrainState.create(params=variables["params"], tx=tx,
                                 batch_stats=variables["batch_stats"])
    steps = JS.build_step_functions(sp, tx, JL.mse, mesh=sp.mesh, donate=False)
    state, _ = steps.train_step(state, jb)
    adam = state.opt_state[0]
    want["tp_step"] = dict(
        state=named({"params": state.params, "batch_stats": state.batch_stats}),
        mu=named({"params": adam.mu}), nu=named({"params": adam.nu}))
    return want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results by rank, and the JAX expectations."""
    root = tmp_path_factory.mktemp("parallel")
    weights = _weights()
    x = np.random.default_rng(21).standard_normal((4, 3, 64, 64)).astype(np.float32)
    batch = {"x": x, "y": (0.9 * x).astype(np.float32)}
    f = _function_inputs()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH", "RANK", "WORLD_SIZE",
                        "VIT_UNET_NUM_PROCESSES", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = REPO
    procs = {}
    for world in WORLDS:
        d = root / f"world{world}"
        d.mkdir()
        with open(d / "inputs.pkl", "wb") as fh:
            pickle.dump(dict(sp=f, weights=weights, batch=batch, cfg=STEP_CFG,
                             sp_min_tokens=SP_MIN_TOKENS,
                             cli=_folders(str(d / "data"))), fh)
        port = str(_port())
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_torch_parallel_worker.py"),
             str(r), str(world), port, str(d)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
    # the JAX side while the worlds run
    variables = jax.tree.map(jnp.asarray, import_torch_state_dict(weights))
    want = dict(functions=_jax_functions(f), model=_jax_model(variables, batch),
                inputs=f, batch=batch)
    results = {}
    for world, ps in procs.items():
        outs = [p.communicate(timeout=600) for p in ps]
        ranks = []
        for r, (p, (_, err)) in enumerate(zip(ps, outs)):
            with open(root / f"world{world}" / f"rank{r}.pkl", "rb") as fh:
                res = pickle.load(fh)
            assert p.returncode == 0 and "error" not in res, (
                res.get("error", "") + err[-3000:])
            ranks.append(res)
        results[world] = ranks
    return results, want


def _close(got, want, tol, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol,
                               err_msg=what)


def _by_data(ranks, world, key_fn):
    """A whole-batch array from the data parts, read on model index 0."""
    parts = [key_fn(r) for r in ranks if r["meshes"]["sp_coords"]["model"] == 0]
    return np.concatenate(parts)


# --- meshes -------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_meshes_lay_ranks_out_data_major(worlds, world):
    ranks = worlds[0][world]
    for r, res in enumerate(ranks):
        m = res["meshes"]
        assert m["sp"] == {"data": world // 2, "model": 2}
        assert m["dp"] == {"data": world, "model": 1}
        assert m["sp_coords"] == {"data": r // 2, "model": r % 2}
        assert m["sp_grid"] == np.arange(world).reshape(-1, 2).tolist()
        assert m["hybrid"] == m["sp_grid"]          # one host
        assert m["local"] == [4 * r + i for i in range(4)]


def test_hybrid_grid_keeps_model_lines_on_a_node():
    """The mocked topology of ``tests/test_parallel.py:186``: two nodes of
    four ranks, ranks interleaved across them."""
    nodes = ["a", "b", "a", "b", "a", "b", "a", "b"]
    grid = PM.hybrid_grid(nodes, 2)
    assert grid.shape == (4, 2)
    for row in grid:
        assert len({nodes[r] for r in row}) == 1
    assert len({nodes[r] for r in grid[:, 0]}) == 2
    assert sorted(grid.ravel().tolist()) == list(range(8))
    assert grid.tolist() == [[0, 2], [4, 6], [1, 3], [5, 7]]
    with pytest.raises(ValueError, match="not divisible"):
        PM.hybrid_grid(nodes, 3)
    assert PM.hybrid_grid(["h"] * 4, 2).tolist() == [[0, 1], [2, 3]]


def test_initialize_distributed_env_and_args(monkeypatch):
    calls = []
    monkeypatch.setattr(PM.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(PM.dist, "is_initialized", lambda: False)
    for key in ("VIT_UNET_NUM_PROCESSES", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert PM.initialize_distributed(device="cpu") == torch.device("cpu")
    PM.initialize_distributed(num_processes=1, device="cpu")
    assert calls == []
    PM.initialize_distributed("host0:1234", num_processes=4, process_id=2, device="cpu")
    assert calls == [("gloo", dict(init_method="tcp://host0:1234", world_size=4, rank=2))]
    calls.clear()
    monkeypatch.setenv("VIT_UNET_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="RANK"):
        PM.initialize_distributed(device="cpu")
    monkeypatch.setenv("RANK", "1")
    PM.initialize_distributed(device="cpu")
    assert calls == [("gloo", dict(init_method="env://", world_size=2, rank=1))]
    with pytest.raises(ValueError, match="nccl"):
        PM.initialize_distributed(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        PM.initialize_distributed(device="cpu", backend="mpi")
    # one process asking for a backend starts a world of one
    calls.clear()
    PM.initialize_distributed(num_processes=1, process_id=0, device="cpu", backend="gloo")
    assert calls == [("gloo", dict(init_method="env://", world_size=1, rank=0))]
    assert PM.default_backend(torch.device("cuda", 0)) == "nccl"
    assert PM.default_backend(torch.device("cuda", 0), ranks_per_card=2) == "gloo"
    assert PM.default_backend(torch.device("cpu")) == "gloo"


def test_lone_process_mesh():
    mesh = PM.create_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and PM.replica_count(mesh) == 1
    assert mesh.shards(("data", "model")) is None
    t = torch.ones(3)
    assert mesh.all_reduce(t) is t and torch.equal(t, torch.ones(3))
    batch = {"x": torch.arange(6)}
    assert PM.replicated(mesh).local(batch) is batch
    assert torch.equal(PM.data_sharding(mesh).local(batch)["x"], batch["x"])
    assert PM.local_device_count() >= 1
    with pytest.raises(ValueError, match="divisible"):
        PM.create_mesh(2, device="cpu")


# --- the dropout mask ---------------------------------------------------------

def _unique_form_bits(seed, b, h, rows, cols):
    """The former ``dropout_bits``: the Philox groups by ``torch.unique``
    (which synchronises the host on the card)."""
    groups = torch.unique((cols >> 6) * 16 + (cols & 15))
    words = torch.stack(TT.philox4(int(seed), b[:, None, None, None],
                                   h[None, :, None, None], rows[None, None, :, None],
                                   groups[None, None, None, :]), dim=-1)
    slot = torch.searchsorted(groups, (cols >> 6) * 16 + (cols & 15))
    return words.flatten(-2)[..., slot * 4 + ((cols >> 4) & 3)]


@pytest.mark.parametrize("shape", [(2, 3, 5, 1), (1, 2, 7, 17), (2, 2, 9, 63),
                                   (1, 1, 4, 64), (1, 2, 3, 65), (1, 1, 2, 79),
                                   (1, 1, 3, 80), (1, 2, 5, 130), (2, 1, 3, 300)])
def test_dropout_mask_is_the_unique_form_bit_for_bit(shape):
    b, h, nq, nk = shape
    ar = lambda n: torch.arange(n, dtype=torch.int64)
    for seed in (0, 77, 2 ** 61 + 12345):
        want_bits = _unique_form_bits(seed, ar(b), ar(h), ar(nq), ar(nk))
        for s in (seed, torch.tensor([seed])):
            assert torch.equal(TT.dropout_bits(s, ar(b), ar(h), ar(nq), nk), want_bits)
            keep = (want_bits >> 8) >= TT.keep_threshold(0.2)
            want = torch.where(keep, TT._keep_scale(0.2), 0.0)
            assert torch.equal(TT.dropout_mask(s, 0.2, b, h, nq, nk), want)
        cols = torch.tensor([5, 200, 64, 3, 79])
        assert torch.equal(TT.dropout_bits(seed, ar(b), ar(h), ar(nq), 201)[..., cols],
                           _unique_form_bits(seed, ar(b), ar(h), ar(nq), cols))


# --- sequence parallelism -----------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_reattention_matches_jax(worlds, world):
    results, want = worlds
    for flash in (True, False):
        got = _by_data(results[world], world, lambda r: r["sp_eval"][flash])
        _close(got, want["functions"]["eval"], 1e-5, f"flash={flash}")


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("mode", ["frozen", "exact", "track"])
@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_train_matches_jax(worlds, world, mode, flash):
    """Forward, moments and every gradient (a loss on the moments too) of
    each mode, without (world 2: 1 x 2) and with a data axis (world 4:
    2 x 2), against JAX's shard body on the same mesh."""
    results, want = worlds
    w = want["functions"][(world, mode)]
    ranks = results[world]
    key = f"sp_train/{mode}/{flash}"
    _close(_by_data(ranks, world, lambda r: r[key]["out"]), w["out"], 1e-4, "out")
    for r in ranks:                          # the moments: alike on every rank
        _close(r[key]["mu"], w["mu"], 1e-5, "mu")
        _close(r[key]["var"], w["var"], 1e-5, "var")
        # the parameters against the largest of their gradients: under exact
        # BN conv_c's gradient is the moments' term alone, and the XLA body
        # holds it only to rounding of the output's (cancelling) terms
        gmax = max(np.abs(g).max() for g in w["grads"][3:])
        for i, name in zip(range(3, 7), ("conv_m", "conv_c", "gamma", "beta")):
            np.testing.assert_allclose(r[key]["grads"][i], w["grads"][i], rtol=1e-4,
                                       atol=1e-4 * gmax, err_msg=name)
    # exact BN's activation gradients carry the XLA body's f32 cancellation
    # in E[c^2] - E[c]^2 (5e-4, as test_train_step_matches_jax holds the
    # kernel path's gradients)
    tol = 5e-4 if mode == "exact" else 1e-4
    for i, name in enumerate("qkv"):
        _close(_by_data(ranks, world, lambda r: r[key]["grads"][i]),
               w["grads"][i], tol, f"d{name}")


@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_dropout_strides_the_seed(worlds, world):
    for res in worlds[0][world]:
        d = res["sp_dropout"]
        assert d["frozen_vs_nxn"] <= 1e-5, d
        assert d["frozen_bodies"] <= 1e-5 and d["exact_bodies"] <= 1e-4, d
        assert 0.6 < d["mask_kept"] < 0.8, d


@pytest.mark.parametrize("world", WORLDS)
def test_gather_backward_forms_agree(worlds, world):
    ranks = worlds[0][world]
    for r in ranks:
        assert r["gather_forms"] == 0.0
    # each rank's block of the line's summed cotangent, not its own
    assert not np.array_equal(ranks[0]["gather_grad"], ranks[1]["gather_grad"])


def _model_block(a, got, key, index):
    """Model index ``index``'s block of the whole array ``a`` where the
    rank holds ``key`` split (``got["split"]``: its dimension), else ``a``."""
    dim = got.get("split", {}).get(key)
    return a if dim is None else np.array_split(a, 2, dim)[index]


def _hold_step(got, want, flash, stats_tol=1e-4, index=0):
    gmax = max(np.abs(g).max() for g in want["grads"].values())
    gtol = 5e-4 if flash else 1e-4
    for key, g in want["grads"].items():
        g = _model_block(g, got, key, index)
        if key.endswith("reatten_matrix.bias"):   # exactly zero under exact BN
            assert np.abs(got["grads"][key]).max() <= 1e-4 * gmax, key
            continue
        np.testing.assert_allclose(got["grads"][key], g, rtol=gtol,
                                   atol=gtol * gmax, err_msg=f"flash={flash} {key}")
    for key, s in want["stats"].items():
        np.testing.assert_allclose(got["state"][key], s, rtol=stats_tol,
                                   atol=stats_tol, err_msg=key)


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("world", WORLDS)
def test_vit_unet_sequence_parallel_matches_jax(worlds, world, flash):
    """``ViTUNet(sequence_parallel=True)`` on 1 x 2 and 2 x 2: the eval
    forward, and a train step's loss, gradients and running statistics
    against JAX's sequence-parallel model on its 2 x 2 mesh."""
    results, want = worlds
    w = want["model"]["sp"]
    for r in results[world]:
        got = r[f"model_sp/{flash}"]
        _close(got["eval"], w["eval"], 1e-4, "eval")
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-4)
        _hold_step(got, w, flash, index=r["meshes"]["sp_coords"]["model"])


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_step_matches_jax(worlds, world, flash):
    """The data-parallel step (the batch split over 2 or 4 ranks, exact BN
    over the whole batch) against JAX's mesh step: loss, gradients (JAX's
    whole-batch gradient), and parameters and running statistics after the
    AdamW update (1e-3, as
    ``test_train_step_matches_jax`` holds them: AdamW moves a weight whose
    gradient is rounding noise by ~lr either way)."""
    results, want = worlds
    for r in results[world]:
        got = r[f"dp_step/{flash}"]
        np.testing.assert_allclose(got["loss"], want["model"]["step"]["loss"], rtol=1e-4)
        _hold_step(got, want["model"]["sp"], flash)
        for key, val in want["model"]["step"]["state"].items():
            tol = 1e-4 if "running" in key else 1e-3
            np.testing.assert_allclose(got["state"][key], val, rtol=tol, atol=tol,
                                       err_msg=key)
    # every rank holds the same model after the step
    first = results[world][0][f"dp_step/{flash}"]["state"]
    for r in results[world][1:]:
        for key, val in r[f"dp_step/{flash}"]["state"].items():
            np.testing.assert_array_equal(val, first[key], err_msg=key)


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel_step_matches_jax(worlds, world, flash):
    """The split model's step on 1 x 2 and 2 x 2 (sequence parallel too):
    each rank holds only its blocks of the parameters the rules split, and
    its parameters and AdamW moments after the step are the matching
    blocks of JAX's mesh step (1e-3 for the parameters, as
    ``test_data_parallel_step_matches_jax``; the moments against the
    largest, as the gradients)."""
    results, want = worlds
    w = want["model"]["tp_step"]
    gtol = 5e-4 if flash else 1e-4
    for r in results[world]:
        got, index = r[f"model_sp/{flash}"], r["meshes"]["sp_coords"]["model"]
        assert set(got["split"]) == {k for k in w["mu"] if re.search(
            r"FeedForward\.fc(1\.|2\.weight)|\.proj\.|position_embedding", k)}
        for key, val in w["state"].items():
            val = _model_block(val, got, key, index)
            assert got["state"][key].shape == val.shape, key
            tol = 1e-4 if "running" in key else 1e-3
            np.testing.assert_allclose(got["state"][key], val, rtol=tol, atol=tol,
                                       err_msg=key)
        for i, moment in enumerate(("mu", "nu")):
            top = max(np.abs(m).max() for m in w[moment].values())
            for key, val in w[moment].items():
                if key.endswith("reatten_matrix.bias"):   # rounding noise
                    continue
                np.testing.assert_allclose(
                    got["moments"][key][i], _model_block(val, got, key, index),
                    rtol=2 * gtol, atol=2 * gtol * top, err_msg=f"{moment} {key}")


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel_clip_norm_is_the_global_one(worlds, world):
    """The split model's gradient norm (the clip's) is the whole
    gradient's: JAX's, of the unsplit function."""
    results, want = worlds
    whole = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                        for g in want["model"]["sp"]["grads"].values()))
    for r in results[world]:
        for flash in (True, False):
            np.testing.assert_allclose(r[f"model_sp/{flash}"]["norm"], whole,
                                       rtol=5e-4, err_msg=f"flash={flash}")


def test_zero_sharding_with_tensor_parallelism(worlds):
    """ZeRO-1 over the data axis of a model split over 'model' (2 x 2):
    the same update as the replicated optimizer state, each rank holding
    about half of its blocks' moments."""
    ranks = worlds[0][4]
    for r in ranks:
        z = r["zero_tp"]
        assert z["split"], "nothing split"
        for key, val in z[False].items():
            np.testing.assert_allclose(z[True][key], val, rtol=1e-6, atol=1e-7,
                                       err_msg=key)
        full, share = z["state_bytes/False"], z["state_bytes/True"]
        assert full == 2 * sum(z["param_bytes"])
        assert abs(share - full / 2) <= 2 * max(z["param_bytes"]), (share, full)


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel_checkpoints_are_mesh_free(worlds, world):
    """A split Fitter's checkpoint (1 x 2; 2 x 2 with ZeRO-1) holds whole
    tensors: the same keys and shapes as a lone Fitter's, the same values
    up to rounding after the same epoch; a lone Fitter loads it to the
    split state gathered, and a split Fitter loads the lone one's to its
    blocks, both exactly."""
    zero = world == 4
    for r in worlds[0][world]:
        ck = r[f"tp_checkpoint/{zero}"]
        assert ck["n_split"] > 0
        assert ck["to_lone"] == 0.0 and ck["to_split"] == 0.0, ck
        assert ck["shapes"][0] == ck["shapes"][1]
        split, lone = ck["model"]
        for key, val in lone.items():
            tol = 1e-4 if "running" in key else 1e-3
            np.testing.assert_allclose(split[key], val, rtol=tol, atol=tol, err_msg=key)
        (m_split, m_lone) = ck["moments"]
        assert sorted(m_split) == sorted(m_lone)
        for i in range(2):
            top = max(np.abs(v[i]).max() for v in m_lone.values())
            for key, val in m_lone.items():
                np.testing.assert_allclose(m_split[key][i], val[i], rtol=1e-3,
                                           atol=1e-3 * top, err_msg=f"{i} {key}")


def test_tensor_parallel_dropout_draws_whole_masks(worlds):
    """With every dropout on, the split models (ViTUNet's FeedForward,
    proj and position embedding; HViTUNetTF's keras heads) give the lone
    process's loss and eval forward up to rounding: each split layer takes
    its block of the whole tensor's mask."""
    for r in worlds[0][2]:
        for name, d in r["tp_dropout"].items():
            assert d["n_split"] > 0, name
            np.testing.assert_allclose(*d["loss"], rtol=1e-5, err_msg=name)
            _close(*d["eval"], 1e-5, name)


def test_zero_sharding_updates_as_replicated(worlds):
    ranks = worlds[0][2]
    for r in ranks:
        z = r["zero"]
        for key, val in z[False].items():
            np.testing.assert_allclose(z[True][key], val, rtol=1e-6, atol=1e-7,
                                       err_msg=key)
        full, share = z["state_bytes/False"], z["state_bytes/True"]
        # two moments a parameter, each rank a half of them up to one
        # parameter's moments
        assert full == 2 * sum(z["param_bytes"])
        assert abs(share - full / 2) <= 2 * max(z["param_bytes"]), (share, full)
    assert (ranks[0]["zero"]["state_bytes/True"] + ranks[1]["zero"]["state_bytes/True"]
            == ranks[0]["zero"]["state_bytes/False"])


def test_grad_buckets_split_by_dtype_and_size(monkeypatch):
    """The gradient all-reduce's buckets: each gradient once, in order
    within its dtype, one dtype a bucket, at most GRAD_BUCKET_BYTES unless
    a single gradient is larger."""
    from vit_unet_tpu_torch.parallel import train_step as TS
    monkeypatch.setattr(TS, "GRAD_BUCKET_BYTES", 64)
    shapes = [(4, torch.float32), (20, torch.float32), (8, torch.bfloat16),
              (3, torch.float32), (40, torch.bfloat16), (1, torch.float32)]
    params = [torch.nn.Parameter(torch.zeros(n, dtype=dt)) for n, dt in shapes]
    for p in params:
        p.grad = torch.randn_like(p)
    buckets = list(TS._grad_buckets(params))
    order = [p.grad for p in params if p.dtype == torch.float32] + [
        p.grad for p in params if p.dtype == torch.bfloat16]
    assert [id(g) for b in buckets for g in b] == [id(g) for g in order]
    assert [[g.numel() for g in b] for b in buckets] == [[4], [20], [3, 1], [8], [40]]
    for b in buckets:
        assert len({g.dtype for g in b}) == 1
        assert len(b) == 1 or sum(g.numel() * g.element_size() for g in b) <= 64


def test_remainder_batch_runs_replicated_and_weights_split(worlds):
    """Loss, gradients (the ranks' average) and running statistics against
    the lone process's.  The remainder runs replicated, so bit for bit; the
    split weighted batch sums its moments in another order, which exact BN
    amplifies in the gradients (1e-4 of the largest, as
    ``test_train_step_matches_jax`` holds the plain path)."""
    for r in worlds[0][2]:
        for name in ("remainder", "weighted"):
            got = r["remainder_weights"][name]
            tol = 0.0 if name == "remainder" else 1e-4
            np.testing.assert_allclose(*got["loss"], rtol=tol, err_msg=name)
            mesh_g, lone_g = got["grads"]
            gmax = max(np.abs(g).max() for g in lone_g.values())
            for key, g in lone_g.items():
                np.testing.assert_allclose(mesh_g[key], g, rtol=0, atol=tol * gmax,
                                           err_msg=f"{name} {key}")
            assert got["stats"] <= tol, (name, got["stats"])


def test_fitter_resumes_on_two_ranks(worlds):
    ranks = worlds[0][2]
    for r in ranks:
        fit = r["fitter"]
        assert fit["start"] == 1
        assert fit["params"] == 0.0
        np.testing.assert_allclose(fit["resumed_loss"], fit["loss"][1:], rtol=1e-6)
        assert np.isfinite(fit["loss"]).all() and np.isfinite(fit["psnr"]).all()
    assert ranks[0]["fitter"]["loss"] == ranks[1]["fitter"]["loss"]
    assert [r["fitter"]["writer"] for r in ranks] == [True, False]
    assert ranks[0]["fitter"]["files"] == ["last-checkpoint.pt"]


def test_clis_train_data_parallel(worlds):
    ranks = worlds[0][2]
    for key in ("cli_denoise", "cli_classify"):
        assert all(np.isfinite(list(r[key].values())).all() for r in ranks), key
        assert ranks[0][key] == ranks[1][key], key


def test_long_context_script_trains_sequence_parallel(worlds):
    """The port's ``train_sp_longcontext`` on 1 x 2 (the 256-token level
    split, the parameters split by the rules): in its frozen-BN mode the
    loss falls and is the lone process's, step for step; with
    ``--exact_bn`` the first loss is the lone process's (exact BN at init
    magnifies rounding from the first update on, in the lone process as
    much: its loss need not fall within a few steps).  Alike on both
    ranks."""
    from vit_unet_tpu_torch.cli import train_sp_longcontext
    ranks = worlds[0][2]
    args = ["--device", "cpu", "--im_size", "64", "--patch_size", "16",
            "--hidden_dim", "32", "--batch", "2", "--sp_min_tokens", "64",
            "--model_parallel", "1"]
    lone = train_sp_longcontext.main(args + ["--steps", "3"])
    lone_exact = train_sp_longcontext.main(args + ["--steps", "1", "--exact_bn"])
    losses = ranks[0]["cli_sp"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, lone, rtol=1e-5)
    exact = ranks[0]["cli_sp_exact"]
    assert np.isfinite(exact).all(), exact
    np.testing.assert_allclose(exact[0], lone_exact[0], rtol=1e-5)
    for key in ("cli_sp", "cli_sp_exact"):
        assert ranks[1][key] == ranks[0][key], key
