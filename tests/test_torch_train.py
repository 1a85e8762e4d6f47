"""The port's training path against the JAX package, on the CPU, float32,
dropout 0: the modules in train mode against JAX's XLA path
(``use_flash=False``), their outputs and mutated BatchNorm statistics, and
the whole train step at TINY against JAX's ``build_step_functions`` with
``optax.adamw(1e-4)``, plus the losses and metrics.

The port runs its default kernel path (``flash_train=True``: the training
kernels' plain versions on the CPU) and its plain N x N path
(``flash_train=False``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_model import TINY, randomised, one_torch_thread  # noqa: F401
from vit_unet_tpu.models import vit_unet as JM
from vit_unet_tpu.nn.blocks import ReAttentionEncoderBlock as JBlock
from vit_unet_tpu.nn.feedforward import FeedForward as JFF
from vit_unet_tpu.nn.reattention import ReAttention as JRA
from vit_unet_tpu.nn.reattention import SkipConnection as JSkip
from vit_unet_tpu.parallel import train_step as JS
from vit_unet_tpu.train import losses as JL
from vit_unet_tpu.train import metrics as JMet
from vit_unet_tpu.utils.torch_import import import_torch_state_dict
from vit_unet_tpu_torch.models import vit_unet as TM
from vit_unet_tpu_torch.nn.blocks import ReAttentionEncoderBlock
from vit_unet_tpu_torch.nn.feedforward import FeedForward
from vit_unet_tpu_torch.nn.reattention import ReAttention, SkipConnection
from vit_unet_tpu_torch.parallel.mesh import create_mesh
from vit_unet_tpu_torch.parallel.train_step import (
    TrainState, adamw, build_step_functions,
)
from vit_unet_tpu_torch.train import losses as TL
from vit_unet_tpu_torch.train import metrics as TMet
from vit_unet_tpu_torch.utils.jax_import import (
    flax_to_state_dict, load_flax_variables,
)

MODES = {  # name -> (use_running_average, bn_track)
    "exact": (False, False), "frozen": (True, False), "track": (False, True)}


def _jax_train(jmod, variables, args, use_running_average):
    out, upd = jmod.apply(variables, *(jnp.asarray(a) for a in args),
                          deterministic=False,
                          use_running_average=use_running_average,
                          rngs={"dropout": jax.random.key(1)},
                          mutable=["batch_stats"])
    return np.asarray(out), upd.get("batch_stats", {})


def _check_module(jmod, tmod, variables, args, mode):
    ura, _ = MODES[mode]
    want, stats = _jax_train(jmod, variables, args, ura)
    load_flax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in args), deterministic=False,
                   use_running_average=ura).numpy()
    # flax's E[x^2] - E[x]^2 batch variance carries ~5e-4 relative f32
    # noise that 1/sigma amplifies (tests/test_kernels_train.py:301-305)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 2e-3 * (scale + 1)
    sd = tmod.state_dict()
    for key, val in flax_to_state_dict({"batch_stats": stats}).items():
        np.testing.assert_allclose(sd[key].numpy(), val.numpy(), rtol=2e-3,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_reattention_train_matches_jax(flash, mode):
    dim, heads, n = 48, 4, 64
    # x4: peaked maps keep the head-mix variance far above BN's eps
    x = np.random.default_rng(13).standard_normal((2, n, dim)).astype(np.float32) * 4
    kw = dict(dim=dim, num_heads=heads)
    jmod = JRA(**kw, use_flash=False, bn_track=MODES[mode][1])
    variables = randomised(jmod.init(jax.random.key(0), jnp.asarray(x)))
    tmod = ReAttention(dim, num_heads=heads, flash_train=flash,
                       bn_track=MODES[mode][1])
    _check_module(jmod, tmod, variables, (x,), mode)


@pytest.mark.parametrize("flash", [True, False])
def test_skip_connection_train_matches_jax(flash):
    dim, heads, n = 48, 4, 64
    rng = np.random.default_rng(3)
    q, k = (rng.standard_normal((2, n, dim)).astype(np.float32) * 4 for _ in range(2))
    jmod = JSkip(dim=dim, num_heads=heads)
    variables = randomised(jmod.init(jax.random.key(0), *(jnp.asarray(a) for a in (q, k, k))))
    want, stats = _jax_train(jmod, variables, (q, k, k), False)
    inner = {col: tree["attn"] for col, tree in variables.items()}
    tmod = load_flax_variables(SkipConnection(dim, num_heads=heads, flash_train=flash), inner)
    with torch.no_grad():
        tq, tk = torch.from_numpy(q), torch.from_numpy(k)
        got = tmod(tq, tk, tk, deterministic=False, use_running_average=False).numpy()
    assert np.abs(got - want).max() < 2e-3 * (np.abs(want).max() + 1)
    want_stats = flax_to_state_dict({"batch_stats": stats["attn"]})
    for key, val in want_stats.items():
        np.testing.assert_allclose(tmod.state_dict()[key].numpy(), val.numpy(),
                                   rtol=2e-3, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("mode", ["exact", "frozen"])
def test_encoder_block_train_matches_jax(mode):
    n, proj, hidden, heads = 16, 48, 24, 4
    x = np.random.default_rng(5).standard_normal((2, n, proj)).astype(np.float32) * 4
    jmod = JBlock(num_patches=n, projection_dim=proj, hidden_dim=hidden,
                  num_heads=heads)
    variables = randomised(jmod.init(jax.random.key(0), jnp.asarray(x)))
    _check_module(jmod, ReAttentionEncoderBlock(n, proj, hidden, heads),
                  variables, (x,), mode)


def test_feedforward_train_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 16, 48)).astype(np.float32)
    jmod = JFF(projection_dim=48, hidden_dim=24)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), deterministic=False))
    tmod = load_flax_variables(FeedForward(48, 24), variables)
    got = tmod(torch.from_numpy(x), deterministic=False).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dropout_needs_a_generator_and_is_reproducible():
    tmod = ReAttention(48, num_heads=4, attn_drop=0.2, proj_drop=0.1)
    x = torch.randn(2, 16, 48)
    with pytest.raises(ValueError, match="generator"):
        tmod(x, deterministic=False)
    run = lambda seed: tmod(x, deterministic=False, use_running_average=True,
                            generator=torch.Generator().manual_seed(seed))
    torch.testing.assert_close(run(5), run(5), rtol=0, atol=0)
    assert not torch.equal(run(5), run(6))


# --- the whole train step -----------------------------------------------------

# BN eps 1e-3 (the JAX package's trainable exact-BN setting) keeps the
# exact-BN gradients of this fresh model well conditioned in f32
STEP_CFG = dict(TINY, attn_bn_eps=1e-3)


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """The JAX model, its variables (randomised BN) and one batch."""
    jmodel = JM.ViTUNet(JM.ViTUNetConfig(**STEP_CFG, use_flash=False))
    variables = randomised(jax.jit(jmodel.init)(jax.random.key(0),
                                                jnp.zeros((1, 3, 64, 64))))
    x = np.random.default_rng(21).standard_normal((2, 3, 64, 64)).astype(np.float32)
    return jmodel, variables, {"x": x, "y": (0.9 * x).astype(np.float32)}


def _port_model(variables, flash):
    return load_flax_variables(
        TM.ViTUNet(TM.ViTUNetConfig(**STEP_CFG, flash_train=flash)), variables)


@pytest.mark.parametrize("bn_frozen", [False, True])
def test_train_step_matches_jax(bn_frozen):
    """Step 1's loss and gradients, and the params and running statistics
    after 3 steps, of the port's kernel path and plain path against JAX's
    XLA path.

    Tolerances, each against the largest gradient of the step (gmax):
    * plain path: 1e-4.  Under exact BN the head-mix conv bias has an
      exactly zero gradient (BatchNorm removes any uniform shift), so both
      sides hold only rounding noise there; it is held below 1e-4 gmax.
    * kernel path: 5e-4.  As on the TPU, the backward takes the softmax-dot
      term D from the o_norm residual, not from the map; in a saturated
      softmax row (this model's Decoders.1 has scores of ~2000) the N x N
      backward cancels dA - D exactly and this form keeps f32 rounding of
      |dA|.  Against a float64 run of the same path its largest error is
      2.6e-4 gmax; JAX's XLA path is at 4e-6.
    * params after 3 steps: 1e-3.  AdamW moves each weight by about
      lr = 1e-4 per step whatever its gradient's size, so a weight whose
      gradient sits at rounding noise may move the other way.
    """
    jmodel, variables, batch = _jax_setup()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jloss(params):
        pred, _ = jmodel.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               jb["x"], deterministic=False,
                               use_running_average=bn_frozen,
                               rngs={"dropout": jax.random.key(0)},
                               mutable=["batch_stats"])
        return JL.mse(pred, jb["y"])

    loss_w, grads_w = jax.value_and_grad(jloss)(variables["params"])
    grads_w = {k: v.numpy() for k, v in flax_to_state_dict({"params": grads_w}).items()}
    gmax = max(np.abs(g).max() for g in grads_w.values())
    tx = optax.adamw(1e-4)
    state = JS.TrainState.create(params=variables["params"], tx=tx,
                                 batch_stats=variables["batch_stats"])
    steps = JS.build_step_functions(jmodel, tx, JL.mse, bn_frozen=bn_frozen)
    for _ in range(3):
        state, _ = steps.train_step(state, jb)
    want = flax_to_state_dict({"params": state.params,
                               "batch_stats": state.batch_stats})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    for flash, gtol in ((True, 5e-4), (False, 1e-4)):
        tmodel = _port_model(variables, flash)
        opt = adamw(tmodel, 1e-4)
        tstate = TrainState.create(model=tmodel, optimizer=opt, seed=0)
        tsteps = build_step_functions(tmodel, opt, TL.mse, bn_frozen=bn_frozen)
        tstate, m = tsteps.train_step(tstate, tb)
        np.testing.assert_allclose(m["loss"].item(), float(loss_w), rtol=1e-4)
        params = dict(tmodel.named_parameters())
        for key, g in grads_w.items():
            got = params[key].grad.numpy()
            if not bn_frozen and key.endswith("reatten_matrix.bias"):
                assert np.abs(got).max() <= 1e-4 * gmax, key
                continue
            np.testing.assert_allclose(got, g, rtol=gtol, atol=gtol * gmax,
                                       err_msg=f"flash={flash} {key}")
        for _ in range(2):
            tstate, _ = tsteps.train_step(tstate, tb)
        sd = tmodel.state_dict()
        for key, val in want.items():
            tol = 1e-4 if "running" in key else 1e-3
            np.testing.assert_allclose(sd[key].numpy(), val.numpy(), rtol=tol,
                                       atol=tol, err_msg=f"flash={flash} {key}")
        assert tstate.step == 3
        # the eval step on the state the port trained, against JAX's eval
        # step on that state mapped back: the two trained states differ by
        # f32 rounding that AdamW turns into weight moves of up to ~5e-4
        # (held above), which the running-average forward amplifies into
        # ~1e-3 of the eval loss even between JAX's own two QKV forms
        back = import_torch_state_dict(sd)
        ev = tsteps.eval_step(tstate, tb)
        np.testing.assert_allclose(
            ev["loss"].item(),
            float(steps.eval_step(state.replace(**back), jb)["loss"]), rtol=1e-5)


def test_train_step_options():
    model = TM.ViTUNet(TM.ViTUNetConfig(**TINY))
    opt = adamw(model)
    assert opt.defaults["weight_decay"] == 1e-4
    with pytest.raises(ValueError, match="mesh"):
        build_step_functions(model, opt, TL.mse, zero_sharding=True)
    # the mesh of a lone process: the same step as without one
    twin = TM.ViTUNet(TM.ViTUNetConfig(**TINY))
    twin.load_state_dict(model.state_dict())
    twin_opt = adamw(twin)
    on_mesh = build_step_functions(twin, twin_opt, TL.mse, mesh=create_mesh(device="cpu"))
    assert on_mesh.optimizer is twin_opt
    xm = torch.randn(2, 3, 64, 64)
    mesh_loss = on_mesh.train_step(TrainState.create(model=twin, optimizer=twin_opt),
                                   {"x": xm, "y": xm})[1]["loss"]
    ref = build_step_functions(model, opt, TL.mse).train_step(
        TrainState.create(model=model, optimizer=opt), {"x": xm, "y": xm})[1]["loss"]
    torch.testing.assert_close(mesh_loss, ref, rtol=0, atol=0)
    for a, b in zip(model.parameters(), twin.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    opt = adamw(model)
    steps = build_step_functions(model, opt, TL.mse, metrics={"psnr": TMet.psnr})
    x = torch.randn(3, 3, 64, 64)
    batch = {"x": x, "y": x * 0.9}
    state = TrainState.create(model=model, optimizer=opt, seed=4)
    ones = steps.eval_step(state, {**batch, "w": torch.ones(3)})["loss"]
    torch.testing.assert_close(ones, steps.eval_step(state, batch)["loss"])
    _, m = steps.train_step(state, batch)
    assert set(m) == {"loss", "psnr"} and torch.isfinite(m["loss"])


# --- losses and metrics -------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TL.LOSSES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    shape = (2, 5) if name == "categorical_crossentropy" else (2, 3, 16, 16)
    pred = rng.standard_normal(shape).astype(np.float32)
    target = rng.uniform(0, 1, shape).astype(np.float32)
    if name == "categorical_crossentropy":
        target = np.eye(5, dtype=np.float32)[[1, 3]]
    want = float(JL.get_loss(name)(jnp.asarray(pred), jnp.asarray(target)))
    got = float(TL.get_loss(name)(torch.from_numpy(pred), torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(TMet.METRICS))
def test_metrics_match_jax(name):
    rng = np.random.default_rng(2)
    shape = (4, 6) if name in ("accuracy", "f1") else (2, 3, 16, 16)
    pred = rng.uniform(0, 1, shape).astype(np.float32)
    target = (rng.uniform(0, 1, shape) > 0.5).astype(np.float32)
    want = float(JMet.get_metric(name)(jnp.asarray(pred), jnp.asarray(target)))
    got = float(TMet.get_metric(name)(torch.from_numpy(pred), torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        TMet.get_metric("nope")
