"""The port's trainer against the JAX package's, on the CPU, float32,
dropout 0: ``Fitter.fit`` for 2 epochs with ``bn_freeze_epochs=1`` in each
``bn_warmup`` mode, started from the same weights (``load_flax_variables``)
and fed the same batches in the same order (the refold run also clips and
accumulates, against the JAX Fitter's
``optax.MultiSteps(chain(clip_by_global_norm, adamw), 2)``); the BN refold
on its own; the callbacks and schedules on the same logs; and clipping by
hand, checkpoints, resume and the loop's rules on the port alone.

Each JAX reference runs once per mode (a module-scoped fixture)."""
import importlib
import json
import math
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import randomised, one_torch_thread  # noqa: F401
from tests.test_torch_train import STEP_CFG
from vit_unet_tpu.data.loader import DataLoader as JDataLoader
from vit_unet_tpu.models import vit_unet as JM
from vit_unet_tpu.train import callbacks as JC
from vit_unet_tpu.train import schedules as JSch
from vit_unet_tpu.train.fitter import Fitter as JFitter
from vit_unet_tpu.utils.torch_import import import_torch_state_dict
from vit_unet_tpu_torch.data.loader import DataLoader
from vit_unet_tpu_torch.models import vit_unet as TM
from vit_unet_tpu_torch.parallel.mesh import create_mesh
from vit_unet_tpu_torch.parallel.train_step import TrainState, build_step_functions
from vit_unet_tpu_torch.train import bn_refold as TB
from vit_unet_tpu_torch.train import callbacks as TC
from vit_unet_tpu_torch.train import schedules as TSch
from vit_unet_tpu_torch.train.fitter import Fitter
from vit_unet_tpu_torch.train.losses import mse
from vit_unet_tpu_torch.utils.jax_import import flax_to_state_dict, load_flax_variables

JB = importlib.import_module("vit_unet_tpu.train.bn_refold")   # the package
# exports the function under the module's name

# test_torch_train's step model at depth 1 (levels E = 768 and 192): the
# JAX Fitter compiles a frozen and an exact train step and an eval step
# for every run
FIT_CFG = dict(STEP_CFG, depth=1)
BATCH, N_SAMPLES = 2, 8
# per-epoch learning rates, exact in float32 (the JAX Fitter keeps its
# injected learning rate in float32): 2^-14 at epoch 0, 2^-13 at epoch 1
SCHEDULE = dict(start_lr=2.0 ** -14, max_lr=2.0 ** -13, min_lr=2.0 ** -14,
                rampup_epochs=1)


class Pairs:
    """x a smooth image plus noise, y the image, from a numpy seed."""

    def __init__(self, n=N_SAMPLES, seed=0):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64
        base = np.stack([yy, xx, yy * xx])
        self.y = (base[None] * rng.uniform(0.5, 1.5, (n, 3, 1, 1))).astype(np.float32)
        self.x = (self.y + rng.normal(0, 0.1, self.y.shape)).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def _loaders(mod):
    return (mod(Pairs(), BATCH, shuffle=True, seed=0, num_workers=0),
            mod(Pairs(seed=1, n=4), BATCH, num_workers=0))


def _callbacks(mod_c, mod_s):
    # ReduceLROnPlateau watches the epoch's learning rate, which rises from
    # epoch 0 to 1: it cuts the rate after epoch 1 whatever the losses do
    return [mod_s.LearningRateScheduler(mod_s.rampup_exp_decay(**SCHEDULE)),
            mod_c.ReduceLROnPlateau(monitor="lr", patience=1)]


# per mode, the Fitter's options beyond the warmup: the refold run also
# clips (far below the gradient's norm) and accumulates 2 micro-batches,
# which the JAX Fitter does as optax.MultiSteps(chain(clip_by_global_norm,
# adamw), 2)
MODES = {"freeze": {}, "track": {},
         "refold": dict(gradient_clip_norm=1e-3, grad_accum_steps=2)}


@pytest.fixture(scope="module", params=sorted(MODES))
def jax_run(request, tmp_path_factory):
    """The JAX Fitter's 2 epochs in one mode from its own initial weights;
    returns them, its history, final state and learning rate."""
    mode = request.param
    jmodel = JM.ViTUNet(JM.ViTUNetConfig(**FIT_CFG, use_flash=False))
    fitter = JFitter(jmodel, learning_rate=SCHEDULE["start_lr"], seed=0,
                     bn_freeze_epochs=1, bn_warmup=mode, bn_calib_batches=2,
                     checkpoint_dir=str(tmp_path_factory.mktemp("jax")),
                     **MODES[mode])
    train, val = _loaders(JDataLoader)
    fitter.init_state({"x": Pairs().x[:1]})
    variables = jax.tree.map(np.asarray, {"params": fitter.state.params,
                                          "batch_stats": fitter.state.batch_stats})
    hist = fitter.fit(train, val, n_epochs=2, callbacks=_callbacks(JC, JSch),
                      save_best=False, verbose=False)
    final = flax_to_state_dict({"params": fitter.state.params,
                                "batch_stats": fitter.state.batch_stats})
    return mode, variables, hist, final, fitter.learning_rate


def test_fit_matches_jax_in_each_warmup_mode(jax_run, tmp_path):
    """Losses per epoch at 1e-4; parameters at the end at 1e-3 (AdamW moves
    a weight whose gradient is rounding noise by about lr a step either
    way, test_torch_train.py::test_train_step_matches_jax); running
    statistics at 1e-3 (the refold's moments pass through the JAX path's
    E[c^2]-free f32 sums and the port's, both within 1e-4 of each other on
    their own); the learning rate after ReduceLROnPlateau exactly."""
    mode, variables, jhist, want, jlr = jax_run
    model = load_flax_variables(TM.ViTUNet(TM.ViTUNetConfig(**FIT_CFG)), variables)
    fitter = Fitter(model, learning_rate=SCHEDULE["start_lr"], seed=0,
                    bn_freeze_epochs=1, bn_warmup=mode, bn_calib_batches=2,
                    checkpoint_dir=str(tmp_path), device="cpu", **MODES[mode])
    train, val = _loaders(DataLoader)
    hist = fitter.fit(train, val, n_epochs=2, callbacks=_callbacks(TC, TSch),
                      save_best=False, verbose=False)
    for key in ("loss", "psnr", "val_loss", "val_psnr"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-4, err_msg=key)
    assert hist["lr"] == jhist["lr"] == [2.0 ** -14, 2.0 ** -13]
    assert fitter.learning_rate == jlr == 2.0 ** -14
    sd = fitter.model.state_dict()
    for key, val_ in want.items():
        np.testing.assert_allclose(sd[key].numpy(), val_.numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=f"{mode} {key}")
    assert fitter.state.step == 2 * N_SAMPLES // BATCH


def test_bn_moments_and_refold_match_jax():
    """On the same variables and batches: the moments at 1e-4 relative, the
    refolded affine and statistics (mapped back through
    ``import_torch_state_dict``) at 1e-4, and the refolded model's exact-BN
    forward equal to the frozen forward before it."""
    jmodel = JM.ViTUNet(JM.ViTUNetConfig(**FIT_CFG, use_flash=False))
    x = Pairs().x[:4]
    variables = randomised(jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x[:1])), seed=5)
    batches = [x[:2], x[2:]]
    jm = JB.estimate_bn_moments(jmodel, variables, [jnp.asarray(b) for b in batches])
    params, stats = JB.bn_refold(variables["params"], variables["batch_stats"], jm,
                                 eps=FIT_CFG["attn_bn_eps"])
    model = load_flax_variables(TM.ViTUNet(TM.ViTUNetConfig(**FIT_CFG)), variables)
    tb = [torch.from_numpy(b) for b in batches]
    with torch.no_grad():
        frozen = model(tb[0], deterministic=True, use_running_average=True)
    moments = TB.estimate_bn_moments(model, [{"x": t} for t in tb])
    names = {".".join(part.replace("_", ".") for part in path if part != "attn"): path
             for path in jm}
    assert sorted(moments) == sorted(names)
    for name, (mean, var) in moments.items():
        jmean, jvar = jm[names[name]]
        np.testing.assert_allclose(mean.numpy(), jmean, rtol=1e-4, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(var.numpy(), jvar, rtol=1e-4, atol=1e-10, err_msg=name)
    TB.bn_refold(model, moments)
    # the refolded model, mapped back through the JAX package's importer
    back = import_torch_state_dict(model.state_dict())
    want = {"params": params, "batch_stats": stats}
    got_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_flat) == len(want_flat)
    refolded = [(path, w) for path, w in want_flat if "var_norm" in str(path)]
    assert refolded
    for path, w in refolded:
        np.testing.assert_allclose(got_flat[path], np.asarray(w), rtol=1e-4,
                                   atol=1e-7, err_msg=str(path))
    # one calibration batch: the exact-BN forward on it is the frozen one
    model1 = load_flax_variables(TM.ViTUNet(TM.ViTUNetConfig(**FIT_CFG)), variables)
    TB.bn_refold(model1, TB.estimate_bn_moments(model1, tb[:1]))
    with torch.no_grad():
        exact = model1(tb[0], deterministic=True, use_running_average=False)
    np.testing.assert_allclose(exact.numpy(), frozen.numpy(), rtol=1e-4,
                               atol=1e-4 * frozen.abs().max().item())
    with pytest.raises(ValueError, match="no batches"):
        TB.estimate_bn_moments(model, [])
    with pytest.raises(ValueError, match="matched no"):
        TB.bn_refold(torch.nn.Linear(2, 2), moments)
    assert "_attend" not in vars(model.Encoders[0].ReAttn)   # hooks removed


def test_clip_and_accumulation_by_hand():
    """SGD (no scale invariance, so the clip shows), in float64: k = 2
    micro-batches leave the parameters alone after the first and, after
    the second, move them by -lr · g · c / max(|g|, c) for g the mean of
    the two gradients, |g| its global norm."""
    data = Pairs()
    batches = [{"x": torch.from_numpy(data.x[i:i + 2]), "y": torch.from_numpy(data.y[i:i + 2])}
               for i in (0, 2)]
    f64 = dict(FIT_CFG, dtype="float64", param_dtype="float64")
    batches = [{k: v.double() for k, v in b.items()} for b in batches]
    model = TM.get_vit_unet("lite", device="cpu", seed=2, **f64)
    grads = []
    for b in batches:
        model.zero_grad(set_to_none=True)
        mse(model(b["x"], deterministic=False, use_running_average=False),
            b["y"]).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    mean = [(a + b) / 2 for a, b in zip(*grads)]
    norm = torch.sqrt(sum(g.square().sum() for g in mean))
    for clip in (1e-3, 1e6):
        fresh = TM.get_vit_unet("lite", device="cpu", seed=2, **f64)
        start = [p.detach().clone() for p in fresh.parameters()]
        opt = torch.optim.SGD(fresh.parameters(), lr=0.5)
        state = TrainState.create(model=fresh, optimizer=opt)
        steps = build_step_functions(fresh, opt, mse, clip_norm=clip, accum_steps=2)
        state, _ = steps.train_step(state, batches[0])
        assert all(torch.equal(p, s) for p, s in zip(fresh.parameters(), start))
        state, _ = steps.train_step(state, batches[1])
        scale = clip / max(norm.item(), clip)
        for p, s, g in zip(fresh.parameters(), start, mean):
            torch.testing.assert_close(p.detach() - s, -0.5 * scale * g,
                                       rtol=1e-6, atol=1e-9 * scale * norm.item())
        assert state.accum == 0 and state.step == 2
    with pytest.raises(ValueError, match="accum_steps"):
        build_step_functions(fresh, opt, mse, accum_steps=0)


class _FakeFitter:
    def __init__(self):
        self.learning_rate, self.stop_training = 1e-3, False


def test_callbacks_and_schedules_match_jax(tmp_path):
    """The same sequence of logs through each callback of both packages."""
    values = [1.0, 0.9, 0.95, 0.95, 0.96, 0.7, 0.71, 0.72, 0.73, 0.74]
    makers = [lambda m: m.ReduceLROnPlateau(patience=1, cooldown=1, factor=0.3,
                                            min_lr=2e-4),
              lambda m: m.ReduceLROnPlateau(mode="max", patience=2, min_delta=0.0),
              lambda m: m.EarlyStopping(patience=3),
              lambda m: m.EarlyStopping(mode="max", patience=2, min_delta=0.05)]
    for make in makers:
        runs = []
        for mod in (TC, JC):
            cb, fitter, trace = make(mod), _FakeFitter(), []
            for epoch, v in enumerate(values):
                logs = {"val_loss": v}
                cb.on_epoch_end(fitter, epoch, logs)
                trace.append((fitter.learning_rate, fitter.stop_training, dict(logs)))
            runs.append(trace)
        assert runs[0] == runs[1]
    for kw in (dict(), SCHEDULE, dict(sustain_epochs=2, exp_decay=0.5, replicas=4)):
        port, jax_ = TSch.rampup_exp_decay(**kw), JSch.rampup_exp_decay(**kw)
        assert [port(e) for e in range(12)] == [jax_(e) for e in range(12)]
    lrs = []
    for mod in (TSch, JSch):
        fitter = _FakeFitter()
        sched = mod.LearningRateScheduler(mod.rampup_exp_decay())
        lrs.append([(sched.on_epoch_begin(fitter, e), fitter.learning_rate)[1]
                    for e in range(8)])
    assert lrs[0] == lrs[1]
    seen = []
    TC.LambdaCallback(lambda f, e, logs: seen.append((e, logs)))\
        .on_epoch_end(None, 3, {"loss": 1.0})
    assert seen == [(3, {"loss": 1.0})]
    records = []
    for mod in (TC, JC):
        path = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        log = mod.JSONLLogger(str(path))
        fitter = _FakeFitter()
        log.on_train_begin(fitter)
        log.on_epoch_end(fitter, 0, {"loss": 0.5, "lr": 1e-3})
        log.on_epoch_end(fitter, 1, {"loss": 0.25})
        rec = [json.loads(line) for line in path.read_text().splitlines()]
        records.append([{k: v for k, v in r.items() if k != "elapsed_s"} for r in rec])
    assert records[0] == records[1]
    with mock.patch.dict(sys.modules, {"wandb": None}):    # wandb absent
        cb = TC.WandbCallback()
        cb.on_train_begin(None)
        cb.on_epoch_end(None, 0, {"loss": 1.0})
        cb.on_train_end(None)
        assert cb.run is None


def _small_fitter(tmp_path, seed=0, **kw):
    model = TM.get_vit_unet("lite", device="cpu", seed=seed,
                            **dict(FIT_CFG, attn_drop=0.1, proj_drop=0.1))
    return Fitter(model, learning_rate=1e-3, checkpoint_dir=str(tmp_path),
                  device="cpu", **kw)


def _state_equal(a: Fitter, b: Fitter):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, entry in oa["state"].items():
        for k, v in entry.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k])), (i, k)
    assert (a.state.step, a.state.accum, a.state.seed) == (b.state.step, b.state.accum, b.state.seed)
    assert torch.equal(a.state.generator.get_state(), b.state.generator.get_state())
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert (pa.grad is None) == (pb.grad is None)
        if pa.grad is not None:
            assert torch.equal(pa.grad, pb.grad)


def test_save_and_resume_are_bit_exact(tmp_path):
    """A run stopped after epoch 0 with a partly accumulated gradient and
    resumed in a fresh Fitter (other weights) restores every tensor bit for
    bit and continues exactly as the run that was not stopped."""
    train = DataLoader(Pairs(), BATCH, shuffle=True, num_workers=0)
    kw = dict(grad_accum_steps=3, bn_freeze_epochs=1, bn_warmup="refold",
              bn_calib_batches=1)
    first = _small_fitter(tmp_path, **kw)
    first.fit(train, n_epochs=1, save_last=True, save_best=False, verbose=False)
    assert first.state.accum == 1            # 4 micro-batches, k = 3
    fresh = _small_fitter(tmp_path / "none", seed=9, **kw)
    fresh.init_state()
    assert fresh.resume() == 0               # no checkpoint there
    second = _small_fitter(tmp_path, seed=9, **kw)
    with pytest.raises(ValueError, match="init_state"):
        second.resume()
    second.init_state()
    assert second.resume() == 1
    _state_equal(first, second)
    # both go on from epoch 1 on the same batches: the same numbers
    for f in (first, second):
        f.fit(lambda: iter(DataLoader(Pairs(seed=3), BATCH, num_workers=0)),
              n_epochs=2, initial_epoch=1, save_best=False, verbose=False)
    _state_equal(first, second)


def test_async_save_then_load(tmp_path):
    fitter = _small_fitter(tmp_path)
    fitter.fit(DataLoader(Pairs(), 4, num_workers=0), n_epochs=1,
               save_best=True, verbose=False)
    assert os.path.isfile(tmp_path / "best-checkpoint.pt")
    path = fitter.save("async", block=False, extra={"epoch": 0, "best": 1.0})
    step = fitter.state.step
    fitter.state.step = 0
    _, extra = fitter.load("async", with_extra=True)    # waits for the write
    assert os.path.isfile(path) and fitter.state.step == step
    assert extra == {"epoch": 0, "best": 1.0}
    fitter.save("async", block=False)
    fitter.finalize_checkpoints()


def test_fit_rules(tmp_path):
    """The loop's rules: a one-shot iterator serves one epoch, an exhausted
    one raises; the dispatch queue's depth does not change the history;
    validation is weighted by batch size; predict is the eval forward."""
    batches = [{"x": Pairs().x[i:i + 2], "y": Pairs().y[i:i + 2]} for i in (0, 2, 4)]
    fitter = _small_fitter(tmp_path)
    fitter.fit(iter(batches), n_epochs=1, save_best=False, verbose=False)
    assert fitter.state.step == 3
    with pytest.raises(ValueError, match="one-shot iterator"):
        _small_fitter(tmp_path).fit(iter(batches), n_epochs=2, save_best=False,
                                    verbose=False)
    hists = [_small_fitter(tmp_path, dispatch_depth=d).fit(
        lambda: iter(batches), n_epochs=2, save_best=False, verbose=False)["loss"]
        for d in (1, 1000)]
    assert hists[0] == hists[1]
    x, y = Pairs().x[:6], np.zeros((6, 3, 64, 64), np.float32)
    split = [{"x": x[:4], "y": y[:4]}, {"x": x[4:], "y": y[4:]}]
    got = fitter.evaluate(split)["val_loss"]
    per = [float(np.mean((fitter.predict(b["x"]).numpy() - b["y"]) ** 2)) for b in split]
    assert got == pytest.approx((4 * per[0] + 2 * per[1]) / 6, rel=1e-5)
    with pytest.raises(ValueError, match="no batches"):
        fitter.evaluate([])


def test_fitter_options_and_device_rule(tmp_path, monkeypatch):
    model = TM.get_vit_unet("lite", device="cpu", **FIT_CFG)
    with pytest.raises(ValueError, match="mesh"):
        Fitter(model, device="cpu", zero_sharding=True)
    lone = create_mesh(device="cpu")       # one process: one replica
    on_mesh = Fitter(model, learning_rate=0.5, mesh=lone, scale_lr_by_replicas=True)
    assert on_mesh.device == torch.device("cpu") and on_mesh.learning_rate == 0.5
    with pytest.raises(ValueError, match="bn_warmup"):
        Fitter(model, device="cpu", bn_warmup="nope")
    frozen = TM.get_vit_unet("lite", device="cpu", **FIT_CFG, flash_frozen_bn=True)
    with pytest.raises(ValueError, match="bn_freeze_epochs"):
        Fitter(frozen, device="cpu", bn_freeze_epochs=1)
    fitter = Fitter(model, optimizer="sgd", learning_rate=0.25, device="cpu")
    assert isinstance(fitter.optimizer, torch.optim.SGD) and fitter.learning_rate == 0.25
    fitter.learning_rate = 0.125
    assert fitter.optimizer.param_groups[0]["lr"] == 0.125
    adamw = Fitter(model, device="cpu").optimizer
    assert isinstance(adamw, torch.optim.AdamW) and adamw.defaults["weight_decay"] == 0.0
    assert isinstance(Fitter(model, optimizer="adam", device="cpu").optimizer, torch.optim.Adam)
    ready = torch.optim.SGD(model.parameters(), lr=0.5)
    assert Fitter(model, optimizer=ready, device="cpu").optimizer is ready
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Fitter(model)
    assert math.isinf(Fitter(model, device="cpu").best)
