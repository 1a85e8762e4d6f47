"""Spread of the f32 eval loss after three exact-BN AdamW steps, across
implementations of the same function, on the CPU.

The model, weights and optimizer are those of
``tests/test_torch_train.py::test_train_step_matches_jax``; the batch is
drawn from each seed in turn (21 is the test's).  Each row prints the eval
loss of every implementation and its relative distance from the port's
plain path run in float64:

* ``jax_mm`` / ``jax_conv``: the JAX package, Q/K/V in its matmul form at
  E <= 256 (its own gate) or held on the conv;
* ``f64`` / ``f64_mm``: the port's plain path in float64, conv form and
  matmul form at E <= 192 (the two agree to float64 rounding);
* ``plain_*`` / ``flash_*``: the port in float32, plain path and kernel
  path (the kernels' plain versions on the CPU), each QKV form.

    JAX_PLATFORMS=cpu python tools/torch_eval_loss_spread.py
"""
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import optax
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_train import STEP_CFG, _jax_setup  # noqa: E402
from vit_unet_tpu.nn.reattention import ReAttention as JRA  # noqa: E402
from vit_unet_tpu.parallel import train_step as JS  # noqa: E402
from vit_unet_tpu.train import losses as JL  # noqa: E402
import vit_unet_tpu_torch.nn.reattention as RA  # noqa: E402
from vit_unet_tpu_torch.models import vit_unet as TM  # noqa: E402
from vit_unet_tpu_torch.parallel.train_step import (  # noqa: E402
    TrainState, adamw, build_step_functions)
from vit_unet_tpu_torch.train import losses as TL  # noqa: E402
from vit_unet_tpu_torch.utils.jax_import import load_flax_variables  # noqa: E402

THREADS = 4      # the f32 sums' order, and so the readings, follow it
SEEDS = (21, 1, 2, 3, 4)
MM_192 = lambda e, dt: "matmul" if e <= 192 else "conv"
CONV = lambda e, dt: "conv"


def jax_eval_loss(jmodel, variables, batch, max_e):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with mock.patch.object(JRA, "_QKV_MATMUL_MAX_E", max_e):
        tx = optax.adamw(1e-4)
        state = JS.TrainState.create(params=variables["params"], tx=tx,
                                     batch_stats=variables["batch_stats"])
        steps = JS.build_step_functions(jmodel, tx, JL.mse, bn_frozen=False)
        for _ in range(3):
            state, _ = steps.train_step(state, jb)
        return float(steps.eval_step(state, jb)["loss"])


def port_eval_loss(variables, batch, form, flash, dtype):
    with mock.patch.object(RA, "qkv_form", form):
        cfg = TM.ViTUNetConfig(**STEP_CFG, flash_train=flash, dtype=dtype,
                               param_dtype=dtype)
        tdt = getattr(torch, dtype)
        model = load_flax_variables(TM.ViTUNet(cfg), variables).to(tdt)
        opt = adamw(model, 1e-4)
        state = TrainState.create(model=model, optimizer=opt, seed=0)
        steps = build_step_functions(model, opt, TL.mse, bn_frozen=False)
        tb = {k: torch.from_numpy(v).to(tdt) for k, v in batch.items()}
        for _ in range(3):
            state, _ = steps.train_step(state, tb)
        return steps.eval_step(state, tb)["loss"].item()


def main():
    torch.set_num_threads(THREADS)
    jmodel, variables, _ = _jax_setup()
    print(f"torch threads {THREADS}")
    for seed in SEEDS:
        x = np.random.default_rng(seed).standard_normal((2, 3, 64, 64)).astype(np.float32)
        batch = {"x": x, "y": (0.9 * x).astype(np.float32)}
        res = {"jax_mm": jax_eval_loss(jmodel, variables, batch, 256),
               "jax_conv": jax_eval_loss(jmodel, variables, batch, 0)}
        for name, form, flash, dtype in (
                ("f64", CONV, False, "float64"), ("f64_mm", MM_192, False, "float64"),
                ("plain_conv", CONV, False, "float32"), ("plain_mm", MM_192, False, "float32"),
                ("flash_conv", CONV, True, "float32"), ("flash_mm", MM_192, True, "float32")):
            res[name] = port_eval_loss(variables, batch, form, flash, dtype)
        ref = res["f64"]
        print(f"seed {seed}: " + ", ".join(
            f"{k} {v:.6f} ({(v - ref) / ref:+.2e})" for k, v in res.items()), flush=True)


if __name__ == "__main__":
    main()
