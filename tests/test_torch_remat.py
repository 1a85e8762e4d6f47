"""``ViTUNet`` with ``remat=True`` and with ``block_type="fourier"``: against
the JAX model (float32, CPU, dropout off; JAX's plain path) and, for remat,
against the port's own ``remat=False`` step with dropout on, which must give
the same loss, gradients, running statistics and generator state: the
recomputation replays the generator and leaves the statistics alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tf_model import NO_ALGSIMP, close, grads_close, init
from vit_unet_tpu.models import vit_unet as JM
from vit_unet_tpu_torch.models import vit_unet as TM
from vit_unet_tpu_torch.parallel.train_step import (
    TrainState, adamw, build_step_functions,
)
from vit_unet_tpu_torch.train import losses as TL
from vit_unet_tpu_torch.utils.jax_import import (
    flax_to_state_dict, load_flax_variables,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401

TINY = dict(depth=2, depth_te=1, size_bottleneck=1, preprocessing="conv",
            im_size=64, patch_size=16, num_channels=3, hidden_dim=32,
            num_heads=4, attn_drop=0.0, proj_drop=0.0, linear_drop=0.0)
DROP = dict(attn_drop=0.2, proj_drop=0.2, linear_drop=0.2)


@pytest.mark.parametrize("block_type,remat", [
    ("fourier", True), ("reattention", True)])
def test_matches_jax(rng, block_type, remat):
    """Eval output, and the gradients of one dropout-free training loss,
    against JAX's model of the same ``block_type`` and ``remat`` (JAX's
    remat computes what its plain model does; the port's remat step is held
    against its plain step below), one level deep: an encoder, a bottleneck
    and a decoder block, each of them checkpointed.

    The Fourier model trains with batch statistics in its skip
    connections' head mix and is held per tensor (1e-3 of max(1, max|g|)).
    A re-attention ViTUNet's f32 gradients are ill-conditioned on both
    sides: saturated softmax rows (scores in the thousands at level 0) put
    its Q/K conv gradients off float64 by the rounding of the largest
    gradient, and more so with batch statistics (ROADMAP Queue C,
    "Exact-BN conditioning").  So it keeps its running statistics here and
    is held as ``tests/test_torch_train.py`` holds the kernel path, within
    5e-4 of the largest gradient.  One level keeps it well inside that;
    with two, other inputs than these went beyond it.  Its exact-BN step
    under remat is held against the port's own step below."""
    cfg = dict(TINY, depth=1, block_type=block_type, remat=remat)
    exact = block_type == "fourier"
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    jmod = JM.ViTUNet(JM.ViTUNetConfig(**cfg))
    v = init(jmod, np.zeros((1, 3, 64, 64), np.float32))

    def run(variables, xj):
        def loss(params):
            y, _ = jmod.apply({**variables, "params": params}, xj,
                              deterministic=False,
                              use_running_average=not exact,
                              mutable=["batch_stats"])
            return jnp.sum((y - 0.9 * xj) ** 2)
        return jmod.apply(variables, xj), jax.grad(loss)(variables["params"])
    want, jgrads = jax.jit(run, compiler_options=NO_ALGSIMP)(v, jnp.asarray(x))
    tmod = load_flax_variables(TM.ViTUNet(TM.ViTUNetConfig(**cfg)), v)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        close(tmod(xt).numpy(), np.asarray(want))
    y = tmod(xt, deterministic=False, use_running_average=not exact)
    ((y - 0.9 * xt) ** 2).sum().backward()
    if exact:
        grads_close(tmod, jgrads)
        return
    want = flax_to_state_dict({"params": jgrads}, tmod)
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=5e-4, atol=5e-4 * gmax, err_msg=name)


def _step(remat: bool, **cfg):
    """One train step of a fresh TINY model with dropout on: (loss,
    gradients, buffers, generator state, block forward calls)."""
    model = TM.get_vit_unet("lite", device="cpu", seed=4,
                            **{**TINY, **DROP, **cfg, "remat": remat})
    calls = []
    model.Encoders[0].register_forward_pre_hook(lambda *a: calls.append(1))
    opt = adamw(model, 1e-4)
    state = TrainState.create(model=model, optimizer=opt, seed=7)
    steps = build_step_functions(model, opt, TL.mse)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    state, m = steps.train_step(state, {"x": x, "y": 0.9 * x})
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    return m["loss"], grads, buffers, state.generator.get_state(), len(calls)


@pytest.mark.parametrize("cfg", [
    dict(),                                  # exact BN on the kernel path
    dict(flash_train=False),                 # exact BN on the plain path
    dict(bn_track=True),                     # running statistics normalise
    dict(block_type="fourier"),
])
def test_remat_step_matches_no_remat_with_dropout(cfg):
    loss0, g0, b0, s0, calls0 = _step(False, **cfg)
    loss1, g1, b1, s1, calls1 = _step(True, **cfg)
    assert (calls0, calls1) == (1, 2)        # the block ran again in backward
    torch.testing.assert_close(loss1, loss0, rtol=0, atol=0)
    assert torch.equal(s1, s0)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-7,
                                   msg=name)
    for name in b0:
        torch.testing.assert_close(b1[name], b0[name], rtol=0, atol=0, msg=name)
    if cfg.get("block_type") != "fourier":
        assert any(not torch.equal(b0[n], torch.zeros_like(b0[n]))
                   for n in b0 if n.endswith("running_mean"))


def test_remat_without_autograd_runs_once(rng):
    model = TM.get_vit_unet("lite", device="cpu", seed=1, **TINY, remat=True)
    calls = []
    model.Encoders[0].register_forward_pre_hook(lambda *a: calls.append(1))
    x = torch.from_numpy(rng.standard_normal((1, 3, 64, 64)).astype(np.float32))
    ref = TM.get_vit_unet("lite", device="cpu", seed=1, **TINY)
    with torch.no_grad():
        torch.testing.assert_close(model(x), ref(x), rtol=0, atol=0)
    assert calls == [1]
