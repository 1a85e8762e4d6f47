"""The frozen-BN forward's route choice, its CPU path, the port's frozen-BN
forward at base's head count against the JAX package, and a CPU emulation
of the rounding its tensor-core route does.

``train_fwd_route`` picks the frozen-BN forward's kernels on the card by
dtype and (heads, dh) alone; on the CPU ``train_fwd`` is the plain version
and counts no launch.  The JAX package's ``_fwd`` runs in interpret mode
without dropout, as its own tests run it.  The kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_unet_tpu_torch.models import get_config

JT = importlib.import_module("vit_unet_tpu.kernels.flash_reattention_train")
TT = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")


def _level_shapes():
    """(preset, level, heads, dh) of every re-attention level of lite, base
    and large."""
    out = []
    for preset in ("lite", "base", "large"):
        cfg = get_config(preset)
        for level in range(cfg.depth + 1):
            dh = cfg.level_geometry(level)["projection_dim"] // cfg.num_heads
            out.append((preset, level, cfg.num_heads, dh))
    return out


# base's and large's levels run on the tensor cores in bf16; lite's (4 heads)
# stay on the CUDA cores
TENSOR_CORE = {(8, 24), (8, 96), (8, 384)}


@pytest.mark.parametrize("preset,level,heads,dh", _level_shapes())
def test_train_fwd_route_by_dtype_and_shape(preset, level, heads, dh):
    assert TT.train_fwd_route(torch.float32, heads, dh) == "cuda_core"
    want = "tensor_core" if (heads, dh) in TENSOR_CORE else "cuda_core"
    assert TT.train_fwd_route(torch.bfloat16, heads, dh) == want
    assert TT.TRAIN_FWD_TC_SHAPES == TENSOR_CORE


def test_train_fwd_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(6)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, k, v = f(1, 8, 40, 24).bfloat16(), f(1, 8, 40, 24).bfloat16(), f(1, 40, 192).bfloat16()
    args = (q, k, v, v.float().sum(1), f(8, 8), f(8), torch.tensor([5]), 0.2)
    before = TT.train_fwd.launches, dict(TT.train_fwd.route_launches)
    got = TT.train_fwd(*args)
    assert (TT.train_fwd.launches, TT.train_fwd.route_launches) == before
    for a, b in zip(got, TT.train_fwd_plain(*args)):
        assert torch.equal(a, b)


def test_train_fwd_matches_jax_fwd_at_base_heads():
    """The port's frozen-BN forward (its plain version here) against the TPU
    kernel it replaces, ``_fwd``, in interpret mode at 8 heads and dh 24,
    rate 0: out, lse and o_norm in f32.  Blocks of 32 over 48 rows and keys,
    so the JAX kernel takes two key steps of its online softmax and masks
    padded keys; its lse and o_norm come back in the kernel's blocked
    layout (B, q blocks, H, 32, ...)."""
    n, heads, dh, block = 48, 8, 24, 32
    rng = np.random.default_rng(7)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k = f(2, heads, n, dh) * 0.5, f(2, heads, n, dh) * 0.5
    v, m, c = f(2, n, heads * dh), f(heads, heads) * 0.4, f(heads) * 0.2
    out_w, lse_w, _, onorm_w = JT._fwd(*map(jnp.asarray, (q, k, v, m, c)), 0,
                                       num_heads=heads, rate=0.0, block_q=block,
                                       block_k=block, interpret=True)
    lse_w = np.asarray(lse_w).transpose(0, 2, 1, 3).reshape(2, heads, -1)[..., :n]
    onorm_w = np.asarray(onorm_w).transpose(0, 2, 1, 3, 4).reshape(
        2, heads, -1, heads * dh)[:, :, :n]
    t = torch.from_numpy
    got = TT.train_fwd(t(q), t(k), t(v), t(v).sum(1), t(m), t(c), None, 0.0)
    for name, a, b in zip(("out", "lse", "o_norm"), got, (out_w, lse_w, onorm_w)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh,n", [(24, 128), (96, 64), (384, 49)])
def test_train_fwd_tensor_core_rounding_stays_within_tolerance(dh, n, rate):
    """The tensor-core route's rounding, emulated on the CPU with bf16
    inputs: A = P * mask from f32 scores in the exp2 form, rounded to bf16
    once for the product with V_cat (f32 accumulation), and the head mix
    taken from that f32 o_norm, as the TPU epilogue takes it, where
    ``train_fwd_plain`` mixes the bf16-rounded o_norm.  out and o_norm stay
    within 2e-2 of the plain version (max|err| / max|plain|, the card's
    tolerance for bf16 outputs)."""
    heads, batch, seed = 8, 2, 13
    g = torch.Generator().manual_seed(dh + n)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q = (rnd(batch, heads, n, dh) * 3 * dh ** -0.5).bfloat16()
    k = rnd(batch, heads, n, dh).bfloat16()
    v = rnd(batch, n, heads * dh).bfloat16()
    m, c = rnd(heads, heads) * heads ** -0.5, rnd(heads) * 0.1
    vsum = v.float().sum(1)
    out_w, _, onorm_w = TT.train_fwd_plain(q, k, v, vsum, m, c, seed, rate)

    s = q.float() @ k.float().transpose(-1, -2)
    log2e = 1.4426950408889634
    p = torch.exp2(s * log2e - (torch.logsumexp(s, -1) * log2e)[..., None])
    a = p * TT.dropout_mask(seed, rate, batch, heads, n, n) if rate > 0 else p
    onorm = torch.einsum("bhnm,bmj->bhnj", a.bfloat16().float(), v.float())
    out = TT._mix(onorm, m, c, vsum, dh).bfloat16()
    assert _rel(onorm.bfloat16(), onorm_w) <= 2e-2
    assert _rel(out, out_w) <= 2e-2
