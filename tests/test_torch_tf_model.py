"""The port's TF-flavour family against the JAX package's, float32 on the
CPU: channels-last patch ops, re-attention on channels-last tokens,
``PatchEncoderCL``, ``KerasMHA``, ``Resampling``, the Fourier and
TF-encoder blocks and the whole ``HViTUNetTF``, with JAX variables carried
across by ``load_flax_variables``.  The JAX side runs its plain path
(``use_flash=False``); its own tests hold its kernels to it.  The port runs
its kernel branch (the kernels' plain versions on CPU tensors) unless a
test says otherwise.  Outputs at 1e-4; gradients at 1e-3 of max(1, max|g|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_unet_tpu.models import hvit_unet_tf as JTF
from vit_unet_tpu.nn.blocks import FourierEncoderBlock as JFourier
from vit_unet_tpu.nn.blocks import TFTransformerEncoder as JTFEnc
from vit_unet_tpu.nn.mha import KerasMHA as JMHA
from vit_unet_tpu.nn.patch_encoder import PatchEncoderCL as JPECL
from vit_unet_tpu.nn.reattention import ReAttention as JRA
from vit_unet_tpu.nn.reattention import conv_token_matrix as j_conv_token_matrix
from vit_unet_tpu.nn.resampling import Resampling as JRS
from vit_unet_tpu.ops import patches as JP
from vit_unet_tpu_torch import Predictor
from vit_unet_tpu_torch.models import hvit_unet_tf as TTF
from vit_unet_tpu_torch.nn import reattention as TRA
from vit_unet_tpu_torch.nn.blocks import FourierEncoderBlock, TFTransformerEncoder
from vit_unet_tpu_torch.nn.mha import KerasMHA
from vit_unet_tpu_torch.nn.patch_encoder import PatchEncoderCL
from vit_unet_tpu_torch.nn.resampling import Resampling
from vit_unet_tpu_torch.ops import patches as TP
from vit_unet_tpu_torch.utils.jax_import import (
    flax_to_state_dict, load_flax_variables,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401

TOL = 1e-4
GRAD_TOL = 1e-3
# the JAX test's SMALL cut to 32² and two levels: patch 4 and 8 (E 48, 192)
SMALL = dict(img_size=32, patch_size=(4, 8), transformer_layers=(1,),
             size_bottleneck=1, num_heads=2)
NO_DROP = dict(drop_attn=0.0, drop_proj=0.0, drop_linear=0.0)
CONFIGS = [     # tests/test_tf_model.py:14-20, the first with residual_gain
    dict(residual_gain=True),
    dict(resampling_type="max", projection_dim=48),
    dict(resampling_type="avg", projection_dim=48),
    dict(original_attn=False),
    dict(resampling_type="conv"),
]


def randomised(variables, seed=0):
    """numpy copy of flax variables with random head-mix BN statistics and
    affine and a random residual gain, so that every fold is exercised."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: np.array(a, np.float32), variables)

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            elif key == "mean":
                node[key] = rng.normal(0, 0.5, val.shape).astype(np.float32)
            elif key == "var":
                node[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
            elif "var_norm" in path and key in ("scale", "bias"):
                node[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif key == "residual_gain":
                node[key] = rng.normal(0, 0.3, val.shape).astype(np.float32)
    walk(out, ())
    return out


def init(jmod, *args, seed=0):
    """Random variables of ``jmod``'s shapes from a numpy seed (no JAX
    compile): kernels and embeddings N(0, 1/fan-in), small random biases
    and LayerNorm affines, then ``randomised``."""
    shapes = jax.eval_shape(jmod.init, jax.random.key(0),
                            *(jnp.asarray(a) for a in args))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        shape = leaf.shape
        if "kernel" in name:
            scale = np.prod(shape[:-1]) ** -0.5
        elif "embedding" in name:
            scale = shape[-1] ** -0.5
        elif "scale" in name:
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            scale = 0.1
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return randomised(jax.tree_util.tree_map_with_path(draw, shapes), seed)


def jax_apply(jmod, v, *args, **kw):
    return np.asarray(jax.jit(lambda v_, *a: jmod.apply(v_, *a, **kw))(
        v, *(jnp.asarray(a) for a in args)))


def port_apply(tmod, *args, **kw):
    with torch.no_grad():
        return tmod(*(torch.from_numpy(a) for a in args), **kw).numpy()


def close(got, want, tol=TOL, what=""):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def grads_close(tmod, jgrads):
    """The port's ``.grad`` against JAX gradients mapped to its names,
    each scaled by max(1, max|g|).  With batch statistics in the head mix
    the head-mix conv bias has an
    exactly zero gradient, since BatchNorm removes any uniform shift: the
    port's is held below 1e-4 of the largest gradient (as
    ``tests/test_torch_train.py`` does); JAX's, rounding noise of a true
    zero, is not compared."""
    want = flax_to_state_dict({"params": jgrads}, tmod)
    got = {n: p.grad for n, p in tmod.named_parameters()}
    assert set(got) == set(want)
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = got[name]
        assert g is not None, name
        if name.endswith("reatten_matrix.bias"):
            assert float(g.abs().max()) <= 1e-4 * gmax, name
            continue
        scale = max(1.0, float(w.abs().max()))
        close(g.numpy() / scale, w.numpy() / scale, GRAD_TOL, name)


# --- modules 1, 3: channels-last patch ops and PatchEncoderCL ---------------

def test_patch_ops_cl_match_jax(rng):
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    pats = TP.patchify_cl(torch.from_numpy(img), 8)
    np.testing.assert_array_equal(pats.numpy(), np.asarray(JP.patchify_cl(jnp.asarray(img), 8)))
    flat = pats.reshape(2, 16, -1)
    np.testing.assert_array_equal(TP.unflatten_cl(flat, 3).numpy(), pats.numpy())
    np.testing.assert_array_equal(TP.unpatchify_cl(flat, 3).numpy(), img)
    np.testing.assert_array_equal(TP.unpatchify_cl(pats).numpy(), img)
    for kw in (dict(down_factor=2), dict(up_factor=2), dict(up_factor=4)):
        want = np.asarray(JP.change_patch_size_cl(jnp.asarray(flat.numpy()), 3, **kw))
        np.testing.assert_array_equal(TP.change_patch_size_cl(flat, 3, **kw).numpy(),
                                      want, err_msg=str(kw))
    with pytest.raises(ValueError):
        TP.unpatchify_cl(flat)


def test_patch_encoder_cl_matches_jax(rng):
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jmod = JPECL(img_size=32, patch_size=8, projection_dim=64)
    v = init(jmod, x)
    tmod = load_flax_variables(PatchEncoderCL(32, 8, projection_dim=64), v)
    close(port_apply(tmod, x), jax_apply(jmod, v, x))


# --- module 2: re-attention on channels-last tokens --------------------------

@pytest.mark.parametrize("form", ["conv", "matmul"])
@pytest.mark.parametrize("layout", ["cm", "cl"])
def test_reattention_layout_and_gelu_match_jax(rng, monkeypatch, layout, form):
    """Self and cross Q/K/V in both forms and layouts, with the exact
    GELU."""
    monkeypatch.setattr(TRA, "qkv_form", lambda e, dt: form)
    dim, heads = 48, 4
    x = rng.standard_normal((2, 16, dim)).astype(np.float32)
    kv = rng.standard_normal((2, 16, dim)).astype(np.float32)
    opts = dict(qkv_gelu=True, token_layout=layout)
    jmod = JRA(dim=dim, num_heads=heads, **opts)
    v = init(jmod, x)
    tmod = load_flax_variables(TRA.ReAttention(dim, num_heads=heads, **opts), v)
    close(port_apply(tmod, x), jax_apply(jmod, v, x), what="self")
    jq, jk, jv = jax.jit(lambda v_, a, b: jmod.apply(
        v_, a, b, b, method=lambda m, *t: m._qkv(*t)))(v, x, kv)
    with torch.no_grad():
        got = tmod._qkv(*(torch.from_numpy(t) for t in (x, kv, kv)))
    for g, w in zip(got, (jq, jk, jv)):
        close(g.numpy(), np.asarray(w), what="cross qkv")


def test_cl_layout_differs_from_cm(rng):
    """The same weights read the patch image another way."""
    dim = 48
    x = torch.from_numpy(rng.standard_normal((1, 8, dim)).astype(np.float32))
    cl = TRA.ReAttention(dim, num_heads=4, qkv_gelu=True, token_layout="cl")
    cm = TRA.ReAttention(dim, num_heads=4, qkv_gelu=True, token_layout="cm")
    cm.load_state_dict(cl.state_dict())
    with torch.no_grad():
        assert (cl(x) - cm(x)).abs().max() > 1e-5
    with pytest.raises(ValueError, match="token_layout"):
        TRA.ReAttention(dim, token_layout="hw")


def test_token_operator_cl_after_cm_matches_conv(rng):
    """One window basis serves both layouts: a channels-last operator built
    after a channel-major one of the same (k, p) is the channels-last conv,
    and equals JAX's ``conv_token_matrix(layout='cl')``."""
    c, p = 3, 4
    w = torch.from_numpy(rng.standard_normal((c, c, 3, 3)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 5, c * p * p)).astype(np.float32))
    TRA.conv_token_matrix(w, c, p, "cm")
    m = TRA.conv_token_matrix(w, c, p, "cl")
    close((x @ m.T).numpy(), TRA.conv_tokens(x, w, c, "cl").numpy(), 1e-5)
    want = np.asarray(j_conv_token_matrix(jnp.asarray(w.numpy().transpose(2, 3, 1, 0)),
                                          c, p, layout="cl"))
    close(m.numpy(), want, 1e-6)


# --- module 4: KerasMHA ------------------------------------------------------

@pytest.mark.parametrize("n_q,n_k", [(64, 64), (16, 64)])
def test_keras_mha_matches_jax(rng, n_q, n_k):
    """Eval outputs and dropout-free training gradients of both port
    branches against JAX's plain path, self and rectangular cross shape."""
    dim, heads, kd = 24, 2, 12
    q_in = rng.standard_normal((2, n_q, dim)).astype(np.float32)
    v_in = rng.standard_normal((2, n_k, dim)).astype(np.float32)
    jmod = JMHA(num_heads=heads, key_dim=kd)
    v = init(jmod, q_in, v_in)
    want = jax_apply(jmod, v, q_in, v_in)
    loss = lambda p: jnp.sum(jmod.apply(p, jnp.asarray(q_in), jnp.asarray(v_in),
                                        deterministic=False) ** 2)
    jgrads = jax.jit(jax.grad(loss))(v)["params"]
    for use_flash in (True, False):
        tmod = load_flax_variables(
            KerasMHA(dim, heads, key_dim=kd, use_flash=use_flash), v)
        assert tmod._kernels == use_flash
        close(port_apply(tmod, q_in, v_in), want, what=f"use_flash={use_flash}")
        out = tmod(torch.from_numpy(q_in), torch.from_numpy(v_in),
                   deterministic=False)
        (out ** 2).sum().backward()
        grads_close(tmod, jgrads)


@pytest.mark.parametrize("n_q,n_k", [(64, 64), (64, 256)])
def test_keras_mha_kernel_branch_matches_plain_with_dropout(rng, n_q, n_k):
    """With dropout on, the kernel branch and the plain branch draw the
    same mask from the same generator: same output and gradients."""
    dim, heads, kd = 16, 2, 8
    q_in = torch.from_numpy(rng.standard_normal((2, n_q, dim)).astype(np.float32))
    v_in = torch.from_numpy(rng.standard_normal((2, n_k, dim)).astype(np.float32))
    ref = KerasMHA(dim, heads, key_dim=kd, dropout=0.3)
    res = {}
    for use_flash in (True, False):
        mod = KerasMHA(dim, heads, key_dim=kd, dropout=0.3, use_flash=use_flash)
        mod.load_state_dict(ref.state_dict())
        gen = torch.Generator().manual_seed(5)
        out = mod(q_in, v_in, deterministic=False, generator=gen)
        (out * torch.linspace(-1, 1, dim)).sum().backward()
        res[use_flash] = (out.detach(), {n: p.grad for n, p in mod.named_parameters()},
                          gen.get_state())
    (o1, g1, s1), (o0, g0, s0) = res[True], res[False]
    torch.testing.assert_close(o1, o0, rtol=1e-5, atol=1e-5)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-5, atol=1e-5)
    assert torch.equal(s1, s0)
    det = KerasMHA(dim, heads, key_dim=kd, dropout=0.3)
    det.load_state_dict(ref.state_dict())
    with torch.no_grad():
        assert (det(q_in, v_in, deterministic=False,
                    generator=torch.Generator().manual_seed(5))
                - det(q_in, v_in)).abs().max() > 1e-3
    with pytest.raises(ValueError, match="generator"):
        det(q_in, v_in, deterministic=False)


# --- module 5: Resampling ----------------------------------------------------

@pytest.mark.parametrize("direction", [(8, 16), (16, 8)])
@pytest.mark.parametrize("mode", ["max", "avg", "standard", "conv"])
def test_resampling_matches_jax(rng, mode, direction):
    """Every mode, merging (8 -> 16) and splitting (16 -> 8); the split
    conv is flax's ConvTranspose carried across by ``jax_import``."""
    proj = 48 if mode in ("max", "avg") else None
    p_from = direction[0]
    e_in = proj or 3 * p_from ** 2
    x = rng.standard_normal((2, (32 // p_from) ** 2, e_in)).astype(np.float32)
    jmod = JRS(img_size=32, patch_size=direction, projection_dim=proj,
               resampling_type=mode)
    v = init(jmod, x)
    tmod = load_flax_variables(Resampling(32, direction, 3, proj, mode), v)
    close(port_apply(tmod, x), jax_apply(jmod, v, x))


def test_resampling_checks():
    with pytest.raises(ValueError, match="multiples"):
        Resampling(48, (16, 24))
    with pytest.raises(ValueError, match="projection_dim"):
        Resampling(32, (8, 16), resampling_type="max")
    with pytest.raises(ValueError, match="resampling_type"):
        Resampling(32, (8, 16), resampling_type="nearest")


# --- modules 6, 7: the blocks ------------------------------------------------

def test_fourier_block_matches_jax(rng):
    x = rng.standard_normal((2, 16, 48)).astype(np.float32)
    jmod = JFourier(num_patches=16, projection_dim=48, hidden_dim=24)
    v = init(jmod, x)
    tmod = load_flax_variables(FourierEncoderBlock(16, 48, 24), v)
    close(port_apply(tmod, x), jax_apply(jmod, v, x))


@pytest.mark.parametrize("original_attn", [True, False])
def test_tf_encoder_matches_jax(rng, original_attn):
    x = rng.standard_normal((2, 16, 48)).astype(np.float32)
    kw = dict(projection_dim=48, hidden_dim=96, num_heads=2, num_layers=2,
              original_attn=original_attn)
    jmod = JTFEnc(num_patches=16, **kw)
    v = init(jmod, x)
    tmod = load_flax_variables(TFTransformerEncoder(**kw), v)
    close(port_apply(tmod, x), jax_apply(jmod, v, x))


# --- module 8: the model ------------------------------------------------------

# XLA's algebraic simplifier, on the CPU, turns the jitted gradient of the
# max merge into another one (up to half the largest gradient off, in every
# layer below the merge); without that pass, as eagerly, JAX's gradient
# agrees with the port run in float64
NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}


@pytest.mark.parametrize("extra", CONFIGS)
def test_hvit_unet_tf_matches_jax(rng, extra):
    """Eval output, and the gradients of one dropout-free training loss
    (batch statistics in the re-attention variant's head mix).  The
    variant's exact-BN gradients are ill-conditioned in f32 on both sides
    (at its 4-token bottleneck each is about 5e-4 of a tensor's scale off
    float64), so JAX runs it in float64 there."""
    cfg = dict(SMALL, **NO_DROP, **extra)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    v = init(JTF.get_hvit_unet_tf(**cfg), np.zeros((1, 32, 32, 3), np.float32))
    f64 = not cfg.get("original_attn", True)

    def reference():
        dt = np.float64 if f64 else np.float32
        jmod = JTF.get_hvit_unet_tf(**cfg, dtype=dt.__name__, param_dtype=dt.__name__)

        def run(variables, xj):
            def loss(params):
                y, _ = jmod.apply({**variables, "params": params}, xj,
                                  deterministic=False, use_running_average=False,
                                  mutable=["batch_stats"])
                return jnp.sum((y - 0.9 * xj) ** 2)
            return jmod.apply(variables, xj), jax.grad(loss)(variables["params"])
        out = jax.jit(run, compiler_options=NO_ALGSIMP)(
            jax.tree.map(lambda a: a.astype(dt), v), jnp.asarray(x.astype(dt)))
        return jax.tree.map(lambda a: np.asarray(a, np.float32), out)
    if f64:
        with jax.enable_x64(True):
            want, jgrads = reference()
    else:
        want, jgrads = reference()
    tmod = load_flax_variables(TTF.HViTUNetTF(TTF.HViTUNetTFConfig(**cfg)), v)
    close(port_apply(tmod, x), want)
    xt = torch.from_numpy(x)
    y = tmod(xt, deterministic=False, use_running_average=False)
    ((y - 0.9 * xt) ** 2).sum().backward()
    grads_close(tmod, jgrads)


def test_hvit_unet_tf_config_and_sizes():
    """The JAX config's checks, and the default model's parameter counts
    (keras attention, and re-attention)."""
    for bad in (dict(patch_size=(16, 8, 32)), dict(img_size=100),
                dict(resampling_type="max"),
                dict(resampling_type="standard", projection_dim=64),
                dict(resampling_type="conv", projection_dim=64)):
        with pytest.raises(ValueError):
            TTF.HViTUNetTFConfig(**bad)
    count = lambda **kw: sum(p.numel() for p in TTF.get_hvit_unet_tf(
        device="meta", **kw).parameters())
    assert count() == 1_571_098_944
    assert count(original_attn=False) == 244_996_892
    cfg = TTF.HViTUNetTFConfig()
    assert (cfg.num_patches, cfg.projection_dims, cfg.hidden_units) == (
        [256, 64, 16], [192, 768, 3072], [384, 1536, 6144])


def test_residual_gain_starts_at_identity(rng):
    model = TTF.get_hvit_unet_tf(device="cpu", seed=1, **SMALL, residual_gain=True)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model(x), x, rtol=0, atol=0)


# --- module 10: serving channels-last images ---------------------------------

def test_predictor_serves_channels_last(rng):
    model = TTF.get_hvit_unet_tf(device="cpu", seed=2, **SMALL)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    pred = Predictor(model, batch_size=2, device="cpu")
    assert pred.input_shape == (32, 32, 3)
    got = pred(x)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pred(x[0]), got[0], rtol=0, atol=0)
