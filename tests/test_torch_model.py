"""The port's modules and the whole ViTUNet against the JAX package, eval
mode, float32: JAX variables from ``init`` (with randomised BatchNorm
statistics and affine so the head-mix fold is exercised) are carried into
the port by ``load_flax_variables`` and the same numpy inputs go through
both.  On the JAX side ``use_flash=True`` reaches the Pallas kernel in
interpret mode wherever its token floor allows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_unet_tpu.models import vit_unet as JM
from vit_unet_tpu.nn.blocks import ReAttentionEncoderBlock as JBlock
from vit_unet_tpu.nn.feedforward import FeedForward as JFF
from vit_unet_tpu.nn.patch_encoder import PatchEncoder as JPE
from vit_unet_tpu.nn.reattention import ReAttention as JRA
from vit_unet_tpu.nn.reattention import SkipConnection as JSkip
from vit_unet_tpu.utils.torch_import import import_torch_state_dict
from vit_unet_tpu_torch.models import vit_unet as TM
from vit_unet_tpu_torch.nn.blocks import ReAttentionEncoderBlock
from vit_unet_tpu_torch.nn.feedforward import FeedForward
from vit_unet_tpu_torch.nn.patch_encoder import PatchEncoder
from vit_unet_tpu_torch.nn.reattention import ReAttention, SkipConnection
from vit_unet_tpu_torch.utils.jax_import import load_flax_variables

TOL = 1e-4
TINY = dict(depth=2, depth_te=1, size_bottleneck=1, preprocessing="conv",
            im_size=64, patch_size=16, num_channels=3, hidden_dim=32,
            num_heads=4, attn_drop=0.0, proj_drop=0.0, linear_drop=0.0)


def randomised(variables, seed=0):
    """numpy copy of flax variables with random head-mix BN statistics
    (mean ~ N(0, 0.5), var ~ U[0.5, 2]), BN affine and residual gain."""
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
            elif "var_norm" in path and key == "scale":
                node[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif ("var_norm" in path and key == "bias") or key == "residual_gain":
                node[key] = rng.normal(0, 0.3, val.shape).astype(np.float32)
    walk(out, ())
    return out


def jax_apply(module, variables, *args):
    return np.asarray(jax.jit(lambda v, *a: module.apply(v, *a))(
        variables, *(jnp.asarray(a) for a in args)))


def port_apply(module, variables, *args):
    load_flax_variables(module, variables)
    with torch.no_grad():
        return module(*(torch.from_numpy(a) for a in args)).numpy()


def check(jmod, tmod, *args, init_args=None):
    v = randomised(jmod.init(jax.random.key(0),
                             *(jnp.asarray(a) for a in (init_args or args))))
    want = jax_apply(jmod, v, *args)
    got = port_apply(tmod, v, *args)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_feedforward_matches_jax(rng):
    x = rng.standard_normal((2, 16, 48)).astype(np.float32)
    check(JFF(projection_dim=48, hidden_dim=24), FeedForward(48, 24), x)


@pytest.mark.parametrize("prep", ["conv", "fourier", "none"])
def test_patch_encoder_matches_jax(rng, prep):
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    check(JPE(depth=2, num_patches=16, patch_size=16, preprocessing=prep),
          PatchEncoder(2, 16, 16, preprocessing=prep), x)


@pytest.mark.parametrize("qkv_kernel,n,use_flash", [
    (1, 16, False), (3, 16, False),
    (3, 128, True),     # JAX side through the Pallas kernel (interpret)
])
def test_reattention_matches_jax(rng, qkv_kernel, n, use_flash):
    dim, heads = 48, 4
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    check(JRA(dim=dim, num_heads=heads, qkv_kernel=qkv_kernel,
              use_flash=use_flash),
          ReAttention(dim, num_heads=heads, qkv_kernel=qkv_kernel), x)


def test_skip_connection_matches_jax(rng):
    dim, n, heads = 48, 16, 4
    q = rng.standard_normal((2, n, dim)).astype(np.float32)
    k = rng.standard_normal((2, n, dim)).astype(np.float32)
    jmod = JSkip(dim=dim, num_heads=heads)
    v = randomised(jmod.init(jax.random.key(0), *(jnp.asarray(a) for a in (q, k, k))))
    want = jax_apply(jmod, v, q, k, k)
    # the port keeps SkipConnection's layers on the module, not under 'attn'
    inner = {col: tree["attn"] for col, tree in v.items()}
    got = port_apply(SkipConnection(dim, num_heads=heads), inner, q, k, k)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ln_mode", ["shared", "dual"])
def test_encoder_block_matches_jax(rng, ln_mode):
    n, proj, hidden, heads = 16, 48, 24, 4
    x = rng.standard_normal((2, n, proj)).astype(np.float32)
    check(JBlock(num_patches=n, projection_dim=proj, hidden_dim=hidden,
                 num_heads=heads, ln_mode=ln_mode),
          ReAttentionEncoderBlock(n, proj, hidden, heads, ln_mode=ln_mode), x)


@pytest.mark.parametrize("extra,size", [
    (dict(), 64),
    (dict(global_residual=True, residual_gain=True, input_skip=True,
          head_blocks=1, head_dim=8), 64),
    (dict(), 80),       # shrinking bilinear resize (antialiased in JAX)
])
def test_vit_unet_matches_jax(rng, extra, size):
    x = rng.standard_normal((2, 3, size, size)).astype(np.float32)
    check(JM.ViTUNet(JM.ViTUNetConfig(**TINY, use_flash=True, **extra)),
          TM.ViTUNet(TM.ViTUNetConfig(**TINY, **extra)), x,
          init_args=(np.zeros((1, 3, 64, 64), np.float32),))


def test_param_counts_match_readme():
    for name, want in [("lite", 3_387_568), ("base", 36_613_036),
                       ("large", 63_043_866)]:
        model = TM.get_vit_unet(name, device="meta")
        assert sum(p.numel() for p in model.parameters()) == want


def test_weight_round_trip_through_torch_import():
    """JAX tree -> port -> state_dict -> import_torch_state_dict gives the
    tree back, for the default config."""
    jmod = JM.ViTUNet(JM.ViTUNetConfig())
    shapes = jax.eval_shape(jmod.init, jax.random.key(0),
                            jnp.zeros((1, 3, 224, 224)))
    rng = np.random.default_rng(5)
    tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    port = load_flax_variables(TM.ViTUNet(TM.ViTUNetConfig()), tree)
    back = import_torch_state_dict(port.state_dict())
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, got), (_, want) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_extension_weights_round_trip():
    """The importer maps neither ``residual_gain`` nor the head convs; the
    port's names for them, mapped here, carry the flax values."""
    cfg = dict(TINY, global_residual=True, residual_gain=True, head_blocks=2,
               head_dim=8, input_skip=True)
    jmod = JM.ViTUNet(JM.ViTUNetConfig(**cfg))
    tree = randomised(jmod.init(jax.random.key(0), jnp.zeros((1, 3, 64, 64))))
    sd = load_flax_variables(TM.ViTUNet(TM.ViTUNetConfig(**cfg)), tree).state_dict()
    np.testing.assert_array_equal(sd["residual_gain"].numpy(),
                                  tree["params"]["residual_gain"])
    for i in range(2):
        np.testing.assert_array_equal(
            sd[f"head.{i}.weight"].numpy().transpose(2, 3, 1, 0),
            tree["params"][f"head_{i}"]["kernel"])


def test_eval_only_and_unported_options_raise():
    model = TM.ViTUNet(TM.ViTUNetConfig(**TINY))
    x = torch.zeros(1, 3, 64, 64)
    with pytest.raises(NotImplementedError, match="training slice"):
        model.train()
    with pytest.raises(NotImplementedError, match="training slice"):
        model(x, deterministic=False)
    with pytest.raises(NotImplementedError, match="training slice"):
        model(x, use_running_average=False)
    for flag in ("flash_train", "flash_frozen_bn", "bn_track"):
        with pytest.raises(NotImplementedError):
            TM.ViTUNet(TM.ViTUNetConfig(**TINY, **{flag: True}))
    for bad in (dict(sequence_parallel=True), dict(block_type="fourier"),
                dict(remat=True)):
        with pytest.raises(NotImplementedError):
            TM.ViTUNet(TM.ViTUNetConfig(**TINY, **bad))
    with pytest.raises(ValueError, match="residual_gain"):
        TM.ViTUNetConfig(**TINY, residual_gain=True)
