"""The port's channel-major patch algebra against the JAX package's: the
same numpy inputs through both, exact equality (pure layout changes), plus
the round trips of ``tests/test_ops.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_unet_tpu.ops import patches as JP
from vit_unet_tpu_torch.ops import patches as TP


def both(fn_name, x, *args, **kw):
    got = getattr(TP, fn_name)(torch.from_numpy(x), *args, **kw).numpy()
    want = np.asarray(getattr(JP, fn_name)(jnp.asarray(x), *args, **kw))
    return got, want


@pytest.mark.parametrize("p", [4, 8, 16])
def test_patchify_matches_jax(rng, p):
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    got, want = both("patchify", x, p)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flat", [False, True])
def test_unpatchify_matches_jax(rng, flat):
    pats = rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32)
    if flat:
        got, want = both("unpatchify", pats.reshape(2, 16, -1), 3)
    else:
        got, want = both("unpatchify", pats)
    np.testing.assert_array_equal(got, want)


def test_flatten_unflatten_match_jax(rng):
    pats = rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32)
    got, want = both("flatten_patches", pats)
    np.testing.assert_array_equal(got, want)
    got, want = both("unflatten", np.array(want), 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pats)


@pytest.mark.parametrize("fn,n,e", [("split_patches", 16, 3 * 64),
                                    ("merge_patches", 64, 3 * 16)])
def test_split_merge_match_jax(rng, fn, n, e):
    x = rng.standard_normal((2, n, e)).astype(np.float32)
    got, want = both(fn, x, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(down_factor=4), dict(up_factor=4),
                                dict()])
def test_change_patch_size_matches_jax(rng, kw):
    n = 4 if "down_factor" in kw else 64
    e = 3 * 256 if "down_factor" in kw else 3 * 16
    x = rng.standard_normal((1, n, e)).astype(np.float32)
    got, want = both("change_patch_size", x, 3, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [4, 8])
def test_unpatchify_roundtrip(rng, p):
    x = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    torch.testing.assert_close(TP.unpatchify(TP.patchify(x, p)), x,
                               rtol=0, atol=0)


def test_split_merge_inverse(rng):
    x = torch.from_numpy(rng.standard_normal((2, 16, 3 * 64)).astype(np.float32))
    torch.testing.assert_close(TP.merge_patches(TP.split_patches(x, 3), 3), x,
                               rtol=0, atol=0)
    torch.testing.assert_close(TP.split_patches(TP.merge_patches(x, 3), 3), x,
                               rtol=0, atol=0)


def test_change_patch_size_rejects_bad_factors(rng):
    x = torch.zeros(1, 16, 3 * 64)
    with pytest.raises(ValueError, match="either"):
        TP.change_patch_size(x, 3, down_factor=2, up_factor=2)
    with pytest.raises(ValueError, match="not divisible"):
        TP.change_patch_size(x, 3, up_factor=3)
