"""The port's CUDA kernel against its plain version, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On the card run
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the
repo's conftest imports jax); ``chip_smoke.py`` holds
the kernel at every level shape of the presets.
"""
import importlib

import pytest
import torch

TK = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention")

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # max|err| / max|plain|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", [
    (2, 8, 384, 49, 49), (2, 8, 96, 196, 196), (2, 8, 24, 784, 784),
    (2, 4, 8, 96, 200), (2, 16, 12, 64, 64),
])
def test_kernel_matches_plain(cuda, dtype, batch, heads, dh, n_q, n_k):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(batch, heads, n_q, dh, generator=g) * dh ** -0.5
    k = torch.randn(batch, heads, n_k, dh, generator=g)
    v = torch.randn(batch, n_k, heads * dh, generator=g)
    w, b = TK.expand_reattention_affine(torch.randn(heads, heads, generator=g),
                                        torch.randn(heads, generator=g), dh=dh)
    args = [t.to(cuda, dtype) for t in (q, k, v)] + [w.to(cuda), b.to(cuda)]
    before = TK.flash_reattention.launches
    got = TK.flash_reattention(*args, num_heads=heads)
    torch.cuda.synchronize()
    assert TK.flash_reattention.launches == before + 1
    want = TK.flash_reattention_plain(*args, num_heads=heads)
    rel = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert rel.item() <= TOL[dtype]


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 8, 8, device=cuda, dtype=torch.float16)
    w, b = TK.expand_reattention_affine(torch.eye(2), torch.zeros(2), dh=8)
    with pytest.raises(TypeError):
        TK.flash_reattention(q, q, torch.zeros(1, 8, 16, device=cuda,
                                               dtype=torch.float16),
                             w.to(cuda), b.to(cuda), num_heads=2)
