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


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


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


def _eval_inputs(cuda, dtype, batch, heads, dh, n_q, n_k, q_scale=1.0):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(batch, heads, n_q, dh, generator=g) * (q_scale * dh ** -0.5)
    k = torch.randn(batch, heads, n_k, dh, generator=g)
    v = torch.randn(batch, n_k, heads * dh, generator=g)
    w, b = TK.expand_reattention_affine(
        torch.randn(heads, heads, generator=g) * heads ** -0.5,
        torch.randn(heads, generator=g) * 0.1, dh=dh)
    return [t.to(cuda, dtype) for t in (q, k, v)] + [w.to(cuda), b.to(cuda)]


# every (heads, dh) class of the tensor-core route, ragged and rectangular
# sizes, a peaked map (q x 8), fewer keys than one MMA tile, a single query
TC_CASES = [
    (2, 8, 384, 49, 49, 1.0), (2, 8, 96, 196, 196, 1.0), (2, 8, 24, 784, 784, 1.0),
    (2, 4, 12, 3136, 3136, 1.0), (2, 4, 48, 784, 784, 1.0), (2, 4, 192, 196, 196, 1.0),
    (2, 8, 96, 96, 200, 1.0), (2, 16, 12, 256, 256, 1.0), (2, 16, 48, 64, 64, 1.0),
    (2, 8, 96, 196, 196, 8.0), (2, 8, 24, 100, 9, 1.0), (2, 8, 384, 1, 49, 1.0),
]


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k,q_scale", TC_CASES)
def test_tensor_core_route_matches_plain(cuda, batch, heads, dh, n_q, n_k, q_scale):
    dtype = torch.bfloat16
    assert TK.kernel_route(dtype, heads, dh) == "tensor_core"
    args = _eval_inputs(cuda, dtype, batch, heads, dh, n_q, n_k, q_scale)
    before = dict(TK.flash_reattention.route_launches)
    got = TK.flash_reattention(*args, num_heads=heads)
    torch.cuda.synchronize()
    assert TK.flash_reattention.route_launches == {
        "cuda_core": before["cuda_core"], "tensor_core": before["tensor_core"] + 1}
    want = TK.flash_reattention_plain(*args, num_heads=heads)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k,q_scale", TC_CASES)
def test_routes_agree_on_the_same_bf16_inputs(cuda, batch, heads, dh, n_q, n_k, q_scale):
    """The CUDA-core kernels and the tensor-core kernels on the same bf16
    inputs: the log-sum-exp to f32 rounding, the output to bf16's."""
    q, k, v, w, b = _eval_inputs(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, q_scale)
    res = {}
    for route in TK.ROUTES:
        out = torch.empty(batch, n_q, heads * dh, dtype=q.dtype, device=cuda)
        lse = torch.empty(batch, heads, n_q, device=cuda)
        TK.launch_passes(q, k, v, w, b, lse, out, route=route)
        res[route] = (lse, out)
    torch.cuda.synchronize()
    ref = torch.logsumexp(q.float() @ k.float().transpose(-1, -2), dim=-1)
    for lse, _ in res.values():
        assert (lse - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert _rel(res["tensor_core"][1], res["cuda_core"][1]) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("heads,dh", [(8, 24), (8, 96), (8, 384)])
def test_no_keys_gives_zeros_and_infinite_lse(cuda, heads, dh):
    """N_k = 0: the log-sum-exp is +inf and the output all zeros, on both
    routes, as in the plain version."""
    q, k, v, w, b = _eval_inputs(cuda, torch.bfloat16, 2, heads, dh, 40, 0)
    for route in TK.ROUTES:
        out = torch.full((2, 40, heads * dh), 7.0, dtype=q.dtype, device=cuda)
        lse = torch.zeros(2, heads, 40, device=cuda)
        TK.launch_passes(q, k, v, w, b, lse, out, route=route)
        torch.cuda.synchronize()
        assert torch.isinf(lse).all() and (lse > 0).all()
        assert (out == 0).all()
    assert (TK.flash_reattention_plain(q, k, v, w, b, num_heads=heads) == 0).all()


def test_float32_takes_the_cuda_core_route(cuda):
    args = _eval_inputs(cuda, torch.float32, 2, 8, 24, 100, 100)
    before = dict(TK.flash_reattention.route_launches)
    TK.flash_reattention(*args, num_heads=8)
    torch.cuda.synchronize()
    assert TK.flash_reattention.route_launches == {
        "cuda_core": before["cuda_core"] + 1, "tensor_core": before["tensor_core"]}
    out = torch.empty(2, 100, 192, device=cuda)
    with pytest.raises(RuntimeError):     # the tensor-core kernels take bfloat16 only
        TK.launch_passes(*args, torch.empty(2, 8, 100, device=cuda), out,
                         route="tensor_core")


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 8, 8, device=cuda, dtype=torch.float16)
    w, b = TK.expand_reattention_affine(torch.eye(2), torch.zeros(2), dh=8)
    with pytest.raises(TypeError):
        TK.flash_reattention(q, q, torch.zeros(1, 8, 16, device=cuda,
                                               dtype=torch.float16),
                             w.to(cuda), b.to(cuda), num_heads=2)


# --- the training kernels ------------------------------------------------------

TT = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")
F32_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}   # f32 outputs (lse, S, C, grads)


def _train_inputs(cuda, dtype, batch, heads, dh, n_q, n_k):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(batch, heads, n_q, dh, generator=g) * 3 * dh ** -0.5
    k = torch.randn(batch, heads, n_k, dh, generator=g)
    v = torch.randn(batch, n_k, heads * dh, generator=g)
    m = torch.randn(heads, heads, generator=g) * heads ** -0.5
    c = torch.randn(heads, generator=g) * 0.1
    gout = torch.randn(batch, n_q, heads * dh, generator=g)
    seed = torch.tensor([99], device=cuda)
    return ([t.to(cuda, dtype) for t in (q, k, v)] + [m.to(cuda), c.to(cuda)]
            + [gout.to(cuda, dtype), seed])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", [
    (2, 8, 384, 49, 49), (2, 8, 96, 196, 196), (2, 8, 24, 784, 784),
    (2, 4, 12, 96, 200),
])
def test_train_kernels_match_plain(cuda, dtype, rate, batch, heads, dh, n_q, n_k):
    q, k, v, m, c, gout, seed = _train_inputs(cuda, dtype, batch, heads, dh, n_q, n_k)
    vsum = v.float().sum(1)
    before = (TT.train_fwd.launches, TT.bn_fwd.launches, TT.train_bwd.launches)
    got = TT.train_fwd(q, k, v, vsum, m, c, seed, rate)
    want = TT.train_fwd_plain(q, k, v, vsum, m, c, seed, rate)
    for a, b, tol in zip(got, want, (TOL, F32_TOL, TOL)):
        assert _rel(a, b) <= tol[dtype]
    got = TT.bn_fwd(q, k, v, seed, rate)
    want = TT.bn_fwd_plain(q, k, v, seed, rate)
    for a, b, tol in zip(got, want, (F32_TOL, F32_TOL, F32_TOL, TOL)):
        assert _rel(a, b) <= tol[dtype]
    lse = want[2]
    d = torch.randn(batch, heads, n_q, device=cuda)
    extra = (torch.randn(heads, heads, device=cuda) * 0.1,
             torch.randn(heads, device=cuda) * 0.1)
    for bn_extra in (None, extra):
        got = TT.train_bwd(q, k, v, lse, gout, m, d, seed, rate, bn_extra)
        want = TT.train_bwd_plain(q, k, v, lse, gout, m, d, seed, rate, bn_extra)
        for a, b in zip(got, want):
            assert _rel(a, b) <= F32_TOL[dtype]
    torch.cuda.synchronize()
    after = (TT.train_fwd.launches, TT.bn_fwd.launches, TT.train_bwd.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 2)


@pytest.mark.parametrize("mode", ["frozen", "bn"])
def test_train_functions_grads_match_nxn_autograd(cuda, mode):
    """The autograd Functions on the card (f32) against torch autograd of
    the N x N forward (``reattention_nxn``) in float64 with the same
    dropout mask; the loss takes the BN moments too."""
    batch, heads, dh, n, rate = 2, 8, 24, 196, 0.2
    q, k, v, m, c, gout, seed = _train_inputs(cuda, torch.float32, batch, heads, dh, n, n)
    mask = TT.dropout_mask(99, rate, batch, heads, n, n, cuda)
    ga, be = torch.rand(heads, device=cuda) + 0.5, torch.randn(heads, device=cuda) * 0.2
    leaves = [t.clone().requires_grad_() for t in
              ((q, k, v, m, c) if mode == "frozen" else (q, k, v, m, c, ga, be))]
    ref = [t.detach().double().requires_grad_() for t in leaves]

    if mode == "frozen":
        got = (TT.flash_reattention_train(*leaves, seed, num_heads=heads, rate=rate),)
        want = (TT.reattention_nxn(*ref, mask)[0],)
    else:
        got = TT.flash_reattention_train_bn(*leaves, seed, num_heads=heads, rate=rate)
        out, moments = TT.reattention_nxn(*ref[:5], mask, norm=ref[5:])
        want = (out, *moments)
    assert _rel(got[0], want[0]) <= 1e-4
    loss = lambda outs: ((outs[0] * gout.to(outs[0].dtype)).sum()
                         + sum(o.sum() for o in outs[1:]))
    g_got = torch.autograd.grad(loss(got), leaves)
    g_want = torch.autograd.grad(loss(want), ref)
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        assert _rel(a, b) <= 1e-3, i


def test_train_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 8, device=cuda, dtype=torch.float16)
    v = torch.zeros(1, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        TT.bn_fwd(q, q, v, None)
    q32 = torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="seed"):
        TT.bn_fwd(q32, q32, torch.zeros(1, 8, 16, device=cuda), 7, 0.2)


# --- the backward's tensor-core route --------------------------------------------

# each redesigned (heads, dh) class at its base level size, and the ragged
# cases: fewer keys than one MMA tile, a single query, rectangular both ways
BWD_TC_CASES = [
    (4, 8, 24, 784, 784), (4, 8, 96, 196, 196), (4, 8, 384, 49, 49),
    (4, 8, 24, 100, 9), (4, 8, 24, 1, 49), (4, 8, 96, 1, 49), (4, 8, 384, 1, 49),
    (4, 8, 96, 96, 200), (4, 8, 24, 200, 96), (2, 8, 384, 70, 130),
]


def _bwd_args(cuda, dtype, batch, heads, dh, n_q, n_k, rate, bn):
    q, k, v, m, _, gout, seed = _train_inputs(cuda, dtype, batch, heads, dh, n_q, n_k)
    lse = torch.logsumexp(q.float() @ k.float().transpose(-1, -2), -1)
    g = torch.Generator().manual_seed(2)
    d = torch.randn(batch, heads, n_q, generator=g).to(cuda)
    extra = ((torch.randn(heads, heads, generator=g) * 0.1).to(cuda),
             (torch.randn(heads, generator=g) * 0.1).to(cuda)) if bn else None
    return q, k, v, lse, gout, m, d, seed, rate, extra


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", BWD_TC_CASES)
def test_bwd_tensor_core_route_matches_plain(cuda, batch, heads, dh, n_q, n_k, rate, bn):
    assert TT.train_bwd_route(torch.bfloat16, heads, dh) == "tensor_core"
    args = _bwd_args(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, rate, bn)
    before = dict(TT.train_bwd.route_launches)
    got = TT.train_bwd(*args)
    torch.cuda.synchronize()
    assert TT.train_bwd.route_launches == {
        "cuda_core": before["cuda_core"], "tensor_core": before["tensor_core"] + 1}
    for a, b in zip(got, TT.train_bwd_plain(*args)):
        assert _rel(a, b) <= F32_TOL[torch.bfloat16]


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", BWD_TC_CASES)
def test_bwd_routes_agree_on_the_same_bf16_inputs(cuda, batch, heads, dh, n_q, n_k):
    args = _bwd_args(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, 0.2, True)
    tc = TT.launch_bwd(*args, route="tensor_core")
    cc = TT.launch_bwd(*args, route="cuda_core")
    torch.cuda.synchronize()
    for a, b in zip(tc, cc):
        assert _rel(a, b) <= F32_TOL[torch.bfloat16]


def test_bwd_float32_takes_the_cuda_core_route(cuda):
    args = _bwd_args(cuda, torch.float32, 2, 8, 24, 100, 100, 0.2, True)
    before = dict(TT.train_bwd.route_launches)
    TT.train_bwd(*args)
    torch.cuda.synchronize()
    assert TT.train_bwd.route_launches == {
        "cuda_core": before["cuda_core"] + 1, "tensor_core": before["tensor_core"]}
    with pytest.raises(RuntimeError):     # the tensor-core kernels take bfloat16 only
        TT.launch_bwd(*args, route="tensor_core")


# --- the exact-BN forward's tensor-core route ------------------------------------

BN_FWD_TOLS = (F32_TOL, F32_TOL, F32_TOL, TOL)   # S, C, lse, o_norm


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", BWD_TC_CASES)
def test_bn_fwd_tensor_core_route_matches_plain(cuda, batch, heads, dh, n_q, n_k, rate):
    assert TT.bn_fwd_route(torch.bfloat16, heads, dh) == "tensor_core"
    q, k, v, _, _, _, seed = _train_inputs(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k)
    before = dict(TT.bn_fwd.route_launches)
    got = TT.bn_fwd(q, k, v, seed, rate)
    torch.cuda.synchronize()
    assert TT.bn_fwd.route_launches == {
        "cuda_core": before["cuda_core"], "tensor_core": before["tensor_core"] + 1}
    for a, b, tol in zip(got, TT.bn_fwd_plain(q, k, v, seed, rate), BN_FWD_TOLS):
        assert _rel(a, b) <= tol[torch.bfloat16]


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", BWD_TC_CASES)
def test_bn_fwd_routes_agree_on_the_same_bf16_inputs(cuda, batch, heads, dh, n_q, n_k):
    q, k, v, _, _, _, seed = _train_inputs(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k)
    tc = TT.launch_bn_fwd(q, k, v, seed, 0.2, route="tensor_core")
    cc = TT.launch_bn_fwd(q, k, v, seed, 0.2, route="cuda_core")
    torch.cuda.synchronize()
    for a, b, tol in zip(tc, cc, BN_FWD_TOLS):
        assert _rel(a, b) <= tol[torch.bfloat16]


@pytest.mark.parametrize("heads,dh,n", [(8, 384, 49), (8, 96, 196)])
def test_bn_fwd_dropout_bits_match_dropout_mask(cuda, heads, dh, n):
    """q = 0 makes every probability 1/Nk, and V_cat[m, j] = 1 where m = j
    (P >= Nk here) makes o_norm[..., m] Nk (1 - rate) the keep bit of key m."""
    rate, proj = 0.2, heads * dh
    q = torch.zeros(2, heads, n, dh, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(2, heads, n, dh, device=cuda).bfloat16()
    v = torch.eye(n, proj, device=cuda, dtype=torch.bfloat16).expand(2, n, proj).contiguous()
    seed = torch.tensor([31], device=cuda)
    onorm = TT.bn_fwd(q, k, v, seed, rate)[3]
    mask = TT.dropout_mask(31, rate, 2, heads, n, n, cuda) > 0
    assert torch.equal(torch.round(onorm[..., :n].float() * n * (1 - rate)), mask.float())


def test_bn_fwd_float32_takes_the_cuda_core_route(cuda):
    q, k, v, _, _, _, seed = _train_inputs(cuda, torch.float32, 2, 8, 24, 100, 100)
    before = dict(TT.bn_fwd.route_launches)
    TT.bn_fwd(q, k, v, seed, 0.2)
    torch.cuda.synchronize()
    assert TT.bn_fwd.route_launches == {
        "cuda_core": before["cuda_core"] + 1, "tensor_core": before["tensor_core"]}
    with pytest.raises(RuntimeError):     # the tensor-core kernels take bfloat16 only
        TT.launch_bn_fwd(q, k, v, seed, 0.2, route="tensor_core")


# --- the frozen-BN forward's tensor-core route ----------------------------------

FWD_TOLS = (TOL, F32_TOL, TOL)   # out, lse, o_norm
# and with more keys than the chunked form keeps A of (256): A recomputed
# for every column chunk
FWD_TC_CASES = BWD_TC_CASES + [(2, 8, 96, 40, 300), (2, 8, 384, 17, 270)]


def _fwd_args(cuda, dtype, batch, heads, dh, n_q, n_k, rate):
    q, k, v, m, c, _, seed = _train_inputs(cuda, dtype, batch, heads, dh, n_q, n_k)
    return q, k, v, v.float().sum(1), m, c, seed, rate


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", FWD_TC_CASES)
def test_fwd_tensor_core_route_matches_plain(cuda, batch, heads, dh, n_q, n_k, rate):
    assert TT.train_fwd_route(torch.bfloat16, heads, dh) == "tensor_core"
    args = _fwd_args(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, rate)
    before = TT.train_fwd.launches, dict(TT.train_fwd.route_launches)
    got = TT.train_fwd(*args)
    torch.cuda.synchronize()
    assert TT.train_fwd.launches == before[0] + 1
    assert TT.train_fwd.route_launches == {
        "cuda_core": before[1]["cuda_core"], "tensor_core": before[1]["tensor_core"] + 1}
    for a, b, tol in zip(got, TT.train_fwd_plain(*args), FWD_TOLS):
        assert _rel(a, b) <= tol[torch.bfloat16]


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", FWD_TC_CASES)
def test_fwd_routes_agree_on_the_same_bf16_inputs(cuda, batch, heads, dh, n_q, n_k):
    args = _fwd_args(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, 0.2)
    tc = TT.launch_train_fwd(*args, route="tensor_core")
    cc = TT.launch_train_fwd(*args, route="cuda_core")
    torch.cuda.synchronize()
    for a, b, tol in zip(tc, cc, FWD_TOLS):
        assert _rel(a, b) <= tol[torch.bfloat16]


@pytest.mark.parametrize("heads,dh,n", [(8, 384, 49), (8, 96, 196)])
def test_fwd_dropout_bits_match_dropout_mask(cuda, heads, dh, n):
    """As for the exact-BN forward, with the head mix M = identity and c = 0:
    o_norm[..., m] Nk (1 - rate) is the keep bit of key m, and out[b, n, j]
    is o_norm[b, head(j), n, j] bit for bit."""
    rate, proj = 0.2, heads * dh
    q = torch.zeros(2, heads, n, dh, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(2, heads, n, dh, device=cuda).bfloat16()
    v = torch.eye(n, proj, device=cuda, dtype=torch.bfloat16).expand(2, n, proj).contiguous()
    seed = torch.tensor([31], device=cuda)
    out, _, onorm = TT.train_fwd(q, k, v, v.float().sum(1), torch.eye(heads, device=cuda),
                                 torch.zeros(heads, device=cuda), seed, rate)
    mask = TT.dropout_mask(31, rate, 2, heads, n, n, cuda) > 0
    assert torch.equal(torch.round(onorm[..., :n].float() * n * (1 - rate)), mask.float())
    own = onorm.unflatten(-1, (heads, dh)).diagonal(dim1=1, dim2=3)   # (B, N, dh, H)
    assert torch.equal(out, own.permute(0, 1, 3, 2).flatten(-2))


def test_fwd_float32_takes_the_cuda_core_route(cuda):
    args = _fwd_args(cuda, torch.float32, 2, 8, 24, 100, 100, 0.2)
    before = dict(TT.train_fwd.route_launches)
    TT.train_fwd(*args)
    torch.cuda.synchronize()
    assert TT.train_fwd.route_launches == {
        "cuda_core": before["cuda_core"] + 1, "tensor_core": before["tensor_core"]}
    with pytest.raises(RuntimeError):     # the tensor-core kernels take bfloat16 only
        TT.launch_train_fwd(*args, route="tensor_core")


# --- the shape gate: a model whose level 0 is wider than the kernels take ----------

GATE_MODEL = dict(im_size=256, patch_size=64, depth_te=1, size_bottleneck=1)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 2e-2)])
def test_wide_head_model_serves_and_trains_against_its_plain_path(cuda, dtype, tol):
    """Head dims 1536, 384, 96: level 0 takes the plain path, the others the
    kernels.  Eval output, and one frozen-BN train step's loss and running
    statistics (and in float32 its gradients), against the same model with
    every layer on the plain path."""
    import copy

    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse

    model = get_vit_unet("base", seed=0, dtype=dtype, param_dtype=dtype, device=cuda,
                         **GATE_MODEL)
    layers = lambda m: [x for x in m.modules() if isinstance(x, ReAttention)]
    taken = sum(x._kernels for x in layers(model))
    assert 0 < taken < len(layers(model))
    x = torch.randn(2, 3, 256, 256, generator=torch.Generator(cuda).manual_seed(0),
                    device=cuda)
    before = TK.flash_reattention.launches
    with torch.inference_mode():
        got = model(x).float()
        torch.cuda.synchronize()
        assert TK.flash_reattention.launches == before + taken
        for layer in layers(model):
            layer.use_flash = False
        want = model(x).float()
        for layer in layers(model):
            layer.use_flash = True
    assert _rel(got, want) <= tol

    results = []
    for flash in (True, False):
        m = copy.deepcopy(model).train()
        for layer in layers(m):
            layer.flash_train = flash
        opt = adamw(m, 1e-4)
        steps = build_step_functions(m, opt, mse, bn_frozen=True)
        _, met = steps.train_step(TrainState.create(model=m, optimizer=opt, seed=7),
                                  {"x": x, "y": 0.9 * x})
        results.append((met["loss"].float(),
                        torch.cat([p.grad.float().flatten() for p in m.parameters()]),
                        torch.cat([b.float() for n, b in m.named_buffers() if "running" in n])))
    (kl, kg, ks), (pl, pg, ps) = results
    assert _rel(kl, pl) <= tol and _rel(ks, ps) <= tol
    if dtype == "float32":
        assert _rel(kg, pg) <= tol
