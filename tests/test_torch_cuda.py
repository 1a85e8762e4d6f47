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


# 16 heads: the classifier's levels at its N, a ragged case, and the two
# wider head dims kernel_takes admits at 16 heads
HEAD16_CASES = [
    (2, 16, 48, 196, 196), (2, 16, 12, 784, 784), (2, 16, 48, 100, 130),
    (2, 16, 192, 196, 196), (2, 16, 384, 49, 49),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", [
    (2, 8, 384, 49, 49), (2, 8, 96, 196, 196), (2, 8, 24, 784, 784),
    (2, 4, 8, 96, 200), (2, 16, 12, 64, 64),
] + HEAD16_CASES)
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
    (2, 8, 192, 256, 256, 1.0), (2, 8, 192, 100, 130, 1.0),   # HViTUNetTF's keras class
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
        **before, "tensor_core": before["tensor_core"] + 1}
    want = TK.flash_reattention_plain(*args, num_heads=heads)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k,q_scale", TC_CASES)
def test_routes_agree_on_the_same_bf16_inputs(cuda, batch, heads, dh, n_q, n_k, q_scale):
    """The CUDA-core kernels and the tensor-core kernels on the same bf16
    inputs: the log-sum-exp to f32 rounding, the output to bf16's."""
    q, k, v, w, b = _eval_inputs(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, q_scale)
    res = {}
    for route in ("cuda_core", "tensor_core"):
        out = torch.empty(batch, n_q, heads * dh, dtype=q.dtype, device=cuda)
        lse = torch.empty(batch, heads, n_q, device=cuda)
        TK.launch_passes(q, k, v, w, b, lse, out, route=route)
        res[route] = (lse, out)
    torch.cuda.synchronize()
    ref = torch.logsumexp(q.float() @ k.float().transpose(-1, -2), dim=-1)
    for lse, _ in res.values():
        assert (lse - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert _rel(res["tensor_core"][1], res["cuda_core"][1]) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("heads,dh", [(8, 24), (8, 96), (8, 384), (8, 192)])
def test_no_keys_gives_zeros_and_infinite_lse(cuda, heads, dh):
    """N_k = 0: the log-sum-exp is +inf and the output all zeros, on both
    routes (and at dh 192 on the identity route), as in the plain version."""
    q, k, v, w, b = _eval_inputs(cuda, torch.bfloat16, 2, heads, dh, 40, 0)
    routes = ("cuda_core", "tensor_core") + (("identity_tc",) if dh == 192 else ())
    for route in routes:
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
        **before, "cuda_core": before["cuda_core"] + 1}
    out = torch.empty(2, 100, 192, device=cuda)
    with pytest.raises(RuntimeError):     # the tensor-core kernels take bfloat16 only
        TK.launch_passes(*args, torch.empty(2, 8, 100, device=cuda), out,
                         route="tensor_core")


# kernel 1's identity route (KerasMHA's calls): its two classes at N 256,
# the level-0 skip's 64 queries of 256 keys, ragged, a single query
IDENTITY_CASES = [(2, 8, 192, 256, 256), (2, 4, 192, 256, 256), (2, 8, 192, 64, 256),
                  (2, 8, 192, 100, 130), (2, 8, 192, 1, 49)]


def _identity_inputs(cuda, batch, heads, dh, n_q, n_k):
    q, k, v, _, _ = _eval_inputs(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k)
    w, b = TK.expand_reattention_affine(torch.eye(heads), torch.zeros(heads), dh=dh)
    return q, k, v, w.to(cuda), b.to(cuda)


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", IDENTITY_CASES)
def test_identity_route_matches_plain_and_the_two_pass_route(cuda, batch, heads, dh, n_q,
                                                             n_k):
    assert TK.kernel_route(torch.bfloat16, heads, dh, identity_mix=True) == "identity_tc"
    q, k, v, w, b = _identity_inputs(cuda, batch, heads, dh, n_q, n_k)
    before = dict(TK.flash_reattention.route_launches)
    got = TK.flash_reattention(q, k, v, w, b, num_heads=heads, identity_mix=True)
    torch.cuda.synchronize()
    assert TK.flash_reattention.route_launches == {
        **before, "identity_tc": before["identity_tc"] + 1}
    assert _rel(got, TK.flash_reattention_plain(q, k, v, w, b, num_heads=heads)) <= TOL[
        torch.bfloat16]
    res = {}
    for route in ("tensor_core", "identity_tc"):
        out = torch.empty_like(got)
        lse = torch.empty(batch, heads, n_q, device=cuda)
        TK.launch_passes(q, k, v, w, b, lse, out, route=route)
        res[route] = (lse, out)
    torch.cuda.synchronize()
    ref = torch.logsumexp(q.float() @ k.float().transpose(-1, -2), dim=-1)
    assert (res["identity_tc"][0] - ref).abs().max().item() <= 1e-4 * max(
        1.0, ref.abs().max().item())
    assert torch.equal(res["identity_tc"][1], got)
    assert _rel(res["identity_tc"][1], res["tensor_core"][1]) <= TOL[torch.bfloat16]


def test_identity_route_takes_only_its_classes_in_bf16(cuda):
    q, k, v, w, b = _identity_inputs(cuda, 2, 8, 96, 64, 64)
    out = torch.empty(2, 64, 8 * 96, dtype=q.dtype, device=cuda)
    lse = torch.empty(2, 8, 64, device=cuda)
    with pytest.raises(RuntimeError):     # (8, 96) is not an identity class
        TK.launch_passes(q, k, v, w, b, lse, out, route="identity_tc")
    with pytest.raises(ValueError, match="one pass"):
        TK.launch_passes(q, k, v, w, b, lse, out, route="identity_tc", passes=1)
    q, k, v, w, b = _identity_inputs(cuda, 2, 8, 192, 64, 64)
    q, k, v = q.float(), k.float(), v.float()
    with pytest.raises(RuntimeError):     # bfloat16 only
        TK.launch_passes(q, k, v, w, b, torch.empty(2, 8, 64, device=cuda),
                         torch.empty(2, 64, 8 * 192, device=cuda), route="identity_tc")


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", IDENTITY_CASES)
def test_identity_f32_route_matches_plain_and_the_cuda_core_route(cuda, batch, heads, dh,
                                                                  n_q, n_k):
    """Kernel 1's float32 identity route (split-precision MMAs) at f32's
    tolerance against the plain version and route 0 on the same inputs."""
    assert TK.kernel_route(torch.float32, heads, dh, identity_mix=True) == "identity_f32"
    q, k, v, w, b = _identity_inputs(cuda, batch, heads, dh, n_q, n_k)
    q, k, v = q.float(), k.float(), v.float()
    before = dict(TK.flash_reattention.route_launches)
    got = TK.flash_reattention(q, k, v, w, b, num_heads=heads, identity_mix=True)
    torch.cuda.synchronize()
    assert TK.flash_reattention.route_launches == {
        **before, "identity_f32": before["identity_f32"] + 1}
    assert got.dtype == torch.float32
    assert _rel(got, TK.flash_reattention_plain(q, k, v, w, b, num_heads=heads)) <= TOL[
        torch.float32]
    res = {}
    for route in ("cuda_core", "identity_f32"):
        out = torch.empty_like(got)
        lse = torch.empty(batch, heads, n_q, device=cuda)
        TK.launch_passes(q, k, v, w, b, lse, out, route=route)
        res[route] = (lse, out)
    torch.cuda.synchronize()
    ref = torch.logsumexp(q @ k.transpose(-1, -2), dim=-1)
    assert (res["identity_f32"][0] - ref).abs().max().item() <= 1e-5 * max(
        1.0, ref.abs().max().item())
    assert torch.equal(res["identity_f32"][1], got)
    assert _rel(res["identity_f32"][1], res["cuda_core"][1]) <= TOL[torch.float32]


def test_identity_f32_route_takes_only_its_classes_in_float32(cuda):
    q, k, v, w, b = _identity_inputs(cuda, 2, 8, 96, 64, 64)
    q, k, v = q.float(), k.float(), v.float()
    with pytest.raises(RuntimeError):     # (8, 96) is not an identity class
        TK.launch_passes(q, k, v, w, b, torch.empty(2, 8, 64, device=cuda),
                         torch.empty(2, 64, 8 * 96, device=cuda), route="identity_f32")
    q, k, v, w, b = _identity_inputs(cuda, 2, 8, 192, 64, 64)
    with pytest.raises(RuntimeError):     # float32 only
        TK.launch_passes(q, k, v, w, b, torch.empty(2, 8, 64, device=cuda),
                         torch.empty(2, 64, 8 * 192, dtype=q.dtype, device=cuda),
                         route="identity_f32")
    assert TK.kernel_route(torch.float32, 8, 192) == "cuda_core"   # without the flag


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
] + HEAD16_CASES)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_base_draws_the_whole_layers_mask(cuda, dtype):
    """A tensor-parallel rank's heads 4-7 of 8 (``head_base`` 4): kernels 2
    and 3 against their plain versions with the same head base, and the
    forward against the 8-head call's heads 4-7 with the identity mix."""
    batch, heads, dh, n, h = 2, 8, 48, 196, 4
    q, k, v, _, _, gout, seed = _train_inputs(cuda, dtype, batch, heads, dh, n, n)
    eye, zero = torch.eye(heads, device=cuda), torch.zeros(heads, device=cuda)
    full = TT.flash_reattention_train(q, k, v, eye, zero, seed, num_heads=heads,
                                      rate=0.2)
    cut = lambda t: t.view(batch, n, heads, dh)[:, :, h:].reshape(batch, n, h * dh)
    qh, kh, vh = q[:, h:].contiguous(), k[:, h:].contiguous(), cut(v).contiguous()
    part = TT.flash_reattention_train(qh, kh, vh, eye[:h, :h], zero[:h], seed,
                                      num_heads=h, rate=0.2, head_base=h)
    assert _rel(part, cut(full)) <= TOL[dtype]
    vsum = vh.float().sum(1)
    got = TT.train_fwd(qh, kh, vh, vsum, eye[:h, :h], zero[:h], seed, 0.2, head_base=h)
    want = TT.train_fwd_plain(qh, kh, vh, vsum, eye[:h, :h], zero[:h], seed, 0.2,
                              head_base=h)
    for a, b, tol in zip(got, want, (TOL, F32_TOL, TOL)):
        assert _rel(a, b) <= tol[dtype]
    d = torch.randn(batch, h, n, device=cuda)
    got = TT.train_bwd(qh, kh, vh, want[1], cut(gout), eye[:h, :h], d, seed, 0.2,
                       head_base=h)
    want = TT.train_bwd_plain(qh, kh, vh, want[1], cut(gout), eye[:h, :h], d, seed,
                              0.2, head_base=h)
    for a, b in zip(got, want):
        assert _rel(a, b) <= F32_TOL[dtype]


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


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("mode", ["frozen", "bn"])
@pytest.mark.parametrize("batch,heads,dh,n", [(2, 16, 48, 196), (2, 16, 12, 784),
                                              (2, 16, 192, 196), (2, 16, 384, 49)])
def test_train_functions_at_16_heads_match_nxn_autograd(cuda, batch, heads, dh, n,
                                                         mode, dtype, tol, rate):
    """Both autograd Functions at 16 heads against torch autograd of the
    N x N forward in float64 on the same inputs and mask (bf16 inputs are
    held to their rounding, as chip_smoke.py's GRAD_TOL does)."""
    q, k, v, m, c, gout, seed = _train_inputs(cuda, dtype, batch, heads, dh, n, n)
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
    loss = lambda outs: ((outs[0] * gout.to(outs[0].dtype)).sum()
                         + sum(o.sum() for o in outs[1:]))
    g_got = torch.autograd.grad(loss(got), leaves)
    g_want = torch.autograd.grad(loss(want), ref)
    assert _rel(got[0], want[0]) <= tol
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        assert _rel(a, b) <= tol, i


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
# the classifier's 16-head classes at its N and ragged: more keys than
# queries over 9 key tiles of 16, more queries than keys over 3 tiles of
# 32, a single query
HEAD16_BWD_CASES = [
    (2, 16, 48, 196, 196), (2, 16, 12, 784, 784), (2, 16, 48, 100, 130),
    (2, 16, 12, 200, 96), (2, 16, 12, 1, 49),
]
# lite's 4-head classes (kernels 2, 3 and 4 on the tensor cores) at a level N
# (dh 12 at 1,024 of its 3,136), ragged over partial key tiles and dropout
# windows, more queries than keys, a single query
LITE_CASES = [
    (2, 4, 12, 1024, 1024), (2, 4, 12, 100, 130), (2, 4, 12, 200, 96), (2, 4, 12, 1, 49),
    (2, 4, 48, 784, 784), (2, 4, 48, 100, 130), (2, 4, 192, 196, 196), (2, 4, 192, 70, 130),
    (2, 4, 192, 1, 49),
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
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", BWD_TC_CASES + HEAD16_BWD_CASES + LITE_CASES)
def test_bwd_tensor_core_route_matches_plain(cuda, batch, heads, dh, n_q, n_k, rate, bn):
    assert TT.train_bwd_route(torch.bfloat16, heads, dh) == "tensor_core"
    args = _bwd_args(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, rate, bn)
    before = dict(TT.train_bwd.route_launches)
    got = TT.train_bwd(*args)
    torch.cuda.synchronize()
    assert TT.train_bwd.route_launches == {
        **before, "tensor_core": before["tensor_core"] + 1}
    for a, b in zip(got, TT.train_bwd_plain(*args)):
        assert _rel(a, b) <= F32_TOL[torch.bfloat16]


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", BWD_TC_CASES + HEAD16_BWD_CASES + LITE_CASES)
def test_bwd_routes_agree_on_the_same_bf16_inputs(cuda, batch, heads, dh, n_q, n_k):
    args = _bwd_args(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, 0.2, True)
    tc = TT.launch_bwd(*args, route="tensor_core")
    cc = TT.launch_bwd(*args, route="cuda_core")
    torch.cuda.synchronize()
    for a, b in zip(tc, cc):
        assert _rel(a, b) <= F32_TOL[torch.bfloat16]


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", [(2, 8, 384, 70, 130), (2, 8, 384, 49, 49)])
def test_bwd_maps_form_repeats_bit_for_bit(cuda, batch, heads, dh, n_q, n_k):
    """The class with a workspace (maps, then products) uses no atomics:
    two calls on the same inputs give the same bits."""
    args = _bwd_args(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, 0.2, True)
    first = TT.launch_bwd(*args, route="tensor_core")
    again = TT.launch_bwd(*args, route="tensor_core")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", HEAD16_BWD_CASES[:2])
def test_bwd_16_head_classes_write_dk_and_dv_once(cuda, batch, heads, dh, n_q, n_k):
    """The 16-head classes add dq by atomics but write dk and dv once from
    a block's registers: two calls give the same dk and dv bits, and dq
    within the tolerance."""
    args = _bwd_args(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, 0.2, True)
    first = TT.launch_bwd(*args, route="tensor_core")
    again = TT.launch_bwd(*args, route="tensor_core")
    torch.cuda.synchronize()
    assert torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
    assert _rel(first[0], again[0]) <= F32_TOL[torch.bfloat16]


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", LITE_CASES[::3])
def test_bwd_lite_classes_write_dk_and_dv_once(cuda, batch, heads, dh, n_q, n_k):
    """At 4 heads one warp of a head keeps dk, the other dv, each written once
    from its registers: two calls give the same dk and dv bits; dq goes by
    atomics, within the tolerance."""
    args = _bwd_args(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, 0.2, True)
    first = TT.launch_bwd(*args, route="tensor_core")
    again = TT.launch_bwd(*args, route="tensor_core")
    torch.cuda.synchronize()
    assert torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
    assert _rel(first[0], again[0]) <= F32_TOL[torch.bfloat16]


@pytest.mark.parametrize("dh", [12, 48, 192])
def test_lite_float32_takes_the_cuda_core_routes(cuda, dh):
    """Lite's classes in float32: kernels 2 and 4 on the CUDA cores, kernel
    3 on its f32 tensor-core route."""
    args = _bwd_args(cuda, torch.float32, 2, 4, dh, 100, 100, 0.2, True)
    before = (dict(TT.train_bwd.route_launches), dict(TT.bn_fwd.route_launches),
              dict(TT.train_fwd.route_launches))
    TT.train_bwd(*args)
    TT.bn_fwd(args[0], args[1], args[2], args[7], 0.2)
    TT.train_fwd(*_fwd_args(cuda, torch.float32, 2, 4, dh, 100, 100, 0.2))
    torch.cuda.synchronize()
    assert TT.train_fwd_route(torch.float32, 4, dh) == "cuda_core"
    assert TT.train_bwd.route_launches == {
        **before[0], "tensor_core_f32": before[0]["tensor_core_f32"] + 1}
    assert TT.bn_fwd.route_launches == {**before[1], "cuda_core": before[1]["cuda_core"] + 1}
    assert TT.train_fwd.route_launches == {
        **before[2], "cuda_core": before[2]["cuda_core"] + 1}


# lite's classes in f32 (kernel 3's split-precision route): LITE_CASES and
# more queries than keys at dh 48 and 192
LITE_F32_CASES = LITE_CASES + [(2, 4, 48, 200, 96), (2, 4, 192, 200, 96)]


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", LITE_F32_CASES)
def test_bwd_f32_tensor_core_route_matches_plain(cuda, batch, heads, dh, n_q, n_k, rate, bn):
    """Kernel 3's f32 route at lite's classes (every operand a bf16 pair,
    three MMAs a product) against the plain version at f32's tolerance,
    counted under its own key; a second call gives dk and dv bit for bit
    (written once) and dq within the tolerance (atomics)."""
    assert TT.train_bwd_route(torch.float32, heads, dh) == "tensor_core_f32"
    args = _bwd_args(cuda, torch.float32, batch, heads, dh, n_q, n_k, rate, bn)
    before = dict(TT.train_bwd.route_launches)
    got = TT.train_bwd(*args)
    again = TT.launch_bwd(*args, route="tensor_core_f32")
    torch.cuda.synchronize()
    assert TT.train_bwd.route_launches == {
        **before, "tensor_core_f32": before["tensor_core_f32"] + 1}
    for a, b in zip(got, TT.train_bwd_plain(*args)):
        assert _rel(a, b) <= F32_TOL[torch.float32]
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    assert _rel(got[0], again[0]) <= F32_TOL[torch.float32]


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", LITE_F32_CASES[::4])
def test_bwd_f32_routes_agree_on_the_same_inputs(cuda, batch, heads, dh, n_q, n_k):
    args = _bwd_args(cuda, torch.float32, batch, heads, dh, n_q, n_k, 0.2, True)
    tc = TT.launch_bwd(*args, route="tensor_core_f32")
    cc = TT.launch_bwd(*args, route="cuda_core")
    torch.cuda.synchronize()
    for a, b in zip(tc, cc):
        assert _rel(a, b) <= F32_TOL[torch.float32]


def test_bwd_f32_tensor_core_route_takes_only_its_classes(cuda):
    """The f32 route has no class but lite's and takes no bf16; the bf16
    route takes no f32; no identity route through ``launch_bwd``."""
    args = _bwd_args(cuda, torch.float32, 2, 8, 24, 100, 100, 0.2, True)
    with pytest.raises(RuntimeError):
        TT.launch_bwd(*args, route="tensor_core_f32")
    lite32 = _bwd_args(cuda, torch.float32, 2, 4, 48, 100, 100, 0.2, True)
    with pytest.raises(RuntimeError):
        TT.launch_bwd(*lite32, route="tensor_core")
    lite16 = _bwd_args(cuda, torch.bfloat16, 2, 4, 48, 100, 100, 0.2, True)
    with pytest.raises(RuntimeError):
        TT.launch_bwd(*lite16, route="tensor_core_f32")
    with pytest.raises(ValueError):
        TT.launch_bwd(*lite32, route="identity_f32")


def test_bwd_float32_takes_the_cuda_core_route(cuda):
    args = _bwd_args(cuda, torch.float32, 2, 8, 24, 100, 100, 0.2, True)
    before = dict(TT.train_bwd.route_launches)
    TT.train_bwd(*args)
    torch.cuda.synchronize()
    assert TT.train_bwd.route_launches == {
        **before, "cuda_core": before["cuda_core"] + 1}
    with pytest.raises(RuntimeError):     # the tensor-core kernels take bfloat16 only
        TT.launch_bwd(*args, route="tensor_core")


def test_bwd_general_mix_at_the_keras_class_takes_the_cuda_core_route(cuda):
    """(8, 192) has no tensor-core class: a general-mix bf16 call there
    takes the CUDA cores (the keras attention's calls take the identity
    route)."""
    args = _bwd_args(cuda, torch.bfloat16, 2, 8, 192, 100, 130, 0.2, True)
    before = dict(TT.train_bwd.route_launches)
    got = TT.train_bwd(*args)
    torch.cuda.synchronize()
    assert TT.train_bwd.route_launches == {
        **before, "cuda_core": before["cuda_core"] + 1}
    for a, b in zip(got, TT.train_bwd_plain(*args)):
        assert _rel(a, b) <= F32_TOL[torch.bfloat16]
    with pytest.raises(RuntimeError):
        TT.launch_bwd(*args, route="tensor_core")


# --- the exact-BN forward's tensor-core route ------------------------------------

BN_FWD_TOLS = (F32_TOL, F32_TOL, F32_TOL, TOL)   # S, C, lse, o_norm


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", BWD_TC_CASES + LITE_CASES)
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


@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", BWD_TC_CASES + LITE_CASES)
def test_bn_fwd_routes_agree_on_the_same_bf16_inputs(cuda, batch, heads, dh, n_q, n_k):
    q, k, v, _, _, _, seed = _train_inputs(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k)
    tc = TT.launch_bn_fwd(q, k, v, seed, 0.2, route="tensor_core")
    cc = TT.launch_bn_fwd(q, k, v, seed, 0.2, route="cuda_core")
    torch.cuda.synchronize()
    for a, b, tol in zip(tc, cc, BN_FWD_TOLS):
        assert _rel(a, b) <= tol[torch.bfloat16]


@pytest.mark.parametrize("heads,dh,n", [(8, 384, 49), (8, 96, 196), (16, 12, 128), (4, 12, 48),
                                      (4, 48, 192), (4, 192, 196), (16, 48, 300)])
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


# both forwards' 16-head classes on the tensor cores, (16, 12) and (16, 48):
# the classifier's N, ragged over partial key tiles, more queries than
# keys, a single query, and at dh 48 more keys than the chunked form keeps
# A of (256), so A is recomputed for every column chunk
BN16_CASES = [(2, 16, 12, 784, 784), (2, 16, 12, 100, 130), (2, 16, 12, 200, 96),
              (2, 16, 12, 1, 49), (2, 16, 48, 196, 196), (2, 16, 48, 100, 130),
              (2, 16, 48, 200, 96), (2, 16, 48, 1, 49), (2, 16, 48, 40, 300)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", BN16_CASES)
def test_bn_fwd16_tensor_core_route_matches_plain_and_cuda_core(cuda, batch, heads, dh, n_q,
                                                                n_k, rate):
    assert TT.bn_fwd_route(torch.bfloat16, heads, dh) == "tensor_core"
    q, k, v, _, _, _, seed = _train_inputs(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k)
    before = dict(TT.bn_fwd.route_launches)
    got = TT.bn_fwd(q, k, v, seed, rate)
    torch.cuda.synchronize()
    assert TT.bn_fwd.route_launches == {**before, "tensor_core": before["tensor_core"] + 1}
    other = TT.launch_bn_fwd(q, k, v, seed, rate, route="cuda_core")
    again = TT.launch_bn_fwd(q, k, v, seed, rate, route="tensor_core")
    want = TT.bn_fwd_plain(q, k, v, seed, rate)
    for a, b, c, tol in zip(got, want, other, BN_FWD_TOLS):
        assert _rel(a, b) <= tol[torch.bfloat16]
        assert _rel(a, c) <= tol[torch.bfloat16]
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics: the same bits
    s_rows, c_rows = got[:2]
    assert torch.equal(c_rows, c_rows.transpose(1, 2))    # C written as one symmetric sum


# --- the frozen-BN forward's tensor-core route ----------------------------------

FWD_TOLS = (TOL, F32_TOL, TOL)   # out, lse, o_norm
# and with more keys than the chunked form keeps A of (256): A recomputed
# for every column chunk; and lite's classes
FWD_TC_CASES = BWD_TC_CASES + [(2, 8, 96, 40, 300), (2, 8, 384, 17, 270)] + LITE_CASES


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
        **before[1], "tensor_core": before[1]["tensor_core"] + 1}
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


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", BN16_CASES)
def test_fwd16_tensor_core_route_matches_plain_and_cuda_core(cuda, batch, heads, dh, n_q, n_k,
                                                             rate):
    assert TT.train_fwd_route(torch.bfloat16, heads, dh) == "tensor_core"
    args = _fwd_args(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k, rate)
    before = dict(TT.train_fwd.route_launches)
    got = TT.train_fwd(*args)
    torch.cuda.synchronize()
    assert TT.train_fwd.route_launches == {**before, "tensor_core": before["tensor_core"] + 1}
    other = TT.launch_train_fwd(*args, route="cuda_core")
    again = TT.launch_train_fwd(*args, route="tensor_core")
    for a, b, c, tol in zip(got, TT.train_fwd_plain(*args), other, FWD_TOLS):
        assert _rel(a, b) <= tol[torch.bfloat16]
        assert _rel(a, c) <= tol[torch.bfloat16]
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics: the same bits


@pytest.mark.parametrize("heads,dh,n", [(8, 384, 49), (8, 96, 196), (4, 192, 196),
                                        (4, 48, 192), (4, 12, 48), (16, 12, 128),
                                        (16, 48, 300)])
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


def test_lite_frozen_step_on_the_kernels_matches_the_plain_path(cuda):
    """Lite at 64² in bf16 (levels (4, 12) at N 256, (4, 48) at 64, (4, 192)
    at 16), one frozen-BN step with dropout: each of its 8 re-attention
    calls through kernel 2 and kernel 3 on the tensor cores.  Its loss
    against the plain path (``flash_train=False``; the same weights and
    dropout seed give the same masks) at the bf16 tolerance, and its
    gradients against the same step with kernel 2 held on the CUDA-core
    route at 3e-2 of the largest (both bf16 on the kernels: they differ by
    kernel 2's rounding of out and o_norm and kernel 3's dq atomics)."""
    import contextlib
    import copy
    from unittest import mock

    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse
    model = get_vit_unet("lite", device=cuda, seed=0, im_size=64, dtype="bfloat16",
                         param_dtype="bfloat16").train()
    x = torch.randn(4, 3, 64, 64, generator=torch.Generator().manual_seed(0)).to(cuda)
    held = mock.patch.object(TT, "train_fwd_route", lambda *a, **k: "cuda_core")
    res = {}
    for path in ("tensor_core", "cuda_core", "plain"):
        m = copy.deepcopy(model)
        for layer in m.modules():
            if isinstance(layer, ReAttention):
                layer.flash_train = path != "plain"
        opt = adamw(m, 1e-4)
        steps = build_step_functions(m, opt, mse, bn_frozen=True)
        before = dict(TT.train_fwd.route_launches), dict(TT.train_bwd.route_launches)
        with held if path == "cuda_core" else contextlib.nullcontext():
            _, met = steps.train_step(TrainState.create(model=m, optimizer=opt, seed=7),
                                      {"x": x, "y": 0.9 * x})
        torch.cuda.synchronize()
        if path == "tensor_core":
            assert TT.train_fwd.route_launches == {
                **before[0], "tensor_core": before[0]["tensor_core"] + 8}
            assert TT.train_bwd.route_launches == {
                **before[1], "tensor_core": before[1]["tensor_core"] + 8}
        res[path] = (met["loss"].float(), [p.grad.float() for p in m.parameters()])
    assert _rel(res["tensor_core"][0], res["plain"][0]) <= TOL[torch.bfloat16]
    grads, held_grads = res["tensor_core"][1], res["cuda_core"][1]
    gmax = max(g.abs().max().item() for g in held_grads)
    assert max((a - b).abs().max().item() for a, b in zip(grads, held_grads)) <= 3e-2 * gmax


def test_fwd_float32_takes_the_cuda_core_route(cuda):
    args = _fwd_args(cuda, torch.float32, 2, 8, 24, 100, 100, 0.2)
    before = dict(TT.train_fwd.route_launches)
    TT.train_fwd(*args)
    torch.cuda.synchronize()
    assert TT.train_fwd.route_launches == {**before, "cuda_core": before["cuda_core"] + 1}
    with pytest.raises(RuntimeError):     # the tensor-core kernels take bfloat16 only
        TT.launch_train_fwd(*args, route="tensor_core")


# --- the frozen-BN forward's identity route (KerasMHA's training calls) -----------

# its two classes at N 256, the level-0 skip's 64 queries of 256 keys, ragged
# (partial dropout windows), a single query
IDENTITY_FWD_CASES = [(2, 8, 192, 256, 256), (2, 4, 192, 256, 256), (2, 8, 192, 64, 256),
                      (2, 8, 192, 100, 130), (2, 8, 192, 1, 49)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", IDENTITY_FWD_CASES)
def test_fwd_identity_route_matches_plain_and_the_cuda_core_route(cuda, batch, heads, dh,
                                                                  n_q, n_k, rate):
    assert TT.train_fwd_route(torch.bfloat16, heads, dh, identity_mix=True) == "identity_tc"
    q, k, v, _, _, _, seed = _train_inputs(cuda, torch.bfloat16, batch, heads, dh, n_q, n_k)
    before = TT.train_fwd.launches, dict(TT.train_fwd.route_launches)
    out, lse = TT.train_fwd_identity(q, k, v, seed, rate)
    torch.cuda.synchronize()
    assert TT.train_fwd.launches == before[0] + 1
    assert TT.train_fwd.route_launches == {
        **before[1], "identity_tc": before[1]["identity_tc"] + 1}
    want_out, want_lse = TT.train_fwd_identity_plain(q, k, v, seed, rate)
    assert _rel(out, want_out) <= TOL[torch.bfloat16]
    assert (lse - want_lse).abs().max().item() <= 1e-3
    eye, zero = torch.eye(heads, device=cuda), torch.zeros(heads, device=cuda)
    cc_out, cc_lse, _ = TT.launch_train_fwd(q, k, v, v.float().sum(1), eye, zero, seed, rate,
                                            route="cuda_core")
    torch.cuda.synchronize()
    assert _rel(out, cc_out) <= TOL[torch.bfloat16]
    assert (lse - cc_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("heads,n,head_base", [(8, 192, 0), (4, 100, 4), (8, 256, 0)])
def test_fwd_identity_dropout_bits_match_dropout_mask(cuda, heads, n, head_base):
    """q = 0 makes every probability 1/Nk, and V_h[m, d] = 1 where
    m = d mod dh, so out_h[n, d] Nk (1 - rate) counts the kept keys
    m = d mod dh of row n: each keep bit itself where Nk <= dh, drawn for
    heads head_base.. of the layer."""
    rate, dh = 0.2, 192
    q = torch.zeros(2, heads, n, dh, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(2, heads, n, dh, device=cuda).bfloat16()
    vh = (torch.arange(n, device=cuda)[:, None] % dh
          == torch.arange(dh, device=cuda)[None, :]).float()
    v = vh.repeat(1, heads).expand(2, n, heads * dh).to(torch.bfloat16).contiguous()
    seed = torch.tensor([31], device=cuda)
    out, _ = TT.train_fwd_identity(q, k, v, seed, rate, head_base=head_base)
    mask = TT.dropout_mask(31, rate, 2, heads, n, n, cuda, head_base) > 0
    want = torch.einsum("bhnm,md->bnhd", mask.float(), vh).flatten(-2)
    assert torch.equal(torch.round(out.float() * n * (1 - rate)), want)


def test_fwd_identity_route_takes_only_its_classes_in_bf16(cuda):
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _, _, _, seed = _train_inputs(cuda, dtype, 2, 8, 96, 64, 64)
        with pytest.raises(RuntimeError):     # (8, 96) is not an identity class
            TT.launch_train_fwd_identity(q, k, v, seed, 0.2)
    assert TT.train_fwd_route(torch.float32, 8, 192, identity_mix=True) == "identity_f32"
    assert TT.train_fwd_route(torch.float32, 8, 192) == "cuda_core"


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", IDENTITY_FWD_CASES)
def test_fwd_identity_f32_route_matches_plain_and_the_cuda_core_route(cuda, batch, heads, dh,
                                                                      n_q, n_k, rate):
    """Kernel 2's float32 identity route (split-precision MMAs, the
    dropout) at f32's tolerance against its plain version and route 0."""
    assert TT.train_fwd_route(torch.float32, heads, dh, identity_mix=True) == "identity_f32"
    q, k, v, _, _, _, seed = _train_inputs(cuda, torch.float32, batch, heads, dh, n_q, n_k)
    before = dict(TT.train_fwd.route_launches)
    out, lse = TT.train_fwd_identity(q, k, v, seed, rate)
    torch.cuda.synchronize()
    assert TT.train_fwd.route_launches == {
        **before, "identity_f32": before["identity_f32"] + 1}
    want_out, want_lse = TT.train_fwd_identity_plain(q, k, v, seed, rate)
    assert out.dtype == torch.float32
    assert _rel(out, want_out) <= TOL[torch.float32]
    assert _rel(lse, want_lse) <= F32_TOL[torch.float32]
    eye, zero = torch.eye(heads, device=cuda), torch.zeros(heads, device=cuda)
    cc_out, cc_lse, _ = TT.launch_train_fwd(q, k, v, v.sum(1), eye, zero, seed, rate,
                                            route="cuda_core")
    torch.cuda.synchronize()
    assert _rel(out, cc_out) <= TOL[torch.float32]
    assert _rel(lse, cc_lse) <= F32_TOL[torch.float32]


@pytest.mark.parametrize("heads,n,head_base", [(8, 192, 0), (4, 100, 4)])
def test_fwd_identity_f32_dropout_bits_match_dropout_mask(cuda, heads, n, head_base):
    """As the bf16 route's read-back, in float32."""
    rate, dh = 0.2, 192
    q = torch.zeros(2, heads, n, dh, device=cuda)
    k = torch.randn(2, heads, n, dh, device=cuda)
    vh = (torch.arange(n, device=cuda)[:, None] % dh
          == torch.arange(dh, device=cuda)[None, :]).float()
    v = vh.repeat(1, heads).expand(2, n, heads * dh).contiguous()
    seed = torch.tensor([31], device=cuda)
    out, _ = TT.train_fwd_identity(q, k, v, seed, rate, head_base=head_base)
    mask = TT.dropout_mask(31, rate, 2, heads, n, n, cuda, head_base) > 0
    want = torch.einsum("bhnm,md->bnhd", mask.float(), vh).flatten(-2)
    assert torch.equal(torch.round(out * n * (1 - rate)), want)


# --- the backward's identity routes (KerasMHA's training calls) ---------------------

# its two classes at N 256, the level-0 skip's 64 queries of 256 keys, ragged
# (partial query and key tiles, partial dropout windows), a single query
IDENTITY_BWD_CASES = [(2, 8, 192, 256, 256), (2, 4, 192, 256, 256), (2, 8, 192, 64, 256),
                      (2, 8, 192, 70, 130), (2, 4, 192, 1, 49)]


def _identity_bwd_args(cuda, dtype, batch, heads, dh, n_q, n_k, rate):
    """(q, k, v, lse, g, d, seed) as the identity Function forms them."""
    q, k, v, _, _, gout, seed = _train_inputs(cuda, dtype, batch, heads, dh, n_q, n_k)
    out, lse = TT.train_fwd_identity_plain(q, k, v, seed, rate)
    d = (gout.float() * out.float()).reshape(batch, n_q, heads, dh).sum(-1).transpose(1, 2)
    return q, k, v, lse, gout, d.contiguous(), seed


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate,head_base", [(0.0, 0), (0.2, 0), (0.2, 4)])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", IDENTITY_BWD_CASES)
def test_bwd_identity_routes_match_plain(cuda, dtype, rate, head_base, batch, heads, dh, n_q,
                                         n_k):
    """``train_bwd_identity`` on its identity route against its plain
    version (``train_bwd_plain`` with I), dq, dk, dv at the f32 outputs'
    tolerance, and against the general route with I."""
    route = TT.train_bwd_route(dtype, heads, dh, identity_mix=True)
    assert route == ("identity_f32" if dtype == torch.float32 else "identity_tc")
    q, k, v, lse, g, d, seed = _identity_bwd_args(cuda, dtype, batch, heads, dh, n_q, n_k, rate)
    before = TT.train_bwd.launches, dict(TT.train_bwd.route_launches)
    got = TT.train_bwd_identity(q, k, v, lse, g, d, seed, rate, head_base)
    torch.cuda.synchronize()
    assert TT.train_bwd.launches == before[0] + 1
    assert TT.train_bwd.route_launches == {**before[1], route: before[1][route] + 1}
    want = TT.train_bwd_identity_plain(q, k, v, lse, g, d, seed, rate, head_base)
    other = TT.launch_bwd(q, k, v, lse, g, torch.eye(heads, device=cuda), d, seed, rate,
                          route=TT.train_bwd_route(dtype, heads, dh), head_base=head_base)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, other):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= F32_TOL[dtype]
        assert _rel(a, c) <= F32_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [8, 4])
def test_identity_function_gradients_match_float64_autograd(cuda, dtype, heads):
    """The identity Function on both identity routes (forward and
    backward), rate 0.2: out and the gradients of q, k, v against torch
    autograd of the N x N forward with I and 0 and the same mask, in
    float64 (f32 1e-3, bf16 3e-2 of the largest entry)."""
    n, dh, rate = 256, 192, 0.2
    q, k, v, _, _, gout, seed = _train_inputs(cuda, dtype, 2, heads, dh, n, n)
    eye, zero = torch.eye(heads, device=cuda), torch.zeros(heads, device=cuda)
    mask = TT.dropout_mask(99, rate, 2, heads, n, n, cuda)
    kl = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    rl = [t.detach().double().requires_grad_() for t in (q, k, v)]
    before = dict(TT.train_bwd.route_launches)
    got = TT.flash_reattention_train(*kl, eye, zero, seed, num_heads=heads, rate=rate,
                                     identity_mix=True)
    gk = torch.autograd.grad((got * gout).sum(), kl)
    route = TT.train_bwd_route(dtype, heads, dh, identity_mix=True)
    assert TT.train_bwd.route_launches[route] == before[route] + 1
    want = TT.reattention_nxn(*rl, eye.double(), zero.double(), mask)[0]
    gr = torch.autograd.grad((want * gout.double()).sum(), rl)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    for a, b in zip((got, *gk), (want, *gr)):
        assert _rel(a, b) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", IDENTITY_BWD_CASES[::3])
def test_bwd_identity_routes_repeat_bit_for_bit(cuda, dtype, batch, heads, dh, n_q, n_k):
    """The identity routes write dq, dk and dv once each (no atomics): two
    calls on the same inputs give the same bits."""
    args = _identity_bwd_args(cuda, dtype, batch, heads, dh, n_q, n_k, 0.2)
    first = TT.launch_bwd_identity(*args, 0.2)
    again = TT.launch_bwd_identity(*args, 0.2)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_bwd_identity_routes_take_only_their_classes(cuda):
    for dtype in (torch.bfloat16, torch.float32):
        args = _identity_bwd_args(cuda, dtype, 2, 8, 96, 64, 64, 0.2)
        with pytest.raises(RuntimeError):     # (8, 96) is not an identity class
            TT.launch_bwd_identity(*args, 0.2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_identity_function_matches_the_general_function(cuda, dtype, tol):
    """flash_reattention_train with identity_mix=True (bf16: the identity
    route, no o_norm saved) against the general Function with I and 0, rate
    0.2: out and the gradients of q, k, v."""
    heads, dh, n = 8, 192, 256
    q, k, v, _, _, g_out, seed = _train_inputs(cuda, dtype, 2, heads, dh, n, n)
    eye, zero = torch.eye(heads, device=cuda), torch.zeros(heads, device=cuda)
    res = []
    for flag in (True, False):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = TT.flash_reattention_train(*leaves, eye, zero, seed, num_heads=heads, rate=0.2,
                                         identity_mix=flag)
        res.append((out.detach(), torch.autograd.grad((out.float() * g_out.float()).sum(),
                                                      leaves)))
    (out1, g1), (out0, g0) = res
    assert _rel(out1, out0) <= tol
    for a, b in zip(g1, g0):
        assert _rel(a, b) <= tol


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


# --- the QKV forms and the trainer on the card ----------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("e,n", [(192, 784), (768, 196), (3072, 49)])
def test_qkv_forms_agree_on_the_card(cuda, dtype, tol, e, n):
    """The conv form and the dense (E, E) operator's form of one layer's
    Q/K/V, self- and cross-attention, and the conv weights' gradients, at
    base's level widths (bf16: each form rounds its output once, from f32
    sums in another order)."""
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    layer = ReAttention(e, num_heads=8, dtype=dtype).to(cuda, dtype)
    g = torch.Generator(cuda).manual_seed(e)
    x, x2 = (torch.randn(4, n, e, generator=g, device=cuda).to(dtype) for _ in range(2))
    for args in ((x, x, x), (x2, x, x)):
        grads = []
        for form in (layer._qkv_conv, layer._qkv_matmul):
            layer.zero_grad(set_to_none=True)
            outs = form(*args)
            sum((o.float() * (i + 1)).sum() for i, o in enumerate(outs)).backward()
            grads.append((outs, [layer.qconv2d.weight.grad, layer.kconv2d.weight.grad,
                                 layer.vconv2d.weight.grad]))
        (a, ga), (b, gb) = grads
        assert max(_rel(u, v) for u, v in zip(b, a)) <= tol
        assert max(_rel(u, v) for u, v in zip(gb, ga)) <= tol


# base's level shapes (heads 8; dh 384, 96, 24 at N 4, 16, 64) at 64²
FIT_MODEL = dict(im_size=64, patch_size=32, depth=2, depth_te=1, size_bottleneck=1,
                 hidden_dim=32, dtype="bfloat16", param_dtype="bfloat16")
FIT_CALLS = 7          # re-attention calls a forward: 2 + 1 + 2 blocks, 2 skips


def _launches():
    import importlib
    T = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")
    out = {"eval": dict(TK.flash_reattention.route_launches)}
    for key, fn in (("fwd", T.train_fwd), ("bn_fwd", T.bn_fwd), ("bwd", T.train_bwd)):
        out[key] = dict(fn.route_launches)
    return out


class _EpochLaunches:
    """Launches by kernel and route in each epoch (validation included)."""

    def __init__(self):
        self.per_epoch = {}

    def on_train_begin(self, fitter): ...
    def on_train_end(self, fitter): ...

    def on_epoch_begin(self, fitter, epoch):
        self._start = _launches()

    def on_epoch_end(self, fitter, epoch, logs):
        end = _launches()
        self.per_epoch[epoch] = {k: {r: end[k][r] - self._start[k][r] for r in end[k]}
                                 for k in end}


def _fit_data(cuda, tmp_path):
    import numpy as np

    from vit_unet_tpu_torch.data import tfrecord as tfr
    from vit_unet_tpu_torch.data.loader import (
        DeviceResidentData, TFRecordStream, device_normalize, prefetch_to_device)
    rng = np.random.default_rng(0)
    clean = rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8)
    noisy = np.clip(clean + rng.normal(0, 20, clean.shape), 0, 255).astype(np.uint8)
    paths = tfr.convert(({"x": a.tobytes(), "y": b.tobytes()} for a, b in zip(noisy, clean)),
                        str(tmp_path / "shards"), "pairs_", lambda it: it)
    stream = TFRecordStream(paths, (64, 64, 3), 4, host_convert=False, shuffle_buffer=4)
    feed = lambda: prefetch_to_device(iter(stream), device=cuda, transform=device_normalize())
    resident = DeviceResidentData(noisy, clean, 4, device=cuda)
    val = DeviceResidentData(noisy[:8], clean[:8], 4, shuffle=False, device=cuda)
    return feed, resident, val


def _fitter(cuda, tmp_path, seed):
    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.train.fitter import Fitter
    model = get_vit_unet("base", seed=seed, device=cuda, **FIT_MODEL)
    return Fitter(model, bn_freeze_epochs=1, bn_warmup="refold", bn_calib_batches=2,
                  checkpoint_dir=str(tmp_path / "ckpt"), device=cuda)


def _want(frozen: bool, steps: int, val_steps: int) -> dict:
    want = {k: dict.fromkeys(counter.route_launches, 0)
            for k, counter in (("fwd", TT.train_fwd), ("bn_fwd", TT.bn_fwd),
                               ("bwd", TT.train_bwd))}
    want["eval"] = dict.fromkeys(TK.ROUTES, 0)
    want["fwd" if frozen else "bn_fwd"]["tensor_core"] = FIT_CALLS * steps
    want["bwd"]["tensor_core"] = FIT_CALLS * steps
    want["eval"]["tensor_core"] = FIT_CALLS * val_steps
    return want


def test_fitter_trains_on_the_card_through_every_kernel(cuda, tmp_path):
    """Two epochs fed from TFRecord shards through prefetch_to_device (frozen
    BN, then the refold flip and exact BN), then one fed by
    DeviceResidentData: kernel 2 then 4 in the forward, 3 in every step, 1
    in validation, all on the tensor-core routes; finite losses."""
    import math

    feed, resident, val = _fit_data(cuda, tmp_path)
    fitter = _fitter(cuda, tmp_path, 0)
    probe = _EpochLaunches()
    hist = fitter.fit(feed, val, n_epochs=2, steps_per_epoch=3, callbacks=[probe],
                      save_last=True, verbose=False)
    hist = fitter.fit(resident, val, n_epochs=3, initial_epoch=2, callbacks=[probe],
                      verbose=False)
    assert probe.per_epoch[0] == _want(True, 3, 2)
    assert probe.per_epoch[1] == _want(False, 3, 2)
    assert probe.per_epoch[2] == _want(False, 4, 2)
    assert all(math.isfinite(v) for v in hist["loss"] + hist["val_loss"])


def test_fitter_resume_round_trip_on_the_card(cuda, tmp_path):
    """A fresh Fitter (other weights) resumes bit for bit and trains on.
    (The two do not go on bit for bit: the backward sums dq by f32
    atomics.)"""
    feed, resident, val = _fit_data(cuda, tmp_path)
    first = _fitter(cuda, tmp_path, 0)
    first.fit(resident, n_epochs=1, save_last=True, save_best=False, verbose=False)
    second = _fitter(cuda, tmp_path, 1)
    second.init_state()
    assert second.resume() == 1

    def state(f):
        opt = f.optimizer.state_dict()["state"]
        return ([t for t in f.model.state_dict().values()]
                + [torch.as_tensor(v).cpu() for i in sorted(opt) for v in opt[i].values()]
                + [f.state.generator.get_state()])

    assert all(torch.equal(a, b) for a, b in zip(state(first), state(second)))
    assert first.state.step == second.state.step == 4
    hist = second.fit(val, n_epochs=2, initial_epoch=1, save_best=False, verbose=False)
    assert second.state.step == 6 and all(v == v for v in hist["loss"])


# --- the entry point: the CLI on PNG folders, export and the operator -------

def _write_png(path, rgb):
    """An 8-bit RGB PNG, rows unfiltered (the card's host has no cv2)."""
    import struct
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    h, w, _ = rgb.shape
    rows = b"".join(b"\0" + rgb[i].tobytes() for i in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _named_routes(model):
    """{kernel: the set of routes its route function names for the model's
    re-attention layers} (bf16)."""
    import importlib
    T = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    shapes = {(m.num_heads, m.dim // m.num_heads) for m in model.modules()
              if isinstance(m, ReAttention)}
    assert shapes and all(TK.kernel_takes(h, d) for h, d in shapes)
    bf = torch.bfloat16
    return {"eval": {TK.kernel_route(bf, h, d) for h, d in shapes},
            "bn_fwd": {T.bn_fwd_route(bf, h, d) for h, d in shapes},
            "bwd": {T.train_bwd_route(bf, h, d) for h, d in shapes}}


def test_cli_trains_lite_from_pngs_on_the_card(cuda, tmp_path):
    """One exact-BN epoch of the CLI's default model with --flash on a PNG
    folder: every launch on the route its route function names."""
    import math

    import numpy as np

    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.cli import run_denoising

    rng = np.random.default_rng(0)
    for d in ("clean", "noisy"):
        (tmp_path / d).mkdir()
    for i in range(8):
        clean = rng.integers(0, 256, (72, 72, 3), dtype=np.uint8)
        _write_png(tmp_path / "clean" / f"{i}.png", clean)
        _write_png(tmp_path / "noisy" / f"{i}.png", 255 - clean)
    before = _launches()
    result = run_denoising.main([
        "--input_folder", str(tmp_path), "--im_size", "64", "--batch_size", "2",
        "--n_epochs", "1", "--dtype", "bfloat16", "--flash",
        "--checkpoint_dir", str(tmp_path / "models")])
    after = _launches()
    assert all(math.isfinite(v) for v in result.values())
    assert (tmp_path / "models" / "fold0" / "best-checkpoint.pt").is_file()
    named = _named_routes(get_vit_unet("lite", device="meta", im_size=64))
    for key, routes in named.items():
        delta = {r: after[key][r] - before[key][r] for r in after[key]}
        assert sum(delta.values()) > 0
        assert all(n == 0 for r, n in delta.items() if r not in routes), (key, delta)
    assert after["fwd"] == before["fwd"]        # no frozen-BN epoch


def test_exported_program_matches_predictor_on_the_card(cuda, tmp_path):
    """export_predictor / load_predictor on the card: kernel 1 runs through
    the registered operator, outputs bit for bit Predictor's."""
    import numpy as np

    from vit_unet_tpu_torch import Predictor, get_vit_unet
    from vit_unet_tpu_torch.serving import export_predictor, load_predictor
    model = get_vit_unet("base", seed=0, device=cuda, **FIT_MODEL)
    x = np.random.default_rng(0).random((6, 3, 64, 64), dtype=np.float32)
    want = Predictor(model, batch_size=4)(x)
    export_predictor(model, str(tmp_path), batch_size=4)
    loaded = load_predictor(str(tmp_path))
    before = _launches()["eval"]
    got = loaded(x)
    torch.cuda.synchronize()
    after = _launches()["eval"]
    assert after["tensor_core"] - before["tensor_core"] == 2 * FIT_CALLS
    assert after["cuda_core"] == before["cuda_core"]
    np.testing.assert_array_equal(got, want)


def test_operator_launches_the_kernel_and_counts(cuda):
    q, k, v, w, b = _eval_inputs(cuda, torch.bfloat16, 2, 8, 96, 196, 196)
    launches = TK.flash_reattention.launches
    tc = TK.flash_reattention.route_launches["tensor_core"]
    got = torch.ops.vit_unet_tpu_torch.flash_reattention(q, k, v, w, b, 8)
    torch.cuda.synchronize()
    assert TK.flash_reattention.launches == launches + 1
    assert TK.flash_reattention.route_launches["tensor_core"] == tc + 1
    want = TK.flash_reattention_plain(q, k, v, w, b, num_heads=8)
    assert _rel(got, want) <= TOL[torch.bfloat16]
    with pytest.raises(ValueError, match="heads"):
        torch.ops.vit_unet_tpu_torch.flash_reattention(q, k, v, w, b, 4)


# --- the TF-flavour family ------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n_q,n_k", [(256, 256), (64, 256)])
def test_keras_mha_kernels_match_plain_with_dropout(cuda, dtype, tol, n_q, n_k):
    """KerasMHA at the default model's level-0 shape (8 heads x 192): the
    kernel branch (kernels 2 and 3 in training, 1 in eval) against the
    plain branch on the card, dropout 0.2 from the same generator seed."""
    from vit_unet_tpu_torch.kernels import flash_reattention_train as T
    from vit_unet_tpu_torch.nn.mha import KerasMHA
    dim = 192
    mods = {}
    for flash in (True, False):
        torch.manual_seed(0)
        mods[flash] = KerasMHA(dim, 8, key_dim=192, dropout=0.2, use_flash=flash,
                               dtype=dtype).to(cuda)
    g = torch.Generator().manual_seed(1)
    q_in = torch.randn(2, n_q, dim, generator=g).to(cuda)
    v_in = torch.randn(2, n_k, dim, generator=g).to(cuda)
    outs, grads = {}, {}
    for flash, mod in mods.items():
        before = (TK.flash_reattention.launches, T.train_fwd.launches,
                  T.train_bwd.launches)
        with torch.no_grad():
            ev = mod(q_in, v_in)
        out = mod(q_in, v_in, deterministic=False,
                  generator=torch.Generator(device=cuda).manual_seed(3))
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        after = (TK.flash_reattention.launches, T.train_fwd.launches,
                 T.train_bwd.launches)
        assert [a - b for a, b in zip(after, before)] == ([1, 1, 1] if flash else [0, 0, 0])
        outs[flash] = (ev, out.detach())
        grads[flash] = [p.grad for p in mod.parameters()]
    for got, want in zip(outs[True], outs[False]):
        assert _rel(got, want) <= tol
    # against the largest gradient: the key bias's is zero up to rounding
    # (a shift of every key moves each row's scores alike)
    gmax = max(g.float().abs().max().item() for g in grads[False])
    for got, want in zip(grads[True], grads[False]):
        assert (got.float() - want.float()).abs().max().item() <= tol * gmax


def test_hvit_unet_tf_serves_and_trains_on_the_card(cuda):
    """A small HViTUNetTF (levels at key_dim 192 / 768, level 0 on the
    kernels) in f32: eval and one train step against use_flash=False."""
    from vit_unet_tpu_torch import Predictor, get_hvit_unet_tf
    from vit_unet_tpu_torch.nn.mha import KerasMHA
    cfg = dict(img_size=64, patch_size=(8, 16), transformer_layers=(1,),
               size_bottleneck=1, drop_attn=0.0, drop_proj=0.0, drop_linear=0.0)
    model = get_hvit_unet_tf(device=cuda, seed=0, **cfg)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    served = torch.from_numpy(Predictor(model, batch_size=2)(x.numpy()))
    xc = x.to(cuda)
    res = []
    for flash in (True, False):
        for m in model.modules():
            if isinstance(m, KerasMHA):
                m.use_flash = flash
        with torch.no_grad():
            ev = model(xc)
        model.zero_grad(set_to_none=True)
        model(xc, deterministic=False).square().sum().backward()
        res.append((ev, [p.grad.clone() for p in model.parameters()]))
    (ev1, g1), (ev0, g0) = res
    assert _rel(ev1 - xc, ev0 - xc) <= 1e-4
    assert _rel(served.to(cuda) - xc, ev1 - xc) <= 1e-5
    gmax = max(g.abs().max().item() for g in g0)
    assert max((a - b).abs().max().item() for a, b in zip(g1, g0)) <= 1e-4 * gmax


def test_exported_hvit_unet_tf_takes_the_identity_route(cuda, tmp_path):
    """A small bf16 HViTUNetTF (level 0 at (8, 192) on the kernels, level 1
    wider than they take) exported and loaded onto the card: every kernel-1
    launch of the loaded program is on the identity route, and its output
    is Predictor's bit for bit."""
    import numpy as np

    from vit_unet_tpu_torch import Predictor, get_hvit_unet_tf
    from vit_unet_tpu_torch.serving import export_predictor, load_predictor
    cfg = dict(img_size=64, patch_size=(8, 16), transformer_layers=(1,),
               size_bottleneck=1, dtype="bfloat16", param_dtype="bfloat16")
    model = get_hvit_unet_tf(device=cuda, seed=0, **cfg)
    x = np.random.default_rng(0).standard_normal((3, 64, 64, 3)).astype(np.float32)
    want = Predictor(model, batch_size=2)(x)
    export_predictor(model, str(tmp_path), batch_size=2)
    loaded = load_predictor(str(tmp_path))
    before = dict(TK.flash_reattention.route_launches)
    got = loaded(x)
    torch.cuda.synchronize()
    after = dict(TK.flash_reattention.route_launches)
    assert after["identity_tc"] > before["identity_tc"]
    assert {r: after[r] - before[r] for r in ("cuda_core", "tensor_core")} == {
        "cuda_core": 0, "tensor_core": 0}
    np.testing.assert_array_equal(got, want)


class _BackwardReplay:
    """Stands in for ``launch_bwd``, the kernel backward's one launch.  The
    first run keeps each launch's inputs and outputs; the second runs each
    launch too, and where its inputs equal an unused kept launch's bit for
    bit returns that launch's outputs (``unmatched`` counts the others).
    Only the dq atomics' summation order, which varies from run to run, is
    taken out of the backward so."""

    def __init__(self):
        self.launch, self.kept, self.replaying = TT.launch_bwd, [], False
        self.used, self.unmatched = set(), 0

    def __call__(self, *args, **kwargs):
        out = self.launch(*args, **kwargs)
        flat = [a for x in list(args) + sorted(kwargs.items())
                for a in (x if isinstance(x, tuple) else (x,))]
        inputs = [a.detach().clone() if torch.is_tensor(a) else a for a in flat]
        if not self.replaying:
            self.kept.append((inputs, tuple(t.clone() for t in out)))
            return out
        same = lambda a, b: len(a) == len(b) and all(
            torch.equal(x, y) if torch.is_tensor(x) and torch.is_tensor(y)
            else (not torch.is_tensor(x) and not torch.is_tensor(y) and x == y)
            for x, y in zip(a, b))
        for i, (kept_in, kept_out) in enumerate(self.kept):
            if i not in self.used and same(kept_in, inputs):
                self.used.add(i)
                return tuple(t.clone() for t in kept_out)
        self.unmatched += 1
        return out


def test_remat_step_matches_no_remat_on_the_card(cuda):
    """A lite ViTUNet at 64² in f32 with dropout, one exact-BN step: remat
    leaves the loss, running statistics, generator state and gradients as
    they were, bit for bit.  Two things vary from run to run in f32 and a
    fresh model's exact-BN step magnifies them (to 1.4e-4 of the largest
    gradient between remat and no remat on the f32 tensor-core route at
    lite's classes, measured on an H100): the backward's dq, summed by f32
    atomics, and cuDNN's choice of f32 convolution algorithms.  So both
    steps run with cuDNN's deterministic algorithms, and the backward is
    made repeatable: the remat step's backward launches, whose inputs (the
    recomputed q, k, v_cat, lse and seed among them) must each equal a
    launch of the no-remat step bit for bit, return that launch's
    outputs."""
    from unittest import mock

    from vit_unet_tpu_torch import get_vit_unet
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0)).to(cuda)
    replay = _BackwardReplay()
    res = []
    with mock.patch.object(TT, "launch_bwd", replay), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        for remat in (False, True):
            replay.replaying = remat
            model = get_vit_unet("lite", device=cuda, seed=0, im_size=64, remat=remat)
            opt = adamw(model)
            steps = build_step_functions(model, opt, mse)
            state, m = steps.train_step(TrainState.create(model=model, optimizer=opt,
                                                          seed=1), {"x": x, "y": 0.9 * x})
            res.append((m["loss"].item(), [p.grad.clone() for p in model.parameters()],
                        [b.clone() for b in model.buffers()], state.generator.get_state()))
    (l0, g0, b0, s0), (l1, g1, b1, s1) = res
    assert l1 == l0 and torch.equal(s1, s0)
    assert all(torch.equal(a, b) for a, b in zip(b1, b0))
    assert replay.kept and replay.unmatched == 0 and len(replay.used) == len(replay.kept)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 2e-2)])
def test_classifier_serves_and_trains_against_its_plain_path(cuda, dtype, tol):
    """The classifier at the CLI's widths (224², patch 16, 16 heads: levels
    (16, 48) at N 196 and (16, 12) at N 784), one block a level: eval
    logits, and one train step's loss and running statistics (and in
    float32 its gradients), exact and frozen BN with dropout on, against
    the same model with every layer on the plain path; the same weights
    and dropout seed give the same masks on both."""
    import copy

    from vit_unet_tpu_torch import get_vit_classifier
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, build_step_functions)
    from vit_unet_tpu_torch.train.losses import categorical_crossentropy

    model = get_vit_classifier(device=cuda, seed=0, num_patches=196, depth_te=1,
                               dtype=dtype, param_dtype=dtype)
    layers = lambda mod: [x for x in mod.modules() if isinstance(x, ReAttention)]
    assert all(x._kernels for x in layers(model)) and len(layers(model)) == 2
    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.rand(4, 3, 224, 224, generator=gen, device=cuda)
    y = torch.eye(4, device=cuda)[torch.tensor([0, 3, 1, 2], device=cuda)]
    before = TK.flash_reattention.launches
    with torch.inference_mode():
        got = model(x).float()
        torch.cuda.synchronize()
        assert TK.flash_reattention.launches == before + 2
        for layer in layers(model):
            layer.use_flash = False
        want = model(x).float()
        for layer in layers(model):
            layer.use_flash = True
    assert _rel(got, want) <= tol

    loss = lambda logits, target: categorical_crossentropy(logits, target, 0.05)
    for frozen in (False, True):
        results = []
        for flash in (True, False):
            m = copy.deepcopy(model).train()
            for layer in layers(m):
                layer.flash_train = flash
            opt = torch.optim.Adam(m.parameters(), 1e-4)
            steps = build_step_functions(m, opt, loss, bn_frozen=frozen)
            _, met = steps.train_step(TrainState.create(model=m, optimizer=opt, seed=7),
                                      {"x": x, "y": y})
            results.append((met["loss"].float(),
                            torch.cat([p.grad.float().flatten() for p in m.parameters()]),
                            torch.cat([b.float() for n, b in m.named_buffers()
                                       if "running" in n])))
        (kl, kg, ks), (pl, pg, ps) = results
        assert _rel(kl, pl) <= tol and _rel(ks, ps) <= tol
        if dtype == "float32":
            assert _rel(kg, pg) <= tol


# --- sequence parallelism: the shard shapes, and the plain paths' dropout -------

# base at 512² split over two ranks: each rank's query rows (Nq = N / 2)
# against every key, at the levels that shard (N 1024, dh 96; N 4096, dh 24)
SP_SHARD_CASES = [(2, 8, 96, 512, 1024), (2, 8, 24, 2048, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,heads,dh,n_q,n_k", SP_SHARD_CASES)
def test_four_kernels_at_sequence_parallel_shard_shapes(cuda, dtype, rate, batch,
                                                        heads, dh, n_q, n_k):
    """Kernels 1-4 at the rectangular calls of a sequence-parallel shard,
    each on the route its function names, against their plain versions."""
    args = _eval_inputs(cuda, dtype, batch, heads, dh, n_q, n_k)
    got = TK.flash_reattention(*args, num_heads=heads)
    assert _rel(got, TK.flash_reattention_plain(*args, num_heads=heads)) <= TOL[dtype]
    q, k, v, m, c, gout, seed = _train_inputs(cuda, dtype, batch, heads, dh, n_q, n_k)
    vsum = v.float().sum(1)
    for a, b, tol in zip(TT.train_fwd(q, k, v, vsum, m, c, seed, rate),
                         TT.train_fwd_plain(q, k, v, vsum, m, c, seed, rate),
                         (TOL, F32_TOL, TOL)):
        assert _rel(a, b) <= tol[dtype]
    want = TT.bn_fwd_plain(q, k, v, seed, rate)
    for a, b, tol in zip(TT.bn_fwd(q, k, v, seed, rate), want,
                         (F32_TOL, F32_TOL, F32_TOL, TOL)):
        assert _rel(a, b) <= tol[dtype]
    d = torch.randn(batch, heads, n_q, device=cuda)
    extra = (torch.randn(heads, heads, device=cuda) * 0.1,
             torch.randn(heads, device=cuda) * 0.1)
    for bn_extra in (None, extra):
        for a, b in zip(TT.train_bwd(q, k, v, want[2], gout, m, d, seed, rate, bn_extra),
                        TT.train_bwd_plain(q, k, v, want[2], gout, m, d, seed, rate,
                                           bn_extra)):
            assert _rel(a, b) <= F32_TOL[dtype]


def test_plain_train_paths_draw_dropout_without_a_host_sync(cuda):
    """The plain N x N paths of ReAttention and KerasMHA draw their dropout
    mask from the seed tensor on the card: a training forward and backward
    with any synchronisation an error; the mask is the int seed's, bit for
    bit."""
    from vit_unet_tpu_torch.nn.mha import KerasMHA
    from vit_unet_tpu_torch.nn.reattention import ReAttention
    seed = torch.tensor([2 ** 40 + 7], dtype=torch.int64, device=cuda)
    want = TT.dropout_mask(2 ** 40 + 7, 0.2, 2, 4, 70, 130, cuda)
    torch.manual_seed(0)
    mods = [ReAttention(48, num_heads=4, attn_drop=0.2, flash_train=False).to(cuda),
            KerasMHA(48, 4, key_dim=12, dropout=0.2, use_flash=False).to(cuda)]
    x = torch.randn(2, 64, 48, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = TT.dropout_mask(seed, 0.2, 2, 4, 70, 130)
        mods[0](x, deterministic=False, use_running_average=False,
                generator=gen).square().sum().backward()
        mods[1](x, x, deterministic=False, generator=gen).square().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    assert all(torch.isfinite(p.grad).all() for mod in mods for p in mod.parameters())
