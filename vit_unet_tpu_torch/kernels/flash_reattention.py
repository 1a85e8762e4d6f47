"""Eval flash re-attention: the hand-written Hopper kernel, its plain
PyTorch version, and the head-mix folding around them.

Counterpart of ``vit_unet_tpu/kernels/flash_reattention.py``.  The function
is ReAttention's eval contraction without the (N, N) map in device memory:

    attn_h  = softmax(q_h @ k_h^T)            (q pre-scaled by qk_scale)
    attn'_h = sum_h2 M[h, h2] * attn_h2 + c[h] (1x1 head-mix conv + eval
                                               BatchNorm, folded into M, c)
    out_h   = attn'_h @ v_h

The kernel (``csrc/flash_reattention.cu``) replaces the Pallas TPU kernel
``flash_reattention`` (body ``_kernel``).  With a head mix it runs in two
passes (per-row log-sum-exp, then the head-mixed probabilities @ V), which
keeps a block's state to (rows x dh) accumulators instead of the TPU form's
(H, bq, H*dh) one, but at lite's float32 classes in the TPU form's one
pass.  It has five routes, and ``kernel_route`` names the one a call takes
from the input dtype, (heads, dh) and the caller's ``identity_mix`` flag,
nothing else:

* ``identity_tc`` (``csrc/attention_identity_tc.cuh``): bfloat16 inputs at
  ``IDENTITY_TC_SHAPES`` (HViTUNetTF's level-0 keras attention, 8 heads x
  dh 192, and a tensor-parallel rank's 4 of them) where the caller passes
  ``identity_mix=True``, promising M = I and c = 0 (``KerasMHA`` does, by
  construction).  The function is then plain attention of each head, and
  the route runs it in one pass (online softmax, no log-sum-exp pass, no
  mix), both products as bf16 MMAs; it does not read ``w`` and ``b``.
* ``identity_f32`` (``csrc/attention_identity_f32.cuh``): the same calls in
  float32, the same one pass with output and lse in f32.  Each f32 operand
  is carried as a pair of bf16 values hi + lo, and each product takes three
  bf16 MMAs (lo hi, hi lo, hi hi; lo lo is left out): the products are good
  to about 2^-16 of their size, the precision of three bf16 passes rather
  than f32's 2^-24, inside the f32 tolerance of 1e-4 of max|plain|.  No
  single TF32 or bf16 product is issued.
* ``tensor_core`` (``csrc/reattention_tc.cuh``): bfloat16 inputs at the
  shape classes of ``TENSOR_CORE_SHAPES`` (every level of the presets, the
  classifier's two 16-head levels and HViTUNetTF's level-0 keras attention,
  8 heads x dh 192).  Both products are bf16 MMAs with
  f32 accumulators, tiles are staged over the whole head dim by asynchronous
  copies into two buffers, every score tile is computed once, and the mixed
  probabilities are rounded to bf16 once before the product with V, as the
  TPU kernel rounds them.  What bounds it on the H100 is the per-entry work
  between the products (exp, the H x H mix, shared-memory trips), not the
  MMAs or the bytes; the header of the source has the budget per class.
* ``tensor_core_f32`` (``csrc/reattention_bnfwd_tc.cuh``'s
  ``eval_fwd_tc_f32``): float32 inputs at ``TENSOR_CORE_F32_SHAPES``, lite's
  levels (4, 12), (4, 48), (4, 192), without the identity flag (with it
  (4, 192) takes ``identity_f32``).  Kernel 1 is the frozen-BN training
  forward's function at dropout rate 0, ``out = sum_h2 M o_norm_h2 + c
  vsum``, so the route runs that forward's f32 sweep in one pass, as the
  TPU kernel does (online softmax, f32 accumulators of all heads' columns,
  the mix at the end, ``vsum`` summed outside), with no dropout draw and no
  o_norm stores: q, K, A and V_cat carried as bf16 triples hi, mid, lo,
  every product as six bf16 MMAs, about f32's own rounding.  The wrapper
  passes ``vsum`` and the compact M and c; ``w`` and ``b`` are not read.
* ``cuda_core`` (``csrc/flash_reattention.cu``): float32 inputs without
  the identity flag at other shapes, and bfloat16 at any other shape.
  Every product is an f32 FMA, so float32 is computed in full float32;
  shared-memory loads and barrier round trips bound it, far above its
  operation count.

On a CPU tensor ``flash_reattention`` runs ``flash_reattention_plain``; on a
CUDA tensor it launches the kernel or raises.  An exported program
records the call as the operator ``vit_unet_tpu_torch::flash_reattention``
(``flash_reattention_op``), which decides by the tensors' device when it
runs, so the program carries the kernel to the card and the plain version
to the CPU.
"""
from __future__ import annotations

import ctypes

import torch

SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEADS = 16
MAX_HEAD_DIM = 384
# the C interface's route 0, 1, 2, 3, 4
ROUTES = ("cuda_core", "tensor_core", "identity_tc", "identity_f32", "tensor_core_f32")
#: routes that run the function in one pass: ``launch_passes`` takes passes=3 only
ONE_PASS_ROUTES = frozenset({"identity_tc", "identity_f32", "tensor_core_f32"})
#: (heads, dh) classes the tensor-core kernels are built for: the level
#: shapes of the lite, base, large and notebook512 presets, the classifier's
#: two 16-head levels and HViTUNetTF's level-0 keras attention, (8, 192)
TENSOR_CORE_SHAPES = frozenset({
    (8, 384), (8, 192), (8, 96), (8, 24), (4, 192), (4, 48), (4, 12), (16, 48),
    (16, 12)})
#: (heads, dh) classes of the identity-mix routes (bfloat16 and float32):
#: HViTUNetTF's level-0 keras attention and a rank's heads of it at model 2
IDENTITY_TC_SHAPES = frozenset({(8, 192), (4, 192)})
#: (heads, dh) classes of the float32 tensor-core routes, lite's levels: kernel
#: 1's here, and the one set of the three training kernels' f32 routes
TENSOR_CORE_F32_SHAPES = frozenset({(4, 12), (4, 48), (4, 192)})


def kernel_takes(heads: int, dh: int) -> bool:
    """Whether a re-attention call of (heads, dh) runs the kernels (eval
    and training) or the plain path: the one place the choice is made, by
    shape alone, against the kernels' own limits.  Every level of the
    presets is inside them; a wider shape (say dh 1536 at ``im_size=256,
    patch_size=64``) takes the plain path, as the JAX module's
    ``_flash_ok`` sends its wide shapes to XLA.  There is no token floor:
    the kernels run at any N."""
    return 1 <= heads <= MAX_HEADS and 1 <= dh <= MAX_HEAD_DIM


def kernel_route(dtype: torch.dtype, heads: int, dh: int,
                 identity_mix: bool = False) -> str:
    """The route a CUDA call with these inputs takes: the only place it is
    chosen, by dtype, shape and the caller's ``identity_mix`` flag alone
    (never by reading the head mix)."""
    if identity_mix and (heads, dh) in IDENTITY_TC_SHAPES:
        if dtype == torch.bfloat16:
            return "identity_tc"
        if dtype == torch.float32:
            return "identity_f32"
    if dtype == torch.bfloat16 and (heads, dh) in TENSOR_CORE_SHAPES:
        return "tensor_core"
    if dtype == torch.float32 and (heads, dh) in TENSOR_CORE_F32_SHAPES:
        return "tensor_core_f32"
    return "cuda_core"


def fold_reattention_compact(conv_weight, conv_bias, bn_weight, bn_bias,
                             bn_mean, bn_var, *, eps: float = 1e-5,
                             reatten_scale: float = 1.0):
    """Fold the 1x1 head-mix conv + eval BatchNorm into the compact (H, H)
    ``m_eff`` and (H,) ``c_eff``: attn'_h = sum_h2 m_eff[h, h2] attn_h2 + c_eff[h].

    ``conv_weight`` is torch's (H_out, H_in, 1, 1) layout or an (H, H) [h, h2]
    matrix.  Computed in float32 (float64 inputs stay float64).
    """
    f = lambda t: t if t.dtype == torch.float64 else t.float()
    m = f(conv_weight)
    if m.ndim == 4:
        m = m[:, :, 0, 0]
    a = f(bn_weight) / torch.sqrt(f(bn_var) + eps)
    c = (f(bn_bias) - a * f(bn_mean)) + a * f(conv_bias)
    return (a[:, None] * m) * reatten_scale, c * reatten_scale


def expand_reattention_affine(m_eff, c_eff, *, dh: int):
    """Compact (H, H)/(H,) affine -> the epilogue layout: w (H, H*dh) with
    w[h2, p] = m_eff[head_of(p), h2]; b (H*dh,) = c_eff[head_of(p)]."""
    return (torch.repeat_interleave(m_eff.t(), dh, dim=1),
            torch.repeat_interleave(c_eff, dh))


def _compact_from_expanded(w, b, dh: int):
    """Inverse of ``expand_reattention_affine``: the kernel reads the first
    column of each head's slice, and so does the plain version."""
    return w[:, ::dh].t().float(), b[::dh].float()


def flash_reattention_plain(q, k, v_cat, w, b, *, num_heads: int):
    """The plain PyTorch version: softmax, head-mix, product with V, in
    float32 with the N x N map materialised; output in q's dtype."""
    batch, heads, n_q, dh = q.shape
    n_k = k.shape[2]
    m_eff, c_eff = _compact_from_expanded(w, b, dh)
    attn = torch.softmax(
        torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()), dim=-1)
    attn = torch.einsum("gh,bhnm->bgnm", m_eff, attn) + c_eff[None, :, None, None]
    v = v_cat.float().reshape(batch, n_k, heads, dh)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
    return out.reshape(batch, n_q, heads * dh).to(q.dtype)


def _check(q, k, v_cat, w, b, num_heads: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v_cat.ndim != 3:
        raise ValueError("expected q, k (B, H, N, dh) and v_cat (B, N, H*dh)")
    batch, heads, n_q, dh = q.shape
    n_k = k.shape[2]
    if heads != num_heads:
        raise ValueError(f"q has {heads} heads, num_heads={num_heads}")
    if k.shape != (batch, heads, n_k, dh):
        raise ValueError(f"k shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if v_cat.shape != (batch, n_k, heads * dh):
        raise ValueError(f"v_cat shape {tuple(v_cat.shape)}, expected "
                         f"{(batch, n_k, heads * dh)}")
    if w.shape != (heads, heads * dh) or b.shape != (heads * dh,):
        raise ValueError("w must be (H, H*dh) and b (H*dh,)")
    tensors = (q, k, v_cat, w, b)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must lie on one device")
    if q.device.type != "cuda":
        return
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or v_cat.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v_cat.dtype}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("w and b must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous inputs")
    if heads > MAX_HEADS or dh > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes at most {MAX_HEADS} heads and "
                         f"head dim {MAX_HEAD_DIM}, got H={heads}, dh={dh}")
    if batch > 65535:
        raise ValueError("the kernel takes a batch of at most 65535")


def _library():
    from vit_unet_tpu_torch.kernels import _build
    lib = _build.load("flash_reattention.cu")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vit_flash_reattention.argtypes = [p] * 10 + [i] * 8 + [p]
        lib.vit_flash_reattention.restype = i
        lib.vit_cuda_error_string.argtypes = [i]
        lib.vit_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def launch_passes(q, k, v_cat, w, b, lse, out, *, route: str, passes: int = 3):
    """Launch the kernels of ``route`` on checked CUDA inputs, into the
    caller's ``lse`` (B, H, N_q) f32 and ``out``.  ``passes``: bit 0 the
    log-sum-exp pass, bit 1 the output pass, which reads ``lse``; the
    one-pass routes (``ONE_PASS_ROUTES``) take 3 only and do not read ``w``
    and ``b``: the identity routes' mix is the identity, and
    ``tensor_core_f32`` takes ``vsum`` (sum over the keys of ``v_cat``) and
    the compact M and c, formed here.  Only the measurements and the
    route-against-route tests name a route or a pass themselves; it counts
    no launch."""
    batch, heads, n_q, dh = q.shape
    if route in ONE_PASS_ROUTES and passes != 3:
        raise ValueError(f"the {route} route runs in one pass: passes=3")
    if route != "cuda_core" and any(t.data_ptr() % 16 for t in (q, k, v_cat, out)):
        raise ValueError("the tensor-core routes copy 16 bytes at a time: q, "
                         "k, v_cat and out must start at 16-byte aligned addresses")
    mix = (None, None, None)
    if route == "tensor_core_f32":
        m_eff, c_eff = _compact_from_expanded(w, b, dh)
        mix = (v_cat.float().sum(1), m_eff.contiguous(), c_eff.contiguous())
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vit_flash_reattention(
            q.data_ptr(), k.data_ptr(), v_cat.data_ptr(), w.data_ptr(),
            b.data_ptr(), *(t if t is None else t.data_ptr() for t in mix),
            lse.data_ptr(), out.data_ptr(), batch, heads, n_q, k.shape[2], dh,
            SUPPORTED_DTYPES[q.dtype], ROUTES.index(route), passes, stream)
    if rc:
        raise RuntimeError(f"flash_reattention kernel launch failed ({route}): "
                           + lib.vit_cuda_error_string(rc).decode())


def _launch(q, k, v_cat, w, b, identity_mix=False):
    """The kernel on checked CUDA inputs, on the route ``kernel_route``
    names, counted by route."""
    batch, heads, n_q, dh = q.shape
    out = torch.empty((batch, n_q, heads * dh), dtype=q.dtype, device=q.device)
    if batch == 0 or n_q == 0:
        return out
    lse = torch.empty((batch, heads, n_q), dtype=torch.float32, device=q.device)
    route = kernel_route(q.dtype, heads, dh, identity_mix)
    launch_passes(q, k, v_cat, w, b, lse, out, route=route)
    flash_reattention.launches += 1
    flash_reattention.route_launches[route] += 1
    return out


@torch.library.custom_op("vit_unet_tpu_torch::flash_reattention",
                         mutates_args=(), device_types="cpu")
def flash_reattention_op(q: torch.Tensor, k: torch.Tensor,
                         v_cat: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor, num_heads: int,
                         identity_mix: bool = False) -> torch.Tensor:
    """Kernel 1 as a registered operator, so that an exported program
    (``serving.export_predictor``) records it, with ``identity_mix``, and
    runs it where it is loaded: the kernel on CUDA tensors, on the route
    ``kernel_route`` names, the plain version on CPU ones."""
    return flash_reattention_plain(q, k, v_cat, w, b, num_heads=num_heads)


@flash_reattention_op.register_kernel("cuda")
def _(q, k, v_cat, w, b, num_heads, identity_mix=False):
    _check(q, k, v_cat, w, b, num_heads)
    return _launch(q, k, v_cat, w, b, identity_mix)


@flash_reattention_op.register_fake
def _(q, k, v_cat, w, b, num_heads, identity_mix=False):
    batch, heads, n_q, dh = q.shape
    return q.new_empty((batch, n_q, heads * dh))


def flash_reattention(q, k, v_cat, w, b, *, num_heads: int,
                      identity_mix: bool = False):
    """Eval re-attention, (B, N_q, H*dh) in q's dtype.

    q: (B, H, N_q, dh), pre-scaled; k: (B, H, N_k, dh); v_cat: (B, N_k, H*dh)
    with the heads concatenated; w: (H, H*dh) and b: (H*dh,) the expanded
    head-mix affine (``expand_reattention_affine``).  N_q may differ from
    N_k.  ``identity_mix``: the caller's promise that w and b are the
    identity affine (M = I, c = 0); it lets ``kernel_route`` name a
    one-pass identity route, which does not read them.  CPU tensors take the
    plain version; CUDA tensors the kernel, on the route ``kernel_route``
    names.

    An export records the call as ``flash_reattention_op``.  An eager call
    skips the operator's dispatch, which is host time (on the H100, 0.7-2.9
    ms of a base b64 bf16 forward's 12 calls in one run of
    ``chip_smoke.py`` phase 6, none measurable in another), and on CPU
    tensors the plain version keeps its autograd.
    """
    _check(q, k, v_cat, w, b, num_heads)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash_reattention for device {q.device}")
    if torch.compiler.is_exporting():
        return flash_reattention_op(q, k, v_cat, w, b, num_heads, identity_mix)
    if q.device.type == "cpu":
        return flash_reattention_plain(q, k, v_cat, w, b, num_heads=num_heads)
    return _launch(q, k, v_cat, w, b, identity_mix)


#: kernel launches since the last reset (the plain version does not count),
#: in all and by route
flash_reattention.launches = 0
flash_reattention.route_launches = dict.fromkeys(ROUTES, 0)
