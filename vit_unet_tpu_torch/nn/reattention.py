"""Re-attention (DeepViT-style) with conv-QKV in patch space.

Counterpart of ``vit_unet_tpu/nn/reattention.py``.  Q/K/V come from per-patch
CxC convolutions on the image form of each token, in one of two forms that
compute the same function: one conv over the fused (B*N) batch, or one
product of the tokens with the conv written as a dense (E, E) operator
(``conv_token_matrix``); ``qkv_form`` picks the form by width and dtype.
A token is read channel-major (``token_layout="cm"``, the torch flavour) or
channels-last (``"cl"``, the TF flavour, which also puts an exact GELU
after each of Q, K and V: ``qkv_gelu``).
Attention is scaled-dot softmax, re-mixed across heads by a 1x1 conv
followed by BatchNorm, then multiplied with V.

Eval folds both head-mix layers into one (H, H) affine and runs
``flash_reattention``.  Training runs the training kernels
(``kernels/flash_reattention_train.py``) with attention dropout inside them:
exact batch-statistics BatchNorm by default, the frozen running statistics
for ``use_running_average=True`` or ``flash_frozen_bn``, and the ``bn_track``
mode (frozen forward, running statistics pulled toward each batch).  On the
card the kernels run, on the CPU their plain versions.  ``flash_train=False``
(or ``use_flash=False``) runs the plain N x N path, whose dropout draws the
same mask.

On a mesh (``parallel/mesh.py``), a layer with ``sequence_parallel`` and at
least ``sp_min_tokens`` tokens splits its tokens over the mesh's ``model``
axis (``parallel/sequence.py``), and, inside a step whose batch is split
over ``data`` (``use_mesh``), every layer takes its exact-BN moments over
the whole batch, as the JAX package's one program over the mesh does.

The running statistics follow flax's BatchNorm, not torch's: momentum 0.9
on the old value and the *biased* batch variance,
``running = 0.9 * running + 0.1 * batch``; ``nn.BatchNorm2d`` only holds the
parameters and buffers and its own forward never runs.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_unet_tpu_torch.kernels.flash_reattention import (
    expand_reattention_affine, flash_reattention, flash_reattention_plain,
    fold_reattention_compact, kernel_takes,
)
from vit_unet_tpu_torch.kernels.flash_reattention_train import (
    dropout_mask, flash_bn_batch_moments, flash_reattention_train,
    flash_reattention_train_bn, new_seed, reattention_nxn,
)
from vit_unet_tpu_torch.nn.dropout import dropout, require_generator
from vit_unet_tpu_torch.ops.patches import unflatten, unflatten_cl
from vit_unet_tpu_torch.parallel.mesh import current_layout
from vit_unet_tpu_torch.parallel.partition import copy_to_model, gather_from_model

BN_MOMENTUM = 0.9


def conv_tokens(x: torch.Tensor, weight: torch.Tensor, num_channels: int,
                layout: str = "cm") -> torch.Tensor:
    """Apply a bias-free conv to every token's (C, p, p) patch image.

    x: (B, N, C*p*p) tokens, channel-major (``layout="cm"``) or
    channels-last (``"cl"``); weight: (O, C, k, k) with O a multiple of C.
    Returns (B, N, O*p*p) in the same layout: with O = 3C (q/k/v weights
    concatenated) the last axis holds the q, k and v token vectors in turn.
    """
    b, n, _ = x.shape
    if layout == "cm":
        pats = unflatten(x, num_channels)                     # (B, N, C, p, p)
    else:
        pats = unflatten_cl(x, num_channels).permute(0, 1, 4, 2, 3)
    p = pats.shape[-1]
    out = F.conv2d(pats.reshape(b * n, num_channels, p, p), weight,
                   padding="same")                            # (B*N, O, p, p)
    if layout == "cl":
        out = (out.reshape(b * n, -1, num_channels, p, p)
               .permute(0, 1, 3, 4, 2))                       # (.., O/C, p, p, C)
    return out.reshape(b, n, -1)


def _window_basis(k: int, p: int, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """``_window_basis_cached``, but built afresh while a program is being
    exported: the export's tensors are placeholders, and one left in the
    cache would poison every later eager call."""
    if torch.compiler.is_exporting():
        return _window_basis_cached.__wrapped__(k, p, device, dtype)
    return _window_basis_cached(k, p, device, dtype)


@functools.lru_cache(maxsize=16)
def _window_basis_cached(k: int, p: int, device: torch.device,
                         dtype: torch.dtype) -> torch.Tensor:
    """(k·k, p⁴): entry [(a, b), (i, j, I, J)] is 1 where input pixel (i, j)
    sits at window offset (a, b) of output pixel (I, J) of a SAME-padded
    k x k conv on a p x p image (i - I = a - k//2, j - J = b - k//2); zero
    padding falls out of the clipped offsets.  A constant per (k, p), made
    as an ordinary tensor even under ``inference_mode`` so that a later
    training step can use it.  It holds no token layout: both layouts'
    operators are permutations of the same product with it."""
    with torch.inference_mode(False):
        ar = torch.arange(p, device=device)
        offsets = torch.arange(-(k // 2), k // 2 + 1, device=device)
        s = ar[None, :, None] - ar[None, None, :] == offsets[:, None, None]  # [a, i, I]
        t = s[:, None, :, None, :, None] & s[None, :, None, :, None, :]     # [a, b, i, j, I, J]
        return t.reshape(k * k, p ** 4).to(dtype)


def _token_operator(weight: torch.Tensor, p: int,
                    layout: str = "cm") -> torch.Tensor:
    """The conv with weight (O, C, k, k) as a right operand on token
    vectors of ``layout``: (C·p², O·p²), ``conv_tokens(x, weight, C,
    layout) == x @ op``.  Built in the weight's dtype by one product with
    the window basis, exact in any dtype (each entry is one weight or
    zero)."""
    o, c, k, _ = weight.shape
    r = weight.reshape(o * c, k * k) @ _window_basis(k, p, weight.device, weight.dtype)
    if layout == "cm":   # rows (c, i, j), columns (o, I, J)
        return (r.reshape(o, c, p, p, p, p).permute(1, 2, 3, 0, 4, 5)
                .reshape(c * p * p, o * p * p))
    # rows (i, j, c), columns (o // C, I, J, o % C)
    return (r.reshape(o // c, c, c, p, p, p, p).permute(3, 4, 2, 0, 5, 6, 1)
            .reshape(c * p * p, o * p * p))


def conv_token_matrix(weight: torch.Tensor, num_channels: int, p: int,
                      layout: str = "cm") -> torch.Tensor:
    """The SAME-padding CxC conv as a dense (E, E) operator M on the token
    vector of ``layout`` (E = C·p²), built differentiably from the conv
    weight (C, C, k, k): ``conv_tokens(x, weight, C, layout) == x @ M.T``."""
    if weight.shape[1] != num_channels:
        raise ValueError(f"weight {tuple(weight.shape)} does not take "
                         f"{num_channels} channels")
    return _token_operator(weight, p, layout).T


#: the widest token vector (E = C·p²), by dtype, whose Q/K/V run as one
#: dense product with ``conv_token_matrix``; wider ones, and other dtypes,
#: run the conv.  Set where the H100 measured the matmul form faster
#: (PERF.md, "QKV forms"): bfloat16 at all of base's level widths E = 192,
#: 768 and 3072, float32 at E = 192 only (the dense operator is E/(9·C)
#: times the conv's work, which f32 pays on the CUDA cores).  The TPU's
#: gate (E <= 256) does not carry over.
QKV_MATMUL_MAX_E = {torch.bfloat16: 3072, torch.float32: 192}


def qkv_form(e: int, dtype: torch.dtype) -> str:
    """``"matmul"`` or ``"conv"``: the form of a layer's Q/K/V at token
    width ``e`` in ``dtype``.  The one place the form is chosen."""
    return "matmul" if e <= QKV_MATMUL_MAX_E.get(dtype, 0) else "conv"


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, E) -> (B, H, N, E/H); head h owns the contiguous channel-major
    slice [h*E/H, (h+1)*E/H) of the flattened patch."""
    b, n, e = x.shape
    return x.reshape(b, n, num_heads, e // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, dh) -> (B, N, E)."""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


class ReAttention(nn.Module):
    """Self re-attention over patch tokens.

    ``qkv_kernel=3`` matches the packaged model and the README configs,
    ``qkv_kernel=1`` the 512² notebook config.  The TF flavour sets
    ``token_layout="cl"`` and ``qkv_gelu=True``.  The Q/K/V convs are
    bias-free: no configuration sets JAX's ``qkv_bias``.
    ``use_flash=False`` runs the plain version of the attention contraction
    on every device (it materialises the N x N map); ``True`` runs the
    kernels, and in training only with ``flash_train`` (the default here;
    JAX defaults it to False).
    A (heads, dh) beyond the kernels' limits (``kernel_takes``) takes the
    plain path whatever the flags say.

    ``sequence_parallel``: at ``sp_min_tokens`` tokens or more, on a mesh
    whose ``model`` axis has more than one rank (``sp_mesh``, else the mesh
    of the step running, ``use_mesh``) and divides the tokens, the attention
    runs sequence-parallel (``_attend_sp``).  Only ``kernel_takes`` gates
    its kernels: the JAX package's floor of 128 rows a shard does not carry
    over.

    ``tp_mesh`` (set by ``parallel/partition.py::shard_module``): ``proj``
    is split over that mesh's ``model`` axis (column-parallel).  The heads
    are not: the head mix really mixes them, and JAX's rules do not split
    the Q/K/V convs either.
    """

    tp_mesh = None

    def __init__(self, dim: int, num_channels: int = 3, num_heads: int = 8,
                 qkv_kernel: int = 3, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, use_flash: bool = True,
                 flash_train: bool = True, flash_frozen_bn: bool = False,
                 bn_track: bool = False, bn_eps: float = 1e-5,
                 qkv_gelu: bool = False,
                 token_layout: str = "cm",
                 sequence_parallel: bool = False, sp_min_tokens: int = 1024,
                 sp_mesh=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if token_layout not in ("cm", "cl"):
            raise ValueError(f"token_layout must be 'cm' or 'cl', got "
                             f"{token_layout!r}")
        self.dim = dim
        self.num_channels = num_channels
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.use_flash = use_flash
        self.flash_train = flash_train
        self.flash_frozen_bn = flash_frozen_bn
        self.bn_track = bn_track
        self.bn_eps = bn_eps
        self.qkv_gelu = qkv_gelu
        self.token_layout = token_layout
        self.sequence_parallel = sequence_parallel
        self.sp_min_tokens = sp_min_tokens
        self.sp_mesh = sp_mesh
        self.dtype = dtype
        c = num_channels
        conv = lambda: nn.Conv2d(c, c, qkv_kernel, padding="same", bias=False)
        self.qconv2d = conv()
        self.kconv2d = conv()
        self.vconv2d = conv()
        self.reatten_matrix = nn.Conv2d(num_heads, num_heads, 1)
        # parameter and running-statistics holder (see the module docstring)
        self.var_norm = nn.BatchNorm2d(num_heads, eps=bn_eps)
        self.proj = nn.Linear(dim, dim)

    @property
    def scale(self) -> float:
        return (self.dim // self.num_heads) ** -0.5

    @property
    def _kernels(self) -> bool:
        """Whether this layer's calls run the kernels: ``use_flash`` and a
        shape the kernels take."""
        return self.use_flash and kernel_takes(self.num_heads,
                                               self.dim // self.num_heads)

    def _qkv(self, q_in, k_in, v_in):
        """(B, N, E) inputs -> q, k, v as (B, H, N, dh), in the form
        ``qkv_form`` names for this width and dtype."""
        if qkv_form(q_in.shape[-1], self.dtype) == "matmul":
            return self._qkv_matmul(q_in, k_in, v_in)
        return self._qkv_conv(q_in, k_in, v_in)

    def _convs(self):
        return (self.qconv2d, self.kconv2d, self.vconv2d)

    def _heads(self, ys):
        """(B, N, E) q, k, v -> (B, H, N, dh), through the exact GELU
        first when ``qkv_gelu``."""
        if self.qkv_gelu:
            ys = (F.gelu(y) for y in ys)
        return tuple(split_heads(y, self.num_heads) for y in ys)

    def _qkv_conv(self, q_in, k_in, v_in):
        """The conv form: one C->3C conv when the three inputs are one
        tensor, else one conv each."""
        dt, c, layout = self.dtype, self.num_channels, self.token_layout
        convs = self._convs()
        if q_in is k_in and k_in is v_in:
            w = torch.cat([cv.weight for cv in convs]).to(dt)
            ys = conv_tokens(q_in.to(dt), w, c, layout).chunk(3, dim=-1)
        else:
            ys = (conv_tokens(t.to(dt), cv.weight.to(dt), c, layout)
                  for t, cv in zip((q_in, k_in, v_in), convs))
        return self._heads(ys)

    def _qkv_matmul(self, q_in, k_in, v_in):
        """The matmul form: the three convs as one (E, 3E) operator
        (``conv_token_matrix`` of each, side by side), one (B·N, E) @
        (E, 3E) product when the three inputs are one tensor, else three
        (B·N, E) @ (E, E).  Same parameters; their gradients flow through
        the operator."""
        dt, layout = self.dtype, self.token_layout
        e = q_in.shape[-1]
        p = round((e // self.num_channels) ** 0.5)
        convs = self._convs()
        w = torch.cat([cv.weight for cv in convs]).to(dt)
        op = _token_operator(w, p, layout)
        if q_in is k_in and k_in is v_in:
            ys = torch.matmul(q_in.to(dt), op).chunk(3, dim=-1)
        else:
            ys = (torch.matmul(t.to(dt), op[:, i * e:(i + 1) * e])
                  for i, t in enumerate((q_in, k_in, v_in)))
        return self._heads(ys)

    def _folded(self):
        """(m_eff, c_eff) from the head-mix conv and the running statistics,
        differentiable in the conv and BatchNorm parameters.  The statistics
        are copied: ``bn_track`` updates them in place before the backward."""
        bn = self.var_norm
        return fold_reattention_compact(
            self.reatten_matrix.weight, self.reatten_matrix.bias, bn.weight,
            bn.bias, bn.running_mean.clone(), bn.running_var.clone(),
            eps=self.bn_eps)

    @torch.no_grad()
    def _update_running(self, mean, var):
        """flax's update: running = 0.9 running + 0.1 batch, biased var."""
        bn = self.var_norm
        bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean.float())
        bn.running_var.mul_(BN_MOMENTUM).add_(
            (1 - BN_MOMENTUM) * var.float().clamp_min(0.0))

    def _sp_mesh_for(self, n: int):
        """The mesh to split ``n`` tokens over, or None where sequence
        parallelism does not apply (off, no mesh, an axis of one rank, too
        few tokens, or a count the axis does not divide)."""
        if not self.sequence_parallel:
            return None
        mesh = self.sp_mesh
        if mesh is None:
            layout = current_layout()
            mesh = None if layout is None else layout.mesh
        if mesh is None:
            return None
        size = mesh.shape["model"]
        if size <= 1 or n < self.sp_min_tokens or n % size:
            return None
        return mesh

    @staticmethod
    def _batch_shards():
        """The ``shards`` of a step whose batch is split over the data axis
        (its exact-BN moments are the whole batch's), else None."""
        layout = current_layout()
        if layout is None or not layout.batch_split:
            return None
        return layout.mesh.shards(("data",))

    def _attend_sp(self, q, k, v, mesh, *, deterministic: bool,
                   use_running_average: bool, generator):
        """Sequence-parallel attention (``parallel/sequence.py``) over
        ``mesh``'s ``model`` axis: eval with the folded running statistics;
        training with dropout and the head-mix BatchNorm on batch statistics
        over the whole (batch, token) plane, or frozen (``use_running_average``,
        or ``flash_frozen_bn`` on the kernels), or tracking (``bn_track``).
        The exact moments across ranks update the running statistics
        directly (JAX feeds them through a two-point tensor)."""
        from vit_unet_tpu_torch.parallel.sequence import (
            sequence_parallel_reattention, sequence_parallel_reattention_train)

        qs = q * self.scale
        if deterministic and use_running_average:
            m_eff, c_eff = self._folded()
            return sequence_parallel_reattention(
                qs, k, v, m_eff, c_eff, mesh, use_flash=self._kernels)
        rate = 0.0 if deterministic else float(self.attn_drop)
        seed = None
        if rate > 0.0:
            seed = new_seed(require_generator(generator, rate, "attention dropout"))
        kernels = self._kernels and self.flash_train
        frozen = use_running_average or (kernels and self.flash_frozen_bn)
        tracking = self.bn_track and not frozen
        bn = self.var_norm
        running = None
        if frozen or tracking:
            running = (bn.running_mean.clone(), bn.running_var.clone())
        # the batch is split over the data axis inside a step that says so,
        # and outside a step wherever the mesh has a data axis
        layout = current_layout()
        split = layout is None or layout.batch_split
        out, mean, var = sequence_parallel_reattention_train(
            qs, k, v, self.reatten_matrix.weight[:, :, 0, 0],
            self.reatten_matrix.bias, bn.weight, bn.bias, mesh, seed=seed,
            rate=rate, data_axis="data" if split else None, eps=self.bn_eps,
            running_stats=running, use_flash=kernels, track_stats=tracking)
        if not frozen:
            self._update_running(mean.detach(), var.detach())
        return out

    def _attend(self, q, k, v, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        """q, k, v (B, H, N, dh) -> merged-head (B, N_q, E)."""
        sp_mesh = self._sp_mesh_for(q.shape[2])
        if sp_mesh is not None:
            return self._attend_sp(q, k, v, sp_mesh, deterministic=deterministic,
                                   use_running_average=use_running_average,
                                   generator=generator)
        qs = (q * self.scale).contiguous()
        k, v_cat = k.contiguous(), merge_heads(v).contiguous()
        if deterministic and use_running_average:
            m_eff, c_eff = self._folded()
            w, b = expand_reattention_affine(m_eff, c_eff,
                                             dh=self.dim // self.num_heads)
            fn = flash_reattention if self._kernels else flash_reattention_plain
            return fn(qs, k, v_cat, w, b, num_heads=self.num_heads)
        rate = 0.0 if deterministic else float(self.attn_drop)
        seed = None
        if rate > 0.0:
            seed = new_seed(require_generator(generator, rate, "attention dropout"))
        if self._kernels and self.flash_train:
            return self._attend_flash_train(qs, k, v_cat, seed, rate,
                                            use_running_average)
        return self._attend_plain_train(qs, k, v_cat, seed, rate,
                                        use_running_average)

    def _attend_flash_train(self, q, k, v_cat, seed, rate, use_running_average):
        """The training kernels, selected as the JAX module's
        ``_attend_flash_train`` selects them."""
        heads = self.num_heads
        if use_running_average or self.flash_frozen_bn:
            m_eff, c_eff = self._folded()
            return flash_reattention_train(q, k, v_cat, m_eff, c_eff, seed,
                                           num_heads=heads, rate=rate)
        conv = self.reatten_matrix
        shards = self._batch_shards()
        if self.bn_track:
            m_eff, c_eff = self._folded()
            out = flash_reattention_train(q, k, v_cat, m_eff, c_eff, seed,
                                          num_heads=heads, rate=rate)
            mu, var = flash_bn_batch_moments(
                q.detach(), k.detach(), v_cat.detach(), conv.weight.detach(),
                conv.bias.detach(), seed, num_heads=heads, rate=rate,
                shards=shards)
            self._update_running(mu, var)
            return out
        bn = self.var_norm
        out, mu, var = flash_reattention_train_bn(
            q, k, v_cat, conv.weight, conv.bias, bn.weight, bn.bias, seed,
            num_heads=heads, rate=rate, eps=self.bn_eps, shards=shards)
        self._update_running(mu.detach(), var.detach())
        return out

    def _attend_plain_train(self, q, k, v_cat, seed, rate, use_running_average):
        """The N x N path of the JAX module's XLA branch
        (``reattention_nxn``): dropout with the kernels' mask, BatchNorm by
        the running statistics (frozen, ``bn_track``) or by the batch's,
        which update the running ones unless they are frozen."""
        batch, heads, n_q, _ = q.shape
        mask = None
        if rate > 0.0:
            mask = dropout_mask(seed, rate, batch, heads, n_q, k.shape[2],
                                q.device)
        conv, bn = self.reatten_matrix, self.var_norm
        stats = None
        if use_running_average or self.bn_track:
            stats = (bn.running_mean.clone(), bn.running_var.clone())
        out, (mean, var) = reattention_nxn(
            q, k, v_cat, conv.weight[:, :, 0, 0], conv.bias, mask,
            norm=(bn.weight, bn.bias), stats=stats, eps=self.bn_eps,
            shards=None if use_running_average else self._batch_shards())
        if not use_running_average:
            self._update_running(mean.detach(), var.detach())
        return out.to(q.dtype)

    def _project(self, out, deterministic: bool, generator):
        """``proj`` and its dropout; split over ``tp_mesh``, column-parallel
        with its output features all-gathered before the dropout (whose
        mask is then the whole tensor's)."""
        dt, mesh = self.dtype, self.tp_mesh
        if mesh is not None:
            out = copy_to_model(out, mesh)
        out = F.linear(out, self.proj.weight.to(dt), self.proj.bias.to(dt))
        if mesh is not None:
            out = gather_from_model(out, mesh, -1)
        return dropout(out, 0.0 if deterministic else self.proj_drop, generator)

    def forward(self, x, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        out = self._attend(*self._qkv(x, x, x), deterministic=deterministic,
                           use_running_average=use_running_average,
                           generator=generator)
        return self._project(out, deterministic, generator)


class SkipConnection(ReAttention):
    """Cross-attention skip fusion: query = encoder skip, key/value =
    decoder stream.  Its layers sit directly on the module (the reference's
    module tree); the JAX package keeps them under an inner ``attn`` scope."""

    def forward(self, q, k, v, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        out = self._attend(*self._qkv(q, k, v), deterministic=deterministic,
                           use_running_average=use_running_average,
                           generator=generator)
        return self._project(out, deterministic, generator)
