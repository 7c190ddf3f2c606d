"""Flash attention: hand-written CUDA kernels and their plain versions.

Port of ``ray_tpu/ops/flash_attention.py``, forward and backward.

``flash_attention`` keeps the JAX wrapper's contract:

- GQA is folded into the grouped layout ``[B*KH*G, T, D]``, with the K/V
  repeat outside the autograd boundary (``_FlashGrouped``) so that the
  backward sums dK/dV over the groups through autograd;
- ragged causal self-attention is zero-padded to the kernel's block and
  sliced back (exact: padded keys sit in every real query's masked future,
  padded query rows get dO = 0, and the pad's gradients are dropped);
- a head_dim between the kernels' widths (32, 64, 128, 256, then every
  multiple of 256) is zero-padded to the next one and sliced back, with
  the softmax scale kept at 1/sqrt(real head_dim) (exact: zero columns add
  exact zeros to Q.K^T, the padded columns of O, dQ, dK and dV are zeros
  and are dropped, and delta is unchanged). bf16 runs the wgmma kernels up
  to 128 and the FMA kernels at 256; above 256 both dtypes run the wide
  FMA kernels, which walk head_dim in chunks of 256;
- ragged non-causal input goes to ``attention_reference``, as in the JAX
  package. That is the documented contract, not a fallback for a failed
  launch: the wrappers' ``.launches`` counts show which branch ran.

Kernels (``csrc/``), each replacing one Pallas kernel; their source notes
say what bounds them on the H100:

- ``flash_attention_forward``: ``flash_attention_fwd.cu`` (``_fwd_kernel``),
  writes O and the per-row logsumexp;
- ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``:
  ``flash_attention_bwd.cu`` (``_dq_kernel`` and ``_dkv_kernel``), the
  FlashAttention-2 backward, behind ``flash_attention_backward``.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain version (``*_reference``) for CPU tensors. The grouped wrappers
and plain versions take the softmax ``scale`` explicitly; it defaults to
1/sqrt(head_dim) of the tensors given.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import _cuda
from .layers import attention_reference, in_dtype

SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
# the kernels' Q and K tiles (kBQ, kBK in csrc/flash_attention_*.cu): T and
# S must be multiples of these
BLOCK_Q = 64
BLOCK_K = 64
_HEAD_DIMS = (32, 64, 128, 256)
WIDE_CHUNK = 256  # above 256, head_dim is a multiple of this (kWideChunk in csrc/common.cuh)


def _bind(source: str, name: str, n_ptrs: int):
    """The C entry point ``name`` of ``source``: n_ptrs pointers, then
    (bh, t, s, d, causal), scale, dtype code and stream."""
    fn = getattr(_cuda.load(source), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    return _bind(SOURCE, "ray_flash_attention_fwd", 5)


@functools.lru_cache(maxsize=None)
def _dq_kernel():
    return _bind(BWD_SOURCE, "ray_flash_attention_bwd_dq", 7)


@functools.lru_cache(maxsize=None)
def _dkv_kernel():
    return _bind(BWD_SOURCE, "ray_flash_attention_bwd_dkv", 8)


def _scale(qg, scale):
    """The softmax scale: ``scale``, or 1/sqrt(head_dim) of ``qg``."""
    return 1.0 / qg.shape[-1] ** 0.5 if scale is None else scale


def _padded_head_dim(d: int) -> int:
    """The kernel width that ``flash_attention`` pads head_dim ``d`` to: the
    next of 32, 64, 128, 256, and above 256 the next multiple of 256."""
    return next((w for w in _HEAD_DIMS if w >= d), -(-d // WIDE_CHUNK) * WIDE_CHUNK)


def _kernel_head_dim(d: int) -> bool:
    return d in _HEAD_DIMS or (d > WIDE_CHUNK and d % WIDE_CHUNK == 0)


def _scores(qg, kg, causal, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S = (q * scale).K^T in f32 with masked entries at -1e30, q * scale
    in the input dtype), as every flash kernel forms them."""
    t = qg.shape[1]
    qs = qg * in_dtype(_scale(qg, scale), qg.dtype).to(qg.device)
    scores = qs.float() @ kg.float().transpose(1, 2)
    if causal:
        q_pos = torch.arange(t, device=qg.device)[:, None]
        k_pos = torch.arange(kg.shape[1], device=qg.device)[None, :]
        scores = scores.masked_fill(k_pos > q_pos, -1e30)
    return scores, qs


def flash_attention_reference(
    qg: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor, causal: bool, scale=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel on the grouped layout: (O [bh, T, D],
    lse [bh, 1, T] f32), with the kernel's rounding points (q * scale in
    the input dtype, P cast to V's dtype before P.V, f32 sums)."""
    bh, t, _ = qg.shape
    scores, _ = _scores(qg, kg, causal, scale)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = p.to(vg.dtype).float() @ vg.float()
    out = (o / l_safe).to(qg.dtype)
    lse = (m + torch.log(l_safe)).reshape(bh, 1, t)
    return out, lse


def _check_inputs(qg, kg, vg):
    if kg.device != qg.device or vg.device != qg.device:
        raise ValueError("flash_attention_forward: q, k, v must be on one device")
    if qg.dtype not in _cuda.DTYPE_CODES or kg.dtype != qg.dtype or vg.dtype != qg.dtype:
        raise TypeError(
            f"flash_attention_forward takes f32 or bf16 q/k/v of one dtype, got "
            f"{qg.dtype}/{kg.dtype}/{vg.dtype}"
        )
    if qg.dim() != 3 or kg.shape != vg.shape or kg.dim() != 3:
        raise ValueError("flash_attention_forward: grouped layout [bh, T|S, D]")
    bh, t, d = qg.shape
    if kg.shape[0] != bh or kg.shape[2] != d:
        raise ValueError(
            f"flash_attention_forward: q {tuple(qg.shape)} vs k {tuple(kg.shape)}"
        )
    if not _kernel_head_dim(d):
        raise ValueError(
            f"flash_attention_forward takes head_dim in {_HEAD_DIMS} or a multiple of "
            f"{WIDE_CHUNK} above it, got {d} (flash_attention pads head_dim up to one)"
        )
    if t % BLOCK_Q or kg.shape[1] % BLOCK_K or kg.shape[1] == 0:
        raise ValueError(
            f"flash_attention_forward: T={t}, S={kg.shape[1]} must be positive "
            f"multiples of {BLOCK_Q}/{BLOCK_K} (flash_attention pads ragged input)"
        )
    for x in (qg, kg, vg):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("flash_attention_forward: q/k/v must be contiguous, 16-byte aligned")


def flash_attention_forward(
    qg: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor, causal: bool, scale=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) on the grouped layout, softmax scale ``scale`` (default
    1/sqrt(head_dim)). CUDA tensors launch the kernel (or raise); CPU
    tensors take ``flash_attention_reference``."""
    scale = _scale(qg, scale)
    if qg.device.type == "cpu":
        return flash_attention_reference(qg, kg, vg, causal, scale)
    if qg.device.type != "cuda":
        raise ValueError(f"flash_attention_forward: unsupported device {qg.device}")
    _check_inputs(qg, kg, vg)
    bh, t, d = qg.shape
    out = torch.empty_like(qg)
    lse = torch.empty((bh, 1, t), dtype=torch.float32, device=qg.device)
    err = _kernel()(
        _cuda.ptr(qg), _cuda.ptr(kg), _cuda.ptr(vg), _cuda.ptr(out), _cuda.ptr(lse),
        bh, t, kg.shape[1], d, int(causal), scale,
        _cuda.DTYPE_CODES[qg.dtype], _cuda.current_stream(),
    )
    _cuda.check(err, "flash_attention_forward")
    flash_attention_forward.launches += 1
    return out, lse


flash_attention_forward.launches = 0


def _recompute_p(qg, kg, lse, causal, scale=None):
    """(P = exp(S - lse) in f32, q * scale in the input dtype), as the
    backward kernels recompute them; masked entries underflow to 0."""
    scores, qs = _scores(qg, kg, causal, scale)
    return torch.exp(scores - lse.reshape(*qg.shape[:2], 1)), qs


def flash_attention_bwd_dq_reference(qg, kg, vg, do, lse, delta, causal, scale=None):
    """Plain version of the dQ kernel (``_dq_kernel``'s rounding points):
    dO in f32, dP = dO.V^T in f32, dS cast to K's dtype before dS.K, and a
    final ``* scale``."""
    bh, t, _ = qg.shape
    scale = _scale(qg, scale)
    p, _ = _recompute_p(qg, kg, lse, causal, scale)
    dp = do.float() @ vg.float().transpose(1, 2)
    ds = p * (dp - delta.reshape(bh, t, 1))
    dq = ds.to(kg.dtype).float() @ kg.float()
    return (dq * scale).to(qg.dtype)


def flash_attention_bwd_dkv_reference(qg, kg, vg, do, lse, delta, causal, scale=None):
    """Plain version of the dK/dV kernel (``_dkv_kernel``'s rounding
    points): dV = P^T.dO with P and dO in f32, dS cast to Q's dtype before
    dS^T.(scale * Q); dK takes no second scale."""
    bh, t, _ = qg.shape
    p, qs = _recompute_p(qg, kg, lse, causal, scale)
    do32 = do.float()
    dv = p.transpose(1, 2) @ do32
    dp = do32 @ vg.float().transpose(1, 2)
    ds = p * (dp - delta.reshape(bh, t, 1))
    dk = ds.to(qs.dtype).float().transpose(1, 2) @ qs.float()
    return dk.to(kg.dtype), dv.to(vg.dtype)


def flash_attention_backward_reference(
    qg, kg, vg, do, lse, delta, causal, scale=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of both backward kernels on the grouped layout:
    (dq, dk, dv) given dO [bh, T, D], lse and delta [bh, 1, T] f32."""
    dk, dv = flash_attention_bwd_dkv_reference(qg, kg, vg, do, lse, delta, causal, scale)
    return flash_attention_bwd_dq_reference(qg, kg, vg, do, lse, delta, causal, scale), dk, dv


def _check_bwd_inputs(qg, kg, vg, do, lse, delta):
    _check_inputs(qg, kg, vg)
    if do.shape != qg.shape or do.dtype != qg.dtype or do.device != qg.device:
        raise ValueError(
            f"flash_attention_backward: dO {tuple(do.shape)} {do.dtype} must match "
            f"q {tuple(qg.shape)} {qg.dtype}"
        )
    row = (qg.shape[0], 1, qg.shape[1])
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != row or x.dtype != torch.float32 or x.device != qg.device:
            raise ValueError(f"flash_attention_backward: {name} must be f32 {row}")
    for x in (do, lse, delta):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("flash_attention_backward: inputs must be contiguous, 16-byte aligned")


def _bwd_args(qg, kg, causal, scale):
    bh, t, d = qg.shape
    return (bh, t, kg.shape[1], d, int(causal), _scale(qg, scale),
            _cuda.DTYPE_CODES[qg.dtype], _cuda.current_stream())


def flash_attention_bwd_dq(qg, kg, vg, do, lse, delta, causal, scale=None) -> torch.Tensor:
    """dQ on the grouped layout, softmax scale ``scale`` (default
    1/sqrt(head_dim)). CUDA tensors launch the dQ kernel (or raise); CPU
    tensors take ``flash_attention_bwd_dq_reference``."""
    if qg.device.type == "cpu":
        return flash_attention_bwd_dq_reference(qg, kg, vg, do, lse, delta, causal, scale)
    if qg.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dq: unsupported device {qg.device}")
    _check_bwd_inputs(qg, kg, vg, do, lse, delta)
    dq = torch.empty_like(qg)
    err = _dq_kernel()(
        _cuda.ptr(qg), _cuda.ptr(kg), _cuda.ptr(vg), _cuda.ptr(do), _cuda.ptr(lse),
        _cuda.ptr(delta), _cuda.ptr(dq), *_bwd_args(qg, kg, causal, scale),
    )
    _cuda.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(qg, kg, vg, do, lse, delta, causal, scale=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) on the grouped layout, softmax scale ``scale`` (default
    1/sqrt(head_dim)). CUDA tensors launch the dK/dV kernel (or raise); CPU
    tensors take ``flash_attention_bwd_dkv_reference``."""
    if qg.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(qg, kg, vg, do, lse, delta, causal, scale)
    if qg.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dkv: unsupported device {qg.device}")
    _check_bwd_inputs(qg, kg, vg, do, lse, delta)
    dk, dv = torch.empty_like(kg), torch.empty_like(vg)
    err = _dkv_kernel()(
        _cuda.ptr(qg), _cuda.ptr(kg), _cuda.ptr(vg), _cuda.ptr(do), _cuda.ptr(lse),
        _cuda.ptr(delta), _cuda.ptr(dk), _cuda.ptr(dv),
        *_bwd_args(qg, kg, causal, scale),
    )
    _cuda.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_backward(
    qg, kg, vg, do, lse, delta, causal, scale=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) on the grouped layout through the two backward kernels
    (CUDA) or their plain versions (CPU); ``flash_attention_bwd_dq`` and
    ``flash_attention_bwd_dkv`` count the launches."""
    dk, dv = flash_attention_bwd_dkv(qg, kg, vg, do, lse, delta, causal, scale)
    return flash_attention_bwd_dq(qg, kg, vg, do, lse, delta, causal, scale), dk, dv


class _FlashGrouped(torch.autograd.Function):
    """Autograd boundary around the grouped kernels (``_flash_grouped``'s
    custom VJP in the JAX package)."""

    @staticmethod
    def forward(ctx, qg, kg, vg, causal, scale):
        out, lse = flash_attention_forward(qg, kg, vg, causal, scale)
        ctx.save_for_backward(qg, kg, vg, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @once_differentiable  # the kernels have no backward of their own
    def backward(ctx, grad_out):
        qg, kg, vg, out, lse = ctx.saved_tensors
        do = grad_out.contiguous()
        # delta_i = rowsum(dO * O), the softmax-jacobian term, in f32 and
        # in lse's [bh, 1, T] layout (plain torch, as in the JAX package)
        delta = (do.float() * out.float()).sum(dim=-1)[:, None, :]
        dq, dk, dv = flash_attention_backward(qg, kg, vg, do, lse, delta, ctx.causal,
                                              ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    *,
    causal: bool = True,
) -> torch.Tensor:
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    ragged = bool(t % BLOCK_Q or s % BLOCK_K)
    if ragged and not (causal and t == s):
        # ragged cross/non-causal input: the plain reference, as in JAX
        return attention_reference(q, k, v, causal=causal)
    # zero-pad ragged causal self-attention to the block multiple and the
    # head_dim to the next kernel width, then slice the pad back off
    pad_t = -t % math.lcm(BLOCK_Q, BLOCK_K) if ragged else 0
    dp = _padded_head_dim(d)
    if pad_t or dp != d:
        z = (0, dp - d, 0, 0, 0, pad_t)
        q, k, v = F.pad(q, z), F.pad(k, z), F.pad(v, z)
    tp, sp = t + pad_t, s + pad_t

    # fold (batch, kv_head, group) into the first axis; the K/V repeat stays
    # outside the autograd boundary so dK/dV sum over the groups
    groups = h // hkv
    qg = (
        q.reshape(b, tp, hkv, groups, dp)
        .permute(0, 2, 3, 1, 4)
        .reshape(b * hkv * groups, tp, dp)
        .contiguous()  # reshape may return a strided view (B = 1)
    )
    kg = (
        k.permute(0, 2, 1, 3)[:, :, None]
        .expand(b, hkv, groups, sp, dp)
        .reshape(b * hkv * groups, sp, dp)
        .contiguous()
    )
    vg = (
        v.permute(0, 2, 1, 3)[:, :, None]
        .expand(b, hkv, groups, sp, dp)
        .reshape(b * hkv * groups, sp, dp)
        .contiguous()
    )
    out = _FlashGrouped.apply(qg, kg, vg, causal, 1.0 / d**0.5)
    out = (
        out.reshape(b, hkv, groups, tp, dp)
        .permute(0, 3, 1, 2, 4)
        .reshape(b, tp, h, dp)
    )
    return out[:, :t, :, :d] if pad_t or dp != d else out
