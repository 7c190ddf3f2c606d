"""Flash attention forward: hand-written CUDA kernel and its plain version.

Port of ``ray_tpu/ops/flash_attention.py`` (the forward; the backward
kernels ``_dq_kernel``/``_dkv_kernel`` come with the training slice).

``flash_attention`` keeps the JAX wrapper's contract:

- GQA is folded into the grouped layout ``[B*KH*G, T, D]``, with the K/V
  repeat outside the autograd boundary (``_FlashGrouped``) so that the
  backward, when it lands, sums dK/dV over the groups for free;
- ragged causal self-attention is zero-padded to the kernel's block and
  sliced back (exact: padded keys sit in every real query's masked future);
- ragged non-causal input goes to ``attention_reference``, as in the JAX
  package. That is the documented contract, not a fallback for a failed
  launch: ``flash_attention_forward.launches`` shows which branch ran.

``flash_attention_forward`` launches ``csrc/flash_attention_fwd.cu`` for
CUDA tensors (the kernel that replaces the Pallas ``_fwd_kernel``; its
source note says what bounds it on the H100) and takes
``flash_attention_reference`` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _cuda
from .layers import attention_reference, in_dtype

SOURCE = "flash_attention_fwd.cu"
# the kernel's Q and K tiles (csrc/flash_attention_fwd.cu kBQ, kBK): T and
# S must be multiples of these
BLOCK_Q = 64
BLOCK_K = 64
_HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _cuda.load(SOURCE).ray_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_reference(
    qg: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel on the grouped layout: (O [bh, T, D],
    lse [bh, 1, T] f32), with the kernel's rounding points (q * scale in
    the input dtype, P cast to V's dtype before P.V, f32 sums)."""
    bh, t, d = qg.shape
    s = kg.shape[1]
    qs = (qg * in_dtype(1.0 / d**0.5, qg.dtype).to(qg.device)).float()
    scores = qs @ kg.float().transpose(1, 2)
    if causal:
        q_pos = torch.arange(t, device=qg.device)[:, None]
        k_pos = torch.arange(s, device=qg.device)[None, :]
        scores = scores.masked_fill(k_pos > q_pos, -1e30)
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
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_forward takes head_dim in {_HEAD_DIMS}, got {d}")
    if t % BLOCK_Q or kg.shape[1] % BLOCK_K or kg.shape[1] == 0:
        raise ValueError(
            f"flash_attention_forward: T={t}, S={kg.shape[1]} must be positive "
            f"multiples of {BLOCK_Q}/{BLOCK_K} (flash_attention pads ragged input)"
        )
    for x in (qg, kg, vg):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("flash_attention_forward: q/k/v must be contiguous, 16-byte aligned")


def flash_attention_forward(
    qg: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) on the grouped layout. CUDA tensors launch the kernel (or
    raise); CPU tensors take ``flash_attention_reference``."""
    if qg.device.type == "cpu":
        return flash_attention_reference(qg, kg, vg, causal)
    if qg.device.type != "cuda":
        raise ValueError(f"flash_attention_forward: unsupported device {qg.device}")
    _check_inputs(qg, kg, vg)
    bh, t, d = qg.shape
    out = torch.empty_like(qg)
    lse = torch.empty((bh, 1, t), dtype=torch.float32, device=qg.device)
    err = _kernel()(
        _cuda.ptr(qg), _cuda.ptr(kg), _cuda.ptr(vg), _cuda.ptr(out), _cuda.ptr(lse),
        bh, t, kg.shape[1], d, int(causal), 1.0 / d**0.5,
        _cuda.DTYPE_CODES[qg.dtype], _cuda.current_stream(),
    )
    _cuda.check(err, "flash_attention_forward")
    flash_attention_forward.launches += 1
    return out, lse


flash_attention_forward.launches = 0


class _FlashGrouped(torch.autograd.Function):
    """Autograd boundary around the grouped forward (``_flash_grouped``'s
    custom VJP in the JAX package)."""

    @staticmethod
    def forward(ctx, qg, kg, vg, causal):
        out, _ = flash_attention_forward(qg, kg, vg, causal)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash attention backward (the dQ and dK/dV kernels of "
            "ray_tpu/ops/flash_attention.py) comes with the port's training slice"
        )


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    *,
    causal: bool = True,
) -> torch.Tensor:
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    if t % BLOCK_Q or s % BLOCK_K:
        if causal and t == s:
            # ragged causal self-attention: zero-pad to the block multiple
            # and slice the pad rows back off
            pad = -t % math.lcm(BLOCK_Q, BLOCK_K)
            zq = (0, 0, 0, 0, 0, pad)
            out = flash_attention(
                F.pad(q, zq), F.pad(k, zq), F.pad(v, zq), causal=True
            )
            return out[:, :t]
        # ragged cross/non-causal input: the plain reference, as in JAX
        return attention_reference(q, k, v, causal=causal)

    # fold (batch, kv_head, group) into the first axis; the K/V repeat stays
    # outside the autograd boundary so dK/dV will sum over groups
    qg = (
        q.reshape(b, t, hkv, groups, d)
        .permute(0, 2, 3, 1, 4)
        .reshape(b * hkv * groups, t, d)
        .contiguous()  # reshape may return a strided view (B = 1)
    )
    kg = (
        k.permute(0, 2, 1, 3)[:, :, None]
        .expand(b, hkv, groups, s, d)
        .reshape(b * hkv * groups, s, d)
        .contiguous()
    )
    vg = (
        v.permute(0, 2, 1, 3)[:, :, None]
        .expand(b, hkv, groups, s, d)
        .reshape(b * hkv * groups, s, d)
        .contiguous()
    )
    out = _FlashGrouped.apply(qg, kg, vg, causal)
    return (
        out.reshape(b, hkv, groups, t, d)
        .permute(0, 3, 1, 2, 4)
        .reshape(b, t, h, d)
    )
