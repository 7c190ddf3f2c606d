"""Paged-attention decode: hand-written CUDA kernel and its plain version.

Port of ``ray_tpu/ops/paged_attention.py``. The decode-step attention of
the continuous-batching engine (``llm/continuous.py``): each slot's single
query token attends over its paged KV cache through a block table.

``paged_attention_decode`` launches ``csrc/paged_attention.cu`` for CUDA
tensors (the kernel that replaces the Pallas ``_paged_kernel``, see the
source note there: memory bound, one block per (slot, kv head, chunk of
query rows), the block-table row read from device memory) and takes
``paged_attention_reference``, the gather formulation, for CPU tensors.
The kernel takes every head_dim that is a multiple of 16 up to 128 and any
number of query heads per KV head; other head_dims raise on CUDA (the
paged pool cannot be padded per call).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda

SOURCE = "paged_attention.cu"
# the kernel's head_dim instances (csrc/paged_attention.cu dispatch_d)
_HEAD_DIMS = tuple(range(16, 129, 16))


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _cuda.load(SOURCE).ray_paged_attention_decode
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k_pages, v_pages, block_tables, lengths, page_size):
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention_decode: all inputs must be on one device")
    if q.dtype not in _cuda.DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"paged_attention_decode takes f32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention_decode: block_tables and lengths must be int32")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged_attention_decode: q [B,KH,G,D] and pools [KH,N,page,D], got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    b, kh, _, d = q.shape
    if (k_pages.shape[0], k_pages.shape[2], k_pages.shape[3]) != (kh, page_size, d):
        raise ValueError(
            f"paged_attention_decode: pool {tuple(k_pages.shape)} does not match "
            f"KH={kh}, page={page_size}, D={d}"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_attention_decode: block_tables [B,P_max], lengths [B]")
    if d not in _HEAD_DIMS:
        raise ValueError(
            f"paged_attention_decode kernel takes a head_dim that is a multiple of 16 "
            f"up to 128, got {d}"
        )
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("paged_attention_decode: inputs must be contiguous")
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("paged_attention_decode: q/k/v must be 16-byte aligned")


def paged_attention_decode(
    q: torch.Tensor,  # [B, KH, G, D] one query token per slot, grouped heads
    k_pages: torch.Tensor,  # [KH, N_pages, page, D] head-major pool
    v_pages: torch.Tensor,  # [KH, N_pages, page, D]
    block_tables: torch.Tensor,  # [B, P_max] int32
    lengths: torch.Tensor,  # [B] int32 valid positions per slot
    *,
    page_size: int,
) -> torch.Tensor:  # [B, KH, G, D]
    """Decode attention over a paged pool. CUDA tensors launch the kernel
    (or raise); CPU tensors take ``paged_attention_reference``. Page ids in
    ``block_tables`` must lie in ``[0, N_pages)``: the kernel trusts them."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, block_tables, lengths, page_size=page_size
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: unsupported device {q.device}")
    _check_inputs(q, k_pages, v_pages, block_tables, lengths, page_size)
    b, kh, g, d = q.shape
    out = torch.empty_like(q)
    err = _kernel()(
        _cuda.ptr(q), _cuda.ptr(k_pages), _cuda.ptr(v_pages),
        _cuda.ptr(block_tables), _cuda.ptr(lengths), _cuda.ptr(out),
        b, kh, g, d, k_pages.shape[1], page_size, block_tables.shape[1],
        1.0 / d**0.5, _cuda.DTYPE_CODES[q.dtype], _cuda.current_stream(),
    )
    _cuda.check(err, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def paged_attention_reference(
    q, k_pages, v_pages, block_tables, lengths, *, page_size
):
    """Gather formulation, the plain version the kernel is held against:
    every slot's pages gathered into a contiguous [S_max] view, f32 scores,
    masked softmax."""
    b, kh, g, d = q.shape
    p_max = block_tables.shape[1]
    s_max = p_max * page_size
    tables = block_tables.long()
    # [N, page, KH, D] pool gathered per slot -> [B, S_max, KH, D]
    ks = k_pages.permute(1, 2, 0, 3)[tables].reshape(b, s_max, kh, d)
    vs = v_pages.permute(1, 2, 0, 3)[tables].reshape(b, s_max, kh, d)
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), ks.float()) / (d**0.5)
    valid = torch.arange(s_max, device=q.device)[None, :] < lengths.long()[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", probs, vs.float()).to(q.dtype)
