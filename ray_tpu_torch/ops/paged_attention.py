"""Paged-attention decode: hand-written CUDA kernel and its plain versions.

Port of ``ray_tpu/ops/paged_attention.py``. The decode-step attention of
the continuous-batching engine (``llm/continuous.py``): each slot's single
query token attends over its paged KV cache through a block table.

``paged_attention_decode`` launches ``csrc/paged_attention.cu`` for CUDA
tensors (the kernel that replaces the Pallas ``_paged_kernel``, see the
source note there: memory bound, each sequence split over several blocks,
pages streamed by cp.async through a shared-memory ring, the splits merged
in a fixed order in the same launch) and takes
``paged_attention_reference``, the gather formulation, for CPU tensors.
The kernel takes every head_dim from 1 to 256 and any number of query
heads per KV head, in f32 and bf16. ``paged_attention_split_reference``
computes the kernel's split-and-combine algebra in plain torch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _cuda

SOURCE = "paged_attention.cu"
MAX_HEAD_DIM = 256  # csrc/paged_attention.cu kMaxHeadDim
SHARE_ROUND = 16  # a split's share of the tokens is a multiple of this (kShareRound)
BLOCKS_PER_SM = 1  # the split count aims at this many blocks per SM (flash_tiles.py paged)
MAX_SPLIT_TOKENS = 2048  # and at no split longer than this many positions
MAX_TABLE_WINDOW = 4096  # block-table entries one split may stage in shared memory


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _cuda.load(SOURCE)
    lib.ray_paged_attention_decode.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.ray_paged_attention_decode.restype = ctypes.c_int
    lib.ray_paged_attention_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ray_paged_attention_rows.restype = ctypes.c_int
    return lib


def split_share(n_valid: int, n_split: int) -> int:
    """Tokens of each split: ceil(n_valid / n_split) rounded up to
    ``SHARE_ROUND`` (the kernel's rule; the last splits may fall empty)."""
    per_split = -(-n_valid // n_split)
    return -(-per_split // SHARE_ROUND) * SHARE_ROUND


def table_window(s_max: int, page: int, n_split: int) -> int:
    """The most block-table entries one split's tokens can lie on."""
    return -(-split_share(s_max, n_split) // page) + 1


@functools.lru_cache(maxsize=None)
def plan(b: int, kh: int, g: int, d: int, p_max: int, page: int, dtype_code: int,
         n_sm: int):
    """(n_split, table window) of a launch, from the shapes and the SM count
    alone (never the device's lengths): enough splits that B * KH * chunks
    * n_split blocks reach ``BLOCKS_PER_SM`` per SM and that no split of the
    longest possible sequence (P_max * page) exceeds ``MAX_SPLIT_TOKENS``
    (the longest block bounds the launch), no more splits than 16-token
    shares of it, and at least enough that one split's table entries fit
    ``MAX_TABLE_WINDOW``."""
    rows = _lib().ray_paged_attention_rows(d, dtype_code)
    blocks = b * kh * -(-g // rows)
    s_max = max(1, p_max * page)
    wanted = max(-(-BLOCKS_PER_SM * n_sm // blocks), -(-s_max // MAX_SPLIT_TOKENS))
    n_split = max(1, min(wanted, -(-s_max // SHARE_ROUND)))
    while table_window(s_max, page, n_split) > MAX_TABLE_WINDOW:
        n_split += 1
    return n_split, min(p_max, table_window(s_max, page, n_split))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_tickets = {}  # (device, stream) -> int32 counters the kernel leaves at 0


def _ticket_buffer(device, stream: int, n: int) -> torch.Tensor:
    key = (device, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def _check_inputs(q, k_pages, v_pages, block_tables, lengths, page_size):
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
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"paged_attention_decode kernel takes head_dim 1..{MAX_HEAD_DIM}, got {d}"
        )
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_decode: inputs must be contiguous, on one device")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
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
    ``block_tables`` must lie in ``[0, N_pages)``: the kernel trusts them.
    Launches on one stream run in order; the split counters are per
    (device, stream)."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, block_tables, lengths, page_size=page_size
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: unsupported device {q.device}")
    _check_inputs(q, k_pages, v_pages, block_tables, lengths, page_size)
    b, kh, g, d = q.shape
    p_max = block_tables.shape[1]
    code = _cuda.DTYPE_CODES[q.dtype]
    n_split, window = plan(b, kh, g, d, p_max, page_size, code, _sm_count(q.device.index))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    workspace = tickets = None
    if n_split > 1:  # partial (o, m, l) per split, merged in the launch
        workspace = torch.empty(b * kh * g * n_split * (d + 2), dtype=torch.float32,
                                device=q.device)
        tickets = _ticket_buffer(q.device, stream, b * kh * g)
    err = _lib().ray_paged_attention_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if workspace is None else workspace.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        b, kh, g, d, k_pages.shape[1], page_size, p_max, n_split, window,
        1.0 / d**0.5, code, stream,
    )
    _cuda.check(err, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def _gather(k_pages, v_pages, block_tables, page_size):
    """Every slot's pages gathered into contiguous f32 [B, S_max, KH, D]."""
    kh, _, _, d = k_pages.shape
    b, p_max = block_tables.shape
    tables = block_tables.long()
    ks = k_pages.permute(1, 2, 0, 3)[tables].reshape(b, p_max * page_size, kh, d)
    vs = v_pages.permute(1, 2, 0, 3)[tables].reshape(b, p_max * page_size, kh, d)
    return ks.float(), vs.float()


def paged_attention_split_reference(
    q, k_pages, v_pages, block_tables, lengths, *, page_size, n_split
):
    """The kernel's algebra in plain torch: each slot's first
    min(length, S_max) positions cut into ``n_split`` shares of
    ``split_share`` tokens; per share the partial max m, sum l and output
    o (P rounded to the input dtype before P.V, q * scale formed in the
    input dtype); the partials merged in split order,
    out = sum_s e^(m_s - M) o_s / max(sum_s e^(m_s - M) l_s, 1e-30).
    A share that falls empty adds nothing, and length 0 gives zeros."""
    b, kh, g, d = q.shape
    s_max = block_tables.shape[1] * page_size
    ks, vs = _gather(k_pages, v_pages, block_tables, page_size)
    scale = torch.tensor(1.0 / d**0.5, dtype=q.dtype)
    qs = (q * scale.to(q.device)).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qs, ks)
    n_valid = lengths.long().clamp(0, s_max)
    share = torch.tensor([split_share(int(n), n_split) for n in n_valid], device=q.device)
    pos = torch.arange(s_max, device=q.device)[None, :]
    big_m = torch.full((b, kh, g), -math.inf, device=q.device)
    parts = []
    for s in range(n_split):
        lo = (s * share).clamp(max=n_valid)
        hi = (lo + share).clamp(max=n_valid)
        inside = ((pos >= lo[:, None]) & (pos < hi[:, None]))[:, None, None, :]
        sc = scores.masked_fill(~inside, -math.inf)
        m = sc.amax(dim=-1)
        p = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
        o = torch.einsum("bhgs,bshd->bhgd", p.to(q.dtype).float(), vs)
        parts.append((m, p.sum(dim=-1), o))
        big_m = torch.maximum(big_m, m)
    total_l = torch.zeros_like(big_m)
    total_o = torch.zeros(b, kh, g, d, device=q.device)
    for m, l, o in parts:
        alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - big_m))
        total_l = total_l + l * alpha
        total_o = total_o + o * alpha[..., None]
    return (total_o / total_l.clamp_min(1e-30)[..., None]).to(q.dtype)


def paged_attention_reference(
    q, k_pages, v_pages, block_tables, lengths, *, page_size
):
    """Gather formulation, the plain version the kernel is held against:
    every slot's pages gathered into a contiguous [S_max] view, f32 scores,
    masked softmax."""
    d = q.shape[3]
    s_max = block_tables.shape[1] * page_size
    ks, vs = _gather(k_pages, v_pages, block_tables, page_size)
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), ks) / (d**0.5)
    valid = torch.arange(s_max, device=q.device)[None, :] < lengths.long()[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", probs, vs).to(q.dtype)
