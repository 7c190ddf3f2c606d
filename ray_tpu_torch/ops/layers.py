"""Elementary model ops: RMSNorm, RoPE, SwiGLU, attention (plain torch).

Port of ``ray_tpu/ops/layers.py``. The rounding points follow the JAX
functions: ``rms_norm`` normalises in f32, casts back, and only then
multiplies by the weight; ``attention_reference`` forms scores in the
input dtype and softmaxes in f32. The flash kernel in
``flash_attention.py`` replaces ``attention_reference`` on CUDA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * weight


def rope_freqs(head_dim: int, max_len: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """[max_len, head_dim//2] rotation angles (f32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv = 1.0 / (theta ** exps)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of ``x``'s last axis by ``cos``/``sin``, which
    broadcast against ``x[..., :D/2]``; computed in f32, cast back."""
    dtype = x.dtype
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dtype)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [..., T, H, D]; angles: [T, D/2] (already offset for this shard)."""
    return rotate(x, torch.cos(angles)[..., :, None, :],
                  torch.sin(angles)[..., :, None, :])


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def in_dtype(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python scalar as a 0-d tensor of ``dtype``: arithmetic with it
    rounds the scalar to ``dtype`` first, as JAX does with a weakly typed
    Python scalar (torch would otherwise compute with the f32 value)."""
    return torch.tensor(value, dtype=torch.float32).to(dtype)


def attention_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain softmax attention with GQA head-group broadcast. Numerics
    reference for the flash kernel."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    qh = q.reshape(b, t, hkv, groups, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qh, k)
    scores = scores / in_dtype(math.sqrt(d), q.dtype).to(q.device)
    scores = scores.float()
    if causal:
        q_pos = torch.arange(t, device=q.device) + q_offset
        k_pos = torch.arange(s, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", p, v)
    return out.reshape(b, t, h, d)
