"""Ring attention: sequence parallelism over the mesh's ``sp`` axis.

Port of ``ray_tpu/ops/ring_attention.py``. Each rank holds one shard of
the sequence; the K/V shards travel around the ring by ``ppermute`` while
every rank folds each visiting block into an online-softmax accumulator,
in f32, as the reference does in ``jnp.einsum`` (the reference has no
Pallas kernel here, so neither does the port). The global positions, the
``-1e30`` mask of future keys and the accumulator update are the
reference's; the last rotation, whose blocks no step reads, is skipped.

q: [B, T_local, H, D], k/v: [B, T_local, Hkv, D] per rank (GQA when
Hkv < H); returns [B, T_local, H, D] in q's dtype.
"""
from __future__ import annotations

import torch

from ..parallel.collectives import ppermute
from ..parallel.mesh import Mesh


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis: str = "sp", *, causal: bool = True) -> torch.Tensor:
    sp = mesh.size(axis)
    idx = mesh.index(axis)
    b, t, h, d = q.shape
    hkv = k.shape[2]
    groups = h // hkv
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), device=q.device))
    qh = q.reshape(b, t, hkv, groups, d).float()
    q_pos = idx * t + torch.arange(t, device=q.device)  # global positions of local queries
    perm = [(i, (i + 1) % sp) for i in range(sp)]

    o = torch.zeros(b, t, hkv, groups, d, device=q.device)
    m = torch.full((b, hkv, groups, t), float("-inf"), device=q.device)
    l = torch.zeros(b, hkv, groups, t, device=q.device)
    k_cur, v_cur = k, v
    for step in range(sp):
        kv_idx = (idx - step) % sp
        s = torch.einsum("bthgd,bshd->bhgts", qh, k_cur.float()) * scale
        if causal:
            k_pos = kv_idx * t + torch.arange(t, device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a fully masked row: exp(-1e30 - m) underflows to 0
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgts,bshd->bthgd", p, v_cur.float())
        o = o * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
        if step < sp - 1:
            k_cur = ppermute(k_cur, mesh, axis, perm)
            v_cur = ppermute(v_cur, mesh, axis, perm)
    denom = l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return (o / denom).reshape(b, t, h, d).to(q.dtype)
