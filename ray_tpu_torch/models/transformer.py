"""Flagship model: LLaMA-style decoder, on one device or a mesh.

Port of ``ray_tpu/models/transformer.py``: ``ModelConfig``,
``init_params``, ``param_specs``, ``shard_params``, ``forward``,
``loss_fn`` and ``make_train_step``, with the dense MLP or Switch-MoE
layers (``models/moe.py``), and the KV-cache inference path
(``init_kv_cache``, ``forward_with_cache``) that ``llm/engine.py`` runs.
Parameters are a plain dict of tensors in the JAX package's stacked-layer
layout (``blocks[name]`` has a leading layer axis, and ``blocks["moe"]`` is
a dict of such stacks), so ``params_from_jax`` carries the JAX package's
weights straight across.

On a mesh (``parallel/mesh.py``) every rank runs the same program on its
shard, as JAX's ``shard_map`` does with ``pp`` and ``sp`` manual; ``dp``
and ``tp``, automatic in JAX, are explicit here:

- ``dp``: each rank gets its own rows of the batch; the train step sums
  the gradients over ``dp`` (and ``sp``);
- ``tp``: Megatron's column-parallel ``wq``/``wk``/``wv``/``w_gate``/
  ``w_up`` behind *f* (``copy_to``) and row-parallel ``wo``/``w_down``
  before *g* (``psum``); a vocab-parallel embedding (mask, look up, psum)
  and ``head`` logits gathered over ``tp``; MoE experts over ``tp``;
- ``pp``: the layer stack split into stages, run by ``ops/pipeline.py``;
- ``sp``: each rank gets a slice of the positions (rope angles offset by
  its ``sp`` index) and attends through ring or Ulysses attention.

A mesh of size 1 runs no collective: ``forward(..., mesh=None)`` is the
same code on a mesh whose every axis has size 1. With ``sp == 1``,
attention on CUDA runs through the port's flash kernels
(``ops/flash_attention.py``, forward and backward), as ``_block`` does on
a TPU; on the CPU it uses ``attention_reference``. The KV-cache path
attends in plain torch over the cache, as the reference does in XLA.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.layers import (apply_rope, attention_reference, rms_norm, rope_freqs, rotate,
                          swiglu)
from ..ops.pipeline import pipeline_apply
from ..ops.ring_attention import ring_attention
from ..ops.ulysses import ulysses_attention
from ..parallel.collectives import all_gather, all_reduce, copy_to, gather, psum
from ..parallel.mesh import Mesh, MeshConfig, local_shard
from . import moe as moe_mod


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    n_experts: int = 0  # 0 = dense MLP; >0 = Switch-MoE every layer
    expert_capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16
    # sequence-parallel attention: "ring" (ops/ring_attention.py) or
    # "ulysses" (ops/ulysses.py)
    sp_attention: str = "ring"
    # recompute each block in the backward pass (torch.utils.checkpoint),
    # as the JAX package's jax.checkpoint over the scanned block
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked-layer parameter dict, drawn from ``generator`` (on the
    generator's own device, then moved), so one CPU generator gives the
    same weights for every target device."""
    device = resolve_device(device)
    d, hd, L, dt = cfg.d_model, cfg.head_dim, cfg.n_layers, cfg.dtype

    def norm_init(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def dense_init(*shape, scale=None):
        scale = scale or shape[-2] ** -0.5
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * scale
        return w.to(device=device, dtype=dt)

    blocks = {
        "ln1": norm_init(L, d),
        "ln2": norm_init(L, d),
        "wq": dense_init(L, d, cfg.n_heads * hd),
        "wk": dense_init(L, d, cfg.n_kv_heads * hd),
        "wv": dense_init(L, d, cfg.n_kv_heads * hd),
        "wo": dense_init(L, cfg.n_heads * hd, d),
    }
    if cfg.n_experts > 0:
        blocks["moe"] = moe_mod.init_moe(cfg.n_experts, d, cfg.d_ff, L, generator, dt,
                                         device)
    else:
        blocks["w_gate"] = dense_init(L, d, cfg.d_ff)
        blocks["w_up"] = dense_init(L, d, cfg.d_ff)
        blocks["w_down"] = dense_init(L, cfg.d_ff, d)
    return {
        "embed": dense_init(cfg.vocab_size, d, scale=0.02),
        "blocks": blocks,
        "ln_f": norm_init(d),
        "head": dense_init(d, cfg.vocab_size),
    }


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy: move
        # the bits as int16 and reinterpret them
        t = torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's parameter pytree, given as (nested dicts of)
    numpy arrays, as the port's dict of tensors on ``device``; nested dicts
    (an MoE model's ``blocks["moe"]``) keep their nesting."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_tensor(np.asarray(tree), device)


def params_to(tree: Any, device: torch.device) -> Any:
    """A parameter tree (dicts and lists of tensors) with every tensor moved
    to ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    return tree.to(device)


def param_leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    """The parameter tensors in sorted-key order (jax.tree.leaves' order),
    e.g. for a ``torch.optim.Optimizer``."""
    return [x for k in sorted(tree) for x in
            (param_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def layer(blocks: Dict[str, Any], li: int) -> Dict[str, Any]:
    """One layer's weights out of the stacked ``blocks`` dict (nested dicts
    kept)."""
    return {k: layer(v, li) if isinstance(v, dict) else v[li] for k, v in blocks.items()}


def _unbind_layers(blocks: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every layer's weights, one ``unbind`` per stacked tensor: its
    backward stacks the layers' gradients once, where indexing layer by
    layer would write a full-size zero gradient per layer."""
    parts = {k: _unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in blocks.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Sharding over a mesh
# ---------------------------------------------------------------------------

# every axis of size 1: each collective is the identity (the device is unused)
_ONE_DEVICE = Mesh(MeshConfig(), 0, torch.device("cpu"))

Spec = Tuple[Optional[str], ...]


def param_specs(cfg: ModelConfig, pp: int = 1) -> Dict[str, Any]:
    """The spec of each parameter (an axis name or None per dimension, as
    the reference's ``PartitionSpec``): Megatron tp sharding, the layer axis
    over pp when pipelined (each stage holds its slice of the stack)."""
    lp = "pp" if pp > 1 else None
    blocks = {
        "ln1": (lp, None),
        "ln2": (lp, None),
        "wq": (lp, None, "tp"),
        "wk": (lp, None, "tp"),
        "wv": (lp, None, "tp"),
        "wo": (lp, "tp", None),
    }
    if cfg.n_experts > 0:
        blocks["moe"] = moe_mod.moe_specs(lp)
    else:
        blocks["w_gate"] = (lp, None, "tp")
        blocks["w_up"] = (lp, None, "tp")
        blocks["w_down"] = (lp, "tp", None)
    return {"embed": ("tp", None), "blocks": blocks, "ln_f": (None,), "head": (None, "tp")}


def _map_specs(fn: Callable[[torch.Tensor, Spec], torch.Tensor], tree: Dict[str, Any],
               specs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _map_specs(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k])
            for k, v in tree.items()}


def check_mesh(cfg: ModelConfig, mesh: Mesh) -> None:
    """Raises where the mesh cannot shard the model evenly, as the reference
    refuses the same meshes (``device_put`` of a ``tp`` or ``pp`` shard that
    does not divide, ``shard_map`` of Ulysses heads that ``sp`` does not
    divide)."""
    tp, pp, sp = mesh.size("tp"), mesh.size("pp"), mesh.size("sp")
    sizes = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, vocab_size=cfg.vocab_size)
    if cfg.n_experts > 0:
        sizes["n_experts"] = cfg.n_experts
    else:
        sizes["d_ff"] = cfg.d_ff
    for name, n in sizes.items():
        if n % tp:
            raise ValueError(f"tp={tp} must divide {name}={n}")
    if cfg.n_layers % pp:
        raise ValueError(f"pp={pp} must divide n_layers={cfg.n_layers}")
    if sp > 1 and cfg.sp_attention == "ulysses" and (cfg.n_heads // tp) % sp:
        raise ValueError(f"sp={sp} must divide the {cfg.n_heads // tp} heads of a tp rank "
                         "for Ulysses")


def shard_params(params: Dict[str, Any], cfg: ModelConfig, mesh: Mesh) -> Dict[str, Any]:
    """This rank's shard of the full parameters, per ``param_specs``, as new
    tensors on the mesh's device."""
    check_mesh(cfg, mesh)
    return _map_specs(
        lambda x, spec: local_shard(mesh, x, *spec).to(mesh.device).clone(
            memory_format=torch.contiguous_format),
        params, param_specs(cfg, mesh.size("pp")))


def gather_params(tree: Dict[str, Any], cfg: ModelConfig, mesh: Mesh) -> Dict[str, Any]:
    """The full layout back from every rank's shard of a parameter-shaped
    tree (the parameters, or their gradients); the same on every rank."""
    def full(x, spec):
        for dim, axis in enumerate(spec):
            if axis is not None:
                x = gather(x, mesh, axis, dim)
        return x

    return _map_specs(full, tree, param_specs(cfg, mesh.size("pp")))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mlp(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor, mesh: Mesh = _ONE_DEVICE,
         batch_axis: Optional[str] = None) -> torch.Tensor:
    if cfg.n_experts > 0:
        return moe_mod.moe_apply(p["moe"], x, cfg.expert_capacity_factor, mesh, batch_axis)
    y = swiglu(copy_to(x, mesh, "tp"), p["w_gate"], p["w_up"], p["w_down"])
    return psum(y, mesh, "tp")


def _attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    if mesh.size("sp") > 1:
        if cfg.sp_attention == "ulysses":
            return ulysses_attention(q, k, v, mesh, causal=True)
        return ring_attention(q, k, v, mesh, causal=True)
    if q.is_cuda:
        return flash_attention(q, k, v, causal=True)
    return attention_reference(q, k, v, causal=True)


def _block(cfg: ModelConfig, p: Dict[str, torch.Tensor], h: torch.Tensor,
           angles: torch.Tensor, mesh: Mesh, batch_axis: Optional[str]) -> torch.Tensor:
    """One decoder block. h: [B, T(_local), D]; angles already offset;
    this rank's heads and hidden columns of ``p``."""
    b, t, _ = h.shape
    hd, tp = cfg.head_dim, mesh.size("tp")
    x = copy_to(rms_norm(h, p["ln1"]), mesh, "tp")
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads // tp, hd)
    k = (x @ p["wk"]).reshape(b, t, cfg.n_kv_heads // tp, hd)
    v = (x @ p["wv"]).reshape(b, t, cfg.n_kv_heads // tp, hd)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    attn = _attention(cfg, q, k, v, mesh)
    h = h + psum(attn.reshape(b, t, -1) @ p["wo"], mesh, "tp")
    x = rms_norm(h, p["ln2"])
    return h + _mlp(cfg, p, x, mesh, batch_axis)


def _blocks(cfg: ModelConfig, blocks: Dict[str, Any], h: torch.Tensor, angles: torch.Tensor,
            mesh: Mesh, batch_axis: Optional[str]) -> torch.Tensor:
    for p in _unbind_layers(blocks):
        if cfg.remat:
            h = checkpoint(_block, cfg, p, h, angles, mesh, batch_axis, use_reentrant=False)
        else:
            h = _block(cfg, p, h, angles, mesh, batch_axis)
    return h


def _embed(embed: torch.Tensor, tokens: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Vocab-parallel lookup: each tp rank holds a slice of the rows, looks
    up the tokens that fall in it, and a psum over tp joins them."""
    if mesh.size("tp") == 1:
        return embed[tokens]
    rows = embed.shape[0]
    local = tokens - mesh.index("tp") * rows
    inside = (local >= 0) & (local < rows)
    h = torch.where(inside[..., None], embed[local.clamp(0, rows - 1)], 0)
    return psum(h, mesh, "tp")


def _hidden(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig, mesh: Mesh,
            num_microbatches: int) -> torch.Tensor:
    """The final normed hidden state [b, t, D] of this rank's tokens [b, t]
    (its rows, its ``sp`` slice of the positions)."""
    pp, dp = mesh.size("pp"), mesh.size("dp")
    b, t = tokens.shape
    h = _embed(params["embed"], tokens, mesh).to(cfg.dtype)
    off = mesh.index("sp") * t
    angles = rope_freqs(cfg.head_dim, off + t, cfg.rope_theta, device=h.device)[off:]
    if pp == 1:
        h = _blocks(cfg, params["blocks"], h, angles, mesh, "dp")
    else:
        # JAX's microbatch i is global rows [i*B/M, (i+1)*B/M): when dp
        # divides M each lies whole on one dp rank, which runs M/dp of them
        m = num_microbatches or max(1, 2 * pp)
        if (b * dp) % m:
            raise ValueError(f"batch {b * dp} not divisible by microbatches {m}")
        stage = functools.partial(_stage, cfg, angles=angles, mesh=mesh)
        if m % dp and cfg.n_experts > 0:
            return rms_norm(_straddling_microbatches(params, h, m, stage, mesh), params["ln_f"])
        # dense rows are independent: any split of the local rows will do
        m_local = m // dp if m % dp == 0 else math.gcd(m, b)
        x = h.reshape(m_local, b // m_local, t, -1)
        h = pipeline_apply(stage, params["blocks"], x, mesh).reshape(b, t, -1)
    return rms_norm(h, params["ln_f"])


def _straddling_microbatches(params: Dict[str, Any], h: torch.Tensor, m: int,
                             stage: Callable, mesh: Mesh) -> torch.Tensor:
    """The pipeline over this rank's rows of ``h`` [b, t, D] when ``dp``
    does not divide the ``m`` microbatches, so that one straddles ``dp``
    ranks and MoE must route over all of its rows. Every rank gathers the
    batch over ``dp`` and runs the microbatches that hold any of its rows;
    a straddling one runs on each of its ranks, and each keeps its own rows.
    The gather's backward sums the gradients over ``dp`` before it takes
    this rank's rows (``copy_to``), so a rank's gradient reaches the rows of
    a straddling microbatch that another rank owns, and nothing is counted
    twice: each rank's loss reads only its own rows."""
    b, t = h.shape[:2]
    rows = b * mesh.size("dp") // m
    lo = mesh.index("dp") * b
    first, last = lo // rows, (lo + b - 1) // rows
    full = copy_to(all_gather(h, mesh, "dp", 0), mesh, "dp")
    x = full[first * rows:(last + 1) * rows].reshape(last + 1 - first, rows, t, -1)
    out = pipeline_apply(stage, params["blocks"], x, mesh).reshape(-1, t, h.shape[-1])
    return out[lo - first * rows:lo - first * rows + b]


def _stage(cfg: ModelConfig, blocks: Dict[str, Any], x: torch.Tensor, *,
           angles: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One pipeline stage on one microbatch, which MoE routes within."""
    return _blocks(cfg, blocks, x, angles, mesh, None)


def _logits(params: Dict[str, Any], h: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """f32 logits over the full vocabulary (this tp rank's columns of
    ``head``, gathered over tp)."""
    logits = (copy_to(h, mesh, "tp") @ params["head"]).float()
    return all_gather(logits, mesh, "tp", -1)


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            mesh: Optional[Mesh] = None, *, num_microbatches: int = 0) -> torch.Tensor:
    """Logits [B, T, V] (f32) for int tokens [B, T] on their device.

    On a mesh, ``params`` is this rank's shard (``shard_params``), tokens
    are this rank's ``dp`` rows with every position, and the logits are
    those rows' at every position (gathered over ``sp``). The reference's
    dispatch: plain with ``pp == sp == 1``, ring or Ulysses attention over
    ``sp``, the pipeline over ``pp`` (with ``num_microbatches`` global
    microbatches, default 2·pp) with or without ``sp``."""
    mesh = _ONE_DEVICE if mesh is None else mesh
    check_mesh(cfg, mesh)
    chunk = local_shard(mesh, tokens, None, "sp")
    logits = _logits(params, _hidden(params, chunk, cfg, mesh, num_microbatches), mesh)
    return all_gather(logits, mesh, "sp", 1)


# ---------------------------------------------------------------------------
# KV-cache inference path (prefill and single-token decode), the engine core
# of llm/engine.py. Cache layout: {"k", "v"}: [L, B, S_max, KH, hd].
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _block_with_cache(cfg: ModelConfig, p: Dict[str, Any], h: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      positions: torch.Tensor, seq_mask: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block over ``h`` [B, T, D] writing K/V into one layer's cache
    ([B, S_max, KH, hd], in place) at each token's position, padded prompt
    positions included, then attending over the cache with a position mask.

    positions: int [B, T] absolute position of each input token.
    seq_mask: bool [B, S_max] which cache slots are valid after this write.
    cos, sin: [B, T, 1, hd/2] each token's rope rotation at its position.
    """
    b, t, _ = h.shape
    hd = cfg.head_dim
    x = rms_norm(h, p["ln1"])
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, t, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, t, cfg.n_kv_heads, hd)
    q = rotate(q, cos, sin)
    k = rotate(k, cos, sin)
    bidx = torch.arange(b, device=h.device)[:, None].expand(b, t)
    k_cache[bidx, positions] = k.to(k_cache.dtype)
    v_cache[bidx, positions] = v.to(v_cache.dtype)
    s_max = k_cache.shape[1]
    groups = cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(b, t, cfg.n_kv_heads, groups, hd)
    scores = torch.einsum("bthgd,bshd->bhgts", qh.float(), k_cache.float()) / torch.sqrt(
        torch.tensor(float(hd), device=h.device))
    k_pos = torch.arange(s_max, device=h.device)
    causal = k_pos[None, None, :] <= positions[:, :, None]  # [B, T, S]
    valid = causal & seq_mask[:, None, :]
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bhgts,bshd->bthgd", probs, v_cache.float()).to(h.dtype)
    h = h + attn.reshape(b, t, -1) @ p["wo"]
    x = rms_norm(h, p["ln2"])
    return h + _mlp(cfg, p, x), k_cache, v_cache


def forward_with_cache(params: Dict[str, Any], tokens: torch.Tensor,
                       positions: torch.Tensor, cache: Dict[str, torch.Tensor],
                       seq_mask: torch.Tensor, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(logits [B, T, V] f32, the cache). Used for both prefill (T = prompt
    length) and decode (T = 1). Unlike the reference's functional arrays,
    the cache is written in place and returned as given."""
    h = params["embed"][tokens].to(cfg.dtype)
    ang = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                     device=h.device)[positions]  # [B, T, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    for li in range(cfg.n_layers):
        h, _, _ = _block_with_cache(cfg, layer(params["blocks"], li), h, cache["k"][li],
                                    cache["v"][li], positions, seq_mask, cos, sin)
    h = rms_norm(h, params["ln_f"])
    return (h @ params["head"]).float(), cache


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            mesh: Optional[Mesh] = None, *, num_microbatches: int = 0) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1] (mean
    negative log-likelihood, log_softmax in f32).

    On a mesh, tokens are this rank's ``dp`` rows with every position; the
    shift comes before the split over ``sp``. Each rank takes the mean over
    its shard, and the loss is the mean of the ``dp`` × ``sp`` shards'
    means (equal shards), the same on every rank; each rank's gradient
    carries its shard's 1/(dp·sp) share."""
    mesh = _ONE_DEVICE if mesh is None else mesh
    check_mesh(cfg, mesh)
    inputs, targets = (local_shard(mesh, x, None, "sp") for x in (tokens[:, :-1], tokens[:, 1:]))
    logits = _logits(params, _hidden(params, inputs, cfg, mesh, num_microbatches), mesh)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    loss = nll.mean()
    shards = mesh.size("dp") * mesh.size("sp")
    if shards > 1:
        loss = psum(psum(loss / shards, mesh, "dp"), mesh, "sp")
    return loss


def reduce_grads(params: Dict[str, Any], mesh: Mesh) -> None:
    """Sum each gradient over the ranks that share its parameter's value
    but not its loss: every parameter over ``dp`` and ``sp``; ``embed`` also
    over ``pp`` (only stage 0 reads it). ``head`` and ``ln_f`` are not summed
    over ``pp``: after the pipeline's psum every ``pp`` rank computes them
    alike. Parameters replicated over ``tp`` already have equal gradients
    there (Megatron's *f* and *g*)."""
    leaves = param_leaves(params)
    for axis, group in (("dp", leaves), ("sp", leaves), ("pp", [params["embed"]])):
        if mesh.size(axis) == 1:
            continue
        flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in group]), mesh, axis)
        for p, g in zip(group, flat.split([p.numel() for p in group])):
            p.grad.copy_(g.view_as(p))


def make_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer,
                    mesh: Optional[Mesh] = None, *, num_microbatches: int = 0
                    ) -> Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]:
    """Returns ``train_step(params, tokens) -> loss``. ``params``' leaves are
    leaf tensors with ``requires_grad``, and ``optimizer`` is built over
    them (``param_leaves``); the step updates them in place and returns the
    loss as a detached tensor, without a sync. On a mesh, ``params`` is
    this rank's shard and tokens are this rank's ``dp`` rows; the
    gradients are reduced (``reduce_grads``) before ``optimizer.step()``.

    The JAX package's optax optimizers map to torch's as:
    ``optax.adamw(1e-3)`` -> ``torch.optim.AdamW(lr=1e-3, betas=(0.9, 0.999),
    eps=1e-8, weight_decay=1e-4)`` (torch's default decay is 1e-2);
    ``optax.adam(3e-4, mu_dtype=bf16)`` -> ``torch.optim.Adam(lr=3e-4)`` on
    bf16 parameters, whose moments are then bf16."""

    def train_step(params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        loss = loss_fn(params, tokens, cfg, mesh, num_microbatches=num_microbatches)
        loss.backward()
        if mesh is not None:
            reduce_grads(params, mesh)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step
