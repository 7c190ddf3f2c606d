"""Flagship model: LLaMA-style decoder (single-device path).

Port of ``ray_tpu/models/transformer.py``: ``ModelConfig``,
``init_params``, ``forward``, ``loss_fn`` and ``make_train_step`` for one
device (pp = sp = 1), with the dense MLP or Switch-MoE layers
(``models/moe.py``, one device), and the KV-cache inference path
(``init_kv_cache``, ``forward_with_cache``) that ``llm/engine.py`` runs.
Parameters are a plain dict of tensors in the JAX package's stacked-layer
layout (``blocks[name]`` has a leading layer axis, and ``blocks["moe"]`` is
a dict of such stacks), so ``params_from_jax`` carries the JAX package's
weights straight across.

On CUDA, attention runs through the port's flash kernels
(``ops/flash_attention.py``, forward and backward), as ``_block`` does on a
TPU; on the CPU it uses ``attention_reference``. The KV-cache path attends
in plain torch over the cache, as the reference does in XLA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.layers import (apply_rope, attention_reference, rms_norm, rope_freqs, rotate,
                          swiglu)
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


def params_to(tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A parameter dict with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
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


def _mlp(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    if cfg.n_experts > 0:
        return moe_mod.moe_apply(p["moe"], x, cfg.expert_capacity_factor)
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _block(cfg: ModelConfig, p: Dict[str, torch.Tensor], h: torch.Tensor,
           angles: torch.Tensor) -> torch.Tensor:
    """One decoder block. h: [B, T, D]."""
    b, t, _ = h.shape
    hd = cfg.head_dim
    x = rms_norm(h, p["ln1"])
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, t, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, t, cfg.n_kv_heads, hd)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    if h.is_cuda:
        attn = flash_attention(q, k, v, causal=True)
    else:
        attn = attention_reference(q, k, v, causal=True)
    h = h + attn.reshape(b, t, -1) @ p["wo"]
    x = rms_norm(h, p["ln2"])
    return h + _mlp(cfg, p, x)


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits [B, T, V] (f32) for int tokens [B, T] on their device. One
    device only: the JAX package's pp/sp paths wait for the parallelism
    slice."""
    t = tokens.shape[1]
    h = params["embed"][tokens].to(cfg.dtype)
    angles = rope_freqs(cfg.head_dim, t, cfg.rope_theta, device=h.device)
    for p in _unbind_layers(params["blocks"]):
        if cfg.remat:
            h = checkpoint(_block, cfg, p, h, angles, use_reentrant=False)
        else:
            h = _block(cfg, p, h, angles)
    h = rms_norm(h, params["ln_f"])
    return (h @ params["head"]).float()


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


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1] (mean
    negative log-likelihood, log_softmax in f32)."""
    logits = forward(params, tokens[:, :-1], cfg)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return nll.mean()


def make_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer
                    ) -> Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]:
    """Returns ``train_step(params, tokens) -> loss``. ``params``' leaves are
    leaf tensors with ``requires_grad``, and ``optimizer`` is built over
    them (``param_leaves``); the step updates them in place and returns the
    loss as a detached tensor, without a sync.

    The JAX package's optax optimizers map to torch's as:
    ``optax.adamw(1e-3)`` -> ``torch.optim.AdamW(lr=1e-3, betas=(0.9, 0.999),
    eps=1e-8, weight_decay=1e-4)`` (torch's default decay is 1e-2);
    ``optax.adam(3e-4, mu_dtype=bf16)`` -> ``torch.optim.Adam(lr=3e-4)`` on
    bf16 parameters, whose moments are then bf16."""

    def train_step(params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        loss = loss_fn(params, tokens, cfg)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step
