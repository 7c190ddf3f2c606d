"""Flagship model: LLaMA-style decoder (single-device path).

Port of ``ray_tpu/models/transformer.py``: ``ModelConfig``,
``init_params`` and ``forward`` for one device (pp = sp = 1), dense MLP
only. Parameters are a plain dict of tensors in the JAX package's
stacked-layer layout (``blocks[name]`` has a leading layer axis), so
``params_from_jax`` carries the JAX package's weights straight across.

On CUDA, attention runs through the port's flash kernel
(``ops/flash_attention.py``), as ``_block`` does on a TPU; on the CPU it
uses ``attention_reference``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.layers import apply_rope, attention_reference, rms_norm, rope_freqs, swiglu


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
    n_experts: int = 0  # the port has the dense MLP only (see _check_dense)
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "ray_tpu_torch ports the dense MLP only; the MoE layers "
            "(ray_tpu/models/moe.py) wait for a later slice"
        )


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked-layer parameter dict, drawn from ``generator`` (on the
    generator's own device, then moved), so one CPU generator gives the
    same weights for every target device."""
    _check_dense(cfg)
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
        "w_gate": dense_init(L, d, cfg.d_ff),
        "w_up": dense_init(L, d, cfg.d_ff),
        "w_down": dense_init(L, cfg.d_ff, d),
    }
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
    numpy arrays, as the port's dict of tensors on ``device``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_tensor(np.asarray(tree), device)


def params_to(tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A parameter dict with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def layer(blocks: Dict[str, torch.Tensor], li: int) -> Dict[str, torch.Tensor]:
    """One layer's weights out of the stacked ``blocks`` dict."""
    return {k: v[li] for k, v in blocks.items()}


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
    return h + swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits [B, T, V] (f32) for int tokens [B, T] on their device. One
    device only: the JAX package's pp/sp paths wait for the parallelism
    slice."""
    _check_dense(cfg)
    t = tokens.shape[1]
    h = params["embed"][tokens].to(cfg.dtype)
    angles = rope_freqs(cfg.head_dim, t, cfg.rope_theta, device=h.device)
    blocks = params["blocks"]
    for li in range(cfg.n_layers):
        h = _block(cfg, layer(blocks, li), h, angles)
    h = rms_norm(h, params["ln_f"])
    return (h @ params["head"]).float()
