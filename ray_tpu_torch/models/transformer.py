"""Flagship model: LLaMA-style decoder (single-device path).

Port of ``ray_tpu/models/transformer.py``: ``ModelConfig``,
``init_params``, ``forward``, ``loss_fn`` and ``make_train_step`` for one
device (pp = sp = 1), dense MLP only. Parameters are a plain dict of
tensors in the JAX package's stacked-layer layout (``blocks[name]`` has a
leading layer axis), so ``params_from_jax`` carries the JAX package's
weights straight across.

On CUDA, attention runs through the port's flash kernels
(``ops/flash_attention.py``, forward and backward), as ``_block`` does on a
TPU; on the CPU it uses ``attention_reference``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    # recompute each block in the backward pass (torch.utils.checkpoint),
    # as the JAX package's jax.checkpoint over the scanned block
    remat: bool = False

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


def param_leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    """The parameter tensors in sorted-key order (jax.tree.leaves' order),
    e.g. for a ``torch.optim.Optimizer``."""
    return [x for k in sorted(tree) for x in
            (param_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


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
    # one unbind per weight: its backward stacks the layers' gradients once,
    # where indexing layer by layer would write a full-size zero gradient
    # per layer
    names = sorted(blocks)
    per_layer = zip(*(blocks[k].unbind(0) for k in names))
    for weights in per_layer:
        p = dict(zip(names, weights))
        if cfg.remat:
            h = checkpoint(_block, cfg, p, h, angles, use_reentrant=False)
        else:
            h = _block(cfg, p, h, angles)
    h = rms_norm(h, params["ln_f"])
    return (h @ params["head"]).float()


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
