"""A torch port of the parts of ``jax.random`` that decode sampling uses.

Ports what ``ray_tpu/llm/continuous.py`` draws from ``jax.random``
(``PRNGKey``, ``fold_in``, ``categorical``): threefry2x32 as in
``jax/_src/prng.py`` with ``jax_threefry_partitionable=True`` (the
default in jax 0.9), the bits-to-float mapping of ``uniform``, and the
low-range Gumbel sampler behind ``categorical``.

torch has little ``uint32`` arithmetic, so every 32-bit word is an int64
tensor holding a value in ``[0, 2**32)``, masked after each add and shift.
A key is an int64 tensor of shape ``[..., 2]``; leading dimensions batch
independent keys, which is how the engine samples every slot in one call.
Bits and uniforms are bit-identical to jax's (``tests/test_torch_jaxrng.py``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = 1.1754943508222875e-38  # np.finfo(np.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of count words (x1, x2) under key (k1, k2);
    all arguments broadcast, 32-bit values in int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` of a uint32 seed (or a tensor of seeds):
    the key words are ``(seed >> 32, seed & 0xFFFFFFFF)`` = ``(0, seed)``."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the count words ``(0, data)`` under
    ``key``. ``data`` (int or tensor) broadcasts against ``key[..., 0]``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` (``jax.random.bits``), for
    each key in ``key``'s leading dimensions: result ``[*key.shape[:-1],
    *shape]``. The counts are the row-major index as a 64-bit iota split
    into (hi, lo) words; the bits are ``y1 ^ y2``."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(tuple(shape))
    lead = key.shape[:-1]
    expand = (...,) + (None,) * len(shape)
    k1, k2 = key[..., 0][expand], key[..., 1][expand]
    y1, y2 = threefry2x32(k1, k2, (idx >> 32) & _MASK, idx & _MASK)
    return (y1 ^ y2).expand(*lead, *shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in ``[minval, maxval)`` as ``jax.random.uniform`` maps
    them: the top 23 bits become the mantissa of a float in ``[1, 2)``."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ("low") mode, f32."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (Gumbel-argmax); one
    key per row of ``logits``: ``key`` is ``[*logits.shape[:-1], 2]``."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
