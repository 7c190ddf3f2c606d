"""A torch port of the parts of ``jax.random`` that decode sampling uses.

Ports what ``ray_tpu/llm/continuous.py`` and ``ray_tpu/llm/engine.py``
draw from ``jax.random`` (``PRNGKey``, ``fold_in``, ``categorical``) and
what the scheduler draws (``uniform``, and ``randint`` at
``ray_tpu/scheduler/hybrid.py:248``), and the ``normal`` draws of
``ray_tpu/rllib/ppo.py::dense_init``:
threefry2x32 as in
``jax/_src/prng.py`` with ``jax_threefry_partitionable=True`` (the
default in jax 0.9), the bits-to-float mapping of ``uniform``, and the
low-range Gumbel sampler behind ``categorical``.

torch has little ``uint32`` arithmetic, so every 32-bit word is an int64
tensor holding a value in ``[0, 2**32)``, masked after each add and shift.
A key is an int64 tensor of shape ``[..., 2]``; leading dimensions batch
independent keys, which is how the engine samples every slot in one call.
Bits, uniforms and randint draws are bit-identical to jax's (``tests/test_torch_jaxrng.py``);
``normal`` writes out XLA's single-precision ``erf_inv`` in its order of
operations and holds within 1e-6 of ``jax.random.normal``
(``tests/test_torch_rllib.py``): its ``log1p`` and ``sqrt`` may differ by
an ulp, as ``gumbel``'s ``log`` may.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
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


def _as_words(x, device) -> torch.Tensor:
    """32-bit words of an int or an integer tensor, as int64. A Python int
    is filled on the device, not copied there, so the scheduler's programs
    build keys without a host-to-device copy that would wait on the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _MASK
    if isinstance(x, int) or (hasattr(x, "dtype") and getattr(x, "shape", None) == ()):
        return torch.full((), int(x) & _MASK, dtype=torch.int64, device=device)
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` of a uint32 seed (or a tensor of seeds):
    the key words are ``(seed >> 32, seed & 0xFFFFFFFF)`` = ``(0, seed)``."""
    seed = _as_words(seed, device)
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the count words ``(0, data)`` under
    ``key``. ``data`` (int or tensor) broadcasts against ``key[..., 0]``."""
    data = _as_words(data, key.device)
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
    return (y1 ^ y2).expand(tuple(lead) + tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in ``[minval, maxval)`` as ``jax.random.uniform`` maps
    them: the top 23 bits become the mantissa of a float in ``[1, 2)``."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one key into ``num`` keys ``[num, 2]``: with
    partitionable threefry, key ``i`` is the hash of the counts ``(0, i)``,
    which is ``fold_in(key, i)``."""
    return fold_in(key[None, :], torch.arange(num, device=key.device))


def randint(key: torch.Tensor, minval, maxval) -> torch.Tensor:
    """One int32 draw in ``[minval, maxval)`` as ``jax.random.randint(key,
    (), minval, maxval)`` makes it: 32 bits from each half of
    ``split(key)``, folded into the span with uint32 arithmetic (the span
    is 1 where ``maxval <= minval``). ``minval`` and ``maxval`` are ints or
    0-d integer tensors on ``key``'s device; no value is read on the host."""
    dev = key.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    k1, k2 = split(key)
    higher = random_bits(k1, ())
    lower = random_bits(k2, ())
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _MASK)
    multiplier = torch.remainder(torch.full_like(span, 1 << 16), span)
    multiplier = torch.remainder((multiplier * multiplier) & _MASK, span)
    offset = ((torch.remainder(higher, span) * multiplier) & _MASK) + torch.remainder(lower, span)
    offset = torch.remainder(offset & _MASK, span)
    return (lo + offset).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ("low") mode, f32."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (Gumbel-argmax). A
    single key ``[2]`` draws the Gumbel noise over the whole of ``logits``,
    as jax does for a batch from one key; a key per row is
    ``[*logits.shape[:-1], 2]``."""
    shape = tuple(logits.shape) if key.dim() == 1 else (logits.shape[-1],)
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)


# XLA's ErfInv32 (Giles' single-precision approximation): the polynomial
# coefficients for w < 5 and for w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_F32_MAX = 3.4028234663852886e38


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` on f32 as XLA expands it: ``w = -log1p(-x*x)``,
    a degree-8 polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``,
    times ``x``; ``+-1`` maps to ``+-`` the largest float. ``x`` is f32."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coefficient(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype, device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype, device=x.device))

    # each Horner step ``c + p * w`` is rounded once, as XLA contracts it
    # into a fused multiply-add: the f32 product is exact in f64
    p, wd = coefficient(0), w.double()
    for i in range(1, len(_ERFINV_LT5)):
        p = (p.double() * wd + coefficient(i).double()).float()
    return torch.where(x.abs() == 1.0, x * _F32_MAX, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in f32 (``_normal_real``): ``sqrt(2) *
    erf_inv(u)`` of a uniform ``u`` on ``(nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.tensor(np.sqrt(2), dtype=torch.float32, device=key.device) * erf_inv(u)
