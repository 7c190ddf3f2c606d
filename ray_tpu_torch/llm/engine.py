"""Batched generation over a dense KV cache, with the generation settings
and the byte tokenizer.

Port of ``ray_tpu/llm/engine.py`` (``GenerationConfig``, ``ByteTokenizer``,
``LLMEngine``). ``LLMEngine`` prefills a batch of prompts into a
``[L, B, S_max, KH, hd]`` cache (``models/transformer.forward_with_cache``,
written in place), samples at each prompt's last real token, then decodes
one token for every row a step. It serves dense and MoE models alike
(``llm/continuous.py`` takes dense models only, as in the reference).

Sampling follows the reference's key chain through ``_jaxrng``: the first
token is drawn with ``PRNGKey(seed)`` over the whole ``[B, V]``; step ``i``
folds ``i`` into the previous key and draws over ``[B, V]`` from that one
key; ``top_k`` keeps the logits at or above the k-th largest
(``sort(scaled)[:, -k]``). Temperatures divide as f32 tensors, never as
Python floats (on CUDA, ``tensor / float`` multiplies by the reciprocal).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from .. import _jaxrng
from .._device import DeviceLike, resolve_device
from ..models import transformer as tfm


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0            # 0 = no top-k filter
    seed: int = 0
    eos_token: Optional[int] = None


class ByteTokenizer:
    """Self-contained byte-level tokenizer (no external vocab files)."""

    vocab_size = 256 + 2
    bos = 256
    eos = 257

    def encode(self, text: str) -> List[int]:
        return [self.bos] + list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", "replace")


class LLMEngine:
    """Batched generation over the flagship model on ``device`` (default
    ``cuda``; raises without one): one prefill of the whole batch, then one
    decode step a generated token, over a cache that steps update in
    place."""

    def __init__(
        self,
        cfg: tfm.ModelConfig,
        params: Optional[Any] = None,
        *,
        max_len: int = 256,
        tokenizer: Optional[Any] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = min(max_len, cfg.max_seq_len)
        self.tokenizer = tokenizer or ByteTokenizer()
        if params is None:
            params = tfm.init_params(cfg, torch.Generator().manual_seed(0), self.device)
        self.params = tfm.params_to(params, self.device)

    def _prefill(self, tokens: torch.Tensor, lengths: torch.Tensor, cache):
        """Logits [B, V] at each sequence's last real token."""
        b, t = tokens.shape
        positions = torch.arange(t, device=self.device)[None, :].expand(b, t)
        s_max = cache["k"].shape[2]
        seq_mask = torch.arange(s_max, device=self.device)[None, :] < lengths[:, None]
        logits, cache = tfm.forward_with_cache(self.params, tokens, positions, cache,
                                               seq_mask, self.cfg)
        return logits[torch.arange(b, device=self.device), lengths - 1]

    def _decode(self, token: torch.Tensor, pos: torch.Tensor, cache, key: torch.Tensor,
                temperature: float, top_k: int) -> torch.Tensor:
        s_max = cache["k"].shape[2]
        seq_mask = torch.arange(s_max, device=self.device)[None, :] <= pos[:, None]
        logits, _ = tfm.forward_with_cache(self.params, token[:, None], pos[:, None], cache,
                                           seq_mask, self.cfg)
        return self._sample(logits[:, 0], key, temperature, top_k)

    def _sample(self, logits: torch.Tensor, key: torch.Tensor, temperature: float,
                top_k: int) -> torch.Tensor:
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        scaled = logits / self._temp(temperature)
        if top_k:
            kth = torch.sort(scaled, dim=-1).values[:, -int(top_k)][:, None]
            scaled = torch.where(scaled >= kth, scaled, -torch.inf)
        return _jaxrng.categorical(key, scaled)

    def _temp(self, temperature: float) -> torch.Tensor:
        return torch.tensor(max(temperature, 1e-6), dtype=torch.float32, device=self.device)

    def generate_ids(
        self,
        prompts: List[List[int]],
        gen: GenerationConfig = GenerationConfig(),
    ) -> List[List[int]]:
        b = len(prompts)
        lengths_h = np.array([len(p) for p in prompts], dtype=np.int64)
        t = int(lengths_h.max())
        tokens_h = np.zeros((b, t), dtype=np.int64)
        for i, p in enumerate(prompts):
            tokens_h[i, : len(p)] = p
        tokens = torch.from_numpy(tokens_h).to(self.device)
        lengths = torch.from_numpy(lengths_h).to(self.device)
        cache = tfm.init_kv_cache(self.cfg, b, self.max_len, self.device)
        last_logits = self._prefill(tokens, lengths, cache)
        key = _jaxrng.prng_key(gen.seed, device=self.device)
        if gen.temperature == 0.0:
            nxt = torch.argmax(last_logits, dim=-1)
        else:
            nxt = _jaxrng.categorical(key, last_logits / self._temp(gen.temperature))
        pos = lengths
        out = [nxt]
        steps = min(gen.max_new_tokens - 1, self.max_len - t - 1)
        for i in range(max(0, steps)):
            key = _jaxrng.fold_in(key, i)
            nxt = self._decode(nxt, pos, cache, key, gen.temperature, gen.top_k)
            pos = pos + 1
            out.append(nxt)
        gen_tokens = torch.stack(out, dim=1).cpu().numpy()  # the one read back
        results = []
        for i in range(b):
            ids = gen_tokens[i].tolist()
            if gen.eos_token is not None and gen.eos_token in ids:
                ids = ids[: ids.index(gen.eos_token)]
            results.append(ids)
        return results

    def generate(
        self, prompts: List[str], gen: GenerationConfig = GenerationConfig()
    ) -> List[str]:
        enc = [self.tokenizer.encode(p) for p in prompts]
        cfg = gen if gen.eos_token is not None else GenerationConfig(
            max_new_tokens=gen.max_new_tokens,
            temperature=gen.temperature,
            top_k=gen.top_k,
            seed=gen.seed,
            eos_token=getattr(self.tokenizer, "eos", None),
        )
        return [self.tokenizer.decode(ids) for ids in self.generate_ids(enc, cfg)]
