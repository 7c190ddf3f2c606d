"""Continuous batching engine with a paged KV cache.

Port of ``ray_tpu/llm/continuous.py`` (``PagedKVPool`` and
``ContinuousBatchingEngine``: submit, admission, prefill, decode step,
sampling, streaming).

- **Paged KV pool**: one buffer of fixed-size pages per K and V,
  ``[n_layers, kv_heads, n_pages, page, head_dim]`` (head-major, so the
  decode kernel reads one head's pool with no transpose), shared by every
  sequence through per-slot block tables. Page 0 is the scratch page.
  Unlike the JAX arrays, the pool is updated in place.
- **Continuous batching**: B decode slots; requests admit into free slots
  as others finish, backpressured by free pages.
- **Decode step**: one token for all slots. Attention goes through
  ``ops/paged_attention.paged_attention_decode``: the CUDA kernel on the
  GPU, its plain gather version on the CPU (the JAX engine's
  ``use_pallas_attention`` switch becomes the choice by device).
- **KV write**: as in the JAX engine, inactive slots write page 0, offset
  0 with the value it already holds, so the duplicate indices of one
  scatter carry identical values and the write stays deterministic on CUDA.
- **Sampling**: greedy is ``argmax`` of f32 logits; temperature > 0 draws
  ``categorical(fold_in(PRNGKey(seed), position))`` through ``_jaxrng``,
  the JAX engine's exact key stream, so a slot's tokens depend only on its
  request's seed and position and match the JAX engine token for token.
- **Prefix cache** (``prefix_cache=``, a ``serve.prefix_cache``
  ``SharedPrefixCache``): an admit restores the longest cached page-aligned
  prefix into its pages and runs ``_prefill_suffix`` (plain torch over the
  slot's whole table, as the reference's einsums) on the rest; every admit
  publishes its prompt's full pages.
- **Disaggregated prefill/decode**: ``prefill_extract`` prefills a prompt,
  samples its first token and hands back a manifest with the prompt's KV
  pages; ``adopt_pages`` grafts them into another engine's pool and admits
  the request with no prefill. With the device plane on, the handed blocks
  are tensors on the engine's device (the wire seals CUDA ones as device
  frames); with it off, host copies.
- **Weights hot-swap**: ``swap_params`` parks admission, lets every active
  slot finish on the old weights (bounded by
  ``cfg.serve_swap_drain_deadline_s``, past which the rest are
  force-evicted), installs the new ones, bumps ``weights_epoch`` and
  retags the prefix cache.

The pool is updated in place, so every block handed to the wire or the
cache is a copy (an index gather of the pages, never a slice view): a later
decode write or page reuse cannot change KV that has been sealed.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import _jaxrng
from .._device import DeviceLike, resolve_device
from ..cluster import device_plane
from ..models import transformer as tfm
from ..ops.layers import rms_norm, rope_freqs, rotate, swiglu
from ..ops.paged_attention import paged_attention_decode
from ..serve.prefix_cache import as_tensor
from .engine import ByteTokenizer, GenerationConfig


@dataclass
class _Slot:
    active: bool = False
    req_id: int = -1
    pos: int = 0  # next position to write
    max_pos: int = 0  # hard stop (prompt + max_new)
    pages: List[int] = field(default_factory=list)
    out: List[int] = field(default_factory=list)
    eos: Optional[int] = None
    temperature: float = 0.0


@dataclass
class _Request:
    req_id: int
    prompt: List[int]
    gen: GenerationConfig


class PagedKVPool:
    """Fixed pool of KV pages + host-side free-list allocator."""

    def __init__(self, cfg: tfm.ModelConfig, n_pages: int, page: int,
                 device: torch.device):
        self.page = page
        self.n_pages = n_pages
        shape = (cfg.n_layers, cfg.n_kv_heads, n_pages, page, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=device)
        # page 0 is the scratch page that inactive decode slots write
        self._free = list(range(1, n_pages))
        self._free_set = set(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1  # minus the scratch page

    def alloc(self, n: int) -> Optional[List[int]]:
        if len(self._free) < n:
            return None
        out = self._free[:n]
        del self._free[:n]
        self._free_set.difference_update(out)
        return out

    def free(self, pages: List[int]) -> None:
        """Return pages to the free-list. Raises on a double free (a page
        already free, the scratch page, out of range, or a duplicate within
        ``pages``): re-adding a freed page would let ``alloc`` hand it to
        two slots whose KV writes would corrupt each other."""
        seen = set()
        for p in pages:
            if p in seen:
                raise ValueError(
                    f"double free: page {p} appears twice in free({pages})"
                )
            if not 0 < p < self.n_pages:
                raise ValueError(
                    f"free of invalid page {p} "
                    f"(scratch page 0 / out of range, n_pages={self.n_pages})"
                )
            if p in self._free_set:
                raise ValueError(
                    f"double free: page {p} is already on the free-list "
                    "(one page allocated to two slots corrupts both "
                    "slots' KV)"
                )
            seen.add(p)
        self._free.extend(pages)
        self._free_set.update(pages)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over the flagship transformer, on
    ``device`` (default ``cuda``; raises without one)."""

    def __init__(
        self,
        cfg: tfm.ModelConfig,
        params: Optional[Dict[str, Any]] = None,
        *,
        max_batch: int = 8,
        page_size: int = 16,
        n_pages: int = 256,
        max_pages_per_seq: Optional[int] = None,
        tokenizer: Optional[Any] = None,
        device: DeviceLike = None,
        prefix_cache: Optional[Any] = None,
        model_id: str = "base",
    ):
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "paged continuous batching supports dense MLP models "
                "(use LLMEngine for MoE)"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.B = max_batch
        self.page = page_size
        self.pool = PagedKVPool(cfg, n_pages, page_size, self.device)
        self.max_pages_per_seq = min(
            max_pages_per_seq
            or (min(cfg.max_seq_len, n_pages * page_size) // page_size),
            self.pool.usable_pages,
        )
        self.tokenizer = tokenizer or ByteTokenizer()
        if params is None:
            params = tfm.init_params(
                cfg, torch.Generator().manual_seed(0), self.device
            )
        self.params = tfm.params_to(params, self.device)
        self.slots = [_Slot() for _ in range(self.B)]
        self.queue: deque = deque()
        self.results: Dict[int, List[int]] = {}
        self._next_req = 0
        # optional cross-replica prefix/KV cache (serve/prefix_cache.py)
        self.prefix_cache = prefix_cache
        # which weights this engine runs, bumped by swap_params: manifests
        # carry both, so a decode engine never grafts KV of other weights
        self.model_id = model_id
        self.weights_epoch = 0
        self._swapping = False
        self._swap_started: Optional[float] = None
        self.swap_force_evicted = 0
        # full prefills against page adoptions (the disaggregated path's
        # zero-re-prefill check reads these)
        self.full_prefill_count = 0
        self.adopted_count = 0
        # rotary tables at max_seq_len, indexed by position (as the JAX
        # engine indexes rope_freqs(head_dim, max_seq_len))
        angles = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                            device=self.device)
        self._cos, self._sin = torch.cos(angles), torch.sin(angles)
        # device-side slot state
        dev = self.device
        self.block_tables = torch.zeros(
            (self.B, self.max_pages_per_seq), dtype=torch.int32, device=dev
        )
        self.positions = torch.zeros(self.B, dtype=torch.int64, device=dev)
        self.cur_tokens = torch.zeros(self.B, dtype=torch.int64, device=dev)
        self.active_mask = torch.zeros(self.B, dtype=torch.bool, device=dev)
        # per-slot temperature (0 = greedy) and uint32 seed (in int64)
        self.temps = torch.zeros(self.B, dtype=torch.float32, device=dev)
        self.seeds = torch.zeros(self.B, dtype=torch.int64, device=dev)

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------
    def _decode_step(self) -> torch.Tensor:
        """One token for every slot. Inactive slots run the same math but
        their KV writes go to the scratch page 0 (see the module note)."""
        cfg, b, page = self.cfg, self.B, self.page
        kh, hd = cfg.n_kv_heads, cfg.head_dim
        groups = cfg.n_heads // kh
        params = self.params
        active = self.active_mask
        # an inactive slot keeps the position it finished at, which can be
        # one past the page cap and the rope table: it runs at position 0
        # (its tokens are dropped and its KV write goes to page 0)
        pos = torch.where(active, self.positions, 0)
        h = params["embed"][self.cur_tokens].to(cfg.dtype)  # [B, D]
        cos, sin = self._cos[pos][:, None, :], self._sin[pos][:, None, :]
        page_ids = self.block_tables.gather(1, (pos // page)[:, None])[:, 0].long()
        page_ids = torch.where(active, page_ids, 0)
        offsets = torch.where(active, pos % page, 0)
        hidx = torch.arange(kh, device=self.device)[None, :]
        idx = (hidx, page_ids[:, None], offsets[:, None])  # broadcast to [B, KH]
        keep = active[:, None, None]
        lengths = (pos + 1).to(torch.int32)
        for li in range(cfg.n_layers):
            p = tfm.layer(params["blocks"], li)
            x = rms_norm(h, p["ln1"])
            q = rotate((x @ p["wq"]).reshape(b, cfg.n_heads, hd), cos, sin)
            k = rotate((x @ p["wk"]).reshape(b, kh, hd), cos, sin)
            v = (x @ p["wv"]).reshape(b, kh, hd)
            pk, pv = self.pool.k[li], self.pool.v[li]  # [KH, N, page, hd] views
            pk[idx] = torch.where(keep, k.to(pk.dtype), pk[idx])
            pv[idx] = torch.where(keep, v.to(pv.dtype), pv[idx])
            attn = paged_attention_decode(
                q.reshape(b, kh, groups, hd), pk, pv, self.block_tables,
                lengths, page_size=page,
            ).reshape(b, cfg.n_heads * hd)
            h = h + attn.to(cfg.dtype) @ p["wo"]
            x2 = rms_norm(h, p["ln2"])
            h = h + swiglu(x2, p["w_gate"], p["w_up"], p["w_down"])
        h = rms_norm(h, params["ln_f"])
        logits = (h @ params["head"]).float()
        nxt = torch.argmax(logits, dim=-1)
        if any(s.active and s.temperature > 0.0 for s in self.slots):
            # per-slot key = fold_in(PRNGKey(seed), position of the token
            # being produced): prefill drew position t, decode goes on at t+1
            keys = _jaxrng.fold_in(_jaxrng.prng_key(self.seeds), pos + 1)
            sampled = _jaxrng.categorical(
                keys, logits / torch.clamp(self.temps, min=1e-6)[:, None]
            )
            nxt = torch.where(self.temps > 0.0, sampled, nxt)
        return nxt

    def _prefill(self, tokens: List[int], t_pad: int, page_ids: List[int]) -> torch.Tensor:
        """Prefill ONE sequence padded to ``t_pad``; write its KV (pad
        positions included) into ``page_ids``; return logits [t_pad, V].
        Attention is plain torch over the prompt, as in the JAX engine."""
        pos = torch.arange(t_pad, device=self.device)
        return self._prefill_layers(tokens, pos, page_ids, table=None)

    def _prefill_suffix(self, tokens: List[int], t_pad: int, hist_len: int,
                        table: torch.Tensor, suffix_page_ids: List[int]) -> torch.Tensor:
        """Prefill the SUFFIX of a sequence whose first ``hist_len`` tokens'
        KV was restored from the prefix cache: write the suffix KV (padded
        to ``t_pad``) into its pages, then attend over history + suffix
        through the slot's whole block-table row ``table`` (key positions
        past each query's own, the scratch page behind unfilled entries
        included, are masked). Returns logits [t_pad, V]."""
        pos = hist_len + torch.arange(t_pad, device=self.device)
        return self._prefill_layers(tokens, pos, suffix_page_ids, table=table)

    def _prefill_layers(self, tokens: List[int], pos: torch.Tensor, page_ids: List[int],
                        table: Optional[torch.Tensor]) -> torch.Tensor:
        """The body of both prefills: the tokens (padded to ``len(pos)``) at
        absolute positions ``pos``, each layer's KV written into
        ``page_ids``, attention causal by position over the keys of
        ``table``'s pages or, with no table, over the tokens' own keys.
        Returns logits [len(pos), V]."""
        cfg, page = self.cfg, self.page
        kh, hd = cfg.n_kv_heads, cfg.head_dim
        groups = cfg.n_heads // kh
        dev = self.device
        params = self.params
        t_pad = pos.shape[0]
        tok = torch.zeros(t_pad, dtype=torch.int64)
        tok[: len(tokens)] = torch.tensor(tokens, dtype=torch.int64)
        h = params["embed"][tok.to(dev)][None].to(cfg.dtype)  # [1, T, D]
        cos, sin = self._cos[pos][None, :, None, :], self._sin[pos][None, :, None, :]
        pages = torch.tensor(page_ids, dtype=torch.int64, device=dev)
        n_keys = t_pad if table is None else table.shape[0] * page
        causal = torch.arange(n_keys, device=dev)[None, :] <= pos[:, None]  # [T, S]
        # a tensor divisor: on CUDA, tensor / float multiplies by the reciprocal
        sqrt_hd = torch.sqrt(torch.tensor(float(hd), device=dev))
        for li in range(cfg.n_layers):
            p = tfm.layer(params["blocks"], li)
            x = rms_norm(h, p["ln1"])
            q = rotate((x @ p["wq"]).reshape(1, t_pad, cfg.n_heads, hd), cos, sin)
            k = rotate((x @ p["wk"]).reshape(1, t_pad, kh, hd), cos, sin)
            v = (x @ p["wv"]).reshape(1, t_pad, kh, hd)
            # head-major pages: [T, KH, hd] -> [KH, n_pages, page, hd]
            pk, pv = self.pool.k[li], self.pool.v[li]  # [KH, N, page, hd] views
            pk[:, pages] = k[0].transpose(0, 1).reshape(kh, -1, page, hd).to(pk.dtype)
            pv[:, pages] = v[0].transpose(0, 1).reshape(kh, -1, page, hd).to(pv.dtype)
            if table is None:
                ks, vs = k[0].transpose(0, 1), v[0].transpose(0, 1)  # [KH, T, hd]
            else:
                rows = table.long()
                ks = pk[:, rows].reshape(kh, n_keys, hd)
                vs = pv[:, rows].reshape(kh, n_keys, hd)
            qh = q[0].reshape(t_pad, kh, groups, hd)
            scores = torch.einsum("tkgd,ksd->tkgs", qh.float(), ks.float()) / sqrt_hd
            scores = scores.masked_fill(~causal[:, None, None, :], -1e30)
            probs = torch.softmax(scores, dim=-1)
            attn = torch.einsum("tkgs,ksd->tkgd", probs, vs.float()).reshape(t_pad, -1)
            h = h + attn[None].to(cfg.dtype) @ p["wo"]
            x2 = rms_norm(h, p["ln2"])
            h = h + swiglu(x2, p["w_gate"], p["w_up"], p["w_down"])
        h = rms_norm(h, params["ln_f"])
        return (h[0] @ params["head"]).float()

    def _pool_pages(self, pages: List[int]):
        """(k, v) blocks ``[L, KH, len(pages), page, hd]`` of the pool's
        ``pages``: an index gather, so a copy that later writes to the pool
        cannot reach; tensors on the engine's device with the device plane
        on, host copies with it off."""
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        k, v = self.pool.k[:, :, idx], self.pool.v[:, :, idx]
        if device_plane.device_plane_enabled():
            return k, v
        return _host_block(k), _host_block(v)

    def _put_pages(self, pages: List[int], k, v) -> None:
        """Write KV blocks (tensors on any device, or numpy) into ``pages``."""
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        self.pool.k[:, :, idx] = as_tensor(k, self.device).to(self.pool.k.dtype)
        self.pool.v[:, :, idx] = as_tensor(v, self.device).to(self.pool.v.dtype)

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], gen: GenerationConfig) -> int:
        if gen.top_k:
            raise NotImplementedError(
                "per-slot top_k is not supported by the continuous engine "
                "(temperature sampling and greedy are); use LLMEngine"
            )
        if self._swapping and self._swap_started is not None:
            from ..config import cfg

            deadline = float(cfg.serve_swap_drain_deadline_s)
            if deadline > 0 and time.monotonic() - self._swap_started > deadline:
                # the drain has outlived its budget: stop parking; the
                # caller gets a typed, retryable rejection instead of a
                # hang behind one wedged slot
                from ..serve.admission import Overloaded

                raise Overloaded(reason="weights_swap", retry_after_s=min(deadline, 5.0))
        prompt_pages = -(-max(len(prompt), 1) // self.page)
        if prompt_pages > self.max_pages_per_seq:
            raise ValueError(
                f"prompt of {len(prompt)} tokens needs {prompt_pages} pages "
                f"but max_pages_per_seq={self.max_pages_per_seq} "
                f"(page_size={self.page})"
            )
        rid = self._next_req
        self._next_req += 1
        self.queue.append(_Request(rid, list(prompt), gen))
        return rid

    def _pages_needed(self, req: _Request) -> int:
        total = len(req.prompt) + req.gen.max_new_tokens
        return -(-total // self.page)

    def _admit(self) -> None:
        """Fill free slots from the queue while pages are available."""
        if self._swapping:
            # weights hot-swap drain: active slots finish on the OLD
            # weights; the queue stays parked until the new ones are in
            return
        for si, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            req = self.queue[0]
            need = min(self._pages_needed(req), self.max_pages_per_seq)
            pages = self.pool.alloc(need)
            if pages is None:
                break  # backpressure: the POOL is the capacity
            self.queue.popleft()
            prompt = req.prompt
            t = len(prompt)
            # shared prefix cache: restore the longest cached page-aligned
            # prefix, capped so that the LAST real token always runs a live
            # forward pass (its logits seed sampling)
            hit = None
            if self.prefix_cache is not None and t > 1:
                hit = self.prefix_cache.lookup(
                    prompt, max_tokens=((t - 1) // self.page) * self.page
                )
            table = np.zeros(self.max_pages_per_seq, np.int32)
            table[: len(pages)] = pages
            table_d = torch.from_numpy(table).to(self.device)
            if hit is not None:
                last_logits = self._admit_with_prefix(req, pages, table_d, hit)
            else:
                t_pad = max(self.page, -(-t // self.page) * self.page)
                logits = self._prefill(prompt, t_pad, pages[: t_pad // self.page])
                last_logits = logits[t - 1]
                self.full_prefill_count += 1
            if self.prefix_cache is not None:
                # publish this prompt's full pages for other replicas
                self._prefix_insert(prompt, pages, hit.tokens if hit is not None else 0)
            first = self._sample_first(req.gen, last_logits, t)
            if hit is not None:
                hit.release()  # the restored pages are copies: drop the pin
            self._activate(si, req.req_id, t, pages, table_d, first, req.gen)

    def _activate(self, si: int, rid: int, t: int, pages: List[int],
                  table: torch.Tensor, first: int, gen: GenerationConfig) -> None:
        """Slot ``si`` takes request ``rid`` whose prompt of ``t`` tokens is
        in ``pages`` and whose first token is ``first``."""
        slot = self.slots[si]
        slot.active = True
        slot.req_id = rid
        slot.pos = t
        # the prefill already produced token #1, so decode runs
        # max_new-1 steps; the last token is never written back
        slot.max_pos = min(t + gen.max_new_tokens - 1, len(pages) * self.page)
        slot.pages = pages
        slot.eos = gen.eos_token
        slot.temperature = float(gen.temperature)
        slot.out = [first]
        self.block_tables[si] = table
        self.positions[si] = t
        self.cur_tokens[si] = first
        self.active_mask[si] = True
        self.temps[si] = slot.temperature
        self.seeds[si] = gen.seed & 0xFFFFFFFF
        self._maybe_finish(si)

    def _admit_with_prefix(self, req: _Request, pages: List[int], table: torch.Tensor,
                           hit) -> torch.Tensor:
        """Cache-hit admission: copy the hit's KV into this engine's pages
        and prefill only the suffix. Returns the last real token's logits."""
        hist_pages = hit.tokens // self.page
        self._put_pages(pages[:hist_pages], hit.k, hit.v)
        suffix = req.prompt[hit.tokens:]
        ts = len(suffix)
        t_pad = max(self.page, -(-ts // self.page) * self.page)
        suffix_pages = pages[hist_pages: hist_pages + t_pad // self.page]
        logits = self._prefill_suffix(suffix, t_pad, hit.tokens, table, suffix_pages)
        return logits[ts - 1]

    def _prefix_insert(self, prompt: List[int], pages: List[int], covered: int) -> None:
        """Publish the prompt's FULL pages (already in the pool) to the
        shared cache; skipped when the hit already covered them or the
        entry is already published (the gather is a sync on the admit
        path)."""
        ins = (len(prompt) // self.page) * self.page
        if ins <= covered or ins == 0:
            return
        n_pages = ins // self.page
        if n_pages > len(pages):
            return
        if getattr(self.prefix_cache, "contains_prefix", None) and (
            self.prefix_cache.contains_prefix(prompt[:ins])
        ):
            return
        k, v = self._pool_pages(pages[:n_pages])
        self.prefix_cache.insert(prompt[:ins], k, v)

    def _sample_first(self, gen: GenerationConfig, last_logits: torch.Tensor,
                      t: int) -> int:
        if gen.temperature > 0.0:
            # the same key stream as the decode step, at position t
            key = _jaxrng.fold_in(
                _jaxrng.prng_key(gen.seed & 0xFFFFFFFF, device=last_logits.device), t
            )
            temp = torch.tensor([max(gen.temperature, 1e-6)], dtype=torch.float32,
                                device=last_logits.device)
            return int(_jaxrng.categorical(key, last_logits / temp))
        return int(torch.argmax(last_logits))

    # ------------------------------------------------------------------
    # disaggregated serving: the prefill/decode split
    # ------------------------------------------------------------------
    def prefill_extract(self, prompt: List[int], gen: GenerationConfig):
        """Prefill-worker half of the KV hand-off: prefill ``prompt``,
        sample its first token (the ``fold_in(seed, t)`` stream a
        monolithic admit uses), gather the prompt pages out of the pool
        and free them. Returns ``(manifest, k, v)`` with ``k``/``v``
        ``[L, KH, prompt_pages, page, hd]``: tensors on this engine's
        device with the device plane on (the wire seals CUDA ones as device
        frames), host copies with it off."""
        t = len(prompt)
        if t < 1:
            raise ValueError("prefill_extract needs a non-empty prompt")
        t_pad = max(self.page, -(-t // self.page) * self.page)
        prompt_pages = t_pad // self.page
        if prompt_pages > self.max_pages_per_seq:
            raise ValueError(
                f"prompt of {t} tokens needs {prompt_pages} pages but "
                f"max_pages_per_seq={self.max_pages_per_seq}"
            )
        pages = self.pool.alloc(prompt_pages)
        if pages is None:
            raise MemoryError(
                "prefill pool exhausted "
                f"(free={self.pool.free_pages}, need={prompt_pages})"
            )
        try:
            logits = self._prefill(list(prompt), t_pad, pages)
            self.full_prefill_count += 1
            first = self._sample_first(gen, logits[t - 1], t)
            k, v = self._pool_pages(pages)  # copies: freeing the pages cannot reach them
        finally:
            self.pool.free(pages)
        manifest = {
            "prompt": list(prompt),
            "t": t,
            "first": int(first),
            "pages": prompt_pages,
            "page": self.page,
            "gen": {
                "max_new_tokens": int(gen.max_new_tokens),
                "temperature": float(gen.temperature),
                "seed": int(gen.seed),
                "eos_token": gen.eos_token,
            },
            "model": self.model_id,
            "weights_epoch": self.weights_epoch,
        }
        return manifest, k, v

    def adopt_pages(self, manifest: dict, k, v) -> Optional[int]:
        """Decode-engine half of the KV hand-off: graft prefilled KV pages
        into this engine's pool and admit the request mid-batch, with no
        prefill here. Returns the new req_id, or None when the hand-off
        cannot be adopted (page geometry or model mismatch, no free slot,
        pool backpressure): the caller then falls back to ``submit()``, a
        local re-prefill, token-exact since generation is
        seed-deterministic."""
        if manifest.get("page") != self.page:
            return None
        if manifest.get("model", self.model_id) != self.model_id:
            return None  # KV of other weights: refuse, re-prefill
        gen = GenerationConfig(**manifest["gen"])
        t = int(manifest["t"])
        ship_pages = int(manifest["pages"])
        si = next((i for i, s in enumerate(self.slots) if not s.active), None)
        if si is None:
            return None
        need = min(-(-(t + gen.max_new_tokens) // self.page), self.max_pages_per_seq)
        need = max(need, ship_pages)
        if need > self.max_pages_per_seq:
            return None
        pages = self.pool.alloc(need)
        if pages is None:
            return None  # pool backpressure: the POOL is the capacity
        rid = self._next_req
        self._next_req += 1
        self._put_pages(pages[:ship_pages], k, v)
        table = np.zeros(self.max_pages_per_seq, np.int32)
        table[: len(pages)] = pages
        self.adopted_count += 1
        self._activate(si, rid, t, pages, torch.from_numpy(table).to(self.device),
                       int(manifest["first"]), gen)
        return rid

    # ------------------------------------------------------------------
    # weights hot-swap
    # ------------------------------------------------------------------
    def swap_params(self, params: Any, model_id: Optional[str] = None) -> int:
        """Install new weights with epoch-fenced drain semantics: admission
        parks, every ACTIVE slot finishes on the old weights, then the swap
        lands and ``weights_epoch`` bumps; queued requests stay queued and
        admit on the NEW weights. Returns the new epoch.

        The drain is bounded by ``cfg.serve_swap_drain_deadline_s`` (0 =
        unbounded): past it, still-active slots are force-evicted, their
        output recorded as generated so far."""
        from ..config import cfg

        deadline = float(cfg.serve_swap_drain_deadline_s)
        self._swapping = True
        self._swap_started = time.monotonic()
        try:
            while any(s.active for s in self.slots):
                if deadline > 0 and time.monotonic() - self._swap_started > deadline:
                    self._force_evict_active()
                    break
                self.step()
            self.params = tfm.params_to(params, self.device)
            if model_id is not None:
                self.model_id = model_id
            self.weights_epoch += 1
            if self.prefix_cache is not None:
                # KV cached under the OLD weights must never be restored
                # for the new ones: re-namespace the shared cache
                self.prefix_cache.retag(
                    self.model_id if model_id is not None else f"swap{self.weights_epoch}"
                )
        finally:
            self._swapping = False
            self._swap_started = None
        return self.weights_epoch

    def _force_evict_active(self) -> None:
        """Evict every still-active slot at the swap-drain deadline: the
        partial output lands in results (eos-truncated like a normal
        finish), pages free, the slot resets."""
        for si, slot in enumerate(self.slots):
            if not slot.active:
                continue
            out = slot.out
            if slot.eos is not None and slot.eos in out:
                out = out[: out.index(slot.eos)]
            self.results[slot.req_id] = out
            self._release(si)
            self.swap_force_evicted += 1

    def _maybe_finish(self, si: int) -> None:
        slot = self.slots[si]
        done = (
            slot.pos >= slot.max_pos
            or (slot.eos is not None and slot.out and slot.out[-1] == slot.eos)
        )
        if done and slot.active:
            out = slot.out
            if slot.eos is not None and slot.eos in out:
                out = out[: out.index(slot.eos)]
            self.results[slot.req_id] = out
            self._release(si)

    def _release(self, si: int) -> None:
        self.pool.free(self.slots[si].pages)
        self.slots[si] = _Slot()
        self.active_mask[si] = False

    def step(self) -> List[int]:
        """Admit + one decode step for all active slots. Returns req_ids
        finished in this step."""
        self._admit()
        before = set(self.results)
        if any(s.active for s in self.slots):
            nxt = self._decode_step()
            nxt_h = nxt.cpu().numpy()
            self.positions += self.active_mask.long()
            self.cur_tokens = nxt
            for si, slot in enumerate(self.slots):
                if not slot.active:
                    continue
                slot.pos += 1
                slot.out.append(int(nxt_h[si]))
                self._maybe_finish(si)
        return [r for r in self.results if r not in before]

    def pending(self) -> int:
        return len(self.queue) + sum(s.active for s in self.slots)

    # ------------------------------------------------------------------
    def generate_ids(
        self,
        prompts: List[List[int]],
        gen: GenerationConfig = GenerationConfig(),
    ) -> List[List[int]]:
        ids = [self.submit(p, gen) for p in prompts]
        while any(i not in self.results for i in ids):
            self.step()
        return [self.results.pop(i) for i in ids]

    def stream_ids(
        self,
        prompt: List[int],
        gen: GenerationConfig = GenerationConfig(),
    ):
        """Incremental generation: yields token ids as decode steps produce
        them, while the engine keeps serving other in-flight requests."""
        rid = self.submit(prompt, gen)
        yield from self.stream_rid(rid)

    def stream_rid(self, rid: int):
        """Stream tokens for a request id already queued by ``submit()``."""
        yielded = 0
        try:
            while rid not in self.results:
                self.step()
                slot = next(
                    (s for s in self.slots if s.req_id == rid and s.active),
                    None,
                )
                if slot is not None:
                    out = slot.out
                    if slot.eos is not None and slot.eos in out:
                        out = out[: out.index(slot.eos)]
                    while yielded < len(out):
                        yield out[yielded]
                        yielded += 1
            final = self.results.pop(rid)
            while yielded < len(final):
                yield final[yielded]
                yielded += 1
        finally:
            # consumer abandoned mid-stream: reclaim the slot's pages and
            # stop burning decode steps on a dead client
            self._cancel(rid)

    def _cancel(self, rid: int) -> None:
        """Drop a request wherever it is: queued, active, or finished."""
        self.results.pop(rid, None)
        for i, req in enumerate(self.queue):
            if req.req_id == rid:
                del self.queue[i]
                return
        for si, slot in enumerate(self.slots):
            if slot.active and slot.req_id == rid:
                self._release(si)
                return

    def generate(
        self, prompts: List[str], gen: GenerationConfig = GenerationConfig()
    ) -> List[str]:
        enc = [self.tokenizer.encode(p) for p in prompts]
        if gen.eos_token is None:
            gen = GenerationConfig(
                max_new_tokens=gen.max_new_tokens,
                temperature=gen.temperature,
                top_k=gen.top_k,
                seed=gen.seed,
                eos_token=getattr(self.tokenizer, "eos", None),
            )
        out = self.generate_ids(enc, gen)
        return [self.tokenizer.decode(ids) for ids in out]

    def stats(self) -> dict:
        out = {
            "free_pages": self.pool.free_pages,
            "total_pages": self.pool.n_pages,
            "active_slots": sum(s.active for s in self.slots),
            "queued": len(self.queue),
            "model_id": self.model_id,
            "weights_epoch": self.weights_epoch,
            "full_prefill_count": self.full_prefill_count,
            "adopted_count": self.adopted_count,
            "swap_force_evicted": self.swap_force_evicted,
        }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out


def _host_block(t: torch.Tensor):
    """A host copy of a gathered KV block: numpy where numpy names the
    dtype, else (bfloat16 without ``ml_dtypes``) a CPU tensor."""
    h = t.cpu()  # ``t`` is a gather's fresh tensor: on the CPU it is the copy
    npd = device_plane.numpy_dtype(device_plane.dtype_name(t.dtype))
    if npd is None:
        return h
    return h.reshape(-1).view(torch.uint8).numpy().view(npd).reshape(tuple(h.shape))
