"""The port's LLM engines on the card: ``LLMEngine`` (dense and MoE), the
disaggregated hand-off through device frames, and the prefix cache's
device-frame hits, each against the same code on the CPU.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor ray_tpu, so it runs where only the port's dependencies
are installed; there, skip the jax-importing tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_llm.py
"""
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.cluster import device_plane as dp
from ray_tpu_torch.cluster import serialization as wire
from ray_tpu_torch.llm import ContinuousBatchingEngine, GenerationConfig, LLMEngine
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.ops import flash_attention as F
from ray_tpu_torch.ops import paged_attention as P

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256,
             max_seq_len=256, dtype=torch.float32)
PROMPTS = [[1, 5, 9, 2, 7, 7, 3], [3, 3, 7], list(range(1, 40)), [2]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _params(cfg, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("over", [{}, dict(n_experts=4)], ids=["dense", "moe"])
@pytest.mark.parametrize("kw", [dict(max_new_tokens=16),
                                dict(max_new_tokens=16, temperature=0.8, top_k=20, seed=3)],
                         ids=["greedy", "top_k"])
def test_llm_engine_card_equals_cpu(cuda, over, kw):
    """f32 streams from the card's engine equal the CPU's, token for token
    (TF32 off; the top_k draw has the same key chain on both)."""
    cfg = T.ModelConfig(**SMALL, **over)
    p = _params(cfg)
    gen = GenerationConfig(**kw)
    on_card = LLMEngine(cfg, p, max_len=64, device=cuda).generate_ids(PROMPTS, gen)
    on_cpu = LLMEngine(cfg, p, max_len=64, device="cpu").generate_ids(PROMPTS, gen)
    assert on_card == on_cpu


def test_moe_forward_launches_flash(cuda):
    cfg = T.ModelConfig(**dict(SMALL, n_experts=4))
    p = _params(cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(1))
    before = F.flash_attention_forward.launches
    got = T.forward(T.params_to(p, cuda), tok.to(cuda), cfg)
    assert F.flash_attention_forward.launches == before + cfg.n_layers
    want = T.forward(p, tok, cfg)
    assert (got.cpu() - want).abs().max().item() <= 1e-3


def test_handoff_through_device_frames(cuda, monkeypatch):
    """prefill_extract hands CUDA tensors; sealed into an arena and landed
    back they are CUDA tensors with equal bytes; the adopted stream equals
    a monolithic engine's, with no prefill and the paged kernel launched."""
    monkeypatch.setenv("RAY_TPU_DEVICE_PLANE", "1")
    from ray_tpu_torch.native.shm_store import NativeObjectStore

    cfg = T.ModelConfig(**SMALL)
    p = _params(cfg)
    gen = GenerationConfig(max_new_tokens=12, temperature=0.7, seed=4)

    def engine():
        return ContinuousBatchingEngine(cfg, p, max_batch=2, page_size=8, n_pages=64,
                                        device=cuda)

    want = list(engine().stream_ids(PROMPTS[2], gen))
    manifest, k, v = engine().prefill_extract(PROMPTS[2], gen)
    assert k.is_cuda and v.is_cuda
    store = NativeObjectStore(path=os.path.join(
        tempfile.gettempdir(), f"t_tcudallm_{os.getpid()}_{time.time_ns()}.shm"),
        capacity=1 << 26)
    try:
        parts, _ = wire.dumps_parts((manifest, k, v))
        store.put_frames("x" * 28, parts)
        with dp.landing("device"):
            m2, k2, v2 = wire.loads(store.get_view("x" * 28))
        assert k2.is_cuda and torch.equal(k2, k) and torch.equal(v2, v)
        dec = engine()
        before = P.paged_attention_decode.launches
        assert list(dec.stream_rid(dec.adopt_pages(m2, k2, v2))) == want
        assert P.paged_attention_decode.launches > before
        assert dec.full_prefill_count == 0 and dec.adopted_count == 1
    finally:
        store.close(unlink=True)


def test_prefix_hit_lands_on_the_card(cuda, monkeypatch):
    monkeypatch.setenv("RAY_TPU_DEVICE_PLANE", "1")
    from ray_tpu_torch.native.shm_store import NativeObjectStore
    from ray_tpu_torch.serve.prefix_cache import SharedPrefixCache

    cfg = T.ModelConfig(**SMALL)
    p = _params(cfg)
    store = NativeObjectStore(path=os.path.join(
        tempfile.gettempdir(), f"t_tcudapfx_{os.getpid()}_{time.time_ns()}.shm"),
        capacity=1 << 26)
    try:
        cache = SharedPrefixCache(store, page_size=8, model_sig="card")
        gen = GenerationConfig(max_new_tokens=10)

        def engine():
            return ContinuousBatchingEngine(cfg, p, max_batch=2, page_size=8, n_pages=64,
                                            device=cuda, prefix_cache=cache)

        want = engine().generate_ids([PROMPTS[2]], gen)
        hit = cache.lookup(PROMPTS[2])
        assert hit is not None and hit.on_device()
        hit.release()
        b = engine()
        assert b.generate_ids([PROMPTS[2]], gen) == want
        assert b.full_prefill_count == 0
        host = np.asarray(cache.lookup(PROMPTS[2]).to_device("cpu")[0])
        assert host.dtype == np.float32
    finally:
        store.close(unlink=True)
