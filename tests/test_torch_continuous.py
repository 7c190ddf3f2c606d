"""ray_tpu_torch's continuous-batching engine against ray_tpu's.

Correctness bar: from the same params and prompts, greedy AND
temperature > 0 streams are token-exact against the JAX engine with its
Pallas decode kernel (interpret mode), and the mirrored cases of
tests/test_continuous_batching.py (admission interleaving, page-pool
backpressure, EOS, multi-page prompts) give the same tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.continuous import ContinuousBatchingEngine as JEngine
from ray_tpu.llm.engine import GenerationConfig as JGen
from ray_tpu.models import transformer as J
from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine, PagedKVPool
from ray_tpu_torch.llm.engine import ByteTokenizer, GenerationConfig
from ray_tpu_torch.models import transformer as T

SMALL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)


@pytest.fixture(scope="module")
def small():
    cj = J.ModelConfig(dtype=jnp.float32, **SMALL)
    ct = T.ModelConfig(dtype=torch.float32, **SMALL)
    pj = J.init_params(cj, jax.random.PRNGKey(7))
    pt = T.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


def engines(small, pallas=False, **kw):
    cj, ct, pj, pt = small
    je = JEngine(cj, pj, use_pallas_attention=pallas, pallas_interpret=pallas, **kw)
    te = ContinuousBatchingEngine(ct, pt, device="cpu", **kw)
    return je, te


def gens(**kw):
    return JGen(**kw), GenerationConfig(**kw)


PROMPTS = [[1, 5, 9, 2], [3, 3, 7], [11, 12, 13, 14, 15, 16, 17], [2]]


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 3), (1.3, 2**32 - 7)])
def test_streams_match_jax_pallas_engine(small, temperature, seed):
    je, te = engines(small, pallas=True, max_batch=3, page_size=8, n_pages=48)
    gj, gt = gens(max_new_tokens=12, temperature=temperature, seed=seed)
    assert te.generate_ids(PROMPTS, gt) == je.generate_ids(PROMPTS, gj)


def test_sampled_stream_ignores_co_resident_requests(small):
    """A slot's stream depends on its request's seed and position only."""
    _, te = engines(small, max_batch=3, page_size=8, n_pages=48)
    gen = GenerationConfig(max_new_tokens=10, temperature=0.9, seed=5)
    alone = te.generate_ids([PROMPTS[0]], gen)[0]
    crowded = te.generate_ids(PROMPTS, gen)[0]
    assert alone == crowded


def test_continuous_admission_interleaves(small):
    je, te = engines(small, max_batch=2, page_size=8, n_pages=32)
    prompts = [[i + 1, i + 2, i + 3] for i in range(6)]
    gj, gt = gens(max_new_tokens=8)
    assert te.generate_ids(prompts, gt) == je.generate_ids(prompts, gj)
    assert te.pool.free_pages == te.pool.usable_pages
    assert te.stats()["active_slots"] == 0


def test_page_pool_backpressure(small):
    # each request needs ceil((3+16)/8)=3 pages; 5 usable -> one at a time
    je, te = engines(small, max_batch=4, page_size=8, n_pages=6)
    prompts = [[5, 6, 7] for _ in range(5)]
    gj, gt = gens(max_new_tokens=16)
    out = te.generate_ids(prompts, gt)
    assert len(out) == 5 and all(len(o) == 16 for o in out)
    assert out[0] == out[1] == out[4]
    assert out == je.generate_ids(prompts, gj)
    assert te.pool.free_pages == te.pool.usable_pages


def test_eos_stops_early(small):
    je, te = engines(small, max_batch=2, page_size=8, n_pages=32)
    first = te.generate_ids([[4, 8]], GenerationConfig(max_new_tokens=10))[0]
    eos = first[3]
    gj, gt = gens(max_new_tokens=10, eos_token=eos)
    out = te.generate_ids([[4, 8]], gt)[0]
    assert out == first[: first.index(eos)]
    assert out == je.generate_ids([[4, 8]], gj)[0]
    assert te.pool.free_pages == te.pool.usable_pages


def test_long_prompt_multiple_pages(small):
    je, te = engines(small, max_batch=2, page_size=8, n_pages=64)
    prompts = [np.random.default_rng(0).integers(1, 90, size=37).tolist()]
    gj, gt = gens(max_new_tokens=6)
    assert te.generate_ids(prompts, gt) == je.generate_ids(prompts, gj)


def test_pool_contents_match_below_each_length(small):
    """After prefill and two decode steps, every slot's KV pages hold the
    JAX engine's values at positions below the slot's length (prefill also
    writes pad positions, which are not compared)."""
    je, te = engines(small, max_batch=3, page_size=8, n_pages=24)
    gj, gt = gens(max_new_tokens=20)
    for p in PROMPTS[:3]:
        je.submit(p, gj)
        te.submit(p, gt)
    for _ in range(3):
        je.step()
        te.step()
    kj, vj = np.asarray(je.pool.k), np.asarray(je.pool.v)
    for sj, st in zip(je.slots, te.slots):
        assert st.active and sj.pages == st.pages and sj.pos == st.pos
        pos = np.arange(st.pos)
        pages = np.asarray(st.pages)[pos // 8]
        np.testing.assert_allclose(te.pool.k[:, :, pages, pos % 8].numpy(),
                                   kj[:, :, pages, pos % 8], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(te.pool.v[:, :, pages, pos % 8].numpy(),
                                   vj[:, :, pages, pos % 8], rtol=1e-5, atol=1e-5)


def test_stream_ids_and_cancel(small):
    _, te = engines(small, max_batch=2, page_size=8, n_pages=32)
    gen = GenerationConfig(max_new_tokens=9)
    want = te.generate_ids([PROMPTS[2]], gen)[0]
    assert list(te.stream_ids(PROMPTS[2], gen)) == want
    stream = te.stream_ids(PROMPTS[2], gen)
    assert next(stream) == want[0]
    stream.close()  # consumer walks away: pages come back
    assert te.pool.free_pages == te.pool.usable_pages
    assert te.pending() == 0


def test_generate_text_matches_jax():
    tok = ByteTokenizer()
    kw = dict(SMALL, vocab_size=tok.vocab_size)
    cj = J.ModelConfig(dtype=jnp.float32, **kw)
    ct = T.ModelConfig(dtype=torch.float32, **kw)
    pj = J.init_params(cj, jax.random.PRNGKey(1))
    pt = T.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    je = JEngine(cj, pj, max_batch=2, page_size=8, n_pages=32)
    te = ContinuousBatchingEngine(ct, pt, max_batch=2, page_size=8, n_pages=32, device="cpu")
    texts = ["hi", "paged"]
    assert te.generate(texts, GenerationConfig(max_new_tokens=6)) == je.generate(
        texts, JGen(max_new_tokens=6))


def test_submit_refusals(small):
    _, te = engines(small, max_batch=2, page_size=8, n_pages=8)
    with pytest.raises(NotImplementedError):
        te.submit([1, 2], GenerationConfig(top_k=5))
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        te.submit(list(range(1, 80)), GenerationConfig())


def test_pool_double_free_checks(small):
    pool = PagedKVPool(small[1], n_pages=6, page=8, device=torch.device("cpu"))
    pages = pool.alloc(3)
    with pytest.raises(ValueError, match="appears twice"):
        pool.free([pages[0], pages[0]])
    pool.free(pages)
    with pytest.raises(ValueError, match="already on the free-list"):
        pool.free(pages)
    with pytest.raises(ValueError, match="invalid page"):
        pool.free([0])
    assert pool.alloc(6) is None and pool.free_pages == pool.usable_pages == 5
