"""The port's admission control and shared prefix cache on the CPU, and the
continuous engine's prefix-hit path against the JAX package's.

Mirrors tests/test_serve_plane.py's admission units (token bucket, typed
shed at depth, WFQ order), prefix-cache units (a hit is a read-only arena
view, not a copy; object ids are deterministic, so the arena is the index)
and the engine case (a hit skips the full prefill and gives the same
stream). Streams are held token-exact against the JAX engine fed the same
weights (``params_from_jax``) and prompts (f32); the device-plane inserts
(tensor blocks sealed as device frames), ``retag`` after a weights swap,
``node_store`` and ``cache_from_cfg`` are the port's own cases."""
import os
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.continuous import ContinuousBatchingEngine as JEngine
from ray_tpu.llm.engine import GenerationConfig as JGen
from ray_tpu.models import transformer as J
from ray_tpu.serve import prefix_cache as jpc
from ray_tpu.serve.prefix_cache import SharedPrefixCache as JCache
from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine
from ray_tpu_torch.llm.engine import GenerationConfig
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.serve import prefix_cache as pc
from ray_tpu_torch.serve.admission import AdmissionController, Overloaded, TokenBucket
from ray_tpu_torch.serve.prefix_cache import SharedPrefixCache


# ---------------------------------------------------------------------------
# admission control (pure units)
# ---------------------------------------------------------------------------
def test_token_bucket_rate_and_burst():
    now = [0.0]
    b = TokenBucket(rate=10.0, burst=2.0, clock=lambda: now[0])
    assert b.try_take() and b.try_take()
    assert not b.try_take(), "burst exhausted"
    now[0] += 0.1
    assert b.try_take()
    assert not b.try_take()
    assert b.next_available_s() == pytest.approx(0.1, abs=0.02)


def test_admission_sheds_typed_overloaded_at_depth():
    ctl = AdmissionController(max_inflight=2, wait_cap=0)
    t1 = ctl.admit()
    t2 = ctl.admit()
    with pytest.raises(Overloaded) as ei:
        ctl.admit()
    assert ei.value.reason == "queue_full"
    assert ei.value.retry_after_s > 0
    t1.done()
    t3 = ctl.admit()
    t3.done()
    t2.done()
    stats = ctl.stats()
    assert stats["sheds"] == 1 and stats["admitted"] == 3
    assert stats["inflight"] == 0


def test_admission_wfq_weights_order_grants():
    ctl = AdmissionController(max_inflight=1, wait_cap=64, wait_timeout_s=30.0,
                              tenant_weights={"gold": 3.0, "bronze": 1.0})
    gate = ctl.admit()
    grants = []
    lock = threading.Lock()

    def one(tenant):
        t = ctl.admit(tenant)
        with lock:
            grants.append(tenant)
        t.done()

    threads = [threading.Thread(target=one, args=(t,)) for t in ["gold"] * 6 + ["bronze"] * 6]
    for t in threads:
        t.start()
    time.sleep(0.3)
    gate.done()
    for t in threads:
        t.join(timeout=30)
    assert len(grants) == 12
    assert grants[:8].count("gold") >= 5, f"WFQ order violated: {grants}"


# ---------------------------------------------------------------------------
# prefix cache (store level)
# ---------------------------------------------------------------------------
def _new_store(tag):
    from ray_tpu_torch.native import NativeObjectStore

    path = os.path.join(tempfile.gettempdir(),
                        f"t_tpfx_{tag}_{os.getpid()}_{time.time_ns()}.shm")
    return NativeObjectStore(path=path, capacity=32 << 20)


@pytest.fixture()
def shm_store():
    store = _new_store("a")
    yield store
    store.close(unlink=True)


def test_prefix_cache_hit_is_view_not_copy(shm_store):
    cache = SharedPrefixCache(shm_store, page_size=4, model_sig="sig")
    k = np.arange(2 * 2 * 2 * 4 * 128, dtype=np.float32).reshape(2, 2, 2, 4, 128)
    v = k + 1.0
    tokens = list(range(8))
    assert cache.insert(tokens, k, v)
    hit = cache.lookup(tokens + [99, 98])
    assert hit is not None and hit.tokens == 8 and not hit.on_device()
    assert not hit.k.flags["OWNDATA"] and not hit.k.flags["WRITEABLE"]
    assert not hit.v.flags["OWNDATA"] and not hit.v.flags["WRITEABLE"]
    with pytest.raises((ValueError, RuntimeError)):
        hit.k[0, 0, 0, 0, 0] = 5.0
    np.testing.assert_array_equal(np.asarray(hit.k), k)
    # delete-under-pin defers the free: the pinned view stays byte-correct
    shm_store.delete(next(iter(cache._mine)))
    np.testing.assert_array_equal(np.asarray(hit.v), v)
    hk, hv = hit.to_device("cpu")
    assert isinstance(hk, torch.Tensor) and torch.equal(hk, torch.from_numpy(k))
    hit.release()
    assert cache.lookup([0, 1, 2]) is None


def test_prefix_cache_deterministic_ids_no_side_index(shm_store):
    a = SharedPrefixCache(shm_store, page_size=4, model_sig="m1")
    b = SharedPrefixCache(shm_store, page_size=4, model_sig="m1")
    other = SharedPrefixCache(shm_store, page_size=4, model_sig="m2")
    k = np.ones((1, 1, 1, 4, 2), dtype=np.float32)
    assert a.insert([5, 6, 7, 8], k, k)
    hit = b.lookup([5, 6, 7, 8, 9])
    assert hit is not None and hit.tokens == 4
    hit.release()
    assert not b.insert([5, 6, 7, 8], k, k)
    assert other.lookup([5, 6, 7, 8, 9]) is None


def test_object_ids_match_the_reference(shm_store):
    """The same chain hashes and object ids as the JAX package's cache, so
    either package's replicas would find the other's entries."""
    assert pc._chain_hashes(list(range(20)), 8) == jpc._chain_hashes(list(range(20)), 8)
    a = SharedPrefixCache(shm_store, page_size=8, model_sig="eng")
    b = JCache(shm_store, page_size=8, model_sig="eng")
    h = pc._chain_hashes(list(range(16)), 8)[-1]
    assert a._oid(h) == b._oid(h)
    a.retag("v2")
    b.retag("v2")
    assert a._oid(h) == b._oid(h)


def test_tensor_blocks_seal_as_device_frames(shm_store, monkeypatch):
    """With the device plane on, tensor blocks (bfloat16 too) go in as
    device frames and a hit lands them as tensors; ``as_tensor`` moves a
    host view (bfloat16 included) with one copy."""
    monkeypatch.setenv("RAY_TPU_DEVICE_PLANE", "1")
    from ray_tpu_torch.cluster import device_plane as dp

    cache = SharedPrefixCache(shm_store, page_size=4, model_sig="dev")
    k = torch.arange(2 * 2 * 2 * 4 * 64, dtype=torch.float32).reshape(2, 2, 2, 4, 64)
    kb = k.to(torch.bfloat16)
    seals = dp.device_stats()["device_frame_seals_total"]
    assert cache.insert(list(range(8)), kb, kb + 1)
    assert dp.device_stats()["device_frame_seals_total"] == seals + 2
    hit = cache.lookup(list(range(10)))
    assert isinstance(hit.k, torch.Tensor) and hit.k.dtype == torch.bfloat16
    assert torch.equal(hit.k, kb) and torch.equal(hit.v, kb + 1)
    assert not hit.on_device()  # a CPU tensor's frame lands on the CPU
    hit.release()
    with dp.landing("host"):
        host = cache.lookup(list(range(10)))
    assert pc.as_tensor(host.k, "cpu").dtype == torch.bfloat16
    assert torch.equal(pc.as_tensor(host.k, "cpu"), kb)
    host.release()


def test_retag_makes_stale_prefix_miss(shm_store):
    cache = SharedPrefixCache(shm_store, page_size=4, model_sig="base")
    k = np.ones((1, 1, 1, 4, 2), dtype=np.float32)
    assert cache.insert([1, 2, 3, 4], k, k)
    cache.retag("epoch-1")
    assert cache.lookup([1, 2, 3, 4, 5]) is None
    assert cache.insert([1, 2, 3, 4], k, k)  # the new namespace takes it
    hit = cache.lookup([1, 2, 3, 4, 5])
    assert hit is not None
    hit.release()
    assert cache.stats()["inserts"] == 2 and cache.stats()["misses"] == 1


def test_node_store_and_cache_from_cfg(monkeypatch):
    monkeypatch.setattr(pc, "_local_store", None)
    store = pc.node_store()
    try:
        assert store is not None and pc.node_store() is store
        assert os.path.basename(store.path).startswith("ray_tpu_torch_prefix_")
        cache = pc.cache_from_cfg(page_size=8, model_sig="m")
        assert isinstance(cache, SharedPrefixCache) and cache.store is store
        monkeypatch.setenv("RAY_TPU_SERVE_PREFIX_CACHE", "0")
        assert pc.cache_from_cfg(page_size=8, model_sig="m") is None
    finally:
        store.close(unlink=True)
        pc._local_store = None


# ---------------------------------------------------------------------------
# the engine's hit path against the JAX engine's
# ---------------------------------------------------------------------------
SMALL = dict(vocab_size=64, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96,
             max_seq_len=96)
PROMPT = [3, 5, 7, 9, 11, 2, 4, 6, 8, 1, 3, 5, 7, 2, 9, 4, 6, 1]


@pytest.fixture(scope="module")
def model():
    cj = J.ModelConfig(dtype=jnp.float32, **SMALL)
    ct = T.ModelConfig(dtype=torch.float32, **SMALL)
    pj = J.init_params(cj, jax.random.PRNGKey(2))
    pt = T.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


def _engine(ct, pt, **kw):
    return ContinuousBatchingEngine(ct, pt, max_batch=2, page_size=8, n_pages=32,
                                    device="cpu", **kw)


@pytest.mark.parametrize("plane", ["0", "1"], ids=["host", "device"])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_engine_prefix_cache_skips_prefill_and_matches(model, monkeypatch, plane,
                                                       temperature):
    monkeypatch.setenv("RAY_TPU_DEVICE_PLANE", plane)
    cj, ct, pj, pt = model
    kw = dict(max_new_tokens=10, temperature=temperature, seed=4)
    want = JEngine(cj, pj, max_batch=2, page_size=8, n_pages=32).generate_ids(
        [list(PROMPT)], JGen(**kw))[0]
    gen = GenerationConfig(**kw)
    store = _new_store("eng")
    try:
        cache = SharedPrefixCache(store, page_size=8, model_sig="eng")
        a = _engine(ct, pt, prefix_cache=cache)
        assert a.generate_ids([list(PROMPT)], gen)[0] == want
        assert cache.inserts == 1
        b = _engine(ct, pt, prefix_cache=cache)
        assert b.generate_ids([list(PROMPT)], gen)[0] == want
        assert b.stats()["full_prefill_count"] == 0, "a cache hit must skip full prefill"
        assert cache.hits >= 1 and b.stats()["prefix_cache"]["hits"] >= 1
        assert b.pool.free_pages == b.pool.usable_pages

        # the JAX engine's hit path on its own cache gives the same stream
        jcache = JCache(store, page_size=8, model_sig="jax-eng")
        JEngine(cj, pj, max_batch=2, page_size=8, n_pages=32,
                prefix_cache=jcache).generate_ids([list(PROMPT)], JGen(**kw))
        jb = JEngine(cj, pj, max_batch=2, page_size=8, n_pages=32, prefix_cache=jcache)
        assert jb.generate_ids([list(PROMPT)], JGen(**kw))[0] == want
        assert jb.full_prefill_count == 0
    finally:
        store.close(unlink=True)


def test_longer_prompt_hits_shared_prefix_and_matches_jax(model):
    """A hit on the first two pages of a longer prompt: the suffix program
    runs over history + suffix, token-exact with the JAX engine's run
    without a cache; two requests batched together share the entry."""
    cj, ct, pj, pt = model
    longer = PROMPT + [12, 13, 14, 15, 16, 17, 18, 19, 20, 21]
    other = PROMPT[:16] + [30, 31]
    kw = dict(max_new_tokens=8)
    want = JEngine(cj, pj, max_batch=2, page_size=8, n_pages=32).generate_ids(
        [longer, other], JGen(**kw))
    store = _new_store("long")
    try:
        cache = SharedPrefixCache(store, page_size=8, model_sig="eng")
        _engine(ct, pt, prefix_cache=cache).generate_ids([list(PROMPT)],
                                                         GenerationConfig(**kw))
        b = _engine(ct, pt, prefix_cache=cache)
        assert b.generate_ids([longer, other], GenerationConfig(**kw)) == want
        assert b.stats()["full_prefill_count"] == 0 and cache.hits >= 2
    finally:
        store.close(unlink=True)


def test_swap_retags_the_cache(model):
    """After ``swap_params`` a prefix cached under the old weights misses,
    so the new weights prefill in full and give the new stream."""
    cj, ct, pj, pt = model
    alt_j = J.init_params(cj, jax.random.PRNGKey(5))
    alt_t = T.params_from_jax(jax.tree.map(np.asarray, alt_j), device="cpu")
    kw = dict(max_new_tokens=8)
    want_new = JEngine(cj, alt_j, max_batch=2, page_size=8, n_pages=32).generate_ids(
        [list(PROMPT)], JGen(**kw))[0]
    store = _new_store("swap")
    try:
        cache = SharedPrefixCache(store, page_size=8, model_sig="eng")
        eng = _engine(ct, pt, prefix_cache=cache)
        eng.generate_ids([list(PROMPT)], GenerationConfig(**kw))
        assert eng.swap_params(alt_t, model_id="alt") == 1
        assert cache.model_sig == "eng|alt"
        before = eng.full_prefill_count
        assert eng.generate_ids([list(PROMPT)], GenerationConfig(**kw))[0] == want_new
        assert eng.full_prefill_count == before + 1  # the stale prefix missed
    finally:
        store.close(unlink=True)
