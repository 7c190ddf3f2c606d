"""The port's disaggregated prefill/decode hand-off and weights hot-swap
against the JAX package's engines on the CPU.

Mirrors the engine cases of tests/test_disagg.py (the page pool's
double-free guard, the hand-off stream with the device plane on and off,
interleaving with local requests, adopt refusals, a sealed hand-off over
the striped peer plane with its sockets severed mid-transfer, the swap
drain and the parked queue) and tests/test_rl_loop.py's two swap cases
(mid-stream drain, the drain deadline's force-eviction and typed shed).
Every stream is held token-exact against the JAX engine fed the same
weights (``params_from_jax``), prompts and seeds (f32). The routing and
fleet cases after them are in ``tests/test_torch_serve_disagg.py``."""
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
from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine, PagedKVPool
from ray_tpu_torch.llm.engine import GenerationConfig
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.serve.admission import Overloaded

SMALL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)


def _params(seed):
    cj = J.ModelConfig(dtype=jnp.float32, **SMALL)
    pj = J.init_params(cj, jax.random.PRNGKey(seed))
    return pj, T.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module")
def small():
    cj = J.ModelConfig(dtype=jnp.float32, **SMALL)
    ct = T.ModelConfig(dtype=torch.float32, **SMALL)
    pj, pt = _params(7)
    return cj, ct, pj, pt


def _kw(kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("page_size", 8)
    kw.setdefault("n_pages", 32)
    return kw


def _engine(ct, pt, **kw):
    return ContinuousBatchingEngine(ct, pt, device="cpu", **_kw(kw))


def _jengine(cj, pj, **kw):
    return JEngine(cj, pj, **_kw(kw))


def _gens(**kw):
    return JGen(**kw), GenerationConfig(**kw)


# ---------------------------------------------------------------------------
# page-pool double-free guard
# ---------------------------------------------------------------------------
def test_pool_double_free_raises(small):
    _, ct, _, _ = small
    pool = PagedKVPool(ct, n_pages=8, page=8, device=torch.device("cpu"))
    pages = pool.alloc(3)
    pool.free(pages)
    with pytest.raises(ValueError):
        pool.free(pages)
    fresh = pool.alloc(2)
    with pytest.raises(ValueError):
        pool.free([fresh[0], fresh[0]])
    with pytest.raises(ValueError):
        pool.free([0])
    with pytest.raises(ValueError):
        pool.free([99])
    pool.free([fresh[1]])
    assert pool.alloc(pool.free_pages) is not None


def test_pool_free_set_tracks_alloc(small):
    _, ct, _, _ = small
    pool = PagedKVPool(ct, n_pages=8, page=8, device=torch.device("cpu"))
    a = pool.alloc(4)
    b = pool.alloc(3)
    assert not set(a) & set(b)
    assert pool.free_pages == 0
    pool.free(a)
    pool.free(b)
    assert pool.free_pages == 7


# ---------------------------------------------------------------------------
# KV hand-off: token-exact with a monolithic run and with JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plane", ["0", "1"], ids=["host", "device"])
def test_handoff_stream_bit_identical(small, monkeypatch, plane):
    monkeypatch.setenv("RAY_TPU_DEVICE_PLANE", plane)
    cj, ct, pj, pt = small
    prompt = [1, 5, 9, 2, 17, 23, 4, 31, 8]
    gj, gt = _gens(max_new_tokens=12, temperature=0.8, seed=9)
    want = list(_jengine(cj, pj).stream_ids(list(prompt), gj))
    assert list(_engine(ct, pt).stream_ids(list(prompt), gt)) == want

    # the JAX engine's own hand-off gives the same stream
    jpre, jdec = _jengine(cj, pj), _jengine(cj, pj)
    jm, jk, jv = jpre.prefill_extract(list(prompt), gj)
    assert list(jdec.stream_rid(jdec.adopt_pages(jm, jk, jv))) == want

    pre, dec = _engine(ct, pt), _engine(ct, pt)
    manifest, k, v = pre.prefill_extract(list(prompt), gt)
    assert manifest == jm
    if plane == "1":
        assert isinstance(k, torch.Tensor) and isinstance(v, torch.Tensor)
    else:
        assert isinstance(k, np.ndarray) and isinstance(v, np.ndarray)
    np.testing.assert_allclose(np.asarray(k), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v), np.asarray(jv), rtol=0, atol=1e-5)
    # the prefill worker reclaims its pages after the gather
    assert pre.pool.free_pages == pre.pool.usable_pages
    free_before = dec.pool.free_pages
    rid = dec.adopt_pages(manifest, k, v)
    assert rid is not None
    assert list(dec.stream_rid(rid)) == want
    assert dec.stats()["full_prefill_count"] == 0
    assert dec.stats()["adopted_count"] == 1
    assert dec.pool.free_pages == free_before


def test_extracted_block_is_a_copy(small, monkeypatch):
    """The pool is written in place: the handed block must not change when
    the freed pages are reused by the next request."""
    monkeypatch.setenv("RAY_TPU_DEVICE_PLANE", "1")
    _, ct, _, pt = small
    pre = _engine(ct, pt)
    _, k, v = pre.prefill_extract([1, 2, 3, 4, 5, 6, 7, 8, 9], GenerationConfig())
    k0, v0 = k.clone(), v.clone()
    pre.generate_ids([[9, 8, 7, 6, 5, 4, 3, 2, 1, 9, 8]], GenerationConfig(max_new_tokens=6))
    assert torch.equal(k, k0) and torch.equal(v, v0)


def test_handoff_interleaves_with_local_requests(small):
    cj, ct, pj, pt = small
    gj, gt = _gens(max_new_tokens=10, temperature=0.0)
    pa, pb = [3, 3, 7, 12], [11, 12, 13, 14, 15, 16, 17]
    want_a, want_b = _jengine(cj, pj).generate_ids([pa, pb], gj)

    pre, dec = _engine(ct, pt), _engine(ct, pt)
    manifest, k, v = pre.prefill_extract(list(pa), gt)
    rid_a = dec.adopt_pages(manifest, k, v)
    assert rid_a is not None
    rid_b = dec.submit(list(pb), gt)
    while rid_a not in dec.results or rid_b not in dec.results:
        dec.step()
    assert dec.results.pop(rid_a) == want_a
    assert dec.results.pop(rid_b) == want_b


def test_adopt_refuses_mismatches(small):
    _, ct, _, pt = small
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    prompt = [1, 2, 3, 4, 5]
    pre = _engine(ct, pt)
    manifest, k, v = pre.prefill_extract(list(prompt), gen)
    dec = _engine(ct, pt)
    assert dec.adopt_pages(dict(manifest, page=manifest["page"] * 2), k, v) is None
    manifest2, k2, v2 = pre.prefill_extract(list(prompt), gen)
    assert dec.adopt_pages(dict(manifest2, model="some-other-weights"), k2, v2) is None
    assert dec.pool.free_pages == dec.pool.usable_pages  # refusals leak no page
    manifest3, k3, v3 = pre.prefill_extract(list(range(1, 21)), gen)
    tiny = _engine(ct, pt, n_pages=2)  # 1 usable page, the prompt needs 3
    assert tiny.adopt_pages(manifest3, k3, v3) is None


# ---------------------------------------------------------------------------
# mid-hand-off connection drop: the striped fetch resumes, stream exact
# ---------------------------------------------------------------------------
def test_mid_handoff_conn_drop_stream_exact(small, monkeypatch):
    from ray_tpu_torch.cluster import device_plane as dp
    from ray_tpu_torch.cluster import serialization as wire
    from ray_tpu_torch.cluster import transport as tp
    from ray_tpu_torch.native.shm_store import NativeObjectStore

    monkeypatch.setenv("RAY_TPU_DEVICE_PLANE", "1")
    monkeypatch.setenv("RAY_TPU_NET_STRIPE_BYTES", str(1 << 12))
    monkeypatch.setenv("RAY_TPU_NET_STRIPE_CONNS", "2")
    cj, ct, pj, pt = small
    prompt = list(range(1, 25))  # 24 tokens: 3 pages of KV to ship
    gj, gt = _gens(max_new_tokens=10, temperature=0.7, seed=3)
    want = list(_jengine(cj, pj, n_pages=64).stream_ids(list(prompt), gj))

    pre = _engine(ct, pt, n_pages=64)
    manifest, k, v = pre.prefill_extract(list(prompt), gt)
    store = NativeObjectStore(
        path=os.path.join(tempfile.gettempdir(),
                          f"t_tdisagg_{os.getpid()}_{time.time_ns()}.shm"),
        capacity=1 << 26,
    )
    srv = tp.DataPlaneServer(store, "nodesrv", "tok-secret", lambda: 100)
    link = tp.PeerLink("lk0", "nodesrv", srv.endpoint, "tok-secret", 100, "nodecli")
    oid = "h" * 28
    try:
        seals = dp.device_stats()["device_frame_seals_total"]
        parts, total = wire.dumps_parts((manifest, k, v))
        assert dp.device_stats()["device_frame_seals_total"] == seals + 2
        store.put_frames(oid, parts)
        got: dict = {}

        def pull():
            got["data"] = tp.fetch_bytes(link, oid, land="device")

        t = threading.Thread(target=pull)
        t.start()
        for _ in range(3):
            time.sleep(0.02)
            srv.chaos_drop()
        t.join(timeout=60)
        assert not t.is_alive()
        assert srv.stats["chaos_drops"] >= 1
        assert len(got["data"]) == total
        with dp.landing("device"):
            m2, k2, v2 = wire.loads(memoryview(got["data"]))
        assert isinstance(k2, torch.Tensor) and torch.equal(k2, k)
        dec = _engine(ct, pt, n_pages=64)
        rid = dec.adopt_pages(m2, k2, v2)
        assert rid is not None
        assert list(dec.stream_rid(rid)) == want
        assert dec.stats()["full_prefill_count"] == 0
    finally:
        link.close()
        srv.close()
        store.close(unlink=True)


# ---------------------------------------------------------------------------
# weights hot-swap: drain + epoch fence
# ---------------------------------------------------------------------------
def test_swap_params_drains_then_bumps_epoch(small):
    cj, ct, pj, pt = small
    alt_j, alt_t = _params(41)
    prompt = [2, 4, 6, 8]
    gj, gt = _gens(max_new_tokens=8, temperature=0.0)
    want_old = _jengine(cj, pj).generate_ids([prompt], gj)[0]
    want_new = _jengine(cj, alt_j).generate_ids([prompt], gj)[0]
    assert want_old != want_new

    eng = _engine(ct, pt)
    rid = eng.submit(list(prompt), gt)
    eng.step()  # mid-generation when the swap arrives
    assert eng.weights_epoch == 0
    assert eng.swap_params(alt_t, model_id="alt") == 1 and eng.model_id == "alt"
    assert eng.results.pop(rid) == want_old
    assert eng.generate_ids([prompt], gt)[0] == want_new
    assert eng.stats()["weights_epoch"] == 1 and eng.stats()["model_id"] == "alt"


def test_swap_blocks_admission_until_done(small):
    cj, ct, _, pt = small
    alt_j, alt_t = _params(41)
    gj, gt = _gens(max_new_tokens=6, temperature=0.0)
    prompt = [9, 9, 1]
    want_new = _jengine(cj, alt_j).generate_ids([prompt], gj)[0]
    eng = _engine(ct, pt)
    eng._swapping = True
    rid = eng.submit(list(prompt), gt)
    eng.step()
    assert all(not s.active for s in eng.slots)  # parked, not admitted
    eng._swapping = False
    eng.swap_params(alt_t, model_id="alt")
    while rid not in eng.results:
        eng.step()
    assert eng.results.pop(rid) == want_new


def test_swap_params_mid_stream_drains_token_exact(small):
    """In flight at the swap: the whole generation on the OLD weights; after
    it, the NEW weights' stream (each equal to the JAX engine's)."""
    cj, ct, pj, pt = small
    new_j, new_t = _params(8)
    gj, gt = _gens(max_new_tokens=8, temperature=0.6, seed=5)
    prompt = [1, 2, 3, 4]
    ref_old = _jengine(cj, pj).generate_ids([prompt], gj)[0]
    ref_new = _jengine(cj, new_j).generate_ids([prompt], gj)[0]
    eng = _engine(ct, pt, model_id="epoch-0")
    rid = eng.submit(list(prompt), gt)
    for _ in range(3):
        eng.step()
    assert rid not in eng.results
    assert eng.swap_params(new_t, model_id="epoch-1") == 1
    assert eng.results.pop(rid) == ref_old
    assert eng.generate_ids([prompt], gt)[0] == ref_new


def test_swap_drain_deadline_force_evicts_and_sheds(small, monkeypatch):
    monkeypatch.setenv("RAY_TPU_SERVE_SWAP_DRAIN_DEADLINE_S", "0.0001")
    _, ct, _, pt = small
    _, new_t = _params(8)
    eng = _engine(ct, pt)
    free_before = eng.pool.free_pages
    rid = eng.submit([1, 2, 3, 4], GenerationConfig(max_new_tokens=64))
    eng.step()
    eng.step()  # a couple of tokens in flight before the swap begins
    assert eng.swap_params(new_t, model_id="epoch-1") >= 1
    assert eng.swap_force_evicted == 1
    out = eng.results.pop(rid)
    assert 0 < len(out) < 64
    assert not any(s.active for s in eng.slots)
    assert eng.pool.free_pages == free_before
    assert eng.stats()["swap_force_evicted"] == 1
    eng._swapping = True
    eng._swap_started = time.monotonic() - 10.0
    try:
        with pytest.raises(Overloaded) as ei:
            eng.submit([1, 2, 3], GenerationConfig(max_new_tokens=4))
        assert ei.value.reason == "weights_swap" and ei.value.retry_after_s > 0
    finally:
        eng._swapping = False
        eng._swap_started = None


def test_moe_config_is_sent_to_llm_engine(small):
    ct = T.ModelConfig(dtype=torch.float32, **dict(SMALL, n_experts=4))
    with pytest.raises(NotImplementedError, match="LLMEngine"):
        ContinuousBatchingEngine(ct, device="cpu")
