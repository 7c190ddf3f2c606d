"""ray_tpu_torch paged-attention decode against the JAX package's Pallas
kernel (interpret mode on the CPU, as tests/test_paged_attention.py runs
it). On the CPU the port's wrapper runs the gather formulation; the CUDA
kernel is held against it on the card by tests/test_torch_cuda_kernels.py
and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as J
from ray_tpu_torch.ops import paged_attention as T


def _setup(b=4, kh=2, g=2, d=32, n_pages=16, page=8, p_max=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh, g, d), dtype=np.float32)
    k_pages = rng.standard_normal((kh, n_pages, page, d), dtype=np.float32)
    v_pages = rng.standard_normal((kh, n_pages, page, d), dtype=np.float32)
    tables = rng.integers(0, n_pages, size=(b, p_max)).astype(np.int32)
    return q, k_pages, v_pages, tables, page


def both(q, kp, vp, tables, lengths, page):
    args = (q, kp, vp, tables, np.asarray(lengths, np.int32))
    want = J.paged_attention_decode(*map(jnp.asarray, args), page_size=page, interpret=True)
    got = T.paged_attention_decode(*map(torch.from_numpy, args), page_size=page)
    return np.asarray(want), got.numpy()


def test_matches_jax_ragged_lengths():
    q, kp, vp, tables, page = _setup()
    want, got = both(q, kp, vp, tables, [5, 17, 32, 1], page)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_single_position_and_full_pages():
    q, kp, vp, tables, page = _setup(seed=3)
    want, got = both(q, kp, vp, tables, [1, 8, 16, 32], page)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_page_sharing_between_slots():
    """Two slots on the SAME physical pages with the same query read
    identical data, and both agree with the JAX kernel."""
    q, kp, vp, tables, page = _setup(seed=7)
    tables[1] = tables[0]
    q[1] = q[0]
    want, got = both(q, kp, vp, tables, [24, 24, 9, 3], page)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("page,d,g", [(16, 64, 2), (4, 32, 4)])
def test_engine_geometries(page, d, g):
    # the flagship's decode geometry (page 16, hd 64, 2 query heads per KV
    # head) and a small-page one
    q, kp, vp, tables, _ = _setup(b=3, kh=2, g=g, d=d, n_pages=24, page=page, p_max=6,
                                  seed=11)
    want, got = both(q, kp, vp, tables, [page * 6, 1, page * 3 + 1], page)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_bf16_matches_jax_gather():
    # the plain version computes in f32 from bf16 inputs and rounds once
    q, kp, vp, tables, page = _setup(seed=9)
    lengths = np.asarray([5, 17, 32, 1], np.int32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv))
    want = np.asarray(J.paged_attention_reference(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths), page_size=page
    ).astype(jnp.float32))
    got = T.paged_attention_decode(tq, tk, tv, torch.from_numpy(tables),
                                   torch.from_numpy(lengths), page_size=page)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-2)


@pytest.mark.parametrize("bad", ["tables_int64", "pool_page", "head_dim", "dtype"])
def test_kernel_input_checks(bad):
    q = torch.zeros(2, 2, 2, 64)
    pool = torch.zeros(2, 8, 16, 64)
    tables = torch.zeros(2, 4, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    page = 16
    if bad == "tables_int64":
        tables = tables.long()
    elif bad == "pool_page":
        page = 8
    elif bad == "head_dim":
        q, pool = torch.zeros(2, 2, 2, 16), torch.zeros(2, 8, 16, 16)
    else:
        q, pool = q.half(), pool.half()
    with pytest.raises((ValueError, TypeError)):
        T._check_inputs(q, pool, pool, tables, lengths, page)

