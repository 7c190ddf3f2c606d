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


@pytest.mark.parametrize("page,d,g", [(16, 64, 2), (4, 32, 4), (16, 80, 2), (8, 128, 16)])
def test_engine_geometries(page, d, g):
    # the flagship's decode geometry (page 16, hd 64, 2 query heads per KV
    # head), a small-page one, head_dim 80 and G * D = 16 * 128 (which the
    # kernel splits over two blocks of 8 query rows)
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
    elif bad == "head_dim":  # wider than the kernel's 256
        q, pool = torch.zeros(2, 2, 2, 272), torch.zeros(2, 8, 16, 272)
    else:
        q, pool = q.half(), pool.half()
    with pytest.raises((ValueError, TypeError)):
        T._check_inputs(q, pool, pool, tables, lengths, page)



@pytest.mark.parametrize("g,d", [(2, 16), (2, 80), (4, 112), (16, 128), (64, 16), (1, 1),
                                 (4, 12), (8, 255), (2, 256)])
def test_kernel_takes_head_widths(g, d):
    """Every head_dim from 1 to 256, at any G (the kernel chunks a head's
    query rows over blocks)."""
    q = torch.zeros(2, 2, g, d)
    pool = torch.zeros(2, 8, 16, d)
    T._check_inputs(q, pool, pool, torch.zeros(2, 4, dtype=torch.int32),
                    torch.ones(2, dtype=torch.int32), 16)


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("d", [8, 12, 20, 72, 160, 256])
def test_head_dims_match_jax(g, d):
    """head_dims the kernel's instances cover (8 and 12 are the JAX
    package's small serving configurations) against the Pallas kernel."""
    q, kp, vp, tables, page = _setup(b=3, kh=2, g=g, d=d, n_pages=12, page=4, p_max=4,
                                     seed=d + g)
    want, got = both(q, kp, vp, tables, [16, 1, 7], page)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _split_case(lengths, d=16, g=2, page=4, p_max=6, seed=5):
    q, kp, vp, tables, _ = _setup(b=len(lengths), kh=2, g=g, d=d, n_pages=20, page=page,
                                  p_max=p_max, seed=seed)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables)]
    return args + [torch.tensor(lengths, dtype=torch.int32)], page


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 24])
def test_split_reference_matches_gather(n_split):
    """The kernel's split-and-combine algebra against the gather reference:
    ragged lengths, a single position, a full table (24 positions), and
    splits past the last 16-token share, which fall empty."""
    args, page = _split_case([1, 5, 17, 24, 2])
    want = T.paged_attention_reference(*args, page_size=page)
    got = T.paged_attention_split_reference(*args, page_size=page, n_split=n_split)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_split", [1, 4])
def test_split_reference_empty_slot_matches_jax(n_split):
    """Length 0 gives zeros, as the Pallas kernel's o / max(l, 1e-30) does
    (the gather reference's softmax over no valid position would average
    V instead); the other slots still match the kernel."""
    args, page = _split_case([0, 1, 23])
    want = J.paged_attention_decode(*(jnp.asarray(a.numpy()) for a in args), page_size=page,
                                    interpret=True)
    got = T.paged_attention_split_reference(*args, page_size=page, n_split=n_split)
    assert not got[0].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_split_shares_and_plan():
    """Shares are ceil(len / n_split) rounded up to 16 tokens, and the plan
    picks splits from the shapes alone: more for a small batch, enough
    that no split of the longest possible sequence passes 2048 positions
    when B * KH already fills the card, and enough that one split's table
    window fits."""
    assert T.split_share(130, 9) == 16 and T.split_share(0, 4) == 0
    assert T.split_share(8192, 1) == 8192 and T.split_share(17, 2) == 16
    assert [T.split_share(n, 3) for n in (1, 48, 49)] == [16, 16, 32]
    assert T.table_window(2048, 16, 9) == 16 and T.table_window(2048, 16, 5) == 27
    rows = {(64, 1): 4}

    class Lib:
        @staticmethod
        def ray_paged_attention_rows(d, code):
            return rows[(d, code)]

    saved = T._lib
    T._lib = lambda: Lib
    try:
        T.plan.cache_clear()
        assert T.plan(8, 4, 2, 64, 128, 16, 1, 132) == (5, 27)  # 32 blocks, 132 SMs
        assert T.plan(256, 4, 2, 64, 512, 16, 1, 132) == (4, 129)  # 8192 positions
        n_split, window = T.plan(1, 1, 2, 64, 8192, 1, 1, 132)
        assert window <= T.MAX_TABLE_WINDOW and n_split >= 2
    finally:
        T._lib = saved
        T.plan.cache_clear()
