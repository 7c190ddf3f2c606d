"""The port's CUDA kernels (paged decode, flash forward and backward)
against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor ray_tpu, so it runs where only the port's dependencies
are installed; there, skip the jax-importing tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as F
from ray_tpu_torch.ops import paged_attention as P

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("t,s", [(256, 256), (192, 192), (128, 320)])
def test_flash_kernel_matches_plain_version(cuda, dtype, atol, causal, d, t, s):
    """O and lse against the plain version. The bf16 kernel's key tile is
    128 rows at head_dim 32/64: T = 192 and S = 320 end inside a tile,
    whose zero-filled keys must be masked. head_dim 256 runs the FMA
    kernel in both dtypes."""
    g = torch.Generator(device=cuda).manual_seed(d + t + s)
    qg = torch.randn(8, t, d, generator=g, device=cuda).to(dtype)
    kg, vg = (torch.randn(8, s, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    before = F.flash_attention_forward.launches
    out, lse = F.flash_attention_forward(qg, kg, vg, causal)
    ref_out, ref_lse = F.flash_attention_reference(qg, kg, vg, causal)
    torch.cuda.synchronize()
    assert F.flash_attention_forward.launches == before + 1
    assert _max_err(out, ref_out) <= atol
    assert _max_err(lse, ref_lse) <= 1e-3


def test_flash_wrapper_branches(cuda):
    """GQA fold and ragged-causal padding launch the kernel; ragged
    non-causal input takes attention_reference and launches nothing."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(1, 100, 8, 64, generator=g, device=cuda)
    k = torch.randn(1, 100, 2, 64, generator=g, device=cuda)
    v = torch.randn(1, 100, 2, 64, generator=g, device=cuda)
    from ray_tpu_torch.ops.layers import attention_reference

    for causal, launches in ((True, 1), (False, 0)):
        before = F.flash_attention_forward.launches
        out = F.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert F.flash_attention_forward.launches == before + launches
        assert _max_err(out, attention_reference(q, k, v, causal=causal)) <= 1e-4


def _bwd_inputs(cuda, dtype, bh, t, d, causal, seed, s=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qg, do = (torch.randn(bh, t, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    kg, vg = (torch.randn(bh, s or t, d, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    out, lse = F.flash_attention_forward(qg, kg, vg, causal)
    delta = (do.float() * out.float()).sum(-1)[:, None, :]
    return qg, kg, vg, do, lse, delta


def _rel_err(a, b):
    return _max_err(a, b) / max(1.0, b.float().abs().max().item())


# f32: sums in another order; bf16: the kernels round dS and the outputs to
# bf16 as the plain version does, so a last-bit f32 difference can flip a
# rounding: a few bf16 ulps of the largest entry
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,t,s,bh", [(32, 256, 256, 8), (64, 256, 256, 8), (128, 256, 256, 8),
                                      (64, 128, 320, 8), (128, 320, 128, 8),
                                      (32, 128, 320, 8), (128, 128, 320, 8),
                                      (64, 64, 64, 8), (128, 64, 192, 8),
                                      (128, 1024, 1024, 4), (256, 256, 256, 4),
                                      (256, 128, 320, 4), (256, 320, 128, 4)])
def test_flash_backward_kernels_match_plain_version(cuda, dtype, causal, d, t, s, bh):
    """Both kernels against their plain versions; T != S covers keys that
    no query sees (S > T: causal, the key tiles from T on walk no Q tile)
    and queries past the last key (T > S); T = 64 is a single Q tile, and
    T = 1024 at head_dim 128 the train shape's walk; head_dim 256 runs the
    FMA kernels (32-row walked tiles) in both dtypes."""
    args = _bwd_inputs(cuda, dtype, bh, t, d, causal, d + 1, s)
    before = (F.flash_attention_bwd_dq.launches, F.flash_attention_bwd_dkv.launches)
    got = F.flash_attention_backward(*args, causal)
    want = F.flash_attention_backward_reference(*args, causal)
    torch.cuda.synchronize()
    assert (F.flash_attention_bwd_dq.launches, F.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel_err(g, w) <= BWD_TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_without_queries(cuda, dtype):
    """T = 0 against S = 64 keys: dK and dV are zeros, as on the CPU (bf16
    writes them without a tensor map over the empty T)."""
    q = torch.zeros(1, 0, 2, 64, device=cuda, dtype=dtype, requires_grad=True)
    k, v = (torch.randn(1, 64, 2, 64, device=cuda).to(dtype).requires_grad_()
            for _ in range(2))
    F.flash_attention(q, k, v, causal=False).sum().backward()
    torch.cuda.synchronize()
    assert q.grad.shape == q.shape
    assert torch.count_nonzero(k.grad) == 0 and torch.count_nonzero(v.grad) == 0


@pytest.mark.parametrize("d,dtype", [(64, torch.float32), (80, torch.float32),
                                     (96, torch.float32), (80, torch.bfloat16),
                                     (96, torch.bfloat16), (160, torch.float32),
                                     (160, torch.bfloat16), (256, torch.float32),
                                     (256, torch.bfloat16)])
def test_flash_backward_through_the_wrapper(cuda, d, dtype):
    """GQA and ragged causal T=100 through flash_attention's autograd on the
    card (kernels) against the same wrapper on the CPU (plain versions);
    head_dim 80 and 96 are padded to the kernels' 128, 160 to 256, and
    sliced back."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(1, 100, 8, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(1, 100, 2, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(1, 100, 2, d, generator=g, device=cuda).to(dtype)
    do = torch.randn(1, 100, 8, d, generator=g, device=cuda).to(dtype)
    grads, outs = [], []
    before = (F.flash_attention_forward.launches, F.flash_attention_bwd_dq.launches,
              F.flash_attention_bwd_dkv.launches)
    for dev in (cuda, "cpu"):
        xs = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        out = F.flash_attention(*xs, causal=True)
        out.backward(do.to(dev))
        outs.append(out.detach().cpu())
        grads.append([x.grad.cpu() for x in xs])
    assert (F.flash_attention_forward.launches, F.flash_attention_bwd_dq.launches,
            F.flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    assert outs[0].shape == q.shape
    assert _max_err(outs[0], outs[1]) <= (1e-4 if dtype == torch.float32 else 3e-2)
    for a, b in zip(*grads):
        assert a.dtype == dtype and _rel_err(a, b) <= BWD_TOL[dtype]


def test_flash_head_dim_above_256_raises(cuda):
    q = torch.zeros(1, 64, 2, 272, device=cuda)
    with pytest.raises(ValueError, match="256"):
        F.flash_attention(q, q, q, causal=True)


def _paged_args(cuda, dtype, b, kh, g, d, n_pages, page, p_max, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh, g, d), dtype=np.float32)
    kp = rng.standard_normal((kh, n_pages, page, d), dtype=np.float32)
    vp = rng.standard_normal((kh, n_pages, page, d), dtype=np.float32)
    tables = rng.integers(0, n_pages, size=(b, p_max)).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda).to(dtype) for a in (q, kp, vp)]
    return args + [torch.from_numpy(tables).to(cuda),
                   torch.tensor(lengths, dtype=torch.int32, device=cuda)]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "g,d,page,lengths",
    [(2, 64, 16, [1, 16, 77, 128]), (4, 32, 8, [5, 17, 32, 1]), (2, 128, 5, [3, 40, 39, 1]),
     (2, 80, 16, [1, 16, 77, 128]), (4, 96, 8, [5, 17, 32, 1]), (2, 16, 16, [3, 40, 39, 1]),
     (16, 128, 16, [1, 16, 77, 128]), (12, 112, 8, [5, 17, 32, 1])],
)
def test_paged_kernel_matches_plain_version(cuda, dtype, atol, g, d, page, lengths):
    """Every head_dim that is a multiple of 16 up to 128; G * D > 1024 (16 x
    128, 12 x 112) splits a head's query rows over blocks."""
    args = _paged_args(cuda, dtype, 4, 4, g, d, 64, page, 128 // page + 1, lengths)
    before = P.paged_attention_decode.launches
    out = P.paged_attention_decode(*args, page_size=page)
    ref = P.paged_attention_reference(*args, page_size=page)
    torch.cuda.synchronize()
    assert P.paged_attention_decode.launches == before + 1
    assert _max_err(out, ref) <= atol


PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _paged_check(args, page, dtype):
    before = P.paged_attention_decode.launches
    out = P.paged_attention_decode(*args, page_size=page)
    ref = P.paged_attention_reference(*args, page_size=page)
    torch.cuda.synchronize()
    assert P.paged_attention_decode.launches == before + 1
    assert out.shape == ref.shape and out.dtype == dtype
    assert _max_err(out, ref) <= PAGED_TOL[dtype]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,g", [(1, 2), (8, 1), (8, 8), (12, 2), (12, 16), (20, 3),
                                 (32, 16), (64, 1), (72, 2), (72, 8), (80, 4), (128, 16),
                                 (160, 2), (255, 2), (256, 1), (256, 8), (256, 16)])
def test_paged_kernel_head_dims(cuda, dtype, d, g):
    """Every width class of the kernel's instances: odd rows (1, 255: 4-byte
    f32 and 2-byte bf16 vectors), 8- and 16-byte rows that leave lanes
    masked (12, 20, 72, 160), and G from 1 to 16 (chunked over blocks)."""
    args = _paged_args(cuda, dtype, 4, 2, g, d, 48, 8, 9, [1, 16, 71, 40], seed=d + g)
    _paged_check(args, 8, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_long_slot_splits_unequally(cuda, dtype):
    """One slot 40x longer than the rest: the split count comes from the
    shapes, so the short slots' later shares fall empty while the long one
    fills every split; and two launches on equal inputs give equal bits."""
    n, page = 40 * 50, 16
    p_max = n // page + 1
    args = _paged_args(cuda, dtype, 4, 2, 2, 64, 4 * p_max + 1, page, p_max,
                       [50, n, 49, 1], seed=3)
    n_split, _ = P.plan(4, 2, 2, 64, p_max, page, 1 if dtype == torch.bfloat16 else 0,
                        P._sm_count(cuda.index or 0))
    assert n_split > 1
    first = _paged_check(args, page, dtype)
    second = P.paged_attention_decode(*args, page_size=page)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_paged_shared_pages_bit_equal(cuda):
    """Two slots on the same pages with the same query and length give the
    same bits, with the sequence split over blocks."""
    args = _paged_args(cuda, torch.bfloat16, 4, 2, 2, 64, 64, 16, 8, [100, 100, 9, 1])
    args[3][1] = args[3][0]
    args[0][1] = args[0][0]
    out = _paged_check(args, 16, torch.bfloat16)
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_empty_slot_gives_zeros(cuda, dtype):
    """Length 0 gives zeros, as the Pallas kernel does (the gather
    reference's softmax over no position would average V instead): the
    kernel against the split reference at its own split count."""
    args = _paged_args(cuda, dtype, 3, 2, 2, 64, 64, 16, 8, [0, 77, 1])
    n_split, _ = P.plan(3, 2, 2, 64, 8, 16, 1 if dtype == torch.bfloat16 else 0,
                        P._sm_count(cuda.index or 0))
    out = P.paged_attention_decode(*args, page_size=16)
    want = P.paged_attention_split_reference(*args, page_size=16, n_split=n_split)
    torch.cuda.synchronize()
    assert not out[0].any()
    assert _max_err(out, want) <= PAGED_TOL[dtype]
