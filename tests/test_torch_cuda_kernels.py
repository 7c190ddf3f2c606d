"""The port's CUDA kernels against their plain versions, on the card.

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
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_kernel_matches_plain_version(cuda, dtype, atol, causal, d):
    g = torch.Generator(device=cuda).manual_seed(d)
    qg, kg, vg = (torch.randn(8, 256, d, generator=g, device=cuda).to(dtype)
                  for _ in range(3))
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
    [(2, 64, 16, [1, 16, 77, 128]), (4, 32, 8, [5, 17, 32, 1]), (2, 128, 5, [3, 40, 39, 1])],
)
def test_paged_kernel_matches_plain_version(cuda, dtype, atol, g, d, page, lengths):
    args = _paged_args(cuda, dtype, 4, 4, g, d, 64, page, 128 // page + 1, lengths)
    before = P.paged_attention_decode.launches
    out = P.paged_attention_decode(*args, page_size=page)
    ref = P.paged_attention_reference(*args, page_size=page)
    torch.cuda.synchronize()
    assert P.paged_attention_decode.launches == before + 1
    assert _max_err(out, ref) <= atol
