"""ray_tpu_torch flash attention against the JAX package's Pallas kernel
(interpret mode on the CPU, as tests/test_flash_attention.py runs it).

On the CPU the port's wrapper runs the kernel's plain version with the
wrapper's own GQA fold, padding and branch logic; the CUDA kernel itself is
held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as J
from ray_tpu_torch.ops import flash_attention as T
from ray_tpu_torch.ops.layers import attention_reference


def mk_qkv(seed, b, t, h, hkv, d, s=None):
    s = s or t
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    return q, k, v


def both(q, k, v, causal):
    want = J.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True)
    got = T.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_kernel(causal):
    want, got = both(*mk_qkv(0, b=2, t=256, h=4, hkv=4, d=64), causal)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_gqa_groups():
    want, got = both(*mk_qkv(1, b=1, t=128, h=8, hkv=2, d=32), True)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_ragged_causal_pads():
    # T=100 pads to the block multiple and slices back
    want, got = both(*mk_qkv(2, b=1, t=100, h=2, hkv=2, d=16), True)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_ragged_noncausal_takes_reference():
    q, k, v = mk_qkv(4, b=1, t=100, h=2, hkv=2, d=16)
    want, got = both(q, k, v, False)
    np.testing.assert_allclose(got, want, atol=2e-3)
    ref = attention_reference(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_grouped_forward_and_lse_match_jax(causal):
    """The kernel's plain version on the grouped layout: O and the per-row
    logsumexp against the Pallas forward (_fwd_impl) in interpret mode."""
    rng = np.random.default_rng(5)
    qg, kg, vg = (rng.standard_normal((3, 128, 32), dtype=np.float32) for _ in range(3))
    o_j, lse_j = J._fwd_impl(*map(jnp.asarray, (qg, kg, vg)), causal, 128, 128, True)
    o_t, lse_t = T.flash_attention_forward(*map(torch.from_numpy, (qg, kg, vg)), causal)
    assert tuple(lse_t.shape) == (3, 1, 128) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-3)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=2e-3)


def test_bf16_rounding_points():
    """bf16: q * scale in bf16, P cast to bf16 before P.V (the Pallas
    kernel's rounding points), against the JAX kernel on the same bf16
    inputs; bound: a few bf16 ulps of |O| <= 4."""
    q, k, v = mk_qkv(6, b=1, t=128, h=4, hkv=2, d=32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv))
    want = np.asarray(J.flash_attention(jq, jk, jv, causal=True, interpret=True)
                      .astype(jnp.float32))
    got = T.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=3e-2)


def test_backward_is_not_ported_yet():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in mk_qkv(7, 1, 64, 2, 2, 32))
    out = T.flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


@pytest.mark.parametrize(
    "shape_q,shape_k,dtype",
    [
        ((2, 128, 16), (2, 128, 16), torch.float32),   # head_dim 16
        ((2, 100, 32), (2, 100, 32), torch.float32),   # T not a block multiple
        ((2, 128, 32), (2, 128, 32), torch.float16),   # dtype
        ((2, 128, 32), (3, 128, 32), torch.float32),   # bh mismatch
    ],
)
def test_kernel_input_checks(shape_q, shape_k, dtype):
    qg = torch.zeros(shape_q, dtype=dtype)
    kg = torch.zeros(shape_k, dtype=dtype)
    with pytest.raises((ValueError, TypeError)):
        T._check_inputs(qg, kg, kg)

