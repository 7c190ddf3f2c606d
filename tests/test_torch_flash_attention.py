"""ray_tpu_torch flash attention, forward and backward, against the JAX
package's Pallas kernels (interpret mode on the CPU, as
tests/test_flash_attention.py runs them).

On the CPU the port's wrappers run the kernels' plain versions with the
wrapper's own GQA fold, padding and branch logic; the CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import jax
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


@pytest.mark.parametrize("d", [80, 96, 160, 256])
@pytest.mark.parametrize(
    "shape,causal",
    [((1, 128, 4, 2), True), ((2, 128, 4, 4), False), ((1, 100, 4, 2), True)],
)
def test_padded_head_dims_match_jax_kernel(d, shape, causal):
    """head_dim 80 and 96 (between the kernels' widths) are zero-padded to
    128, and 160 to 256, and sliced back, the softmax scale kept at
    1/sqrt(d); 256 is a kernel width itself: causal GQA 4->2, non-causal,
    and ragged causal T=100 (padded in T as well)."""
    want, got = both(*mk_qkv(12, *shape, d), causal)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_head_dim_pad_widths():
    assert [T._padded_head_dim(d) for d in (16, 32, 48, 64, 80, 96, 112, 128, 129, 160, 256,
                                            272)] == [
        32, 32, 64, 64, 128, 128, 128, 128, 256, 256, 256, 272]


def test_ragged_noncausal_takes_reference():
    q, k, v = mk_qkv(4, b=1, t=100, h=2, hkv=2, d=16)
    want, got = both(q, k, v, False)
    np.testing.assert_allclose(got, want, atol=2e-3)
    ref = attention_reference(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,s", [(128, 128), (192, 192), (128, 320)])
def test_grouped_forward_and_lse_match_jax(causal, t, s):
    """The kernel's plain version on the grouped layout: O and the per-row
    logsumexp against the Pallas forward (_fwd_impl, 64-row blocks) in
    interpret mode. The tails pin what the CUDA kernel must keep where its
    128-key tile overruns: T = 192 is not a multiple of 128, and T = 128
    with S = 320 puts keys past every causal query and past the last full
    128-key tile (no causal offset when T != S)."""
    rng = np.random.default_rng(5)
    qg = rng.standard_normal((3, t, 32), dtype=np.float32)
    kg, vg = (rng.standard_normal((3, s, 32), dtype=np.float32) for _ in range(2))
    o_j, lse_j = J._fwd_impl(*map(jnp.asarray, (qg, kg, vg)), causal, 64, 64, True)
    o_t, lse_t = T.flash_attention_forward(*map(torch.from_numpy, (qg, kg, vg)), causal)
    assert tuple(lse_t.shape) == (3, 1, t) and lse_t.dtype == torch.float32
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


def grads_both(q, k, v, causal, loss):
    """Grads of loss(out) w.r.t. q, k, v: jax.grad through the Pallas
    kernels (interpret mode) and torch autograd through the port's wrapper
    (the backward's plain version on the CPU)."""
    def f(q, k, v):
        return loss(J.flash_attention(q, k, v, causal=causal, interpret=True), jnp)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    loss(T.flash_attention(tq, tk, tv, causal=causal), torch).backward()
    return [np.asarray(w) for w in want], [x.grad.numpy() for x in (tq, tk, tv)]


def cos_loss(out, xp):
    return xp.sum(out * xp.cos(out))  # non-uniform cotangent


@pytest.mark.parametrize(
    "name,shape,causal,loss",
    [
        ("causal", (2, 256, 4, 4, 64), True, cos_loss),
        ("non-causal", (2, 256, 4, 4, 64), False, cos_loss),
        ("GQA 8->2", (1, 128, 8, 2, 32), True, lambda o, xp: o.sum()),
        ("ragged causal T=70", (1, 70, 2, 2, 16), True, lambda o, xp: (o**2).sum()),
        ("D=80 GQA 4->2", (1, 128, 4, 2, 80), True, cos_loss),
        ("D=80 ragged causal T=70", (1, 70, 4, 2, 80), True, lambda o, xp: (o**2).sum()),
        ("D=96 GQA 4->2", (1, 128, 4, 2, 96), True, cos_loss),
        ("D=96 ragged causal T=100", (1, 100, 4, 2, 96), True, cos_loss),
        ("D=160 GQA 4->2", (1, 128, 4, 2, 160), True, cos_loss),
        ("D=256 ragged causal T=100", (1, 100, 2, 2, 256), True, cos_loss),
    ],
)
def test_grads_match_jax_kernel(name, shape, causal, loss):
    """The cases of tests/test_flash_attention.py's backward tests, at the
    reference's own tolerance (atol 5e-3): dk/dv sum over GQA groups and
    the ragged pad's gradients are dropped. head_dim 80 and 96 are padded to
    128, and 160 to 256, with the scale kept at 1/sqrt(real head_dim); the
    pad's gradients are dropped too."""
    want, got = grads_both(*mk_qkv(8, *shape), causal, loss)
    for w, g, n in zip(want, got, "qkv"):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=5e-3, err_msg=f"{name}: d{n}")


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 0, 1e-5),
                                              (torch.bfloat16, 2**-7, 3e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,s", [(128, 128), (128, 256)])
@pytest.mark.parametrize("d", [32, 128])
def test_backward_reference_matches_pallas_bwd(dtype, rtol, atol, causal, t, s, d):
    """flash_attention_backward_reference against the Pallas backward
    (_flash_grouped_bwd, interpret mode) on the grouped layout, given the
    same dO, O and lse. f32: sums in another order, atol 1e-5. bf16: both
    round dS to bf16 before dS.K and dS^T.Q, where an f32 difference in
    the last bit can flip one bf16 rounding (2**-8 relative), and dq/dk/dv
    (|x| up to ~8 here) are rounded to bf16: two bf16 ulps of the value
    (rtol 2**-7) plus atol 3e-2. S > T covers the keys no query sees.
    head_dim 128 is the train shape's, where the scale 1/sqrt(128) is not
    a power of two, so q * scale rounds (a rounding point both keep)."""
    rng = np.random.default_rng(9)
    qg, do = (rng.standard_normal((3, t, d), dtype=np.float32) for _ in range(2))
    kg, vg = (rng.standard_normal((3, s, d), dtype=np.float32) for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (qg, kg, vg, do))
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.dtype(str(dtype)[6:]))
                       for t in (tq, tk, tv, tdo))
    out, lse = T.flash_attention_forward(tq, tk, tv, causal)
    jout, jlse = jnp.asarray(out.float().numpy()).astype(jq.dtype), jnp.asarray(lse.numpy())
    want = J._flash_grouped_bwd(causal, 128, 128, True, (jq, jk, jv, jout, jlse), jdo)
    delta = (tdo.float() * out.float()).sum(-1)[:, None, :]
    got = T.flash_attention_backward_reference(tq, tk, tv, tdo, lse, delta, causal)
    for w, g, n in zip(want, got, "qkv"):
        assert g.dtype == dtype and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   rtol=rtol, atol=atol, err_msg=f"d{n}")
    # the CPU wrapper is the plain version, through both kernel wrappers
    assert all(torch.equal(a, b) for a, b in zip(
        got, T.flash_attention_backward(tq, tk, tv, tdo, lse, delta, causal)))


@pytest.mark.parametrize("causal", [True, False])
def test_dv_from_bf16_hi_lo_split_of_p(causal):
    """The bf16 dK/dV kernel forms dV = P^T.dO from P_hi = bf16(P) and
    P_lo = bf16(P - P_hi), two products with f32 sums, where the plain
    version (as Pallas) takes P in f32. The two agree within 2**-16 of the
    largest entry of dV; P rounded to bf16 alone (P_hi) does not."""
    rng = np.random.default_rng(10)
    qg, kg, vg, do = (torch.from_numpy(rng.standard_normal((4, 256, 128), dtype=np.float32))
                      .bfloat16() for _ in range(4))
    _, lse = T.flash_attention_forward(qg, kg, vg, causal)
    p, _ = T._recompute_p(qg, kg, lse, causal)
    do32 = do.float()
    want = p.transpose(1, 2) @ do32  # flash_attention_bwd_dkv_reference's dV, before the cast
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    got = p_hi.transpose(1, 2) @ do32 + p_lo.transpose(1, 2) @ do32
    bound = 2**-16 * want.abs().max().item()
    assert (got - want).abs().max().item() <= bound
    assert (p_hi.transpose(1, 2) @ do32 - want).abs().max().item() > bound


def test_backward_input_checks():
    qg = torch.zeros(2, 128, 32)
    row = torch.zeros(2, 1, 128)
    T._check_bwd_inputs(qg, qg, qg, qg, row, row)
    for do, lse in ((qg.bfloat16(), row), (qg[:, :64], row), (qg, row.double()),
                    (qg, row[:, :, :64])):
        with pytest.raises((ValueError, TypeError)):
            T._check_bwd_inputs(qg, qg, qg, do, lse, row)


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



def test_head_dim_above_256_is_refused_naming_the_limit():
    """head_dim 272 reaches the kernels unpadded and is refused with the
    widths they take; 256 is taken."""
    T._check_inputs(*(torch.zeros(2, 128, 256) for _ in range(3)))
    with pytest.raises(ValueError, match="256"):
        T._check_inputs(*(torch.zeros(2, 128, 272) for _ in range(3)))
