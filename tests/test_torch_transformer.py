"""ray_tpu_torch.models.transformer against ray_tpu.models.transformer:
weights carried across with params_from_jax, logits of forward, and the
port's device rule (CUDA unless the caller asks for the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as J
from ray_tpu_torch import resolve_device
from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine
from ray_tpu_torch.models import transformer as T

SMALL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)


def configs(jdt, tdt, **over):
    kw = dict(SMALL, **over)
    return J.ModelConfig(dtype=jdt, **kw), T.ModelConfig(dtype=tdt, **kw)


def jax_params(cfg, seed):
    return jax.tree.map(np.asarray, J.init_params(cfg, jax.random.PRNGKey(seed)))


def logits_both(cj, ct, seed, b, t):
    pj = J.init_params(cj, jax.random.PRNGKey(seed))
    pt = T.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    tok = np.random.default_rng(seed).integers(0, cj.vocab_size, (b, t)).astype(np.int32)
    want = np.asarray(J.forward(pj, jnp.asarray(tok), cj))
    got = T.forward(pt, torch.from_numpy(tok).long(), ct)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, t, cj.vocab_size)
    return want, got.numpy()


@pytest.mark.parametrize(
    "seed,b,t,over",
    [(7, 2, 24, {}), (3, 1, 33, {}), (5, 2, 16, dict(n_heads=8, n_kv_heads=2, d_model=128))],
)
def test_forward_logits_f32(seed, b, t, over):
    want, got = logits_both(*configs(jnp.float32, torch.float32, **over), seed, b, t)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_forward_logits_bf16():
    # bf16 rounds at each matmul output in both frameworks, in a different
    # summation order: logits of magnitude ~4 agree within a few bf16 ulps
    # (one ulp at 4 is 2**-6); bound 0.1
    want, got = logits_both(*configs(jnp.bfloat16, torch.bfloat16), 7, 2, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.1)


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_params_from_jax_is_exact(jdt):
    cj, _ = configs(jdt, torch.float32)
    pj = jax_params(cj, 1)
    pt = T.params_from_jax(pj, device="cpu")
    want_dtype = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    for path, a in flat_j:
        node = pt
        for key in path:
            node = node[key.key]
        assert node.dtype == want_dtype and tuple(node.shape) == a.shape
        np.testing.assert_array_equal(node.float().numpy(), np.asarray(a, np.float32))


def test_init_params_layout_matches_jax():
    cj, ct = configs(jnp.bfloat16, torch.bfloat16)
    pj = jax_params(cj, 0)
    pt = T.init_params(ct, torch.Generator().manual_seed(0), device="cpu")
    assert set(pt) == set(pj) and set(pt["blocks"]) == set(pj["blocks"])
    for name, a in pj["blocks"].items():
        assert tuple(pt["blocks"][name].shape) == a.shape
        assert pt["blocks"][name].dtype == torch.bfloat16
    # same generator seed, same weights; another seed, other weights
    again = T.init_params(ct, torch.Generator().manual_seed(0), device="cpu")
    other = T.init_params(ct, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(pt["head"], again["head"])
    assert not torch.equal(pt["head"], other["head"])


def test_moe_config_builds_and_carries_across():
    """An MoE config builds its own weights in the reference's layout, and
    the JAX package's carry across (the nested blocks["moe"] dict) and give
    its logits."""
    cj, ct = configs(jnp.float32, torch.float32, n_experts=4)
    pj = jax_params(cj, 0)
    own = T.init_params(ct, torch.Generator().manual_seed(0), device="cpu")
    assert set(own["blocks"]) == set(pj["blocks"])
    assert {k: tuple(v.shape) for k, v in own["blocks"]["moe"].items()} == {
        k: v.shape for k, v in pj["blocks"]["moe"].items()}
    pt = T.params_from_jax(pj, device="cpu")
    tok = np.random.default_rng(0).integers(0, cj.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(J.forward(jax.tree.map(jnp.asarray, pj), jnp.asarray(tok), cj))
    got = T.forward(pt, torch.from_numpy(tok).long(), ct)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_entry_points_raise_without_cuda():
    """No device asked for and no CUDA: the port raises, never carries on
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, ct = configs(jnp.float32, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(ct, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.params_from_jax(jax_params(J.ModelConfig(**SMALL), 0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(ct)
    assert resolve_device("cpu") == torch.device("cpu")
