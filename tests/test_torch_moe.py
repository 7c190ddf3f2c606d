"""The port's single-device MoE and KV-cache path against the JAX package's
on the CPU: ``moe_apply``, an MoE model's ``forward``, ``loss_fn`` and
gradients, and ``forward_with_cache`` (prefill and decode, dense and MoE).
Weights are carried across with ``params_from_jax``; inputs come from a
numpy seed; everything is f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as JM
from ray_tpu.models import transformer as J
from ray_tpu_torch.models import moe as TM
from ray_tpu_torch.models import transformer as T

SMALL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)


def setup(seed, **over):
    kw = dict(SMALL, **over)
    cj = J.ModelConfig(dtype=jnp.float32, **kw)
    ct = T.ModelConfig(dtype=torch.float32, **kw)
    pj = J.init_params(cj, jax.random.PRNGKey(seed))
    pt = T.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


@pytest.mark.parametrize("n_experts,b,t,cf", [(4, 2, 24, 1.25), (8, 1, 40, 1.0),
                                             (4, 3, 7, 0.5), (2, 2, 16, 2.0)])
def test_moe_apply_matches_jax(n_experts, b, t, cf):
    """One layer's MoE within 1e-5, at capacities that drop tokens (0.5,
    1.0) and that keep them all (2.0)."""
    pj = JM.init_moe(n_experts, 64, 128, 1, jax.random.PRNGKey(n_experts + t), jnp.float32)
    pj = {k: v[0] for k, v in pj.items()}
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    x = np.random.default_rng(t).standard_normal((b, t, 64), dtype=np.float32)
    want = np.asarray(JM.moe_apply(pj, jnp.asarray(x), cf))
    got = TM.moe_apply(pt, torch.from_numpy(x), cf)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_moe_apply_drops_over_capacity():
    """Routed to one expert past its capacity, the later tokens get zeros
    (their residual carries them), as in the reference."""
    router = np.zeros((8, 2), np.float32)
    router[:, 0] = 1.0  # every positive-sum token prefers expert 0
    rng = np.random.default_rng(0)
    p = {"router": torch.from_numpy(router)}
    for name, shape in (("w_gate", (2, 8, 16)), ("w_up", (2, 8, 16)), ("w_down", (2, 16, 8))):
        p[name] = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    x = torch.from_numpy(np.abs(rng.standard_normal((1, 8, 8), dtype=np.float32)))
    out = TM.moe_apply(p, x, capacity_factor=0.5)  # cap = int(0.5 * 8 / 2) = 2
    zero_rows = (out[0].abs().sum(-1) == 0).sum().item()
    assert zero_rows == 6
    pj = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    np.testing.assert_allclose(out.numpy(), np.asarray(JM.moe_apply(pj, jnp.asarray(x.numpy()),
                                                                    0.5)), atol=1e-5)


def test_moe_params_carry_nested_dict():
    cj, ct, pj, pt = setup(3, n_experts=4)
    assert set(pt["blocks"]["moe"]) == {"router", "w_gate", "w_up", "w_down"}
    assert "w_gate" not in pt["blocks"]
    for name, a in pj["blocks"]["moe"].items():
        np.testing.assert_array_equal(pt["blocks"]["moe"][name].numpy(), np.asarray(a))
    layer = T.layer(pt["blocks"], 1)
    assert tuple(layer["moe"]["w_up"].shape) == (4, 64, 128)
    # the port's own init has the reference's layout
    own = T.init_params(ct, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in own["blocks"]["moe"].items()} == {
        k: tuple(v.shape) for k, v in pj["blocks"]["moe"].items()}


@pytest.mark.parametrize("seed,b,t,over", [(0, 2, 24, dict(n_experts=4)),
                                           (1, 1, 33, dict(n_experts=2,
                                                           expert_capacity_factor=1.0)),
                                           (2, 2, 16, dict(n_experts=8, n_heads=8,
                                                           n_kv_heads=2, d_model=128))])
def test_moe_forward_matches_jax(seed, b, t, over):
    cj, ct, pj, pt = setup(seed, **over)
    tok = np.random.default_rng(seed).integers(0, cj.vocab_size, (b, t)).astype(np.int32)
    want = np.asarray(J.forward(pj, jnp.asarray(tok), cj))
    got = T.forward(pt, torch.from_numpy(tok).long(), ct)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_and_grads_match_jax(remat):
    """f32 loss and every gradient leaf (router and experts included)
    within 1e-5; remat recomputes the MoE block in the backward."""
    cj, ct, pj, pt = setup(4, n_experts=4, remat=remat)
    tok = np.random.default_rng(4).integers(0, cj.vocab_size, (2, 25)).astype(np.int32)
    loss_j, grads_j = jax.value_and_grad(J.loss_fn)(pj, jnp.asarray(tok), cj)
    leaves = T.param_leaves(pt)
    for x in leaves:
        x.requires_grad_()
    loss_t = T.loss_fn(pt, torch.from_numpy(tok).long(), ct)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=0, atol=1e-5)
    want = [np.asarray(x) for x in jax.tree.leaves(grads_j)]
    assert len(want) == len(leaves)
    for i, (x, w) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=0, atol=1e-5, err_msg=f"leaf {i}")


def test_moe_train_step_runs():
    """make_train_step over an MoE model: the loss falls over a few Adam
    steps on one batch."""
    _, ct, _, pt = setup(5, n_experts=4)
    leaves = T.param_leaves(pt)
    for x in leaves:
        x.requires_grad_()
    step = T.make_train_step(ct, torch.optim.Adam(leaves, lr=3e-3))
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, 96, (2, 17)))
    losses = [step(pt, tok).item() for _ in range(4)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("over", [{}, dict(n_experts=4)], ids=["dense", "moe"])
def test_forward_with_cache_matches_jax(over):
    """Prefill of a ragged batch (padded prompt positions written too),
    then two decode steps: logits within 1e-5 and the caches equal within
    1e-5 after each call."""
    cj, ct, pj, pt = setup(6, **over)
    b, t, s_max = 2, 9, 24
    lengths = np.array([9, 5], np.int32)
    tok = np.random.default_rng(6).integers(1, cj.vocab_size, (b, t)).astype(np.int32)
    for i, n in enumerate(lengths):
        tok[i, n:] = 0
    cache_j = J.init_kv_cache(cj, b, s_max)
    cache_t = T.init_kv_cache(ct, b, s_max, device="cpu")
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    mask = np.arange(s_max)[None, :] < lengths[:, None]
    lj, cache_j = J.forward_with_cache(pj, jnp.asarray(tok), jnp.asarray(pos), cache_j,
                                       jnp.asarray(mask), cj)
    lt, cache_t = T.forward_with_cache(pt, torch.from_numpy(tok).long(),
                                       torch.from_numpy(pos).long(), cache_t,
                                       torch.from_numpy(mask), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)
    cur = lengths.copy()
    nxt = np.asarray(lj)[np.arange(b), cur - 1].argmax(-1).astype(np.int32)
    for _ in range(2):
        mask = np.arange(s_max)[None, :] <= cur[:, None]
        lj, cache_j = J.forward_with_cache(pj, jnp.asarray(nxt[:, None]),
                                           jnp.asarray(cur[:, None]), cache_j,
                                           jnp.asarray(mask), cj)
        lt, cache_t = T.forward_with_cache(pt, torch.from_numpy(nxt[:, None]).long(),
                                           torch.from_numpy(cur[:, None]).long(), cache_t,
                                           torch.from_numpy(mask), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache_t[name].numpy(), np.asarray(cache_j[name]),
                                       rtol=0, atol=1e-5)
        nxt = np.asarray(lj)[:, 0].argmax(-1).astype(np.int32)
        cur = cur + 1


def test_init_kv_cache_layout():
    _, ct, _, _ = setup(0)
    cache = T.init_kv_cache(ct, 3, 40, device="cpu")
    assert tuple(cache["k"].shape) == (2, 3, 40, 2, 16) and cache["v"].dtype == torch.float32
