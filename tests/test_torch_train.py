"""The port's training path against the JAX package's on the CPU: loss_fn
and its gradients, three AdamW steps of make_train_step against optax, and
remat. Weights are carried across with params_from_jax; tokens come from a
numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as J
from ray_tpu_torch.models import transformer as T

SMALL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)


def setup(seed, b=2, t=25, **over):
    kw = dict(SMALL, **over)
    cj = J.ModelConfig(dtype=jnp.float32, **kw)
    ct = T.ModelConfig(dtype=torch.float32, **kw)
    pj = J.init_params(cj, jax.random.PRNGKey(seed))
    pt = T.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    tok = np.random.default_rng(seed).integers(0, cj.vocab_size, (b, t)).astype(np.int32)
    return cj, ct, pj, pt, tok


def trainable(pt):
    leaves = T.param_leaves(pt)
    for x in leaves:
        x.requires_grad_()
    return leaves


def jax_leaves(tree):
    """numpy leaves in jax.tree.leaves' order, which param_leaves mirrors."""
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def assert_trees_close(got, want, atol, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, f"{what} leaf {i}"
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=atol,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("seed,over", [(0, {}), (1, dict(n_heads=8, n_kv_heads=2, d_model=128))])
def test_loss_and_grads_match_jax(seed, over):
    """f32: the loss within 1e-5 and every gradient leaf within 1e-5 (f32
    sums in another order; gradients here are at most ~1 in magnitude)."""
    cj, ct, pj, pt, tok = setup(seed, **over)
    loss_j, grads_j = jax.value_and_grad(J.loss_fn)(pj, jnp.asarray(tok), cj)
    leaves = trainable(pt)
    loss_t = T.loss_fn(pt, torch.from_numpy(tok).long(), ct)
    loss_t.backward()
    assert loss_t.dtype == torch.float32 and loss_t.dim() == 0
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=0, atol=1e-5)
    assert_trees_close([x.grad for x in leaves], jax_leaves(grads_j), 1e-5, "grad")


def test_adamw_steps_match_optax():
    """Three steps of make_train_step with torch.optim.AdamW against the JAX
    train step with optax.adamw(1e-3): losses within 1e-5 and parameters
    within 1e-5 after each step. Adam's first steps move each weight by
    about lr * sign(g), so a gradient that differs in its last f32 bits
    moves the weight by the same amount in both."""
    cj, ct, pj, pt, tok = setup(2)
    opt_j = optax.adamw(1e-3)
    state_j = opt_j.init(pj)
    step_j = jax.jit(J.make_train_step(cj, opt_j))
    leaves = trainable(pt)
    opt_t = torch.optim.AdamW(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4)
    step_t = T.make_train_step(ct, opt_t)
    tok_t = torch.from_numpy(tok).long()
    for step in range(3):
        pj, state_j, loss_j = step_j(pj, state_j, jnp.asarray(tok))
        loss_t = step_t(pt, tok_t)
        assert not loss_t.requires_grad and all(x.grad is None for x in leaves)
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=0, atol=1e-5,
                                   err_msg=f"loss, step {step}")
        assert_trees_close(leaves, jax_leaves(pj), 1e-5, f"params after step {step}")
    assert float(loss_j) < float(J.loss_fn(J.init_params(cj, jax.random.PRNGKey(2)),
                                           jnp.asarray(tok), cj))


def test_remat_gives_the_same_grads():
    """Recomputing each block in the backward is exact on the CPU."""
    grads = []
    for remat in (False, True):
        _, ct, _, pt, tok = setup(3, remat=remat)
        leaves = trainable(pt)
        T.loss_fn(pt, torch.from_numpy(tok).long(), ct).backward()
        grads.append([x.grad for x in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_param_leaves_order_matches_jax():
    cj, _, pj, pt, _ = setup(4)
    names_j = ["/".join(str(k.key) for k in path)
               for path, _ in jax.tree_util.tree_leaves_with_path(pj)]
    assert len(T.param_leaves(pt)) == len(names_j)
    for x, path in zip(T.param_leaves(pt), names_j):
        node = pt
        for key in path.split("/"):
            node = node[key]
        assert x is node
