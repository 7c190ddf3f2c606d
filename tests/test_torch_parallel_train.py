"""The JAX package's 8-device dry run (``__graft_entry__.dryrun_multichip``)
against the port's on 8 gloo ranks: configuration A (dp=2 x pp=2 x tp=2,
dense, 4 layers, B=8, T=32, 4 microbatches), A with remat, and B (dp=2 x
tp=2 x sp=2, MoE with 4 experts over tp, ring attention, 2 layers, B=4,
T=32), and moe_m3 (A's mesh, B's MoE model at vocab 96, B=6 in three
microbatches, which dp=2 does not divide), each from the reference's own parameters and tokens (PRNGKey 0 and
1), ``shard_params`` on each rank. The first step's loss within 1e-5 and
every gradient, reduced and gathered to the full layout, within 1e-4 of
``jax.grad`` on the same mesh; a second SGD step's loss within 1e-5
(``torch.optim.SGD`` against ``optax.sgd``: Adam's first step is a sign
function and would amplify last-bit noise). Then the port's own
``dryrun_multichip(8, "cpu")`` runs with finite losses."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tpu.models import transformer as J
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu_torch.parallel import dryrun, launch

LR = 0.1
RUNS = {"A": dryrun.runs(8)[0], "A_remat": dataclasses.replace(
    dryrun.runs(8)[0], model=dataclasses.replace(dryrun.BASE, remat=True)),
    "B": dryrun.runs(8)[1],
    # MoE under pp where dp=2 does not divide M=3: the middle microbatch
    # straddles the dp ranks and is routed over all of its rows
    "moe_m3": dryrun.Run(dryrun.MeshConfig(dp=2, pp=2, tp=2), dataclasses.replace(
        dryrun.MOE, vocab_size=96), 6, 32, microbatches=3)}


def jax_config(run):
    fields = {f.name: getattr(run.model, f.name) for f in dataclasses.fields(run.model)
              if f.name not in ("dtype", "remat")}
    return J.ModelConfig(dtype=jnp.float32, **fields)


def jax_inputs(run):
    cj = jax_config(run)
    params = J.init_params(cj, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (run.batch, run.seq + 1), 0,
                                cj.vocab_size)
    return cj, params, tokens


@pytest.fixture(scope="module")
def port():
    """One 8-rank gloo launch: two SGD steps of each run, from the JAX
    package's parameters and tokens, with the first step's gradients."""
    names = list(RUNS)
    ins = [jax_inputs(RUNS[n]) for n in names]
    params = [jax.tree.map(np.asarray, p) for _, p, _ in ins]
    tokens = [np.asarray(t) for _, _, t in ins]
    res = launch(dryrun.train_rank, 8,
                 ([RUNS[n] for n in names], "cpu", "sgd", LR, 2, params, tokens, True),
                 device="cpu", timeout=600)
    assert all(r[i]["losses"] == res[0][i]["losses"] for r in res for i in range(len(names)))
    return dict(zip(names, res[0]))


@pytest.fixture(scope="module")
def reference():
    """JAX's loss and gradients on the 8-device mesh, and the loss after one
    optax.sgd step, for A, B and moe_m3 (A's numbers hold for A_remat too)."""
    out = {}
    for name in ("A", "B", "moe_m3"):
        run = RUNS[name]
        cj, params, tokens = jax_inputs(run)
        mesh = j_build_mesh(JMeshConfig(**vars(run.mesh)), jax.devices()[:8])
        params = J.shard_params(params, cj, mesh)
        vg = jax.jit(jax.value_and_grad(partial(J.loss_fn, cfg=cj, mesh=mesh,
                                                num_microbatches=run.num_microbatches)))
        loss, grads = vg(params, tokens)
        opt = optax.sgd(LR)
        updates, _ = opt.update(grads, opt.init(params), params)
        loss2, _ = vg(optax.apply_updates(params, updates), tokens)
        out[name] = dict(losses=[float(loss), float(loss2)],
                         grads=jax.tree.map(np.asarray, grads))
    out["A_remat"] = out["A"]
    return out


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


@pytest.mark.parametrize("name", list(RUNS))
def test_first_step_loss_matches_jax(name, port, reference):
    np.testing.assert_allclose(port[name]["losses"][0], reference[name]["losses"][0],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(RUNS))
def test_gradients_match_jax(name, port, reference):
    want = dict(_leaves(reference[name]["grads"]))
    got = dict(_leaves(port[name]["grads"]))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("name", list(RUNS))
def test_second_sgd_step_loss_matches_jax(name, port, reference):
    np.testing.assert_allclose(port[name]["losses"][1], reference[name]["losses"][1],
                               rtol=0, atol=1e-5)
    assert port[name]["losses"][1] < port[name]["losses"][0]


def test_first_step_losses_are_the_reference_dry_runs(port):
    """The losses ``__graft_entry__.py --dryrun`` prints for A and B."""
    assert (round(port["A"]["losses"][0], 4), round(port["B"]["losses"][0], 4)) == (
        6.7787, 6.6562)


def test_dryrun_multichip_on_gloo():
    results = dryrun.dryrun_multichip(8, "cpu")
    assert len(results) == 2
    assert all(np.isfinite(r["losses"][0]) for r in results)
