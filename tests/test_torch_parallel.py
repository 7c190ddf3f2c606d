"""The port's mesh, sharded ops and model forward against the JAX package's
on the CPU: ``MeshConfig.auto`` and the rank layout, the raises without
CUDA, ring and Ulysses attention at sp=4 and the GPipe pipeline at pp=2
(each against the reference under ``shard_map`` on the virtual CPU
devices), expert parallelism at dp=2 x tp=2 with dropped tokens (against
``moe_apply`` over the global batch), and ``forward`` on a mesh at dp=2,
tp=2, pp=2, sp=4 ring and Ulysses, dp=2 x tp=2 and MoE at dp=2 x pp=2,
against the reference's ``forward`` on the same mesh. The port's side runs
on gloo ranks (``ray_tpu_torch.parallel.launch``); the checks of one world
size share one launch. Inputs come from a numpy seed or JAX's PRNGKey;
everything is f32."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from ray_tpu.models import moe as JM
from ray_tpu.models import transformer as J
from ray_tpu.ops.pipeline import pipeline_apply as j_pipeline_apply
from ray_tpu.ops.ring_attention import ring_attention as j_ring
from ray_tpu.ops.ulysses import ulysses_attention as j_ulysses
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.parallel import MeshConfig, build_mesh, launch, local_mesh
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import programs

OUT_TOL, GRAD_TOL = 2e-5, 1e-4

# (name, kind, causal, h, hkv); B=2, T=32 (8 a rank at sp=4), head_dim 16
ATTN = [("ring_causal_gqa", "ring", True, 4, 2), ("ring_plain_gqa", "ring", False, 4, 2),
        ("ring_causal_mha", "ring", True, 4, 4),
        ("ulysses_causal_lcm", "ulysses", True, 8, 2), ("ulysses_plain", "ulysses", False, 8, 4),
        ("ulysses_causal_gqa", "ulysses", True, 4, 4)]
MOE_CF = 0.5  # capacity int(0.5 * 32 / 4) = 4 tokens an expert: tokens are dropped

# the JAX package's own mesh-test model (tests/test_model.py), and forward
# cases: (name, mesh, microbatches, config overrides, batch)
MODEL = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=64,
             max_seq_len=64)
LOGIT_TOL = 2e-4  # the JAX package's mesh-vs-dense tolerance
FORWARD2 = [("dp2", dict(dp=2), 0, {}, 8), ("tp2", dict(tp=2), 0, {}, 8),
            ("pp2", dict(pp=2), 4, {}, 8)]
FORWARD4 = [("sp4_ring", dict(sp=4), 0, {}, 8),
            ("sp4_ulysses", dict(sp=4), 0, dict(sp_attention="ulysses"), 8),
            ("dp2_tp2", dict(dp=2, tp=2), 0, {}, 8),
            ("moe_dp2_pp2", dict(dp=2, pp=2), 4, dict(n_experts=4, n_layers=2), 8),
            # three microbatches of two rows over dp=2: the middle one straddles
            ("moe_dp2_pp2_m3", dict(dp=2, pp=2), 3, dict(n_experts=4, n_layers=2), 6)]
# meshes that do not divide the model, which both packages refuse: (name,
# mesh, config overrides, the port's message)
UNEVEN = [("tp3_over_4_heads", dict(tp=3), {}, "tp=3 must divide n_heads=4"),
          ("pp3_over_2_layers", dict(pp=3), dict(n_layers=2), "pp=3 must divide n_layers=2"),
          ("ulysses_tp2_sp4_over_4_heads", dict(tp=2, sp=4), dict(sp_attention="ulysses"),
           "sp=4 must divide the 2 heads of a tp rank for Ulysses")]


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def attn_inputs(i, h, hkv):
    b, t, d = 2, 32, 16
    return dict(q=_rand(10 * i, b, t, h, d), k=_rand(10 * i + 1, b, t, hkv, d),
                v=_rand(10 * i + 2, b, t, hkv, d), cot=_rand(10 * i + 3, b, t, h, d))


def moe_inputs():
    pj = JM.init_moe(4, 16, 32, 1, jax.random.PRNGKey(5), jnp.float32)
    params = {k: np.asarray(v[0]) for k, v in pj.items()}
    return dict(params=params, x=_rand(50, 4, 8, 16), cot=_rand(51, 4, 8, 16))


def model_inputs(over, batch):
    kw = dict(MODEL, **over)
    cj = J.ModelConfig(dtype=jnp.float32, **kw)
    params = jax.tree.map(np.asarray, J.init_params(cj, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(batch).integers(0, MODEL["vocab_size"], (batch, 16))
    return cj, T.ModelConfig(dtype=torch.float32, **kw), params, tokens.astype(np.int32)


def forward_cases(table):
    out = []
    for name, mesh, m, over, batch in table:
        _, ct, params, tokens = model_inputs(over, batch)
        out.append((name, programs.forward_case,
                    dict(mesh_config=MeshConfig(**mesh), cfg=ct, params=params, tokens=tokens,
                         num_microbatches=m)))
    return out


@pytest.fixture(scope="module")
def world2():
    """One 2-rank gloo launch of every world-2 case."""
    cases = [("pipeline_pp2", programs.pipeline_case, dict(pp=2, **pipeline_inputs()))]
    cases += forward_cases(FORWARD2)
    return launch(programs.run_cases, 2, (cases, "cpu"), device="cpu", timeout=300)[0]


@pytest.fixture(scope="module")
def world4():
    """One 4-rank gloo launch of every world-4 case."""
    cases = [(name, programs.attention_case,
              dict(kind=kind, sp=4, causal=causal, **attn_inputs(i, h, hkv)))
             for i, (name, kind, causal, h, hkv) in enumerate(ATTN)]
    cases.append(("ulysses_heads_raise", programs.attention_case,
                  dict(kind="ulysses", sp=4, causal=True, **attn_inputs(9, 6, 2))))
    cases.append(("moe_dp2_tp2", programs.moe_case,
                  dict(dp=2, tp=2, capacity_factor=MOE_CF, **moe_inputs())))
    cases += forward_cases(FORWARD4)
    return launch(programs.run_cases, 4, (cases, "cpu"), device="cpu", timeout=300)[0]


@pytest.mark.parametrize("n", range(1, 17))
def test_auto_matches_jax(n):
    assert MeshConfig.auto(n) == MeshConfig(**vars(JMeshConfig.auto(n)))


@pytest.mark.parametrize("shape", [dict(dp=2, pp=2, tp=2), dict(dp=2, tp=2, sp=2), dict(sp=4),
                                   dict(pp=2, tp=4), dict(dp=8)])
def test_rank_layout_matches_jax_device_grid(shape, devices8):
    """Rank r sits where JAX's mesh puts device r, and each axis's group is
    the ranks along that axis of JAX's device grid, in order."""
    cfg = MeshConfig(**shape)
    grid = np.vectorize(lambda d: d.id)(j_build_mesh(JMeshConfig(**shape), devices8).devices)
    for r in range(cfg.size):
        coords = tmesh.rank_coords(cfg, r)
        assert grid[tuple(coords[a] for a in tmesh.AXES)] == r
    for i, axis in enumerate(tmesh.AXES):
        want = sorted(np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]).tolist())
        assert sorted(tmesh.axis_groups(cfg, axis)) == want


def test_default_device_is_cuda_and_raises_without_it():
    """No fallback to gloo or the CPU: the mesh, the size-1 mesh and the
    launcher all raise without CUDA, and the launcher starts nothing."""
    def nope():
        raise AssertionError("launched")

    for call in (lambda: build_mesh(MeshConfig(dp=2)), lambda: local_mesh(),
                 lambda: launch(nope, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cpu_mesh_needs_the_launcher():
    assert local_mesh("cpu").shape == dict(dp=1, pp=1, tp=1, sp=1)
    with pytest.raises(RuntimeError, match="launch"):
        build_mesh(MeshConfig(tp=2), "cpu")


def _jax_attention(kind, causal, q, k, v, cot, devices):
    mesh = JMesh(np.array(devices[:4]), ("sp",))
    fn = shard_map(partial(j_ulysses if kind == "ulysses" else j_ring, axis_name="sp",
                           causal=causal),
                   mesh=mesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"))
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: (fn(q, k, v) * cot).sum(), argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("i", range(len(ATTN)), ids=[a[0] for a in ATTN])
def test_sequence_parallel_attention_matches_jax(i, world4, devices8):
    """Output within 2e-5 and the gradients of q, k and v within 1e-4 of the
    reference's op under shard_map over 4 devices (GQA, the Ulysses lcm path
    where Hkv < sp)."""
    name, kind, causal, h, hkv = ATTN[i]
    inp = attn_inputs(i, h, hkv)
    out, grads = _jax_attention(kind, causal, devices=devices8, **inp)
    got = world4[name]
    np.testing.assert_allclose(got["out"], out, rtol=0, atol=OUT_TOL)
    for key, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[key], want, rtol=0, atol=GRAD_TOL, err_msg=key)


def test_ulysses_raises_when_heads_do_not_divide(world4):
    assert world4["ulysses_heads_raise"] == "n_heads=6 must divide by sp=4 for Ulysses"


def test_expert_parallel_matches_jax_over_the_global_batch(world4):
    """dp=2 x tp=2: routing over the global batch (capacity and positions
    across the dp ranks, tokens dropped), experts over tp; output within
    2e-5 and every gradient within 1e-4 of the reference's moe_apply on the
    whole batch."""
    inp = moe_inputs()
    pj = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    x, cot = jnp.asarray(inp["x"]), jnp.asarray(inp["cot"])
    # the reference's routing drops tokens at this capacity
    probs = jax.nn.softmax(x.reshape(-1, 16) @ pj["router"], axis=-1)
    per_expert = np.bincount(np.asarray(jnp.argmax(probs, -1)), minlength=4)
    assert per_expert.max() > int(MOE_CF * 32 / 4)

    def loss(p, x):
        return (JM.moe_apply(p, x, MOE_CF) * cot).sum()

    out = JM.moe_apply(pj, x, MOE_CF)
    gp, gx = jax.grad(loss, argnums=(0, 1))(pj, x)
    got = world4["moe_dp2_tp2"]
    np.testing.assert_allclose(got["out"], np.asarray(out), rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(got["dx"], np.asarray(gx), rtol=0, atol=GRAD_TOL)
    for k in pj:
        np.testing.assert_allclose(got["grads"][k], np.asarray(gp[k]), rtol=0, atol=GRAD_TOL,
                                   err_msg=k)


def pipeline_inputs():
    layers, m, mb, d = 4, 4, 2, 8
    return dict(w=_rand(60, layers, d, d) * 0.5, b=_rand(61, layers, d) * 0.1,
                x=_rand(62, m, mb, d), cot=_rand(63, m, mb, d))


def _jax_stage(p, x):
    for i in range(p["w"].shape[0]):
        x = jnp.tanh(x @ p["w"][i] + p["b"][i])
    return x


def test_pipeline_matches_jax(world2, devices8):
    """pp=2, M=4: the outputs within 2e-5 and the gradients of the stage
    weights and of x within 1e-4 of the reference's pipeline_apply under
    shard_map."""
    inp = pipeline_inputs()
    mesh = JMesh(np.array(devices8[:2]), ("pp",))
    fn = shard_map(lambda p, x: j_pipeline_apply(_jax_stage, p, x, "pp"), mesh=mesh,
                   in_specs=({"w": P("pp"), "b": P("pp")}, P()), out_specs=P())
    p = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    x, cot = jnp.asarray(inp["x"]), jnp.asarray(inp["cot"])
    out = jax.jit(fn)(p, x)
    gp, gx = jax.jit(jax.grad(lambda p, x: (fn(p, x) * cot).sum(), argnums=(0, 1)))(p, x)
    got = world2["pipeline_pp2"]
    np.testing.assert_allclose(got["out"], np.asarray(out), rtol=0, atol=OUT_TOL)
    for key, want in (("dw", gp["w"]), ("db", gp["b"]), ("dx", gx)):
        np.testing.assert_allclose(got[key], np.asarray(want), rtol=0, atol=GRAD_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("world,case", [("world2", c) for c in FORWARD2]
                         + [("world4", c) for c in FORWARD4],
                         ids=[c[0] for c in FORWARD2 + FORWARD4])
def test_forward_on_a_mesh_matches_jax(world, case, request, devices8):
    """Logits within 2e-4 of the reference's forward on the same mesh and
    params (each rank's shard of them, ``shard_params``)."""
    name, mesh, m, over, batch = case
    cj, _, params, tokens = model_inputs(over, batch)
    jmesh = j_build_mesh(JMeshConfig(**mesh), devices8)
    pj = J.shard_params(jax.tree.map(jnp.asarray, params), cj, jmesh)
    want = np.asarray(jax.jit(partial(J.forward, cfg=cj, mesh=jmesh, num_microbatches=m))(
        pj, jnp.asarray(tokens)))
    got = request.getfixturevalue(world)[name]
    assert got.shape == want.shape == (batch, 16, MODEL["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_moe_under_pp_raises_when_dp_does_not_divide_the_microbatches(world4, devices8):
    """Named for the refusal the port made before Queue C 3 was repaired.
    It no longer raises: when dp=2 does not divide M=3, the middle
    microbatch (global rows 2-3) straddles the two dp ranks, and each rank
    routes it over all of its rows, as JAX does. The logits equal the
    reference's within 2e-4."""
    name, mesh, m, over, batch = FORWARD4[-1]
    assert (m % mesh["dp"], batch // m) == (1, 2)
    cj, _, params, tokens = model_inputs(over, batch)
    jmesh = j_build_mesh(JMeshConfig(**mesh), devices8)
    pj = J.shard_params(jax.tree.map(jnp.asarray, params), cj, jmesh)
    want = np.asarray(jax.jit(partial(J.forward, cfg=cj, mesh=jmesh, num_microbatches=m))(
        pj, jnp.asarray(tokens)))
    assert not isinstance(world4[name], str), world4[name]
    np.testing.assert_allclose(world4[name], want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("case", UNEVEN, ids=[c[0] for c in UNEVEN])
def test_both_packages_refuse_a_mesh_that_does_not_divide(case, devices8):
    """JAX raises in ``shard_params`` (``device_put`` of a shard that does
    not divide) or in ``loss_fn`` (``shard_map`` of Ulysses heads); the
    port raises in ``check_mesh``."""
    _, mesh, over, message = case
    cj, ct, params, tokens = model_inputs(over, 8)
    jmesh = j_build_mesh(JMeshConfig(**mesh), devices8)
    with pytest.raises(ValueError, match="divisible"):
        pj = J.shard_params(jax.tree.map(jnp.asarray, params), cj, jmesh)
        jax.jit(partial(J.loss_fn, cfg=cj, mesh=jmesh))(pj, jnp.asarray(tokens))
    with pytest.raises(ValueError, match=message):
        T.check_mesh(ct, tmesh.Mesh(MeshConfig(**mesh), 0, torch.device("cpu")))


def test_tp_must_divide_the_model():
    cfg = T.ModelConfig(dtype=torch.float32, **dict(MODEL, n_kv_heads=1))
    mesh = tmesh.Mesh(MeshConfig(tp=2), 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="n_kv_heads=1"):
        T.check_mesh(cfg, mesh)
