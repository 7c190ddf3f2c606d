"""The simulated-scale harness (``ray_tpu_torch.scheduler.sim``) on the CPU.

It drives the port's real ``HeadServer`` (scheduler thread, batch popping,
pipelined or synchronous rounds, ring unparking, the elasticity
controller) with ``_send_grants`` replaced by a sink. Mirrors
``tests/test_sched_pipeline.py::test_sim_modes_place_identically``, then
holds the port against the JAX package: the same seeded stream through
both heads must put every spec on the same node (scheduler outputs are
integers: bit-identical), under both weight sets, and the elasticity
tick's solve path and plan must agree.
"""
import importlib

import pytest

PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's head brings its scheduler up on cuda and raises without
    # it; here both packages' rounds run on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _sim(pkg):
    return importlib.import_module(f"{pkg}.scheduler.sim")


def test_sim_modes_place_identically():
    """Both modes deliver every demand and place each spec on the SAME
    node (the divergence check, small)."""
    pair = _sim("ray_tpu_torch").run_sim_pair(16, 600, timeout_s=120.0)
    assert pair["sync"]["completed"] and pair["pipelined"]["completed"]
    assert pair["sync"]["delivered"] == 600
    assert pair["pipelined"]["delivered"] == 600
    assert pair["placement_divergence"] == 0


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("seed", [0, 3])
def test_run_sim_places_like_jax(seed, pipeline):
    runs = {
        pkg: _sim(pkg).run_sim(16, 600, pipeline=pipeline, seed=seed,
                               collect_assignments=True, timeout_s=120.0)
        for pkg in PKGS
    }
    for out in runs.values():
        assert out["completed"] and out["delivered"] == 600
    assert runs["ray_tpu_torch"]["assignments"] == runs["ray_tpu"]["assignments"]


def test_run_sim_heterogeneous_skewed_places_like_jax():
    """NODE_MIX's three node types with throughput factors, and
    LARGE_SHAPE requests in the stream: the het and frag terms score."""
    runs = {
        pkg: _sim(pkg).run_sim(24, 800, seed=5, heterogeneous=True, large_frac=0.02,
                               collect_assignments=True, timeout_s=120.0)
        for pkg in PKGS
    }
    for out in runs.values():
        assert out["completed"] and out["num_large"] > 0
    assert runs["ray_tpu_torch"]["assignments"] == runs["ray_tpu"]["assignments"]
    for key in ("large_delivered", "fragmentation_pct_final"):
        assert runs["ray_tpu_torch"][key] == runs["ray_tpu"][key], key


def test_run_sim_weights_pair_places_like_jax():
    """Single-objective and multi-objective weights over the same skewed
    stream (fill-once: no completions, so the stream is deterministic):
    each weight set places every spec as the JAX package does."""
    pairs = {
        pkg: _sim(pkg).run_sim_weights_pair(16, 600, seed=1, hold_rounds=0,
                                            collect_assignments=True, timeout_s=120.0)
        for pkg in PKGS
    }
    for mode in ("single", "multi"):
        got = pairs["ray_tpu_torch"][mode]
        ref = pairs["ray_tpu"][mode]
        assert got["completed"] and ref["completed"]
        assert got["assignments"] == ref["assignments"], mode
    for key in ("weights", "hold_rounds", "frag_pct_single", "frag_pct_multi"):
        assert pairs["ray_tpu_torch"][key] == pairs["ray_tpu"][key], key


def test_run_elasticity_sim_matches_jax():
    """64 synthetic nodes, serve pressure, under-world gangs and parked
    task shapes: every tick is one solve; the solve path and the plan's
    sizes agree with the JAX package's."""
    kw = dict(ticks=3, serve_tenants=4, gangs=3, task_shapes=40, seed=2)
    outs = {pkg: _sim(pkg).run_elasticity_sim(64, **kw) for pkg in PKGS}
    got, ref = outs["ray_tpu_torch"], outs["ray_tpu"]
    assert got["solve_path"] == "solve"
    for key in ("num_nodes", "ticks", "demand_rows", "solve_path", "serve_hints",
                "world_hints"):
        assert got[key] == ref[key], key
    assert got["demand_rows"] > 0 and got["tick_p99_ms"] > 0
