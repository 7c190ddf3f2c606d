"""The port's parallel paths over NCCL, one rank per card, against the same
programs on gloo CPU ranks: ring and Ulysses attention at sp=4, the
pipeline at pp=2, expert parallelism at dp=2 x tp=2, ``forward`` on seven
meshes, and two SGD steps of three 4-rank training runs (dense at pp=2 x
tp=2, MoE with ring attention at dp=2 x sp=2, dense with remat at dp=2 x
pp=2), each run's loss and gradients. The CPU tests hold the gloo side
against the JAX package (``tests/test_torch_parallel*.py``); these hold
NCCL to gloo.

Every test needs 4 CUDA cards (NCCL refuses two ranks on one card) and
skips with fewer. The file imports neither jax nor ray_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_parallel.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch import _cuda
from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.models.moe import init_moe
from ray_tpu_torch.parallel import MeshConfig, dryrun, launch, programs

pytestmark = pytest.mark.cuda

OUT_TOL, GRAD_TOL, LOGIT_TOL, LOSS_TOL = 2e-5, 1e-4, 2e-4, 1e-5
MODEL = tfm.ModelConfig(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
                        d_ff=64, max_seq_len=64, dtype=torch.float32)
MOE = dataclasses.replace(MODEL, n_layers=2, n_experts=4)
RUNS = [dryrun.Run(MeshConfig(pp=2, tp=2), dryrun.BASE, 8, 32),
        dryrun.Run(MeshConfig(dp=2, sp=2), dryrun.MOE, 4, 32),
        dryrun.Run(MeshConfig(dp=2, pp=2), dataclasses.replace(dryrun.BASE, remat=True), 8, 32)]


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _model_case(name, mesh, cfg, m=0):
    params = _numpy(tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu"))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    return (name, programs.forward_case,
            dict(mesh_config=MeshConfig(**mesh), cfg=cfg, params=params, tokens=tokens,
                 num_microbatches=m))


def _attention_case(name, kind, causal, h, hkv, seed):
    b, t, d = 2, 32, 16
    return (name, programs.attention_case,
            dict(kind=kind, sp=4, causal=causal, q=_rand(seed, b, t, h, d),
                 k=_rand(seed + 1, b, t, hkv, d), v=_rand(seed + 2, b, t, hkv, d),
                 cot=_rand(seed + 3, b, t, h, d)))


WORLD2 = [("pipeline_pp2", programs.pipeline_case,
           dict(pp=2, w=_rand(60, 4, 8, 8) * 0.5, b=_rand(61, 4, 8) * 0.1,
                x=_rand(62, 4, 2, 8), cot=_rand(63, 4, 2, 8))),
          _model_case("dp2", dict(dp=2), MODEL), _model_case("tp2", dict(tp=2), MODEL),
          _model_case("pp2", dict(pp=2), MODEL, 4)]
WORLD4 = [_attention_case("ring_causal_gqa", "ring", True, 4, 2, 10),
          _attention_case("ring_plain", "ring", False, 4, 4, 20),
          _attention_case("ulysses_causal_lcm", "ulysses", True, 8, 2, 30),
          ("moe_dp2_tp2", programs.moe_case,
           dict(dp=2, tp=2, capacity_factor=0.5, x=_rand(50, 4, 8, 16), cot=_rand(51, 4, 8, 16),
                params={k: v[0].numpy() for k, v in init_moe(
                    4, 16, 32, 1, torch.Generator().manual_seed(5), torch.float32,
                    torch.device("cpu")).items()})),
          _model_case("sp4_ring", dict(sp=4), MODEL),
          _model_case("sp4_ulysses", dict(sp=4), dataclasses.replace(MODEL, sp_attention="ulysses")),
          _model_case("dp2_tp2", dict(dp=2, tp=2), MODEL),
          _model_case("moe_dp2_pp2", dict(dp=2, pp=2), MOE, 4)]


@pytest.fixture(scope="module")
def cards4():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: one NCCL rank per card")
    _cuda.build_all()  # once, before the ranks load the kernels


def _both(fn, world, args):
    """Rank 0's result of ``fn(*args, device)`` over NCCL, then over gloo."""
    return [launch(fn, world, (*args, d), device=d, timeout=600)[0] for d in ("cuda", "cpu")]


@pytest.fixture(scope="module")
def cases(cards4):
    out = {}
    for world, table in ((2, WORLD2), (4, WORLD4)):
        nccl, gloo = _both(programs.run_cases, world, (table,))
        out.update({name: (nccl[name], gloo[name]) for name, _, _ in table})
    return out


@pytest.fixture(scope="module")
def runs(cards4):
    """Both sides start from the same parameters and tokens, drawn on the CPU."""
    drawn = [dryrun.inputs(run, "cpu") for run in RUNS]
    params = [_numpy(p) for p, _ in drawn]
    tokens = [t.numpy() for _, t in drawn]
    nccl, gloo = _both(programs.train_sgd, 4, (RUNS, params, tokens))
    return list(zip(nccl, gloo))


def _close(got, want, tol, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _close(got[k], want[k], tol, f"{what}/{k}")
    else:
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("name", [c[0] for c in WORLD2 + WORLD4])
def test_nccl_matches_gloo(name, cases):
    """Logits within 2e-4; an op's output within 2e-5 and its gradients
    within 1e-4."""
    nccl, gloo = cases[name]
    if isinstance(gloo, np.ndarray):  # a forward case's logits
        np.testing.assert_allclose(nccl, gloo, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        return
    assert nccl.keys() == gloo.keys()
    for key in gloo:
        _close(nccl[key], gloo[key], OUT_TOL if key == "out" else GRAD_TOL, f"{name}/{key}")


@pytest.mark.parametrize("i", range(len(RUNS)), ids=[str(r.mesh) for r in RUNS])
def test_nccl_train_matches_gloo(i, runs):
    """Two SGD steps on seeded parameters drawn on the CPU: both losses
    within 1e-5 and the first step's reduced gradients within 1e-4."""
    nccl, gloo = runs[i]
    np.testing.assert_allclose(nccl["losses"], gloo["losses"], rtol=0, atol=LOSS_TOL)
    assert nccl["losses"][1] < nccl["losses"][0]
    _close(nccl["grads"], gloo["grads"], GRAD_TOL, "grads")


def test_nccl_dryrun_on_four_cards(cards4):
    """The reference's dry run below 8 devices: MeshConfig.auto(4) (dp=2 x
    pp=2), one adamw step over NCCL, its loss equal to one CPU process's."""
    [res] = dryrun.dryrun_multichip(4)
    [run] = dryrun.runs(4)
    params, tokens = dryrun.inputs(run, "cuda")  # as each rank draws them
    with torch.no_grad():
        want = tfm.loss_fn(tfm.params_to(params, torch.device("cpu")), tokens.cpu(),
                           run.model).item()
    np.testing.assert_allclose(res["losses"][0], want, rtol=0, atol=LOSS_TOL)
