"""The check logic of ``chip_smoke.py``'s soak phases, on synthetic runs.

``phase_failover_soak``, ``phase_mixed_fleet`` and ``phase_rl_soak`` run a
cluster for 30-90 s on the card; each hands what it saw to a verdict
function (``failover_verdicts``, ``mixed_fleet_verdicts``,
``rl_soak_verdicts``) that returns the failures. Here each verdict gets a run
that passes and, one case each, a run with one fault in it, and must name
it. ``chip_smoke`` exits at import without a card, so it is imported with
``torch.cuda.is_available`` stubbed; nothing here touches a card.
"""
import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.syspath_prepend(str(REPO))
        sys.modules.pop("chip_smoke", None)
        module = importlib.import_module("chip_smoke")
    yield module
    sys.modules.pop("chip_smoke", None)


def _result(plan, detail=lambda f: "done", ok=True):
    from ray_tpu_torch.chaos.orchestrator import ChaosRunResult, FaultResult

    return ChaosRunResult(seed=plan.seed, objects_acked=10, faults=[
        FaultResult(spec=f, ok=ok, recovery_s=1.0, detail=detail(f)) for f in plan.faults])


def _head(nbytes, device="cpu"):
    return SimpleNamespace(device_state=SimpleNamespace(device=torch.device(device),
                                                        resident_bytes=lambda: nbytes))


# ---------------------------------------------------------------------------
# failover soak
# ---------------------------------------------------------------------------
def _failover_run():
    from ray_tpu_torch.chaos import FAILOVER_MIX, make_plan

    plan = make_plan(20260805, 8, mix=FAILOVER_MIX,
                     allow=("head_kill_promote", "partition", "object_drop"))
    heads = [_head(0), _head(0), _head(0), _head(1160)]
    return dict(plan=plan, res=_result(plan), heads=heads,
                resident={id(heads[-1].device_state): heads[-1].device_state},
                device="cpu", lost=[])


def test_failover_verdicts_pass_a_clean_soak(smoke):
    run = _failover_run()
    assert run["plan"].counts()["head_kill_promote"] == 3
    assert smoke.failover_verdicts(**run) == []


def _corpse_holds(run):
    run["heads"][1] = _head(1160)


def _two_resident(run):
    run["resident"][id(run["heads"][0])] = run["heads"][0]


def _promotion_skipped(run):
    run["res"] = _result(run["plan"], lambda f: "skipped: no armed warm standby"
                         if f.kind == "head_kill_promote" else "done")
    run["heads"] = run["heads"][:1]
    run["resident"] = {id(run["heads"][0].device_state): run["heads"][0].device_state}


def _schedule_differs(run):
    run["res"].faults.pop()


def _object_lost(run):
    run["lost"] = ["acked object 0a1b2c3d lost: ObjectLostError()"]


def _head_off_device(run):
    run["heads"][2] = _head(0, device="meta")


def _invariant_failed(run):
    run["res"] = _result(run["plan"], ok=False)


@pytest.mark.parametrize("fault, words", [
    (_corpse_holds, "killed leaders still hold"),
    (_two_resident, "scheduler states hold"),
    (_promotion_skipped, "head_kill_promote faults"),
    (_schedule_differs, "schedule differs"),
    (_object_lost, "acked objects lost"),
    (_head_off_device, "not on cpu"),
    (_invariant_failed, "invariants failed"),
])
def test_failover_verdicts_name_each_fault(smoke, fault, words):
    run = _failover_run()
    fault(run)
    failures = smoke.failover_verdicts(**run)
    assert any(words in f for f in failures), failures


# ---------------------------------------------------------------------------
# mixed fleet
# ---------------------------------------------------------------------------
def _timeline(peak_worlds, peak_hints, trough_b=(2, 2, 2, 2)):
    out = [("trough A", 2, 2, 0)] * 6
    out += [("peak", w, h, 9) for w, h in zip(peak_worlds, peak_hints)]
    out += [("trough B", w, 2, 0) for w in trough_b]
    return out


def _mixed_run(**over):
    run = dict(timeline=_timeline((2, 2, 2), (2, 2, 2)), reshapes=[], disk_restores=0,
               errored=0, launches=[1200, 1100])
    run.update(over)
    return run


@pytest.mark.parametrize("run", [
    _mixed_run(),
    _mixed_run(timeline=_timeline((2, 1, 1, 2), (2, 1, 1, 2)),
               reshapes=[("cede", 2, 1), ("grow", 1, 2)]),
], ids=["no pressure, no cede", "a cede the controller ordered, then the grow"])
def test_mixed_fleet_verdicts_pass(smoke, run):
    assert smoke.mixed_fleet_verdicts(**run) == []


@pytest.mark.parametrize("run, words", [
    (_mixed_run(timeline=_timeline((2, 2), (1, 1))), "the gang held 2"),
    (_mixed_run(timeline=_timeline((2, 1), (2, 2))), "no hint below 2"),
    (_mixed_run(timeline=_timeline((2, 2), (2, 2), trough_b=(2, 1, 1, 1, 1))), "trough B"),
    (_mixed_run(timeline=[("trough A", 1, 2, 0)] + _timeline((2,), (2,))[6:]), "trough A"),
    (_mixed_run(reshapes=[("shrink", 2, 1)]), "other than cede and grow"),
    (_mixed_run(disk_restores=1), "disk restores"),
    (_mixed_run(errored=2), "errored requests"),
    (_mixed_run(launches=[1200, 0]), "paged launches"),
], ids=["hint ignored", "cede unordered", "no grow-back", "trough A short", "shrink",
        "disk restore", "errors", "a replica without launches"])
def test_mixed_fleet_verdicts_name_each_fault(smoke, run, words):
    failures = smoke.mixed_fleet_verdicts(**run)
    assert any(words in f for f in failures), failures


# ---------------------------------------------------------------------------
# RL triple soak
# ---------------------------------------------------------------------------
def _rl_run(**over):
    from ray_tpu_torch.chaos import RL_MIX, make_plan

    plan = make_plan(seed=14, num_faults=4, mix=RL_MIX,
                     allow=("rollout_kill", "trainer_rank_kill", "head_kill_mid_publish"),
                     min_delay_s=0.5, max_delay_s=1.5)
    losses = {s: 10.0 - 0.1 * s for s in range(8)}
    run = dict(res=_result(plan), verify_failures=[],
               acct={"emitted": 40, "trained": 40, "unaccounted": 0},
               gang_losses=dict(losses), shadow_losses=dict(losses), epoch=5,
               hist=[{"device": "cpu"}] * 8,
               launches=dict(paged=320, fwd=32, dq=32, dkv=32), device="cpu")
    run.update(over)
    return run


def test_rl_soak_verdicts_pass_a_clean_soak(smoke):
    assert smoke.rl_soak_verdicts(**_rl_run()) == []


def _rl_skipped():
    run = _rl_run()
    from ray_tpu_torch.chaos import RL_MIX, make_plan

    plan = make_plan(seed=14, num_faults=4, mix=RL_MIX,
                     allow=("rollout_kill", "trainer_rank_kill", "head_kill_mid_publish"),
                     min_delay_s=0.5, max_delay_s=1.5)
    run["res"] = _result(plan, lambda f: "skipped: no publish entered the seal window"
                         if f.kind == "head_kill_mid_publish" else "done")
    return run


@pytest.mark.parametrize("make, words", [
    (_rl_skipped, "faults skipped"),
    (lambda: _rl_run(verify_failures=["stream under 'base' returned 3 tokens"]),
     "verify failures"),
    (lambda: _rl_run(acct={"emitted": 40, "trained": 39, "unaccounted": 1}),
     "trajectory accounting"),
    (lambda: _rl_run(shadow_losses={s: 10.0 - 0.1 * s + (0.01 if s == 3 else 0.0)
                                    for s in range(8)}), "off by more than 1e-3"),
    (lambda: _rl_run(shadow_losses={0: 10.0, 1: 9.9}), "2 steps shared"),
    (lambda: _rl_run(epoch=2), "2 epochs published"),
    (lambda: _rl_run(hist=[{"device": "cpu"}, {"device": "meta"}]), "the gang trained on"),
    (lambda: _rl_run(launches=dict(paged=320, fwd=0, dq=0, dkv=0)), "launches"),
], ids=["skipped", "verify", "accounting", "loss gap", "few shared steps", "few epochs",
        "off device", "no flash launches"])
def test_rl_soak_verdicts_name_each_fault(smoke, make, words):
    failures = smoke.rl_soak_verdicts(**make())
    assert any(words in f for f in failures), failures
