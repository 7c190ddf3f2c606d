"""Mirror of ``tests/test_config.py`` on the port, with ``ray_tpu``
read as ``ray_tpu_torch`` and the scheduler's rounds on the host.

Typed config registry (ray_config_def.h analog).
"""
import subprocess
import sys

import pytest

from ray_tpu_torch.config import cfg, registry


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def test_defaults_and_types():
    assert cfg.sched_tick_s == pytest.approx(0.002)
    assert isinstance(cfg.sched_max_batch, int)
    assert cfg.direct_actor_calls is True
    assert cfg.inline_object_max == 100 * 1024


def test_env_override(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_TICK_S", "0.5")
    assert cfg.sched_tick_s == 0.5
    monkeypatch.setenv("RAY_TPU_DIRECT_ACTOR_CALLS", "0")
    assert cfg.direct_actor_calls is False
    monkeypatch.setenv("RAY_TPU_STORE_BYTES", "0x100000")
    assert cfg.store_bytes == 1 << 20


def test_bad_env_value_falls_back(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_MAX_BATCH", "not-a-number")
    assert cfg.sched_max_batch == registry()["sched_max_batch"].default


def test_unknown_knob_raises():
    with pytest.raises(AttributeError):
        cfg.nonexistent_knob


def test_every_entry_documented():
    for e in registry().values():
        assert e.doc and e.env_var.startswith("RAY_TPU_")


def test_cli_dump():
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "config", "--json"],
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    import json

    rows = json.loads(out.stdout)
    names = {r["name"] for r in rows}
    assert {"sched_tick_s", "direct_actor_calls", "store_bytes"} <= names
