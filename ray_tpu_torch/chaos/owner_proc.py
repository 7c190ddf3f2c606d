"""Sacrificial owner process for owner-crash chaos.

A real driver in its own process: it connects to the head (establishing
an owner session lease), creates non-detached actors, optionally parks
one never-finishing task (an UNPRODUCED object whose fate the reap
decides), then keeps light task traffic flowing until it is SIGKILLed by
the chaos orchestrator / tests. It writes a JSON info file (client id,
actor ids, pending ref) once everything is ALIVE so the killer knows
exactly what must be reaped.

The point of a separate process is that the kill is REAL: no
DisconnectClient, no atexit — the head must notice purely through missed
owner heartbeats and run the full reap (kill actors, revoke leases,
cancel tasks, fail unproduced objects with OwnerDiedError).

Port of ``ray_tpu/chaos/owner_proc.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _hang(seconds: float) -> bytes:
    time.sleep(seconds)
    return b"hang-done"


def _small(i: int) -> bytes:
    return bytes([i % 251]) * 4096


class _OwnedActor:
    """Plain non-detached actor; dies with its owner."""

    def ping(self) -> str:
        return "pong"


def main() -> None:
    parser = argparse.ArgumentParser(description="sacrificial chaos owner")
    parser.add_argument("--head", required=True)
    parser.add_argument("--info-file", required=True)
    parser.add_argument("--actors", type=int, default=1)
    parser.add_argument(
        "--hang-task",
        action="store_true",
        help="park one max_retries=0 task so an unproduced object exists",
    )
    parser.add_argument("--hang-seconds", type=float, default=600.0)
    args = parser.parse_args()

    import ray_tpu_torch

    rt = ray_tpu_torch.init(address=args.head)
    Actor = ray_tpu_torch.remote(_OwnedActor)
    handles = [Actor.remote() for _ in range(max(0, args.actors))]
    for h in handles:
        # report only once every actor is ALIVE: the killer's invariant
        # ("reaped within one liveness window") starts from real state
        ray_tpu_torch.get(h.ping.remote(), timeout=120)
    hang_ref = None
    if args.hang_task:
        hang_ref = (
            ray_tpu_torch.remote(_hang)
            .options(max_retries=0)
            .remote(args.hang_seconds)
        )
    info = {
        "pid": os.getpid(),
        "client_id": rt.client_id,
        "actor_ids": [h._actor_id for h in handles],
        "hang_ref": hang_ref.hex if hang_ref is not None else None,
    }
    tmp = args.info_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, args.info_file)

    task = ray_tpu_torch.remote(_small)
    i = 0
    while True:  # until SIGKILL
        refs = [task.remote(i + k) for k in range(2)]
        i += 2
        try:
            ray_tpu_torch.get(refs, timeout=30)
        except Exception:  # noqa: BLE001 - traffic is best-effort
            pass
        for h in handles:
            h.ping.remote()
        time.sleep(0.25)


if __name__ == "__main__":
    main()
