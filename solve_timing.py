"""Time the autoscaler solve, ``ray_tpu_torch/scheduler/binpack.py::
solve_pack_counts``, on one GPU at chip_smoke.py's size: 10,000 node rows,
64 shapes, 24 iterations.

    python3 solve_timing.py [OTHER_ROOT ...]

Times this checkout's solve and, given the roots of other checkouts (e.g.
the parent commit unpacked by ``git archive``), theirs, in turns (this,
others, others reversed, this), each in a fresh process on the same
seeded inputs. Each process prints the card's ms per call (one
first-touch call, then five timed), the CPU path's ms for one call,
whether the card equals the CPU bit for bit, and a digest of the
per-node placements, so checkouts whose placements agree show it.

Needs one CUDA card; exits 2 without one.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time

import numpy as np


def inputs():
    """chip_smoke.py's autoscaler inputs: bench.py's node mix (a quarter
    with 4 TPUs, CPU availability uniform(0.5, 1.0) of the total) and 64
    shapes with counts in [1, 400)."""
    from ray_tpu_torch.scheduler.resources import CPU, MEMORY, OBJECT_STORE_MEMORY, TPU

    rng = np.random.default_rng(0)
    n, r = 10_000, 16
    rows = np.zeros((n, r), np.float32)
    rows[:, CPU], rows[:, MEMORY], rows[:, OBJECT_STORE_MEMORY] = 64.0, 256.0, 64.0
    rows[: n // 4, CPU], rows[: n // 4, TPU] = 32.0, 4.0
    rows[:, CPU] *= rng.uniform(0.5, 1.0, n).astype(np.float32)
    shapes = np.zeros((64, r), np.float32)
    shapes[:, CPU] = rng.choice([0.5, 1.0, 2.0, 4.0], 64) + np.arange(64) / 128.0
    shapes[::3, MEMORY] = 8.0
    return rows, shapes, rng.integers(1, 400, 64).astype(np.float32)


def one(root: str) -> None:
    """Time the solve of the checkout at ``root`` (run in its own process)."""
    sys.path.insert(0, root)
    import torch

    from ray_tpu_torch.scheduler import binpack as P

    rows, shapes, cnts = inputs()
    shapes = shapes[P.sort_demands(shapes)]

    def solve(dev):
        return P.solve_pack_counts(rows, shapes, cnts, iters=24, device=dev)

    card = solve("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        card = solve("cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    cpu = solve("cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
    digest = hashlib.sha1(cpu.per_node.numpy().tobytes()).hexdigest()[:12]
    print(f"solve_pack_counts N=10000 U=64 iters=24 [{root}]: card {ms:.2f} ms, "
          f"CPU {cpu_ms:.2f} ms, card == CPU {same}, per_node {digest}", flush=True)
    if not same:
        sys.exit(1)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        return one(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        print("solve_timing: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    roots = [here] + [os.path.abspath(r) for r in sys.argv[1:]]
    for root in roots + roots[::-1]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True,
                       timeout=600)


if __name__ == "__main__":
    main()
