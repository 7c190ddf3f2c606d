"""Run one function on every rank of a mesh, one process per rank.

The port's counterpart of handing a jitted program to every device of a
``jax.sharding.Mesh``: ``launch(fn, world, args)`` starts ``world``
processes, each joins the default process group (rendezvous through a
``file://`` store in a fresh temporary directory, so no port is fixed and
launches may run side by side), calls ``fn(*args)`` and sends its return
value back. ``fn`` and ``args`` are pickled, so ``fn`` is a module-level
function of an importable module; the port keeps the programs its tests
and ``chip_smoke.py`` launch, so that a rank imports neither a test module
nor JAX.

The default device is CUDA with NCCL, one rank per card (rank r on card
r); it raises without enough cards and never falls back to gloo. Gloo runs
only on ``device="cpu"``, each rank on one intra-op thread.

The ranks are plain ``python`` subprocesses rather than
``multiprocessing`` children: a ``multiprocessing`` spawn also starts a
resource-tracker process that lives as long as the caller. Every rank is
waited for; if one fails, the rest are killed and its traceback raised,
and at ``timeout`` all are killed.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from .mesh import BACKENDS

ROOT = str(Path(__file__).resolve().parents[2])  # the directory holding ray_tpu_torch/


def launch(fn: Callable, world: int, args: Sequence[Any] = (), *,
           device: DeviceLike = None, timeout: float = 600.0) -> List[Any]:
    """``[fn(*args) on rank r for r in range(world)]``, each rank in its own
    process with the default process group set up (NCCL for ``device=None``
    or a CUDA device, gloo for ``"cpu"``)."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise ValueError(f"{world} ranks need {world} CUDA devices, have "
                         f"{torch.cuda.device_count()}")
    backend = BACKENDS[device.type]
    with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_launch_") as tmp:
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
        main = "from ray_tpu_torch.parallel.launch import _rank_main; _rank_main()"
        procs = [subprocess.Popen([sys.executable, "-c", main, tmp, str(r), str(world), backend],
                                  env=env)
                 for r in range(world)]
        try:
            _wait(procs, tmp, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))  # written by this launch's own ranks
        return out


def _wait(procs: List[subprocess.Popen], tmp: str, deadline: float) -> None:
    while True:
        codes = [p.poll() for p in procs]
        for r, code in enumerate(codes):
            if code not in (None, 0):
                err = os.path.join(tmp, f"rank{r}.err")
                detail = open(err).read() if os.path.exists(err) else ""
                raise RuntimeError(f"rank {r} of {len(procs)} exited with {code}\n{detail}")
        if all(code == 0 for code in codes):
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"ranks {[r for r, c in enumerate(codes) if c is None]} "
                               f"still running at the launch's timeout")
        time.sleep(0.05)


def _rank_main() -> None:
    """One rank: ``argv`` is the launch's directory, the rank, the world
    size and the backend."""
    tmp, rank, world, backend = sys.argv[1:]
    rank, world = int(rank), int(world)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kwargs["device_id"] = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store", world_size=world,
                            rank=rank, **kwargs)
    try:
        with open(os.path.join(tmp, "job.pkl"), "rb") as f:
            fn, args = pickle.load(f)  # written by the launching process
        result = fn(*args)
        dist.barrier()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    part = os.path.join(tmp, f"rank{rank}.pkl.part")
    with open(part, "wb") as f:
        pickle.dump(result, f)
    os.replace(part, os.path.join(tmp, f"rank{rank}.pkl"))
