"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, loaded with ``ctypes``. Libraries are built at
first use into ``ray_tpu_torch/_build/`` (git-ignored), named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one is reused. All missing sources build at once, one ``nvcc`` each,
started together.

A missing ``nvcc`` or a failed build raises: no kernel wrapper falls back
to its plain version on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("paged_attention.cu", "flash_attention_fwd.cu", "flash_attention_bwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes shared with csrc/*.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from csrc/ at first use and need the CUDA toolkit"
    )


def _library_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Build every source whose library is missing, all nvcc processes at
    once. Returns {source: seconds} for what was built; raises with the
    compiler's output on a failure. The ptxas report (registers, shared
    memory, spills) goes to ``<library>.log``."""
    todo = [s for s in SOURCES if not _library_path(s).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = {}
    for src in todo:
        out = _library_path(src)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    times, errors = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[src] = time.monotonic() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if missing."""
    if source not in SOURCES:
        raise KeyError(f"unknown kernel source {source!r}")
    build_all()
    return ctypes.CDLL(str(_library_path(source)))


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def current_stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
