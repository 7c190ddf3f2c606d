"""Time the bf16 flash forward kernel's key-tile choices on one GPU.

    python3 flash_fwd_tiles.py

The kernel (``ray_tpu_torch/csrc/flash_attention_fwd.cu``) takes its
key-tile rows and K/V ring stages per head_dim from ``WgTiles<D>``. This
script builds the source as committed and once per alternative below (one
``nvcc`` each, started together, into ``ray_tpu_torch/_build/tiles/``),
checks every alternative against the committed build, and times them in
turns at the two cells' shapes (bf16, causal): the forward cell's (bh=32,
T=2048, D=64) and the train cell's (bh=128, T=1024, D=128). Needs one CUDA
card and ``nvcc``; exits 2 without a card.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

if not torch.cuda.is_available():
    print("flash_fwd_tiles: no CUDA device", file=sys.stderr)
    sys.exit(2)

from ray_tpu_torch import _cuda  # noqa: E402

DEV = torch.device("cuda")
SOURCE = "flash_attention_fwd.cu"
OUT = _cuda.BUILD_DIR / "tiles"
# (head_dim, key-tile rows, ring stages) beside the committed WgTiles
ALTERNATIVES = [(64, 64, 2), (64, 128, 3), (128, 128, 2), (128, 64, 3)]
SHAPES = [(32, 2048, 64), (128, 1024, 128)]  # (bh, T, D)


def tiles_line(d: int, bk: int, stages: int) -> str:
    return (f"template <> struct WgTiles<{d}> {{ static constexpr int kBK = {bk}, "
            f"kStages = {stages}; }};")


def build(name: str, edit=None) -> subprocess.Popen:
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src)
    if edit:
        text = (src / SOURCE).read_text()
        pattern = rf"template <> struct WgTiles<{edit[0]}> {{[^\n]*}};"
        assert re.search(pattern, text), f"no WgTiles<{edit[0]}> in {SOURCE}"
        (src / SOURCE).write_text(re.sub(pattern, tiles_line(*edit), text))
    cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(src / "fwd.so"), str(src / SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def forward(lib, q, k, v):
    fn = lib.ray_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, 1, t), dtype=torch.float32, device=DEV)
    err = fn(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o), _cuda.ptr(lse), bh, t,
             t, d, 1, 1.0 / d**0.5, _cuda.DTYPE_CODES[torch.bfloat16], _cuda.current_stream())
    _cuda.check(err, "flash_fwd_tiles")
    return o


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    committed = re.findall(r"template <> struct WgTiles<(\d+)> { static constexpr int kBK = (\d+), "
                           r"kStages = (\d+); };", (_cuda.CSRC / SOURCE).read_text())
    print("committed (head_dim, key rows, stages):", committed)
    procs = {"committed": build("committed")}
    for alt in ALTERNATIVES:
        procs["d{}_bk{}_ns{}".format(*alt)] = build("d{}_bk{}_ns{}".format(*alt), alt)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            sys.exit(f"nvcc failed on {name}")
        libs[name] = ctypes.CDLL(str(OUT / name / "fwd.so"))
    for bh, t, d in SHAPES:
        g = torch.Generator(device=DEV).manual_seed(11)
        q, k, v = (torch.randn(bh, t, d, generator=g, device=DEV).to(torch.bfloat16)
                   for _ in range(3))
        flops = 4.0 * d * bh * t * (t + 1) / 2
        names = ["committed"] + [n for n in libs if n.startswith(f"d{d}_")]
        want = forward(libs["committed"], q, k, v)
        for name in names[1:]:
            err = (forward(libs[name], q, k, v).float() - want.float()).abs().max().item()
            if err > 3e-2:
                sys.exit(f"{name}: max_abs_err {err} against the committed build")
        times = {n: [] for n in names}
        for order in (names, names[::-1]):  # in turns, forward then back
            for n in order:
                times[n].append(time_ms(lambda: forward(libs[n], q, k, v)))
        for n in names:
            print(f"bh={bh} T={t} D={d} causal {n}: "
                  + ", ".join(f"{ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s)" for ms in times[n]))


if __name__ == "__main__":
    main()
