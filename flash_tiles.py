"""Time the bf16 flash kernels' tile choices, and the paged-decode
kernel's split counts and ring, on one GPU.

    python3 flash_tiles.py fwd     # the forward's key-tile rows and K/V ring stages
    python3 flash_tiles.py dkv     # the dK/dV kernel's Q-tile rows and Q/dO ring stages
    python3 flash_tiles.py dq      # the dQ kernel's key-tile rows and K/V ring stages
    python3 flash_tiles.py paged [PARENT]   # paged decode: n_split and stages in flight

Each kernel takes its tiles per head_dim from one struct in its source:
``WgTiles<D>`` (``kBK``, ``kStages``) in
``ray_tpu_torch/csrc/flash_attention_fwd.cu``, ``DkvTiles<D>`` (``kQT``,
``kStages``) and ``DqTiles<D>`` (``kBK``, ``kStages``) in
``flash_attention_bwd.cu``. This script builds the source as committed and
once per alternative below (one ``nvcc`` each, started together, into
``ray_tpu_torch/_build/tiles/``), checks every alternative against the
committed build, and times them in turns at the two training shapes (bf16,
causal): bh=32, T=2048, D=64 and bh=128, T=1024, D=128. It prints the
ptxas register, spill and advisory lines of the kernel's every build.
``paged`` builds ``paged_attention.cu`` as committed and once per
alternative ``PagedRing`` (tokens a stage, stages in the ring: the pages in
flight), and times each build at several split counts beside the one
``paged_attention_decode`` plans, at chip_smoke.py's two paged shapes (the
engine's decode step and B=256, P_max=512), in turns, as device time
(torch.profiler's kernel rows). Given the root of another checkout
(``PARENT``, e.g. the parent commit unpacked by ``git archive``), it also
times that checkout's ``paged_attention_decode`` against this one's, in
turns (parent, this, this, parent), device time and host+device time per
call.

Needs one CUDA card and ``nvcc``; exits 2 without a card.
"""
from __future__ import annotations

import ctypes
import importlib.util
import re
import shutil
import subprocess
import sys

import torch

if not torch.cuda.is_available():
    print("flash_tiles: no CUDA device", file=sys.stderr)
    sys.exit(2)

from ray_tpu_torch import _cuda  # noqa: E402
from ray_tpu_torch.ops import flash_attention as F  # noqa: E402
from ray_tpu_torch.ops import paged_attention as P  # noqa: E402

DEV = torch.device("cuda")
OUT = _cuda.BUILD_DIR / "tiles"
SHAPES = [(32, 2048, 64), (128, 1024, 128)]  # (bh, T, D)
# per kernel: source, kernel name, tile struct and its two fields, the
# counted flops per live (query, key) pair over D (fwd: 2 products of 2 * D;
# dkv: 5; dq: 3), and the alternatives (head_dim, first field, ring stages)
# beside the committed struct
KERNELS = {
    "fwd": dict(source="flash_attention_fwd.cu", kernel="flash_fwd_wgmma_kernel",
                struct="WgTiles", fields=("kBK", "kStages"), flops_per_pair=4,
                alternatives=[(64, 64, 2), (64, 128, 3), (128, 128, 2), (128, 64, 3)]),
    "dkv": dict(source="flash_attention_bwd.cu", kernel="flash_bwd_dkv_wgmma_kernel",
                struct="DkvTiles", fields=("kQT", "kStages"), flops_per_pair=10,
                alternatives=[(64, 32, 2), (64, 64, 2), (128, 32, 2), (128, 64, 3),
                              (128, 32, 3)]),
    "dq": dict(source="flash_attention_bwd.cu", kernel="flash_bwd_dq_wgmma_kernel",
               struct="DqTiles", fields=("kBK", "kStages"), flops_per_pair=6,
               alternatives=[(64, 64, 2), (64, 128, 2), (64, 128, 3), (128, 64, 3),
                             (128, 128, 2), (128, 32, 2)]),
}


def tiles_line(spec, d: int, first: int, stages: int) -> str:
    a, b = spec["fields"]
    return (f"template <> struct {spec['struct']}<{d}> {{ static constexpr int {a} = {first}, "
            f"{b} = {stages}; }};")


def build(spec, name: str, edit=None) -> subprocess.Popen:
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src)
    if edit:
        path = src / spec["source"]
        pattern = rf"template <> struct {spec['struct']}<{edit[0]}> {{[^\n]*}};"
        text = path.read_text()
        assert re.search(pattern, text), f"no {spec['struct']}<{edit[0]}> in {spec['source']}"
        path.write_text(re.sub(pattern, tiles_line(spec, *edit), text))
    cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(src / "lib.so"),
           str(src / spec["source"])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def fwd_inputs(bh, t, d):
    g = torch.Generator(device=DEV).manual_seed(11)
    return tuple(torch.randn(bh, t, d, generator=g, device=DEV).to(torch.bfloat16)
                 for _ in range(3))


def fwd_call(lib, q, k, v):
    fn = lib.ray_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, 1, t), dtype=torch.float32, device=DEV)
    err = fn(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o), _cuda.ptr(lse), bh, t,
             t, d, 1, 1.0 / d**0.5, _cuda.DTYPE_CODES[torch.bfloat16], _cuda.current_stream())
    _cuda.check(err, "flash_tiles fwd")
    return (o,)


def bwd_inputs(bh, t, d):
    g = torch.Generator(device=DEV).manual_seed(12)
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device=DEV).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = F.flash_attention_forward(q, k, v, True)  # the committed forward
    delta = (do.float() * out.float()).sum(-1)[:, None, :]
    return q, k, v, do, lse, delta


def dkv_call(lib, q, k, v, do, lse, delta):
    fn = lib.ray_flash_attention_bwd_dkv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    bh, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = fn(*(_cuda.ptr(x) for x in (q, k, v, do, lse, delta, dk, dv)), bh, t, t, d, 1,
             1.0 / d**0.5, _cuda.DTYPE_CODES[torch.bfloat16], _cuda.current_stream())
    _cuda.check(err, "flash_tiles dkv")
    return dk, dv


def dq_call(lib, q, k, v, do, lse, delta):
    fn = lib.ray_flash_attention_bwd_dq
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    err = fn(*(_cuda.ptr(x) for x in (q, k, v, do, lse, delta, dq)), bh, t, t, d, 1,
             1.0 / d**0.5, _cuda.DTYPE_CODES[torch.bfloat16], _cuda.current_stream())
    _cuda.check(err, "flash_tiles dq")
    return (dq,)


CALLS = {"fwd": (fwd_inputs, fwd_call), "dkv": (bwd_inputs, dkv_call),
         "dq": (bwd_inputs, dq_call)}


def ptxas_report(log: str, kernel: str):
    """ptxas's lines (registers, spills, advisories) for each instance of
    ``kernel``, from an ``nvcc -Xptxas -v`` log."""
    lines, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
            if inside:  # the kernel and its head_dim, from the mangled name
                d = re.search(r"ILi(\d+)EE", line)
                lines.append(f"{kernel}<{d.group(1) if d else '?'}>")
        elif inside and any(w in line for w in ("registers", "spill", "arning", "Loss")):
            lines.append(line.strip())
    return lines


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


PAGED_SOURCE = "paged_attention.cu"
PAGED_RING = re.compile(r"struct PagedRing \{ static constexpr int kStageBytes = (\d+), "
                        r"kStages = (\d+); \};")
# beside the committed (stage bytes, stages)
PAGED_RINGS = [(8192, 3), (8192, 4), (12288, 4), (16384, 2), (16384, 4), (24576, 2)]


def paged_build(name: str, ring=None) -> subprocess.Popen:
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src)
    if ring:
        path = src / PAGED_SOURCE
        text = path.read_text()
        assert PAGED_RING.search(text), f"no PagedRing in {PAGED_SOURCE}"
        path.write_text(PAGED_RING.sub(
            f"struct PagedRing {{ static constexpr int kStageBytes = {ring[0]}, "
            f"kStages = {ring[1]}; }};", text))
    cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(src / "lib.so"),
           str(src / PAGED_SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def paged_call(lib, args, n_split: int, tickets: torch.Tensor):
    """One launch of a build's C entry at a given split count."""
    fn = lib.ray_paged_attention_decode
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    q, kp, vp, tables, lens = args
    b, kh, g, d = q.shape
    page, p_max = kp.shape[2], tables.shape[1]
    out = torch.empty_like(q)
    ws = torch.empty(b * kh * g * n_split * (d + 2), dtype=torch.float32, device=DEV)
    window = min(p_max, P.table_window(p_max * page, page, n_split))
    err = fn(*(x.data_ptr() for x in (q, kp, vp, tables, lens, out, ws, tickets)), b, kh, g, d,
             kp.shape[1], page, p_max, n_split, window, 1.0 / d**0.5,
             _cuda.DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "flash_tiles paged")
    return out


def load_parent_paged(root: str):
    """The ``ops.paged_attention`` module of the checkout at ``root``,
    imported as package ``parent_rtt`` (it builds into that checkout)."""
    pkg = f"{root}/ray_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_rtt", f"{pkg}/__init__.py", submodule_search_locations=[pkg])
    sys.modules["parent_rtt"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["parent_rtt"])
    return importlib.import_module("parent_rtt.ops.paged_attention")


def paged_main(parent) -> None:
    import chip_smoke as cs  # its inputs, shapes and device timing

    committed = PAGED_RING.search((_cuda.CSRC / PAGED_SOURCE).read_text()).groups()
    print("paged committed PagedRing (kStageBytes, kStages):", committed)
    procs = {"committed": paged_build("committed")}
    for ring in PAGED_RINGS:
        name = f"stage{ring[0] // 1024}k_ns{ring[1]}"
        procs[name] = paged_build(name, ring)
    _cuda.build_all()
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            sys.exit(f"nvcc failed on {name}")
        # the flagship's instance: bf16, 16-byte vectors, 8 lanes a token (D = 64)
        for line in ptxas_report(log, "paged_decode_kernelI13__nv_bfloat16Li16ELi8ELi1E"):
            print(f"ptxas {name}: {line}")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    tickets = torch.zeros(1 << 16, dtype=torch.int32, device=DEV)
    lens = torch.randint(1, 512 * 16 + 1, (256,), generator=torch.Generator().manual_seed(5))
    shapes = [  # chip_smoke.phase_paged's two timed shapes, and split counts to try
        ("engine B=8 P_max=128", (8, 4, 2, 64, 256, 16, 128,
                                  [128, 140, 113, 159, 97, 150, 131, 120]), 26,
         [1, 2, 4, 9, 16]),
        ("B=256 P_max=512", (256, 4, 2, 64, 256 * 512 + 1, 16, 512, lens.tolist()), 25,
         [1, 2, 8]),
    ]
    old = load_parent_paged(parent) if parent else None
    for label, shape, seed, splits in shapes:
        args = cs.paged_inputs(*shape, torch.bfloat16, seed)
        planned, _ = cs.paged_plan(args)
        ref = P.paged_attention_reference(*args, page_size=16)
        runs = [(n, planned) for n in libs] + [("committed", k) for k in splits if k != planned]
        for name, k in runs:
            err = cs.max_err(paged_call(libs[name], args, k, tickets), ref)
            if err > 2e-2:
                sys.exit(f"paged {label} {name} n_split {k}: error {err}")
        times = {r: [] for r in runs}
        for order in (runs, runs[::-1]):
            for name, k in order:
                times[(name, k)].append(cs.kernel_device_ms(
                    lambda: paged_call(libs[name], args, k, tickets), "paged_decode"))
        for name, k in runs:
            tag = " (planned)" if k == planned else ""
            print(f"paged {label} {name} n_split {k}{tag}: device "
                  + ", ".join(f"{ms:.4f} ms" for ms in times[(name, k)]))
        if old:
            calls = [("parent", old.paged_attention_decode), ("this", P.paged_attention_decode),
                     ("this", P.paged_attention_decode), ("parent", old.paged_attention_decode)]
            for name, fn in calls:
                err = cs.max_err(fn(*args, page_size=16), ref)
                dev = cs.kernel_device_ms(lambda: fn(*args, page_size=16), "paged_decode")
                host = cs.time_ms(lambda: fn(*args, page_size=16))
                print(f"paged {label} {name}: device {dev:.4f} ms, host+device per call "
                      f"{host:.4f} ms, max_abs_err {err:.3e}")
        del args, ref
        torch.cuda.empty_cache()


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "paged" or sys.argv[1:] == ["paged"]:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
        print(smi.stdout.strip())
        return paged_main(sys.argv[2] if len(sys.argv) == 3 else None)
    if len(sys.argv) != 2 or sys.argv[1] not in KERNELS:
        sys.exit(f"usage: python3 flash_tiles.py {'|'.join(KERNELS)}|paged [PARENT]")
    kind = sys.argv[1]
    spec = KERNELS[kind]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    a, b = spec["fields"]
    committed = re.findall(rf"template <> struct {spec['struct']}<(\d+)> {{ static constexpr "
                           rf"int {a} = (\d+), {b} = (\d+); }};",
                           (_cuda.CSRC / spec["source"]).read_text())
    print(f"{kind} committed (head_dim, {a}, {b}):", committed)
    procs = {"committed": build(spec, "committed")}
    for alt in spec["alternatives"]:
        name = "d{}_{}{}_ns{}".format(alt[0], a[1:].lower(), alt[1], alt[2])
        procs[name] = build(spec, name, alt)
    _cuda.build_all()  # the package's own kernels, for the backward inputs' forward
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            sys.exit(f"nvcc failed on {name}")
        for line in ptxas_report(log, spec["kernel"]):
            print(f"ptxas {name}: {line}")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    inputs, call = CALLS[kind]
    for bh, t, d in SHAPES:
        args = inputs(bh, t, d)
        flops = spec["flops_per_pair"] * d * bh * t * (t + 1) / 2
        names = ["committed"] + [n for n in libs if n.startswith(f"d{d}_")]
        want = call(libs["committed"], *args)
        for name in names[1:]:
            got = call(libs[name], *args)
            err = max((x.float() - w.float()).abs().max().item()
                      / max(1.0, w.float().abs().max().item()) for x, w in zip(got, want))
            if err > 2e-2:
                sys.exit(f"{name}: relative error {err} against the committed build")
        times = {n: [] for n in names}
        for order in (names, names[::-1]):  # in turns, forward then back
            for n in order:
                times[n].append(time_ms(lambda: call(libs[n], *args)))
        for n in names:
            print(f"{kind} bh={bh} T={t} D={d} causal {n}: "
                  + ", ".join(f"{ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s)" for ms in times[n]))


if __name__ == "__main__":
    main()
