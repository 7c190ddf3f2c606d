"""Chip smoke test of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (PATH or /usr/local/cuda/bin) and this
checkout; imports nothing of JAX or ``ray_tpu``. Phases, each of which
passes or exits non-zero:

1. prints the card's name and power limit, builds the kernels from
   ``ray_tpu_torch/csrc`` and prints the build time and ptxas report;
2. holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at edge cases, and times kernel, plain version
   and (for flash) ``scaled_dot_product_attention``, forward or backward
   (the backward under its flash and cuDNN backends), as a yardstick; the
   flash forward at the forward cell's and the train cell's shapes and
   where its key tiles end inside the keys; the backward kernels at T = S,
   causal S > T (key tiles no query sees), non-causal S > T (a key tile
   that ends inside S), T > S and T = 0, and through ``flash_attention``'s
   autograd (GQA, ragged causal T=100 and T=1023, head_dim 80 and 96
   padded to 128, 160 padded to 256, and 256) against the CPU; head_dim 256
   timed beside SDPA (bh=16, T=1024, causal); the paged kernel at head_dims
   8, 12, 72, 80 and 256, at 8 and 16 query heads per KV head, with one
   slot 40 times longer than the rest (split over blocks; two launches
   bit-equal), and timed at B=256, P_max=512 and at the engine's decode
   shapes, device time (torch.profiler's kernel rows) apart from
   host+device time per wrapper call;
3. runs ``forward`` of ``ModelConfig()`` at B=4, T=2048 (flash launches
   counted from zero), and checks an f32 forward on the card against the
   CPU's plain path;
4. serves 8 greedy requests and one at temperature 0.8 through
   ``ContinuousBatchingEngine(ModelConfig())`` at its defaults (paged
   launches counted from zero), prints decode tokens/s, and checks that an
   f32 engine on the card (kernel) gives the same greedy tokens as the
   same engine on the CPU (plain version);
5. trains bench.py's 700M configuration (d_model 2048, 12 layers, remat,
   bf16) at B=8, T=1024 with ``torch.optim.Adam(lr=3e-4)`` for a few steps
   of ``make_train_step`` on one batch (flash launches counted from zero):
   the loss must be finite and fall; then checks an f32 ``ModelConfig()``
   loss and every gradient on the card against the CPU's plain path;
6. runs the scheduler slice on the card against the port's CPU path, every
   output bit-identical: bench.py's kernel tier (1,024 nodes, 100,000
   requests) through ``hybrid_schedule_shapes``, with capacity recomputed on
   the host; the head's round at 10,000 nodes and a 200,000-request backlog
   through ``DeviceSchedulerState`` and ``SchedulerPipeline`` (rounds of
   4,096 at depth 3), with the default weights and the multi-objective ones,
   placement divergence 0; then the fidelity, chunked, ring, slot, bundle
   and autoscaler programs; prints ms per call, placements/s, round-latency
   p50/p99, upload/kernel/readback ms, device ops and busy share;
7. runs the local runtime (``ray_tpu_torch.init`` → ``remote`` → a
   placement round of ``DeviceSchedulerState`` on the card → worker →
   ``get``): bench.py's many-tasks burst (256 nodes of 4 CPUs, 10,000 no-op
   tasks at 0.25 CPU, two passes) prints tasks/s, scheduling rounds, parks,
   unparks and ms per ``schedule`` call (p50/p99); then, with every round's
   inputs recorded, a functional workload whose every value is checked (a
   100-deep ObjectRef chain, multiple returns, nested tasks, 1,000 ordered
   actor calls, a named actor and ``kill``, PACK and STRICT_SPREAD groups
   with tasks in them, a 64 MiB array through the native store as a
   read-only view, ``wait`` and ``cancel``, ``kill_node`` and lineage
   rebuild, a streaming generator, and work held past every slot that
   parks and unparks on ``shape_slots``); each recorded round is replayed
   on the CPU and must give the same node rows; the burst then runs again
   on the port's CPU path. Any ERROR record of the ``ray_tpu_torch``
   loggers ("scheduler round failed") fails the phase;
8. prints the kernel table as one JSON line, then the result line.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; the port's smoke test needs one GPU",
          file=sys.stderr)
    sys.exit(2)

from ray_tpu_torch import _cuda  # noqa: E402
from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine  # noqa: E402
from ray_tpu_torch.llm.engine import GenerationConfig  # noqa: E402
from ray_tpu_torch.models import transformer as tfm  # noqa: E402
from ray_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference,
    flash_attention_forward,
    flash_attention_reference,
)
from ray_tpu_torch.ops.layers import attention_reference  # noqa: E402
from ray_tpu_torch.ops import paged_attention as paged_ops  # noqa: E402
from ray_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_attention_decode,
    paged_attention_reference,
)

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per dtype


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events: the larger of the host's and the device's pace,
    so for a short kernel behind a Python wrapper it is host+device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_ATTEMPTS = 3


def warm_profiler() -> None:
    """One throwaway torch.profiler session over a few small kernels. The
    first session of a process can come back with no device rows while
    CUPTI attaches, so none of the measured sessions is the first."""
    x = torch.ones(1 << 20, device=DEV)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(8):
            x = x * 1.0001
        torch.cuda.synchronize()
    rows = sum(1 for e in prof.key_averages() if e.self_device_time_total > 0)
    print(f"profiler warm-up: {rows} kernel rows with device time")


def kernel_device_ms(fn, marker: str, iters: int = 20) -> float:
    """Device time per call of the kernels whose name holds ``marker``, as
    torch.profiler's kernel rows give it over ``iters`` calls of ``fn``: the
    kernels' own duration on the card, with no host time and no gap between
    launches. A trace with no such row is taken again, up to
    ``PROFILE_ATTEMPTS`` sessions in all; fails if none shows the kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if marker in e.key and str(e.device_type).endswith("CUDA"))
        if us > 0:
            return us / iters / 1e3
        print(f"profiler: session {attempt} of {PROFILE_ATTEMPTS} shows no device time "
              f"for *{marker}*", file=sys.stderr)
    fail(f"no device time for kernels named *{marker}* in {PROFILE_ATTEMPTS} traces")


def bound_ms(n_bytes: float, flops: float, dtype: torch.dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEV).manual_seed(seed)


# ---------------------------------------------------------------------------
# 1. card, build
# ---------------------------------------------------------------------------
def phase_card_and_build() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.monotonic()
    built = _cuda.build_all()
    print(f"build: {time.monotonic() - t0:.1f} s for {sorted(built) or 'nothing (cached)'}")
    for src in _cuda.SOURCES:
        log = _cuda._library_path(src).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            entry = re.search(r"entry function '_Z\w*?\d+((?:flash|paged)_\w*?_kernel)I(\w*?)EEv",
                              line)
            if entry:  # the kernel and its template arguments, from the mangled name
                args = re.sub(r"L[ij](\d+)E", r"\1,", entry.group(2))
                args = re.sub(r"^f", "float,", args).replace("13__nv_bfloat16", "bf16,")
                print(f"  ptxas {src}: {entry.group(1)}<{args.rstrip(',')}>")
            elif any(w in line for w in ("registers", "spill", "arning", "Performance Loss")):
                print(f"  ptxas {src}: {line.strip()}")
    warm_profiler()


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------
def flash_case(name, b, t, h, hkv, d, causal, dtype, atol, seed, expect_launch=True):
    g = gen(seed)
    q = torch.randn(b, t, h, d, generator=g, device=DEV).to(dtype)
    k = torch.randn(b, t, hkv, d, generator=g, device=DEV).to(dtype)
    v = torch.randn(b, t, hkv, d, generator=g, device=DEV).to(dtype)
    before = flash_attention_forward.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    launched = flash_attention_forward.launches - before
    ref = attention_reference(q.float(), k.float(), v.float(), causal=causal)
    err = max_err(out, ref)
    print(f"flash {name}: max_abs_err {err:.3e} (atol {atol}) launches {launched}")
    check(err <= atol and math.isfinite(err), f"flash {name} error {err} > {atol}")
    check(launched == (1 if expect_launch else 0), f"flash {name}: {launched} launches")


def phase_flash():
    """Edge cases through the wrapper against attention_reference in f32,
    then the kernel against its plain version at the forward's shapes."""
    flash_case("f32 causal", 2, 256, 4, 4, 64, True, torch.float32, 1e-4, 1)
    flash_case("f32 non-causal", 2, 256, 4, 4, 64, False, torch.float32, 1e-4, 2)
    flash_case("f32 GQA hd32", 1, 128, 8, 2, 32, True, torch.float32, 1e-4, 3)
    flash_case("f32 ragged causal T=100", 1, 100, 4, 2, 64, True, torch.float32, 1e-4, 4)
    flash_case("f32 ragged non-causal T=100 (plain branch)", 1, 100, 4, 2, 64, False,
               torch.float32, 1e-4, 5, expect_launch=False)
    # bf16 against the f32 reference of the same bf16 inputs: bf16 rounding
    # of q*scale, P and O bounds the error (O is an average of N(0,1) values)
    flash_case("bf16 GQA causal", 2, 512, 8, 4, 64, True, torch.bfloat16, 3e-2, 6)
    flash_case("bf16 ragged causal T=2000", 1, 2000, 8, 4, 64, True, torch.bfloat16, 3e-2, 7)
    flash_case("bf16 entry() shape hd32", 4, 128, 8, 4, 32, True, torch.bfloat16, 3e-2, 8)
    # head_dims between the kernels' widths: zero-padded to 128, sliced back
    flash_case("f32 GQA hd80", 2, 256, 8, 4, 80, True, torch.float32, 1e-4, 9)
    flash_case("bf16 GQA hd96 ragged causal T=200", 1, 200, 8, 2, 96, True, torch.bfloat16,
               3e-2, 10)
    # head_dim 256 (the FMA kernels in both dtypes), and 160 padded to 256
    flash_case("f32 GQA hd256", 1, 256, 4, 2, 256, True, torch.float32, 1e-4, 12)
    flash_case("bf16 hd256 non-causal", 1, 192, 4, 4, 256, False, torch.bfloat16, 3e-2, 13)
    flash_case("f32 GQA hd160 ragged causal T=100", 1, 100, 4, 2, 160, True, torch.float32,
               1e-4, 14)
    flash_case("bf16 GQA hd160", 1, 256, 4, 2, 160, True, torch.bfloat16, 3e-2, 15)

    # the bf16 kernel against its plain version where its 128-key tile ends
    # inside the keys (T = 192; S = 320, no causal offset when T != S) and
    # at the head_dims whose tiles are laid out differently (32: 64-byte
    # swizzle; 128: two 64-column boxes, 64-key tiles)
    for name, bh, t, s, d, causal in (
        ("T=192 causal", 4, 192, 192, 64, True),
        ("T=192 non-causal", 4, 192, 192, 64, False),
        ("T=128 S=320 non-causal", 4, 128, 320, 64, False),
        ("T=128 S=320 causal", 4, 128, 320, 64, True),
        ("hd32 T=192 non-causal", 4, 192, 192, 32, False),
        ("hd32 T=128 S=320 causal", 4, 128, 320, 32, True),
        ("hd128 T=192 causal", 4, 192, 192, 128, True),
        ("hd128 T=128 S=320 non-causal", 4, 128, 320, 128, False),
        ("hd256 T=128 S=320 causal", 4, 128, 320, 256, True),
    ):
        g = gen(t + s + d + int(causal))
        qg = torch.randn(bh, t, d, generator=g, device=DEV).to(torch.bfloat16)
        kg, vg = (torch.randn(bh, s, d, generator=g, device=DEV).to(torch.bfloat16)
                  for _ in range(2))
        out, lse = flash_attention_forward(qg, kg, vg, causal)
        ref_out, ref_lse = flash_attention_reference(qg, kg, vg, causal)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        print(f"flash kernel bf16 {name} bh={bh}: out err {e_out:.3e} (atol 3e-2) "
              f"lse err {e_lse:.3e} (atol 1e-3)")
        check(e_out <= 3e-2 and e_lse <= 1e-3, f"flash kernel bf16 {name}: {e_out}, {e_lse}")

    # the forward cell's shapes (B=4, T=2048, 8 heads over 4 KV heads, hd 64,
    # causal and not), then the train cell's (bench.py's config, B=8 x 16
    # heads, T=1024, hd 128, causal)
    rows = {}
    for key, bh, t, hd, causal in (("fwd", 32, 2048, 64, True),
                                   ("fwd non-causal", 32, 2048, 64, False),
                                   ("train", 128, 1024, 128, True),
                                   ("hd256", 16, 1024, 256, True)):
        g = gen(11)
        qg, kg, vg = (torch.randn(bh, t, hd, generator=g, device=DEV).to(torch.bfloat16)
                      for _ in range(3))
        out, lse = flash_attention_forward(qg, kg, vg, causal)
        ref_out, ref_lse = flash_attention_reference(qg, kg, vg, causal)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        del ref_out, ref_lse
        ms = time_ms(lambda: flash_attention_forward(qg, kg, vg, causal))
        plain = time_ms(lambda: flash_attention_reference(qg, kg, vg, causal), iters=5)
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qg[None], kg[None], vg[None], is_causal=causal))
        pairs = bh * (t * (t + 1) // 2 if causal else t * t)
        flops = 4.0 * hd * pairs
        bnd, by = bound_ms(nbytes(qg, kg, vg, out, lse), flops, torch.bfloat16)
        print(f"flash bf16 bh={bh} T={t} D={hd} causal={causal}: out err {e_out:.3e} "
              f"lse err {e_lse:.3e}; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain {plain:.4f} ms, sdpa {sdpa:.4f} ms, bound {bnd:.4f} ms ({by})")
        check(e_out <= 3e-2 and e_lse <= 1e-3, f"flash forward shapes: {e_out}, {e_lse}")
        rows[key] = dict(max_abs_err=e_out, ms=ms, plain_ms=plain, bound_ms=bnd,
                         bound_by=by, library_ms=sdpa)
        del qg, kg, vg, out, lse
    torch.cuda.empty_cache()
    # the forward cell is causal; the train cell's shape rides beside it
    return dict(rows["fwd"], train_shape=dict(shape="bh=128 T=1024 D=128 bf16 causal",
                                               **rows["train"]))


def bwd_launches():
    return flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max abs error over the larger of 1 and the reference's max |b|."""
    return max_err(a, b) / max(1.0, b.float().abs().max().item())


# backward tolerances, relative to max(1, max |reference|): f32 sums in
# another order; bf16 rounds dS and the outputs to bf16 at the plain
# version's points, so a last-bit f32 difference can flip a rounding (a
# few bf16 ulps of the largest entry)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def grouped_bwd_inputs(bh, t, d, causal, dtype, seed, s=None):
    g = gen(seed)
    qg, kg, vg, do = (torch.randn(bh, n, d, generator=g, device=DEV).to(dtype)
                      for n in (t, s or t, s or t, t))
    out, lse = flash_attention_forward(qg, kg, vg, causal)
    delta = (do.float() * out.float()).sum(-1)[:, None, :]
    return qg, kg, vg, do, lse, delta


def wrapper_bwd_case(name, b, t, h, hkv, d, causal, dtype, seed):
    """Grads of flash_attention through autograd: the card (kernels)
    against the same wrapper on the CPU (plain versions)."""
    g = gen(seed)
    q = torch.randn(b, t, h, d, generator=g, device=DEV).to(dtype)
    k = torch.randn(b, t, hkv, d, generator=g, device=DEV).to(dtype)
    v = torch.randn(b, t, hkv, d, generator=g, device=DEV).to(dtype)
    do = torch.randn(b, t, h, d, generator=g, device=DEV).to(dtype)
    grads = []
    before = bwd_launches()
    for dev in (DEV, "cpu"):
        xs = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        flash_attention(*xs, causal=causal).backward(do.to(dev))
        grads.append([x.grad.cpu() for x in xs])
    launched = tuple(a - b for a, b in zip(bwd_launches(), before))
    errs = [rel_err(a, b) for a, b in zip(*grads)]
    tol = BWD_TOL[dtype]
    print(f"flash bwd {name}: dq/dk/dv rel err {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} "
          f"(tol {tol}, card vs CPU wrapper) launches dq/dkv {launched}")
    check(all(e <= tol for e in errs), f"flash bwd {name}: {errs} > {tol}")
    check(launched == (1, 1), f"flash bwd {name}: launches {launched}")


def sdpa_backward_ms(qg, kg, vg, do):
    """The yardstick: SDPA's backward on the grouped layout (dq, dk and dv in
    one call, from a saved output), causal, timed under each backend that
    takes these inputs, the forward built inside the same context. Returns
    {backend: ms}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = (x[None].detach().requires_grad_() for x in (qg, kg, vg))
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel(backend):
                out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                                        is_causal=True)
                times[backend.name.lower()] = time_ms(lambda: torch.autograd.grad(
                    out4, (q4, k4, v4), do[None], retain_graph=True))
        except RuntimeError as e:  # the backend does not take these inputs here
            print(f"sdpa {backend.name}: not available ({str(e).splitlines()[0][:120]})")
    return times


def bwd_timing(bh, t, d, seed):
    """dQ and dK/dV kernels at one causal bf16 shape: error against the
    plain versions, kernel, plain and SDPA-backward ms, and each bound."""
    dtype = torch.bfloat16
    args = grouped_bwd_inputs(bh, t, d, True, dtype, seed)
    qg, kg, vg, do, lse, delta = args
    dq = flash_attention_bwd_dq(*args, True)
    dk, dv = flash_attention_bwd_dkv(*args, True)
    want = flash_attention_backward_reference(*args, True)
    errs = [rel_err(a, b) for a, b in zip((dq, dk, dv), want)]
    check(max(errs) <= BWD_TOL[dtype], f"flash bwd bh={bh} T={t} D={d}: rel err {errs}")
    e_dq = max_err(dq, want[0])
    e_dkv = max(max_err(dk, want[1]), max_err(dv, want[2]))
    sdpa_by = sdpa_backward_ms(qg, kg, vg, do)
    backend = min(sdpa_by, key=sdpa_by.get) if sdpa_by else None
    sdpa = sdpa_by[backend] if backend else None
    print(f"sdpa backward bh={bh} T={t} D={d} causal: "
          + (", ".join(f"{b} {ms:.4f} ms" for b, ms in sdpa_by.items()) or "no backend"))
    pairs = bh * t * (t + 1) // 2
    ins = nbytes(qg, kg, vg, do, lse, delta)
    rows = {}
    for name, fn, plain_fn, outs, products, err in (
        ("dq", flash_attention_bwd_dq, flash_attention_bwd_dq_reference, (dq,), 3, e_dq),
        ("dkv", flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference, (dk, dv), 4,
         e_dkv),
    ):
        ms = time_ms(lambda: fn(*args, True))
        plain = time_ms(lambda: plain_fn(*args, True), iters=3, warmup=1)
        bnd, by = bound_ms(ins + nbytes(*outs), products * 2.0 * d * pairs, dtype)
        print(f"flash bwd {name} bf16 bh={bh} T={t} D={d} causal: max_abs_err {err:.3e}; "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa backward (dq+dk+dv, "
              f"{backend}) {sdpa if sdpa is None else f'{sdpa:.4f}'} ms, bound {bnd:.4f} ms "
              f"({by}), {products * 2.0 * d * pairs / ms / 1e9:.1f} TFLOP/s")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                          library_ms=sdpa, library=f"sdpa backward ({backend})")
    return rows


def bwd_kernel_case(bh, t, s, d, causal, dtype, seed):
    """Both backward kernels against their plain versions, one launch each."""
    args = grouped_bwd_inputs(bh, t, d, causal, dtype, seed, s)
    before = bwd_launches()
    got = flash_attention_backward(*args, causal)
    launched = tuple(a - b for a, b in zip(bwd_launches(), before))
    want = flash_attention_backward_reference(*args, causal)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    tag = f"{'f32' if dtype == torch.float32 else 'bf16'} causal={causal} hd{d}"
    print(f"flash bwd kernels {tag} bh={bh} T={t} S={s}: dq/dk/dv rel err "
          f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} (tol {BWD_TOL[dtype]}) "
          f"launches dq/dkv {launched}")
    check(all(e <= BWD_TOL[dtype] for e in errs), f"flash bwd {tag} T={t} S={s}: {errs}")
    check(launched == (1, 1), f"flash bwd {tag}: launches {launched}")


def bwd_without_queries(dtype):
    """T = 0 against S = 128 keys: dK and dV are zeros. The outputs' memory
    is taken from a freed block of ones, so zeros must be written."""
    bh, s, d = 4, 128, 64
    torch.ones(2, bh, s, d, dtype=dtype, device=DEV)  # freed at once, then reused
    qg, do = (torch.zeros(bh, 0, d, dtype=dtype, device=DEV) for _ in range(2))
    kg, vg = (torch.randn(bh, s, d, generator=gen(37), device=DEV).to(dtype)
              for _ in range(2))
    row = torch.zeros(bh, 1, 0, device=DEV)
    before = flash_attention_bwd_dkv.launches
    dk, dv = flash_attention_bwd_dkv(qg, kg, vg, do, row, row, True)
    torch.cuda.synchronize()
    nonzero = int(torch.count_nonzero(dk)) + int(torch.count_nonzero(dv))
    tag = "f32" if dtype == torch.float32 else "bf16"
    print(f"flash bwd dkv {tag} T=0 S={s}: nonzero entries {nonzero}, "
          f"launches {flash_attention_bwd_dkv.launches - before}")
    check(nonzero == 0 and tuple(dk.shape) == (bh, s, d), f"flash bwd dkv {tag} T=0")


def phase_flash_backward():
    """The dQ and dK/dV kernels against their plain versions on the grouped
    layout (T = S; causal S > T, whose later key tiles no query sees; T > S
    non-causal; T = 0), through flash_attention's autograd against the CPU,
    then timed at the two training shapes."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in (32, 64, 128):
            for causal in (True, False):
                bwd_kernel_case(8, 256, 256, d, causal, dtype, d + int(causal))
            bwd_kernel_case(4, 128, 320, d, True, dtype, d + 2)
            # every query walks S = 320: dQ's last 128-key tile ends inside S
            bwd_kernel_case(4, 128, 320, d, False, dtype, d + 4)
            bwd_kernel_case(4, 320, 128, d, False, dtype, d + 3)
        # head_dim 256: the FMA kernels, with 32-row walked tiles
        bwd_kernel_case(4, 256, 256, 256, True, dtype, 256)
        bwd_kernel_case(4, 128, 320, 256, False, dtype, 257)
        bwd_without_queries(dtype)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        wrapper_bwd_case(f"{tag} GQA 8->2 hd64", 2, 256, 8, 2, 64, True, dtype, 31)
        wrapper_bwd_case(f"{tag} GQA 8->4 hd32 non-causal", 1, 128, 8, 4, 32, False, dtype, 32)
        wrapper_bwd_case(f"{tag} ragged causal T=100", 1, 100, 4, 2, 64, True, dtype, 33)
        wrapper_bwd_case(f"{tag} ragged causal T=1023 hd128", 1, 1023, 2, 2, 128, True,
                         dtype, 34)
        # head_dims between the kernels' widths, padded to 128
        wrapper_bwd_case(f"{tag} GQA 8->2 hd80", 2, 256, 8, 2, 80, True, dtype, 38)
        wrapper_bwd_case(f"{tag} ragged causal T=100 hd96", 1, 100, 4, 2, 96, True, dtype, 39)
        # head_dim 160 padded to 256, and 256 itself
        wrapper_bwd_case(f"{tag} GQA 4->2 hd160", 1, 256, 4, 2, 160, True, dtype, 40)
        wrapper_bwd_case(f"{tag} ragged causal T=100 hd256", 1, 100, 2, 2, 256, True, dtype, 41)
    train = bwd_timing(128, 1024, 128, 35)  # bench.py's train config, B=8 x 16 heads
    bwd_timing(32, 2048, 64, 36)            # ModelConfig() at B=4, T=2048
    bwd_timing(16, 1024, 256, 42)           # head_dim 256: the FMA kernels
    return train


def paged_inputs(b, kh, g, d, n_pages, page, p_max, lengths, dtype, seed, share=False):
    gn = gen(seed)
    q = torch.randn(b, kh, g, d, generator=gn, device=DEV).to(dtype)
    kp = torch.randn(kh, n_pages, page, d, generator=gn, device=DEV).to(dtype)
    vp = torch.randn(kh, n_pages, page, d, generator=gn, device=DEV).to(dtype)
    if b * p_max < n_pages:  # distinct pages per slot, as the engine allocates them
        perm = torch.randperm(n_pages - 1, generator=gn, device=DEV)[: b * p_max] + 1
        tables = perm.reshape(b, p_max).to(torch.int32)
    else:  # tests/test_paged_attention.py draws pages with replacement
        tables = torch.randint(0, n_pages, (b, p_max), generator=gn, device=DEV,
                               dtype=torch.int32)
    if share:
        tables[1] = tables[0]
        q[1] = q[0]
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    return q, kp, vp, tables, lens


def paged_case(name, args, page, atol):
    before = paged_attention_decode.launches
    out = paged_attention_decode(*args, page_size=page)
    ref = paged_attention_reference(*args, page_size=page)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    print(f"paged {name}: max_abs_err {err:.3e} (atol {atol}) "
          f"launches {paged_attention_decode.launches - before}")
    check(err <= atol and math.isfinite(err), f"paged {name} error {err} > {atol}")
    return out


def paged_plan(args):
    """(n_split, table window) that paged_attention_decode takes for args."""
    q, kp, _, tables, _ = args
    b, kh, g, d = q.shape
    return paged_ops.plan(b, kh, g, d, tables.shape[1], kp.shape[2],
                          _cuda.DTYPE_CODES[q.dtype], paged_ops._sm_count(q.device.index))


def paged_timing(name, args, page, dtype):
    q, kp, vp, tables, lens = args
    kh, d = q.shape[1], q.shape[3]
    host_ms = time_ms(lambda: paged_attention_decode(*args, page_size=page))
    ms = kernel_device_ms(lambda: paged_attention_decode(*args, page_size=page), "paged_decode")
    plain = time_ms(lambda: paged_attention_reference(*args, page_size=page), iters=5)
    total_len = lens.long().clamp(max=tables.shape[1] * page).sum().item()
    kv_bytes = 2 * total_len * kh * d * kp.element_size()
    n_bytes = kv_bytes + 2 * nbytes(q) + nbytes(lens) + 4 * total_len // page
    flops = 4.0 * q.shape[2] * d * kh * total_len
    bnd, by = bound_ms(n_bytes, flops, dtype)
    print(f"paged {name} (n_split {paged_plan(args)[0]}): kernel device {ms:.4f} ms ({n_bytes / ms / 1e6:.1f} GB/s), "
          f"host+device per call {host_ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms "
          f"({by})")
    return dict(ms=ms, host_ms=host_ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None)


def phase_paged():
    f32, bf16 = torch.float32, torch.bfloat16
    # tests/test_paged_attention.py's cases, f32 and bf16 (bf16: P and
    # q*scale are rounded in the kernel, not in the plain f32 gather)
    for dtype, atol in ((f32, 2e-5), (bf16, 2e-2)):
        tag = "f32" if dtype == f32 else "bf16"
        paged_case(f"{tag} ragged", paged_inputs(4, 2, 2, 32, 16, 8, 4, [5, 17, 32, 1],
                                                 dtype, 21), 8, atol)
        paged_case(f"{tag} single/full pages",
                   paged_inputs(4, 2, 2, 64, 16, 8, 4, [1, 8, 16, 32], dtype, 22), 8, atol)
        out = paged_case(f"{tag} shared pages",
                         paged_inputs(4, 2, 2, 64, 16, 8, 4, [24, 24, 9, 3], dtype, 23,
                                      share=True), 8, atol)
        check(max_err(out[0], out[1]) == 0.0, f"paged {tag}: shared pages differ")
        paged_case(f"{tag} hd128 G4", paged_inputs(3, 2, 4, 128, 64, 16, 4, [50, 64, 1],
                                                   dtype, 24), 16, atol)
        # head_dims of every vector width (8, 12 and 72 mask lanes; 256 is
        # the widest), G = 8 at 256, and G * D = 16 * 128 over chunks
        for d, g, seed in ((80, 2, 27), (8, 2, 29), (12, 2, 30), (72, 2, 31), (256, 2, 32),
                           (256, 8, 33), (128, 16, 28)):
            paged_case(f"{tag} hd{d} G{g}", paged_inputs(3, 2, g, d, 64, 16, 4, [50, 64, 1],
                                                         dtype, seed), 16, atol)
        # one slot 40x longer than the others: its splits are all full, the
        # short slots' later ones empty; two launches give equal bits
        long_args = paged_inputs(4, 4, 2, 64, 4 * 126 + 1, 16, 126, [50, 2000, 49, 1], dtype,
                                 34)
        n_split, _ = paged_plan(long_args)
        out = paged_case(f"{tag} one slot 40x longer (n_split {n_split})", long_args, 16, atol)
        again = paged_attention_decode(*long_args, page_size=16)
        check(n_split > 1, f"paged {tag} long slot: n_split {n_split}")
        check(torch.equal(out, again), f"paged {tag}: two launches differ")
    # the large configuration: 256 slots x 512 pages of 16 (8192 positions)
    lens = torch.randint(1, 512 * 16 + 1, (256,), generator=torch.Generator().manual_seed(5))
    big = paged_inputs(256, 4, 2, 64, 256 * 512 + 1, 16, 512, lens.tolist(), bf16, 25)
    paged_case("bf16 B=256 P_max=512", big, 16, 2e-2)
    big_row = paged_timing("bf16 B=256 P_max=512", big, 16, bf16)
    del big
    # the engine's decode step: B=8, 4 KV heads x 2, hd 64, 256 pages of 16,
    # P_max 128, at the lengths of the serving phase's mid-point
    main = paged_inputs(8, 4, 2, 64, 256, 16, 128, [128, 140, 113, 159, 97, 150, 131, 120],
                        bf16, 26)
    out = paged_attention_decode(*main, page_size=16)
    err = max_err(out, paged_attention_reference(*main, page_size=16))
    check(err <= 2e-2, f"paged engine shapes error {err}")
    row = paged_timing("bf16 engine shapes B=8 P_max=128", main, 16, bf16)
    row["max_abs_err"] = err
    row["big_shape"] = dict(shape="B=256 P_max=512 page 16 KH=4 G=2 D=64 bf16", **big_row)
    return row


# ---------------------------------------------------------------------------
# 3. model forward
# ---------------------------------------------------------------------------
def phase_forward() -> int:
    cfg = tfm.ModelConfig()
    params = tfm.init_params(cfg, gen(0), DEV)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen(1), device=DEV)
    flash_attention_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = tfm.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flash_attention_forward.launches
    check(tuple(logits.shape) == (4, 2048, cfg.vocab_size), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(launches > 0, "forward did not launch the flash kernel")
    ms = time_ms(lambda: tfm.forward(params, tokens, cfg), iters=5, warmup=1)
    print(f"forward ModelConfig() B=4 T=2048 bf16: first {dt * 1e3:.1f} ms, steady {ms:.2f} ms, "
          f"flash launches {launches}")
    device_profile("forward ModelConfig() B=4 T=2048", lambda: tfm.forward(params, tokens, cfg), 3)
    del logits, params

    # f32 on the card (flash kernel) against the CPU's plain path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = tfm.ModelConfig(dtype=torch.float32)
    p_cpu = tfm.init_params(cfg32, torch.Generator().manual_seed(2), "cpu")
    p_gpu = tfm.params_to(p_cpu, DEV)
    tok = torch.randint(0, cfg32.vocab_size, (1, 256), generator=torch.Generator().manual_seed(3))
    want = tfm.forward(p_cpu, tok, cfg32)
    got = tfm.forward(p_gpu, tok.to(DEV), cfg32).cpu()
    err = max_err(got, want)
    print(f"forward f32 B=1 T=256 card vs CPU plain path: max_abs_err {err:.3e} (atol 1e-3)")
    check(err <= 1e-3, f"f32 forward card vs CPU error {err}")
    return launches


# ---------------------------------------------------------------------------
# 4. serving
# ---------------------------------------------------------------------------
def prompts(cfg, n=8, length=96, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=length).tolist() for _ in range(n)]


def kernel_kind(key: str) -> str:
    k = key.lower()
    for kind, marks in (("flash", ("flash_",)), ("paged", ("paged_",)),
                        ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
                        ("optimizer", ("multi_tensor",))):
        if any(m in k for m in marks):
            return kind
    return "other"


def device_profile(label: str, fn, steps: int) -> None:
    """Where ``fn``'s time goes: torch.profiler over ``steps`` calls; the
    device busy share is the summed kernel time over the wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel rows only: an operator's row repeats its kernels' device time,
    # and a user annotation (the optimizer's step) spans them
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    if not rows:
        print(f"{label} profile: no device time in the trace (not measured)")
        return
    busy_us = sum(r[0] for r in rows)
    print(f"{label} profile over {steps} calls: wall {wall_us / steps:.1f} us/call, "
          f"device busy {busy_us / steps:.1f} us/call ({100 * busy_us / wall_us:.1f}%), "
          f"{sum(r[1] for r in rows) // steps} device ops/call")
    kinds = {}
    for us, _, key in rows:
        kinds[kernel_kind(key)] = kinds.get(kernel_kind(key), 0.0) + us
    print("  by kind: " + ", ".join(f"{k} {us / steps:.1f} us/call"
                                    for k, us in sorted(kinds.items(), key=lambda x: -x[1])))
    for us, count, key in sorted(rows, reverse=True)[:6]:
        print(f"  {us / steps:9.1f} us/call  x{count // steps:<4d} {key[:90]}")


def profile_decode(eng, ps, gen_cfg) -> None:
    """Profile decode steps of a full batch of 8 slots."""
    for p in ps:
        eng.submit(p, gen_cfg)
    eng._admit()
    eng.step()
    device_profile("decode step, 8 slots", eng.step, 8)
    while eng.pending():
        eng.step()
    eng.results.clear()


def phase_serve():
    cfg = tfm.ModelConfig()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), DEV)
    eng = ContinuousBatchingEngine(cfg, params)
    greedy = GenerationConfig(max_new_tokens=64)
    sampled = GenerationConfig(max_new_tokens=64, temperature=0.8, seed=17)
    ps = prompts(cfg)
    # warm the engine's programs on one short request (not counted)
    eng.generate_ids([ps[0][:16]], GenerationConfig(max_new_tokens=4))
    paged_attention_decode.launches = 0
    ids = [eng.submit(p, greedy) for p in ps] + [eng.submit(ps[0], sampled)]
    decode_tokens, decode_s, steps = 0, 0.0, 0
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    while eng.pending():
        eng._admit()  # prefill whatever fits now, outside the decode timing
        torch.cuda.synchronize()
        active = sum(1 for s in eng.slots if s.active)
        t0 = time.perf_counter()
        eng.step()  # admits nothing more; ends in a device-to-host read
        decode_s += time.perf_counter() - t0
        decode_tokens += active  # one token per slot active in the step
        steps += 1
    wall = time.perf_counter() - t_all
    launches = paged_attention_decode.launches
    outs = [eng.results.pop(i) for i in ids]
    check(launches > 0, "serving did not launch the paged kernel")
    check(all(len(o) == 64 for o in outs), f"lengths {[len(o) for o in outs]}")
    check(all(0 <= x < cfg.vocab_size for o in outs for x in o), "token out of vocab")
    check(outs[8] != outs[0], "temperature 0.8 stream equals the greedy one")
    check(eng.pool.free_pages == eng.pool.usable_pages, "pages leaked")
    tps = decode_tokens / decode_s if decode_s else float("nan")
    print(f"serve ModelConfig() 9 requests x 64 tokens: {steps} steps, wall {wall:.3f} s, "
          f"decode {decode_tokens} tokens in {decode_s:.3f} s = {tps:.1f} tokens/s, "
          f"paged launches {launches}")

    profile_decode(eng, ps, greedy)

    # f32: the engine on the card (kernel) against the engine on the CPU
    # (plain gather), token for token; TF32 off so f32 products stay f32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = tfm.ModelConfig(dtype=torch.float32)
    p32 = tfm.init_params(cfg32, torch.Generator().manual_seed(0), "cpu")
    on_card = ContinuousBatchingEngine(cfg32, p32).generate_ids(ps, greedy)
    on_cpu = ContinuousBatchingEngine(cfg32, p32, device="cpu").generate_ids(ps, greedy)
    same = sum(a == b for a, b in zip(on_card, on_cpu))
    print(f"serve f32 card vs CPU (allow_tf32=False): {same}/8 greedy streams token-exact")
    check(same == len(ps), "f32 greedy streams differ between card and CPU")
    return launches, tps


# ---------------------------------------------------------------------------
# 5. training
# ---------------------------------------------------------------------------
# bench.py's train configuration (the 700M model it trains with optax.adam)
TRAIN_CFG = dict(vocab_size=32000, d_model=2048, n_layers=12, n_heads=16, n_kv_heads=16,
                 d_ff=5504, max_seq_len=1024, remat=True)


def phase_train(steps: int = 6):
    cfg = tfm.ModelConfig(**TRAIN_CFG)
    params = tfm.init_params(cfg, gen(40), DEV)
    leaves = [x.requires_grad_() for x in tfm.param_leaves(params)]
    n_params = sum(x.numel() for x in leaves)
    opt = torch.optim.Adam(leaves, lr=3e-4)  # bf16 params: bf16 moments
    step = tfm.make_train_step(cfg, opt)
    b, t = 8, 1024
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen(41), device=DEV)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(params, tokens)]  # first step: allocations, optimizer state
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    flash_attention_forward.launches = 0
    flash_attention_bwd_dq.launches = flash_attention_bwd_dkv.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(params, tokens))
    # the time ends at a readback of a weight the last update wrote, so
    # every step's backward and optimizer update are inside it
    float(params["ln_f"].detach().float().sum())
    dt = time.perf_counter() - t0
    launches = dict(fwd=flash_attention_forward.launches, dq=flash_attention_bwd_dq.launches,
                    dkv=flash_attention_bwd_dkv.launches)
    losses = [x.item() for x in losses]
    step_ms = dt / steps * 1e3
    tps = b * (t - 1) * steps / dt  # loss_fn trains on T-1 positions
    print(f"train bench.py config ({n_params / 1e6:.1f}M params, remat, bf16) B={b} T={t} "
          f"Adam(3e-4): first step {first_s * 1e3:.1f} ms, then {step_ms:.2f} ms/step "
          f"over {steps} steps = {tps:.1f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"train losses {['%.4f' % x for x in losses]}; launches over {steps} steps: "
          f"flash fwd {launches['fwd']}, dq {launches['dq']}, dkv {launches['dkv']}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    layers = cfg.n_layers * steps
    check(launches == dict(fwd=2 * layers, dq=layers, dkv=layers),
          f"train launches {launches}, expected fwd {2 * layers}, dq/dkv {layers}")
    device_profile(f"train step B={b} T={t}", lambda: step(params, tokens), 2)
    del params, leaves, opt, step
    torch.cuda.empty_cache()
    return launches, step_ms, tps


def leaf_names(tree, prefix=""):
    """Names of tfm.param_leaves(tree), in its order."""
    return [n for k in sorted(tree) for n in (
        leaf_names(tree[k], f"{prefix}{k}/") if isinstance(tree[k], dict) else [prefix + k])]


def phase_train_f32() -> None:
    """f32 ModelConfig(): loss and every gradient on the card (kernels)
    against the CPU's plain path, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tfm.ModelConfig(dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (1, 257), generator=torch.Generator().manual_seed(42))
    got = []
    for dev in (DEV, torch.device("cpu")):
        params = tfm.init_params(cfg, torch.Generator().manual_seed(43), dev)
        leaves = [x.requires_grad_() for x in tfm.param_leaves(params)]
        loss = tfm.loss_fn(params, tok.to(dev), cfg)
        loss.backward()
        got.append([loss.detach().cpu()] + [x.grad.cpu() for x in leaves])
    names = ["loss"] + leaf_names(params)
    errs = [rel_err(a, b) for a, b in zip(*got)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    # f32 sums in another order over T=256 and 4 layers: 1e-4 of the leaf's
    # largest entry
    print(f"train f32 ModelConfig() B=1 T=257 card vs CPU plain path: loss "
          f"{got[0][0].item():.6f} vs {got[1][0].item():.6f}, worst relative error "
          f"{errs[worst]:.2e} ({names[worst]}; tol 1e-4) over the loss and "
          f"{len(errs) - 1} gradient leaves")
    check(max(errs) <= 1e-4, f"f32 train step card vs CPU: {errs}")


# ---------------------------------------------------------------------------
# 6. the scheduler: card against the port's CPU path
# ---------------------------------------------------------------------------
SCHED_EPS = 1e-5  # the scheduler's comparison tolerance (scheduler/hybrid.py _EPS)


def same_bits(a, b) -> bool:
    """Every element of two outputs (tensors or arrays) bit-identical."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype.kind == "f":
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and bool((a == b).all())


def check_same(name: str, card, cpu) -> None:
    card = card if isinstance(card, (tuple, list)) else (card,)
    cpu = cpu if isinstance(cpu, (tuple, list)) else (cpu,)
    check(len(card) == len(cpu) and all(same_bits(a, b) for a, b in zip(card, cpu)),
          f"scheduler {name}: card and CPU outputs differ")


def host_ms(fn, iters: int = 3) -> float:
    """Mean host-clock ms of ``fn`` (which ends in a readback or a sync)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def device_share(label: str, fn, calls: int):
    """torch.profiler over ``calls`` calls of ``fn``: device ms per call
    (kernel rows only), device ops per call, and the device's busy share of
    the wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    if not rows:
        print(f"{label} profile: no device time in the trace (not measured)")
        return None
    busy_us = sum(r[0] for r in rows)
    ops = sum(r[1] for r in rows) / calls
    print(f"{label} profile over {calls} calls: wall {wall_us / calls / 1e3:.3f} ms/call, device "
          f"{busy_us / calls / 1e3:.4f} ms/call, {ops:.0f} device ops/call, device busy "
          f"{100 * busy_us / wall_us:.1f}%")
    for us, count, key in sorted(rows, reverse=True)[:4]:
        print(f"  {us / calls:9.1f} us/call  x{count // calls:<5d} {key[:80]}")
    return dict(device_ms=busy_us / calls / 1e3, ops=ops, busy=busy_us / wall_us)


def bench_cluster(num_nodes: int, rng):
    """bench.py's kernel-tier cluster (build_cluster): a quarter of the
    nodes with 4 TPUs, CPU availability drawn from uniform(0.5, 1.0)."""
    from ray_tpu_torch.scheduler.resources import CPU, MEMORY, OBJECT_STORE_MEMORY, TPU

    totals = np.zeros((num_nodes, 16), dtype=np.float32)
    n_tpu = num_nodes // 4
    totals[:, CPU], totals[:, MEMORY], totals[:, OBJECT_STORE_MEMORY] = 64.0, 256.0, 64.0
    totals[:n_tpu, CPU] = 32.0
    totals[:n_tpu, TPU] = 4.0
    avail = totals.copy()
    avail[:, CPU] *= rng.uniform(0.5, 1.0, num_nodes).astype(np.float32)
    return totals, avail, np.ones(num_nodes, dtype=bool)


def bench_demands(num_tasks: int, rng):
    """bench.py's demand mix (build_demands): 70% 0.25 CPU, 15% 0.5 CPU and
    1 memory, 10% 1 CPU, 5% 1 CPU and 1 TPU."""
    from ray_tpu_torch.scheduler.resources import CPU, MEMORY, TPU

    d = np.zeros((num_tasks, 16), dtype=np.float32)
    kind = rng.choice(4, num_tasks, p=[0.70, 0.15, 0.10, 0.05])
    d[:, CPU] = np.where(kind == 0, 0.25, np.where(kind == 1, 0.5, 1.0))
    d[kind == 1, MEMORY] = 1.0
    d[kind == 3, TPU] = 1.0
    return d


def sched_kernel_tier():
    """1,024 nodes x 100,000 requests through hybrid_schedule_shapes, on the
    card and on the CPU."""
    from ray_tpu_torch.scheduler import hybrid as H

    rng = np.random.default_rng(0)
    totals, avail, alive = bench_cluster(1024, rng)
    demands = bench_demands(100_000, rng)
    shapes, ids = H.dedupe_shapes(demands)
    dev_in = [torch.from_numpy(x).to(DEV) for x in (totals, avail, alive, shapes, ids)]
    card = H.hybrid_schedule_shapes(*dev_in, 123)
    cpu = H.hybrid_schedule_shapes(totals, avail, alive, shapes, ids, 123, device="cpu")
    check_same("kernel tier hybrid_schedule_shapes", tuple(card), tuple(cpu))
    nodes = card.node.cpu().numpy()
    placed = nodes >= 0
    after = avail.copy()
    np.add.at(after, nodes[placed], -demands[placed])
    check(after.min() >= -SCHED_EPS, f"kernel tier over-committed a node: min {after.min()}")
    check(np.abs(after - card.avail_out.cpu().numpy()).max() <= 1e-3, "kernel tier avail_out")
    ms = time_ms(lambda: H.hybrid_schedule_shapes(*dev_in, 7), iters=10, warmup=2)
    cpu_ms = host_ms(lambda: H.hybrid_schedule_shapes(totals, avail, alive, shapes, ids, 7,
                                                      device="cpu"))
    prof = device_share("sched kernel tier hybrid_schedule_shapes N=1024 B=100000",
                        lambda: H.hybrid_schedule_shapes(*dev_in, 7), 5)
    print(f"sched kernel tier N=1024 B=100000 U={shapes.shape[0]}: placed {int(placed.sum())}, "
          f"min avail after {after.min():.4f}; card {ms:.3f} ms/call "
          f"({100_000 / ms * 1e3:.0f} placements/s), CPU {cpu_ms:.3f} ms/call; "
          f"card == CPU bit for bit")
    return dict(ms=ms, cpu_ms=cpu_ms, **(prof or {}))


def sim_view(num_nodes: int, seed: int = 0):
    """A ClusterView of sim.py's heterogeneous node mix (60% std 64 CPU /
    256 memory, 20% dense 128/512 with throughput 1.25/1.1, 20% highmem
    32/1024 with 0.8/1.2)."""
    from ray_tpu_torch.scheduler.resources import ClusterView, ResourceVocab

    mix = ((0.6, "std", {"CPU": 64.0, "memory": 256.0}, None),
           (0.2, "dense", {"CPU": 128.0, "memory": 512.0}, {"CPU": 1.25, "memory": 1.1}),
           (0.2, "highmem", {"CPU": 32.0, "memory": 1024.0}, {"memory": 1.2, "CPU": 0.8}))
    view = ClusterView(ResourceVocab())
    for _, name, _, thr in mix:
        view.register_node_type(name, thr)
    bounds = np.cumsum([m[0] for m in mix])
    picks = np.random.default_rng(seed + 1).random(num_nodes)
    for i in range(num_nodes):
        _, name, res, _ = mix[min(int(np.searchsorted(bounds, picks[i])), len(mix) - 1)]
        view.add_node(f"simnode-{i}", res, node_type=name)
    return view


def head_batches(width: int, num_demands: int, batch: int, seed: int = 0):
    """sim.py's demand mix (build_demand_maps): 70% 0.25 CPU, 15% 0.5 CPU
    and 1 memory, 15% 1 CPU, deduped per round of ``batch`` requests."""
    from ray_tpu_torch.scheduler.hybrid import dedupe_shapes

    kind = np.random.default_rng(seed).choice(3, num_demands, p=[0.70, 0.15, 0.15])
    rows = np.zeros((3, width), np.float32)
    rows[:, 0] = (0.25, 0.5, 1.0)
    rows[1, 1] = 1.0
    dem = rows[kind]
    return [(dem[i:i + batch], *dedupe_shapes(dem[i:i + batch]))
            for i in range(0, num_demands, batch)]


def hist_delta(hist, before):
    """(mean, p50, p99) of the observations made since ``before``."""
    from ray_tpu_torch.util.metrics import percentile_from_buckets

    count0, sum0, buckets0 = before
    s = hist.summary()
    buckets = [b - a for a, b in zip(buckets0, hist.buckets_snapshot())]
    n = s["count"] - count0
    mean = (s["sum"] - sum0) / n if n else float("nan")
    return (mean, percentile_from_buckets(hist.boundaries, buckets, 0.5),
            percentile_from_buckets(hist.boundaries, buckets, 0.99))


def head_run(platform: str, batches, weights, with_ages: bool, label: str):
    """The head's round: a DeviceSchedulerState synced from the ClusterView,
    rounds of cfg.sched_max_batch requests dispatched through
    SchedulerPipeline at cfg.sched_pipeline_depth. Returns every request's
    node, in stream order, and the run's numbers."""
    from ray_tpu_torch.config import cfg
    from ray_tpu_torch.scheduler import device as D
    from ray_tpu_torch.scheduler.pipeline import SchedulerPipeline

    view = sim_view(10_000)
    st = D.DeviceSchedulerState(platform=platform)
    st.sync(view)
    # first touch (allocator, kernels) on one round, then a full re-upload
    # drops its deductions again
    st.schedule_async(shapes=batches[0][1:], weights=weights,
                      ages=np.zeros(batches[0][1].shape[0], np.float32)).result()
    st.invalidate()
    st.sync(view)
    # an agent report from every tenth node: a dirty-row push ahead of the stream
    for i in range(0, 10_000, 10):
        row = view.row_of(f"simnode-{i}")
        view.update_available(f"simnode-{i}", view.vocab.unpack(view.avail[row] * 0.75))
    st.sync(view)
    check(st.stats["delta_pushes"] == 1 and st.stats["delta_rows"] == 1000,
          f"{label}: delta push {st.stats}")
    avail0 = view.avail.copy()
    results, round_ms, dispatch_ms = {}, [], []

    def on_complete(ctx, rows, _ms):
        i, t_start = ctx  # latency from the start of the dispatch call
        results[i] = rows
        round_ms.append((time.perf_counter() - t_start) * 1e3)

    hists = (D.SCHED_UPLOAD_MS, D.SCHED_KERNEL_MS, D.SCHED_READBACK_MS)
    before = [(h.summary()["count"], h.summary()["sum"], h.buckets_snapshot()) for h in hists]
    pipe = SchedulerPipeline(on_complete=on_complete, depth=int(cfg.sched_pipeline_depth))
    if platform == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for i, (_, sd, sid) in enumerate(batches):
            ages = (np.full(sd.shape[0], 0.5 + (i % 3), np.float32) if with_ages else None)
            t_start = time.perf_counter()
            st.sync(view)
            pending = st.schedule_async(shapes=(sd, sid), ages=ages, weights=weights,
                                        ctx=(i, t_start))
            dispatch_ms.append((time.perf_counter() - t_start) * 1e3)
            pipe.submit(pending)
        check(pipe.flush(timeout=600.0), f"{label}: pipeline did not drain")
    finally:
        pipe.stop()
    wall = time.perf_counter() - t0
    upload, kernel, readback = (hist_delta(h, b) for h, b in zip(hists, before))
    nodes = np.concatenate([results[i] for i in range(len(batches))])
    dem = np.concatenate([b[0] for b in batches])
    ok = nodes >= 0
    after = avail0.copy()
    np.add.at(after, nodes[ok], -dem[ok])
    check(after.min() >= -SCHED_EPS, f"{label} {platform}: over-committed, min {after.min()}")
    n = nodes.shape[0]
    row = dict(placements_per_s=n / wall, p50=float(np.percentile(round_ms, 50)),
               p99=float(np.percentile(round_ms, 99)), dispatch=float(np.mean(dispatch_ms)),
               upload=upload, kernel=kernel,
               readback=readback, placed=int(ok.sum()), rounds=len(batches),
               peak=pipe.stats()["inflight_peak"])
    print(f"sched head round {label} [{platform}] 10000 nodes, {n} requests in {len(batches)} "
          f"rounds of {cfg.sched_max_batch} (depth {cfg.sched_pipeline_depth}): placed "
          f"{row['placed']}, {row['placements_per_s']:.0f} placements/s, round latency p50 "
          f"{row['p50']:.3f} ms p99 {row['p99']:.3f} ms, dispatch call {row['dispatch']:.3f} ms "
          f"mean; upload_ms mean/p50/p99 "
          f"{upload[0]:.3f}/{upload[1]:.3f}/{upload[2]:.3f}, kernel_ms "
          f"{kernel[0]:.3f}/{kernel[1]:.3f}/{kernel[2]:.3f}, readback_ms "
          f"{readback[0]:.4f}/{readback[1]:.4f}/{readback[2]:.4f}; min avail after "
          f"{after.min():.4f}")
    return nodes, row, st, view


def sched_head_round():
    """10,000 nodes and a 200,000-request backlog through the head's round,
    card and CPU, with the default weights and with the multi-objective
    ones (preemption and explain armed)."""
    from ray_tpu_torch.scheduler.hybrid import ScoreWeights

    out = {}
    for label, weights, with_ages in (("defaults", ScoreWeights(), False),
                                      ("multi-objective", ScoreWeights(1.0, 0.5, 1.0, 1.0),
                                       True)):
        batches = head_batches(16, 200_000, 4096)
        card, card_row, st, view = head_run("cuda", batches, weights, with_ages, label)
        cpu, cpu_row, _, _ = head_run("cpu", batches, weights, with_ages, label)
        divergence = int((card != cpu).sum())
        print(f"sched head round {label}: placement divergence card vs CPU {divergence}")
        check(divergence == 0, f"sched head round {label}: divergence {divergence}")
        sd, sid = batches[1][1:]
        ages = np.ones(sd.shape[0], np.float32) if with_ages else None
        prof = device_share(f"sched head round {label} (one 4096-request round, 10000 nodes)",
                            lambda: st.schedule_async(shapes=(sd, sid), ages=ages,
                                                      weights=weights).result(), 5)
        out[label] = dict(card=card_row, cpu=cpu_row, profile=prof)
    return out, st, view


def sched_other_programs(st, view):
    """The other programs, card against CPU, every output equal, timed."""
    from ray_tpu_torch.scheduler import binpack as P
    from ray_tpu_torch.scheduler import bundles as B
    from ray_tpu_torch.scheduler import hybrid as H
    from ray_tpu_torch.scheduler.resources import ResourceRequest
    from ray_tpu_torch.scheduler.unpark import select_unparkable

    rng = np.random.default_rng(1)
    timings = {}

    def both(name, fn, iters=1):
        """``fn(device)`` on the card (a first-touch call, then ``iters``
        timed calls) and once on the CPU; every output bit-identical."""
        card = fn(DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            card = fn(DEV)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        t0 = time.perf_counter()
        cpu = fn("cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        check_same(name, card, cpu)
        timings[name] = (ms, cpu_ms)
        print(f"sched {name}: card {ms:.2f} ms, CPU {cpu_ms:.2f} ms; card == CPU bit for bit")
        return card

    totals, avail, alive = bench_cluster(256, rng)
    dem = bench_demands(512, rng)
    pref = rng.integers(0, 256, 512).astype(np.int32)
    spill = rng.random(512) < 0.1
    both("hybrid_schedule_batch N=256 B=512", lambda d: tuple(H.hybrid_schedule_batch(
        totals, avail, alive, dem, pref, spill, 3, device=d)))
    totals, avail, alive = bench_cluster(1024, rng)
    chunks = bench_demands(8 * 4096, rng).reshape(8, 4096, 16)
    res = both("hybrid_schedule_rounds_chunked N=1024 8x4096", lambda d: tuple(
        H.hybrid_schedule_rounds_chunked(totals, avail, alive, chunks, 5, device=d)))
    nodes = res[0].cpu().numpy()
    flat = chunks.reshape(-1, 16)
    after = avail.copy()
    np.add.at(after, nodes[nodes >= 0], -flat[nodes >= 0])
    check(after.min() >= -1e-4, f"rounds_chunked over-committed: {after.min()}")

    # the parked-demand ring, full, and the slot estimator, on the head
    # state's resident arrays (10,000 nodes) against the same on the CPU
    n, r = view.num_nodes, view.totals.shape[1]
    ring_rows = np.zeros((st.ring_slots, r), np.float32)
    ring_rows[:, 0] = rng.choice([0.25, 0.5, 1.0, 2.0, 4.0, 8.0], st.ring_slots)
    ring_rows[:, 1] = rng.choice([0.0, 1.0, 4.0], st.ring_slots)
    ring_rows[:, 0] += np.arange(st.ring_slots) / 64.0  # one distinct shape per slot
    counts = rng.integers(1, 5000, st.ring_slots).astype(np.int32)
    ages = rng.uniform(0.0, 2.0, st.ring_slots).astype(np.float32)
    args = [x.clone() for x in (st._totals, st._avail, st._alive, st._ntypes, st._thr)]
    w = H.ScoreWeights(1.0, 0.5, 1.0, 1.0)
    both(f"ring_schedule S={st.ring_slots} (full) N={n}", lambda d: tuple(H.ring_schedule_impl(
        *[a.to(d) for a in args], ring_rows, counts, ages, 9, weights=w, preempt=True,
        device=d)), iters=3)
    both(f"shape_slots S={st.ring_slots} N={n}", lambda d: H.shape_slots_impl(
        *[a.to(d) for a in args[:3]], ring_rows, device=d), iters=3)
    for i in range(st.ring_slots):  # the state's own ring path
        check(st.ring_park(("shape", i), ring_rows[i]), "ring_park refused a free slot")
    check(not st.ring_park(("shape", "extra"), ring_rows[0]), "a full ring took another shape")
    placed, per_node, pre = st.ring_schedule({i: int(counts[i]) for i in range(st.ring_slots)},
                                             ages_by_slot={i: 1.5 for i in range(8)})
    check(int(per_node.sum()) == int(placed.sum()) > 0, "ring_schedule counts")

    # the unpark estimator on the card's resident arrays
    calls = [0]

    def slots_fn(mat):
        calls[0] += 1
        return st.shape_slots(mat)

    class Spec:
        def __init__(self, res):
            self.resources = res

    parked = [Spec({"CPU": c}) for c in rng.choice([0.5, 1.0, 64.0], 3000)]
    take, keep = select_unparkable(
        parked, view.avail, view.alive, slots_fn=slots_fn,
        is_constrained=lambda s: False, resources_of=lambda s: s.resources,
        request_of=lambda s: ResourceRequest.from_map(view.vocab, s.resources))
    check(calls[0] == 1, "unpark: device estimator not used")
    print(f"sched unpark: {len(take)} of {len(parked)} parked specs unpark by the card's "
          f"shape_slots")

    # placement groups: a 64-bundle group over the 10,000 nodes
    t_h, a_h, al_h = (x.cpu().numpy() for x in args[:3])
    bundles = np.zeros((64, r), np.float32)
    bundles[:, 0] = rng.choice([1.0, 2.0, 4.0, 8.0], 64)
    bundles[::4, 1] = 16.0
    sb = bundles[B.sort_bundles(bundles)]
    for name, fn in (("pack_bundles", B.pack_bundles),
                     ("spread_bundles", lambda *a, **k: B.spread_bundles(*a, strict=False, **k)),
                     ("spread_bundles strict", lambda *a, **k: B.spread_bundles(*a, strict=True,
                                                                                 **k)),
                     ("strict_pack_bundles", B.strict_pack_bundles)):
        res = both(f"{name} B=64 N={n}", lambda d, fn=fn: tuple(fn(t_h, a_h, al_h, sb, device=d)))
        check(bool(res[1]) or name == "strict_pack_bundles", f"{name} failed to place")

    # the autoscaler: 10,000 node rows, 64 shapes
    shapes = np.zeros((64, r), np.float32)
    shapes[:, 0] = rng.choice([0.5, 1.0, 2.0, 4.0], 64) + np.arange(64) / 128.0
    shapes[::3, 1] = 8.0
    shapes = shapes[P.sort_demands(shapes)]
    cnts = rng.integers(1, 400, 64).astype(np.float32)
    rows = a_h[:n]
    both(f"bin_pack_residual N={n} B=64", lambda d: tuple(P.bin_pack_residual(rows, shapes,
                                                                              device=d)))
    sol = both(f"solve_pack_counts N={n} U=64 iters=24", lambda d: tuple(P.solve_pack_counts(
        rows, shapes, cnts, iters=24, device=d)))
    check(float(sol[0].sum()) > 0, "solve placed nothing")
    types = np.unique(t_h[:n], axis=0)
    both(f"utilization_scores T={types.shape[0]} B=64", lambda d: tuple(P.utilization_scores(
        types, shapes, device=d)), iters=3)
    ids = [f"simnode-{i}" for i in range(n)]
    demands = np.repeat(shapes, cnts.astype(np.int64), axis=0)
    runs0, falls0 = P.SOLVER_RUNS.value(), P.SOLVER_FALLBACKS.value()
    packers = (P.DeltaBinPacker(device=DEV), P.DeltaBinPacker(device="cpu"))
    got = [pk.pack_or_solve(ids, rows, demands) for pk in packers]
    check(P.SOLVER_RUNS.value() == runs0 + 2 and P.SOLVER_FALLBACKS.value() == falls0,
          "DeltaBinPacker.pack_or_solve did not solve, or fell back")
    check(same_bits(got[0], got[1]), "DeltaBinPacker card vs CPU")
    t0 = time.perf_counter()
    packers[0].pack_or_solve(ids, rows, demands)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"sched DeltaBinPacker.pack_or_solve N={n} B={demands.shape[0]}: card {ms:.2f} ms, "
          f"{int((got[0] >= 0).sum())} placed; card == CPU")
    return timings


def phase_scheduler():
    """The scheduler slice: kernel tier, head round, other programs."""
    import os

    os.environ["RAY_TPU_SCHED_PREWARM"] = "0"  # no background warm-up in the timings
    t0 = time.perf_counter()
    tier = sched_kernel_tier()
    head, st, view = sched_head_round()
    sched_other_programs(st, view)
    print(f"sched phase: {time.perf_counter() - t0:.1f} s")
    return tier, head



# --- the local runtime (init → remote → round on the card → worker → get) ---


class _RuntimeErrors:
    """Collects every ERROR record of the port's loggers (``ray_tpu_torch``
    and below: "scheduler round failed", a failed unpark sync or slot
    estimate). The scheduler thread logs and requeues a failing round, so
    on the card a broken program would show as a hang, not an error."""

    def __init__(self):
        import logging

        self.records = []
        errors = self

        class _Handler(logging.Handler):
            def emit(self, record):
                errors.records.append(record.getMessage())

        self.handler = _Handler(level=logging.ERROR)
        self.logger = logging.getLogger("ray_tpu_torch")
        self.logger.addHandler(self.handler)

    def check(self, where: str) -> None:
        check(not self.records, f"runtime {where}: {len(self.records)} error records, first: "
                                f"{self.records[:1]}")

    def close(self) -> None:
        self.logger.removeHandler(self.handler)


def _instrument_runtime(rt):
    """Counts parks, unparks and ``shape_slots`` calls, and times each
    ``device_state.schedule`` call on the host clock, by wrapping the
    runtime instance's own methods (nothing changes in the package)."""
    stats = {"parks": 0, "unparks": 0, "shape_slots": 0, "schedule_ms": []}
    park, unpark = rt._park_infeasible, rt._unpark_grantable

    def _park(spec):
        stats["parks"] += 1
        park(spec)

    def _unpark():
        before = len(rt._infeasible)
        unpark()
        stats["unparks"] += before - len(rt._infeasible)

    rt._park_infeasible, rt._unpark_grantable = _park, _unpark
    st = rt.device_state
    if st is not None:
        schedule, slots = st.schedule, st.shape_slots

        def _schedule(*a, **k):
            t0 = time.perf_counter()
            out = schedule(*a, **k)
            stats["schedule_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

        def _slots(*a, **k):
            stats["shape_slots"] += 1
            return slots(*a, **k)

        st.schedule, st.shape_slots = _schedule, _slots
    return stats


def _noop():
    return None


def runtime_burst(label: str, device: str, num_tasks: int = 10_000, passes: int = 2):
    """bench.py's ``cluster_bench`` workload on the local runtime: 256 nodes
    of 4 CPUs and 4 GiB, ``num_tasks`` no-op tasks at num_cpus=0.25 in one
    burst (2.4× the cluster's 4,096 slots, so work parks and unparks),
    gathered 500 at a time; ``passes`` passes after a 50-task warm-up."""
    import ray_tpu_torch as rtt

    rt = rtt.init(num_nodes=256, resources_per_node={"CPU": 4, "memory": float(4 << 30)})
    try:
        check(rt.device_state is not None and rt.device_state.device.type == device,
              f"runtime {label}: the scheduler state is not on {device}")
        check(rt.native_store is not None, f"runtime {label}: no native object store")
        stats = _instrument_runtime(rt)
        f = rtt.remote(_noop).options(num_cpus=0.25, max_retries=0)
        rtt.get([f.remote() for _ in range(50)], timeout=120)
        rates, wall = [], 0.0
        calls0 = len(stats["schedule_ms"])
        for _ in range(passes):
            t0 = time.perf_counter()
            refs = [f.remote() for _ in range(num_tasks)]
            for i in range(0, num_tasks, 500):
                check(rtt.get(refs[i:i + 500], timeout=300) == [None] * len(refs[i:i + 500]),
                      f"runtime {label}: a no-op task returned a value")
            wall += time.perf_counter() - t0
            rates.append(num_tasks / (time.perf_counter() - t0))
        in_passes = sum(stats["schedule_ms"][calls0:])
        ms = np.asarray(stats["schedule_ms"]) if stats["schedule_ms"] else np.zeros(1)
        print(f"runtime {label}: tasks/s " + ", ".join(f"pass {i + 1} {r:.1f}"
                                                     for i, r in enumerate(rates))
              + f"; sched_rounds {rt.metrics['sched_rounds']}, schedule calls {len(ms)}, "
              f"ms per schedule p50 {np.percentile(ms, 50):.3f} p99 {np.percentile(ms, 99):.3f}, "
              f"{in_passes:.1f} ms in schedule calls over the passes' {wall * 1e3:.1f} ms "
              f"({100 * in_passes / (wall * 1e3):.1f}%); "
              f"parks {stats['parks']}, unparks {stats['unparks']}, "
              f"shape_slots calls {stats['shape_slots']}; "
              f"finished {rt.metrics['tasks_finished']}, failed {rt.metrics['tasks_failed']}")
        check(rt.metrics["tasks_failed"] == 0, f"runtime {label}: tasks failed")
        if rt.device_state.device.type == "cuda":
            # one more pass under torch.profiler (not counted in tasks/s):
            # its kernel rows over its wall time are the device's busy share
            def one_pass():
                refs = [f.remote() for _ in range(num_tasks)]
                check(rtt.get(refs, timeout=300) == [None] * num_tasks,
                      f"runtime {label}: a no-op task returned a value")

            device_share(f"runtime {label} profiled pass ({num_tasks} tasks)", one_pass, 1)
        return rates
    finally:
        rtt.shutdown()


def _record_rounds():
    """Wraps the round program so each call's inputs (resident totals,
    avail, alive, node types, shapes, ids, ages, seed, options) and its
    node rows are kept on the host; returns (records, restore)."""
    from ray_tpu_torch.scheduler import hybrid as H

    impl = H.hybrid_schedule_shapes_multi_impl
    records = []

    def _recorded(*args, **kwargs):
        host = [a.detach().cpu().clone() if isinstance(a, torch.Tensor) else a for a in args]
        kw = {k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v)
              for k, v in kwargs.items()}
        res = impl(*args, **kwargs)
        records.append((host, kw, res.node.cpu().clone(), res.avail_out.cpu().clone()))
        return res

    H.hybrid_schedule_shapes_multi_impl = _recorded

    def restore():
        H.hybrid_schedule_shapes_multi_impl = impl

    return records, impl, restore


def runtime_functional(rt, rtt, stats):
    """The task path's features on the card, every value checked."""
    import threading

    from ray_tpu_torch.core.object_store import TaskError
    from ray_tpu_torch.core.runtime import get_context
    from ray_tpu_torch.core.scheduling_strategies import PlacementGroupSchedulingStrategy

    @rtt.remote
    def add(a, b):
        return a + b

    ref = rtt.put(0)
    for i in range(100):
        ref = add.remote(ref, i)
    check(rtt.get(ref, timeout=120) == sum(range(100)), "runtime: 100-deep chain")

    @rtt.remote(num_returns=2)
    def pair(x):
        return x, -x

    a, b = pair.remote(add.remote(3, 4))
    check(rtt.get([a, b], timeout=60) == [7, -7], "runtime: multiple returns")

    @rtt.remote
    def outer(x):
        return sum(rtt.get([add.remote(x, i) for i in range(4)], timeout=60))

    check(rtt.get(outer.remote(10), timeout=60) == 46, "runtime: nested tasks")

    @rtt.remote
    class Log:
        def __init__(self):
            self.seen = []

        def push(self, i):
            self.seen.append(i)
            return len(self.seen)

        def items(self):
            return list(self.seen)

    log = Log.remote()
    counts = rtt.get([log.push.remote(i) for i in range(1000)], timeout=120)
    check(counts == list(range(1, 1001)), "runtime: 1,000 actor calls out of order")
    check(rtt.get(log.items.remote(), timeout=60) == list(range(1000)),
          "runtime: actor state out of order")

    @rtt.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="svc").remote()
    svc = rtt.get_actor("svc")
    check(rtt.get(svc.ping.remote(), timeout=60) == "pong", "runtime: named actor")
    rtt.kill(svc)
    try:
        rtt.get(svc.ping.remote(), timeout=10)
        fail("runtime: a killed actor answered")
    except rtt.GetTimeoutError:
        fail("runtime: a call to a killed actor hung")
    except Exception:  # noqa: BLE001 - the call must fail, not hang
        pass

    @rtt.remote(num_cpus=1)
    def where():
        return get_context().node_id

    for strategy, same in (("PACK", True), ("STRICT_SPREAD", False)):
        pg = rtt.placement_group([{"CPU": 1}] * 3, strategy=strategy)
        check(rtt.get(pg.ready(), timeout=60) is True, f"runtime: {strategy} group not ready")
        hosts = [b["node_id"] for b in rtt.placement_group_table()[pg.id]["bundles"].values()]
        check(len(set(hosts)) == (1 if same else 3), f"runtime: {strategy} bundles on {hosts}")
        ran = rtt.get([where.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=i)).remote() for i in range(3)],
            timeout=60)
        check(ran == hosts, f"runtime: {strategy} tasks ran on {ran}, bundles on {hosts}")
        rtt.remove_placement_group(pg)

    big = np.arange(16 << 20, dtype=np.float32)  # 64 MiB
    used0 = rt.native_store.stats()["used"]
    ref = rtt.put(big)
    view = rtt.get(ref, timeout=60)
    check(rt.native_store.stats()["used"] - used0 >= big.nbytes, "runtime: 64 MiB not in the arena")
    check(not view.flags.writeable and not view.flags.owndata,
          "runtime: the arena's array is not a read-only view")
    check(np.array_equal(view, big), "runtime: 64 MiB array differs")

    @rtt.remote
    def total(x):
        return float(x[-1]) + float(x[1])

    check(rtt.get(total.remote(ref), timeout=60) == float(big[-1]) + 1.0,
          "runtime: a task read the arena's array wrong")
    del view, ref

    @rtt.remote
    def slow(t):
        time.sleep(t)
        return t

    fast_ref, slow_ref = slow.remote(0.0), slow.remote(2.0)
    ready, rest = rtt.wait([slow_ref, fast_ref], num_returns=1, timeout=30)
    check(ready == [fast_ref] and rest == [slow_ref], "runtime: wait picked the wrong ref")
    stuck = add.options(num_cpus=10_000).remote(1, 2)  # parks: no node has it
    deadline = time.monotonic() + 30
    while not any(stuck.hex in s.return_ids for s in list(rt._infeasible)):
        check(time.monotonic() < deadline, "runtime: the oversized task never parked")
        time.sleep(0.01)
    rtt.cancel(stuck)
    try:
        rtt.get(stuck, timeout=10)
        fail("runtime: a cancelled task returned")
    except TaskError:
        pass
    check(rtt.get(slow_ref, timeout=30) == 2.0, "runtime: slow task")

    calls = []

    @rtt.remote(num_cpus=1)
    def produce():
        calls.append(1)
        return ("data", get_context().node_id)

    ref = produce.remote()
    _, node = rtt.get(ref, timeout=60)
    rt.kill_node(node)
    data, node2 = rtt.get(ref, timeout=60)  # rebuilt through its lineage
    check(data == "data" and node2 != node and len(calls) == 2, "runtime: lineage rebuild")

    def count(n):
        for i in range(n):
            yield i * i

    gen = rtt.remote(count).options(num_returns="streaming", num_cpus=0.5).remote(8)
    items = [rtt.get(gen.next_ref(timeout=60), timeout=60) for _ in range(8)]
    check(items == [i * i for i in range(8)], "runtime: streaming generator")
    try:
        gen.next_ref(timeout=60)
        fail("runtime: the stream did not end")
    except StopIteration:
        pass

    # fill every slot with held tasks, so the next ones park; opening the
    # gate frees the slots and the parked work unparks on shape_slots
    gate = threading.Event()

    @rtt.remote(num_cpus=0.25, max_retries=0)
    def held():
        gate.wait(120)
        return 1

    slots = int(rtt.cluster_resources()["CPU"] / 0.25)
    parks0, unparks0, slots0 = stats["parks"], stats["unparks"], stats["shape_slots"]
    refs = [held.remote() for _ in range(slots + 2000)]
    deadline = time.monotonic() + 60
    while stats["parks"] - parks0 < 2000:
        check(time.monotonic() < deadline, "runtime: work beyond the slots never parked")
        time.sleep(0.01)
    gate.set()
    check(sum(rtt.get(refs, timeout=300)) == slots + 2000, "runtime: held tasks")
    check(stats["unparks"] - unparks0 >= 2000 and stats["shape_slots"] > slots0,
          "runtime: parked work did not unpark through shape_slots")


def phase_runtime():
    """The local runtime on the card: the many-tasks burst (card, then the
    port's CPU path in a fresh runtime), the functional workload with every
    round recorded, and each recorded round replayed on the CPU."""
    import os

    import ray_tpu_torch as rtt

    os.environ["RAY_TPU_SCHED_PREWARM"] = "0"  # no background warm-up in the timings
    os.environ.pop("RAY_TPU_SCHED_PLATFORM", None)  # the default: cuda
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    try:
        card = runtime_burst("card", "cuda")
        errors.check("burst on the card")
        records, impl, restore = _record_rounds()
        try:
            rt = rtt.init(num_nodes=256, resources_per_node={"CPU": 4, "memory": float(4 << 30)})
            try:
                check(rt.device_state is not None and rt.device_state.device.type == "cuda",
                      "runtime: the scheduler state is not on the card")
                check(rt.native_store is not None, "runtime: no native object store")
                stats = _instrument_runtime(rt)
                runtime_functional(rt, rtt, stats)
                print(f"runtime functional workload on the card: every value right; "
                      f"sched_rounds {rt.metrics['sched_rounds']}, parks {stats['parks']}, "
                      f"unparks {stats['unparks']}, shape_slots calls {stats['shape_slots']}")
            finally:
                rtt.shutdown()
        finally:
            restore()
        errors.check("functional workload")
        check(len(records) > 0, "runtime: no round was recorded")
        for i, (args, kw, node, avail_out) in enumerate(records):
            res = impl(*args, **kw)
            check(torch.equal(res.node, node) and torch.equal(res.avail_out, avail_out),
                  f"runtime: round {i} of {len(records)} replays differently on the CPU")
        print(f"runtime replay: {len(records)} card rounds replayed on the CPU, every node row "
              f"and avail_out equal")
        os.environ["RAY_TPU_SCHED_PLATFORM"] = "cpu"
        try:
            cpu = runtime_burst("CPU path", "cpu")
        finally:
            os.environ.pop("RAY_TPU_SCHED_PLATFORM", None)
        errors.check("burst on the CPU path")
    finally:
        errors.close()
    print(f"runtime tasks/s card {', '.join(f'{r:.1f}' for r in card)}; "
          f"CPU path {', '.join(f'{r:.1f}' for r in cpu)}")
    print(f"runtime phase: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    phase_card_and_build()
    flash_row = phase_flash()
    bwd_rows = phase_flash_backward()
    paged_row = phase_paged()
    flash_launches = phase_forward()
    paged_launches, tps = phase_serve()
    train_launches, step_ms, train_tps = phase_train()
    phase_train_f32()
    phase_scheduler()
    phase_runtime()
    kernels = [
        dict(name="paged_attention_decode", route="cuda",
             source="ray_tpu_torch/csrc/paged_attention.cu",
             replaces="ray_tpu/ops/paged_attention.py:102",
             launches=paged_launches, **paged_row),
        dict(name="flash_attention_fwd", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:185",
             launches=flash_launches, **flash_row),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:230",
             launches=train_launches["dq"], **bwd_rows["dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:247",
             launches=train_launches["dkv"], **bwd_rows["dkv"]),
    ]
    print(f"decode tokens/s {tps:.1f}; train {step_ms:.2f} ms/step, {train_tps:.1f} tokens/s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
