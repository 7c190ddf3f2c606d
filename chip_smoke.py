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
5a. parallelism (``ray_tpu_torch/parallel/``): the mesh path over NCCL on
   ``MeshConfig.auto(device_count())`` ranks, one per card, each training
   bench.py's configuration (remat, bf16, B=8 a dp rank, T=1024, Adam) for
   a few steps of ``make_train_step(cfg, opt, mesh)`` (flash launches
   counted from zero: 2·layers·microbatches forward and layers·microbatches
   dQ and dK/dV a step on each rank), ms/step and tokens/s beside phase
   5's; an f32 ``ModelConfig()`` step through the mesh path at
   ``local_mesh()`` against the plain ``make_train_step``, loss and every
   gradient within 1e-6; then ``dryrun_multichip(8, "cpu")`` on 8 gloo
   ranks, its first-step losses equal to the single-process CPU
   ``loss_fn`` within 1e-5;
5c. the training libraries (``ray_tpu_torch/train/``, ``tune/``):
   ``TorchTrainer`` on the local runtime trains phase 5's configuration and
   seeds in one worker for six steps, reports a checkpoint of the params
   and the optimizer's state after step 3, fails after step 4 on its first
   attempt (``FailureConfig(max_failures=1)``) and restores step 3: its six
   losses must equal phase 5's first six bit for bit, every tensor of the
   loop lie on the card, and the flash launches be those of 7 step runs;
   checkpoint bytes, write and restore seconds printed. ``ElasticTrainer``
   on ``Cluster()`` (bench.py's ``elastic_train_bench``: the head on the
   card, two agents sharing it, a 2-rank STRICT_SPREAD gang, 4 virtual
   shards, a seal every 2 steps) trains ``ModelConfig()`` bf16 for 40 steps
   with Adam's moments sealed ZeRO-style; the node of rank 1 is killed at
   step 13, a node joins after the shrink and the gang grows back: steps
   0-39 contiguous, reshapes exactly a shrink 2->1 and a grow 1->2, no
   disk restore, the final state, moments and every loss bit-equal to this
   process's own run of the 40 steps, CUDA leaves sealed, flash launches
   reported by the ranks; step rate before and after, retention, time to
   detect the shrink and the seal's ms and bytes printed. A ``Tuner`` grid
   of four learning rates under ASHA (max_t 8, grace 2, reduction 2) on
   ``ModelConfig()``, B=4, T=512: every trial on the card, one stopped, the
   best result the lowest last loss;
5b. head_dim above 256: ``flash_attention`` at 320 (padded to 512) and the
   grouped kernels at 512, forward, dQ and dK/dV, and the paged kernel at
   320 and 512 (one slot split over blocks, two launches bit-equal), f32
   and bf16, each against its plain version; each wide kernel timed at one
   bf16 shape (bh=16, T=1024, D=512 causal; paged at the engine's decode
   shapes with D=512) beside its plain version, SDPA where it takes the
   inputs, and its bound. Then ``LLMEngine(ModelConfig())``: 8 prompts x 64
   greedy tokens and one stream at temperature 0.8 with top_k 40, decode
   tokens/s; f32 greedy streams card == CPU (TF32 off);
   ``ModelConfig(n_experts=4)``: the engine generates, ``forward`` at B=4,
   T=2048 launches the flash kernel (counted from zero), three MoE train
   steps launch the flash forward and backward, an f32 MoE forward card vs
   CPU within 1e-3. Then the continuous engine in f32 with the device plane
   on: ``prefill_extract`` hands CUDA tensors, sealed as device frames into
   a ``NativeObjectStore`` and landed back on the card equal;
   ``adopt_pages`` decodes them token-exact with a monolithic engine, with
   no prefill and the paged kernel launched; engine A publishes a prefix
   that engine B hits with no prefill and an equal stream (and a longer
   prompt's stream equals a full prefill's); ``swap_params`` finishes the
   in-flight stream on the old weights, admits the queued one on the new,
   retags the cache so the old prefix misses, and at its drain deadline
   evicts a wedged slot and sheds the next submit (``Overloaded``); no
   engine leaks a page;
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
8. runs the multi-process cluster (``Cluster()``: the head in this process
   with its ``DeviceSchedulerState`` on the card and
   ``sched_device_min_batch`` 0, node-agent and worker subprocesses that
   never touch the card before a task asks for it): bench.py's
   ``cluster_bench`` (two agents of 16 CPUs × 4 workers, 50 warm-up tasks,
   two passes of 10,000 no-op tasks at 0.25 CPU, ``get`` in chunks of 500)
   prints tasks/s, the head's rounds per pass, lease-cache hits and misses
   and the rounds' round/upload/kernel/readback ms (p50/p99); then, with
   every head round recorded, a functional workload whose every value is
   checked (ObjectRef arguments across nodes, 64 MiB between agents, 1,000
   ordered actor calls, a named actor and ``kill``, STRICT_SPREAD and PACK
   groups, a GPU agent whose worker computes a seeded product on the card
   under its lease's ``CUDA_VISIBLE_DEVICES``, a head restart from its WAL
   with the new head's state on the card, leased tasks then ``kill_node``
   and a lineage rebuild); each recorded round (the parked-demand ring's
   from the card burst on) is replayed on the CPU; the burst runs again
   with the head on the port's CPU path. Each burst prints its ring
   rounds' program ms and slots walked, and the client's lease grants,
   grant RPC ms, misses by the state of their shape's leases and lease
   ages. Any ERROR record fails the phase;
9. drives bench.py's ``sim_sched`` through the port's real ``HeadServer``
   (``scheduler/sim.py``: 10,000 nodes of NODE_MIX, 200,000 demands,
   grants to a sink), synchronous then pipelined after a warm-up run:
   placements/s, round p50/p99, divergence 0; every head and ring round of
   the runs, recorded on the card, replays equal on the CPU;
10. runs ``run_elasticity_sim`` at bench.py's part (b) defaults (10,000
   nodes, 8 ticks, 200 parked shapes): tick p50/p99, ``solve_path``,
   every tick's ``solve_pack_counts`` on the card, each replayed on the
   CPU (per_node and placed equal, the residual within 1e-5);
11. drives the autoscaler: in the local runtime on the card (256 nodes, a
   2,000-task backlog in 20 shapes no node holds), ``Autoscaler.tick()``
   packs the demand on the card and launches nodes until every task has
   returned its value, ``SOLVER_RUNS`` rising and ``SOLVER_FALLBACKS``
   not, each ``pack_or_solve`` replayed on the CPU; then a two-agent
   ``Cluster`` whose head's elasticity controller, given
   ``attach_elasticity_provider``, provisions agents under a parked burst
   and retires them when idle, ms per tick printed;
12. starts a ``Cluster`` with a warm standby (``start_standby``), runs 300
   tasks, kills the leader: the standby promotes onto the leader's port
   with its scheduler state on the card, a task and an actor created after
   the promotion return, and ``FAILOVER_MS`` is printed;
13. serves the head's dashboard (``dashboard_port=0``, the standard
   library's ``ThreadingHTTPServer``) over two agents, tasks, two actors
   and a STRICT_SPREAD group: every route fetched with ``urllib`` and held
   against the cluster's own state, a job submitted through the REST API
   with its status and logs, 404 and 405 where the reference gives them,
   the Prometheus scrape parser-valid with the scheduler's ``sched_*_ms``
   histograms; then ``util.state`` on the in-process runtime after 2,000
   tasks;
14. runs bench.py's tier 4 and 4b on the port's ``Cluster`` (three
   ``_Stage`` actors: 20 eager chains against 200 compiled executions,
   then ``compile_pipeline`` over 100 warm-up and 4,000 timed items,
   ``respilled`` and ``broken`` 0), a CUDA tensor through two actors' ring
   edges (it lands on the card, bytes equal) and a 64 MiB CUDA tensor
   through the in-process runtime's local edges (same ``data_ptr()``);
15. runs bench.py's ``device_xfer_bench``: a CUDA block made on one node,
   pulled inside a worker of another that lands it on the card, 32 MiB × 5
   and 256 MiB × 2, with the device plane on and with the kill switch
   (``RAY_TPU_DEVICE_PLANE=0``, the host bounce): MB/s, the counters
   (seals, device lands, pump chunks, landing-zone chunks of the driver's
   ``rdt.get_tensor``), where it landed and whether its bytes equal the
   source's; then the card's pinned D2H and H2D rates as the yardstick.
   Every result line of 13-15 carries the card's name and power limit;
16. checks that every process the phases started (agents, zygotes,
   workers) has ended: the script is its descendants' subreaper, so a
   worker orphaned by its agent's death is found too; what is left after
   20 s is killed and the run fails naming it. On any exit, whatever is
   left below the script is killed;
17. prints the kernel table as one JSON line, then the result line.
"""
from __future__ import annotations

import atexit
import json
import math
import os
import re
import signal
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
from ray_tpu_torch.llm.engine import GenerationConfig, LLMEngine  # noqa: E402
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
from ray_tpu_torch.parallel import MeshConfig, dryrun, launch, local_mesh  # noqa: E402

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


def sdpa_backward_ms(qg, kg, vg, do, backends=("FLASH_ATTENTION", "CUDNN_ATTENTION")):
    """The yardstick: SDPA's backward on the grouped layout (dq, dk and dv in
    one call, from a saved output), causal, timed under each of ``backends``
    (SDPBackend names) that takes these inputs, the forward built inside the
    same context. Returns {backend: ms}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = (x[None].detach().requires_grad_() for x in (qg, kg, vg))
    times = {}
    for backend in (getattr(SDPBackend, name) for name in backends):
        try:
            with sdpa_kernel(backend):
                out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                                        is_causal=True)
                times[backend.name.lower()] = time_ms(lambda: torch.autograd.grad(
                    out4, (q4, k4, v4), do[None], retain_graph=True))
        except RuntimeError as e:  # the backend does not take these inputs here
            print(f"sdpa {backend.name}: not available ({str(e).splitlines()[0][:120]})")
    return times


def bwd_timing(bh, t, d, seed, sdpa_backends=("FLASH_ATTENTION", "CUDNN_ATTENTION")):
    """dQ and dK/dV kernels at one causal bf16 shape: error against the
    plain versions, kernel, plain and SDPA-backward ms (the fastest of
    ``sdpa_backends``), and each bound."""
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
    sdpa_by = sdpa_backward_ms(qg, kg, vg, do, sdpa_backends)
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
    return launches, step_ms, tps, losses


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
# 5a. parallelism
# ---------------------------------------------------------------------------
def parallel_nccl_train(train_ms: float, train_tps: float, steps: int = 6) -> dict:
    """bench.py's train configuration through the mesh path, one NCCL rank
    per card, each rank a process of ``parallel.launch``."""
    mesh_cfg = MeshConfig.auto(torch.cuda.device_count())
    cfg = tfm.ModelConfig(**TRAIN_CFG)
    run = dryrun.Run(mesh_cfg, cfg, batch=8 * mesh_cfg.dp, seq=1023)
    res = launch(dryrun.train_rank, mesh_cfg.size, ([run], None, "adam", 3e-4, steps + 1),
                 timeout=600)
    m = run.num_microbatches
    local = 1 if mesh_cfg.pp == 1 else (m // mesh_cfg.dp if m % mesh_cfg.dp == 0
                                        else math.gcd(m, 8))
    passes = cfg.n_layers // mesh_cfg.pp * local * steps  # layer passes a rank makes
    tps = run.batch * run.seq / (res[0][0]["step_ms"] / 1e3)
    print(f"parallel NCCL {mesh_cfg} ({mesh_cfg.size} ranks) bench.py config B={run.batch} "
          f"T={run.seq + 1} Adam(3e-4) on {'; '.join(card_line().splitlines())}: first step "
          f"{res[0][0]['first_ms']:.1f} ms, then {res[0][0]['step_ms']:.2f} ms/step over "
          f"{steps} steps = {tps:.1f} tokens/s (plain path, phase 5: {train_ms:.2f} ms/step, "
          f"{train_tps:.1f} tokens/s)")
    for r, [out] in enumerate(res):
        losses = out["losses"]
        print(f"parallel rank {r} losses {['%.4f' % x for x in losses]}; launches over "
              f"{steps} steps: flash fwd {out['launches']['fwd']}, dq {out['launches']['dq']}, "
              f"dkv {out['launches']['dkv']}")
        check(all(math.isfinite(x) for x in losses), f"rank {r}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"rank {r}: loss did not fall: {losses}")
        check(out["launches"] == dict(fwd=2 * passes, dq=passes, dkv=passes),
              f"rank {r} launches {out['launches']}, expected fwd {2 * passes}, "
              f"dq/dkv {passes}")
    return dict(res[0][0]["launches"], step_ms=res[0][0]["step_ms"], tps=tps)


def parallel_local_mesh() -> float:
    """f32 ModelConfig(): one step through the mesh path at local_mesh()
    against the plain make_train_step from the same parameters; returns
    the largest difference of the loss and the gradients."""
    cfg = tfm.ModelConfig(dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (2, 257),
                        generator=torch.Generator().manual_seed(46)).to(DEV)
    got = []
    for mesh in (None, local_mesh()):
        params = tfm.init_params(cfg, torch.Generator().manual_seed(47), DEV)
        leaves = [x.requires_grad_() for x in tfm.param_leaves(params)]
        opt = torch.optim.SGD(leaves, lr=1e-3)
        grads = []
        opt.register_step_pre_hook(lambda *_: grads.extend(x.grad.clone() for x in leaves))
        loss = tfm.make_train_step(cfg, opt, mesh)(params, tok)
        got.append([loss] + grads)
    names = ["loss"] + leaf_names(params)
    errs = [max_err(a, b) for a, b in zip(*got)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    print(f"parallel local_mesh() f32 ModelConfig() B=2 T=257 mesh path vs plain path: loss "
          f"{got[1][0].item():.6f} vs {got[0][0].item():.6f}, largest difference "
          f"{errs[worst]:.3e} ({names[worst]}; tol 1e-6) over the loss and "
          f"{len(errs) - 1} gradient leaves")
    check(max(errs) <= 1e-6, f"mesh path at local_mesh() vs plain path: {errs}")
    return errs[worst]


def single_process_loss(run: "dryrun.Run", params, tokens) -> float:
    """The CPU loss_fn of one process. On a mesh with sp > 1 an MoE layer
    routes each sp shard of the sequence alone (capacity and positions
    counted within it, over the whole batch), as the reference does inside
    its sp shard_map, so here each slice of the sequence goes through
    moe_apply alone."""
    moe_apply, sp = tfm.moe_mod.moe_apply, run.mesh.sp

    def per_shard(p, x, *args):
        return torch.cat([moe_apply(p, c, *args) for c in x.chunk(sp, dim=1)], dim=1)

    tfm.moe_mod.moe_apply = per_shard
    try:
        with torch.no_grad():
            return tfm.loss_fn(params, tokens, run.model).item()
    finally:
        tfm.moe_mod.moe_apply = moe_apply


def parallel_gloo_dryrun() -> None:
    """The reference's 8-device dry run on 8 gloo ranks of this machine's
    CPU, each first-step loss against the single-process CPU loss_fn."""
    t0 = time.perf_counter()
    results = dryrun.dryrun_multichip(8, "cpu")
    for run, res in zip(dryrun.runs(8), results):
        want = single_process_loss(run, *dryrun.inputs(run, "cpu"))
        err = abs(res["losses"][0] - want)
        print(f"parallel gloo dry run {run.mesh}: loss {res['losses'][0]:.6f}, single process "
              f"{want:.6f}, difference {err:.2e} (tol 1e-5)")
        check(err <= 1e-5, f"gloo dry run {run.mesh}: {res['losses'][0]} vs {want}")
    print(f"parallel gloo dry run: {time.perf_counter() - t0:.1f} s")


def phase_parallel(train_ms: float, train_tps: float) -> dict:
    t0 = time.perf_counter()
    out = parallel_nccl_train(train_ms, train_tps)
    out["local_mesh_err"] = parallel_local_mesh()
    parallel_gloo_dryrun()
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 5c. the training libraries: TorchTrainer, ElasticTrainer, Tune
# ---------------------------------------------------------------------------
def zero_launches() -> None:
    flash_attention_forward.launches = 0
    flash_attention_bwd_dq.launches = flash_attention_bwd_dkv.launches = 0


def read_launches() -> dict:
    return dict(fwd=flash_attention_forward.launches, dq=flash_attention_bwd_dq.launches,
                dkv=flash_attention_bwd_dkv.launches)


def trainer_loop(config):
    """A worker's loop: bench.py's train step for six steps (phase 5's
    seeds), a checkpoint after step 3 (params and the optimizer's state,
    and the losses so far), and on the first attempt a failure after step 4."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint

    ctx = train.get_context()
    dev = torch.device(config["device"])
    cfg = tfm.ModelConfig(**config["model"])
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(40), dev)
    leaves = [x.requires_grad_() for x in tfm.param_leaves(params)]
    opt = torch.optim.Adam(leaves, lr=3e-4)
    step = tfm.make_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (config["batch"], config["seq"]),
                           generator=torch.Generator(device=dev).manual_seed(41), device=dev)
    restore = ctx.get_checkpoint()
    losses, info = [], {}
    timing = os.path.join(ctx.trial_dir, "checkpoint_write.json")
    if restore is not None:
        with open(timing) as f:
            info.update(json.load(f))  # the first attempt's write
        t0 = time.perf_counter()
        state = restore.load_state()
        with torch.no_grad():
            for p, v in zip(leaves, tfm.param_leaves(state["params"])):
                p.copy_(v)
        opt.load_state_dict(state["opt"])
        losses = list(state["losses"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        info["restore_s"] = time.perf_counter() - t0
    for s in range(len(losses) + 1, 7):
        t0 = time.perf_counter()
        losses.append(step(params, tokens).item())  # the read waits for the step
        step_s = time.perf_counter() - t0
        ckpt = None
        if s == 3:
            t0 = time.perf_counter()
            ckpt = Checkpoint.from_state(
                {"params": params, "opt": opt.state_dict(), "losses": losses},
                os.path.join(ctx.trial_dir, f"checkpoint_{s:06d}"))
            info["write_s"] = time.perf_counter() - t0
            info["bytes"] = sum(f.stat().st_size for f in os.scandir(ckpt.path))
            with open(timing, "w") as f:
                json.dump(info, f)
        # Adam's step counts are host scalars by torch's design (not
        # capturable); every tensor the step reads or writes is checked
        held = leaves + [tokens] + [v for st in opt.state.values() for k, v in st.items()
                                    if k != "step"]
        train.report({"step": s, "loss": losses[-1], "losses": list(losses), "step_s": step_s,
                      "on_device": all(x.device.type == dev.type for x in held),
                      "restored": restore is not None, **info}, checkpoint=ckpt)
        if s == 4 and restore is None:
            raise RuntimeError("injected failure after step 4")


def phase_trainer(want_losses, device: str = "cuda", model=None, batch: int = 8,
                  seq: int = 1024) -> dict:
    """``TorchTrainer`` on the local runtime with its scheduler on the card:
    one worker trains bench.py's configuration (phase 5's seeds), fails
    after step 4, restores step 3's checkpoint and runs steps 4-6. Its six
    losses must equal phase 5's first six bit for bit."""
    import shutil
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig, TorchTrainer

    _platform_env(device)
    model = dict(TRAIN_CFG if model is None else model)
    t0 = time.perf_counter()
    storage = tempfile.mkdtemp(prefix="ray_tpu_torch_trainer_")
    rtt.init(num_nodes=1, resources_per_node={"CPU": 4.0, "GPU": 1.0})
    try:
        zero_launches()
        result = TorchTrainer(
            trainer_loop,
            train_loop_config=dict(model=model, device=device, batch=batch, seq=seq),
            # a GPU lease exports CUDA_VISIBLE_DEVICES to the worker
            scaling_config=ScalingConfig(num_workers=1,
                                         resources_per_worker={"CPU": 1.0, "GPU": 1.0}),
            run_config=RunConfig(name="phase-trainer", storage_path=storage,
                                 failure_config=FailureConfig(max_failures=1)),
        ).fit()
        launches = read_launches()
    finally:
        rtt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    check(result.error is None, f"trainer: {result.error!r}")
    hist = result.metrics_history
    m = result.metrics
    losses = m["losses"]
    print(f"trainer TorchTrainer bench.py config B={batch} T={seq} on "
          f"{'; '.join(card_line().splitlines())}: losses {['%.4f' % x for x in losses]}; "
          f"checkpoint {m['bytes'] / 2**30:.3f} GiB written in {m['write_s']:.2f} s "
          f"(attempt 1), restored in {m['restore_s']:.2f} s; steps 4-6 after the restore "
          f"{', '.join('%.2f' % (h['step_s'] * 1e3) for h in hist)} ms; launches over 7 step runs: "
          f"flash fwd {launches['fwd']}, dq {launches['dq']}, dkv {launches['dkv']}; "
          f"{time.perf_counter() - t0:.1f} s")
    check([h["step"] for h in hist] == [4, 5, 6] and all(h["restored"] for h in hist),
          f"trainer: the second attempt reported {[h['step'] for h in hist]}, not a restore "
          f"of step 3 running steps 4-6")
    check(all(h["on_device"] for h in hist), f"trainer: a tensor of the loop was off {device}")
    same = [a == b for a, b in zip(losses, want_losses[:6])]
    print(f"trainer losses against phase 5's first six: {sum(same)}/6 bit-equal")
    check(len(losses) == 6 and all(same),
          f"trainer losses {losses} differ from phase 5's {want_losses[:6]}")
    layers = tfm.ModelConfig(**model).n_layers * 7
    check(launches == dict(fwd=2 * layers, dq=layers, dkv=layers),
          f"trainer launches {launches}, expected fwd {2 * layers}, dq/dkv {layers}")
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


def _median_rate(walls: dict, lo: int, hi: int) -> float:
    """bench.py's elastic_train_bench: steps/s from the median step gap."""
    deltas = sorted(d for d in (walls[s + 1] - walls[s] for s in range(lo, hi - 1)
                                if s in walls and s + 1 in walls) if d > 0)
    return 1.0 / deltas[len(deltas) // 2] if deltas else 0.0


ELASTIC_CONFIG = dict(model=dict(dtype="bfloat16"), seed=60, batch=2, seq=512, lr=3e-4)


def phase_elastic_train(device: str = "cuda", total_steps: int = 40, model=None) -> dict:
    """bench.py's elastic_train_bench on the port's ``Cluster`` (the head on
    the card, two agents sharing the card): a 2-rank STRICT_SPREAD gang of
    ``ElasticTrainer`` trains ``ModelConfig()`` (bf16, Adam, its moments
    sealed ZeRO-style over 4 virtual shards, a seal every 2 steps); the node
    hosting rank 1 is killed at step total/3, a node joins once the shrink
    has landed, and the gang grows back. The state, the moments and every
    step's loss must equal this process's own run of the same steps bit for
    bit, with no disk restore."""
    import threading

    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.train import ElasticConfig, ElasticTrainer, programs, pytree

    _platform_env(device)
    old_env = os.environ.get("RAY_TPU_HEALTH_TIMEOUT_S")
    os.environ["RAY_TPU_HEALTH_TIMEOUT_S"] = "2.0"  # bench.py's
    config = dict(ELASTIC_CONFIG, device=device)
    if model is not None:
        config["model"] = dict(model)
    gpu = {"GPU": 1.0} if device == "cuda" else {}
    # a node's arena holds its rank's seals (params and half the moments, 180
    # MB at ModelConfig()) of the ~10 waves the driver keeps alive, as many
    # buddy copies of the other rank's, and the hub's partials in flight
    # (540 MB a step): ~4.5 GB, where the default arena is 256 MiB
    node = dict(num_workers=2, store_capacity=8 << 30)
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    import logging

    # the driver's generation log (placements, drains, reshapes and why a
    # rank broke) goes to this run's output
    el_log = logging.getLogger("ray_tpu_torch.train.elastic")
    el_handler = logging.StreamHandler(sys.stdout)
    el_handler.setFormatter(logging.Formatter("elastic log %(relativeCreated).0f ms: %(message)s"))
    el_log.addHandler(el_handler)
    el_log.setLevel(logging.DEBUG)
    c = _cluster(device)
    stop_watch = threading.Event()

    def watch(trainer):
        """Every 20 s: the gang's progress and each node's arena use."""
        while not stop_watch.wait(20.0):
            arenas = []
            for nid, rpc in list(c.head._clients.items()):
                try:
                    st = rpc.call("DebugState", timeout=10.0)["store"]
                    arenas.append(f"{nid[:7]} {st.get('used', 0) / 2**20:.0f} MiB "
                                  f"{st.get('num_objects')} objects")
                except Exception as exc:  # noqa: BLE001 - a dead node
                    arenas.append(f"{nid[:7]} {type(exc).__name__}")
            print(f"elastic progress {trainer.progress()}: {'; '.join(arenas)}", flush=True)

    try:
        c.add_node({"CPU": 2.0, **gpu}, **node)
        c.add_node({"CPU": 2.0, **gpu}, **node)
        client = c.client()
        set_runtime(client)
        try:
            trainer = ElasticTrainer(
                programs.lm_init, programs.lm_step, total_steps=total_steps,
                train_loop_config=config,
                elastic_config=ElasticConfig(
                    min_workers=1, max_workers=2, virtual_shards=4, seal_interval_steps=2,
                    elastic_shard_rules=(r"^opt/",), grow=True,
                    placement_strategy="STRICT_SPREAD",
                    resources_per_worker={"CPU": 1.0, **gpu}))
            box = {}

            def fit():
                try:
                    box["res"] = trainer.fit()
                except BaseException as exc:  # noqa: BLE001 - reported below
                    box["exc"] = exc

            th = threading.Thread(target=fit, name="elastic-fit")
            th.start()
            threading.Thread(target=watch, args=(trainer,), daemon=True,
                             name="elastic-watch").start()
            kill_at = max(6, total_steps // 3)
            deadline = time.monotonic() + 300
            while (trainer.progress()["step"] < kill_at and time.monotonic() < deadline
                   and th.is_alive()):
                time.sleep(0.1)
            check("exc" not in box, f"elastic: fit raised {box.get('exc')!r}")
            gangs = client.head.call("QueryState", {"kind": "gangs"})
            victim = gangs.get(trainer.gang_id, {"members": {}})["members"].get("1")
            check(bool(victim), f"elastic: no node for rank 1 ({gangs.get(trainer.gang_id)})")
            t_kill = time.monotonic()
            c.kill_node(victim)
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and th.is_alive():
                if any(r["direction"] == "shrink" for r in trainer.reshape_log):
                    break
                time.sleep(0.2)
            shrink_s = time.monotonic() - t_kill
            c.add_node({"CPU": 2.0, **gpu}, **node)
            th.join(timeout=600)
            check(not th.is_alive(), "elastic: fit() did not finish")
            check("exc" not in box, f"elastic: fit raised {box.get('exc')!r}")
            res = box["res"]
            check(res.error is None, f"elastic: {res.error!r}")
            final = trainer.final_state()
        finally:
            set_runtime(None)
            try:
                client.shutdown()
            except Exception:  # noqa: BLE001
                pass
    finally:
        stop_watch.set()
        el_log.removeHandler(el_handler)
        c.shutdown()
        errors.close()
        if old_env is None:
            os.environ.pop("RAY_TPU_HEALTH_TIMEOUT_S", None)
        else:
            os.environ["RAY_TPU_HEALTH_TIMEOUT_S"] = old_env
    cluster_s = time.perf_counter() - t0
    hist = res.metrics_history
    el = res.metrics["elastic"]
    reshapes = [(r["direction"], r["from_world"], r["to_world"]) for r in el["reshapes"]]
    shrinks = [r for r in el["reshapes"] if r["direction"] == "shrink"]
    grows = [r for r in el["reshapes"] if r["direction"] == "grow"]
    walls = {m["step"]: m["wall"] for m in hist}
    kill_step = shrinks[0]["resume_step"] if shrinks else kill_at
    post = grows[-1]["resume_step"] + 1 if grows else kill_step + 1
    rate_pre, rate_post = _median_rate(walls, 2, kill_step), _median_rate(walls, post, total_steps)
    seal_bytes = max(m["seal_bytes"] for m in hist)
    seal_ms = [m["seal_ms_sum"] / m["seals"] for m in hist if m["seals"]]
    # each step's launches, per virtual shard, made by the rank that owned
    # the shard and summed through the gang's own allreduce
    gang_launches = {k: sum(row[k] for m in hist for row in m["launches"])
                     for k in ("fwd", "dq", "dkv")}
    # the same steps in this process, every shard's partial from the same
    # kernels, summed in ascending shard order, then the same update
    zero_launches()
    t1 = time.perf_counter()
    want, want_losses = programs.lm_reference(config, total_steps, 4)
    launches = read_launches()
    ref_s = time.perf_counter() - t1
    got_leaves, want_leaves = pytree.leaves(final), pytree.leaves(want)
    equal = sum(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got_leaves, want_leaves))
    losses = [m["loss"] for m in hist]
    print(f"elastic ElasticTrainer ModelConfig() bf16, 2 x STRICT_SPREAD ranks, 4 virtual "
          f"shards x B={config['batch']} T={config['seq']}, {total_steps} steps on "
          f"{'; '.join(card_line().splitlines())}: reshapes {reshapes}, disk restores "
          f"{el['disk_restores']}; step rate {rate_pre:.3f}/s before the kill, "
          f"{rate_post:.3f}/s after the grow-back, elastic_step_retention_pct "
          f"{100.0 * rate_post / rate_pre if rate_pre else 0.0:.1f}; shrink detected "
          f"{shrink_s:.2f} s after the kill; seals {seal_bytes / 2**20:.1f} MiB by the "
          f"reporting rank, {np.mean(seal_ms) if seal_ms else 0.0:.1f} ms a seal; "
          f"{cluster_s:.1f} s on the cluster")
    print(f"elastic against one process ({ref_s:.1f} s; launches flash fwd {launches['fwd']}, "
          f"dq {launches['dq']}, dkv {launches['dkv']}): {equal}/{len(want_leaves)} state leaves "
          f"bit-equal, {sum(a == b for a, b in zip(losses, want_losses))}/{total_steps} losses "
          f"bit-equal; first/last loss {losses[0]:.4f}/{losses[-1]:.4f}; the gang's own launches "
          f"over the {len(hist)} steps kept: flash fwd {gang_launches['fwd']}, dq "
          f"{gang_launches['dq']}, dkv {gang_launches['dkv']}")
    errors.check("elastic train")
    check([m["step"] for m in hist] == list(range(total_steps)),
          f"elastic: steps {[m['step'] for m in hist]} are not 0..{total_steps - 1}")
    check(el["disk_restores"] == 0, f"elastic: {el['disk_restores']} disk restores")
    check(reshapes == [("shrink", 2, 1), ("grow", 1, 2)], f"elastic: reshapes {reshapes}")
    check(len(got_leaves) == len(want_leaves) == equal,
          f"elastic: {equal} of {len(want_leaves)} state leaves equal the one-process run")
    check(losses == want_losses, f"elastic: losses {losses} vs one process {want_losses}")
    check(losses[-1] < losses[0], f"elastic: loss did not fall {losses}")
    check(seal_bytes > 0, f"elastic: the ranks sealed {seal_bytes} bytes")
    check(device != "cuda" or all(m["copied_frames"] > 0 for m in hist if m["seals"]),
          f"elastic: a rank that sealed wrote no CUDA frame: {[m['copied_frames'] for m in hist]}")
    check(all(x.device.type == device for x in got_leaves),
          f"elastic: a regathered leaf is not on {device}")
    check(all(m["device"].startswith(device) for m in hist),
          f"elastic: a rank trained off {device}: {sorted({m['device'] for m in hist})}")
    n_layers = programs.model_config(config).n_layers
    per_shard = [dict(fwd=n_layers, dq=n_layers, dkv=n_layers)] * 4
    wrong = [(m["step"], m["world"], m["launches"]) for m in hist if m["launches"] != per_shard]
    check(not wrong, f"elastic: steps whose shards did not each launch flash fwd, dq and dkv "
          f"{n_layers} times (step, world, per shard): {wrong}")
    passes = total_steps * 4 * n_layers
    check(gang_launches == dict(fwd=passes, dq=passes, dkv=passes),
          f"elastic gang launches {gang_launches}, expected {passes} each")
    check(launches == dict(fwd=passes, dq=passes, dkv=passes),
          f"elastic one-process launches {launches}, expected {passes} each")
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


def tune_trainable(config):
    """One trial: ``ModelConfig()`` from the same seed at the trial's
    learning rate, B=4, T=512, one Adam step an iteration."""
    from ray_tpu_torch import tune

    dev = torch.device(config["device"])
    cfg = tfm.ModelConfig(**config.get("model", {}))
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(50), dev)
    opt = torch.optim.Adam([x.requires_grad_() for x in tfm.param_leaves(params)],
                           lr=config["lr"])
    step = tfm.make_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512),
                           generator=torch.Generator(device=dev).manual_seed(51), device=dev)
    for it in range(8):
        tune.report({"loss": step(params, tokens).item(), "iteration": it,
                     "device": str(params["embed"].device)})


def phase_tune(device: str = "cuda", model=None) -> dict:
    """``Tuner`` over the card: a grid of four learning rates, 8 iterations
    each, under ASHA (max_t 8, grace 2, reduction 2). The trials run one at
    a time, so the flash launches they add are counted exactly, and ASHA's
    decisions follow from the losses alone: each trial stops where a fresh
    scheduler, handed the trials' losses in the same order, says STOP."""
    import ray_tpu_torch as rtt
    from ray_tpu_torch import tune

    def asha():
        return tune.ASHAScheduler(metric="loss", mode="min", max_t=8, grace_period=2,
                                  reduction_factor=2)

    _platform_env(device)
    t0 = time.perf_counter()
    rtt.init(num_nodes=1, resources_per_node={"CPU": 4.0, "GPU": 1.0})
    try:
        zero_launches()
        grid = tune.Tuner(
            tune_trainable,
            param_space={"lr": tune.grid_search([1e-4, 3e-4, 1e-3, 3e-2]),
                         "device": device, "model": dict(model or {})},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=1, scheduler=asha()),
        ).fit()
        launches = read_launches()
    finally:
        rtt.shutdown()
    rows = [(r.config["lr"], r.status, len(r.metrics_history), r.metrics.get("loss"),
             {m["device"] for m in r.metrics_history}) for r in grid]
    best = grid.get_best_result()
    lowest = min((r for r in grid if r.metrics), key=lambda r: r.metrics["loss"])
    its = sum(len(r.metrics_history) for r in grid)
    replay, want = asha(), {}
    for r in grid:
        state = tune.tuner._TrialState(trial_id=r.trial_id, config={})
        want[r.config["lr"]] = next(
            (it for it, m in enumerate(r.metrics_history, 1)
             if replay.on_result(state, m["loss"], it, it - 1) == "STOP"),
            len(r.metrics_history))
    print(f"tune ASHA over lr {[r[0] for r in rows]} on {'; '.join(card_line().splitlines())}: "
          + "; ".join(f"lr {lr:g} {st} after {n} iterations, last loss {loss:.4f}"
                      for lr, st, n, loss, _ in rows)
          + f"; best lr {best.config['lr']:g}; launches flash fwd {launches['fwd']}, dq "
          f"{launches['dq']}, dkv {launches['dkv']}; {time.perf_counter() - t0:.1f} s")
    print("tune losses by lr: " + "; ".join(
        f"{r.config['lr']:g} " + " ".join(f"{m['loss']:.4f}" for m in r.metrics_history)
        for r in grid))
    check(all(r.error is None for r in grid), f"tune: {[r.error for r in grid]}")
    check(all(devs and all(d.startswith(device) for d in devs) for *_, devs in rows),
          f"tune: a trial ran off {device}: {rows}")
    check(any(st == "STOPPED" for _, st, *_ in rows), f"tune: ASHA stopped no trial: {rows}")
    got = {lr: n for lr, _, n, *_ in rows}
    check(got == want, f"tune: iterations by lr {got}, where ASHA on the same losses stops "
          f"at {want}")
    check(got[3e-2] < 8 and all(got[lr] == 8 for lr in (1e-4, 3e-4, 1e-3)),
          f"tune: ASHA should stop lr 3e-2 early and no other trial: {got}")
    check(best.config["lr"] == 1e-3, f"tune: the best lr is {best.config['lr']:g}, not 1e-3")
    check(best.trial_id == lowest.trial_id, "tune: the best result is not the lowest last loss")
    n_layers = tfm.ModelConfig(**(model or {})).n_layers
    check(launches == dict(fwd=its * n_layers, dq=its * n_layers, dkv=its * n_layers),
          f"tune launches {launches}, expected {its * n_layers} each over {its} iterations")
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 5b. head_dim above 256, the dense-cache engine, MoE, disaggregated serving
# ---------------------------------------------------------------------------
def wide_fwd_timing(bh, t, d, seed):
    """The wide flash forward at one causal bf16 shape: error against the
    plain version, kernel, plain and SDPA ms, and the bound."""
    g = gen(seed)
    qg, kg, vg = (torch.randn(bh, t, d, generator=g, device=DEV).to(torch.bfloat16)
                  for _ in range(3))
    out, lse = flash_attention_forward(qg, kg, vg, True)
    ref_out, ref_lse = flash_attention_reference(qg, kg, vg, True)
    e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
    check(e_out <= 3e-2 and e_lse <= 1e-3, f"wide forward D={d}: {e_out}, {e_lse}")
    del ref_out, ref_lse
    ms = time_ms(lambda: flash_attention_forward(qg, kg, vg, True), iters=10)
    plain = time_ms(lambda: flash_attention_reference(qg, kg, vg, True), iters=3, warmup=1)
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qg[None], kg[None], vg[None], is_causal=True), iters=10)
    flops = 4.0 * d * bh * t * (t + 1) // 2
    bnd, by = bound_ms(nbytes(qg, kg, vg, out, lse), flops, torch.bfloat16)
    print(f"flash wide bf16 bh={bh} T={t} D={d} causal: out err {e_out:.3e} lse err "
          f"{e_lse:.3e}; kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {sdpa:.4f} ms, "
          f"bound {bnd:.4f} ms ({by})")
    return dict(shape=f"bh={bh} T={t} D={d} bf16 causal", max_abs_err=e_out, ms=ms,
                plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=sdpa)


def phase_wide_heads():
    """head_dim above 256: flash_attention pads 320 to 512 and runs the wide
    kernels (head_dim walked in 256-column chunks), forward and backward;
    the paged kernel's wide instance at 320 and 512; f32 and bf16, each
    against its plain version; then each timed at one bf16 shape."""
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        atol = 1e-4 if dtype == torch.float32 else 3e-2
        flash_case(f"{tag} GQA hd320 ragged causal T=100", 1, 100, 4, 2, 320, True, dtype,
                   atol, 51)
        flash_case(f"{tag} hd512 non-causal", 1, 192, 4, 4, 512, False, dtype, atol, 52)
        bwd_kernel_case(4, 192, 192, 512, True, dtype, 53)
        bwd_kernel_case(4, 128, 320, 512, False, dtype, 54)
        wrapper_bwd_case(f"{tag} GQA 4->2 hd320 ragged causal T=100", 1, 100, 4, 2, 320,
                         True, dtype, 55)
        wrapper_bwd_case(f"{tag} hd512", 1, 128, 2, 2, 512, True, dtype, 56)
        paged_atol = 2e-5 if dtype == torch.float32 else 2e-2
        paged_case(f"{tag} hd320 G4", paged_inputs(3, 2, 4, 320, 64, 16, 4, [50, 64, 1],
                                                   dtype, 57), 16, paged_atol)
        long_args = paged_inputs(4, 2, 2, 512, 4 * 126 + 1, 16, 126, [50, 2000, 49, 1],
                                 dtype, 58)
        out = paged_case(f"{tag} hd512 one slot 40x longer (n_split "
                         f"{paged_plan(long_args)[0]})", long_args, 16, paged_atol)
        check(torch.equal(out, paged_attention_decode(*long_args, page_size=16)),
              f"paged {tag} hd512: two launches differ")
    rows = dict(fwd=wide_fwd_timing(16, 1024, 512, 59))
    # SDPA's flash and cuDNN backwards stop at head_dim 256; its memory-efficient
    # backend takes D = 512 (dq, dk and dv in one call)
    bwd = bwd_timing(16, 1024, 512, 60, sdpa_backends=("EFFICIENT_ATTENTION",))
    for key in ("dq", "dkv"):
        rows[key] = dict(bwd[key], shape="bh=16 T=1024 D=512 bf16 causal")
    wide = paged_inputs(8, 4, 2, 512, 256, 16, 128, [128, 140, 113, 159, 97, 150, 131, 120],
                        torch.bfloat16, 61)
    err = max_err(paged_attention_decode(*wide, page_size=16),
                  paged_attention_reference(*wide, page_size=16))
    check(err <= 2e-2, f"paged wide engine shapes error {err}")
    rows["paged"] = dict(paged_timing("bf16 B=8 P_max=128 D=512", wide, 16, torch.bfloat16),
                         shape="B=8 KH=4 G=2 D=512 page 16 P_max=128 bf16", max_abs_err=err)
    print(f"wide heads phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return rows


def llm_decode_rate(eng, ps, gen_cfg):
    """(decode tokens/s, s for the whole call): generate_ids at gen_cfg
    against the same call with one new token (prefill and first sample
    only); both end in the engine's read-back."""
    one = GenerationConfig(max_new_tokens=1, temperature=gen_cfg.temperature,
                           top_k=gen_cfg.top_k, seed=gen_cfg.seed)
    t0 = time.perf_counter()
    eng.generate_ids(ps, one)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = eng.generate_ids(ps, gen_cfg)
    t_all = time.perf_counter() - t0
    steps = gen_cfg.max_new_tokens - 1
    return outs, len(ps) * steps / (t_all - t_one), t_all


def phase_llm_engine():
    """LLMEngine (dense KV cache) at ModelConfig()'s width: 8 greedy prompts
    and one stream at temperature 0.8 with top_k=40, decode tokens/s; f32
    greedy streams card == CPU; then ModelConfig(n_experts=4): the engine
    generates, forward at B=4, T=2048 launches the flash kernel, an f32 MoE
    forward card vs CPU, and a few MoE train steps through the flash
    forward and backward kernels."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tfm.ModelConfig()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), DEV)
    eng = LLMEngine(cfg, params)
    ps = prompts(cfg)
    eng.generate_ids([ps[0][:16]], GenerationConfig(max_new_tokens=4))  # warm-up
    greedy = GenerationConfig(max_new_tokens=64)
    outs, tps, wall = llm_decode_rate(eng, ps, greedy)
    check(all(len(o) == 64 for o in outs), f"LLMEngine lengths {[len(o) for o in outs]}")
    check(all(0 <= x < cfg.vocab_size for o in outs for x in o), "token out of vocab")
    top_k = GenerationConfig(max_new_tokens=64, temperature=0.8, top_k=40, seed=17)
    sampled, tps_k, _ = llm_decode_rate(eng, ps[:1], top_k)
    check(len(sampled[0]) == 64 and sampled[0] != outs[0], "top_k stream equals the greedy one")
    check(eng.generate_ids(ps[:1], top_k) == sampled, "top_k stream not reproducible")
    print(f"llm engine ModelConfig() 8 prompts x 96 tokens, 64 greedy tokens: {wall:.3f} s, "
          f"decode {tps:.1f} tokens/s; one stream at temperature 0.8 top_k 40: "
          f"{tps_k:.1f} tokens/s")

    cfg32 = tfm.ModelConfig(dtype=torch.float32)
    p32 = tfm.init_params(cfg32, torch.Generator().manual_seed(0), "cpu")
    short = GenerationConfig(max_new_tokens=32)
    on_card = LLMEngine(cfg32, p32).generate_ids(ps, short)
    on_cpu = LLMEngine(cfg32, p32, device="cpu").generate_ids(ps, short)
    same = sum(a == b for a, b in zip(on_card, on_cpu))
    print(f"llm engine f32 card vs CPU (allow_tf32=False): {same}/8 greedy streams "
          f"token-exact")
    check(same == len(ps), "LLMEngine f32 greedy streams differ between card and CPU")
    del eng, params, p32

    moe = tfm.ModelConfig(n_experts=4)
    pm = tfm.init_params(moe, torch.Generator().manual_seed(1), DEV)
    moe_outs, moe_tps, _ = llm_decode_rate(LLMEngine(moe, pm), ps, greedy)
    check(all(len(o) == 64 for o in moe_outs), "MoE LLMEngine lengths")
    tokens = torch.randint(0, moe.vocab_size, (4, 2048), generator=gen(1), device=DEV)
    flash_attention_forward.launches = 0
    logits = tfm.forward(pm, tokens, moe)
    torch.cuda.synchronize()
    moe_launches = flash_attention_forward.launches
    check(tuple(logits.shape) == (4, 2048, moe.vocab_size)
          and bool(torch.isfinite(logits).all()), "MoE forward logits")
    check(moe_launches > 0, "MoE forward did not launch the flash kernel")
    moe_ms = time_ms(lambda: tfm.forward(pm, tokens, moe), iters=3, warmup=1)
    del logits
    leaves = [x.requires_grad_() for x in tfm.param_leaves(pm)]
    step = tfm.make_train_step(moe, torch.optim.Adam(leaves, lr=1e-3))
    batch = tokens[:2, :513]
    flash_attention_forward.launches = 0
    flash_attention_bwd_dq.launches = flash_attention_bwd_dkv.launches = 0
    losses = [step(pm, batch).item() for _ in range(3)]
    train_launches = (flash_attention_forward.launches, flash_attention_bwd_dq.launches,
                      flash_attention_bwd_dkv.launches)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"MoE train losses {losses}")
    check(min(train_launches) > 0, f"MoE train step launches {train_launches}")
    print(f"llm engine MoE ModelConfig(n_experts=4): decode {moe_tps:.1f} tokens/s; forward "
          f"B=4 T=2048 {moe_ms:.2f} ms, flash launches {moe_launches}; 3 train steps B=2 "
          f"T=512 losses {['%.4f' % x for x in losses]}, launches fwd/dq/dkv {train_launches}")
    del pm, leaves, step
    torch.cuda.empty_cache()

    moe32 = tfm.ModelConfig(n_experts=4, dtype=torch.float32)
    p_cpu = tfm.init_params(moe32, torch.Generator().manual_seed(2), "cpu")
    tok = torch.randint(0, moe32.vocab_size, (1, 256), generator=torch.Generator().manual_seed(3))
    want = tfm.forward(p_cpu, tok, moe32)
    got = tfm.forward(tfm.params_to(p_cpu, DEV), tok.to(DEV), moe32).cpu()
    err = max_err(got, want)
    print(f"llm engine MoE f32 forward B=1 T=256 card vs CPU: max_abs_err {err:.3e} "
          f"(atol 1e-3)")
    check(err <= 1e-3, f"MoE f32 forward card vs CPU error {err}")
    print(f"llm engine phase: {time.perf_counter() - t0:.1f} s")
    return dict(tps=tps, tps_top_k=tps_k, moe_tps=moe_tps, moe_forward_ms=moe_ms)


def phase_llm_disagg():
    """The hand-off, the prefix cache and the weights swap of the continuous
    engine at ModelConfig()'s width in f32 (TF32 off), the device plane on:
    prefill_extract hands CUDA tensors that seal as device frames into a
    NativeObjectStore and land back on the card; adopt_pages decodes them
    token-exact with a monolithic engine with no prefill; engine A publishes
    a prefix that engine B hits; swap_params fences epochs, retags the
    cache and force-evicts a wedged slot at its drain deadline."""
    import tempfile

    from ray_tpu_torch.cluster import device_plane as dp
    from ray_tpu_torch.cluster import serialization as wire
    from ray_tpu_torch.native.shm_store import NativeObjectStore
    from ray_tpu_torch.serve.admission import Overloaded
    from ray_tpu_torch.serve.prefix_cache import SharedPrefixCache

    t0 = time.perf_counter()
    os.environ["RAY_TPU_DEVICE_PLANE"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tfm.ModelConfig(dtype=torch.float32)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), DEV)
    # 90 tokens: a prompt publishes its 5 full pages of 16, and a lookup
    # may restore up to the page before its last token, so 5 pages too
    ps = [p[:90] for p in prompts(cfg, n=3)]
    engines = []

    def engine(p=params, **kw):
        engines.append(ContinuousBatchingEngine(cfg, p, **kw))
        return engines[-1]

    store = NativeObjectStore(path=os.path.join(
        tempfile.gettempdir(), f"ray_tpu_torch_smoke_{os.getpid()}.shm"), capacity=256 << 20)
    try:
        # 1. the hand-off through device frames
        sampled = GenerationConfig(max_new_tokens=32, temperature=0.8, seed=9)
        want = list(engine().stream_ids(ps[0], sampled))
        pre, dec = engine(), engine()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        manifest, k, v = pre.prefill_extract(ps[0], sampled)
        torch.cuda.synchronize()
        t_extract = time.perf_counter() - t1
        check(k.is_cuda and v.is_cuda, "prefill_extract handed host blocks with the plane on")
        seals = dp.device_stats()["device_frame_seals_total"]
        t1 = time.perf_counter()
        parts, total = wire.dumps_parts((manifest, k, v))
        store.put_frames("handoff" + "0" * 21, parts)
        t_seal = time.perf_counter() - t1
        check(dp.device_stats()["device_frame_seals_total"] == seals + 2,
              "the hand-off's blocks did not seal as device frames")
        t1 = time.perf_counter()
        with dp.landing("device"):
            m2, k2, v2 = wire.loads(store.get_view("handoff" + "0" * 21))
        torch.cuda.synchronize()
        t_land = time.perf_counter() - t1
        check(k2.is_cuda and torch.equal(k2, k) and torch.equal(v2, v),
              "the hand-off did not land on the card equal")
        paged_attention_decode.launches = 0
        rid = dec.adopt_pages(m2, k2, v2)
        got = list(dec.stream_rid(rid))
        launches = paged_attention_decode.launches
        check(got == want, "adopted stream differs from the monolithic one")
        check(dec.full_prefill_count == 0 and dec.adopted_count == 1,
              f"decode engine stats {dec.stats()}")
        check(launches > 0, "adopted decode did not launch the paged kernel")
        print(f"llm disagg hand-off f32 90-token prompt ({total} bytes sealed): extract "
              f"{t_extract * 1e3:.2f} ms, seal+put {t_seal * 1e3:.2f} ms, land "
              f"{t_land * 1e3:.2f} ms; adopted stream == monolithic (32 tokens), "
              f"full prefills 0, adopted 1, paged launches {launches}")

        # 2. the prefix cache: engine A publishes, engine B hits
        cache = SharedPrefixCache(store, page_size=16, model_sig="smoke")
        greedy = GenerationConfig(max_new_tokens=32)
        a = engine(prefix_cache=cache)
        seals = dp.device_stats()["device_frame_seals_total"]
        want_a = a.generate_ids([ps[1]], greedy)[0]
        check(cache.inserts == 1 and dp.device_stats()["device_frame_seals_total"] > seals,
              "engine A's prefix did not go in as device frames")
        hit = cache.lookup(ps[1] + [5])
        check(hit is not None and hit.on_device(), "the prefix hit did not land on the card")
        hit.release()
        b = engine(prefix_cache=cache)
        paged_attention_decode.launches = 0
        got_b = b.generate_ids([ps[1]], greedy)[0]
        longer = ps[1] + ps[2][:40]
        got_long = b.generate_ids([longer], greedy)[0]
        launches_b = paged_attention_decode.launches
        check(got_b == want_a, "engine B's prefix-hit stream differs from engine A's")
        check(b.full_prefill_count == 0 and cache.hits >= 2,
              f"engine B stats {b.stats()}")
        check(got_long == engine().generate_ids([longer], greedy)[0],
              "the longer prompt's prefix-hit stream differs from a full prefill's")
        check(launches_b > 0, "the decode after a prefix hit did not launch the paged kernel")
        print(f"llm disagg prefix cache: B hit A's 80-token prefix (hits {cache.hits}, "
              f"inserts {cache.inserts}), full prefills 0, streams equal, paged launches "
              f"{launches_b}")

        # 3. weights swap: drain on the old epoch, queue on the new, retag
        alt = tfm.init_params(cfg, torch.Generator().manual_seed(5), DEV)
        short = GenerationConfig(max_new_tokens=16)
        want_old = engine().generate_ids([ps[0]], short)[0]
        want_new = engine(alt).generate_ids([ps[0]], short)[0]
        swap_cache = SharedPrefixCache(store, page_size=16, model_sig="swap")
        eng = engine(prefix_cache=swap_cache)
        rid_a = eng.submit(ps[0], short)
        eng.step()
        rid_b = eng.submit(ps[0], short)  # queued behind the swap
        check(eng.swap_params(alt, model_id="alt") == 1, "weights_epoch did not bump")
        check(eng.results.pop(rid_a) == want_old, "the drained stream crossed weights")
        while rid_b not in eng.results:
            eng.step()
        check(eng.results.pop(rid_b) == want_new, "the queued request missed the new weights")
        check(swap_cache.model_sig == "swap|alt", "the cache was not retagged")
        # the queued request's prompt was published under the old weights
        # by the first: after the retag it missed and prefilled in full
        check(eng.full_prefill_count == 2, "a stale prefix hit after the swap")
        os.environ["RAY_TPU_SERVE_SWAP_DRAIN_DEADLINE_S"] = "0.0001"
        try:
            wedged = eng.submit(ps[1], GenerationConfig(max_new_tokens=200))
            eng.step()
            eng.step()
            eng.swap_params(params, model_id="base")
            partial = eng.results.pop(wedged)
            check(eng.swap_force_evicted == 1 and 0 < len(partial) < 200,
                  f"drain deadline: evicted {eng.swap_force_evicted}, {len(partial)} tokens")
            eng._swapping, eng._swap_started = True, time.monotonic() - 10.0
            try:
                eng.submit(ps[1], short)
                fail("an expired drain did not shed the submit")
            except Overloaded as e:
                check(e.reason == "weights_swap", f"shed reason {e.reason}")
            finally:
                eng._swapping, eng._swap_started = False, None
        finally:
            del os.environ["RAY_TPU_SERVE_SWAP_DRAIN_DEADLINE_S"]
        print(f"llm disagg swap: in-flight finished on epoch 0, queued admitted on epoch 1, "
              f"cache retagged ({swap_cache.model_sig}), drain deadline evicted 1 slot at "
              f"{len(partial)} tokens and shed the next submit")
        leaked = [e.pool.usable_pages - e.pool.free_pages for e in engines]
        check(not any(leaked), f"pages leaked: {leaked}")
    finally:
        store.close(unlink=True)
    print(f"llm disagg phase: {time.perf_counter() - t0:.1f} s")
    return dict(extract_ms=t_extract * 1e3, seal_ms=t_seal * 1e3, land_ms=t_land * 1e3)


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


# --- the multi-process cluster (head rounds on the card, agents, workers) ---

SCHED_HISTS = ("round_ms", "upload_ms", "kernel_ms", "readback_ms")


def _sched_hists():
    from ray_tpu_torch.cluster.head import SCHED_ROUND_MS
    from ray_tpu_torch.scheduler.device import (
        SCHED_KERNEL_MS,
        SCHED_READBACK_MS,
        SCHED_UPLOAD_MS,
    )

    return dict(zip(SCHED_HISTS, (SCHED_ROUND_MS, SCHED_UPLOAD_MS, SCHED_KERNEL_MS,
                                  SCHED_READBACK_MS)))


def _hist_marks():
    return {k: (h.summary()["count"], h.summary()["sum"], h.buckets_snapshot())
            for k, h in _sched_hists().items()}


def _cluster(device: str, **kwargs):
    """A ``Cluster`` whose head state is on ``device``; checks the state and
    that every round goes to the device (``sched_device_min_batch`` 0)."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.config import cfg

    c = Cluster(**kwargs)
    check(c.head.device_state is not None and c.head.device_state.device.type == device,
          f"cluster: the head's scheduler state is not on {device}")
    check(cfg.sched_device_min_batch == 0,
          f"cluster: sched_device_min_batch is {cfg.sched_device_min_batch}, not 0")
    return c


def _trace_leases():
    """Traces the client's lease cache by wrapping ``_TaskLeaseManager``'s
    and ``_TaskLeaseChannel``'s methods (nothing changes in the package):
    each grant request's RPC time and answer, each miss by the state of
    its shape's leases at that moment, and each lease's age when it is
    dropped (idle TTL, stall or failure). Returns (stats, restore)."""
    from ray_tpu_torch.cluster import client as C

    mgr, chan = C._TaskLeaseManager, C._TaskLeaseChannel
    saved = (mgr.submit, mgr._grant, mgr._drop_channel, chan.__init__)
    stats = {"grant_ms": [], "requests": 0, "granted": 0, "misses": {}, "ages": [],
             "drops": {}, "born": {}, "ttl": set()}

    def submit(self, item, shape_key):
        ok = saved[0](self, item, shape_key)
        if not ok:
            ent = self._shapes.get(shape_key)
            live = [c for c in (ent or {}).get("channels", []) if not c.dead]
            if ent is None:
                why = "stopped"
            elif not live:
                why = ("grant in flight" if ent["granting"] else
                       "cooldown" if time.monotonic() < ent["cooldown_until"] else "warm-up")
            elif not any(c.accepting() for c in live):
                why = "leases stalled"
            else:
                why = "leases full"
            stats["misses"][why] = stats["misses"].get(why, 0) + 1
        return ok

    def grant(self, shape_key, resources, fn_id):
        t0 = time.perf_counter()
        try:
            return saved[1](self, shape_key, resources, fn_id)
        finally:
            stats["requests"] += 1
            stats["grant_ms"].append((time.perf_counter() - t0) * 1e3)

    def drop(self, shape_key, ch):
        born = stats["born"].pop(id(ch), None)
        if born is not None:
            stats["ages"].append(time.monotonic() - born)
            callers, f = set(), sys._getframe(1)
            while f is not None:
                callers.add(f.f_code.co_name)
                f = f.f_back
            why = ("failed over" if "_fail_over" in callers else
                   "stopped" if "stop" in callers else "idle for its TTL")
            stats["drops"][why] = stats["drops"].get(why, 0) + 1
        return saved[2](self, shape_key, ch)

    def init(self, *a, **k):
        saved[3](self, *a, **k)
        stats["granted"] += 1
        stats["born"][id(self)] = time.monotonic()
        stats["ttl"].add(self.ttl)

    mgr.submit, mgr._grant, mgr._drop_channel, chan.__init__ = submit, grant, drop, init

    def restore():
        mgr.submit, mgr._grant, mgr._drop_channel, chan.__init__ = saved

    return stats, restore


def _pcts(xs, scale=1.0):
    """'p50/p99' of ``xs`` (or 'none')."""
    if not len(xs):
        return "none"
    a = np.asarray(xs, dtype=np.float64) * scale
    return f"{np.percentile(a, 50):.3f}/{np.percentile(a, 99):.3f}"


def cluster_burst(label: str, device: str, num_tasks: int = 10_000, passes: int = 2):
    """bench.py's ``cluster_bench``, unchanged in shape: a head, two agents
    of 16 CPUs with 4 workers each, 50 warm-up tasks, then ``passes`` passes
    of ``num_tasks`` no-op tasks at num_cpus=0.25, gathered 500 at a time.
    Under task leases most of a pass streams to cached worker leases and
    never reaches the head, so the head's rounds are printed beside the
    tasks/s: those tasks/s are not the card's."""
    import ray_tpu_torch as rtt
    from ray_tpu_torch.core.runtime import set_runtime

    c = _cluster(device)
    marks = _hist_marks()  # the head's rounds of this cluster, warm-up included
    leases, untrace = _trace_leases()
    try:
        c.add_node({"CPU": 16.0}, num_workers=4)
        c.add_node({"CPU": 16.0}, num_workers=4)
        client = c.client()
        set_runtime(client)
        try:
            f = rtt.remote(_noop).options(num_cpus=0.25, max_retries=0)
            check(rtt.get([f.remote() for _ in range(50)], timeout=120) == [None] * 50,
                  f"cluster {label}: a warm-up task returned a value")
            hits0 = client.metrics["lease_cache_hits"]
            misses0 = client.metrics["lease_cache_misses"]
            rates, rounds = [], []
            for _ in range(passes):
                r0 = c.head.metrics["sched_rounds"]
                t0 = time.perf_counter()
                refs = [f.remote() for _ in range(num_tasks)]
                for i in range(0, num_tasks, 500):
                    check(rtt.get(refs[i:i + 500], timeout=300) == [None] * len(refs[i:i + 500]),
                          f"cluster {label}: a no-op task returned a value")
                rates.append(num_tasks / (time.perf_counter() - t0))
                rounds.append(c.head.metrics["sched_rounds"] - r0)
            sched = c.head._h_query_state({"kind": "sched"})
            hists = _sched_hists()
            lat = {k: hist_delta(hists[k], marks[k]) for k in SCHED_HISTS}
            n_obs = {k: hists[k].summary()["count"] - marks[k][0] for k in SCHED_HISTS}
            hits = client.metrics["lease_cache_hits"] - hits0
            misses = client.metrics["lease_cache_misses"] - misses0
            print(f"cluster {label}: tasks/s " + ", ".join(
                f"pass {i + 1} {r:.1f} ({n} head rounds)"
                for i, (r, n) in enumerate(zip(rates, rounds)))
                + f"; lease cache hits {hits}, misses {misses} over the passes; head "
                f"sched_rounds {sched['sched_rounds']} in all, device rounds "
                f"{(sched['device'] or {}).get('rounds')}, ring rounds "
                f"{(sched['device'] or {}).get('ring_rounds')}")
            print(f"cluster {label} head rounds' latency, warm-up and passes (ms, p50/p99 over "
                  f"n): " + "; ".join(f"{k} {p50:.3f}/{p99:.3f} over {n_obs[k]}"
                                      for k, (_, p50, p99) in lat.items()))
            print(f"cluster {label} leases, warm-up and passes: {leases['requests']} grant "
                  f"requests, {leases['granted']} granted, grant RPC ms p50/p99 "
                  f"{_pcts(leases['grant_ms'])}; misses by the state of their shape's leases "
                  f"{dict(sorted(leases['misses'].items()))}; {len(leases['ages'])} leases "
                  f"dropped at age s p50/p99 {_pcts(leases['ages'])} "
                  f"{dict(sorted(leases['drops'].items()))}, "
                  f"{len(leases['born'])} live at the end; lease TTL s {sorted(leases['ttl'])}")
            return rates, rounds, hits, misses
        finally:
            set_runtime(None)
            client.shutdown()
    finally:
        untrace()
        c.shutdown()


def _record_ring_rounds():
    """As ``_record_rounds``, for the parked-demand ring's program (the
    head's unpark rounds): each call's inputs and all four outputs kept on
    the host, with the program's time (dispatch to its outputs on the host)
    and the number of slots it walked; returns (records, impl, restore)."""
    from ray_tpu_torch.scheduler import hybrid as H

    impl = H.ring_schedule_impl
    records = []

    def host(x):
        return x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x

    def _recorded(*args, **kwargs):
        t0 = time.perf_counter()
        res = impl(*args, **kwargs)
        outs = [host(t) for t in res]  # the caller reads them back next anyway
        ms = (time.perf_counter() - t0) * 1e3
        walked = kwargs.get("slots")
        records.append(([host(a) for a in args], {k: host(v) for k, v in kwargs.items()},
                        outs, ms, len(walked) if walked is not None else int(res[0].shape[0])))
        return res

    H.ring_schedule_impl = _recorded

    def restore():
        H.ring_schedule_impl = impl

    return records, impl, restore


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _dot64(a, b):
    return float(np.dot(a.astype(np.float64), b.astype(np.float64)))


def _sum64(a):
    return a.shape, a.dtype.str, float(a.astype(np.float64).sum()), bool(a.flags.writeable)


def _node_of():

    return os.environ.get("RAY_TPU_NODE_ID")


def _payload(i, n):
    return bytes([i % 251]) * n


def _gpu_product(seed, n):
    """In a worker: the lease's CUDA_VISIBLE_DEVICES, whether CUDA was
    initialised before this task (the zygote and the worker must not touch
    it), and a seeded f32 product computed on the card."""

    import torch as th

    before = th.cuda.is_initialized()
    g = th.Generator().manual_seed(seed)
    a, b = th.randn(n, n, generator=g), th.randn(n, n, generator=g)
    out = (a.to("cuda") @ b.to("cuda")).cpu().numpy()
    return before, os.environ.get("CUDA_VISIBLE_DEVICES"), th.cuda.get_device_name(0), out


class _Ordered:
    def __init__(self):
        self.seen = []

    def push(self, i):
        self.seen.append(i)
        return len(self.seen)

    def log(self):
        return list(self.seen)


def cluster_gpu_task(c, rtt):
    """A third agent with one GPU runs a num_gpus=1 task; the driver holds
    the worker's card product against the CPU's."""
    c.add_node({"CPU": 2.0, "GPU": 1.0}, num_workers=1)
    before, visible, name, out = rtt.get(
        rtt.remote(_gpu_product).options(num_gpus=1, num_cpus=1).remote(7, 256), timeout=180)
    check(not before, "cluster: CUDA was initialised in the worker before its GPU task")
    check(visible == "0", f"cluster: the GPU worker saw CUDA_VISIBLE_DEVICES={visible!r}")
    g = torch.Generator().manual_seed(7)
    a, b = torch.randn(256, 256, generator=g), torch.randn(256, 256, generator=g)
    err = float(np.abs(out - (a @ b).numpy()).max())
    check(err <= 1e-3, f"cluster: the worker's card product is off the CPU's by {err:.3g}")
    print(f"cluster GPU task: a worker on {name} with CUDA_VISIBLE_DEVICES={visible}, "
          f"product max abs err {err:.3g} against the CPU (tolerance 1e-3)")


def cluster_functional(c, client, rtt):
    """The cluster's features with the head on the card, every value checked."""
    from ray_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    n1, n2 = sorted(n["NodeID"] for n in rtt.nodes() if n["Alive"])

    def on(nid):
        return NodeAffinitySchedulingStrategy(node_id=nid, soft=False)

    # ObjectRef arguments across nodes, and 64 MiB moved between agents
    a = rtt.remote(_vec).options(scheduling_strategy=on(n1)).remote(100_000, 1)
    b = rtt.remote(_vec).options(scheduling_strategy=on(n2)).remote(100_000, 2)
    dot = rtt.get(rtt.remote(_dot64).options(scheduling_strategy=on(n2)).remote(a, b),
                  timeout=120)
    check(dot == _dot64(_vec(100_000, 1), _vec(100_000, 2)), "cluster: cross-node dot is wrong")
    big = rtt.remote(_vec).options(scheduling_strategy=on(n1)).remote(16 << 20, 3)
    want = _vec(16 << 20, 3)
    got = rtt.get(rtt.remote(_sum64).options(scheduling_strategy=on(n2)).remote(big), timeout=180)
    check(got[:3] == ((16 << 20,), "<f4", float(want.astype(np.float64).sum())),
          f"cluster: the 64 MiB array arrived wrong: {got}")
    check(np.array_equal(rtt.get(big, timeout=180), want), "cluster: 64 MiB get is wrong")

    # 1,000 ordered actor calls, a named actor, and a kill
    Ordered = rtt.remote(_Ordered)
    act = Ordered.options(name="ordered").remote()
    lens = rtt.get([act.push.remote(i) for i in range(1000)], timeout=180)
    check(lens == list(range(1, 1001)), "cluster: actor calls returned out of order")
    again = rtt.get_actor("ordered")
    check(rtt.get(again.log.remote(), timeout=60) == list(range(1000)),
          "cluster: the actor ran its calls out of order")
    rtt.kill(again)
    time.sleep(0.3)
    try:
        rtt.get(again.log.remote(), timeout=20)
        fail("cluster: a killed actor still answered")
    except Exception:  # noqa: BLE001 - any error is the expected death
        pass

    # STRICT_SPREAD and PACK groups over the two nodes
    for strategy, bundles in (("STRICT_SPREAD", [{"CPU": 1.0}, {"CPU": 1.0}]),
                              ("PACK", [{"CPU": 1.0}] * 3)):
        pg = rtt.placement_group(bundles, strategy=strategy)
        check(pg.wait(60), f"cluster: the {strategy} group was never placed")
        where = rtt.get([
            rtt.remote(_node_of).options(
                num_cpus=1, scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=pg, placement_group_bundle_index=i)).remote()
            for i in range(len(bundles))], timeout=120)
        distinct = len(set(where))
        check(distinct == (len(bundles) if strategy == "STRICT_SPREAD" else 1),
              f"cluster: {strategy} tasks ran on {where}")
        rtt.remove_placement_group(pg)

    cluster_gpu_task(c, rtt)

    # a head restart: earlier refs resolve, new tasks run, the new head's
    # state is again on the card
    c.restart_head()
    check(c.head.device_state is not None and c.head.device_state.device.type == "cuda",
          "cluster: the restarted head's state is not on the card")
    deadline = time.monotonic() + 60
    while sum(1 for n in rtt.nodes() if n["Alive"]) < 3:
        check(time.monotonic() < deadline, "cluster: agents did not re-register after restart")
        time.sleep(0.2)
    check(np.array_equal(rtt.get(big, timeout=120), want),
          "cluster: a pre-restart ref does not resolve after the head restart")
    check(rtt.get(rtt.remote(_dot64).remote(a, b), timeout=120) == dot,
          "cluster: a task on pre-restart refs is wrong after the head restart")
    inc = rtt.remote(_payload).options(num_cpus=0.5)
    check(rtt.get([inc.remote(i, 8) for i in range(20)], timeout=120)
          == [bytes([i]) * 8 for i in range(20)], "cluster: new tasks after the restart")

    # leased tasks, then kill_node and a lineage rebuild
    task = rtt.remote(_payload)
    hits0 = client.metrics["lease_cache_hits"]
    refs = []
    for wave in range(6):
        batch = [task.options(max_retries=3).remote(wave * 8 + k, 150_000) for k in range(8)]
        refs.extend(batch)
        for r in batch:
            rtt.get(r, timeout=120)
    check(client.metrics["lease_cache_hits"] > hits0, "cluster: no task rode a worker lease")
    head = c.head
    with head._lock:
        held = [(i, r, set(head._objects[r.hex].locations)) for i, r in enumerate(refs)
                if r.hex in head._objects and head._objects[r.hex].locations]
    check(bool(held), "cluster: no leased object is store-resident")
    idx, victim, locs = held[-1]
    with client._direct_cv:
        client._direct_results.pop(victim.hex, None)
    for nid in locs:
        c.kill_node(nid)
    c.add_node({"CPU": 16.0}, num_workers=4)
    check(rtt.get(victim, timeout=180) == bytes([idx % 251]) * 150_000,
          "cluster: the lost leased object was not rebuilt")
    print(f"cluster lineage: killed {sorted(locs)}, rebuilt a leased object; lineage "
          f"resubmits {client.metrics['lineage_resubmits']}")


def phase_cluster():
    """The multi-process cluster with the head's rounds on the card:
    bench.py's cluster burst (card, then the port's CPU path in a fresh
    cluster), the functional workload, and each recorded head round (the
    ring's from the card burst on, the pipelined ones in the functional
    workload: recording reads each back, which the ring does anyway)
    replayed on the CPU."""
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch.core.runtime import set_runtime

    os.environ["RAY_TPU_SCHED_PREWARM"] = "0"
    os.environ.pop("RAY_TPU_SCHED_PLATFORM", None)  # the default: cuda
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    ring_records, ring_impl, ring_restore = _record_ring_rounds()
    restores = [ring_restore]
    try:
        card, card_rounds, card_hits, card_misses = cluster_burst("card", "cuda")
        card_ring = list(ring_records)
        errors.check("cluster burst on the card")
        records, impl, restore = _record_rounds()
        restores.append(restore)
        os.environ["RAY_TPU_HEALTH_TIMEOUT_S"] = "4.0"  # kill_node is noticed in seconds
        try:
            with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_head_") as d:
                c = _cluster("cuda", persist_path=os.path.join(d, "head_state.pkl"))
                try:
                    c.add_node({"CPU": 16.0}, num_workers=4)
                    c.add_node({"CPU": 16.0}, num_workers=4)
                    client = c.client()
                    set_runtime(client)
                    try:
                        cluster_functional(c, client, rtt)
                        print(f"cluster functional workload with the head on the card: every "
                              f"value right; head sched_rounds (since the restart) "
                              f"{c.head.metrics['sched_rounds']}")
                    finally:
                        set_runtime(None)
                        client.shutdown()
                finally:
                    c.shutdown()
        finally:
            os.environ.pop("RAY_TPU_HEALTH_TIMEOUT_S", None)
            while restores:
                restores.pop()()
        errors.check("cluster functional workload")
        check(len(records) > 0, "cluster: no head round was recorded")
        for i, (args, kw, node, avail_out) in enumerate(records):
            res = impl(*args, **kw)
            check(torch.equal(res.node, node) and torch.equal(res.avail_out, avail_out),
                  f"cluster: head round {i} of {len(records)} replays differently on the CPU")
        for i, (args, kw, outs, _, _) in enumerate(ring_records):
            res = ring_impl(*args, **kw)
            check(all(torch.equal(a, b) for a, b in zip(res, outs)),
                  f"cluster: ring round {i} of {len(ring_records)} replays differently on the CPU")
        print(f"cluster replay: {len(records)} card head rounds and {len(ring_records)} ring "
              f"rounds replayed on the CPU, every node row, count and avail_out equal")
        os.environ["RAY_TPU_SCHED_PLATFORM"] = "cpu"
        cpu_ring, _, cpu_ring_restore = _record_ring_rounds()
        try:
            cpu, cpu_rounds, cpu_hits, cpu_misses = cluster_burst("CPU path", "cpu")
        finally:
            cpu_ring_restore()
            os.environ.pop("RAY_TPU_SCHED_PLATFORM", None)
        errors.check("cluster burst on the CPU path")
        for label, recs, hits, misses in (("card", card_ring, card_hits, card_misses),
                                          ("CPU path", cpu_ring, cpu_hits, cpu_misses)):
            print(f"cluster ring rounds, burst {label}: {len(recs)} rounds, program ms (dispatch "
                  f"to outputs on the host) p50/p99 {_pcts([r[3] for r in recs])}, slots walked "
                  f"p50/p99 {_pcts([r[4] for r in recs])}; lease hits {hits}, misses {misses}")
    finally:
        while restores:
            restores.pop()()
        errors.close()
    print(f"cluster tasks/s card {', '.join(f'{r:.1f}' for r in card)} "
          f"(head rounds {', '.join(map(str, card_rounds))}); CPU path "
          f"{', '.join(f'{r:.1f}' for r in cpu)} (head rounds {', '.join(map(str, cpu_rounds))})")
    print(f"cluster phase: {time.perf_counter() - t0:.1f} s")


# --- the simulated-scale head, the elasticity controller, the autoscaler ---
# --- and the warm standby, each on the card                              ---


def _platform_env(device: str) -> None:
    """Point the port's scheduler at ``device`` (``cuda``, the default, or
    ``cpu``, which only a rehearsal on a host without a card asks for)."""

    os.environ["RAY_TPU_SCHED_PREWARM"] = "0"  # no background warm-up in the timings
    if device == "cuda":
        os.environ.pop("RAY_TPU_SCHED_PLATFORM", None)
    else:
        os.environ["RAY_TPU_SCHED_PLATFORM"] = device


def _record_on_device(module, name):
    """Wraps ``module.<name>`` so each call's tensor arguments and outputs
    are cloned where they lie, with no read to the host (pipelined rounds
    stay pipelined); returns (records, impl, restore)."""
    impl = getattr(module, name)
    records = []

    def keep(x):
        return x.detach().clone() if isinstance(x, torch.Tensor) else x

    def _recorded(*args, **kwargs):
        kept = ([keep(a) for a in args], {k: keep(v) for k, v in kwargs.items()})
        res = impl(*args, **kwargs)
        records.append((*kept, [keep(t) for t in res]))
        return res

    setattr(module, name, _recorded)
    return records, impl, lambda: setattr(module, name, impl)


def _replay_on_cpu(label: str, records, impl, fields) -> int:
    """Runs every recorded call again on the CPU; the outputs named by
    ``fields`` (indices into the result) must be equal bit for bit."""
    def host(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    for i, (args, kw, outs) in enumerate(records):
        res = impl(*(host(a) for a in args), **{**{k: host(v) for k, v in kw.items()},
                                                "device": "cpu"})
        for f in fields:
            check(torch.equal(res[f], host(outs[f])),
                  f"{label}: call {i} of {len(records)} replays differently on the CPU "
                  f"(output {f})")
    return len(records)


SIM_DEMANDS = 200_000  # bench.py sim_sched's default backlog


def phase_sim(device: str = "cuda", num_nodes: int = 10_000, num_demands: int = SIM_DEMANDS):
    """bench.py's ``sim_sched`` through the port's real ``HeadServer``
    (scheduler thread, batch popping, rounds, ring unparks; grants go to a
    sink): ``num_nodes`` nodes of sim.py's NODE_MIX, the same backlog
    synchronous then pipelined after a warm-up run, every round on the
    card. Divergence must be 0, and every head round and ring round of the
    three runs, recorded on the card, replays equal on the CPU."""
    from ray_tpu_torch.scheduler import hybrid as H
    from ray_tpu_torch.scheduler import sim

    _platform_env(device)
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    rounds, round_impl, round_restore = _record_on_device(H, "hybrid_schedule_shapes_multi_impl")
    rings, ring_impl, ring_restore = _record_on_device(H, "ring_schedule_impl")
    try:
        pair = sim.run_sim_pair(num_nodes, num_demands, heterogeneous=True,
                                timeout_s=max(300.0, num_demands / 1000.0))
    finally:
        ring_restore()
        round_restore()
        errors.close()
    run_s = time.perf_counter() - t0
    errors.check("sim")
    for mode in ("sync", "pipelined"):
        r = pair[mode]
        check(r["completed"] and r["delivered"] == num_demands,
              f"sim {mode}: delivered {r['delivered']} of {num_demands}")
        print(f"sim {mode} [{device}] {num_nodes} nodes, {num_demands} demands through the head: "
              f"{r['placements_per_s']:.1f} placements/s in {r['elapsed_s']:.3f} s; "
              f"{r['sched_rounds']} rounds, round p50 {r['sched_round_p50_ms']:.3f} ms p99 "
              f"{r['sched_round_p99_ms']:.3f} ms; device {r['device_stats']}")
    check(pair["placement_divergence"] == 0,
          f"sim: placement divergence {pair['placement_divergence']}")
    check(len(rounds) > 0 and rounds[0][2][0].device.type == device,
          f"sim: no head round ran on {device}")
    t1 = time.perf_counter()
    n_rounds = _replay_on_cpu("sim head round", rounds, round_impl, (0, 1))
    n_ring = _replay_on_cpu("sim ring round", rings, ring_impl, (0, 1, 2, 3))
    print(f"sim: placement divergence {pair['placement_divergence']}, pipeline speedup "
          f"{pair['pipeline_speedup']}; {n_rounds} head rounds and {n_ring} ring rounds of the "
          f"three runs replayed on the CPU, every node row, count and avail_out equal "
          f"({time.perf_counter() - t1:.1f} s); the runs took {run_s:.1f} s")
    print(f"sim phase: {time.perf_counter() - t0:.1f} s")
    return pair


def phase_elasticity(device: str = "cuda", num_nodes: int = 10_000, ticks: int = 8,
                     task_shapes: int = 200):
    """bench.py's elasticity part (b): ``run_elasticity_sim`` at its
    defaults, a real head with ``num_nodes`` nodes, serve pressure,
    under-world gangs and ``task_shapes`` parked shapes; every tick is one
    ``solve_pack_counts`` on the card. Each recorded solve is replayed on
    the CPU: per_node and placed equal, the residual within 1e-5."""
    from ray_tpu_torch.scheduler import binpack as B
    from ray_tpu_torch.scheduler import elasticity as E
    from ray_tpu_torch.scheduler.sim import run_elasticity_sim

    _platform_env(device)
    t0 = time.perf_counter()
    impl = B.solve_pack_counts
    solves = []

    def _recorded(nodes_avail, shapes, counts, **kw):
        t = time.perf_counter()
        res = impl(nodes_avail, shapes, counts, **kw)
        outs = [x.cpu() for x in res]  # the caller reads them back next anyway
        ms = (time.perf_counter() - t) * 1e3
        solves.append(((np.array(nodes_avail), np.array(shapes), np.array(counts)), dict(kw),
                       res.per_node.device.type, outs, ms))
        return res

    fallback0 = E.ELASTIC_TICKS.value({"path": "first_fit"})
    errors = _RuntimeErrors()
    B.solve_pack_counts = _recorded
    try:
        out = run_elasticity_sim(num_nodes=num_nodes, ticks=ticks, task_shapes=task_shapes)
    finally:
        B.solve_pack_counts = impl
        errors.close()
    errors.check("elasticity")
    check(out["solve_path"] == "solve", f"elasticity: the last tick took {out['solve_path']}")
    check(E.ELASTIC_TICKS.value({"path": "first_fit"}) == fallback0,
          "elasticity: a tick's solve failed over to first-fit")
    check(len(solves) >= ticks and all(s[2] == device for s in solves),
          f"elasticity: {len(solves)} solves, on {sorted({s[2] for s in solves})}")
    print(f"elasticity [{device}] {num_nodes} nodes, {task_shapes} parked shapes: {ticks} ticks, "
          f"tick p50 {out['tick_p50_ms']:.3f} ms p99 {out['tick_p99_ms']:.3f} ms, "
          f"{out['ticks_per_s']} ticks/s, solve_path {out['solve_path']}, demand rows "
          f"{out['demand_rows']}, serve hints {out['serve_hints']}, world hints "
          f"{out['world_hints']}; solve shape {solves[-1][0][1].shape[0]} x "
          f"{solves[-1][0][0].shape[0]}, solve ms (upload to outputs on the host) p50/p99 "
          f"{_pcts([x[4] for x in solves])}")
    t1 = time.perf_counter()
    worst = 0.0
    for i, ((avail, shapes, counts), kw, _, outs, _) in enumerate(solves):
        res = impl(avail, shapes, counts, **{**kw, "device": "cpu"})
        check(torch.equal(res.per_node, outs[1]) and torch.equal(res.placed, outs[0]),
              f"elasticity: solve {i} of {len(solves)} places differently on the CPU")
        err = float((res.avail_out - outs[2]).abs().max())
        worst = max(worst, err)
        check(err <= SCHED_EPS, f"elasticity: solve {i} residual off the CPU's by {err:.3g}")
    print(f"elasticity replay: {len(solves)} solves on the CPU, per_node and placed equal, "
          f"residual max abs err {worst:.3g} (tolerance {SCHED_EPS}) "
          f"({time.perf_counter() - t1:.1f} s)")
    print(f"elasticity phase: {time.perf_counter() - t0:.1f} s")
    return out


def _ret(i):
    return i


# 20 shapes no node of the 4-CPU, 4 GiB fleet holds
AUTOSCALE_SHAPES = [{"CPU": float(c), "memory": float(m << 30)}
                    for c in (5, 6, 7, 8) for m in (1, 2, 3, 4, 5)]


def autoscaler_runtime(device: str, backlog: int = 2000):
    """The in-process runtime at runtime_burst's 256 nodes of 4 CPUs and
    4 GiB; ``backlog`` tasks in AUTOSCALE_SHAPES park; ``Autoscaler.tick()``
    (called directly, never its loop) packs the demand on the runtime's
    scheduler device and launches nodes through ``SimNodeProvider``; every
    task returns its value. Each ``pack_or_solve`` call is replayed on the
    CPU and must give the same row per demand."""
    import ray_tpu_torch as rtt
    from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig
    from ray_tpu_torch.scheduler import binpack as B

    gib = float(1 << 30)
    rt = rtt.init(num_nodes=256, resources_per_node={"CPU": 4, "memory": 4 * gib})
    try:
        check(rt.device_state is not None and rt.device_state.device.type == device,
              f"autoscaler: the runtime's scheduler state is not on {device}")
        refs = []
        for i in range(backlog):
            shape = AUTOSCALE_SHAPES[i % len(AUTOSCALE_SHAPES)]
            refs.append(rtt.remote(_ret).options(
                num_cpus=shape["CPU"], memory=shape["memory"], max_retries=0).remote(i))
        deadline = time.monotonic() + 60
        while len(rt.pending_resource_demands()) < backlog:
            check(time.monotonic() < deadline, "autoscaler: the backlog never parked")
            time.sleep(0.05)
        asc = Autoscaler(rt, [NodeTypeConfig("cpu64", {"CPU": 64.0, "memory": 256 * gib}, 0, 4),
                              NodeTypeConfig("cpu32", {"CPU": 32.0, "memory": 128 * gib}, 0, 2)],
                         idle_timeout_s=3600.0)
        check(asc.device == rt.sched_device and asc.device.type == device,
              f"autoscaler: packing on {asc.device}, not the runtime's {rt.sched_device}")
        packs = []
        pack_or_solve = asc._packer.pack_or_solve

        def _recorded(ids, rows, demands):
            out = pack_or_solve(ids, rows, demands)
            packs.append((list(ids), np.array(rows, dtype=np.float32), np.array(demands),
                          np.array(out)))
            return out

        asc._packer.pack_or_solve = _recorded
        runs0, falls0 = B.SOLVER_RUNS.value(), B.SOLVER_FALLBACKS.value()
        tick_ms, launched = [], {}
        t0 = time.perf_counter()
        deadline = time.monotonic() + 300
        while True:
            t = time.perf_counter()
            d = asc.tick()
            tick_ms.append((time.perf_counter() - t) * 1e3)
            for k, v in d.launch.items():
                launched[k] = launched.get(k, 0) + v
            ready, _ = rtt.wait(refs, num_returns=len(refs), timeout=0.5)
            if len(ready) == len(refs):
                break
            check(time.monotonic() < deadline,
                  f"autoscaler: {len(refs) - len(ready)} of {backlog} tasks never ran")
        wall = time.perf_counter() - t0
        check(rtt.get(refs, timeout=120) == list(range(backlog)),
              "autoscaler: a task returned a wrong value")
        check(sum(launched.values()) > 0 and len(rt.nodes) > 256,
              f"autoscaler: launched {launched}, {len(rt.nodes)} nodes")
        runs = B.SOLVER_RUNS.value() - runs0
        check(runs > 0, "autoscaler: no pack went through the solve")
        check(B.SOLVER_FALLBACKS.value() == falls0, "autoscaler: a solve fell back to first-fit")
        check(any(p[2].shape[0] >= 64 for p in packs), "autoscaler: no batch of 64 or more")
        for i, (ids, rows, demands, out) in enumerate(packs):
            again = B.DeltaBinPacker(device="cpu").pack_or_solve(ids, rows, demands)
            check(np.array_equal(again, out),
                  f"autoscaler: pack {i} of {len(packs)} ({demands.shape[0]} demands on "
                  f"{len(ids)} nodes) gives other rows on the CPU")
        print(f"autoscaler runtime [{device}]: {backlog} tasks in {len(AUTOSCALE_SHAPES)} shapes "
              f"parked on 256 nodes; {len(tick_ms)} ticks, first {tick_ms[0]:.3f} ms, ms per "
              f"tick p50/p99 {_pcts(tick_ms)}; launched {launched}; every value back in "
              f"{wall:.1f} s; SOLVER_RUNS +{runs}, SOLVER_FALLBACKS +0; {len(packs)} "
              f"pack_or_solve calls (largest {max(p[2].shape[0] for p in packs)} demands on "
              f"{max(len(p[0]) for p in packs)} nodes) replayed on the CPU, every row equal")
    finally:
        rtt.shutdown()


def _payload_cpu(i):
    return bytes([i % 251]) * 64


def autoscaler_cluster(device: str):
    """A two-agent ``Cluster`` with the head's elasticity controller on
    (``RAY_TPU_ELASTIC_CONTROLLER=1``) and ``attach_elasticity_provider``
    as its node lifecycle: a parked burst of 3-CPU tasks, which neither
    2-CPU agent holds, provisions 4-CPU agents; every value returns; the
    idle fleet drains and retires. The controller's solves run on the
    head's scheduler device."""

    import ray_tpu_torch as rtt
    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.scheduler import elasticity as E

    env = {"RAY_TPU_ELASTIC_CONTROLLER": "1", "RAY_TPU_ELASTIC_TICK_S": "0.2",
           "RAY_TPU_ELASTIC_IDLE_RETIRE_S": "2.0", "RAY_TPU_ELASTIC_MIN_NODES": "2"}
    os.environ.update(env)
    solves0 = E.ELASTIC_TICKS.value({"path": "solve"})
    fallback0 = E.ELASTIC_TICKS.value({"path": "first_fit"})
    try:
        c = _cluster(device)
        ctrl = c.head._elasticity
        try:
            check(c.head.sched_device.type == device,
                  f"autoscaler cluster: the controller solves on {c.head.sched_device}")
            c.add_node({"CPU": 2.0}, num_workers=1)
            c.add_node({"CPU": 2.0}, num_workers=1)
            client = c.client()
            set_runtime(client)
            try:
                provider = c.attach_elasticity_provider(resources={"CPU": 4.0}, num_workers=2,
                                                        max_nodes=4)
                t0 = time.perf_counter()
                f = rtt.remote(_payload_cpu).options(num_cpus=3.0, max_retries=0)
                refs = [f.remote(i) for i in range(24)]
                check(rtt.get(refs, timeout=180) == [bytes([i]) * 64 for i in range(24)],
                      "autoscaler cluster: a task returned a wrong value")
                up_s = time.perf_counter() - t0
                peak = sum(1 for n in rtt.nodes() if n["Alive"])
                check(len(provider.created) >= 1, "autoscaler cluster: nothing was provisioned")
                deadline = time.monotonic() + 90
                while not provider.terminated:
                    check(time.monotonic() < deadline, "autoscaler cluster: nothing retired")
                    time.sleep(0.2)
                down_s = time.perf_counter() - t0
                pct = ctrl.tick_percentiles()
                solves = E.ELASTIC_TICKS.value({"path": "solve"}) - solves0
                check(solves > 0, "autoscaler cluster: no controller tick solved")
                check(E.ELASTIC_TICKS.value({"path": "first_fit"}) == fallback0,
                      "autoscaler cluster: a tick's solve failed over to first-fit")
                print(f"autoscaler cluster [{device}]: 24 tasks of 3 CPU on two 2-CPU agents: "
                      f"provisioned {len(provider.created)} 4-CPU agents, every value back in "
                      f"{up_s:.1f} s ({peak} agents at the peak); retired "
                      f"{len(provider.terminated)} by {down_s:.1f} s; {ctrl.ticks} controller "
                      f"ticks ({solves:.0f} solved on {c.head.sched_device}, the rest had no "
                      f"demand), ms per tick p50 {pct['p50_ms']:.3f} p99 {pct['p99_ms']:.3f}")
            finally:
                set_runtime(None)
                client.shutdown()
        finally:
            # the controller provisions from its own thread: stop it before
            # the cluster tears its agents down
            ctrl.stop()
            if ctrl._thread is not None:
                ctrl._thread.join(timeout=10)
            c.shutdown()
    finally:
        for k in env:
            os.environ.pop(k, None)


def phase_autoscaler(device: str = "cuda"):
    _platform_env(device)
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    try:
        autoscaler_runtime(device)
        errors.check("autoscaler in the local runtime")
        autoscaler_cluster(device)
        errors.check("autoscaler in the cluster")
    finally:
        errors.close()
    print(f"autoscaler phase: {time.perf_counter() - t0:.1f} s")


STANDBY_PAYLOAD = 200 * 1024


def phase_standby(device: str = "cuda", num_tasks: int = 300):
    """A ``Cluster`` whose head state is on the card, with a warm standby
    (``start_standby``) tailing its WAL: ``num_tasks`` tasks, then the
    leader dies; the standby promotes onto the leader's port with its own
    scheduler state on the card, and a task and an actor created after the
    promotion return."""
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch.cluster.replication import FAILOVER_MS
    from ray_tpu_torch.core.runtime import set_runtime

    _platform_env(device)
    env = {"RAY_TPU_HEAD_HEALTH_TIMEOUT_S": "1.5", "RAY_TPU_HEALTH_TIMEOUT_S": "4.0"}
    os.environ.update(env)
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    try:
        with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_standby_") as d:
            c = _cluster(device, persist_path=os.path.join(d, "head_state.pkl"))
            try:
                c.add_node({"CPU": 4.0}, num_workers=2)
                c.add_node({"CPU": 4.0}, num_workers=2)
                client = c.client()
                set_runtime(client)
                try:
                    standby = c.start_standby(auto_promote=True)
                    f = rtt.remote(_payload).options(num_cpus=0.5, max_retries=20)
                    # results above the inline limit live in the agents' stores
                    refs = [f.remote(i, STANDBY_PAYLOAD) for i in range(num_tasks)]
                    check(rtt.get(refs, timeout=180) == [_payload(i, STANDBY_PAYLOAD)
                                                         for i in range(num_tasks)],
                          "standby: a task before the failover returned a wrong value")
                    pre_epoch = c.head.cluster_epoch
                    n0, s0 = FAILOVER_MS.summary()["count"], FAILOVER_MS.summary()["sum"]
                    t_kill = time.perf_counter()
                    c.kill_head()
                    head = standby.wait_promoted(timeout=60.0)
                    detect_s = time.perf_counter() - t_kill
                    check(head is not None, "standby: never promoted")
                    check(c.head is head and head.address == c.address,
                          "standby: the promoted head is not on the leader's port")
                    check(head.cluster_epoch > pre_epoch, "standby: the epoch did not rise")
                    check(head.device_state is not None
                          and head.device_state.device.type == device,
                          f"standby: the promoted head's scheduler state is not on {device}")
                    check(rtt.get(f.remote(7, 64), timeout=120) == _payload(7, 64),
                          "standby: a task after the promotion returned a wrong value")
                    act = rtt.remote(_Ordered).remote()
                    check(rtt.get([act.push.remote(i) for i in range(3)], timeout=120)
                          == [1, 2, 3], "standby: an actor after the promotion answered wrong")
                    check(rtt.get(refs[-1], timeout=60)
                          == _payload(num_tasks - 1, STANDBY_PAYLOAD),
                          "standby: a pre-failover ref does not resolve")
                    s = FAILOVER_MS.summary()
                    check(s["count"] == n0 + 1, "standby: FAILOVER_MS did not record one")
                    print(f"standby [{device}]: {num_tasks} tasks, leader killed; promoted onto "
                          f"{head.address} with its state on "
                          f"{head.device_state.device}, epoch {pre_epoch} -> "
                          f"{head.cluster_epoch}; FAILOVER_MS {s['sum'] - s0:.3f} ms (bind and "
                          f"bring-up); leader death to promoted head {detect_s:.3f} s "
                          f"(head_health_timeout_s 1.5); a task and an actor after it returned")
                finally:
                    set_runtime(None)
                    client.shutdown()
            finally:
                c.shutdown()
        errors.check("standby")
    finally:
        errors.close()
        for k in env:
            os.environ.pop(k, None)
    print(f"standby phase: {time.perf_counter() - t0:.1f} s")


# --- the dashboard and the state API, compiled DAGs and pipelines, and ---
# --- device frames for CUDA tensors                                    ---

_SMI = {}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them, printed
    beside every number the last three phases measure."""
    if "line" not in _SMI:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60,
            ).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            out = "no card (a CPU rehearsal)"
        _SMI["line"] = out
    return _SMI["line"]


def _square(x):
    return x * x


def _http(url: str, method: str = "GET", body=None):
    """(status, content type, body bytes) of one dashboard request."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(), method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type", ""), exc.read()


def _get_json(url: str):
    status, ctype, body = _http(url)
    check(status == 200 and ctype.startswith("application/json"),
          f"dashboard: {url} answered {status} {ctype!r}")
    return json.loads(body)


def dashboard_routes(c, client, rtt, actors, pg) -> None:
    """Every route of the head's dashboard, each answer checked against
    the cluster's own state."""
    from ray_tpu_torch.util.metrics import validate_exposition

    head = c.head
    base = f"http://127.0.0.1:{head.dashboard.port}"
    t0 = time.perf_counter()
    status, ctype, body = _http(base + "/")
    check(status == 200 and b"ray_tpu cluster" in body, f"dashboard /: {status}")
    status, ctype, body = _http(base + "/ui")
    check(status == 200 and ctype.startswith("text/html")
          and all(f'<table id="{t}">'.encode() in body
                  for t in ("nodes", "actors", "pgs", "jobs", "rpc")),
          f"dashboard /ui: {status}, tables missing")
    info = head._h_cluster_info(None)
    nodes = _get_json(base + "/api/nodes")
    check(len(nodes) == len(info["nodes"]) == 2 and all(n["Alive"] for n in nodes)
          and {n["NodeID"] for n in nodes} == {n["NodeID"] for n in info["nodes"]},
          f"dashboard /api/nodes: {len(nodes)} nodes against the head's {len(info['nodes'])}")
    status_body = _get_json(base + "/api/cluster_status")
    check({"metrics", "nodes", "head_address", "leases"} <= set(status_body)
          and status_body["head_address"] == head.address,
          f"dashboard /api/cluster_status: keys {sorted(status_body)}")
    for n in nodes:
        debug = _get_json(f"{base}/api/nodes/{n['NodeID']}/debug")
        check({"available", "store", "rpc_handlers", "oom_kills"} <= set(debug),
              f"dashboard node debug: keys {sorted(debug)}")
    check("error" in _get_json(base + "/api/nodes/nope/debug"),
          "dashboard: an unknown node's debug answered without an error")
    rpc = _get_json(base + "/api/rpc_stats")
    check(isinstance(rpc, dict) and rpc, "dashboard /api/rpc_stats: empty")
    listed = _get_json(base + "/api/actors")
    want = {a._actor_id for a in actors}
    alive = {a["actor_id"] for a in listed if a.get("state") == "ALIVE"}
    check(want <= alive and len(listed) == len(head._h_query_state({"kind": "actors"})),
          f"dashboard /api/actors: {len(listed)} rows, ours alive {len(want & alive)} of {len(want)}")
    objects = _get_json(base + "/api/objects")
    check(isinstance(objects, list), "dashboard /api/objects: not a list")
    pgs = _get_json(base + "/api/placement_groups")
    check(any(p.get("pg_id") == pg.id and p.get("ready") for p in pgs)
          and len(pgs) == len(head._h_query_state({"kind": "placement_groups"})),
          f"dashboard /api/placement_groups: {len(pgs)} rows, ours missing")
    # a job through the REST API, its status and its logs
    status, _, body = _http(base + "/api/jobs", "POST",
                            {"entrypoint": f"{sys.executable} -c \"print('dashboard-job')\""})
    check(status == 200, f"dashboard POST /api/jobs: {status}")
    job_id = json.loads(body)["job_id"]
    deadline = time.monotonic() + 120
    job = {}
    while time.monotonic() < deadline:
        job = _get_json(f"{base}/api/jobs/{job_id}")
        if job["status"] in ("SUCCEEDED", "FAILED", "STOPPED"):
            break
        time.sleep(0.2)
    check(job.get("status") == "SUCCEEDED", f"dashboard job: {job}")
    status, _, logs = _http(f"{base}/api/jobs/{job_id}/logs")
    check(status == 200 and b"dashboard-job" in logs, f"dashboard job logs: {status}")
    jobs = _get_json(base + "/api/jobs")
    check(len(jobs) == len(head.jobs.list()) == 1 and jobs[0]["job_id"] == job_id,
          f"dashboard /api/jobs: {len(jobs)} rows")
    for path, want_status in (("/api/jobs/nope", 404), ("/api/jobs/nope/logs", 404),
                              ("/api/nothing", 404)):
        status, _, _ = _http(base + path)
        check(status == want_status, f"dashboard {path}: {status}, not {want_status}")
    status, _, _ = _http(base + "/api/nodes", "POST", {})
    check(status == 405, f"dashboard POST /api/nodes: {status}, not 405")
    # the Prometheus scrape: parser-valid, the scheduler's histograms in it
    status, ctype, text = _http(base + "/metrics")
    fams = validate_exposition(text.decode())
    hists = sorted(f for f, v in fams.items()
                   if v["kind"] == "histogram" and f.startswith("sched_"))
    for name in ("sched_round_ms", "sched_upload_ms", "sched_kernel_ms", "sched_readback_ms"):
        check(name in hists, f"dashboard /metrics: no {name} histogram (has {hists})")
    rounds = sum(v for n, _, v in fams["sched_round_ms"]["samples"] if n.endswith("_count"))
    check(rounds > 0, "dashboard /metrics: sched_round_ms counted no round")
    check(fams["ray_tpu_nodes_alive"]["samples"][0][2] == 2,
          "dashboard /metrics: ray_tpu_nodes_alive is not 2")
    print(f"dashboard [{card_line()}]: 14 routes answered on ThreadingHTTPServer in "
          f"{time.perf_counter() - t0:.2f} s: 2 nodes alive, {len(listed)} actors, "
          f"{len(objects)} objects, {len(pgs)} placement groups, job {job['status']} with "
          f"its logs, 404/405 where the reference answers them; /metrics parser-valid with "
          f"{len(fams)} families, histograms {', '.join(hists)} ({rounds:.0f} head rounds)")


def state_api_burst(device: str, num_tasks: int = 2000) -> None:
    """``util.state`` on the in-process runtime, its rounds on ``device``,
    after a burst of tasks."""
    import ray_tpu_torch as rtt
    from ray_tpu_torch.util import state

    rt = rtt.init(num_nodes=8, resources_per_node={"CPU": 4.0})
    try:
        check(rt.device_state.device.type == device,
              f"state API: the runtime's scheduler state is not on {device}")
        f = rtt.remote(_square).options(num_cpus=0.25)
        t0 = time.perf_counter()
        check(rtt.get([f.remote(i) for i in range(num_tasks)], timeout=300)
              == [i * i for i in range(num_tasks)], "state API: the burst returned wrong values")
        burst_s = time.perf_counter() - t0
        actor = rtt.remote(_Ordered).options(name="state-ordered").remote()
        check(rtt.get(actor.push.remote(1), timeout=60) == 1, "state API: the actor answered wrong")
        t0 = time.perf_counter()
        finished = state.list_tasks(filters=[("state", "=", "FINISHED")], limit=10**9)
        summary = state.summarize_tasks()
        actors = state.list_actors()
        nodes = state.list_nodes()
        objects = state.list_objects(limit=10**9)
        list_s = time.perf_counter() - t0
        named = sum(1 for t in finished if t["name"] == "_square")
        check(named == num_tasks, f"state API: {named} finished _square tasks, not {num_tasks}")
        check(summary.get("FINISHED", 0) >= num_tasks + 1, f"state API: summary {summary}")
        check(any(a["name"] == "state-ordered" and a["state"] == "ALIVE" for a in actors),
              "state API: the named actor is not listed alive")
        check(len(nodes) == 8, f"state API: {len(nodes)} nodes, not 8")
        print(f"state API [{card_line()}]: {num_tasks} tasks in {burst_s:.2f} s on the "
              f"runtime's {device} rounds; list_tasks/summarize/list_actors/list_nodes/"
              f"list_objects in {list_s * 1e3:.1f} ms: {len(finished)} finished, summary "
              f"{summary}, {len(actors)} actors, {len(nodes)} nodes, {len(objects)} objects")
    finally:
        rtt.shutdown()


def phase_dashboard(device: str = "cuda"):
    """The head's dashboard (``dashboard_port=0``) over two agents and a
    small workload: every route fetched and checked against the cluster's
    own state, a job through the REST API, the Prometheus scrape; then
    the state API on the in-process runtime after a burst."""
    import ray_tpu_torch as rtt
    from ray_tpu_torch.core.runtime import set_runtime

    _platform_env(device)
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    try:
        c = _cluster(device, dashboard=True)
        try:
            c.add_node({"CPU": 4.0}, num_workers=2)
            c.add_node({"CPU": 4.0}, num_workers=2)
            client = c.client()
            set_runtime(client)
            try:
                f = rtt.remote(_square).options(num_cpus=0.25, max_retries=0)
                check(rtt.get([f.remote(i) for i in range(200)], timeout=120)
                      == [i * i for i in range(200)], "dashboard: the tasks returned wrong values")
                ordered = rtt.remote(_Ordered).options(num_cpus=0.25)
                actors = [ordered.remote(), ordered.options(name="dash-ordered").remote()]
                check(rtt.get([a.push.remote(5) for a in actors], timeout=120) == [1, 1],
                      "dashboard: the actors answered wrong")
                pg = rtt.placement_group([{"CPU": 1.0}, {"CPU": 1.0}], strategy="STRICT_SPREAD")
                check(pg.wait(timeout_seconds=60), "dashboard: the placement group never formed")
                dashboard_routes(c, client, rtt, actors, pg)
            finally:
                set_runtime(None)
                client.shutdown()
        finally:
            c.shutdown()
        check(not c.head.dashboard._thread.is_alive(), "dashboard: its thread outlived the head")
        errors.check("dashboard")
        state_api_burst(device)
        errors.check("state API")
    finally:
        errors.close()
    print(f"dashboard phase: {time.perf_counter() - t0:.1f} s")


class _Stage:
    """bench.py's tier-4 stage."""

    def __init__(self, k):
        self.k = k

    def f(self, x):
        return x + self.k


def _pipe_inc(x):
    return x + 1


class _TensorStage:
    """Doubles a tensor where it lies; reports the device it received."""

    def scale(self, x):
        return x * 2.0

    def where(self, x):
        return x.device.type


class _Echo:
    def echo(self, x):
        return x


def dag_tiers(rtt, n_exec: int = 200, n_items: int = 4000) -> dict:
    """bench.py's tier 4 (three ``_Stage`` actors, 20 eager chains against
    ``n_exec`` compiled executions) and tier 4b (``compile_pipeline`` over
    two of them, 100 warm-up items and ``n_items`` timed), every value
    checked."""
    from ray_tpu_torch.dag import InputNode, compile_pipeline

    S = rtt.remote(_Stage).options(num_cpus=0.25, max_retries=0)
    sa, sb, sc = S.remote(1), S.remote(10), S.remote(100)
    check(rtt.get(sc.f.remote(sb.f.remote(sa.f.remote(0))), timeout=60) == 111,
          "dag: the eager chain returned a wrong value")
    t0 = time.perf_counter()
    for i in range(20):
        check(rtt.get(sc.f.remote(sb.f.remote(sa.f.remote(i))), timeout=60) == i + 111,
              "dag: the eager chain returned a wrong value")
    eager_per = (time.perf_counter() - t0) / 20
    with InputNode() as inp:
        dag = sc.f.bind(sb.f.bind(sa.f.bind(inp)))
    compiled = dag.experimental_compile()
    try:
        check(compiled.execute(0).get(timeout=60) == 111, "dag: the compiled chain's warm-up")
        t0 = time.perf_counter()
        refs = [compiled.execute(i) for i in range(n_exec)]
        outs = [r.get(timeout=60) for r in refs]
        dag_per = (time.perf_counter() - t0) / n_exec
    finally:
        compiled.teardown()
    check(outs == [i + 111 for i in range(n_exec)], "dag: a compiled execution returned wrong")
    pipe = compile_pipeline([sa, sb], [_pipe_inc, _pipe_inc], max_inflight=64)
    try:
        check([r.get(timeout=60) for r in pipe.map(list(range(100)))]
              == [i + 2 for i in range(100)], "dag: the pipeline's warm-up items came back wrong")
        t0 = time.perf_counter()
        prefs = pipe.map(list(range(n_items)))
        pouts = [r.get(timeout=300) for r in prefs]
        pipe_s = time.perf_counter() - t0
        pst = pipe.stats()
    finally:
        pipe.teardown()
    check(pouts == [i + 2 for i in range(n_items)], "dag: a pipeline item came back wrong")
    check(pst["respilled"] == 0 and pst["broken"] is None,
          f"dag: the pipeline respilled {pst['respilled']} or broke ({pst['broken']})")
    for h in (sa, sb, sc):
        rtt.kill(h)
    return {"eager_ms": eager_per * 1e3, "dag_us": dag_per * 1e6,
            "speedup": eager_per / dag_per, "items_per_s": n_items / pipe_s,
            "us_per_item": pipe_s / n_items * 1e6, "respilled": pst["respilled"],
            "broken": pst["broken"]}


def dag_cuda_ring(rtt, device: str, n: int = 1 << 22) -> None:
    """A two-actor cluster DAG whose ring edges carry a CUDA tensor: each
    stage doubles it on the card, and the result lands on the driver's
    card, bytes equal to the same doubling done here."""
    from ray_tpu_torch.dag import InputNode

    T = rtt.remote(_TensorStage).options(num_cpus=0.25, max_retries=0)
    a, b = T.remote(), T.remote()
    with InputNode() as inp:
        dag = b.scale.bind(a.scale.bind(inp))
    compiled = dag.experimental_compile(buffer_size_bytes=64 << 20)
    try:
        x = torch.arange(n, dtype=torch.float32, device=device) * 0.5
        t0 = time.perf_counter()
        out = compiled.execute(x).get(timeout=120)
        dt = time.perf_counter() - t0
    finally:
        compiled.teardown()
    where = rtt.get(b.where.remote(x), timeout=60)
    for h in (a, b):
        rtt.kill(h)
    check(isinstance(out, torch.Tensor) and out.device.type == device,
          f"dag: the ring's tensor landed as {type(out).__name__} on "
          f"{getattr(out, 'device', None)}, not {device}")
    check(where == device, f"dag: the stage received its tensor on {where}, not {device}")
    want = x * 4.0
    check(torch.equal(out.view(torch.int32), want.view(torch.int32)),
          "dag: the tensor that crossed the ring differs from the card's own doubling")
    print(f"dag cluster ring [{card_line()}]: a {n * 4 >> 20} MiB {device} tensor through two "
          f"actors' ring edges (each stage received it on {where}) landed on {out.device}, "
          f"bytes equal; one execution {dt * 1e3:.1f} ms")


def dag_local_cuda(rtt, device: str, n: int = 16 << 20) -> None:
    """The in-process runtime: a compiled DAG whose local edges hand a 64
    MiB CUDA tensor over by reference."""
    from ray_tpu_torch.dag import InputNode

    rt = rtt.init(num_nodes=1, resources_per_node={"CPU": 4.0})
    try:
        check(rt.device_state.device.type == device,
              f"dag: the local runtime's scheduler state is not on {device}")
        E = rtt.remote(_Echo)
        a, b = E.remote(), E.remote()
        with InputNode() as inp:
            dag = b.echo.bind(a.echo.bind(inp))
        compiled = dag.experimental_compile()
        try:
            x = torch.arange(n, dtype=torch.float32, device=device)
            t0 = time.perf_counter()
            out = compiled.execute(x).get(timeout=60)
            dt = time.perf_counter() - t0
        finally:
            compiled.teardown()
    finally:
        rtt.shutdown()
    check(out is x and out.data_ptr() == x.data_ptr() and out.device.type == device,
          "dag: the local edge did not hand the tensor over by reference")
    print(f"dag local [{card_line()}]: a {n * 4 >> 20} MiB {device} tensor through two local "
          f"edges came back with the same data_ptr() on {out.device} in {dt * 1e3:.2f} ms")


def phase_dag(device: str = "cuda"):
    """bench.py's tier 4 and 4b on the port's ``Cluster`` (its head on
    the card, two agents of 16 CPUs × 4 workers), nothing cut; then a CUDA
    tensor through a cluster DAG's ring edges and through the local
    runtime's edges by reference. The tensor stages inherit this
    process's CUDA visibility (no GPU lease)."""
    import ray_tpu_torch as rtt
    from ray_tpu_torch.core.runtime import set_runtime

    _platform_env(device)
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    try:
        c = _cluster(device)
        try:
            c.add_node({"CPU": 16.0}, num_workers=4)
            c.add_node({"CPU": 16.0}, num_workers=4)
            client = c.client()
            set_runtime(client)
            try:
                m = dag_tiers(rtt)
                print(f"dag tier 4 [{card_line()}]: compiled {m['dag_us']:.1f} us per execution "
                      f"against the eager chain's {m['eager_ms']:.2f} ms, speed-up "
                      f"{m['speedup']:.1f}x (200 executions, 20 chains)")
                print(f"dag tier 4b [{card_line()}]: pipeline {m['items_per_s']:.1f} items/s, "
                      f"{m['us_per_item']:.1f} us per item over 4000 items (max_inflight 64), "
                      f"respilled {m['respilled']}, broken {m['broken'] or 0}")
                dag_cuda_ring(rtt, device)
            finally:
                set_runtime(None)
                client.shutdown()
        finally:
            c.shutdown()
        errors.check("dag on the cluster")
        dag_local_cuda(rtt, device)
        errors.check("dag in the local runtime")
    finally:
        errors.close()
    print(f"dag phase: {time.perf_counter() - t0:.1f} s")


class _Source:
    """The source node's block maker. An actor, so that the worker that
    seals the block is the one whose counters ``counters`` reads (a plain
    task may land on any worker of the node)."""

    def make(self, n_f32: int, device: str):
        """bench.py's block, where the worker lies: its return seals it as
        a device frame when the plane is on (torch's reducer when off)."""
        import torch as th

        return th.arange(n_f32, dtype=th.float32, device=device) * 0.5

    def counters(self):
        from ray_tpu_torch.cluster import device_plane as dpl

        return (dpl.device_stats(), dpl.device_plane_enabled(),
                os.environ.get("CUDA_VISIBLE_DEVICES"))


class _Sink:
    """The destination node's puller: an actor, so every pull runs in the
    one worker that holds the destination's GPU lease, with no lease
    grant per pull."""

    def ready(self):
        return os.getpid()

    def pull(self, hex_id: str, n_f32: int, device: str, check_bytes: bool):
        """Timed end-device pull inside the destination worker: the fetch
        through its agent and the landing, up to a synchronize on the
        landed tensor (seconds); where the value landed, whether its bytes
        equal the source's, and this process's counter deltas."""
        import torch as th

        from ray_tpu_torch.cluster import device_plane as dpl
        from ray_tpu_torch.cluster import worker as worker_mod

        before = dpl.device_stats()
        t0 = time.perf_counter()
        v = worker_mod.fetch_into_local_arena(hex_id, land="device")
        landed = f"{type(v).__name__} on {v.device.type if isinstance(v, th.Tensor) else 'host'}"
        if not (isinstance(v, th.Tensor) and v.device.type == device):
            v = th.as_tensor(v).to(device)  # what the host bounce still owes
        if device == "cuda":
            th.cuda.synchronize()
        dt = time.perf_counter() - t0
        equal = None
        if check_bytes:
            want = th.arange(n_f32, dtype=th.float32, device=device) * 0.5
            equal = bool(th.equal(v.view(th.int32), want.view(th.int32)))
        after = dpl.device_stats()
        # where the time goes: the same read again, now a local arena hit,
        # is the landing alone (deserialize and H2D), without the fetch
        del v
        t1 = time.perf_counter()
        v = worker_mod.fetch_into_local_arena(hex_id, land="device")
        if not (isinstance(v, th.Tensor) and v.device.type == device):
            v = th.as_tensor(v).to(device)
        if device == "cuda":
            th.cuda.synchronize()
        land_s = time.perf_counter() - t1
        return dt, land_s, landed, equal, {k: after[k] - before[k] for k in after}, \
            os.environ.get("CUDA_VISIBLE_DEVICES")


XFER_SIZES = ((32 << 20, 5), (256 << 20, 2))  # bench.py: 32 MB x iters, 256 MB x iters // 2


def _xfer_mode(rtt, device: str, plane: bool) -> dict:
    """One of bench.py's ``_measure`` runs: a two-node cluster, the block
    made on the source node, pulled inside a destination worker with the
    destination's copy deleted between pulls; then the same block pulled
    by this driver through ``rdt.get_tensor`` (the socket fetch with the
    landing zone)."""
    from ray_tpu_torch import rdt
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.cluster import device_plane as dpl
    from ray_tpu_torch.cluster.rpc import RpcClient
    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.util.tracing import SPANS

    # set BEFORE the cluster spawns: sealing and landing happen in the
    # workers, which inherit it (and in this driver, for its own pull)
    os.environ["RAY_TPU_DEVICE_PLANE"] = "1" if plane else "0"
    big = max(n for n, _ in XFER_SIZES)
    cap = max(1 << 28, big * 3)
    gpu = {"GPU": 1.0} if device == "cuda" else {}
    sizes = {}
    t_mode = time.perf_counter()
    c = Cluster(use_device_scheduler=False)
    try:
        c.add_node({"CPU": 2.0, "srcres": 1.0, **gpu}, num_workers=1, store_capacity=cap)
        dst = c.add_node({"CPU": 2.0, "dstres": 1.0, **gpu}, num_workers=1,
                         store_capacity=cap)
        client = c.client()
        set_runtime(client)
        try:
            lease = {"num_gpus": 1} if device == "cuda" else {}
            src = rtt.remote(_Source).options(resources={"srcres": 0.1}, **lease).remote()
            sink = rtt.remote(_Sink).options(resources={"dstres": 0.1}, **lease).remote()
            dst_agent = RpcClient(c.agent_address(dst))
            rtt.get([src.counters.remote(), sink.ready.remote()], timeout=120)
            setup_s = time.perf_counter() - t_mode
            for nbytes, iters in XFER_SIZES:
                n = nbytes // 4
                (s0, src_on, _) = rtt.get(src.counters.remote(), timeout=120)
                ref = src.make.remote(n, device)
                rtt.wait([ref], timeout=300)
                (s1, _, src_visible) = rtt.get(src.counters.remote(), timeout=120)
                seal = {k: s1[k] - s0[k] for k in s1}
                samples, lands, dst_delta = [], [], {}
                landed, equal, dst_visible = set(), None, None
                for i in range(iters + 1):
                    dt, land_s, where, eq, delta, dst_visible = rtt.get(
                        sink.pull.remote(ref.hex, n, device, i == 1), timeout=600)
                    samples.append(nbytes / dt / 2**20)
                    lands.append(land_s * 1e3)
                    landed.add(where)
                    if eq is not None:
                        equal = eq
                    if i > 0:
                        for k, v in delta.items():
                            dst_delta[k] = dst_delta.get(k, 0) + v
                    dst_agent.call("DeleteObjects", {"object_ids": [ref.hex]}, timeout=30.0)
                # the driver's own pulls, zone, plain, plain, zone:
                # rdt.get_tensor (a landing("device") scope: the socket
                # fetch opens a landing zone and the frame lands from its
                # device copy) and a plain get (no zone: one H2D at the
                # deserialize)
                want = torch.arange(n, dtype=torch.float32, device=device) * 0.5
                drv = {"zone": [], "plain": []}
                drv_split = {"zone": [], "plain": []}
                drv_delta = {"zone": {}, "plain": {}}
                drv_equal = True
                for how in ("zone", "plain", "plain", "zone"):
                    d0 = dpl.device_stats()
                    SPANS.clear()
                    t0 = time.perf_counter()
                    got = (rdt.get_tensor(ref, timeout=300) if how == "zone"
                           else rtt.get(ref, timeout=300))
                    if device == "cuda":
                        torch.cuda.synchronize()
                    pull_s = time.perf_counter() - t0
                    drv[how].append(nbytes / pull_s / 2**20)
                    # where the pull's time went: the socket fetch (the
                    # zone's copies run inside it) and the zone's own H2D
                    spans = {r["name"]: r for r in SPANS.slices()}
                    fetch = spans.get("socket_fetch")
                    zone = spans.get("h2d_overlap_ms")
                    drv_split[how].append((
                        pull_s * 1e3, fetch["dur"] / 1e3 if fetch else float("nan"),
                        zone["args"]["h2d_ms"] if zone else 0.0))
                    d1 = dpl.device_stats()
                    for k in d1:
                        drv_delta[how][k] = drv_delta[how].get(k, 0) + d1[k] - d0[k]
                    drv_equal = drv_equal and (
                        isinstance(got, torch.Tensor) and got.device.type == device
                        and torch.equal(got.view(torch.int32), want.view(torch.int32)))
                    del got
                del want, ref
                sizes[nbytes] = {
                    "mb_s": float(np.median(samples[1:])), "samples": samples[1:],
                    "land_ms": float(np.median(lands[1:])),
                    "pull_ms": float(np.median([nbytes / 2**20 / x * 1e3 for x in samples[1:]])),
                    "seal": seal, "dst": dst_delta, "landed": sorted(landed), "equal": equal,
                    "drv_mb_s": drv, "drv_split": drv_split, "drv_equal": drv_equal,
                    "drv": drv_delta["zone"], "drv_plain": drv_delta["plain"],
                    "src_plane": src_on,
                    "visible": (src_visible, dst_visible),
                }
        finally:
            set_runtime(None)
            client.shutdown()
    finally:
        c.shutdown()
        os.environ.pop("RAY_TPU_DEVICE_PLANE", None)
    return {"sizes": sizes, "setup_s": setup_s, "total_s": time.perf_counter() - t_mode}


def pinned_copy_rates(nbytes: int = 256 << 20, reps: int = 5):
    """The card's own pinned D2H and H2D rates (MB/s) for ``nbytes``:
    ``copy_`` between a pinned host buffer and a CUDA tensor, timed
    between CUDA events, the median of ``reps``."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    rates = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        rates[name] = nbytes / (float(np.median(ms)) / 1e3) / 2**20
    return rates


def h2d_staging_rates(sizes=(32 << 20, 256 << 20), reps: int = 5) -> dict:
    """MB/s of two ways to land a frame's bytes from pageable host memory
    (a bytearray, as a socket fetch leaves them) on the card, each timed
    on the host clock up to a synchronize, the median of ``reps``, the two
    interleaved (ring, copy, copy, ring, ...): a plain pageable ``copy_``
    and the device plane's land (``device_plane.h2d``, its two-slot pinned
    ring of ``device_land_chunk_bytes`` chunks)."""
    from ray_tpu_torch.cluster import device_plane as dpl

    out = {}
    for nbytes in sizes:
        buf = bytearray(np.random.default_rng(nbytes).integers(
            0, 256, nbytes, dtype=np.uint8).tobytes())
        raw = np.frombuffer(buf, dtype=np.uint8)
        host = dpl.cpu_bytes(raw)
        ms = {"copy": [], "ring": []}

        def run(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = host.to(DEV) if name == "copy" else dpl.h2d(raw)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            return got

        want = torch.from_numpy(raw.copy()).to(DEV)
        for i in range(reps + 1):
            for name in (("ring", "copy") if i % 2 == 0 else ("copy", "ring")):
                got = run(name)
                if i == 0:  # warm-up, checked and not counted
                    check(torch.equal(got, want), f"h2d {name} of {nbytes >> 20} MiB: "
                                                  f"bytes differ")
                    ms[name].clear()
        out[nbytes] = {k: nbytes / (float(np.median(v)) / 1e3) / 2**20 for k, v in ms.items()}
        out[nbytes]["ms"] = {k: float(np.median(v)) for k, v in ms.items()}
        del buf, raw, host, want
    return out


def seal_times(sizes=(32 << 20, 256 << 20), reps: int = 3) -> dict:
    """ms to seal a CUDA f32 block (the D2H pump's readout into the
    frame's host buffer, ``serialization.dumps_parts``) and to copy the
    frame into a host buffer as the arena put does (the second host
    pass), each the median of ``reps``; with the pump's own
    ``d2h_overlap_ms`` span of the last seal."""
    from ray_tpu_torch.cluster import serialization as wire
    from ray_tpu_torch.util.tracing import SPANS

    out = {}
    for nbytes in sizes:
        t = torch.arange(nbytes // 4, dtype=torch.float32, device=DEV) * 0.5
        arena = bytearray(nbytes + (1 << 16))
        seal, put = [], []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts, total = wire.dumps_parts(t)
            t1 = time.perf_counter()
            mv, off = memoryview(arena), 0
            for p in parts:
                n = p.nbytes if isinstance(p, memoryview) else len(p)
                mv[off:off + n] = p
                off += n
            t2 = time.perf_counter()
            seal.append((t1 - t0) * 1e3)
            put.append((t2 - t1) * 1e3)
        back = wire.loads(memoryview(arena)[:total])
        check(torch.equal(back, t), f"seal of {nbytes >> 20} MiB: landed bytes differ")
        spans = [r for r in SPANS.slices(cat="device_plane") if r["name"] == "d2h_overlap_ms"]
        check(bool(spans), f"seal of {nbytes >> 20} MiB: no d2h_overlap_ms span (pump not run)")
        out[nbytes] = {"seal_ms": float(np.median(seal[1:])), "put_ms": float(np.median(put[1:])),
                       "pump_span_ms": spans[-1]["dur"] / 1e3,
                       "pump_chunks": spans[-1]["args"]["chunks"]}
        del t, arena, back, parts
    return out


def phase_device_xfer(device: str = "cuda"):
    """bench.py's ``device_xfer_bench`` on the port, nothing cut: a CUDA
    f32 block made on the source node, pulled inside a destination worker
    that lands it on the card (``fetch_into_local_arena(land="device")``,
    timed up to a synchronize), 32 MiB × 5 and 256 MiB × 2 with the
    device plane on, then again with ``RAY_TPU_DEVICE_PLANE=0`` (the
    reference's kill switch: torch's own reducer, the host bounce). Both
    workers see the card through their GPU lease (``num_gpus=1`` on a node
    of ``GPU: 1``, so ``CUDA_VISIBLE_DEVICES=0``). Yardstick: the card's
    pinned D2H and H2D rates."""
    import ray_tpu_torch as rtt

    _platform_env(device)
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    try:
        modes = {"device plane": _xfer_mode(rtt, device, True)}
        errors.check("device transfer, plane on")
        modes["host bounce (RAY_TPU_DEVICE_PLANE=0)"] = _xfer_mode(rtt, device, False)
        errors.check("device transfer, plane off")
    finally:
        errors.close()
    on = modes["device plane"]["sizes"]
    off = modes["host bounce (RAY_TPU_DEVICE_PLANE=0)"]["sizes"]
    for mode, m in modes.items():
        res = m["sizes"]
        plane = res is on
        print(f"device xfer {mode}: {m['total_s']:.1f} s, of it {m['setup_s']:.1f} s the "
              f"cluster and its two actors coming up")
        for nbytes, r in res.items():
            mib = nbytes >> 20
            check(r["equal"] is True, f"device xfer {mode} {mib} MiB: landed bytes differ")
            check(r["drv_equal"], f"device xfer {mode} {mib} MiB: a driver's pull differs")
            check(r["drv_plain"]["device_land_chunks_total"] == 0,
                  f"device xfer {mode} {mib} MiB: the driver's plain get opened a landing zone")
            check(r["landed"] == [f"Tensor on {device}"],
                  f"device xfer {mode} {mib} MiB: landed as {r['landed']}")
            check(r["src_plane"] == plane, f"device xfer {mode}: the source worker's plane is "
                                           f"{'on' if r['src_plane'] else 'off'}")
            if device == "cuda":
                check(r["visible"] == ("0", "0"), f"device xfer: the workers saw "
                                                  f"CUDA_VISIBLE_DEVICES {r['visible']}")
            moved = {"seals": r["seal"]["device_frame_seals_total"],
                     "device lands": r["dst"]["device_frame_lands_device_total"],
                     "pump chunks": r["seal"]["device_pump_chunks_total"],
                     "landing-zone chunks": r["drv"]["device_land_chunks_total"]}
            for name, v in moved.items():
                if plane and (device == "cuda" or name in ("seals", "device lands")):
                    check(v > 0, f"device xfer {mode} {mib} MiB: {name} stayed flat")
                if not plane:
                    check(v == 0, f"device xfer {mode} {mib} MiB: {name} moved ({v}) "
                                  f"with the plane off")
            print(f"device xfer [{card_line()}] {mode}, {mib} MiB: "
                  f"{r['mb_s']:.1f} MB/s median of {len(r['samples'])} pulls "
                  f"({', '.join(f'{s:.1f}' for s in r['samples'])}); a pull {r['pull_ms']:.1f} "
                  f"ms, of it the landing alone (a re-read from the local arena) "
                  f"{r['land_ms']:.1f} ms; landed "
                  f"{', '.join(r['landed'])}, bytes equal {r['equal']}; counter deltas "
                  f"{', '.join(f'{k} {v}' for k, v in moved.items())}, "
                  f"seal zero-copy {r['seal']['device_frame_zero_copy_total']}; driver "
                  f"rdt.get_tensor (landing zone) "
                  f"{', '.join(f'{x:.1f}' for x in r['drv_mb_s']['zone'])} MB/s, plain get "
                  f"(no zone) {', '.join(f'{x:.1f}' for x in r['drv_mb_s']['plain'])} MB/s, "
                  f"bytes equal {r['drv_equal']}; a driver pull's ms, of it the socket fetch, of "
                  f"that the zone's H2D: zone "
                  f"{'; '.join('%.1f, %.1f, %.1f' % x for x in r['drv_split']['zone'])}; plain "
                  f"{'; '.join('%.1f, %.1f, %.1f' % x for x in r['drv_split']['plain'])}")
    for nbytes in on:
        print(f"device xfer [{card_line()}] {nbytes >> 20} MiB: device plane / host bounce "
              f"{on[nbytes]['mb_s'] / off[nbytes]['mb_s']:.2f}x")
    if device == "cuda":
        rates = pinned_copy_rates()
        print(f"device xfer [{card_line()}] yardstick: pinned copy_ of 256 MiB, D2H "
              f"{rates['d2h']:.1f} MB/s, H2D {rates['h2d']:.1f} MB/s")
        for nbytes, r in h2d_staging_rates().items():
            print(f"device xfer [{card_line()}] land H2D from pageable memory, "
                  f"{nbytes >> 20} MiB: plain pageable copy_ {r['copy']:.1f} MB/s "
                  f"({r['ms']['copy']:.3f} ms), the plane's two-slot pinned ring "
                  f"(device_plane.h2d) {r['ring']:.1f} MB/s ({r['ms']['ring']:.3f} ms)")
        for nbytes, r in seal_times().items():
            print(f"device xfer [{card_line()}] seal of a CUDA f32 {nbytes >> 20} MiB block: "
                  f"{r['seal_ms']:.3f} ms (the pump's d2h_overlap_ms span {r['pump_span_ms']:.3f} "
                  f"ms, {r['pump_chunks']} chunks), then the frame's copy into a host buffer as "
                  f"the arena put does {r['put_ms']:.3f} ms")
    print(f"device xfer phase: {time.perf_counter() - t0:.1f} s")


PR_SET_CHILD_SUBREAPER = 36  # linux/prctl.h


def become_subreaper() -> None:
    """Orphans of the processes this script starts (a worker whose agent
    died first) are re-parented to this process rather than to init, so
    ``descendants`` sees them."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        fail(f"prctl(PR_SET_CHILD_SUBREAPER) failed: errno {ctypes.get_errno()}")


def descendants() -> dict:
    """pid -> command line of every live process below this one; reaps
    this process's own children that have exited."""
    parent_of, zombies = {}, []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if state in ("Z", "X"):
            zombies.append((int(entry), int(ppid)))
        else:
            parent_of[int(entry)] = int(ppid)
    me = os.getpid()
    for pid, ppid in zombies:
        if ppid == me:
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
    live = {}
    for pid in parent_of:
        q = parent_of[pid]
        while q not in (me, 0) and q in parent_of:
            q = parent_of[q]
        if q == me:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    live[pid] = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
            except OSError:
                pass
    return live


def stop_descendants(grace_s: float) -> dict:
    """Waits up to ``grace_s`` for every process below this one to end,
    then kills what is left; returns what was left (pid -> command line)."""
    deadline = time.monotonic() + grace_s
    left = descendants()
    while left and time.monotonic() < deadline:
        time.sleep(0.2)
        left = descendants()
    killed = dict(left)
    for _ in range(50):
        if not left:
            break
        for pid in left:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        time.sleep(0.1)
        left = descendants()
        killed.update(left)
    return killed


def phase_processes(grace_s: float = 20.0) -> None:
    """Every process the phases started has ended within ``grace_s`` of
    the last phase; what is left is killed and the run fails naming it."""
    t0 = time.perf_counter()
    left = stop_descendants(grace_s)
    check(not left, f"{len(left)} processes outlived the phases that started them "
                    f"(killed after {grace_s:.0f} s): "
                    + "; ".join(f"{pid} {cmd[:160]}" for pid, cmd in sorted(left.items())))
    print(f"processes: every process the phases started has ended "
          f"({time.perf_counter() - t0:.1f} s after the last phase)")


def main() -> None:
    become_subreaper()
    atexit.register(stop_descendants, 2.0)
    phase_card_and_build()
    flash_row = phase_flash()
    bwd_rows = phase_flash_backward()
    paged_row = phase_paged()
    flash_launches = phase_forward()
    paged_launches, tps = phase_serve()
    train_launches, step_ms, train_tps, train_losses = phase_train()
    phase_train_f32()
    par = phase_parallel(step_ms, train_tps)
    lib_launches = [phase_trainer(train_losses), phase_elastic_train(), phase_tune()]
    trainer_launches = {k: sum(x[k] for x in lib_launches) for k in ("fwd", "dq", "dkv")}
    wide_rows = phase_wide_heads()
    llm = phase_llm_engine()
    disagg = phase_llm_disagg()
    phase_scheduler()
    phase_runtime()
    phase_cluster()
    phase_sim()
    phase_elasticity()
    phase_autoscaler()
    phase_standby()
    phase_dashboard()
    phase_dag()
    phase_device_xfer()
    phase_processes()
    kernels = [
        dict(name="paged_attention_decode", route="cuda",
             source="ray_tpu_torch/csrc/paged_attention.cu",
             replaces="ray_tpu/ops/paged_attention.py:102",
             launches=paged_launches, **paged_row, wide_shape=wide_rows["paged"]),
        dict(name="flash_attention_fwd", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:185",
             launches=flash_launches, **flash_row, wide_shape=wide_rows["fwd"],
             mesh_launches=par["fwd"], trainer_launches=trainer_launches["fwd"]),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:230",
             launches=train_launches["dq"], **bwd_rows["dq"], wide_shape=wide_rows["dq"],
             mesh_launches=par["dq"], trainer_launches=trainer_launches["dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:247",
             launches=train_launches["dkv"], **bwd_rows["dkv"], wide_shape=wide_rows["dkv"],
             mesh_launches=par["dkv"], trainer_launches=trainer_launches["dkv"]),
    ]
    print(f"decode tokens/s {tps:.1f}; train {step_ms:.2f} ms/step, {train_tps:.1f} tokens/s; "
          f"mesh train {par['step_ms']:.2f} ms/step, {par['tps']:.1f} tokens/s; "
          f"LLMEngine decode {llm['tps']:.1f} tokens/s (MoE {llm['moe_tps']:.1f}); hand-off "
          f"extract/seal/land {disagg['extract_ms']:.2f}/{disagg['seal_ms']:.2f}/"
          f"{disagg['land_ms']:.2f} ms")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
