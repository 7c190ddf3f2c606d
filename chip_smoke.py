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
   step 13 (the chaos package's ``wait_gang_reshaped`` clean within 60 s),
   a node joins after the shrink and the gang grows back: steps
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
5d. serving (``ray_tpu_torch/serve/``, ``llm/serving.py``; ``phase_serving``)
   on one ``Cluster()`` (the head on the card, two agents sharing it,
   replicas in worker processes on a quarter GPU lease each), every paged
   launch counted inside the replica processes: bench.py's ``serve_bench`` (a
   ``build_llm_deployment`` of ModelConfig() bf16, 2 continuous replicas,
   max_batch 4, prefix cache on, open loop at 6 QPS for 20 s, 80% hot
   prefixes, 12 tokens): sustained QPS, TTFT p50, e2e p99, shed count and
   prefix hits, zero per-request head RPCs, every admitted stream 12
   tokens; one POST through ``start_http_proxy`` (the standard library's
   server without aiohttp) equal to the router's unary call; a one-replica
   f32 deployment's 8 greedy streams token-exact with the engine on the CPU
   (TF32 off). ``serve_disagg_bench``: one prefill replica, one then two
   decode replicas, two weight variants; per decode count a burst of 24
   requests at 8, each naming the base variant, tenants from bench.py's
   mix: TTFT p50, decode tokens/s and the hand-off's MB/s, no fallback to a
   local prefill, no decode-side full prefill, paged launches in every
   decode replica; forced swaps between the variants with no stream error.
   ``router_scale_bench``: its token server behind 1 and 2 routers at 40
   QPS, QPS and e2e p99 and their ratio; then the LLM deployment in f32
   with a router killed mid-stream three times, every stream token-exact
   with an unbroken run, failover p95. The paged kernel is also held
   against its plain version at the
   serving decode shape (max_batch 4, 8-token pages). Last on that cluster,
   ``phase_chaos_serve``: the reference's two slow serve chaos cases under
   ``ray_tpu_torch.chaos`` (ModelConfig() f32, 2 continuous replicas of
   max_batch 2 behind 2 routers, ``ServeStreamWorkload`` of 2 threads x 10
   tokens held against the CPU engine): two replica kills (seed 11), then a
   router kill (seed 7); both runs ``ok``, every stream token-exact, the
   replica set backfilled to 2 with each backfilled replica launching the
   paged kernel, the killed router's streams resumed ``ok``, no arena
   zombie (its launches are the kernel line's ``chaos_launches``). Then, on
   a cluster of its own, ``phase_mixed_fleet``: bench.py's
   ``elasticity_bench`` part (a) (two agents of 4 CPUs × 4 workers, the
   elasticity controller on, tick 0.5 s; 2 continuous replicas of
   ``ModelConfig()`` f32 behind a router that admits 8 requests at a time,
   under its hot/cold prompts at QPS 1.5, twice the replicas' measured
   completion rate, and 1.5 for 8, 10 and 8 s, beside an elastic gang of
   its numpy step, SPREAD, 1-2 ranks): requests parked at the peak, the
   controller hinting fewer ranks and the gang ceding there (only when
   hinted), world 2 in both troughs, only cede and grow reshapes, no disk
   restore, no errored request (sheds counted apart by reason), paged
   launches in each replica (``mixed_fleet_launches``), every controller
   solve and head round replayed equal on the CPU; each step's reached
   arrival rate, completed requests a second and most requests in flight,
   retention, serve p99 and the reshapes printed;
5e. online RL (``ray_tpu_torch/rl/``; ``phase_rl``): bench.py's
   ``rl_loop_bench`` traffic (2 rollout workers x 2 prompts a step, 6 prompt
   and 6 new tokens, batch 4, 8 steps, seed 3, a publish every 2 steps) on
   ``ModelConfig()`` bf16, the rollouts on ``ContinuousBatchingEngine``
   (the paged kernel) and the trainer's SGD steps through ``loss_fn`` (the
   flash forward, dQ and dK/dV kernels): the run fenced by the port's
   ``HeadServer`` (WAL on), the rerun on the local ledger, losses bit-equal,
   weights epoch 4 on every worker, nothing unaccounted, every parameter
   and KV page on the card, each run's launches equal to what its steps
   imply; samples/s, publish ms and publish-to-first-token ms; the bf16
   flash forward and backward at the trainer's shape (B=4, T=11 padded to
   one tile; the kernel and its lse also at the padded shape) and the paged
   kernel at the rollout engine's (max_batch 2, 8-token pages) against
   their plain versions; then an f32
   loop of 2 steps on the card against the CPU's plain path, every
   trajectory token-equal and the losses within 1e-4. Then
   ``phase_rl_soak`` (in a child process, ``--rl_soak``, beside the phases
   from ``phase_rllib`` to the last; it prints its launches as JSON for
   the kernel line): ``tests/test_rl_loop.py``'s triple chaos soak on the
   card (a WAL head with an auto-promoting standby, 2 continuous replicas
   of ``ModelConfig()`` f32 as rollout workers, an elastic trainer gang of
   ``elastic_rl_step`` on the card, a shadow trainer publishing through the
   weights-epoch fence; seed 14: two rollout kills, a trainer-rank node
   kill, a head kill inside a seal → commit window): every fault fired and
   ``ok``, every stream token-exact against an engine on the card, no
   trajectory unaccounted, the gang's losses within 1e-3 of the shadow's,
   3 or more epochs, every head and ring round replayed equal on the CPU
   (launches: ``rl_soak_launches``);
5f. rllib (``ray_tpu_torch/rllib/``; ``phase_rllib``): PPO, DQN and IMPALA
   at ``tests/test_rllib.py``'s configurations on the local runtime, each
   learner on the card and its runners on the CPU: the learner's tensors on
   the card, the mean return past the first iteration's by more than 10,
   every loss finite, a PPO checkpoint restored equal on the card, IMPALA
   with both rollouts in flight; env steps/s and SGD steps/s;
5g. data (``ray_tpu_torch/data/``; ``phase_data``): prints whether pyarrow
   and pandas import; bench.py's ``shuffle_bench`` traffic unchanged, on a
   fresh ``Cluster(use_device_scheduler=True)`` of two agents (4 CPUs, 2
   workers, 512 MiB arenas) for each of its two passes, the row loop
   (``RAY_TPU_DATA_VECTOR_SHUFFLE=0`` before the agents start) then the
   vectorized path: ``random_shuffle(seed=7)`` of 4,000,000 f64 rows in 16
   ndarray blocks, equal element for element to this process's replay of
   the port's map and reduce functions, and a hash ``groupby("k").count()``
   over ``range(100_000)`` in 16 blocks (64 groups of 1,562 or 1,563); on the
   vectorized pass the locality run (1,000,000 rows in 32 blocks, seed 11,
   ``RAY_TPU_SCHED_W_LOCALITY=2.0``: locality-scored leases, the head's
   rounds on the card, each replayed equal on the CPU) and the ingest
   stall of ``iter_batches(batch_size=125_000)`` at prefetch 0 and 2, each
   batch copied to the card before a 4 ms step, the landed rows sorted on
   the card equal to ``arange`` with their exact f64 sum; zero arena spills.
   ``shuffle_mb_per_s``, ``shuffle_groupby_s``, the locality hit rate,
   ``ingest_stall_s`` and each pass's grant RPC p50 printed. Then
   ``TorchTrainer(datasets={"train": ds})`` over
   ``from_numpy_blocks(table, 8).random_shuffle(seed=2)`` of a seeded
   256 × 513 int32 table: 2 workers on half a GPU lease each train
   ``ModelConfig()`` bf16 at T=512 with Adam, one step a batch of 8, every
   batch moved to the card; the ranks' rows disjoint and covering the
   table, each rank's losses bit-equal to this process's replay of its
   ``split(2)`` shard, the flash launches those the steps imply. Where
   pyarrow imports, ``LLMProcessor`` over ``from_items`` of 8 prompts in 2
   blocks (``ModelConfig()`` bf16, batch 4, 8 greedy tokens): every stream
   token-equal to ``LLMEngine.generate_ids`` in this process;
6. runs the scheduler slice on the card against the port's CPU path, every
   output bit-identical: bench.py's kernel tier (1,024 nodes, 100,000
   requests) through ``hybrid_schedule_shapes``, with capacity recomputed on
   the host; the head's round at 10,000 nodes and a 200,000-request backlog
   through ``DeviceSchedulerState`` and ``SchedulerPipeline`` (rounds of
   4,096 at depth 3), with the default weights and the multi-objective ones,
   placement divergence 0 over the first 16 rounds, which the CPU path
   replays; then the fidelity, chunked (two chunks of 2,048), ring, slot, bundle
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
   on the CPU and must give the same node rows; the burst then runs again,
   one pass of 2,500 tasks, on the port's CPU path. Any ERROR record of the ``ray_tpu_torch``
   loggers ("scheduler round failed") fails the phase;
8. runs the multi-process cluster (``Cluster()``: the head in this process
   with its ``DeviceSchedulerState`` on the card and
   ``sched_device_min_batch`` 0, node-agent and worker subprocesses that
   never touch the card before a task asks for it): bench.py's
   ``cluster_bench`` (two agents of 16 CPUs × 4 workers, 50 warm-up tasks,
   one pass of its two of 10,000 no-op tasks at 0.25 CPU, ``get`` in chunks
   of 500)
   prints tasks/s, the head's rounds per pass, lease-cache hits and misses
   and the rounds' round/upload/kernel/readback ms (p50/p99); then, with
   every head round recorded, a functional workload whose every value is
   checked (ObjectRef arguments across nodes, 64 MiB between agents, 1,000
   ordered actor calls, a named actor and ``kill``, STRICT_SPREAD and PACK
   groups, a GPU agent whose worker computes a seeded product on the card
   under its lease's ``CUDA_VISIBLE_DEVICES``, a head restart from its WAL
   with the new head's state on the card, leased tasks then ``kill_node``
   and a lineage rebuild); each recorded round (the parked-demand ring's
   from the card burst on) is replayed on the CPU; the burst runs again,
   2,500 tasks, with the head on the port's CPU path. Each burst prints its ring
   rounds' program ms and slots walked, and the client's lease grants,
   grant RPC ms, misses by the state of their shape's leases and lease
   ages. Any ERROR record fails the phase;
9. drives bench.py's ``sim_sched`` through the port's real ``HeadServer``
   (``scheduler/sim.py``: 10,000 nodes of NODE_MIX, 200,000 demands,
   grants to a sink), synchronous then pipelined after a warm-up run:
   placements/s, round p50/p99, divergence 0; every head and ring round of
   the runs, recorded on the card, replays equal on the CPU;
10. runs ``run_elasticity_sim`` at bench.py's part (b) sizes (10,000
   nodes, 200 parked shapes), 1 tick of its 8: the tick's ms, ``solve_path``,
   every tick's ``solve_pack_counts`` on the card, each against the CPU's
   result for its inputs, each distinct input solved once on the CPU
   (per_node and placed equal, the residual within 1e-5);
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
12a. runs bench.py's ``chaos_bench`` on the port (``phase_chaos``, in a
   child process of this script, ``--chaos``, with a temp dir of its own,
   from after the kernels' timing phases to before ``phase_elastic_train``:
   it needs no kernel and spends most of its time waiting out its faults'
   detection, so it runs beside the model phases; its output is printed
   when it ends, and its exit code is checked): a
   ``Cluster`` with its head on the card and a WAL, two 2-CPU agents,
   ``ChaosWorkload`` and ``ChaosOrchestrator`` over the first 12 faults of
   bench.py's seed 20260803 (partitions, stragglers, object drops, node,
   owner and zygote kills), then one ``head_restart``: both runs ``ok``,
   the injected schedule equal to the plan, no acked object lost, no arena
   zombie, no ERROR record; the old head's scheduler state holds no card
   memory after the restart and no other state took any; every head and
   ring round of the phase replays equal on the CPU; seed, fault counts,
   acked, reconstructed, owners killed, recovery p50/p95, breaker opens and
   wall printed;
12b. runs ``tests/test_head_failover.py``'s soak (``phase_failover_soak``,
   in a second child process, ``--failover``, from after
   ``phase_elastic_train`` to before ``phase_mixed_fleet``): a WAL head on the
   card with an auto-promoting standby, two 2-CPU agents, ``ChaosWorkload``
   and seed 20260805's 8 faults (3 leader kills with promotion, 2
   partitions, 3 object drops): the run ``ok``, the schedule equal to the
   plan, every acked object read back, every promoted head's state on the
   card, every killed leader's released and one state resident at the end,
   every head and ring round replayed equal on the CPU;
12c. runs ``tests/test_preemption.py``'s three cluster scenarios
   (``phase_preemption``, in a third child process, ``--preemption``, from
   after ``phase_mixed_fleet`` to before the last phase), each on a fresh
   ``Cluster`` with its head on the card under the reference's fixture
   (a shape starves after 2 retry rounds, 0.2 s cooldown): (a) two running
   retryable sleepers of 10 s killed and requeued for a starving 2-CPU
   task, which ends before they would have; (b) ``max_retries=0`` sleepers
   never killed, each run once, the big task after them; (c) a storm over
   two nodes with one killed: no acked object lost, no at-most-once task
   run twice; nominations and preemptions in (a) and (c), every head and
   ring round (nominations too) replayed equal on the CPU, no ERROR record;
13. serves the head's dashboard (first, while nvcc builds the kernels of
   phase 1, since it needs none of them) (``dashboard_port=0``, the standard
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
17. prints every phase's seconds on one line, then the kernel table as one
   JSON line, then the result line.
"""
from __future__ import annotations

import atexit
import json
import math
import os
import re
import shutil
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
    BLOCK_K,
    BLOCK_Q,
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
def start_build():
    """Starts ``_cuda.build_all()`` (one nvcc a source, all at once) in a
    thread, so a phase that needs no kernel can run meanwhile; returns a
    function that waits for it and gives (built, seconds), or raises what
    the build raised."""
    import threading

    box = {}

    def run():
        t0 = time.monotonic()
        try:
            box["built"] = _cuda.build_all()
        except BaseException as exc:  # noqa: BLE001 - re-raised by the join
            box["exc"] = exc
        box["s"] = time.monotonic() - t0

    th = threading.Thread(target=run, name="nvcc-build")
    th.start()

    def join():
        th.join()
        if "exc" in box:
            raise box["exc"]
        return box["built"], box["s"]

    return join


def phase_card_and_build(build) -> None:
    """The card's line, the kernels' build (waiting for ``build``, the join
    that ``start_build()`` returns) and their ptxas report."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    built, build_s = build()
    print(f"build: {build_s:.1f} s for {sorted(built) or 'nothing (cached)'} "
          "(begun beside the first phase)")
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

    from ray_tpu_torch.chaos import InvariantChecker
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
        add_nodes(c, ({"CPU": 2.0, **gpu}, node), ({"CPU": 2.0, **gpu}, node))
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
            pre_epochs = {trainer.gang_id: gangs[trainer.gang_id]["epoch"]}
            t_kill = time.monotonic()
            c.kill_node(victim)
            # the chaos package's invariant: the gang fences the dead
            # generation and registers a membership whose nodes all live
            reshaped = InvariantChecker(c, None).wait_gang_reshaped(pre_epochs, timeout=60)
            check(reshaped == [], f"elastic: the gang did not reshape: {reshaped}")
            print(f"elastic: wait_gang_reshaped clean {time.monotonic() - t_kill:.2f} s after "
                  f"the kill (epoch {pre_epochs[trainer.gang_id]} -> "
                  f"{c.head._gangs.get(trainer.gang_id, {}).get('epoch')})")
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
# 5d. serving: deployments, the router fleet, build_llm_deployment
# ---------------------------------------------------------------------------
# bench.py serve_bench's traffic: three hot prefixes take 80% of the prompts
SERVE_HOT = ["the quick brown fox jumps over it " * 2,
             "in the beginning there was a tape " * 2,
             "once upon a time in a cluster far " * 2]
# bench.py's per-request head surfaces, which the steady state must not call
HEAD_RPCS = ("SubmitLease", "WaitObjectBatch", "WaitObject", "PutObject",
             "GrantTaskLease", "CreateActor", "WaitActor", "LocateObjects")
SERVE_ENGINE = dict(engine="continuous", max_batch=4, page_size=8, n_pages=128)  # bench.py's
F32_PROMPTS = ["a prompt of plain words", "tokens come one at a time",
               "the card decodes what the host asks", "pages of keys and values",
               "a router in front of replicas", "eight greedy streams in f32",
               "no tensor float here", "the last of the prompts"]


def id_tokenizer():
    """The engines' byte tokenizer, whose decode names every token id
    (``"<id> "``): the byte tokenizer decodes each id of 256 and above,
    most of ModelConfig()'s 32,000, to nothing. The class is local, so
    replicas unpickle it by value."""
    from ray_tpu_torch.llm.engine import ByteTokenizer

    class IdTokenizer(ByteTokenizer):
        def decode(self, ids):
            return "".join(f"{int(i)} " for i in ids)

    return IdTokenizer()


def text_ids(texts) -> list:
    return [int(x) for x in "".join(texts).split()]


def serve_model(dtype, model=None, seed=0):
    """ModelConfig() (or ``model``'s overrides) in ``dtype`` and its seeded
    weights on the host, as the deployment's closure carries them."""
    cfg = tfm.ModelConfig(**dict(model or {}, dtype=dtype))
    return cfg, tfm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def serve_cluster(device: str, nodes: int = 2, workers: int = 3):
    """(a ``Cluster`` with the head on ``device`` and ``nodes`` agents that
    share the card (one GPU each, which replicas lease in quarters), its
    client, the runtime the serving phases use)."""
    from ray_tpu_torch.core.runtime import set_runtime

    _platform_env(device)
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"  # f32 stays f32 in every replica
    c = _cluster(device)
    gpu = {"GPU": 1.0} if device == "cuda" else {}
    add_nodes(c, *[({"CPU": 4.0, **gpu}, dict(num_workers=workers))] * nodes)
    client = c.client()
    set_runtime(client)
    return c, client


def close_cluster(c, client) -> None:
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.core.runtime import set_runtime

    try:
        serve.shutdown()
    finally:
        set_runtime(None)
        client.shutdown()
        c.shutdown()
        os.environ.pop("NVIDIA_TF32_OVERRIDE", None)
    # the replicas hold CUDA contexts; give their processes time to end
    t0, left, marks = time.perf_counter(), descendants(), [5.0, 15.0]
    while left and time.perf_counter() - t0 < 60.0:
        time.sleep(0.5)
        left = descendants()
        if left and marks and time.perf_counter() - t0 > marks[0]:
            print(f"serve cluster: still running {marks.pop(0):.0f} s after the shutdown: "
                  + "; ".join(f"{pid} {proc_state(pid)}: {cmd[-60:]}"
                              for pid, cmd in left.items()), flush=True)
    if left:  # each worker dumps its threads' stacks on SIGUSR1
        for pid in left:
            try:
                os.kill(pid, signal.SIGUSR1)
            except OSError:
                pass
            print(f"serve cluster: pid {pid} still running {time.perf_counter() - t0:.1f} s "
                  f"after the shutdown: {proc_state(pid)}: {left[pid]}", flush=True)
    else:
        print(f"serve cluster: every process ended {time.perf_counter() - t0:.1f} s after the "
              "shutdown")


def proc_state(pid: int) -> str:
    """What /proc shows of a process: its state, parent (pid and the end of
    its command line) and its threads' names; '?' for what it cannot read."""
    def read(path):
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return None

    status = dict(line.split(":\t", 1) for line in (read(f"/proc/{pid}/status") or "").splitlines()
                  if ":\t" in line)
    ppid = status.get("PPid", "?").strip()
    parent = (read(f"/proc/{ppid}/cmdline") or "?").replace("\0", " ").strip()[-50:]
    try:
        tids = os.listdir(f"/proc/{pid}/task")
    except OSError:
        tids = []
    names = {}
    for tid in tids:
        name = (read(f"/proc/{pid}/task/{tid}/comm") or "?").strip()
        names[name] = names.get(name, 0) + 1
    return (f"state {status.get('State', '?').strip()}, ppid {ppid} ({parent}), threads "
            + ", ".join(f"{k} x{v}" for k, v in sorted(names.items())))


def replica_actors(name: str) -> list:
    from ray_tpu_torch.serve.deployment import _apps

    rs = _apps[name]
    with rs.lock:
        return [r.actor for r in rs.replicas]


def replica_launches(rtt, name: str, reset: bool = False) -> list:
    """Each replica's paged launches, counted inside its own process."""
    return [rtt.get(a.kernel_launches.remote(reset), timeout=60)["paged_attention_decode"]
            for a in replica_actors(name)]


def replica_stats(rtt, name: str) -> list:
    return [rtt.get(a.serve_stats.remote(), timeout=60) for a in replica_actors(name)]


def head_rpcs() -> dict:
    """The head's per-request handlers' call counts so far, by name."""
    from ray_tpu_torch.cluster.rpc import HANDLER_STATS

    snap = HANDLER_STATS.snapshot()
    return {n: (snap.get(n) or {}).get("count", 0) for n in HEAD_RPCS}


def window_pct(hist, label: dict, base, q: float) -> float:
    from ray_tpu_torch.util.metrics import percentile_from_buckets

    cur = hist.buckets_snapshot(label)
    return percentile_from_buckets(hist.boundaries, [max(0, a - b) for a, b in zip(cur, base)], q)


def serve_app(cfg, params, name, device, **kw):
    from ray_tpu_torch.llm import build_llm_deployment

    gpu = {"num_gpus": 0.25} if device == "cuda" else {}
    return build_llm_deployment(cfg, params, name=name, device=device, tokenizer=id_tokenizer(),
                                ray_actor_options=gpu, **kw)


def run_stream(router, payload, tenant=None, sheds=None):
    """(the stream's token ids, or None when it was shed, its reason then
    counted in ``sheds`` if given; an error raises)."""
    from ray_tpu_torch.serve.admission import Overloaded

    args = (payload,) if tenant is None else (payload, tenant)
    try:
        stream = router.stream(*args)
    except Overloaded as exc:
        if sheds is not None:
            sheds[exc.reason] = sheds.get(exc.reason, 0) + 1
        return None
    try:
        return text_ids(list(stream))
    finally:
        stream.close()


def open_loop(fn, qps: float, seconds: float) -> tuple:
    """bench.py's open loop: one thread per arrival at ``qps`` for
    ``seconds``, whether or not earlier requests finished. Returns (each
    arrival's result or its exception, the wall seconds)."""
    import threading

    results, threads = {}, []

    def one(i):
        try:
            results[i] = fn(i)
        except Exception as exc:  # noqa: BLE001 - counted as an error
            results[i] = exc

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        threads.append(threading.Thread(target=one, args=(len(threads),)))
        threads[-1].start()
        delay = t0 + len(threads) / qps - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
    for t in threads:
        t.join(timeout=300)
    return [results.get(i, TimeoutError("no result")) for i in range(len(threads))], \
        time.perf_counter() - t0


def http_generate(name: str, payload: dict, standard_library: bool) -> str:
    """One POST /<name> through ``start_http_proxy``: the aiohttp proxy, or
    with ``standard_library`` the ``ThreadingHTTPServer`` it takes where
    aiohttp does not import. Stops the server after the reply."""
    import importlib
    import importlib.util
    import urllib.request

    import ray_tpu_torch.serve as serve

    dep = importlib.import_module("ray_tpu_torch.serve.deployment")
    find_spec = importlib.util.find_spec
    if standard_library:
        importlib.util.find_spec = lambda m, *a: None if m == "aiohttp" else find_spec(m, *a)
    try:
        port = serve.start_http_proxy(port=0)
    finally:
        importlib.util.find_spec = find_spec
    req = urllib.request.Request(f"http://127.0.0.1:{port}/{name}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["result"]["generated_text"]
    finally:
        dep._http_server.shutdown()
        dep._http_server = None


def serve_paged_check(cfg) -> None:
    """The paged kernel against its plain version at the decode shape the
    serving phases give it (max_batch 4, 8-token pages, 128 pages)."""
    b, page, n_pages = SERVE_ENGINE["max_batch"], SERVE_ENGINE["page_size"], SERVE_ENGINE["n_pages"]
    kh, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    args = paged_inputs(b, kh, g, d, n_pages, page, 16, [83, 80, 9, 128], cfg.dtype, 41)
    paged_case(f"serve shape (B={b}, page {page}, {n_pages} pages)", args, page,
               2e-2 if cfg.dtype == torch.bfloat16 else 2e-5)


def phase_serve_deployment(device: str = "cuda", model=None, qps: float = 6.0,
                           seconds: float = 20.0, max_new: int = 12) -> int:
    """bench.py's serve_bench on the port: ``build_llm_deployment`` of
    ModelConfig() (bf16), 2 continuous replicas in worker processes on the
    card (max_batch 4, prefix cache on) behind the lease-routed router on 2
    agents, open loop at ``qps`` for ``seconds``, 80% of the prompts from
    three hot prefixes, ``max_new`` tokens each. Sustained QPS, TTFT p50, e2e
    p99, shed count and prefix-hit rate; zero per-request head RPCs; every
    replica launched the paged kernel; every admitted stream ended with
    ``max_new`` tokens, as the engine's own run of the request does (no EOS).
    Then one POST through ``start_http_proxy`` equals the router's unary
    call, and a one-replica f32 deployment (TF32 off) streams 8 greedy
    prompts token for token as the port's engine on the CPU. Returns the
    paged launches counted inside the replicas."""
    import random

    import ray_tpu_torch as rtt
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.serve.admission import SERVE_SHED
    from ray_tpu_torch.serve.router import SERVE_E2E_MS, SERVE_TTFT_MS

    import importlib.util

    t0 = time.perf_counter()
    print("serve ingresses on this machine: " + ", ".join(
        f"{m} {'imports' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("aiohttp", "grpc")) + " (the HTTP proxy takes aiohttp where it imports, "
        "the standard library's server otherwise; the proto ingress needs grpc)")
    cfg, params = serve_model(torch.bfloat16, model)
    if device == "cuda":
        serve_paged_check(cfg)
    name = "serve-llm"
    try:
        serve.run(serve_app(cfg, params, name, device, num_replicas=2, **SERVE_ENGINE))
        router = serve.get_router(name)
        rng = random.Random(7)
        picks = [rng.choice(SERVE_HOT) if rng.random() < 0.8
                 else f"cold prompt number {i} with some extra words" for i in range(int(qps * seconds) + 8)]

        def request(i):
            return run_stream(router, {"prompt": picks[i], "max_new_tokens": max_new})

        warm = open_loop(request, 4 / 0.05, 0.05)[0]  # 4 arrivals: both replicas warm
        check(all(isinstance(r, list) and len(r) == max_new for r in warm), f"serve warm-up: {warm}")
        lbl = {"deployment": name}
        ttft0, e2e0 = SERVE_TTFT_MS.buckets_snapshot(lbl), SERVE_E2E_MS.buckets_snapshot(lbl)
        shed0 = sum(SERVE_SHED.values_by_label().values())
        replica_launches(rtt, name, reset=True)
        rpcs0 = head_rpcs()
        results, wall = open_loop(request, qps, seconds)
        rpcs = {k: v - rpcs0[k] for k, v in head_rpcs().items() if v > rpcs0[k]}
        launches = replica_launches(rtt, name)
        shed = sum(SERVE_SHED.values_by_label().values()) - shed0
        errors = [r for r in results if isinstance(r, Exception)]
        done = [r for r in results if isinstance(r, list)]
        stats = replica_stats(rtt, name)
        hits = sum((s.get("prefix_cache") or {}).get("hits", 0) for s in stats)
        lookups = hits + sum((s.get("prefix_cache") or {}).get("misses", 0) for s in stats)
        ttft = window_pct(SERVE_TTFT_MS, lbl, ttft0, 0.5)
        e2e = window_pct(SERVE_E2E_MS, lbl, e2e0, 0.99)
        print(f"serve deployment ModelConfig() bf16, 2 replicas, open loop {qps:g} QPS x "
              f"{seconds:g} s, {max_new} tokens: {len(results)} launched, {len(done)} completed, "
              f"{len(errors)} errors, {shed} shed; sustained {len(done) / wall:.2f} QPS, TTFT p50 "
              f"{ttft:.1f} ms, e2e p99 {e2e:.1f} ms, prefix hits {hits}/{lookups}; head RPCs "
              f"in the window {rpcs or 0}; paged launches "
              f"per replica {launches} [{card_line()}]")
        check(not errors, f"serve: {len(errors)} streams failed, first: {errors[:1]!r}")
        check(all(len(r) == max_new for r in done),
              f"serve: stream lengths {sorted({len(r) for r in done})}, not {max_new}")
        check(len(done) + shed == len(results), "serve: a stream was neither admitted nor shed")
        # the controller's liveness sweep reads each replica's state with one
        # WaitActor a second (deployment.reap_dead_replicas), whatever the
        # traffic; every other head call of the window would be per request
        sweep = 2 * (math.ceil(wall) + 2)
        check(set(rpcs) <= {"WaitActor"} and rpcs.get("WaitActor", 0) <= sweep,
              f"serve: per-request head RPCs in the steady state: {rpcs} (the liveness "
              f"sweep's WaitActor at most {sweep})")
        check(len(launches) == 2 and all(n > 0 for n in launches),
              f"serve: paged launches per replica {launches}")
        check(lookups > 0 and hits > 0, f"serve: prefix cache hits {hits} of {lookups}")

        payload = {"prompt": "hello", "max_new_tokens": max_new}
        unary = router.call(payload, timeout=120)["generated_text"]
        kinds = (["aiohttp"] if importlib.util.find_spec("aiohttp") else []) + ["standard library"]
        for kind in kinds:
            text = http_generate(name, payload, kind == "standard library")
            print(f"serve http ({kind} server): POST /{name} -> {len(text_ids([text]))} tokens, "
                  f"equal to the router's unary call: {text == unary}")
            check(text == unary and text_ids([text]),
                  f"serve: the {kind} proxy's text differs from the router's unary call")
        serve.shutdown()

        # f32, TF32 off: the deployment's streams against the engine on the CPU
        cfg32, p32 = serve_model(torch.float32, model)
        serve.run(serve_app(cfg32, p32, "serve-f32", device, num_replicas=1,
                            prefix_cache=False, **SERVE_ENGINE))
        router32 = serve.get_router("serve-f32")
        got = [run_stream(router32, {"prompt": p, "max_new_tokens": 24}) for p in F32_PROMPTS]
        cpu = ContinuousBatchingEngine(cfg32, p32, device="cpu", tokenizer=id_tokenizer(),
                                       **{k: v for k, v in SERVE_ENGINE.items() if k != "engine"})
        want = [list(cpu.stream_ids(cpu.tokenizer.encode(p), GenerationConfig(max_new_tokens=24)))
                for p in F32_PROMPTS]
        same = sum(a == b for a, b in zip(got, want))
        print(f"serve f32 deployment vs the engine on the CPU (TF32 off): {same}/{len(want)} "
              f"greedy streams token-exact")
        check(same == len(want), "serve: f32 deployment streams differ from the CPU engine's")
    finally:
        serve.shutdown()
    print(f"serve deployment phase: {time.perf_counter() - t0:.1f} s")
    return sum(launches)


def phase_serve_disagg(device: str = "cuda", model=None, max_new: int = 10,
                       burst_n: int = 24, burst_conc: int = 8) -> int:
    """bench.py's serve_disagg_bench on the port: ``build_llm_deployment``
    of ModelConfig() (bf16) with one prefill replica and one, then two,
    decode replicas, two weight variants (m0, the base, and m1). A
    closed-loop burst of ``burst_n`` requests at ``burst_conc`` at each
    decode count, with bench.py's traffic: every request names m0, its
    tenant drawn from the mix 0.7/0.2/0.1, each tenant of weight 1. TTFT
    p50, decode tokens/s, the hand-off's MB/s; every stream adopts shipped
    pages (no fallback to a local prefill, no full prefill on the decode
    side), and every decode replica launches the paged kernel (the second
    one takes m0 traffic: it starts on the base). Then forced swaps between
    m0 and m1 under live streams, with no stream error. Returns the paged
    launches counted inside the decode replicas."""
    import random
    import threading

    import ray_tpu_torch as rtt
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.serve.router import SERVE_TTFT_MS

    t0 = time.perf_counter()
    cfg, base = serve_model(torch.bfloat16, model, seed=7)
    alt = serve_model(torch.bfloat16, model, seed=11)[1]
    name = "serve-disagg"
    launches_total = 0
    try:
        serve.run(serve_app(cfg, base, name, device, num_replicas=1, prefill_replicas=1,
                            variants={"m1": alt}, base_model_id="m0", **SERVE_ENGINE))
        router = serve.get_router(name)
        tenant_mix = [("t-flood", 0.7), ("t-mid", 0.2), ("t-victim", 0.1)]  # bench.py's
        router.admission.set_tenant_weights({t: 1.0 for t, _ in tenant_mix})
        rng = random.Random(7)
        lock = threading.Lock()

        def pick_tenant():
            r, acc = rng.random(), 0.0
            for t, w in tenant_mix:
                acc += w
                if r < acc:
                    return t
            return tenant_mix[-1][0]

        def request(i, model_id="m0", tenant=None):
            """One stream naming ``model_id``; the router keeps it to the
            decode replicas that can serve that variant without a swap (a
            cold one swaps). Without ``tenant``, one from bench.py's mix."""
            with lock:
                prompt = (rng.choice(SERVE_HOT) if rng.random() < 0.8
                          else f"cold prompt number {i} with some extra words")
                tenant = tenant or pick_tenant()
            return run_stream(router, {"prompt": prompt, "max_new_tokens": max_new,
                                       "model": model_id}, tenant)

        def counters():
            keys = ("handoff_bytes", "handoff_s", "handoffs", "handoff_fallbacks",
                    "full_prefill_count", "adopted_count", "weight_swaps")
            out = dict.fromkeys(keys, 0)
            for s in replica_stats(rtt, name):
                for k in keys:
                    out[k] += s.get(k) or 0
            return out

        def burst():
            results, counter = [], [0]

            def worker():
                while True:
                    with lock:
                        if counter[0] >= burst_n:
                            return
                        counter[0] += 1
                        i = counter[0]
                    try:
                        results.append(request(i))
                    except Exception as exc:  # noqa: BLE001 - counted below
                        results.append(exc)

            t1 = time.perf_counter()
            threads = [threading.Thread(target=worker) for _ in range(burst_conc)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            return results, time.perf_counter() - t1

        for i, m in enumerate(("m0", "m1", "m0")):  # warm both tiers and both variants
            check(len(request(i, m, "t-flood") or []) == max_new, "disagg: a warm-up stream failed")
        lbl = {"deployment": name}
        rows = []
        for n_decode in (1, 2):
            if n_decode == 2:
                router._rs.add_replica()
                for r in open_loop(lambda i: request(100 + i, "m0", "t-flood"), 80.0, 0.05)[0]:
                    check(isinstance(r, list), f"disagg: warm-up of the new replica: {r!r}")
            replica_launches(rtt, name, reset=True)
            before, ttft0 = counters(), SERVE_TTFT_MS.buckets_snapshot(lbl)
            results, wall = burst()
            after, launches = counters(), replica_launches(rtt, name)
            errors = [r for r in results if isinstance(r, Exception)]
            done = [r for r in results if isinstance(r, list) and len(r) == max_new]
            d = {k: after[k] - before[k] for k in after}
            mbps = d["handoff_bytes"] / d["handoff_s"] / 2**20 if d["handoff_s"] else float("nan")
            rows.append(dict(tps=len(done) * max_new / wall,
                             ttft=window_pct(SERVE_TTFT_MS, lbl, ttft0, 0.5)))
            print(f"serve disagg ModelConfig() bf16, 1 prefill + {n_decode} decode: burst "
                  f"{burst_n} at {burst_conc}: {len(done)} completed, {len(errors)} errors in "
                  f"{wall:.2f} s, decode {rows[-1]['tps']:.1f} tokens/s, TTFT p50 "
                  f"{rows[-1]['ttft']:.1f} ms; hand-offs {d['handoffs']} ({d['handoff_bytes'] / 2**20:.1f} "
                  f"MiB, {mbps:.1f} MB/s), fallbacks {d['handoff_fallbacks']}, adopted "
                  f"{d['adopted_count']}, decode-side full prefills {d['full_prefill_count']}; "
                  f"paged launches per decode replica {launches} [{card_line()}]")
            check(not errors and len(done) == burst_n,
                  f"disagg: {len(done)}/{burst_n} streams completed, errors {errors[:1]!r}")
            check(d["handoff_fallbacks"] == 0 and d["full_prefill_count"] == 0,
                  f"disagg: {d['handoff_fallbacks']} fallbacks, {d['full_prefill_count']} full "
                  f"prefills in the steady state")
            check(d["adopted_count"] == d["handoffs"] == burst_n,
                  f"disagg: {d['adopted_count']} adopted, {d['handoffs']} hand-offs, not {burst_n}")
            check(len(launches) == n_decode and all(n > 0 for n in launches),
                  f"disagg: paged launches per decode replica {launches}")
            launches_total += sum(launches)
        print(f"serve disagg scaling 1 -> 2 decode replicas: {rows[1]['tps'] / rows[0]['tps']:.3f}x "
              f"decode tokens/s, TTFT p50 {rows[0]['ttft']:.1f} -> {rows[1]['ttft']:.1f} ms")

        swaps0 = counters()
        results = open_loop(lambda i: request(200 + i, "m0" if i % 2 else "m1", "t-mid"), 10.0, 0.6)[0]
        swaps = counters()
        errors = [r for r in results if not (isinstance(r, list) and len(r) == max_new)]
        print(f"serve disagg hot swap: {len(results)} streams alternating m0/m1, {len(errors)} "
              f"errors, {swaps['weight_swaps'] - swaps0['weight_swaps']} decode-side swaps, "
              f"fallbacks {swaps['handoff_fallbacks'] - swaps0['handoff_fallbacks']}")
        check(not errors, f"disagg: swap streams failed: {errors[:1]!r}")
        check(swaps["weight_swaps"] > swaps0["weight_swaps"], "disagg: no swap happened")
        check(swaps["handoff_fallbacks"] == 0, "disagg: a hand-off fell back to a local prefill")
    finally:
        serve.shutdown()
    print(f"serve disagg phase: {time.perf_counter() - t0:.1f} s")
    return launches_total


def token_server():
    """bench.py's _BenchTokenServer: a resumable stream of ``n`` tokens
    ("tok0", "tok1", ...), cheap enough that the ingress routers, not the
    replicas, are what the fleet rows measure. The class is local, so
    replicas unpickle it by value."""

    class TokenServer:
        def __init__(self, delay_s: float = 0.0):
            self.delay_s = float(delay_s)

        def stream_to(self, writer, request):
            n = int(request.get("n", 16))
            for i in range(int(request.get("resume_from", 0)), n):
                if self.delay_s:
                    time.sleep(self.delay_s)
                writer.write(f"tok{i}")
            writer.close_channel()
            return n

    return TokenServer


def phase_router_fleet(device: str = "cuda", model=None, qps: float = 40.0,
                       seconds: float = 6.0, n_tokens: int = 8, kills: int = 3) -> int:
    """bench.py's router_scale_bench on the port: its token server (2
    replicas) behind 1 and 2 ingress routers, open loop at ``qps`` for
    ``seconds`` over 8 tenants: sustained QPS and e2e p99 per fleet size,
    and the 2-router p99 over the 1-router p99 that bench.py's scale gate
    reads. Then the failover row on ``build_llm_deployment`` (ModelConfig()
    f32, TF32 off, 2 continuous replicas on the card): 4 streams on 4
    tenants, one of the two routers killed after the first token,
    ``kills`` times; each stream that failed over resumes on the sibling,
    and every stream's tokens equal an unbroken run's of the same requests.
    Prints the failover p95. Returns the paged launches counted inside the
    LLM replicas."""
    import random

    import ray_tpu_torch as rtt
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.serve.admission import Overloaded
    from ray_tpu_torch.serve.deployment import _apps, _routers
    from ray_tpu_torch.serve.fleet import SERVE_ROUTER_FAILOVER_S, RouterFleet
    from ray_tpu_torch.serve.router import SERVE_E2E_MS

    t0 = time.perf_counter()
    tenants = [f"tenant-{i}" for i in range(8)]
    p99 = {}
    try:
        for n_routers in (1, 2):
            os.environ["RAY_TPU_SERVE_ROUTERS"] = str(n_routers)
            name = f"fleet{n_routers}"
            serve.run(serve.deployment(name=name, num_replicas=2, resumable_streams=True)(
                token_server()).bind())
            fleet = serve.get_router(name)
            check(len(fleet.routers) == n_routers, f"fleet: {len(fleet.routers)} routers")
            rng = random.Random(17)
            picks = [rng.choice(tenants) for _ in range(int(qps * seconds) + 8)]

            def request(i):
                try:
                    stream = fleet.stream({"n": n_tokens}, picks[i])
                except Overloaded:
                    return None
                try:
                    return list(stream)
                finally:
                    stream.close()

            open_loop(request, 80.0, 0.05)  # warm both replicas' dispatch, off the clock
            lbl = {"deployment": name}
            e2e0 = SERVE_E2E_MS.buckets_snapshot(lbl)
            results, wall = open_loop(request, qps, seconds)
            want = [f"tok{i}" for i in range(n_tokens)]
            done = [r for r in results if r == want]
            shed = sum(r is None for r in results)
            errors = [r for r in results if isinstance(r, Exception)]
            p99[n_routers] = window_pct(SERVE_E2E_MS, lbl, e2e0, 0.99)
            print(f"router fleet of {n_routers}, bench.py's token server, 2 replicas, open loop "
                  f"{qps:g} QPS x {seconds:g} s, {n_tokens} tokens: {len(done)}/{len(results)} "
                  f"completed, {shed} shed, {len(errors)} errors, {len(done) / wall:.2f} QPS, "
                  f"e2e p99 {p99[n_routers]:.1f} ms [{card_line()}]")
            check(not errors, f"fleet: streams failed: {errors[:1]!r}")
            check(len(done) + shed == len(results), "fleet: a stream came short")
            serve.shutdown()
        print(f"router fleet scale: e2e p99 at 2 routers / at 1 router = "
              f"{p99[2] / p99[1]:.3f} (bench.py's gate, off by default, holds the largest "
              f"fleet's p99 within max(1.5x, 50 ms) of one router's)")

        # the failover row, f32: a router kill severs push-sink streams (the
        # shm rings of same-host replicas would ride it out)
        os.environ["RAY_TPU_SERVE_ROUTERS"] = "2"
        os.environ["RAY_TPU_SERVE_SHM_STREAMS"] = "0"
        cfg32, p32 = serve_model(torch.float32, model)
        serve.run(serve_app(cfg32, p32, "fleet-f32", device, num_replicas=2,
                            prefix_cache=False, **SERVE_ENGINE))
        fleet = serve.get_router("fleet-f32")
        replica_launches(rtt, "fleet-f32", reset=True)
        payloads = [{"prompt": f"a stream that outlives its router {i}", "max_new_tokens": 40}
                    for i in range(4)]

        def open_streams(fleet):
            streams = [fleet.stream(p, t) for p, t in zip(payloads, tenants)]
            return streams, [[s.read(timeout=120)] for s in streams]

        def drain(streams, got):
            for s, g in zip(streams, got):
                g.extend(s)
                s.close()
            return [text_ids(g) for g in got]

        unbroken = drain(*open_streams(fleet))
        check(all(len(u) == 40 for u in unbroken), "fleet: an unbroken stream came short")
        lbl = {"deployment": "fleet-f32"}
        fo0 = SERVE_ROUTER_FAILOVER_S.buckets_snapshot(lbl)
        resumed = exact = 0
        for _ in range(kills):
            streams, got = open_streams(fleet)
            victim = streams[0]._rid
            check(fleet.chaos_kill_router(rid=victim) == victim, "fleet: the kill missed")
            ids = drain(streams, got)
            resumed += sum(s.router_failovers > 0 for s in streams)
            exact += sum(a == b for a, b in zip(ids, unbroken))
            check(streams[0].router_failovers > 0, "fleet: the victim's stream did not fail over")
            _routers["fleet-f32"].close()  # a fresh two-router fleet for the next kill
            fleet = _routers["fleet-f32"] = RouterFleet(_apps["fleet-f32"])
        p95 = window_pct(SERVE_ROUTER_FAILOVER_S, lbl, fo0, 0.95)
        launches = replica_launches(rtt, "fleet-f32")
        print(f"router fleet failover, ModelConfig() f32 (TF32 off), 2 replicas: {kills} kills, "
              f"{resumed} streams resumed on the sibling, {exact}/{4 * kills} streams token-exact "
              f"with the unbroken run, failover p95 {p95:.3f} s; paged launches per replica "
              f"{launches} [{card_line()}]")
        check(exact == 4 * kills, "fleet: a failed-over stream differs from the unbroken run")
        check(len(launches) == 2 and all(n > 0 for n in launches),
              f"fleet: paged launches per replica {launches}")
    finally:
        os.environ.pop("RAY_TPU_SERVE_ROUTERS", None)
        os.environ.pop("RAY_TPU_SERVE_SHM_STREAMS", None)
        serve.shutdown()
    print(f"router fleet phase: {time.perf_counter() - t0:.1f} s")
    return sum(launches)


CHAOS_SERVE_ENGINE = dict(engine="continuous", max_batch=2, page_size=8, n_pages=64)


def _wait_until(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        check(time.monotonic() < deadline, f"{what}: not within {timeout:.0f} s")
        time.sleep(0.2)


def phase_chaos_serve(c, client, device: str = "cuda", model=None, max_new: int = 10) -> int:
    """The reference's two slow serve chaos cases on ``serve_cluster``'s
    cluster at ``ModelConfig()``'s width in f32 (TF32 off): a
    ``build_llm_deployment`` of 2 continuous replicas on the card (max_batch
    2, 8-token pages, 64 pages) behind a 2-router fleet (push streams),
    ``ServeStreamWorkload`` (2 threads, 10 greedy tokens a stream, each
    held against the engine on the CPU with the same weights), then
    ``make_plan(11, 2, SERVE_MIX, allow=("replica_kill",))`` and
    ``make_plan(7, 1, ROUTER_MIX, allow=("router_kill",))`` under
    ``ChaosOrchestrator``: both ``ok``, every stream token-exact, the
    replica set backfilled to 2 with each backfilled replica launching the
    paged kernel, every stream in flight on the killed router resumed
    ``ok`` on its sibling, one router left, no arena zombie. Returns the
    paged launches counted inside the replicas alive at the end, from zero
    at the deployment's start (a killed replica's count dies with it)."""
    import ray_tpu_torch as rtt
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.chaos import (
        ROUTER_MIX,
        SERVE_MIX,
        ChaosOrchestrator,
        ChaosWorkload,
        ServeStreamWorkload,
        make_plan,
    )

    t0 = time.perf_counter()
    name, prompt = "chaos-llm", "chaos stream"
    os.environ["RAY_TPU_SERVE_ROUTERS"] = "2"
    os.environ["RAY_TPU_SERVE_SHM_STREAMS"] = "0"  # a router kill severs push streams
    cfg32, p32 = serve_model(torch.float32, model)
    eng = ContinuousBatchingEngine(cfg32, p32, device="cpu", tokenizer=id_tokenizer(),
                                   **{k: v for k, v in CHAOS_SERVE_ENGINE.items()
                                      if k != "engine"})
    gen = GenerationConfig(max_new_tokens=max_new, temperature=0.0, seed=0)
    expected = [eng.tokenizer.decode([int(t)])
                for t in eng.stream_ids(eng.tokenizer.encode(prompt), gen)]
    check(len(expected) == max_new, f"chaos serve: the CPU engine gave {len(expected)} tokens")
    workload = None
    runs = []
    try:
        serve.run(serve_app(cfg32, p32, name, device, num_replicas=2, **CHAOS_SERVE_ENGINE))
        fleet = serve.get_router(name)
        check(fleet.resumable and len(fleet.routers) == 2,
              f"chaos serve: {len(fleet.routers)} routers, resumable {fleet.resumable}")
        first = {a._actor_id for a in replica_actors(name)}
        replica_launches(rtt, name, reset=True)
        workload = ServeStreamWorkload(fleet, {"prompt": prompt, "max_new_tokens": max_new},
                                       expected, concurrency=2)
        workload.start()
        _wait_until(lambda: workload.completed >= 2 or workload.verify_failures, 180.0,
                    "chaos serve: warm streams")
        check(not workload.verify_failures, f"chaos serve: {workload.verify_failures[:1]}")
        chaos_wl = ChaosWorkload(client, payload_bytes=150_000, num_actors=1)
        for plan, want in ((make_plan(seed=11, num_faults=2, mix=SERVE_MIX,
                                      allow=("replica_kill",), min_delay_s=0.5, max_delay_s=1.0),
                            {"replica_kill": 2}),
                           (make_plan(seed=7, num_faults=1, mix=ROUTER_MIX,
                                      allow=("router_kill",), min_delay_s=0.5, max_delay_s=1.0),
                            {"router_kill": 1})):
            check(plan.counts() == want, f"chaos serve: plan {plan.counts()}")
            orch = ChaosOrchestrator(c, chaos_wl, plan, node_resources={"CPU": 4.0},
                                     convergence_budget_s=120.0, serve_adapter=workload)
            t1 = time.perf_counter()
            res = orch.run()
            runs.append((plan, res, time.perf_counter() - t1, workload.completed))
            for f in res.faults:
                print(f"chaos serve #{f.spec.index} {f.spec.kind}: {f.recovery_s:.3f} s, "
                      f"{f.detail}" + (f"; FAILED {f.failures}" if not f.ok else ""))
            check(res.ok, f"chaos serve seed {plan.seed}: {res.summary()['failures']}")
            check(not workload.verify_failures, f"chaos serve: {workload.verify_failures[:1]}")
            if "replica_kill" in want:
                check(workload.completed >= 3, f"chaos serve: {workload.completed} completed")
                check(workload.live_replicas() == 2,
                      f"chaos serve: {workload.live_replicas()} live replicas, not 2")
                fresh = [a for a in replica_actors(name) if a._actor_id not in first]
                check(len(fresh) >= 1, "chaos serve: no replica was backfilled")

                def fresh_launched():
                    return all(rtt.get(a.kernel_launches.remote(False), timeout=60)
                               ["paged_attention_decode"] > 0 for a in fresh)

                _wait_until(fresh_launched, 60.0,
                            "chaos serve: a backfilled replica launching the paged kernel")
        workload.stop()
        launches = replica_launches(rtt, name)
        outcomes = workload.watched_outcomes()
        routers_live = workload.routers_live()
    finally:
        if workload is not None:
            workload.stop()
        os.environ.pop("RAY_TPU_SERVE_ROUTERS", None)
        os.environ.pop("RAY_TPU_SERVE_SHM_STREAMS", None)
        serve.shutdown()
    check(workload.routers_killed == 1, f"chaos serve: {workload.routers_killed} routers killed")
    check(bool(outcomes) and all(v == "ok" for v in outcomes.values()),
          f"chaos serve: streams in flight on the killed router: {outcomes}")
    check(routers_live == 1, f"chaos serve: {routers_live} routers live after the kill")
    check(all(res.arena_zombies_after == 0 for _, res, _, _ in runs),
          f"chaos serve: arena zombies {[res.arena_zombies_after for _, res, _, _ in runs]}")
    check(len(launches) == 2 and all(n > 0 for n in launches),
          f"chaos serve: paged launches per replica {launches}")
    for plan, res, wall, done in runs:
        lat = res.recovery_percentiles()
        print(f"chaos serve seed {plan.seed} {res.summary()['fault_counts']}, ModelConfig() f32 "
              f"(TF32 off), 2 replicas behind 2 routers [{card_line()}]: ok {res.ok}, recovery "
              f"p50 {lat['p50']:.3f} s p95 {lat['p95']:.3f} s, {done} streams completed "
              f"token-exact so far, arena zombies {res.arena_zombies_after}, wall {wall:.1f} s")
    print(f"chaos serve: {workload.completed} streams token-exact, {workload.stream_errors} "
          f"stream errors tolerated, 0 verify failures; {len(outcomes)} streams in flight on the "
          f"killed router, all resumed ok; paged launches in the replicas alive at the end "
          f"{launches} (both backfilled or kept); {time.perf_counter() - t0:.1f} s")
    return sum(launches)


def phase_serving(device: str = "cuda", model=None) -> tuple:
    """The three serving phases and ``phase_chaos_serve`` on one
    ``serve_cluster``; returns the paged launches counted inside the
    serving phases' replicas and inside the chaos phase's."""
    cluster = serve_cluster(device)
    try:
        launches = (phase_serve_deployment(device, model) + phase_serve_disagg(device, model)
                    + phase_router_fleet(device, model))
        return launches, timed(phase_chaos_serve, *cluster, device, model)
    finally:
        close_cluster(*cluster)


# bench.py elasticity_bench part (a)'s walk: (label, QPS, seconds), its peak
# raised from bench.py's 10 QPS to twice the two replicas' completed
# requests/s measured on the card (PERF.md section 4), so requests park
MIXED_WALK = (("trough A", 1.5, 8.0), ("peak", 80.0, 10.0), ("trough B", 1.5, 8.0))
# the router admits what its replicas can batch: 2 replicas x max_batch 4
MIXED_ENV = {"RAY_TPU_ELASTIC_CONTROLLER": "1", "RAY_TPU_ELASTIC_TICK_S": "0.5",
             "RAY_TPU_ELASTIC_RETIRE_MAX": "0", "RAY_TPU_ELASTIC_PROVISION_MAX": "0",
             "RAY_TPU_HEALTH_TIMEOUT_S": "2.0", "RAY_TPU_SERVE_ADMISSION_MAX_INFLIGHT": "8"}


def mixed_fleet_verdicts(timeline, reshapes, disk_restores: int, errored: int,
                         launches: list) -> list:
    """What the mixed fleet must show, as a list of failures. ``timeline``
    holds (walk label, gang world, the controller's world hint, parked serve
    requests) samples; as in bench.py a trough's world is the largest of its
    last 4 samples. ``reshapes`` holds (direction, from world, to world,
    walk label) with a shrink no node death caused named ``cede``. The
    peak's overload must take the cede path: requests park, the controller
    hints fewer ranks, the gang cedes at the peak (and only when hinted),
    and grows back to world 2 in trough B; world 2 in trough A; every
    reshape a cede or a grow; no disk restore, no errored request (a shed
    is no error), paged launches in each replica."""
    out = []
    by = {}
    for label, world, hint, parked in timeline:
        by.setdefault(label, []).append((world, hint, parked))
    for label in ("trough A", "trough B"):
        worlds = [w for w, _, _ in by.get(label, [])][-4:]
        if max(worlds, default=0) != 2:
            out.append(f"{label}: the gang's world {worlds}, not 2")
    peak = by.get("peak", [])
    peak_cedes = [r for r in reshapes if r[0] == "cede" and r[3] == "peak"]
    if not peak:
        out.append("no sample at the peak")
    else:
        hints = [h for _, h, _ in peak if h is not None]
        ceded = min(w for w, _, _ in peak) < 2 or bool(peak_cedes)
        ordered = bool(hints) and min(hints) < 2
        if max(n for _, _, n in peak) == 0:
            out.append("no request parked at the peak")
        if not ordered:
            out.append(f"no hint below 2 at the peak ({sorted(set(hints))})")
        elif not ceded:
            out.append(f"the controller hinted {min(hints)} at the peak and the gang held 2")
        if ceded and not ordered:
            out.append("the gang left world 2 at the peak with no hint below 2")
        if not peak_cedes:
            out.append(f"no cede reshape at the peak (reshapes {reshapes})")
    odd = [r for r in reshapes if r[0] not in ("cede", "grow")]
    if odd:
        out.append(f"reshapes other than cede and grow: {odd}")
    if disk_restores:
        out.append(f"{disk_restores} disk restores")
    if errored:
        out.append(f"{errored} errored requests")
    if len(launches) != 2 or not all(n > 0 for n in launches):
        out.append(f"paged launches per replica {launches}")
    return out


def request_outcomes(results, max_new: int) -> tuple:
    """(completed, shed, errored) of the walk's requests: a completed one
    gave ``max_new`` tokens, a shed one None (``Overloaded``), an errored
    one -1 or an exception (bench.py counts both as errors)."""
    errored = sum(isinstance(r, Exception) or r == -1 for r in results)
    return (sum(r == max_new for r in results), sum(r is None for r in results), errored)


def phase_mixed_fleet(device: str = "cuda", model=None, max_new: int = 8,
                      walk=MIXED_WALK) -> int:
    """bench.py's ``elasticity_bench`` part (a) with the head's rounds and
    the elasticity controller's solves on ``device``: two agents of 4 CPUs
    and 4 workers (sharing the card), the controller on (tick 0.5 s, retire
    and provision max 0, health timeout 2 s), ``build_llm_deployment`` of 2
    continuous replicas (max_batch 4, 8-token pages, 128 pages) of
    ``ModelConfig()`` f32 (bench.py's d_model 48 widened), bench.py's
    hot/cold prompts (seed 11, 80% hot, ``max_new`` tokens) at QPS 1.5 for
    8 s, 10 for 10 s, 1.5 for 8 s, beside an elastic gang of bench.py's
    numpy step (dim 2048, work 32, 4 virtual shards, SPREAD, min 1, max 2,
    grow) stopped 20 steps after the walk (of its 800). The router admits 8
    requests at a time (``MIXED_ENV``) and the peak's rate is twice what the
    replicas complete, so requests park in its waiting room and the
    controller cedes the gang's seats to them. ``mixed_fleet_verdicts``
    must hold; every head and ring round and every controller solve replays
    equal on the CPU; no ERROR record. Prints, for each step of the walk,
    the arrival rate the open loop reached, the requests completed a second
    and the most in flight (the open loop's, and the router's admitted).
    Returns the replicas' paged launches."""
    import random
    import tempfile
    import threading

    import ray_tpu_torch as rtt
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.scheduler import binpack as B
    from ray_tpu_torch.serve.admission import Overloaded
    from ray_tpu_torch.serve.router import SERVE_E2E_MS
    from ray_tpu_torch.train import ElasticConfig, ElasticTrainer

    _platform_env(device)
    os.environ.update(MIXED_ENV)
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    t0 = time.perf_counter()
    name = "mix-llm"
    errors = _RuntimeErrors()
    records, impl, restore = _record_rounds()
    ring_records, ring_impl, ring_restore = _record_ring_rounds()
    solve_impl, solves = B.solve_pack_counts, []

    def _solve(nodes_avail, shapes, counts, **kw):
        res = solve_impl(nodes_avail, shapes, counts, **kw)
        solves.append(((np.array(nodes_avail), np.array(shapes), np.array(counts)), dict(kw),
                       res.per_node.device.type, [x.cpu() for x in res]))
        return res

    B.solve_pack_counts = _solve
    stop_dir = tempfile.mkdtemp(prefix="chip_smoke_mixed_")
    stop_file = os.path.join(stop_dir, "stop_at")

    # bench.py's _elastic_bench_init/_elastic_bench_step, closures so the
    # ranks get them by value; the step also reads the step to stop at
    def mix_init(config):
        d = int(config["dim"])
        return {"w": np.zeros(d), "opt": {"m": np.zeros(d)}}

    def mix_step(state, step, gang, config):
        d, work = int(config["dim"]), int(config["work"])
        partials = {v: {"g": np.full((work, d), float((v + step) % 7)).sum(axis=0)}
                    for v in gang.owned_shards()}
        g = gang.allreduce_shards(partials)
        time.sleep(float(config.get("step_sleep", 0.0)))
        try:
            with open(config["stop_file"]) as f:
                stop = step >= int(f.read())
        except (OSError, ValueError):
            stop = False
        return ({"w": state["w"] + g["g"], "opt": {"m": state["opt"]["m"] + 1.0}},
                {"step": step, "world": gang.world, "wall": time.time(), "stop": stop})

    c = _cluster(device)
    gpu = {"GPU": 1.0} if device == "cuda" else {}
    timeline, results, walls = [], [], {}
    label = [walk[0][0]]
    sheds, most, admitted, done_at, windows, arrived = {}, {}, {}, [], {}, {}
    stop_evt = threading.Event()
    ctl, ticks = c.head._elasticity, []
    real_tick = ctl.tick

    def tick():  # each controller tick's step of the walk, ms, rows and hints
        t = time.perf_counter()
        out = real_tick()
        ticks.append((label[0], (time.perf_counter() - t) * 1e3, out["demand_rows"],
                      min(out["world_hints"].values(), default=None)))
        return out

    ctl.tick = tick
    try:
        add_nodes(c, *[({"CPU": 4.0, **gpu}, dict(num_workers=4))] * 2)
        client = c.client()
        set_runtime(client)
        try:
            cfg32, p32 = serve_model(torch.float32, model)
            serve.run(serve_app(cfg32, p32, name, device, num_replicas=2, **SERVE_ENGINE))
            router = serve.get_router(name)
            rng = random.Random(11)
            flight = threading.Lock()
            in_flight = [0]

            def one_request(idx):
                prompt = (rng.choice(SERVE_HOT) if rng.random() < 0.8
                          else f"cold prompt number {idx} with some extra words")
                with flight:
                    in_flight[0] += 1
                    most[label[0]] = max(most.get(label[0], 0), in_flight[0])
                try:
                    got = run_stream(router, {"prompt": prompt, "max_new_tokens": max_new},
                                     sheds=sheds)
                except Exception:  # noqa: BLE001 - counted as errored, as bench.py does
                    return -1
                finally:
                    with flight:
                        in_flight[0] -= 1
                if got is not None:
                    done_at.append(time.monotonic())
                return None if got is None else len(got)

            warm = [threading.Thread(target=one_request, args=(i,)) for i in range(4)]
            for th in warm:
                th.start()
            for th in warm:
                th.join(timeout=300)
            trainer = ElasticTrainer(
                mix_init, mix_step, total_steps=800,
                train_loop_config={"dim": 2048, "work": 32, "step_sleep": 0.04,
                                   "stop_file": stop_file},
                elastic_config=ElasticConfig(
                    min_workers=1, max_workers=2, virtual_shards=4, seal_interval_steps=2,
                    grow=True, placement_strategy="SPREAD",
                    resources_per_worker={"CPU": 1.0}))
            box = {}

            def fit():
                try:
                    box["res"] = trainer.fit()
                except BaseException as exc:  # noqa: BLE001 - reported below
                    box["exc"] = exc

            fit_th = threading.Thread(target=fit, name="mixed-fit")
            fit_th.start()
            deadline = time.monotonic() + 120
            while (trainer.progress()["step"] < 5 and time.monotonic() < deadline
                   and fit_th.is_alive()):
                time.sleep(0.1)
            check("exc" not in box and fit_th.is_alive(),
                  f"mixed fleet: the gang did not start: {box.get('exc')!r}")
            most.clear()

            def sample():
                while not stop_evt.is_set():
                    with c.head._lock:
                        g = dict(c.head._gangs.get(trainer.gang_id) or {})
                        waiting = sum(int(t.get("waiting") or 0)
                                      for reps in c.head._serve_budget.values()
                                      for rep in reps.values()
                                      for t in (rep.get("pressure") or {}).values())
                    n = router.admission.stats()["inflight"]
                    admitted[label[0]] = max(admitted.get(label[0], 0), n)
                    if g:
                        timeline.append((label[0], len(g.get("members") or {}),
                                         g.get("world_hint"), waiting,
                                         len(trainer.reshape_log)))
                    stop_evt.wait(0.5)

            threading.Thread(target=sample, daemon=True, name="mixed-sample").start()
            lbl = {"deployment": name}
            e2e0 = SERVE_E2E_MS.buckets_snapshot(lbl)
            for label[0], qps, seconds in walk:
                s0, w0 = trainer.progress()["step"], time.monotonic()
                got, _ = open_loop(one_request, qps, seconds)
                results += got
                walls[label[0]] = (trainer.progress()["step"] - s0) / (time.monotonic() - w0)
                windows[label[0]] = (w0, w0 + seconds)
                arrived[label[0]] = len(got)
            p99 = window_pct(SERVE_E2E_MS, lbl, e2e0, 0.99)
            stop_evt.set()
            with open(stop_file, "w") as f:
                f.write(str(trainer.progress()["step"] + 20))
            fit_th.join(timeout=300)
            check(not fit_th.is_alive(), "mixed fleet: fit() did not finish")
            check("exc" not in box, f"mixed fleet: fit raised {box.get('exc')!r}")
            res = box["res"]
            check(res.error is None, f"mixed fleet: {res.error!r}")
            launches = replica_launches(rtt, name)
        finally:
            stop_evt.set()
            try:
                serve.shutdown()
            finally:
                set_runtime(None)
                client.shutdown()
    finally:
        c.shutdown()
        B.solve_pack_counts = solve_impl
        restore()
        ring_restore()
        errors.close()
        shutil.rmtree(stop_dir, ignore_errors=True)
        for k in (*MIXED_ENV, "NVIDIA_TF32_OVERRIDE"):
            os.environ.pop(k, None)
    el = res.metrics["elastic"]
    reshapes = []
    for i, r in enumerate(el["reshapes"]):
        # a shrink no node death caused is the controller's cede
        kind = "cede" if r["direction"] == "shrink" and not r["dead_nodes"] else r["direction"]
        when = next((lab for lab, *_, n in timeline if n > i), None)
        reshapes.append((kind, r["from_world"], r["to_world"], when))
    completed, shed, errored = request_outcomes(results, max_new)
    rate_a, rate_b = walls[walk[0][0]], walls[walk[-1][0]]
    peak = [(w, h, n) for lab, w, h, n, _ in timeline if lab == walk[1][0]]
    for lab, qps, seconds in walk:
        mine = [t for t in ticks if t[0] == lab]
        print(f"mixed fleet {lab}: {len(mine)} controller ticks, ms "
              f"{', '.join(f'{ms:.0f}' for _, ms, _, _ in mine)}; demand rows "
              f"{[r for _, _, r, _ in mine]}; gang hints {[h for *_, h in mine]}")
        lo, hi = windows[lab]
        print(f"mixed fleet {lab}: {qps} QPS asked, {arrived[lab] / seconds:.2f} reached "
              f"({arrived[lab]} arrivals in {seconds} s); "
              f"{sum(lo <= t < hi for t in done_at) / seconds:.2f} requests completed a "
              f"second; most in flight {most.get(lab, 0)} in the open loop, "
              f"{admitted.get(lab, 0)} admitted at the router")
    print(f"mixed fleet ModelConfig() f32 x 2 replicas + elastic gang, controller on "
          f"[{card_line()}]: {len(results)} requests, {completed} completed, {errored} "
          f"errored, {shed} shed {sheds}; serve e2e p99 "
          f"{p99:.1f} ms; gang "
          f"step rate trough A {rate_a:.2f}/s, trough B {rate_b:.2f}/s, "
          f"mixed_fleet_retention_pct {100.0 * rate_b / rate_a if rate_a else 0.0:.1f}; "
          f"worlds (trough A, peak min, trough B) "
          f"({max([t[1] for t in timeline if t[0] == walk[0][0]][-4:], default=0)}, "
          f"{min([w for w, _, _ in peak], default=0)}, "
          f"{max([t[1] for t in timeline if t[0] == walk[-1][0]][-4:], default=0)}); "
          f"peak hints {sorted({h for _, h, _ in peak}, key=str)}, parked serve requests at the "
          f"peak max {max([n for _, _, n in peak], default=0)}; reshapes {reshapes}, disk "
          f"restores {el['disk_restores']}, {len(res.metrics_history)} steps (of 800); paged "
          f"launches per replica {launches}")
    print("mixed fleet timeline (label: world/hint/parked/reshapes every 0.5 s): "
          + "; ".join(f"{lab}: " + " ".join(f"{w}/{h}/{n}/{k}" for l2, w, h, n, k in timeline
                                            if l2 == lab)
                      for lab, _, _ in walk))
    failures = mixed_fleet_verdicts([t[:4] for t in timeline], reshapes, el["disk_restores"],
                                    errored, launches)
    check(not failures, f"mixed fleet: {failures}")
    check(len(res.metrics_history) < 800, "mixed fleet: the gang's 800 steps ended before the walk")
    errors.check("mixed fleet")
    check(len(solves) >= 10 and all(x[2] == device for x in solves),
          f"mixed fleet: {len(solves)} controller solves, on {sorted({x[2] for x in solves})}")
    cpu = {}
    for i, ((avail, shapes, counts), kw, _, outs) in enumerate(solves):
        key = (avail.tobytes(), shapes.tobytes(), counts.tobytes(), repr(sorted(kw.items())))
        if key not in cpu:
            cpu[key] = solve_impl(avail, shapes, counts, **{**kw, "device": "cpu"})
        r = cpu[key]
        err = float((r.avail_out - outs[2]).abs().max()) if r.avail_out.numel() else 0.0
        check(torch.equal(r.per_node, outs[1]) and torch.equal(r.placed, outs[0])
              and err <= SCHED_EPS,
              f"mixed fleet: controller solve {i} of {len(solves)} plans differently on the CPU")
    _replay_rounds("mixed fleet", records, impl, ring_records, ring_impl)
    print(f"mixed fleet replay: {len(solves)} controller solves ({len(cpu)} distinct inputs), "
          f"{len(records)} head rounds and {len(ring_records)} ring rounds replayed on the CPU, "
          f"every plan and output equal")
    print(f"mixed fleet phase: {time.perf_counter() - t0:.1f} s")
    return sum(launches)


# ---------------------------------------------------------------------------
# 5e. online RL: bench.py's rl_loop_bench at ModelConfig()'s width
# ---------------------------------------------------------------------------
# bench.py's rl_loop_bench traffic: 2 rollout workers, 2 prompts each a step,
# 6 prompt and 6 new tokens, batch 4, 8 steps, seed 3, a publish every 2
RL_LOOP = dict(n_rollout_workers=2, prompts_per_step=2, prompt_len=6, max_new_tokens=6,
               batch_size=4, total_steps=8, seed=3, publish_interval=2)


def rl_counts() -> dict:
    """The paged kernel's launches and the flash kernels' (fwd, dq, dkv)."""
    return dict(paged=paged_attention_decode.launches, **read_launches())


def rl_zero() -> None:
    paged_attention_decode.launches = 0
    zero_launches()


def rl_run(cfg, params, lc, device: str, head_address=None):
    """One ``OnlineRLLoop`` from ``params``: (result, launches counted from
    zero over its run, the loop, every step's trained token block)."""
    from ray_tpu_torch.rl import OnlineRLLoop

    loop = OnlineRLLoop(cfg, params, lc, head_address=head_address, device=device)
    try:
        rl_zero()
        res = loop.run()
        if device == "cuda":
            torch.cuda.synchronize()
        launches = rl_counts()
    finally:
        loop.close()
    blocks = [np.asarray(loop.feed._step_cache[s]["tokens"]) for s in sorted(loop.feed._step_cache)]
    return res, launches, loop, blocks


def on(tensors, device: str) -> bool:
    return all(t.device.type == device for t in tensors)


def rl_kernel_checks(cfg, lc, eng) -> None:
    """The kernels at the shapes and dtype the RL path gives them, against
    their plain versions: the trainer's flash forward and backward on
    B=batch_size rows of prompt_len + max_new_tokens - 1 positions (zero-
    padded to one tile by the wrapper; the kernel and its lse also at that
    padded shape), and the rollout engine ``eng``'s paged decode step."""
    b, t = lc.batch_size, lc.prompt_len + lc.max_new_tokens - 1
    h, hkv, d, dtype = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype
    atol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    flash_case(f"rl trainer shape B={b} T={t}", b, t, h, hkv, d, True, dtype, atol, 61)
    wrapper_bwd_case(f"rl trainer shape B={b} T={t}", b, t, h, hkv, d, True, dtype, 62)
    tp = t + -t % math.lcm(BLOCK_Q, BLOCK_K)
    g = gen(63)
    qg, kg, vg = (torch.nn.functional.pad(torch.randn(b * h, t, d, generator=g, device=DEV),
                                          (0, 0, 0, tp - t)).to(dtype) for _ in range(3))
    out, lse = flash_attention_forward(qg, kg, vg, True)
    ref_out, ref_lse = flash_attention_reference(qg, kg, vg, True)
    torch.cuda.synchronize()
    e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
    print(f"flash kernel {str(dtype).rpartition('.')[2]} rl padded bh={b * h} T={t} -> {tp}: "
          f"out err {e_out:.3e} (atol {atol}) lse err {e_lse:.3e} (atol 1e-3)")
    check(e_out <= atol and e_lse <= 1e-3, f"flash kernel rl padded shape: {e_out}, {e_lse}")
    kh, grp = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    lens = [t, lc.prompt_len + 1][: eng.B] + [1] * max(0, eng.B - 2)
    args = paged_inputs(eng.B, kh, grp, d, eng.pool.n_pages, eng.page, eng.max_pages_per_seq,
                        lens, dtype, 64)
    paged_case(f"rl rollout shape (B={eng.B}, page {eng.page}, {eng.pool.n_pages} pages, "
               f"P_max {eng.max_pages_per_seq})", args, eng.page,
               2e-2 if dtype == torch.bfloat16 else 2e-5)


def phase_rl(device: str = "cuda", model=None) -> dict:
    """bench.py's ``rl_loop_bench`` with its traffic unchanged and its toy
    model replaced by ``ModelConfig()`` bf16 (random weights from a seeded
    generator): the fenced run against the port's ``HeadServer`` (WAL in a
    temp directory), then the rerun on the local ledger. Losses bit-equal,
    epoch 4 on every worker and engine, nothing unaccounted, every
    parameter and KV page on the card, and each run's paged and flash
    launches equal to what its steps imply. The kernels at the shapes and
    dtype the run gave them against their plain versions
    (``rl_kernel_checks``). Then an f32 loop of 2 steps
    (one publish, TF32 off) on the card and on the CPU's plain path from
    the same weights: every trajectory token-equal, losses within 1e-4.
    Returns the fenced run's launches."""
    import tempfile

    from ray_tpu_torch.cluster.head import HeadServer
    from ray_tpu_torch.rl import RLLoopConfig
    from ray_tpu_torch.train import pytree

    _platform_env(device)
    t0 = time.perf_counter()
    cfg = tfm.ModelConfig(**dict(model or {}))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(7), device)
    lc = RLLoopConfig(**RL_LOOP)
    with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_rl_") as td:
        head = HeadServer(port=0, use_device_scheduler=False,
                          persist_path=os.path.join(td, "head"))
        try:
            res, launches, loop, _ = rl_run(cfg, params, lc, device, head.address)
        finally:
            head.shutdown()
    ref, ref_launches, _, _ = rl_run(cfg, params, lc, device)
    steps, layers = lc.total_steps, cfg.n_layers
    trained = len(res["losses"])
    # a rollout's two slots decode in lockstep: max_new - 1 decode steps
    # after the prefill's first token, one paged launch a layer each; a
    # train step launches each flash kernel once a layer
    want = dict(paged=steps * lc.n_rollout_workers * (lc.max_new_tokens - 1) * layers,
                fwd=trained * layers, dq=trained * layers, dkv=trained * layers)
    pft, pub = res["publish_to_first_token_ms"], res["publish_ms"]
    acct = res["accounting"]
    print(f"rl loop (ModelConfig() {str(cfg.dtype).rpartition('.')[2]}, {steps} steps) on "
          f"{'; '.join(card_line().splitlines())}: rl_samples_per_s {res['samples_per_s']:.2f} "
          f"(rerun {ref['samples_per_s']:.2f}); publish_ms mean {sum(pub) / len(pub):.2f} "
          f"({', '.join(f'{x:.2f}' for x in pub)}); publish-to-first-token ms mean "
          f"{sum(pft) / len(pft):.2f} ({', '.join(f'{x:.2f}' for x in pft)}); weights_epoch "
          f"{res['weights_epoch']}; stale_dropped_frac {res['stale_dropped_frac']}; "
          f"accounting {acct}; losses {res['losses']}; launches {launches} (expected {want}; "
          f"rerun {ref_launches}); wall {res['wall_s']:.2f} s, rerun {ref['wall_s']:.2f} s")
    check(res["losses"] == ref["losses"], f"rl: rerun losses {ref['losses']} differ from the "
          f"fenced run's {res['losses']}")
    check(trained == steps, f"rl: {trained} of {steps} steps trained")
    check(res["weights_epoch"] == ref["weights_epoch"] == steps // lc.publish_interval,
          f"rl: weights_epoch {res['weights_epoch']}, rerun {ref['weights_epoch']}")
    epoch = res["weights_epoch"]
    check(all(w.weights_epoch == epoch and w.engine.model_id == f"epoch-{epoch}"
              for w in loop.workers),
          f"rl: workers at {[(w.weights_epoch, w.engine.model_id) for w in loop.workers]}")
    check(acct["unaccounted"] == 0 and ref["accounting"]["unaccounted"] == 0,
          f"rl: unaccounted trajectories {acct}, rerun {ref['accounting']}")
    check(res["stale_dropped_frac"] == ref["stale_dropped_frac"],
          f"rl: stale_dropped_frac {res['stale_dropped_frac']}, rerun {ref['stale_dropped_frac']}")
    tensors = pytree.leaves(loop.params)
    for w in loop.workers:
        tensors += pytree.leaves(w.engine.params) + [w.engine.pool.k, w.engine.pool.v]
    check(on(tensors, device), f"rl: a parameter or KV page off {device}")
    check(all(math.isfinite(x) for x in res["losses"]), f"rl: losses {res['losses']}")
    if device == "cuda":
        check(launches == want and ref_launches == want,
              f"rl launches {launches}, rerun {ref_launches}, expected {want}")
        rl_kernel_checks(cfg, lc, loop.workers[0].engine)

    # f32: the card against the CPU's plain path from the same weights
    f32 = tfm.ModelConfig(**dict(model or {}, dtype=torch.float32))
    p32 = tfm.init_params(f32, torch.Generator().manual_seed(7), "cpu")
    lc32 = RLLoopConfig(**dict(RL_LOOP, total_steps=2))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, _, _, card_blocks = rl_run(f32, p32, lc32, device)
        cpu, _, _, cpu_blocks = rl_run(f32, p32, lc32, "cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    loss_err = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
    same = len(card_blocks) == len(cpu_blocks) == 2 and all(
        np.array_equal(a, b) for a, b in zip(card_blocks, cpu_blocks))
    print(f"rl f32 (2 steps, one publish) {device} vs CPU: trajectories token-equal {same}; "
          f"losses {card['losses']} vs {cpu['losses']}, max err {loss_err:.3g}")
    check(same, "rl f32: a trajectory on the card differs from the CPU's")
    check(card["weights_epoch"] == cpu["weights_epoch"] == 1, "rl f32: one publish expected")
    check(loss_err <= 1e-4, f"rl f32: losses differ by {loss_err:.3g} (tolerance 1e-4)")
    print(f"rl phase: {time.perf_counter() - t0:.1f} s")
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 5f. rllib: PPO, DQN and IMPALA with their learners on the card
# ---------------------------------------------------------------------------
RL_SOAK_SEED = 14  # tests/test_rl_loop.py's soak seed: all three planes in 4 faults


def rl_soak_verdicts(res, verify_failures: list, acct: dict, gang_losses: dict,
                     shadow_losses: dict, epoch: int, hist: list, launches: dict,
                     device: str) -> list:
    """What the RL triple soak must show, as a list of failures: the
    reference test's checks (every fault ``ok`` and fired, all three planes,
    no verify failure, no trajectory unaccounted and some emitted, the
    gang's losses within 1e-3 of the shadow's on at least 5 shared steps,
    3 or more epochs published), every step trained on ``device``, and the
    paged kernel launched in the replicas and the flash kernels in the
    gang."""
    out = []
    if not res.ok:
        out.append(f"invariants failed: {res.summary()['failures']}")
    skipped = [(f.spec.kind, f.detail) for f in res.faults if f.detail.startswith("skipped")]
    if skipped:
        out.append(f"faults skipped: {skipped}")
    kinds = {f.spec.kind for f in res.faults}
    if kinds != {"rollout_kill", "trainer_rank_kill", "head_kill_mid_publish"}:
        out.append(f"fault kinds {sorted(kinds)}")
    if verify_failures:
        out.append(f"{len(verify_failures)} verify failures: {verify_failures[:2]}")
    if acct.get("unaccounted", -1) != 0 or acct.get("emitted", 0) <= 0:
        out.append(f"trajectory accounting {acct}")
    shared = sorted(set(gang_losses) & set(shadow_losses))
    off = [(s, gang_losses[s], shadow_losses[s]) for s in shared
           if not abs(gang_losses[s] - shadow_losses[s]) < 1e-3]
    if off or len(shared) < 5:
        out.append(f"{len(shared)} steps shared with the shadow, off by more than 1e-3: "
                   f"{off[:3]}")
    if epoch < 3:
        out.append(f"{epoch} epochs published")
    places = sorted({m.get("device", "?").split(":")[0] for m in hist})
    if places != [device]:
        out.append(f"the gang trained on {places}")
    if not all(launches.get(k, 0) > 0 for k in ("paged", "fwd", "dq", "dkv")):
        out.append(f"launches {launches}")
    return out


def phase_rl_soak(device: str = "cuda", model=None, max_new: int = 8) -> dict:
    """``tests/test_rl_loop.py``'s triple chaos soak with the head's rounds
    on ``device``: a WAL head with an auto-promoting standby, two agents of
    8 CPUs and 3 workers sharing the card and a feed node, the
    ``TrajectoryFeed`` actor, ``build_llm_deployment`` of 2 continuous
    replicas (max_batch 2, 8-token pages, 64 pages) of ``ModelConfig()`` f32
    (the reference's ``_small_cfg(vocab_size=258)`` widened) on the card,
    ``RLRolloutWorkload`` streams of the reference's prompt (8 greedy tokens)
    held token for token against an engine on the card, an elastic trainer
    gang of ``elastic_rl_step`` (2 STRICT_SPREAD ranks on the card, 4
    virtual shards, a seal every 2 steps, lr 0.01) paced at 0.2 s a step, a
    shadow trainer replaying the feed's step batches on the card and
    publishing through the two-phase fence, then ``make_plan(14, 4, RL_MIX,
    allow=(rollout_kill, trainer_rank_kill, head_kill_mid_publish))`` under
    ``ChaosOrchestrator`` (budget 180 s). ``rl_soak_verdicts`` must hold,
    every head and ring round replays equal on the CPU, no ERROR record.
    Returns the launches: paged in the replicas alive at the end, the flash
    kernels in the gang's reporting rank."""
    import tempfile
    import threading

    import ray_tpu_torch as rtt
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.chaos import (
        RL_MIX,
        ChaosOrchestrator,
        ChaosWorkload,
        RLRolloutWorkload,
        make_plan,
    )
    from ray_tpu_torch.core.runtime import set_runtime
    from ray_tpu_torch.rl import (
        TrajectoryFeed,
        WeightsPublisher,
        elastic_rl_init,
        elastic_rl_step,
        model_config_to_dict,
    )
    from ray_tpu_torch.rl.loop import sgd_step
    from ray_tpu_torch.train import ElasticConfig, ElasticTrainer
    from ray_tpu_torch.train import pytree

    _platform_env(device)
    env = {"RAY_TPU_HEAD_HEALTH_TIMEOUT_S": "1.5", "NVIDIA_TF32_OVERRIDE": "0"}
    os.environ.update(env)
    t0 = time.perf_counter()
    name, prompt = "rl-policy", "rl rollout"
    errors = _RuntimeErrors()
    records, impl, restore = _record_rounds()
    ring_records, ring_impl, ring_restore = _record_ring_rounds()
    mcfg, base = serve_model(torch.float32, model)
    dev = torch.device(device)
    gen_cfg = GenerationConfig(max_new_tokens=max_new, temperature=0.0, seed=0)
    ref_engine = ContinuousBatchingEngine(mcfg, pytree.tree_map(lambda t: t.to(dev), base),
                                          max_batch=2, page_size=8, n_pages=64, device=dev,
                                          tokenizer=id_tokenizer())

    def expected_tokens():
        return [ref_engine.tokenizer.decode([int(t)])
                for t in ref_engine.stream_ids(ref_engine.tokenizer.encode(prompt), gen_cfg)]

    expected_base = expected_tokens()
    check(len(expected_base) == max_new, f"rl soak: the reference engine gave {expected_base}")
    gpu = {"GPU": 1.0} if device == "cuda" else {}
    node = {"CPU": 8.0, **gpu}
    tmp = tempfile.mkdtemp(prefix="ray_tpu_torch_rl_soak_")
    c = _cluster(device, persist_path=os.path.join(tmp, "head_state.pkl"))
    heads = _watch_heads(c)
    stop_evt = threading.Event()
    workload = pump = None
    shadow_losses, pump_errors, pump_s = {}, [], []
    spans, untrace = _trace_checks()
    # every node, the orchestrator's replacements too, gets the elastic
    # phase's 8 GiB arena: a rank seals the whole f32 model (~200 MB) every
    # 2 steps, and its buddy pulls the other rank's
    add_node = c.add_node
    c.add_node = lambda *a, **kw: add_node(*a, **{"store_capacity": 8 << 30, **kw})
    try:
        # the feed actor on a node of its own, so a trainer-rank node's
        # kill never takes the accounting ledger down with it
        add_nodes(c, (node, dict(num_workers=3)), (node, dict(num_workers=3)),
                  ({"CPU": 0.5, "FEED": 1.0}, dict(num_workers=1, store_capacity=1 << 28)))
        client = c.client()
        set_runtime(client)
        c.start_standby(auto_promote=True)
        try:
            feed = rtt.remote(TrajectoryFeed).options(
                name="rl-feed", num_cpus=0.25, resources={"FEED": 1.0}).remote(2)
            rtt.get(feed.latest_epoch.remote(), timeout=60.0)
            serve.run(serve_app(mcfg, base, name, device, num_replicas=2, engine="continuous",
                                max_batch=2, page_size=8, n_pages=64))
            router = serve.get_router(name)
            check(router.resumable, "rl soak: the deployment's router is not resumable")
            publisher = WeightsPublisher(name, head_address=c.address)
            workload = RLRolloutWorkload(router, {"prompt": prompt, "max_new_tokens": max_new},
                                         {"base": expected_base}, publisher=publisher, feed=feed,
                                         concurrency=2, token_space=mcfg.vocab_size)
            workload.start()
            _wait_until(lambda: workload.completed >= 2 or workload.verify_failures, 240.0,
                        "rl soak: warm rollout streams")
            check(not workload.verify_failures, f"rl soak: {workload.verify_failures[:1]}")
            # paced through the faults (the trainer outlives them), then sprinted
            rtt.get(feed.set_pace.remote(0.2), timeout=30.0)
            trainer = ElasticTrainer(
                elastic_rl_init, elastic_rl_step, total_steps=2500,
                train_loop_config={"model": model_config_to_dict(mcfg), "seed": 0,
                                   "batch_size": 4, "lr": 0.01, "feed_actor": "rl-feed",
                                   "device": device},
                elastic_config=ElasticConfig(
                    min_workers=1, max_workers=2, virtual_shards=4, seal_interval_steps=2,
                    grow=True, placement_strategy="STRICT_SPREAD",
                    resources_per_worker={"CPU": 1.0, **({"GPU": 0.25} if gpu else {})}))
            workload.trainer = trainer
            box = {}

            def fit():
                try:
                    box["res"] = trainer.fit()
                except BaseException as exc:  # noqa: BLE001 - reported below
                    box["exc"] = exc

            fit_th = threading.Thread(target=fit, daemon=True, name="rl-soak-fit")
            fit_th.start()
            _wait_until(lambda: trainer.progress()["step"] >= 2 or "exc" in box, 240.0,
                        "rl soak: the trainer's first steps")
            check("exc" not in box, f"rl soak: fit raised {box.get('exc')!r}")
            # the shadow replays the feed's step batches (what the gang trained)
            # and publishes under the fence, hot-swapping every replica
            shadow = {"params": pytree.tree_map(lambda t: t.to(dev), base), "step": 0}

            def _pump():
                while not stop_evt.is_set():
                    marks = [time.perf_counter()]
                    try:
                        target = trainer.progress()["step"]
                        while shadow["step"] < target and not stop_evt.is_set():
                            s = shadow["step"]
                            block = rtt.get(feed.take_for_step.remote(s, 4), timeout=60.0)
                            if block is not None:
                                tokens = torch.from_numpy(np.asarray(block["tokens"])).to(
                                    device=dev, dtype=torch.int64)
                                loss, shadow["params"] = sgd_step(shadow["params"], tokens,
                                                                  mcfg, 0.01)
                                shadow_losses[s] = float(loss)
                            shadow["step"] = s + 1
                        marks.append(time.perf_counter())
                        epoch = publisher.publish(shadow["params"])
                        rtt.get(feed.note_epoch.remote(epoch), timeout=30.0)
                        marks.append(time.perf_counter())
                        model_id = f"epoch-{epoch}"
                        ref_engine.swap_params(shadow["params"], model_id=model_id)
                        expected = expected_tokens()
                        marks.append(time.perf_counter())
                        workload.broadcast_weights(shadow["params"], model_id, epoch)
                        workload.register_model(model_id, expected)
                        marks.append(time.perf_counter())
                        pump_s.append([b - a for a, b in zip(marks, marks[1:])])
                    except Exception as exc:  # noqa: BLE001 - the head mid-failover
                        pump_errors.append(repr(exc))
                    stop_evt.wait(1.0)

            pump = threading.Thread(target=_pump, daemon=True, name="rl-soak-pump")
            pump.start()
            _wait_until(lambda: workload.published_epoch() >= 1, 120.0,
                        f"rl soak: the first publish (pump errors {pump_errors[-3:]})")
            plan = make_plan(seed=RL_SOAK_SEED, num_faults=4, mix=RL_MIX,
                             allow=("rollout_kill", "trainer_rank_kill",
                                    "head_kill_mid_publish"),
                             min_delay_s=0.5, max_delay_s=1.5)
            chaos_wl = ChaosWorkload(client, payload_bytes=150_000, num_actors=1)
            orch = ChaosOrchestrator(c, chaos_wl, plan, node_resources=node,
                                     workers_per_node=3, convergence_budget_s=180.0,
                                     serve_adapter=workload, rl_adapter=workload)
            t1 = time.perf_counter()
            res = orch.run()
            wall = time.perf_counter() - t1
            stop_evt.set()
            workload.stop()
            rtt.get(feed.set_pace.remote(0.0), timeout=30.0)
            rtt.get(feed.request_stop.remote(), timeout=30.0)
            fit_th.join(timeout=420)
            check(not fit_th.is_alive(), f"rl soak: the trainer did not finish "
                                         f"{trainer.progress()}")
            check("exc" not in box, f"rl soak: fit raised {box.get('exc')!r}")
            check(box["res"].error is None, f"rl soak: {box['res'].error!r}")
            hist = box["res"].metrics_history
            acct = workload.trajectory_accounting()
            epoch = workload.published_epoch()
            replicas = replica_launches(rtt, name)
            gates = [(st["model_id"], st["weight_swaps"], st["swap_gate_wait_ms_max"],
                      st["swap_gate_deadline_misses"]) for st in replica_stats(rtt, name)]
            verify_failures = list(workload.verify_failures)
            if not res.ok:  # what each head held of the workload's named actor
                aid = chaos_wl.actor_ids[0]
                for i, h in enumerate(heads):
                    info = h._actors.get(aid)
                    print(f"rl soak head {i}: named {dict(h._named_actors)}; actor {aid[:8]} "
                          + (f"{info.state} on {info.node_id}, restarts {info.num_restarts}"
                             if info is not None else "unknown"))
        finally:
            stop_evt.set()
            if pump is not None:
                pump.join(timeout=30)
            if workload is not None:
                workload.stop()
            try:
                serve.shutdown()
            finally:
                set_runtime(None)
                client.shutdown()
    finally:
        c.shutdown()
        restore()
        ring_restore()
        untrace()
        errors.close()
        shutil.rmtree(tmp, ignore_errors=True)
        for k in env:
            os.environ.pop(k, None)
    _print_check_spans("rl soak", spans, res)
    if pump_s:
        cols = list(zip(*pump_s))
        print(f"rl soak pump: {len(pump_s)} publishes; seconds (mean/max) "
              + ", ".join(f"{n} {np.mean(c):.3f}/{max(c):.3f}" for n, c in zip(
                  ("replay", "publish", "reference", "broadcast"), cols)))
    gang_losses = {m["step"]: m["loss"] for m in hist if m.get("loss") == m.get("loss")}
    launches = dict(paged=sum(replicas),
                    **{k: sum(m.get("launches", {}).get(k, 0) for m in hist)
                       for k in ("fwd", "dq", "dkv")})
    lat = res.recovery_percentiles()
    for f in res.faults:
        print(f"rl soak #{f.spec.index} {f.spec.kind}: {f.recovery_s:.3f} s, {f.detail}"
              + (f"; FAILED {f.failures}" if not f.ok else ""))
    shared = sorted(set(gang_losses) & set(shadow_losses))
    print(f"rl soak seed {plan.seed} {res.summary()['fault_counts']}, ModelConfig() f32 (TF32 "
          f"off) [{card_line()}]: ok {res.ok}, recovery p50 {lat['p50']:.3f} s p95 "
          f"{lat['p95']:.3f} s; {workload.completed} streams token-exact, "
          f"{len(verify_failures)} verify failures; trajectories {acct}; {len(hist)} gang steps, "
          f"{len(shared)} shared with the shadow, largest loss gap "
          f"{max([abs(gang_losses[s] - shadow_losses[s]) for s in shared], default=0.0):.3g}; "
          f"{epoch} epochs published, pump errors {len(pump_errors)}; replicas (model, swaps, "
          f"longest swap wait ms, swaps past the drain deadline) {gates}; {len(heads)} heads; "
          f"launches {launches} (paged per replica {replicas}); wall {wall:.1f} s")
    failures = rl_soak_verdicts(res, verify_failures, acct, gang_losses, shadow_losses, epoch,
                                hist, launches, device)
    check(not failures, f"rl soak: {failures}")
    errors.check("rl soak")
    check(all(h.device_state.device.type == device for h in heads),
          f"rl soak: a head's scheduler state is off {device}")
    _replay_rounds("rl soak", records, impl, ring_records, ring_impl)
    print(f"rl soak replay: {len(records)} head rounds and {len(ring_records)} ring rounds of the "
          f"{len(heads)} heads replayed on the CPU, every output equal")
    print(f"rl soak phase: {time.perf_counter() - t0:.1f} s")
    return launches


class _SgdClock:
    """Counts and times (synced) a learner's update calls."""

    def __init__(self, algo, name: str, device: str):
        self.n, self.s, self.device = 0, 0.0, device
        inner = getattr(algo, name)

        def timed(*args):
            t = time.perf_counter()
            out = inner(*args)
            if self.device == "cuda":
                torch.cuda.synchronize()
            self.s += time.perf_counter() - t
            self.n += 1
            return out

        setattr(algo, name, timed)


def rllib_learn(label: str, algo, iters: int, steps_key: str, clock: _SgdClock, device: str):
    from ray_tpu_torch.train import pytree

    t = time.perf_counter()
    results = [algo.train() for _ in range(iters)]
    wall = time.perf_counter() - t
    returns = [r["episode_return_mean"] for r in results]
    first, last = returns[0], returns[-1]
    env_steps = sum(r[steps_key] for r in results)
    losses = [r.get("total_loss", r.get("td_loss")) for r in results]
    print(f"rllib {label} on {'; '.join(card_line().splitlines())}: {iters} iterations, "
          f"episode return mean {first:.1f} -> {last:.1f} "
          f"({', '.join(f'{x:.1f}' for x in returns)}); "
          f"env steps/s {env_steps / wall:.1f} ({env_steps} steps, {wall:.2f} s); "
          f"SGD steps/s {clock.n / max(clock.s, 1e-9):.1f} ({clock.n} steps, {clock.s:.3f} s)")
    tensors = pytree.leaves(algo.params) + pytree.leaves(algo.opt_state)
    check(on(tensors, device), f"rllib {label}: a learner tensor off {device}")
    check(last > first + 10, f"rllib {label}: mean return {first:.1f} -> {last:.1f}, not > +10")
    check(all(x is not None and math.isfinite(x) for x in losses), f"rllib {label}: {losses}")
    return results


def phase_rllib(device: str = "cuda") -> None:
    """``tests/test_rllib.py``'s three learners on the local runtime, each
    learner on the card (runners act on the CPU with host copies of the
    parameters): PPO 8 iterations of 2 runners x 256 steps (seed 3), DQN
    12 of 2 x 128 with 48 SGD steps of 64 (seed 1), IMPALA 8 of 2 x 192
    with 4 updates (seed 5). Each learner's tensors on the card, its mean
    return past the first iteration's by more than 10, every loss finite;
    a PPO checkpoint restores to equal parameters on the card; IMPALA keeps
    both rollouts in flight. Prints env steps/s and SGD steps/s."""
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch.rllib import DQN, DQNConfig, IMPALA, ImpalaConfig, PPO, PPOConfig
    from ray_tpu_torch.train import pytree

    _platform_env(device)
    t0 = time.perf_counter()
    rtt.init(num_nodes=1, resources_per_node={"CPU": 4.0, "memory": 1e9})
    try:
        ppo = PPO(PPOConfig(num_env_runners=2, rollout_steps=256, seed=3, device=device))
        rllib_learn("PPO", ppo, 8, "num_env_steps", _SgdClock(ppo, "_sgd_step", device), device)
        with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_ppo_") as td:
            ppo.save(os.path.join(td, "ckpt"))
            back = PPO(PPOConfig(num_env_runners=1, rollout_steps=64, device=device))
            back.restore(os.path.join(td, "ckpt"))
        a, b = pytree.leaves(back.params), pytree.leaves(ppo.params)
        check(on(a, device) and all(torch.equal(x, y) for x, y in zip(a, b)),
              f"rllib PPO: the restored parameters differ or lie off {device}")
        dqn = DQN(DQNConfig(num_env_runners=2, rollout_steps=128, sgd_steps_per_iter=48,
                            batch_size=64, eps_decay_iters=6, seed=1, device=device))
        rllib_learn("DQN", dqn, 12, "num_env_steps", _SgdClock(dqn, "_sgd_step", device), device)
        impala = IMPALA(ImpalaConfig(num_env_runners=2, rollout_steps=192, updates_per_iter=4,
                                     seed=5, device=device))
        rllib_learn("IMPALA", impala, 8, "num_env_steps", _SgdClock(impala, "_update", device),
                    device)
        check(len(impala._in_flight) == 2,
              f"rllib IMPALA: {len(impala._in_flight)} rollouts in flight, not 2")
        # let the rollouts in flight end before the runtime does: a runner
        # thread still inside torch when the process exits aborts it
        rtt.wait(list(impala._in_flight), num_returns=2, timeout=120)
    finally:
        rtt.shutdown()
    print(f"rllib phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 5g. data/: the streaming shuffle, and real ingest into TorchTrainer and
#     LLMProcessor
# ---------------------------------------------------------------------------
SHUFFLE = dict(rows=4_000_000, parts=16, loc_parts=32, groupby_rows=100_000)  # bench.py's
DATA_TRAIN = dict(rows=256, seq=512, vocab=32_000, blocks=8, batch=8, seed=70, lr=3e-4)


def data_libs() -> dict:
    """The data layer's lazy imports: which of pyarrow and pandas import
    here (a dict result of ``map_batches`` needs pyarrow)."""
    import importlib

    libs = {}
    for name in ("pyarrow", "pandas"):
        try:
            libs[name] = importlib.import_module(name).__version__
        except Exception as exc:  # noqa: BLE001 - absent or broken: both mean "no"
            libs[name] = None
            print(f"data: import {name} failed: {exc!r}")
    print(f"data: pyarrow {libs['pyarrow'] or 'absent'}, pandas {libs['pandas'] or 'absent'}")
    return libs


def _agent_spills(c, nodes) -> int:
    """Objects the agents' arenas spilled to disk (their DebugState)."""
    from ray_tpu_torch.cluster.rpc import RpcClient

    total = 0
    for nid in nodes:
        rpc = RpcClient(c.agent_address(nid))
        try:
            st = rpc.call("DebugState", {}, timeout=15.0)
        finally:
            rpc.close()
        total += st.get("object_plane", {}).get("spilled_objects", 0) or 0
    return total


def shuffle_replay(blocks, seed: int) -> np.ndarray:
    """``random_shuffle(seed)`` of ``blocks`` computed in this process with
    the port's own map and reduce functions, in the dataset's block order."""
    from ray_tpu_torch.data.shuffle import _partition_block, _reduce_shuffled

    n = len(blocks)
    maps = [_partition_block._fn(b, n, "random", None, None, seed + i) for i, b in enumerate(blocks)]
    return np.concatenate([np.asarray(_reduce_shuffled._fn(seed, *[m[p] for m in maps]),
                                      dtype=np.float64) for p in range(n)])


def ingest_stall(ds, batch_size: int, prefetch: int, dev, keep: bool):
    """bench.py's ingest stall: seconds blocked in ``next()`` over
    ``iter_batches`` at ``prefetch`` depth, each batch copied to ``dev``
    before a 4 ms step; the copies are kept when ``keep``."""
    it = ds.iter_batches(batch_size=batch_size, prefetch_batches=prefetch)
    stall, got = 0.0, []
    while True:
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        stall += time.perf_counter() - t
        x = torch.tensor(batch["data"], device=dev)  # the batch on the card
        if keep:
            got.append(x)
        time.sleep(0.004)  # bench.py's "train step"
    return stall, got


def _locality_rounds():
    """Wraps the head's round program to note, per call, the device of its
    inputs and whether a locality matrix rode with it, on top of
    ``_record_rounds``'s host copies; returns (records, impl, seen, restore)."""
    from ray_tpu_torch.scheduler import hybrid as H

    records, impl, restore_rec = _record_rounds()
    inner, seen = H.hybrid_schedule_shapes_multi_impl, []

    def probe(*args, **kwargs):
        seen.append((args[0].device.type, kwargs.get("locality") is not None))
        return inner(*args, **kwargs)

    H.hybrid_schedule_shapes_multi_impl = probe

    def restore():
        H.hybrid_schedule_shapes_multi_impl = inner
        restore_rec()

    return records, impl, seen, restore


def shuffle_pass(vector: bool, device: str, rows: int, parts: int, loc_parts: int,
                 groupby_rows: int) -> dict:
    """One of bench.py's ``shuffle_bench`` passes on a fresh
    ``Cluster(use_device_scheduler=True)`` of two agents (4 CPUs, 2
    workers, a 512 MiB arena each): the partitioning path is chosen in the
    workers, so ``RAY_TPU_DATA_VECTOR_SHUFFLE`` is set before the agents
    start. ``random_shuffle(seed=7)`` of ``rows`` f64 rows in ``parts``
    ndarray blocks, its rows held against this process's replay of the map
    and reduce functions; a hash ``groupby("k").count()``; and on the
    vectorized pass the locality run (``loc_parts`` blocks, seed 11,
    ``RAY_TPU_SCHED_W_LOCALITY=2.0``, every head round recorded and
    replayed on the CPU) and the ingest stall at depths 0 and 2, every
    batch landed on the card, the landed rows sorted there."""
    import ray_tpu_torch as rtt
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.core.runtime import set_runtime

    label = "vectorized" if vector else "row loop"
    dev = torch.device(device)
    os.environ["RAY_TPU_DATA_VECTOR_SHUFFLE"] = "1" if vector else "0"
    os.environ["RAY_TPU_SCHED_W_LOCALITY"] = "0"
    res = {}
    t_pass = time.perf_counter()
    c = _cluster(device, use_device_scheduler=True)
    leases, untrace = _trace_leases()
    try:
        nodes = add_nodes(c, *[({"CPU": 4.0}, dict(num_workers=2, store_capacity=1 << 29))] * 2)
        client = c.client()
        set_runtime(client)
        try:
            arr = np.arange(rows, dtype=np.float64)
            t0 = time.perf_counter()
            shuffled = rd.from_numpy_blocks(arr, override_num_blocks=parts).random_shuffle(
                seed=7).materialize()
            refs = shuffled._input_blocks
            ready, _ = rtt.wait(refs, num_returns=len(refs), timeout=600)
            check(len(ready) == len(refs), f"data {label}: {len(ready)}/{len(refs)} reduces sealed")
            sealed = sum(client.object_sizes(refs).values())
            res["mb_s"] = rows * 8 / (time.perf_counter() - t0) / 2**20
            check(sealed >= rows * 8, f"data {label}: reduces sealed {sealed} bytes < {rows * 8}")
            res["shuffle_grants"] = len(leases["grant_ms"])

            g0 = time.perf_counter()
            # a lambda, as bench.py's: shipped by value to the workers
            counts = (rd.range(groupby_rows, override_num_blocks=16)
                      .map(lambda x: {"k": x % 64, "v": x}).groupby("k").count().take_all())
            res["groupby_s"] = time.perf_counter() - g0
            got = {r["k"]: r["count"] for r in counts}
            want = {k: len(range(k, groupby_rows, 64)) for k in range(64)}
            check(got == want, f"data {label}: group counts {sorted(got.items())[:4]}... are not "
                               f"{sorted(want.items())[:4]}...")

            replay = shuffle_replay(np.array_split(arr, parts), 7)
            if not vector:
                host = np.concatenate([np.asarray(b, dtype=np.float64)
                                       for b in shuffled.iter_blocks()])
                check(np.array_equal(host, replay),
                      f"data {label}: the shuffled rows differ from the in-process replay")
            else:
                stall0, landed = ingest_stall(shuffled, max(1, rows // parts // 2), 0, dev, True)
                stall2, _ = ingest_stall(shuffled, max(1, rows // parts // 2), 2, dev, False)
                res["stall"] = (stall0, stall2)
                cat = torch.cat(landed)
                check(cat.device.type == device, f"data: the landed rows lie on {cat.device}")
                check(torch.equal(torch.sort(cat).values,
                                  torch.arange(rows, dtype=torch.float64, device=dev)),
                      "data: the rows the card received, sorted there, are not arange(rows)")
                total = cat.sum().item()
                check(total == rows * (rows - 1) / 2,
                      f"data: the landed rows sum to {total}, not {rows * (rows - 1) // 2}")
                check(torch.equal(cat, torch.from_numpy(replay).to(dev)),
                      "data: the rows the card received differ from the in-process replay")
                del landed, cat

                records, impl, seen, restore = _locality_rounds()
                try:
                    os.environ["RAY_TPU_SCHED_W_LOCALITY"] = "2.0"
                    loc0 = client.query_state("sched").get("locality", {})
                    larr = np.arange(rows // 4, dtype=np.float64)
                    lds = rd.from_numpy_blocks(larr, override_num_blocks=loc_parts).random_shuffle(
                        seed=11).materialize()
                    lrefs = lds._input_blocks
                    ready, _ = rtt.wait(lrefs, num_returns=len(lrefs), timeout=600)
                    loc1 = client.query_state("sched").get("locality", {})
                finally:
                    restore()
                check(len(ready) == len(lrefs), "data: the locality run's reduces did not seal")
                scored = (loc1.get("scored") or 0) - (loc0.get("scored") or 0)
                hits = (loc1.get("hit_frac_sum") or 0.0) - (loc0.get("hit_frac_sum") or 0.0)
                res["locality_scored_leases"] = int(scored)
                res["locality_hit_rate"] = hits / scored if scored else None
                check(scored > 0, "data: no lease was locality-scored")
                with_loc = [d for d, has in seen if has]
                check(with_loc and all(d == device for d in with_loc),
                      f"data: the locality rounds ran on {sorted(set(with_loc))}, not {device}")
                for i, (args, kw, node, avail_out, _) in enumerate(records):
                    out = impl(*args, **kw)
                    check(torch.equal(out.node, node) and torch.equal(out.avail_out, avail_out),
                          f"data: head round {i} of {len(records)} replays differently on the CPU")
                res["rounds"] = (len(records), len(with_loc))
                lrows = np.concatenate([np.asarray(b) for b in lds.iter_blocks()])
                check(np.array_equal(np.sort(lrows), larr)
                      and np.array_equal(lrows, shuffle_replay(np.array_split(larr, loc_parts), 11)),
                      "data: the locality run's rows differ from the in-process replay")
                res["spills"] = _agent_spills(c, nodes)
        finally:
            set_runtime(None)
            client.shutdown()
    finally:
        untrace()
        c.shutdown()
        os.environ.pop("RAY_TPU_DATA_VECTOR_SHUFFLE", None)
        os.environ.pop("RAY_TPU_SCHED_W_LOCALITY", None)
    res["grant_p50_ms"] = float(np.percentile(leases["grant_ms"], 50)) if leases["grant_ms"] else None
    res["grants"] = len(leases["grant_ms"])
    res["seconds"] = time.perf_counter() - t_pass
    print(f"data shuffle {label} on {'; '.join(card_line().splitlines())}: "
          f"{rows:,} f64 rows in {parts} blocks, shuffle_mb_per_s {res['mb_s']:.1f}; "
          f"shuffle_groupby_s {res['groupby_s']:.3f}; lease grants {res['grants']} "
          f"({res['shuffle_grants']} in the shuffle), grant RPC ms p50 "
          f"{res['grant_p50_ms'] if res['grant_p50_ms'] is None else round(res['grant_p50_ms'], 1)}"
          f"; pass {res['seconds']:.1f} s")
    return res


def data_train_steps(batches, config, dev):
    """The ingest loop's body: ``ModelConfig(**config["model"])`` from
    ``init_params`` under ``config["seed"]`` on ``dev``, Adam, one step a
    batch, each batch's int32 rows copied to the card. Returns the losses,
    each row's digest and whether every tensor of the loop lay on ``dev``."""
    import hashlib

    cfg = tfm.ModelConfig(**config["model"])
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(config["seed"]), dev)
    leaves = [x.requires_grad_() for x in tfm.param_leaves(params)]
    opt = torch.optim.Adam(leaves, lr=config["lr"])
    step = tfm.make_train_step(cfg, opt)
    losses, digests, on_dev = [], [], True
    for batch in batches:
        rows = batch["data"]
        digests += [hashlib.sha1(r.tobytes()).hexdigest() for r in rows]
        tokens = torch.tensor(rows, device=dev).long()
        losses.append(step(params, tokens).item())
        # Adam's step counts are host scalars by torch's design
        held = leaves + [tokens] + [v for st in opt.state.values() for k, v in st.items()
                                    if k != "step"]
        on_dev = on_dev and on(held, dev.type)
    return losses, digests, on_dev


def data_train_loop(config):
    """A TorchTrainer worker: its shard of the table through
    ``get_dataset_shard("train")`` (the default prefetch depth), one train
    step a batch; writes its losses and row digests beside the run."""
    from ray_tpu_torch import train

    rank = train.get_context().get_world_rank()
    batches = train.get_dataset_shard("train").iter_batches(batch_size=config["batch"])
    losses, digests, on_dev = data_train_steps(batches, config, torch.device(config["device"]))
    with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
        json.dump(dict(losses=losses, digests=digests, on_device=on_dev), f)
    train.report({"steps": len(losses)})


def data_trainer(device: str, model: dict, seq: int) -> dict:
    """``TorchTrainer(datasets={"train": ds})``: 2 workers on half a GPU
    lease each, on the local runtime with its scheduler on the card, over
    ``from_numpy_blocks(table, 8).random_shuffle(seed=2)`` of a seeded
    256 x (T + 1) int32 table. The ranks' rows are disjoint and cover the
    table; each rank's losses equal, bit for bit, this process's replay of
    its ``ds.split(2)`` shard with the same seed; the flash launches are
    those the steps imply."""
    import hashlib
    import tempfile

    import ray_tpu_torch as rtt
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    dev = torch.device(device)
    t0 = time.perf_counter()
    dt = DATA_TRAIN
    table = np.random.default_rng(dt["seed"]).integers(
        0, min(dt["vocab"], model.get("vocab_size", dt["vocab"])), (dt["rows"], seq + 1),
        dtype=np.int32)
    digests = {hashlib.sha1(r.tobytes()).hexdigest() for r in table}
    check(len(digests) == dt["rows"], "data trainer: the table's rows are not distinct")
    config = dict(model=model, device=device, batch=dt["batch"], seed=dt["seed"], lr=dt["lr"])
    with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_data_") as out:
        config["out"] = out
        rtt.init(num_nodes=1, resources_per_node={"CPU": 4.0, "GPU": 1.0})
        try:
            ds = rd.from_numpy_blocks(table, override_num_blocks=dt["blocks"]).random_shuffle(seed=2)
            zero_launches()
            result = TorchTrainer(
                data_train_loop, train_loop_config=config,
                scaling_config=ScalingConfig(num_workers=2,
                                             resources_per_worker={"CPU": 1.0, "GPU": 0.5}),
                run_config=RunConfig(name="phase-data", storage_path=out),
                datasets={"train": ds},
            ).fit()
            launches = read_launches()
            check(result.error is None, f"data trainer: {result.error!r}")
            ranks = []
            for r in range(2):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            t_replay = time.perf_counter()
            replays = [data_train_steps(shard.iter_batches(batch_size=dt["batch"]), config, dev)
                       for shard in ds.split(2)]
            replay_s = time.perf_counter() - t_replay
        finally:
            rtt.shutdown()
    steps = [len(r["losses"]) for r in ranks]
    seen = [set(r["digests"]) for r in ranks]
    check(sum(len(r["digests"]) for r in ranks) == dt["rows"] and not (seen[0] & seen[1])
          and (seen[0] | seen[1]) == digests,
          f"data trainer: the ranks' rows ({[len(r['digests']) for r in ranks]}) are not a "
          f"partition of the table's {dt['rows']}")
    check(all(r["on_device"] for r in ranks), f"data trainer: a tensor of the loop was off {device}")
    for rank, (r, (losses, dig, on_dev)) in enumerate(zip(ranks, replays)):
        check(dig == r["digests"], f"data trainer: rank {rank}'s replayed rows differ")
        check(losses == r["losses"],
              f"data trainer: rank {rank}'s losses {r['losses'][:3]}... differ from the replay's "
              f"{losses[:3]}...")
    cfg = tfm.ModelConfig(**model)
    per_step = dict(fwd=cfg.n_layers * (2 if cfg.remat else 1), dq=cfg.n_layers, dkv=cfg.n_layers)
    want = {k: v * sum(steps) for k, v in per_step.items()}
    print(f"data trainer: TorchTrainer over the shuffled table, 2 ranks x half a GPU lease, "
          f"steps {steps} (rows {[len(r['digests']) for r in ranks]}), losses rank 0 "
          f"{ranks[0]['losses'][0]:.4f} -> {ranks[0]['losses'][-1]:.4f}, rank 1 "
          f"{ranks[1]['losses'][0]:.4f} -> {ranks[1]['losses'][-1]:.4f}, bit-equal to the "
          f"driver's replay ({replay_s:.1f} s); flash launches {launches}, the steps imply "
          f"{want} ({per_step} a step x {sum(steps)} steps); {time.perf_counter() - t0:.1f} s")
    if device == "cuda":
        check(launches == want, f"data trainer: launches {launches}, the steps imply {want}")
        torch.cuda.empty_cache()
    return launches


def data_processor(device: str, model: dict) -> None:
    """``LLMProcessor`` over ``from_items`` of 8 prompts in 2 blocks
    (``ModelConfig()`` bf16, batch 4, 8 greedy tokens) on the local
    runtime: every row's text names the same token ids as
    ``LLMEngine.generate_ids`` of its prompt in this process. For the
    phase the engines' byte tokenizer decodes each id as ``"<id> "``
    (``id_tokenizer``), so equal texts mean equal tokens."""
    import ray_tpu_torch as rtt
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.llm import LLMProcessor
    from ray_tpu_torch.llm import engine as eng_mod

    t0 = time.perf_counter()
    cfg = tfm.ModelConfig(**model)
    params = tfm.init_params(cfg, torch.Generator(device=device).manual_seed(72), device)
    prompts = [f"row {i} of the data slice's batch" for i in range(8)]
    gen_cfg = GenerationConfig(max_new_tokens=8)
    saved = eng_mod.ByteTokenizer.decode
    eng_mod.ByteTokenizer.decode = lambda self, ids: "".join(f"{int(i)} " for i in ids)
    rtt.init(num_nodes=1, resources_per_node={"CPU": 4.0, "GPU": 1.0})
    try:
        ds = rd.from_items([{"prompt": p} for p in prompts], override_num_blocks=2)
        rows = LLMProcessor(cfg, params, generation=gen_cfg, batch_size=4, max_len=64,
                            device=device).process(ds).take_all()
    finally:
        rtt.shutdown()
        eng_mod.ByteTokenizer.decode = saved
    want = LLMEngine(cfg, params, max_len=64, device=device).generate_ids(
        [eng_mod.ByteTokenizer().encode(p) for p in prompts], gen_cfg)
    got = {r["prompt"]: text_ids([r["generated_text"]]) for r in rows}
    check(sorted(got) == sorted(prompts), f"data processor: rows for {sorted(got)}")
    same = sum(got[p] == list(w) for p, w in zip(prompts, want))
    print(f"data processor: LLMProcessor over a Dataset (8 prompts, 2 blocks, batch 4, 8 greedy "
          f"tokens), {same}/8 streams token-equal to LLMEngine.generate_ids; "
          f"{time.perf_counter() - t0:.1f} s")
    check(same == 8, "data processor: a stream differs from LLMEngine's")


def phase_data(device: str = "cuda", model=None, seq: int = 512, shuffle=None) -> dict:
    """``data/`` on the card: bench.py's ``shuffle_bench`` (the row loop,
    then the vectorized path with the locality run and the ingest stall),
    ``TorchTrainer`` over a shuffled dataset on the flash kernels, and,
    where pyarrow imports, ``LLMProcessor`` over a dataset. Returns the
    trainer's flash launches."""
    _platform_env(device)
    t0 = time.perf_counter()
    libs = data_libs()
    sh = dict(SHUFFLE, **(shuffle or {}))
    errors = _RuntimeErrors()
    try:
        slow = shuffle_pass(False, device, **sh)
        fast = shuffle_pass(True, device, **sh)
        errors.check("data shuffle")
    finally:
        errors.close()
    stall0, stall2 = fast["stall"]
    print(f"data shuffle on {'; '.join(card_line().splitlines())}: shuffle_mb_per_s vectorized "
          f"{fast['mb_s']:.1f}, row loop {slow['mb_s']:.1f}, speedup "
          f"{fast['mb_s'] / max(slow['mb_s'], 1e-9):.2f}; shuffle_groupby_s vectorized "
          f"{fast['groupby_s']:.3f}, row loop {slow['groupby_s']:.3f}; "
          f"shuffle_locality_hit_rate {fast['locality_hit_rate']} over "
          f"{fast['locality_scored_leases']} locality-scored leases; head rounds recorded "
          f"{fast['rounds'][0]} ({fast['rounds'][1]} with locality on {device}), each replayed "
          f"equal on the CPU; ingest_stall_s prefetch 0 {stall0:.3f}, prefetch 2 {stall2:.3f}, "
          f"ratio {stall2 / max(stall0, 1e-9):.3f}; arena spills {fast['spills']}; grant RPC ms "
          f"p50 row loop {slow['grant_p50_ms']}, vectorized {fast['grant_p50_ms']}")
    check(fast["spills"] == 0, f"data: the arenas spilled {fast['spills']} objects")
    model = {} if model is None else dict(model)  # ModelConfig(): bf16, d_model 512, 4 layers
    launches = data_trainer(device, model, seq)
    if libs["pyarrow"]:
        data_processor(device, model)
    else:
        print("data processor: skipped, pyarrow does not import here (a dict result of "
              "map_batches becomes an Arrow block)")
    print(f"data phase: {time.perf_counter() - t0:.1f} s")
    return launches


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


CPU_ROUNDS = 16  # of the 49 rounds of 4,096 the card runs


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
        # the CPU twin replays the stream's first CPU_ROUNDS rounds (the
        # state carries from round to round, so a prefix is a whole
        # comparison): the smoke's time
        cpu, cpu_row, _, _ = head_run("cpu", batches[:CPU_ROUNDS], weights, with_ages, label)
        divergence = int((card[:cpu.shape[0]] != cpu).sum())
        print(f"sched head round {label}: placement divergence card vs CPU {divergence} over "
              f"the first {len(batches[:CPU_ROUNDS])} of {len(batches)} rounds")
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
    # 2 chunks of 2048 (2 of 4096, 8 of 4096 before): the CPU side of 2 x 4096 took
    # 15.5 s of the smoke; two chunks keep the availability and seed carried
    # from chunk to chunk under the comparison
    chunks = bench_demands(2 * 2048, rng).reshape(2, 2048, 16)
    res = both("hybrid_schedule_rounds_chunked N=1024 2x2048", lambda d: tuple(
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
    avail, alive, node types, shapes, ids, ages, seed, options), its node
    rows, its avail and its preemption nominations (None when the round
    nominates none) are kept on the host; returns (records, impl,
    restore)."""
    from ray_tpu_torch.scheduler import hybrid as H

    impl = H.hybrid_schedule_shapes_multi_impl
    records = []

    def _recorded(*args, **kwargs):
        host = [a.detach().cpu().clone() if isinstance(a, torch.Tensor) else a for a in args]
        kw = {k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v)
              for k, v in kwargs.items()}
        res = impl(*args, **kwargs)
        pre = res.preempt_node.cpu().clone() if kwargs.get("preempt") else None
        records.append((host, kw, res.node.cpu().clone(), res.avail_out.cpu().clone(), pre))
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
        for i, (args, kw, node, avail_out, _) in enumerate(records):
            res = impl(*args, **kw)
            check(torch.equal(res.node, node) and torch.equal(res.avail_out, avail_out),
                  f"runtime: round {i} of {len(records)} replays differently on the CPU")
        print(f"runtime replay: {len(records)} card rounds replayed on the CPU, every node row "
              f"and avail_out equal")
        os.environ["RAY_TPU_SCHED_PLATFORM"] = "cpu"
        try:
            # one pass of a quarter of the card's (bench.py's two of 10,000)
            # on the CPU twin: the smoke's time
            cpu = runtime_burst("CPU path", "cpu", num_tasks=2_500, passes=1)
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


def add_nodes(c, *nodes) -> list:
    """Starts one agent per ``(resources, add_node keyword arguments)`` all
    at once, then waits until every agent of ``c`` is up: an agent's start
    (its imports, its zygote) takes seconds, and the agents of one cluster
    need not start one after the other. Returns the node ids in order."""
    ids = [c.add_node(res, wait=False, **kw) for res, kw in nodes]
    c.wait_for_nodes(len(c._agents))
    return ids


def _trace_leases():
    """Traces the client's lease cache by wrapping ``_TaskLeaseManager``'s
    and ``_TaskLeaseChannel``'s methods (nothing changes in the package):
    each grant request's RPC time and answer, each miss by the state of
    its shape's leases at that moment, and each lease's age when it is
    dropped (idle TTL, stall or failure). Returns (stats, restore)."""
    from ray_tpu_torch.cluster import client as C
    from ray_tpu_torch.cluster.head import HeadServer as H

    mgr, chan = C._TaskLeaseManager, C._TaskLeaseChannel
    saved = (mgr.submit, mgr._grant, mgr._drop_channel, chan.__init__)
    head_saved = (H._grant_task_lease_inner, H._send_grants, H._apply_task_lease_reports)
    stats = {"grant_ms": [], "requests": 0, "granted": 0, "misses": {}, "ages": [],
             "drops": {}, "born": {}, "ttl": set(),
             # the head's side of each grant: when its long-poll began, when
             # the round's grant sent the lease to an agent, when the agent's
             # activation report landed, when the long-poll answered
             "head": {"sent": {}, "active": {}, "rows": [], "unanswered": 0}}
    head = stats["head"]

    def grant_inner(self, req):
        t0 = time.monotonic()
        reply = head_saved[0](self, req)
        if reply.get("granted"):
            head["rows"].append((t0, reply["lease_id"], time.monotonic()))
        else:
            head["unanswered"] += 1
        return reply

    def send_grants(self, grants):
        now = time.monotonic()
        for specs in grants.values():
            for sp in specs:
                if sp.kind == "worker_lease":
                    head["sent"].setdefault(sp.task_id, now)
        return head_saved[1](self, grants)

    def task_lease_reports(self, reports):
        now = time.monotonic()
        for tl in reports:
            if tl.get("ok"):
                head["active"].setdefault(tl["lease_id"], now)
        return head_saved[2](self, reports)

    H._grant_task_lease_inner, H._send_grants = grant_inner, send_grants
    H._apply_task_lease_reports = task_lease_reports

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
        H._grant_task_lease_inner, H._send_grants, H._apply_task_lease_reports = head_saved

    return stats, restore


def _head_grant_trace(head: dict) -> str:
    """The head's side of the traced grants: ms from the long-poll's start
    to the round's send to an agent, from the send to the agent's
    activation report, and from the report to the answer (p50/p99)."""
    rows = [(t0, head["sent"].get(lid), head["active"].get(lid), t1)
            for t0, lid, t1 in head["rows"]]
    done = [r for r in rows if r[1] is not None and r[2] is not None]
    return (f"head side: {len(rows)} answered granted, {head['unanswered']} answered not "
            f"granted; worker leases sent to agents {len(head['sent'])}, activated "
            f"{len(head['active'])}; ms p50/p99 long-poll start to send "
            f"{_pcts([(s - t0) * 1e3 for t0, s, _, _ in done])}, send to activation "
            f"{_pcts([(a - s) * 1e3 for _, s, a, _ in done])}, activation to answer "
            f"{_pcts([(t1 - a) * 1e3 for _, _, a, t1 in done])}")


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
        add_nodes(c, *[({"CPU": 16.0}, dict(num_workers=4))] * 2)
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
                  f"{len(leases['born'])} live at the end; lease TTL s {sorted(leases['ttl'])}; "
                  f"{_head_grant_trace(leases['head'])}")
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


def unequal_replays(records, impl, ring_records, ring_impl) -> list:
    """Runs every head round and ring round recorded by ``_record_rounds``
    and ``_record_ring_rounds`` again on the CPU; names each whose outputs
    (the nominations too) differ."""
    out = []
    for i, (args, kw, node, avail_out, pre) in enumerate(records):
        res = impl(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args], **kw)
        if not (torch.equal(res.node, node) and torch.equal(res.avail_out, avail_out)
                and (pre is None or torch.equal(res.preempt_node, pre))):
            out.append(f"head round {i} of {len(records)}")
    for i, (args, kw, outs, _, _) in enumerate(ring_records):
        res = ring_impl(*args, **kw)
        if not all(torch.equal(a, b) for a, b in zip(res, outs)):
            out.append(f"ring round {i} of {len(ring_records)}")
    return out


def _replay_rounds(label: str, records, impl, ring_records, ring_impl) -> None:
    """Every head round and ring round recorded by ``_record_rounds`` and
    ``_record_ring_rounds`` runs again on the CPU with equal outputs."""
    check(len(records) + len(ring_records) > 0, f"{label}: no head round was recorded")
    bad = unequal_replays(records, impl, ring_records, ring_impl)
    check(not bad, f"{label}: {', '.join(bad[:3])} replay differently on the CPU "
                   f"({len(bad)} in all)")


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
        # one pass of bench.py's two, as on the CPU path below: the smoke's time
        card, card_rounds, card_hits, card_misses = cluster_burst("card", "cuda", passes=1)
        print(f"cluster phase: card burst done at {time.perf_counter() - t0:.1f} s")
        card_ring = list(ring_records)
        errors.check("cluster burst on the card")
        records, impl, restore = _record_rounds()
        restores.append(restore)
        os.environ["RAY_TPU_HEALTH_TIMEOUT_S"] = "4.0"  # kill_node is noticed in seconds
        try:
            with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_head_") as d:
                c = _cluster("cuda", persist_path=os.path.join(d, "head_state.pkl"))
                try:
                    add_nodes(c, *[({"CPU": 16.0}, dict(num_workers=4))] * 2)
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
        print(f"cluster phase: functional workload done at {time.perf_counter() - t0:.1f} s")
        check(len(records) > 0, "cluster: no head round was recorded")
        for i, (args, kw, node, avail_out, _) in enumerate(records):
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
            # a quarter of a pass on the CPU twin (the card's pass is bench.py's
            # 10,000 tasks): the smoke's time
            cpu, cpu_rounds, cpu_hits, cpu_misses = cluster_burst("CPU path", "cpu",
                                                                  num_tasks=2_500, passes=1)
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
    ``solve_pack_counts`` on the card. Each recorded solve is held against
    the CPU's solve of its inputs (each distinct input solved once there):
    per_node and placed equal, the residual within 1e-5."""
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
    tick = (f"tick {out['tick_p50_ms']:.3f} ms (the first, cold)" if ticks == 1 else
            f"tick p50 {out['tick_p50_ms']:.3f} ms p99 {out['tick_p99_ms']:.3f} ms")
    print(f"elasticity [{device}] {num_nodes} nodes, {task_shapes} parked shapes: {ticks} ticks, "
          f"{tick}, "
          f"{out['ticks_per_s']} ticks/s, solve_path {out['solve_path']}, demand rows "
          f"{out['demand_rows']}, serve hints {out['serve_hints']}, world hints "
          f"{out['world_hints']}; solve shape {solves[-1][0][1].shape[0]} x "
          f"{solves[-1][0][0].shape[0]}, solve ms (upload to outputs on the host) p50/p99 "
          f"{_pcts([x[4] for x in solves])}")
    t1 = time.perf_counter()
    worst = 0.0
    cpu = {}  # a tick solves the same inputs more than once: each is replayed once
    for i, ((avail, shapes, counts), kw, _, outs, _) in enumerate(solves):
        key = (avail.tobytes(), shapes.tobytes(), counts.tobytes(), repr(sorted(kw.items())))
        if key not in cpu:
            cpu[key] = impl(avail, shapes, counts, **{**kw, "device": "cpu"})
        res = cpu[key]
        check(torch.equal(res.per_node, outs[1]) and torch.equal(res.placed, outs[0]),
              f"elasticity: solve {i} of {len(solves)} places differently on the CPU")
        err = float((res.avail_out - outs[2]).abs().max())
        worst = max(worst, err)
        check(err <= SCHED_EPS, f"elasticity: solve {i} residual off the CPU's by {err:.3g}")
    print(f"elasticity replay: {len(solves)} solves ({len(cpu)} distinct inputs) against the "
          f"CPU, per_node and placed equal, residual max abs err {worst:.3g} (tolerance "
          f"{SCHED_EPS}) ({time.perf_counter() - t1:.1f} s)")
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
            add_nodes(c, *[({"CPU": 2.0}, dict(num_workers=1))] * 2)
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
                add_nodes(c, *[({"CPU": 4.0}, dict(num_workers=2))] * 2)
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


# --- the chaos harness: bench.py's chaos soak with the head on the card ---

CHAOS_SEED = 20260803  # bench.py chaos_bench's default seed
CHAOS_FAULTS = 12  # the first 12 of its 20 faults: all six of the plan's kinds


def _resident_states(device: str) -> dict:
    """id -> every scheduler state in this process that holds ``device``
    memory now (no collection forced: a state left for the collector to
    find counts)."""
    import gc
    import warnings

    from ray_tpu_torch.scheduler.device import DeviceSchedulerState

    with warnings.catch_warnings():  # isinstance reaches deprecated module attributes
        warnings.simplefilter("ignore")
        return {id(o): o for o in gc.get_objects()
                if isinstance(o, DeviceSchedulerState) and o.device.type == device
                and o.resident_bytes() > 0}


def _watch_restart(c, device: str, records: list, ring_records: list) -> dict:
    """Wraps ``c.restart_head`` to note, at the restart, the old head's
    state, the states holding ``device`` memory, the card's allocated bytes
    and how many rounds were recorded so far."""
    seen = {}
    restart = c.restart_head

    def _restart():
        if device == "cuda":
            torch.cuda.synchronize()
        old = c.head.device_state
        seen.update(old=old, old_bytes=old.resident_bytes(), before=_resident_states(device),
                    mem=torch.cuda.memory_allocated() if device == "cuda" else 0,
                    rounds=len(records), ring=len(ring_records))
        restart()
        seen["new"] = c.head.device_state

    c.restart_head = _restart
    return seen


def _trace_checks():
    """Times each invariant wait the orchestrator runs after a fault, by
    wrapping the checker's and the workload's methods (nothing changes in
    the package). Returns ({(seed, index, kind): {wait: seconds}}, restore)."""
    from ray_tpu_torch.chaos import invariants as inv
    from ray_tpu_torch.chaos import orchestrator as orc
    from ray_tpu_torch.chaos import workload as wl

    spans, cur, saved = {}, [None], []

    def wrap(cls, name):
        fn = getattr(cls, name)
        saved.append((cls, name, fn))

        def timed_call(self, *a, **k):
            t = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                if cur[0] is not None:
                    d = spans.setdefault(cur[0], {})
                    d[name] = d.get(name, 0.0) + time.perf_counter() - t

        setattr(cls, name, timed_call)

    for name in ("wait_membership", "wait_actors", "check_leases_drained", "wait_owner_reaped",
                 "wait_streams_resume", "wait_replica_backfilled",
                 "wait_streams_resume_cross_router"):
        wrap(inv.InvariantChecker, name)
    for name in ("verify_acked", "verify_ref"):
        wrap(wl.ChaosWorkload, name)
    inject = orc.ChaosOrchestrator._inject
    saved.append((orc.ChaosOrchestrator, "_inject", inject))

    def _inject(self, spec):
        cur[0] = (self.plan.seed, spec.index, spec.kind)
        return inject(self, spec)

    orc.ChaosOrchestrator._inject = _inject

    def restore():
        for cls, name, fn in saved:
            setattr(cls, name, fn)

    return spans, restore


def _print_check_spans(label: str, spans: dict, res) -> None:
    """One line a fault: its recovery and the invariant waits inside it."""
    for f in res.faults:
        waits = spans.get((res.seed, f.spec.index, f.spec.kind), {})
        print(f"{label} #{f.spec.index} {f.spec.kind} waits (s): recovery {f.recovery_s:.3f}; "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(waits.items(), key=lambda kv: -kv[1])))


def phase_chaos(device: str = "cuda", num_faults: int = CHAOS_FAULTS):
    """bench.py's ``chaos_bench`` on the port with the head's rounds on
    ``device``: a ``Cluster`` with a WAL and two agents of 2 CPUs and 2
    workers, ``ChaosWorkload`` (150,000-byte payloads, one restartable
    actor), ``make_plan(20260803, num_faults)`` (the first faults of
    bench.py's 20) under ``ChaosOrchestrator`` (partition hold 1 s,
    convergence budget 60 s), then, on the same cluster,
    ``make_plan(20260803, 1, allow=("head_restart",))``, then 16 tasks of a
    shape no lease holds, which the restarted head places. Both runs ``ok``,
    the injected schedule equal to the plan, zero acked-object loss, no
    arena zombie, no ERROR record; every head and ring round of the phase
    (after the restart too) replays equal on the CPU; after the restart the
    old head's state holds no device memory and one state holds it."""
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch.chaos import ChaosOrchestrator, ChaosWorkload, make_plan
    from ray_tpu_torch.cluster.rpc import _BREAKERS
    from ray_tpu_torch.core.runtime import set_runtime

    _platform_env(device)
    # bench.py's failure-detection knobs: the soak's time goes to faults
    env = {"RAY_TPU_HEALTH_TIMEOUT_S": "4.0", "RAY_TPU_RPC_BREAKER_WINDOW_S": "2.0"}
    os.environ.update(env)
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    records, impl, restore = _record_rounds()
    ring_records, ring_impl, ring_restore = _record_ring_rounds()
    spans, untrace = _trace_checks()
    opens0 = sum(b.open_count for b in _BREAKERS.values())
    runs = []
    try:
        with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_chaos_") as d:
            c = _cluster(device, persist_path=os.path.join(d, "head_state.pkl"))
            try:
                add_nodes(c, *[({"CPU": 2.0}, dict(num_workers=2))] * 2)
                seen = _watch_restart(c, device, records, ring_records)
                client = c.client()
                set_runtime(client)
                try:
                    workload = ChaosWorkload(client, payload_bytes=150_000, num_actors=1)
                    for plan in (make_plan(CHAOS_SEED, num_faults),
                                 make_plan(CHAOS_SEED, 1, allow=("head_restart",))):
                        orch = ChaosOrchestrator(c, workload, plan, node_resources={"CPU": 2.0},
                                                 partition_hold_s=1.0, convergence_budget_s=60.0)
                        t1 = time.perf_counter()
                        runs.append((plan, orch.run(), time.perf_counter() - t1))

                    # a shape no lease holds: the restarted head's rounds place it
                    # (the workload's own tasks may all ride cached leases)
                    def burst(i):
                        return i * i

                    f = rtt.remote(num_cpus=0.5)(burst)
                    got = rtt.get([f.remote(i) for i in range(16)], timeout=120)
                    check(got == [i * i for i in range(16)],
                          f"chaos: the restarted head's burst gave {got[:3]}...")
                finally:
                    set_runtime(None)
                    client.shutdown()
                head_rounds = c.head.metrics["sched_rounds"]
                after = _resident_states(device)
                new_bytes = seen["new"].resident_bytes() if seen.get("new") else 0
                mem = torch.cuda.memory_allocated() if device == "cuda" else 0
            finally:
                c.shutdown()
    finally:
        restore()
        ring_restore()
        untrace()
        errors.close()
        for k in env:
            os.environ.pop(k, None)
    opens = sum(b.open_count for b in _BREAKERS.values()) - opens0
    for plan, res, wall in runs:
        summ = res.summary()
        lat = res.recovery_percentiles()
        print(f"chaos seed {plan.seed}, {len(res.faults)} faults {summ['fault_counts']} with the "
              f"head on {device} [{card_line()}]: ok {res.ok}; objects acked "
              f"{res.objects_acked}, reconstructed {res.objects_reconstructed}, owners killed "
              f"{res.owners_killed}; recovery p50 {lat['p50']:.3f} s p95 {lat['p95']:.3f} s; "
              f"arena zombies after {res.arena_zombies_after}; wall {wall:.1f} s")
        for f in res.faults:
            print(f"chaos #{f.spec.index} {f.spec.kind}: {f.recovery_s:.3f} s, {f.detail}"
                  + (f"; FAILED {f.failures}" if not f.ok else ""))
        _print_check_spans("chaos", spans, res)
        check(res.ok, f"chaos seed {plan.seed}: invariants failed: {summ['failures']}")
        check([(f.spec.index, f.spec.kind) for f in res.faults]
              == [(f.index, f.kind) for f in plan.faults],
              f"chaos seed {plan.seed}: the injected schedule differs from the plan")
        check(res.arena_zombies_after == 0,
              f"chaos: {res.arena_zombies_after} arena zombies after the soak")
    soak = runs[0][1]
    check(len(soak.faults) == num_faults and len(runs[1][1].faults) == 1,
          f"chaos: {len(soak.faults)} + {len(runs[1][1].faults)} faults")
    check(soak.objects_acked >= num_faults, f"chaos: {soak.objects_acked} objects acked")
    check(runs[1][1].faults[0].detail.startswith("head restarted"),
          f"chaos: the head was not restarted: {runs[1][1].faults[0].detail}")
    errors.check("chaos")
    # the restart: the old head's state released, one state resident
    check(seen.get("new") is not None and seen["old"] is not seen["new"],
          "chaos: no head restart was watched")
    check(seen["old"].resident_bytes() == 0,
          f"chaos: the old head's state still holds {seen['old'].resident_bytes()} bytes")
    grown = set(after) - set(seen["before"])
    check(id(seen["old"]) not in after and grown <= {id(seen["new"])},
          f"chaos: {len(grown)} scheduler states took {device} memory after the restart")
    print(f"chaos head restart: the old head's state held {seen['old_bytes']} bytes and holds 0; "
          f"scheduler states holding {device} memory {len(seen['before'])} before, {len(after)} "
          f"after (the new head's {new_bytes} bytes); allocated on the card "
          f"{seen['mem']} -> {mem} bytes; {opens} breaker opens; head sched_rounds since the "
          f"restart {head_rounds}")
    # every recorded round replays equal on the CPU
    check(len(records) - seen["rounds"] + len(ring_records) - seen["ring"] > 0,
          "chaos: no head round was recorded after the restart")
    _replay_rounds("chaos", records, impl, ring_records, ring_impl)
    lat = soak.recovery_percentiles()
    print(f"chaos replay: {len(records)} head rounds ({len(records) - seen['rounds']} after the "
          f"restart) and {len(ring_records)} ring rounds ({len(ring_records) - seen['ring']} "
          f"after) replayed on the CPU, every output equal")
    print(f"chaos: chaos_seed {CHAOS_SEED}, chaos_ok {all(r.ok for _, r, _ in runs)}, "
          f"chaos_faults_injected {num_faults}+1, chaos_fault_counts "
          f"{soak.summary()['fault_counts']} + head_restart, chaos_objects_acked "
          f"{runs[1][1].objects_acked}, chaos_objects_reconstructed "
          f"{sum(r.objects_reconstructed for _, r, _ in runs)}, chaos_owners_killed "
          f"{soak.owners_killed}, recovery_p50_s {lat['p50']:.3f}, recovery_p95_s "
          f"{lat['p95']:.3f}, chaos_breaker_opens {opens}, arena_zombies_after_soak "
          f"{runs[1][1].arena_zombies_after}, chaos_wall_s {sum(w for _, _, w in runs):.1f} "
          f"[{card_line()}]")
    print(f"chaos phase: {time.perf_counter() - t0:.1f} s")


FAILOVER_SEED = 20260805  # tests/test_head_failover.py's soak seed: 3 failovers in 8 faults
FAILOVER_FAULTS = 8


def _watch_heads(c) -> list:
    """The list of every head ``c`` runs, the first and, as each standby
    promotes, the promoted one."""
    heads = [c.head]
    adopt = c._adopt_head

    def _adopt(head):
        heads.append(head)
        adopt(head)

    c._adopt_head = _adopt  # start_standby hands this to each standby
    return heads


def failover_verdicts(plan, res, heads, resident: dict, device: str, lost: list) -> list:
    """What the failover soak must show, as a list of failures: the run
    ``ok``, at least 2 promotions (each fired, a head each), the injected
    schedule equal to the plan, no acked object lost, every head's state on
    ``device``, every killed leader's state released and exactly one state
    (the last leader's) holding ``device`` memory."""
    out = []
    if not res.ok:
        out.append(f"invariants failed: {res.summary()['failures']}")
    promotions = sum(f.spec.kind == "head_kill_promote" and not f.detail.startswith("skipped")
                     for f in res.faults)
    if promotions < 2 or len(heads) != promotions + 1:
        out.append(f"{promotions} head_kill_promote faults, {len(heads)} heads")
    if [(f.spec.index, f.spec.kind) for f in res.faults] != [(f.index, f.kind)
                                                            for f in plan.faults]:
        out.append("the injected schedule differs from the plan")
    if lost:
        out.append(f"{len(lost)} acked objects lost: {lost[:2]}")
    off = [h.device_state.device.type for h in heads
           if h.device_state is None or h.device_state.device.type != device]
    if off:
        out.append(f"heads whose scheduler state is not on {device}: {off}")
    held = [h.device_state.resident_bytes() for h in heads[:-1]]
    if any(held):
        out.append(f"killed leaders still hold {held} bytes")
    if set(resident) != {id(heads[-1].device_state)}:
        out.append(f"{len(resident)} scheduler states hold {device} memory, not the last "
                   "leader's alone")
    return out


def phase_failover_soak(device: str = "cuda", num_faults: int = FAILOVER_FAULTS):
    """``tests/test_head_failover.py``'s slow soak with the head's rounds on
    ``device``: a ``Cluster`` with a WAL and two agents of 2 CPUs and 2
    workers, an auto-promoting standby (each promoted head brings its state
    up on ``device``), ``ChaosWorkload`` (150,000-byte payloads, 1 actor),
    ``make_plan(20260805, 8, FAILOVER_MIX, allow=(head_kill_promote,
    partition, object_drop))`` under ``ChaosOrchestrator`` (partition hold
    1 s, budget 90 s; head health 1.5 s, health 4 s, breaker window 2 s).
    ``failover_verdicts`` must hold, every acked object reads back, no
    ERROR record, and every head and ring round of every head replays
    equal on the CPU."""
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch.chaos import FAILOVER_MIX, ChaosOrchestrator, ChaosWorkload, make_plan
    from ray_tpu_torch.core.runtime import set_runtime

    _platform_env(device)
    env = {"RAY_TPU_HEAD_HEALTH_TIMEOUT_S": "1.5", "RAY_TPU_HEALTH_TIMEOUT_S": "4.0",
           "RAY_TPU_RPC_BREAKER_WINDOW_S": "2.0"}
    os.environ.update(env)
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    records, impl, restore = _record_rounds()
    ring_records, ring_impl, ring_restore = _record_ring_rounds()
    plan = make_plan(FAILOVER_SEED, num_faults, mix=FAILOVER_MIX,
                     allow=("head_kill_promote", "partition", "object_drop"))
    try:
        with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_failover_") as d:
            c = _cluster(device, persist_path=os.path.join(d, "head_state.pkl"))
            heads = _watch_heads(c)
            try:
                add_nodes(c, *[({"CPU": 2.0}, dict(num_workers=2))] * 2)
                client = c.client()
                set_runtime(client)
                try:
                    c.start_standby(auto_promote=True)
                    workload = ChaosWorkload(client, payload_bytes=150_000, num_actors=1)
                    orch = ChaosOrchestrator(c, workload, plan, node_resources={"CPU": 2.0},
                                             partition_hold_s=1.0, convergence_budget_s=90.0)
                    t1 = time.perf_counter()
                    res = orch.run()
                    wall = time.perf_counter() - t1
                    # every acked object of the soak, not a sample, reads back whole
                    lost = workload.verify_acked(sample=len(workload.acked), timeout=60.0)

                    # a shape no lease holds: the last leader's rounds place it
                    def burst(i):
                        return i * i

                    before = c.head.metrics["sched_rounds"]
                    f = rtt.remote(num_cpus=0.5)(burst)
                    got = rtt.get([f.remote(i) for i in range(16)], timeout=120)
                    check(got == [i * i for i in range(16)]
                          and c.head.metrics["sched_rounds"] > before,
                          f"failover soak: the last leader placed no burst ({got[:3]}...)")
                finally:
                    set_runtime(None)
                    client.shutdown()
                if device == "cuda":
                    torch.cuda.synchronize()
                resident = _resident_states(device)
                rounds = [h.metrics["sched_rounds"] for h in heads]
                failures = failover_verdicts(plan, res, heads, resident, device, lost)
            finally:
                c.shutdown()
    finally:
        restore()
        ring_restore()
        errors.close()
        for k in env:
            os.environ.pop(k, None)
    lat = res.recovery_percentiles()
    for f in res.faults:
        print(f"failover #{f.spec.index} {f.spec.kind}: {f.recovery_s:.3f} s, {f.detail}"
              + (f"; FAILED {f.failures}" if not f.ok else ""))
    print(f"failover soak seed {plan.seed}, {len(res.faults)} faults "
          f"{res.summary()['fault_counts']} with the head on {device} [{card_line()}]: ok "
          f"{res.ok}; objects acked {res.objects_acked} ({len(workload.acked)} read back, "
          f"{len(lost)} lost), reconstructed {res.objects_reconstructed}; recovery p50 "
          f"{lat['p50']:.3f} s p95 {lat['p95']:.3f} s; arena zombies {res.arena_zombies_after}; "
          f"{len(heads)} heads, head rounds {rounds}; {len(resident)} scheduler state holding "
          f"{device} memory at the end; wall {wall:.1f} s")
    check(not failures, f"failover soak: {failures}")
    errors.check("failover soak")
    _replay_rounds("failover soak", records, impl, ring_records, ring_impl)
    print(f"failover soak replay: {len(records)} head rounds and {len(ring_records)} ring rounds "
          f"of the {len(heads)} heads replayed on the CPU, every output equal")
    print(f"failover soak phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# executed preemption: tests/test_preemption.py's three cluster scenarios
# ---------------------------------------------------------------------------
# tests/test_preemption.py:53-57's fixture: a shape starves after 2 park
# retry rounds, 0.2 s between preemptions of one shape
PREEMPT_ENV = {"RAY_TPU_SCHED_STARVE_ROUNDS": "2", "RAY_TPU_SCHED_PREEMPT_COOLDOWN_S": "0.2",
               "RAY_TPU_SCHED_PREEMPT": "1"}
PREEMPT_SLEEP_S = {"retryable": 10.0, "at-most-once": 8.0, "storm": 6.0}  # the reference's


def preemption_verdicts(runs: dict, rounds: int, unequal: list, errors: list) -> list:
    """What the three preemption scenarios must show, as a list of
    failures. ``runs`` maps each scenario to what it saw: the head's
    ``nominations`` and ``preemptions``; for ``retryable``, the big task's
    value ``big`` and seconds ``big_s`` against the sleepers' ``sleep_s``,
    the sleepers' values ``victims`` and executions ``runs``; for
    ``at-most-once`` the same, and ``after_s``, how long after the last
    sleeper's natural end the big task ended; for ``storm``, ``lost`` (a
    retryable or starving task without its value), ``once_runs`` (the
    at-most-once tasks' executions) and ``unresolved`` (at-most-once tasks
    with neither a value nor an error). ``rounds`` is the head and ring
    rounds recorded, ``unequal`` those whose CPU replay differed, ``errors``
    the ERROR records."""
    out = []
    a = runs.get("retryable")
    if a is None:
        out.append("(a) retryable: did not run")
    else:
        if a["nominations"] == 0:
            out.append("(a) retryable: no preemption nomination")
        if a["preemptions"] == 0:
            out.append("(a) retryable: no preemption executed")
        if a["big"] != "ok" or a["big_s"] >= 0.9 * a["sleep_s"]:
            out.append(f"(a) retryable: the big task gave {a['big']!r} after {a['big_s']:.1f} s, "
                       f"not before the sleepers' natural end ({a['sleep_s']:.0f} s)")
        if a["victims"] != ["slept"] * len(a["runs"]) or min(a["runs"], default=0) < 2:
            out.append(f"(a) retryable: the victims gave {a['victims']} after {a['runs']} "
                       f"executions, not requeued and complete")
    b = runs.get("at-most-once")
    if b is None:
        out.append("(b) at-most-once: did not run")
    else:
        if b["preemptions"] or b["runs"] != [1] * len(b["runs"]) \
                or b["victims"] != ["slept"] * len(b["runs"]):
            out.append(f"(b) at-most-once: a max_retries=0 task was killed ({b['preemptions']} "
                       f"preemptions, executions {b['runs']}, values {b['victims']})")
        if b["big"] != "ok" or b["after_s"] < 0:
            out.append(f"(b) at-most-once: the big task gave {b['big']!r} "
                       f"{-b['after_s']:.1f} s before the sleepers' natural end")
    c = runs.get("storm")
    if c is None:
        out.append("(c) storm: did not run")
    else:
        if c["nominations"] == 0:
            out.append("(c) storm: no preemption nomination")
        if c["preemptions"] == 0:
            out.append("(c) storm: no preemption executed")
        if c["lost"]:
            out.append(f"(c) storm: {c['lost']} acked objects lost")
        if any(n > 1 for n in c["once_runs"]):
            out.append(f"(c) storm: an at-most-once task ran more than once {c['once_runs']}")
        if c["unresolved"]:
            out.append(f"(c) storm: {c['unresolved']} at-most-once tasks never resolved")
    if rounds == 0:
        out.append("no head or ring round was recorded")
    if unequal:
        out.append(f"unequal on the CPU replay: {', '.join(unequal[:3])} ({len(unequal)} in all)")
    if errors:
        out.append(f"{len(errors)} ERROR records, first: {errors[0]}")
    return out


def _preempt_fns():
    """The reference's sleeper and no-op, made here so that cloudpickle
    sends them by value: a worker need not import this script."""
    def sleeper(path, seconds):
        # one line per execution: the at-most-once checks count these
        with open(path, "a") as f:
            f.write(f"{os.getpid()} {time.time()}\n")
            f.flush()
        time.sleep(seconds)
        return "slept"

    def noop():
        return "ok"

    return sleeper, noop


def _executions(path) -> list:
    """The start times (host clock) of a sleeper's executions."""
    try:
        with open(path) as f:
            return [float(line.split()[1]) for line in f]
    except FileNotFoundError:
        return []


def _value(rtt, ref, timeout: float):
    try:
        return rtt.get(ref, timeout=timeout)
    except Exception as exc:  # noqa: BLE001 - an error is an outcome here
        return exc


def _preempt_retryable(c, rtt, d: str) -> dict:
    """tests/test_preemption.py:62: two retryable sleepers pin a 2-CPU
    node, a 2-CPU task starves, the head kills and requeues them."""
    sleeper, noop = _preempt_fns()
    sleep_s = PREEMPT_SLEEP_S["retryable"]
    add_nodes(c, ({"CPU": 2.0}, dict(num_workers=3)))
    paths = [os.path.join(d, f"victim{i}") for i in range(2)]
    sleep_fn = rtt.remote(sleeper).options(num_cpus=1.0, max_retries=3)
    victims = [sleep_fn.remote(p, sleep_s) for p in paths]
    _wait_until(lambda: all(_executions(p) for p in paths), 60, "preemption (a): sleepers running")
    t = time.monotonic()
    big = _value(rtt, rtt.remote(noop).options(num_cpus=2.0, max_retries=0).remote(), 60)
    big_s = time.monotonic() - t
    values = [_value(rtt, r, 60) for r in victims]
    return dict(sleep_s=sleep_s, big=big, big_s=big_s, victims=values,
                runs=[len(_executions(p)) for p in paths])


def _preempt_at_most_once(c, rtt, d: str) -> dict:
    """tests/test_preemption.py:103: max_retries=0 sleepers hold the node;
    the starving shape must wait for them."""
    sleeper, noop = _preempt_fns()
    sleep_s = PREEMPT_SLEEP_S["at-most-once"]
    add_nodes(c, ({"CPU": 2.0}, dict(num_workers=3)))
    paths = [os.path.join(d, f"amo{i}") for i in range(2)]
    once_fn = rtt.remote(sleeper).options(num_cpus=1.0, max_retries=0)
    victims = [once_fn.remote(p, sleep_s) for p in paths]
    _wait_until(lambda: all(_executions(p) for p in paths), 60, "preemption (b): sleepers running")
    t = time.monotonic()
    big = _value(rtt, rtt.remote(noop).options(num_cpus=2.0, max_retries=0).remote(), 60)
    big_s, done = time.monotonic() - t, time.time()
    values = [_value(rtt, r, 30) for r in victims]
    starts = [x for p in paths for x in _executions(p)]
    return dict(sleep_s=sleep_s, big=big, big_s=big_s, victims=values,
                runs=[len(_executions(p)) for p in paths],
                after_s=done - (max(starts) + sleep_s))


def _preempt_storm(c, rtt, d: str) -> dict:
    """tests/test_preemption.py:184: retryable and at-most-once sleepers
    on two nodes, two starving 2-CPU shapes, one node killed mid-storm."""
    sleeper, noop = _preempt_fns()
    sleep_s = PREEMPT_SLEEP_S["storm"]
    _, n1 = add_nodes(c, *[({"CPU": 2.0}, dict(num_workers=3))] * 2)
    retry_fn = rtt.remote(sleeper).options(num_cpus=1.0, max_retries=5)
    once_fn = rtt.remote(sleeper).options(num_cpus=1.0, max_retries=0)
    retry_paths = [os.path.join(d, f"r{i}") for i in range(3)]
    once_paths = [os.path.join(d, f"o{i}") for i in range(3)]
    retry_refs = [retry_fn.remote(p, sleep_s) for p in retry_paths]
    once_refs = [once_fn.remote(p, sleep_s) for p in once_paths]
    big = rtt.remote(noop).options(num_cpus=2.0, max_retries=1)
    big_refs = [big.remote() for _ in range(2)]
    time.sleep(2.0)  # the storm arms (starve rounds 2, about 1 Hz)
    c.kill_node(n1)
    bigs = [_value(rtt, r, 240) for r in big_refs]
    onces = [_value(rtt, r, 240) for r in once_refs]
    retries = [_value(rtt, r, 240) for r in retry_refs]
    return dict(big=bigs, retry=retries,
                lost=sum(v != "ok" for v in bigs) + sum(v != "slept" for v in retries),
                once_runs=[len(_executions(p)) for p in once_paths],
                unresolved=sum(not (v == "slept" or isinstance(v, Exception)) for v in onces))


def phase_preemption(device: str = "cuda") -> dict:
    """Executed preemption on the port, the head's rounds on ``device``:
    ``tests/test_preemption.py``'s three cluster scenarios, each on a fresh
    ``Cluster`` under its fixture's settings (``PREEMPT_ENV``) and its
    sleeps (``PREEMPT_SLEEP_S``): (a) a starving 2-CPU shape preempts two
    running retryable sleepers, (b) it never preempts ``max_retries=0``
    sleepers, (c) a preemption storm over two nodes with one killed.
    ``preemption_verdicts`` must hold: nominations and preemptions in (a)
    and (c), no at-most-once kill, no acked object lost, every head and
    ring round (the nomination rows too) equal on a CPU replay, no ERROR
    record. Prints each scenario's counters and wall; returns the runs."""
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch.core.runtime import set_runtime

    _platform_env(device)
    os.environ.update(PREEMPT_ENV)
    t0 = time.perf_counter()
    errors = _RuntimeErrors()
    records, impl, restore = _record_rounds()
    ring_records, ring_impl, ring_restore = _record_ring_rounds()
    runs, walls = {}, {}
    try:
        with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_preempt_") as tmp:
            for name, scenario in (("retryable", _preempt_retryable),
                                   ("at-most-once", _preempt_at_most_once),
                                   ("storm", _preempt_storm)):
                t1 = time.perf_counter()
                d = os.path.join(tmp, name)
                os.makedirs(d)
                c = _cluster(device)
                try:
                    client = c.client()
                    set_runtime(client)
                    try:
                        runs[name] = scenario(c, rtt, d)
                    finally:
                        set_runtime(None)
                        client.shutdown()
                    runs[name].update(nominations=c.head.metrics["preempt_nominations"],
                                      preemptions=c.head.metrics["preemptions"],
                                      rounds=c.head.metrics["sched_rounds"])
                finally:
                    c.shutdown()
                walls[name] = time.perf_counter() - t1
    finally:
        restore()
        ring_restore()
        errors.close()
        for k in PREEMPT_ENV:
            os.environ.pop(k, None)
    unequal = unequal_replays(records, impl, ring_records, ring_impl)
    nominated = sum(pre is not None and bool((pre >= 0).any()) for *_, pre in records) \
        + sum(bool((outs[3] >= 0).any()) for _, _, outs, _, _ in ring_records)
    for name, run in runs.items():
        shown = {k: v for k, v in run.items() if k not in ("nominations", "preemptions", "rounds")}
        print(f"preemption ({name}) with the head on {device} [{card_line()}]: "
              f"preempt_nominations {run['nominations']}, preemptions {run['preemptions']}, "
              f"head sched_rounds {run['rounds']}; {shown}; wall {walls[name]:.1f} s")
    print(f"preemption replay: {len(records)} head rounds and {len(ring_records)} ring rounds "
          f"({nominated} with a nomination) replayed on the CPU, {len(unequal)} unequal")
    failures = preemption_verdicts(runs, len(records) + len(ring_records), unequal,
                                   errors.records)
    check(not failures, f"preemption: {failures}")
    print(f"preemption phase: {time.perf_counter() - t0:.1f} s")
    return runs


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
            add_nodes(c, *[({"CPU": 4.0}, dict(num_workers=2))] * 2)
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
            add_nodes(c, *[({"CPU": 16.0}, dict(num_workers=4))] * 2)
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
        _, dst = add_nodes(
            c, ({"CPU": 2.0, "srcres": 1.0, **gpu}, dict(num_workers=1, store_capacity=cap)),
            ({"CPU": 2.0, "dstres": 1.0, **gpu}, dict(num_workers=1, store_capacity=cap)))
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


PHASE_S: dict = {}


_NESTED = [0.0]  # seconds of timed phases inside the one running


def timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds kept under its name for the
    phase-seconds line (a timed phase inside another counts only under its
    own name)."""
    t = time.perf_counter()
    _NESTED.append(0.0)
    try:
        return fn(*args, **kwargs)
    finally:
        dt = time.perf_counter() - t
        inner = _NESTED.pop()
        _NESTED[-1] += dt
        name = fn.__name__.removeprefix("phase_")
        PHASE_S[name] = round(PHASE_S.get(name, 0.0) + dt - inner, 1)


# phases run in a child process beside the others: left out of the total
BESIDE = ("chaos", "failover", "preemption", "rl_soak")


def beside_failure(name: str, text: str, rc: int, tail_lines: int = 40) -> tuple:
    """What the join of a failed child says: the end of its output, for
    stderr (the output went to stdout, which a reader of the run's errors
    may not see), and the FAIL message, which carries the child's own FAIL
    line where it printed one."""
    lines = text.splitlines()
    said = [ln for ln in lines if ln.startswith("chip_smoke: FAIL:")]
    shown = lines[-tail_lines:] + [ln for ln in said if ln not in lines[-tail_lines:]]
    tail = f"--- the last lines of the {name} phase's process ---\n" + "\n".join(shown) + "\n"
    why = (f" ({said[-1].removeprefix('chip_smoke: FAIL: ')})" if said
           else " (it printed no FAIL line: see its last lines above)")
    return tail, f"{name}: the phase's process exited with {rc}{why}"


def start_beside(name: str, label: str = "", held: bool = False):
    """A phase in a child process of this script (``--<name>``) with a
    temp dir of its own (no other cluster's agent sweeps its files); its
    output goes to a file there, printed by the join this returns, which
    keeps the wait for it as ``<name>_wait`` and the phase's own seconds
    (its "<label> phase: N s" line) as ``<name>``. With ``held`` the child
    starts (its imports) and then waits, idle, until the ``go`` returned
    beside the join is called. The join returns the child's output."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    log = open(os.path.join(tmp, f"{name}.log"), "wb")
    here = os.path.dirname(os.path.abspath(__file__))
    go_file = os.path.join(tmp, "go")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), f"--{name}"]
                            + ([go_file] if held else []),
                            stdout=log, stderr=subprocess.STDOUT, cwd=here,
                            env={**os.environ, "TMPDIR": tmp})

    def go():
        open(go_file, "w").close()

    def join():
        t1 = time.perf_counter()
        rc = proc.wait(timeout=900)
        PHASE_S[f"{name}_wait"] = round(time.perf_counter() - t1, 1)
        log.close()
        with open(log.name, "rb") as f:
            text = f.read().decode(errors="replace")
        sys.stdout.write(text)
        sys.stdout.flush()
        # the phase's own seconds, as it printed them
        m = re.search(rf"^{label or name} phase: ([0-9.]+) s$", text, re.M)
        PHASE_S[name] = float(m.group(1)) if m else round(time.perf_counter() - t0, 1)
        shutil.rmtree(tmp, ignore_errors=True)
        if rc != 0 or m is None:
            tail, msg = beside_failure(name, text, rc)
            sys.stderr.write(tail)
            fail(msg)
        return text

    return join, go


def main() -> None:
    if sys.argv[1:] == ["--chaos"]:
        phase_chaos()
        return
    if sys.argv[1:] == ["--preemption"]:
        phase_preemption()
        return
    if sys.argv[1:] == ["--rl_soak"]:
        print(f"rl soak launches: {json.dumps(phase_rl_soak())}")
        return
    if sys.argv[1:2] == ["--failover"]:
        if sys.argv[2:]:  # held: start when the file appears
            deadline = time.monotonic() + 1200
            while not os.path.exists(sys.argv[2]) and time.monotonic() < deadline:
                time.sleep(0.1)
        phase_failover_soak()
        return
    become_subreaper()
    atexit.register(stop_descendants, 2.0)
    build = start_build()
    # the dashboard needs no kernel: it runs while nvcc builds them
    timed(phase_dashboard)
    timed(phase_card_and_build, build)
    flash_row = timed(phase_flash)
    bwd_rows = timed(phase_flash_backward)
    paged_row = timed(phase_paged)
    # the chaos soak needs no kernel and mostly waits: it runs beside the
    # model phases, after the kernels' timing phases
    join_chaos, _ = start_beside("chaos")
    flash_launches = timed(phase_forward)
    paged_launches, tps = timed(phase_serve)
    train_launches, step_ms, train_tps, train_losses = timed(phase_train)
    timed(phase_train_f32)
    par = timed(phase_parallel, step_ms, train_tps)
    trainer_run = timed(phase_trainer, train_losses)
    # before the elastic gang's node kill and its 2 s health timeout
    join_chaos()
    # the failover soak needs no kernel and mostly waits: its process starts
    # (its imports) now and idles through the elastic gang's node kill and
    # 2 s health timeout, then runs beside the phases up to the mixed fleet
    join_failover, go_failover = start_beside("failover", "failover soak", held=True)
    lib_launches = [trainer_run, timed(phase_elastic_train)]
    go_failover()
    lib_launches.append(timed(phase_tune))
    trainer_launches = {k: sum(x[k] for x in lib_launches) for k in ("fwd", "dq", "dkv")}
    wide_rows = timed(phase_wide_heads)
    llm = timed(phase_llm_engine)
    disagg = timed(phase_llm_disagg)
    serve_launches, chaos_launches = timed(phase_serving)
    join_failover()
    # the overload peak's controller ticks run on this process's host threads:
    # the mixed fleet runs with no child beside it
    mixed_launches = timed(phase_mixed_fleet)
    # the preemption scenarios need no kernel and mostly sleep, and the RL
    # soak mostly waits out its faults: both run beside the phases after them
    join_preemption, _ = start_beside("preemption")
    rl_launches = timed(phase_rl)
    join_rl_soak, _ = start_beside("rl_soak", "rl soak")
    timed(phase_rllib)
    data_launches = timed(phase_data)
    timed(phase_scheduler)
    timed(phase_runtime)
    timed(phase_cluster)
    timed(phase_sim)
    timed(phase_elasticity, ticks=1)  # bench.py's 8 ticks cut to 1 to keep the smoke in its time
    timed(phase_autoscaler)
    timed(phase_standby)
    timed(phase_dag)
    timed(phase_device_xfer)
    rl_soak = json.loads(re.search(r"^rl soak launches: (\{.*\})$", join_rl_soak(),
                                   re.M).group(1))
    join_preemption()
    timed(phase_processes)
    kernels = [
        dict(name="paged_attention_decode", route="cuda",
             source="ray_tpu_torch/csrc/paged_attention.cu",
             replaces="ray_tpu/ops/paged_attention.py:102",
             launches=paged_launches, **paged_row, wide_shape=wide_rows["paged"],
             serve_launches=serve_launches, chaos_launches=chaos_launches,
             rl_launches=rl_launches["paged"], mixed_fleet_launches=mixed_launches,
             rl_soak_launches=rl_soak["paged"]),
        dict(name="flash_attention_fwd", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:185",
             launches=flash_launches, **flash_row, wide_shape=wide_rows["fwd"],
             mesh_launches=par["fwd"], trainer_launches=trainer_launches["fwd"],
             rl_launches=rl_launches["fwd"], data_launches=data_launches["fwd"],
             rl_soak_launches=rl_soak["fwd"]),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:230",
             launches=train_launches["dq"], **bwd_rows["dq"], wide_shape=wide_rows["dq"],
             mesh_launches=par["dq"], trainer_launches=trainer_launches["dq"],
             rl_launches=rl_launches["dq"], data_launches=data_launches["dq"],
             rl_soak_launches=rl_soak["dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:247",
             launches=train_launches["dkv"], **bwd_rows["dkv"], wide_shape=wide_rows["dkv"],
             mesh_launches=par["dkv"], trainer_launches=trainer_launches["dkv"],
             rl_launches=rl_launches["dkv"], data_launches=data_launches["dkv"],
             rl_soak_launches=rl_soak["dkv"]),
    ]
    total = sum(v for k, v in PHASE_S.items() if k not in BESIDE)
    print(f"phase seconds: {json.dumps(PHASE_S)}; total {total:.1f} s (without "
          f"{', '.join(BESIDE)}, run beside the others; each <name>_wait is the wait for it)")
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
