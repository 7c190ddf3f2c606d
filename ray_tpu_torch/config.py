"""Typed configuration registry — every tunable in one place.

Port of ``ray_tpu/config.py``, copied: the scheduler's ``sched_platform``
defaults to ``cuda`` here, and ``xla_cache`` is gone (the port has no XLA).

Analog of the reference's RayConfig flag system
(Ray's src/ray/common/ray_config_def.h:18, ~400 RAY_CONFIG
declarations with env overrides): each knob is declared once with a type,
default, and doc line, and can be overridden by an environment variable
named ``RAY_TPU_<NAME>`` (upper-cased). Reads go through ``cfg.<name>``
and consult the environment live for most knobs; a few structural
constants (inline_object_max, sched_tick_s, sched_max_batch,
dag_buffer_bytes, dag_max_inflight) are bound once at module import, so
set those in the environment before importing ray_tpu (they shape wire
formats and pre-sized buffers).

Dump everything with ``python -m ray_tpu config``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


def _parse_bool(s: str) -> bool:
    return s.strip().lower() not in ("0", "false", "no", "off")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: lambda s: int(s, 0),
    float: float,
    str: str,
}


@dataclass(frozen=True)
class ConfigEntry:
    name: str
    type: type
    default: Any
    doc: str

    @property
    def env_var(self) -> str:
        return f"RAY_TPU_{self.name.upper()}"

    def current(self) -> Any:
        raw = os.environ.get(self.env_var)
        if raw is None:
            return self.default
        if self.type is bool and raw.strip() == "":
            # a SET-but-empty boolean var keeps the default (shell templates
            # leave FLAG= empty to mean "don't change it"); anything else
            # would silently flip opt-in flags like direct_trace on
            return self.default
        try:
            return _PARSERS[self.type](raw)
        except (ValueError, KeyError):
            import logging

            logging.getLogger("ray_tpu.config").warning(
                "ignoring invalid %s=%r (expected %s); using default %r",
                self.env_var,
                raw,
                self.type.__name__,
                self.default,
            )
            return self.default


_REGISTRY: Dict[str, ConfigEntry] = {}


def define(name: str, default: Any, doc: str, type_: Optional[type] = None):
    entry = ConfigEntry(name, type_ or type(default), default, doc)
    _REGISTRY[name] = entry
    return entry


def registry() -> Dict[str, ConfigEntry]:
    return dict(_REGISTRY)


class _Config:
    """Attribute access over the registry; env consulted on every read."""

    def __getattr__(self, name: str) -> Any:
        entry = _REGISTRY.get(name)
        if entry is None:
            raise AttributeError(f"unknown config knob {name!r}")
        return entry.current()

    def dump(self) -> list:
        out = []
        for e in sorted(_REGISTRY.values(), key=lambda x: x.name):
            raw = os.environ.get(e.env_var)
            out.append(
                {
                    "name": e.name,
                    "env": e.env_var,
                    "type": e.type.__name__,
                    "default": e.default,
                    "value": e.current(),
                    "source": "env" if raw is not None else "default",
                    "doc": e.doc,
                }
            )
        return out


cfg = _Config()

# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------
define("sched_tick_s", 0.002, "Head scheduler loop pause between rounds.")
define("sched_max_batch", 4096, "Max leases per scheduling kernel round.")
define(
    "device_scheduler",
    True,
    "Run the live scheduling programs on a torch device (vs NumPy golden).",
)
define(
    "sched_platform",
    "cuda",
    "torch device for the live scheduler programs (cuda keeps the cluster "
    "arrays on the card; cpu runs the same programs on the host).",
)
define(
    "sched_init_timeout_s",
    30.0,
    "Scheduler device bring-up budget at init(); the runtime raises past it.",
)
define(
    "sched_device_min_batch",
    0,
    "Batches smaller than this schedule on the host golden model even "
    "when the XLA device scheduler is up (per-dispatch overhead beats "
    "kernel gains for tiny rounds; 0 = always use the device kernels).",
)
define(
    "sched_pipeline",
    True,
    "Pipelined scheduling rounds: round N+1's kernel dispatches while "
    "round N's placements are still being read back (async host copy, "
    "double-buffered through the donated avail chain); grants fan out "
    "from a completion thread. Off: every round blocks on its own "
    "readback inside the scheduler loop (the pre-pipeline behavior).",
)
define(
    "sched_pipeline_depth",
    3,
    "Max scheduling rounds in flight (dispatched, readback pending) "
    "before submit blocks. Bounds host-mirror lag and grant latency; "
    "1 degenerates to the synchronous round with the completion thread "
    "still off the scheduler loop.",
)
define(
    "sched_prewarm",
    True,
    "Background-compile the scheduling kernel for the bucketed "
    "(batch, unique-shape) grid at first device sync (and again after "
    "node-capacity growth), so first-touch rounds stop paying "
    "multi-second jit compile spikes visible as sched_round_ms outliers.",
)
define(
    "sched_ring_slots",
    64,
    "Slots in the on-device parked-demand ring: resource shapes that "
    "failed placement stay resident on the scheduler device (one row "
    "per shape) and retry via a count-driven kernel without re-uploading "
    "demand matrices. 0 disables the ring (parked specs retry through "
    "the normal round path).",
)
define(
    "sched_unpark_device",
    True,
    "Estimate per-shape grantable slots for capacity-capped unparking "
    "on the scheduler device (one batched kernel over the resident "
    "availability arrays) instead of per-shape host NumPy scans.",
)
# --- multi-objective scoring weights (hybrid.ScoreWeights) ---
# (1, 0, 0, 0) recovers the single-objective kernel bit-for-bit; the
# extra terms are skipped at trace time, so the defaults cost nothing.
define(
    "sched_w_util",
    1.0,
    "Weight of the reference-compatible critical-utilization term in the "
    "multi-objective scheduling cost (quantized spread score).",
)
define(
    "sched_w_het",
    0.0,
    "Weight of the heterogeneity term (Gavel-style per-(shape, node-type)"
    " effective-throughput penalty from ClusterView.type_throughput).",
)
define(
    "sched_w_frag",
    0.0,
    "Weight of the fragmentation term (post-placement stranded-capacity "
    "estimate vs the round's largest demand shape): >0 packs small "
    "shapes onto already-broken nodes instead of stranding whole ones.",
)
define(
    "sched_w_starve",
    0.0,
    "Starvation discount of the soft het/frag terms: a shape parked "
    "w_starve-scaled wait-ages stops holding out for a well-scored node "
    "and takes any available one.",
)
define(
    "sched_w_locality",
    0.0,
    "Weight of the data-locality term in the multi-objective scheduling "
    "cost: a per-(shape, node) BONUS for nodes already holding the "
    "task's input-partition bytes (object-directory locations x seal "
    "sizes, uploaded with the demand rows), so shuffle reduce tasks "
    "land where their map partitions live. 0 (default) keeps round "
    "prep and the kernel program byte-identical to the pre-locality "
    "path; specs with different residency split into their own kernel "
    "slots when > 0.",
)
define(
    "sched_starve_rounds",
    32,
    "Park-retry rounds before a demand shape counts as STARVING: its "
    "normalized wait-age crosses 1.0, arming preemption nomination and "
    "maxing the starvation discount.",
)
define(
    "sched_preempt",
    True,
    "Preemption as a first-class scheduler action: a starving shape with "
    "zero capacity anywhere nominates its lowest-cost feasible node in "
    "the round kernel, and the head kills-and-requeues preemptable "
    "victims there (queued leases respill untouched; active worker "
    "leases revoke and spill; running retryable tasks may be killed — "
    "see sched_preempt_running). max_retries=0 victims that already "
    "started are NEVER preempted (at-most-once).",
)
define(
    "sched_preempt_running",
    True,
    "Allow preemption to force-kill a RUNNING task when its lease is "
    "retryable (attempt < max_retries); the kill requeues through the "
    "lineage machinery WITHOUT consuming a retry attempt. Off: only "
    "not-yet-running work and worker leases are preemptable.",
)
define(
    "sched_preempt_max_per_round",
    8,
    "Cap on victim leases preempted per scheduling round (a starvation "
    "storm must drain gradually, not mass-kill the cluster).",
)
define(
    "sched_preempt_cooldown_s",
    2.0,
    "Per-shape cooldown between preemption actions: the freed capacity "
    "needs agent report round-trips to become placeable, so re-preempting"
    " for the same starving shape every round would overshoot.",
)
# --- autoscaler on-device residual solve ---
define(
    "autoscaler_solve",
    True,
    "Solve the autoscaler's residual bin-pack as a fixed-iteration "
    "projected-gradient allocation over DeltaBinPacker's resident "
    "arrays (CvxCluster-style batched iterative solve, arxiv "
    "2605.01614) instead of the O(demands) first-fit scan. The host "
    "greedy remains the oracle and the automatic fallback.",
)
define(
    "autoscaler_solve_iters",
    24,
    "Fixed projected-gradient iteration count of the autoscaler solve "
    "(jit-prewarmed; more iterations sharpen the allocation but the "
    "exact extraction pass keeps any count correct).",
)
define(
    "autoscaler_solve_min_demands",
    64,
    "Demand batches smaller than this pack with the exact first-fit "
    "kernel (per-demand scan beats the solve's fixed overhead there).",
)
define(
    "spill_storage_uri",
    "",
    "External spill storage for the object plane (external_storage.py "
    "analog): empty = node-local spill dir; file:///path; memory://; "
    "s3://bucket/prefix (boto3 or an injected client).",
)
define(
    "streaming_window",
    128,
    "num_returns='streaming' backpressure: max items an executor seals "
    "ahead of the consumer's watermark before pausing (the reference's "
    "_generator_backpressure_num_objects analog).",
)
define(
    "stream_idle_gc_s",
    600.0,
    "Head-side GC: a finished stream untouched this long is dropped and "
    "its undelivered item holds released (abandoned-generator cleanup).",
)
define(
    "trace_tasks",
    True,
    "Mint a root trace context for every untraced task submission "
    "(distributed tracing on by default, reference tracing_helper.py "
    "semantics). Off: only traces opened explicitly via "
    "util.tracing.start_trace() propagate; untraced submissions pay "
    "zero minting cost on the hot path.",
)
define(
    "native_ledger",
    True,
    "Use the C++ fixed-point resource ledger (vs pure-Python fallback).",
)

# ---------------------------------------------------------------------------
# flight recorder: federation, spans, attribution, crash bundles
# ---------------------------------------------------------------------------
define(
    "trace_spans",
    True,
    "Record process-level duration spans (scheduler rounds, serve "
    "request lifecycle, socket-plane stripes, elastic reshape phases) "
    "into util.tracing.SPANS; merged into every Chrome-trace export and "
    "crash bundle. All sites are off the per-task hot path.",
)
define(
    "metrics_federation",
    True,
    "Ship typed registry deltas to the head (workers piggyback on the "
    "seal channel, agents on the coalesced head report); the head "
    "merges them into one node/role-labeled scrape body.",
)
define(
    "metrics_interval_s",
    2.0,
    "Registry-delta ship cadence for the metrics federation (workers "
    "and agents collect at most this often; idle registries ship "
    "nothing).",
)
define(
    "sched_explain",
    True,
    "Read back the per-term cost contributions (util/het/frag/locality "
    "+ starvation discount) of every winning placement from the round "
    "kernel and keep them queryable via QueryState explain_placement. "
    "Adds one f32[B,5] readback per round; placements are unchanged.",
)
define(
    "sched_explain_keep",
    4096,
    "Bounded count of per-task placement explanations retained on the "
    "head (oldest evicted first).",
)
define(
    "crash_bundles",
    True,
    "Dump a bounded flight-recorder bundle (recent task events, trace "
    "spans, a metrics snapshot, debug state) on chaos faults, "
    "retries-exhausted task failures, and head failover.",
)
define(
    "crash_bundle_dir",
    "",
    "Base directory for crash bundles (empty = <tmpdir>/ray_tpu_bundles); "
    "each process writes under a per-run subdirectory.",
)
define(
    "crash_bundle_window_s",
    60.0,
    "Crash bundles include only task events / spans from the last this "
    "many seconds.",
)
define(
    "crash_bundle_keep",
    8,
    "Max bundles kept per run directory (oldest rotated out).",
)
define(
    "crash_bundle_min_interval_s",
    5.0,
    "Throttle: at most one crash bundle per process per this interval "
    "(a failure storm must not turn the recorder into the outage).",
)

# ---------------------------------------------------------------------------
# cluster control plane
# ---------------------------------------------------------------------------
define("head_address", "", "Cluster head address for implicit ray_tpu.init().")
define(
    "report_period_s", 0.1, "Agent resource/health report period to the head."
)
define(
    "health_timeout_s",
    8.0,
    "Head marks a node dead after this long without a report. The"
    " reference's detection window is ~15-25s (health_check_period_ms x"
    " failure_threshold); 3s proved twitchy enough to falsely kill nodes"
    " mid-transfer-storm on a loaded 1-core host.",
)
define(
    "health_miss_threshold",
    3,
    "Consecutive missed health windows before the head marks a node dead "
    "(gcs_health_check_manager failure_threshold analog). The window is "
    "health_timeout_s / health_miss_threshold, so total detection latency "
    "stays ~health_timeout_s while a single wall-clock gap (GC pause, "
    "transfer storm on a loaded host) is no longer a death sentence.",
)
define(
    "orphan_timeout_s",
    120.0,
    "An agent that cannot reach any head for this long exits.",
)

# ---------------------------------------------------------------------------
# replicated control plane (warm-standby heads, WAL shipping, failover)
# ---------------------------------------------------------------------------
define(
    "head_shards",
    8,
    "Shard count of the head's owner-sharded directory/lease tables "
    "(object directory, task-lease table, peer-link table). Keys route "
    "by a stable hash, so lookups touch one shard and shipped-WAL "
    "replay applies shard groups conflict-free.",
)
define(
    "head_standbys",
    "",
    "Comma-separated warm-standby head addresses agents/clients walk "
    "(after the primary and any leader hint) when the head stops "
    "answering as leader.",
)
define(
    "head_health_timeout_s",
    2.0,
    "Standby-side leader death detection window: a standby declares the "
    "leader dead after head_miss_threshold consecutive missed probe "
    "windows of head_health_timeout_s / head_miss_threshold each, then "
    "promotes (epoch bump + listener bind).",
)
define(
    "head_miss_threshold",
    3,
    "Consecutive missed leader-probe windows before a warm standby "
    "declares the leader dead and promotes itself (same strike shape as "
    "the head's node health loop).",
)
define(
    "wal_ship_acked",
    False,
    "Acked WAL shipping: the leader's WAL flush waits (bounded by "
    "wal_ship_ack_timeout_s) until every live standby applied the "
    "flushed records. Off (default): shipping is asynchronous — a "
    "leader crash can lose the last in-flight batch, same window as "
    "unreplicated durability today.",
)
define(
    "wal_ship_ack_timeout_s",
    2.0,
    "Bound on one acked-shipping wait; a standby that cannot ack within "
    "it accrues strikes and is dropped from the ack quorum (it re-syncs "
    "when it returns).",
)
define(
    "wal_ship_ring",
    8192,
    "Replication ring capacity (records) on the leader: standbys whose "
    "ack fell further behind than the ring re-sync from a fresh "
    "snapshot instead of replaying records that no longer exist.",
)
define(
    "wal_ship_batch",
    512,
    "Max WAL records per shipped ReplWal batch.",
)
define(
    "revoke_redrive_ttl_s",
    120.0,
    "Pending-revoke WAL rows (lease returns / peer-link revokes queued "
    "but not yet delivered to their agent) older than this whose target "
    "node is gone are dropped by the sweep instead of re-driven forever.",
)

# ---------------------------------------------------------------------------
# rpc retry + circuit breaking (RetryableGrpcClient analog)
# ---------------------------------------------------------------------------
define(
    "rpc_backoff_cap_s",
    2.0,
    "Ceiling on any single RPC retry backoff sleep (decorrelated-jitter "
    "exponential backoff below the cap).",
)
define(
    "rpc_breaker_window_s",
    5.0,
    "A peer whose calls have failed at transport level for this long "
    "with no intervening success gets its circuit opened: calls fail "
    "fast and the node-unreachable callback fires into the health path "
    "(server_unavailable_timeout_seconds analog).",
)
define(
    "rpc_breaker_cooldown_s",
    1.0,
    "How long an open circuit stays open before one half-open probe "
    "call is allowed through; probe success closes it.",
)
define(
    "rpc_breaker_min_failures",
    3,
    "Minimum transport failures (with no intervening success) before the "
    "breaker may open — the window span alone must not let two isolated "
    "large-transfer timeouts read as a dead peer.",
)
define(
    "chaos_seed",
    0,
    "Seed for the deterministic chaos orchestrator (ray_tpu.chaos). The "
    "same seed replays the exact same fault schedule; soak failures "
    "print the seed so they reproduce exactly.",
)

define(
    "rpc_chaos",
    "",
    "Message-level failure injection, e.g. "
    "'ExecuteLeaseBatch:drop=0.1;PushTaskBatch:delay_ms=20' "
    "(rpc_chaos.h analog; parsed once per process).",
)

# ---------------------------------------------------------------------------
# object plane
# ---------------------------------------------------------------------------
define(
    "inline_object_max",
    100 * 1024,
    "Values at or below this many serialized bytes travel inline in "
    "control messages instead of the shared-memory store.",
)
define("native_store", True, "Use the C++ shared-memory object store.")
define(
    "store_bytes",
    1 << 28,
    "Default shared-memory arena capacity per node (bytes).",
)
define("refcount_debug", False, "Record per-ref count history (diagnostics).")
define(
    "runtime_env_idle_gc_s",
    300.0,
    "Reap pip runtime-env workers idle longer than this and GC "
    "unreferenced env directories.",
)
define(
    "max_concurrent_pushes",
    4,
    "Outbound object-transfer slots per agent (push_manager.h in-flight "
    "cap analog); requests are admitted GET > WAIT > TASK_ARGS.",
)
define(
    "max_concurrent_pulls",
    4,
    "Bound on concurrent inbound peer object transfers per node "
    "(pull_manager admission; same-object pulls coalesce regardless).",
)
define(
    "transfer_chunk_bytes",
    4 << 20,
    "Peer object transfers larger than this pull in chunks of this size "
    "(object_manager chunked-push analog) instead of one monolithic "
    "FetchObject reply; a dropped chunk retries alone.",
)
define(
    "transfer_max_inflight_chunks",
    4,
    "Concurrent in-flight chunks per chunked peer pull (push_manager "
    "in-flight cap analog, per transfer).",
)
define(
    "native_net",
    True,
    "Cross-node zero-copy transport: direct worker<->worker data sockets "
    "(native/net.cc sendmsg/recvmsg scatter-gather over RTP5 frames, "
    "head-granted peer connection leases, striping for large objects). "
    "Off: every cross-node transfer rides the chunked-RPC fallback "
    "(object_plane.fetch_chunked). Read live — flip mid-process for "
    "A/B; in-flight transfers finish on their current path.",
)
define(
    "net_stripe_bytes",
    64 << 20,
    "Stripe size for socket peer transfers: objects larger than one "
    "stripe split across parallel connections with per-stripe offsets; "
    "a severed connection re-fetches only its lost stripes (resume).",
)
define(
    "net_stripe_conns",
    4,
    "Max parallel data connections one striped transfer fans out over "
    "(>1 GB objects ride N sockets; single-stripe objects use one).",
)
define(
    "net_inflight_cap_bytes",
    256 << 20,
    "Cap on in-flight (requested, not yet landed) bytes per striped "
    "transfer — backpressure into the receiving arena.",
)
define(
    "net_fetch_inflight_cap_bytes",
    512 << 20,
    "Cap on TOTAL in-flight socket-fetch bytes across all concurrent "
    "peer pulls in one process (a shuffle reduce resolving many "
    "partitions at once must not stage more than this into the arena "
    "before the spill path can drain it). New fetches park until "
    "running ones land; a single transfer larger than the cap still "
    "proceeds alone. 0 disables the gate.",
)
define(
    "device_plane",
    True,
    "Device-direct data plane: jax.Array leaves seal as device frames "
    "(dlpack/__array__ export riding RTP5 out-of-band buffers — on the "
    "CPU backend the export aliases the device buffer, zero-copy) and "
    "land via device_put straight from the arriving arena view / socket "
    "landing zone, skipping the host-bounce copy on both sides. Off: "
    "jax leaves ride cloudpickle's stock reducer (full host copy in the "
    "pickle pass) and land host-side — the pre-device-plane behaviour. "
    "Read live; sealed device frames remain loadable either way.",
)
define(
    "device_pump_min_bytes",
    8 << 20,
    "Device arrays at or above this size on a non-host-aliasing backend "
    "read out through the chunked copy_to_host_async D2H pump "
    "(overlapping readout with the arena gather / socket send) instead "
    "of one monolithic export.",
)
define(
    "device_pump_chunk_bytes",
    4 << 20,
    "Chunk size of the D2H pump (device_pump_min_bytes); each chunk is "
    "one copy_to_host_async window.",
)
define(
    "device_pump_depth",
    4,
    "Max in-flight async D2H chunks the pump keeps ahead of its "
    "consumer.",
)
define(
    "device_land_chunk_bytes",
    4 << 20,
    "Device landing zone H2D chunk size: during a striped socket fetch "
    "with land=device, each completed chunk of the contiguous prefix is "
    "device_put in flight, overlapping H2D with the remaining recv.",
)
define(
    "device_land_always",
    False,
    "Force the device landing zone even on host-aliasing backends (CPU) "
    "where the overlap hides nothing — test / A-B hook; production "
    "leaves this off and the zone activates only when a real H2D hop "
    "exists.",
)
define(
    "peer_link_ttl_s",
    10.0,
    "Renewal horizon of a granted peer data link: agents piggyback "
    "renewals for recently-used links on their seal reports, and the "
    "head's sweep revokes links not renewed within 3x this (dead-holder "
    "safety net; an actively-renewed link never expires).",
)
define(
    "peer_link_idle_ttl_s",
    60.0,
    "Requester-side idle TTL: a cached peer link with no transfer for "
    "this long closes its pooled connections and returns the lease to "
    "the head.",
)
define(
    "worker_shm_reads",
    True,
    "Workers resolve same-node objects as zero-copy read-only views over "
    "the shared-memory arena. Off: every read round-trips the agent as "
    "pickled bytes (debug / perf-comparison fallback).",
)
define(
    "memory_monitor_interval_s",
    1.0,
    "Agent memory-pressure check period; 0 disables OOM killing.",
)
define(
    "memory_usage_threshold",
    0.95,
    "Host memory usage fraction above which the agent kills the newest "
    "plain task's worker to relieve pressure.",
)

# ---------------------------------------------------------------------------
# worker lifecycle (fork-server + warm pool)
# ---------------------------------------------------------------------------
define(
    "fork_server",
    True,
    "Fork new workers from a per-agent zygote process that imported "
    "ray_tpu (and jax, when JAX_PLATFORMS is set) once, instead of a "
    "cold interpreter spawn per worker (reference worker_pool.cc "
    "prestart + Python fork-server semantics). Falls back to cold "
    "spawn automatically when fork is unavailable, the zygote dies, or "
    "a pip/conda runtime env demands its own interpreter.",
)
define(
    "zygote_ready_timeout_s",
    30.0,
    "How long a fork request waits for the zygote's one-time import "
    "warmup before falling back to cold spawn for good.",
)
define(
    "prestart_max_workers",
    16,
    "Cap on extra workers an agent prestarts above num_workers in "
    "response to head PrestartWorkers hints (worker_pool.cc "
    "PrestartWorkers analog).",
)
define(
    "actor_worker_reuse",
    True,
    "Return a worker whose actor exited cleanly to the idle pool after "
    "a scrub (module/env/cwd reset) instead of killing it. Reuse is "
    "denied across pip/conda or persisted runtime envs, and when the "
    "scrub cannot restore pristine state (heavyweight modules imported "
    "by actor code) — those workers are killed and re-forked.",
)

# ---------------------------------------------------------------------------
# direct actor calls
# ---------------------------------------------------------------------------
define(
    "direct_actor_calls",
    True,
    "Submit actor methods caller->worker directly, head off the hot path.",
)
define(
    "direct_inline_wait_s",
    0.005,
    "Worker lingers this long so fast results ride the accept reply.",
)
define(
    "direct_wait_fallback_s",
    10.0,
    "Getter stops trusting the direct result push after this long and "
    "resolves through the head directory.",
)
define(
    "direct_results_cap",
    16384,
    "Driver-side FIFO bound on cached direct-call / leased-task "
    "results. Evicting an owner-held (deferred-seal) entry whose ref is "
    "still live costs a PutObject upload to the head, so the cap should "
    "sit above a driver's typical in-flight ref count — a 10k-task "
    "submit-then-get wave over a 4096 cap paid ~6k serial uploads.",
)
define("direct_trace", False, "Stamp direct-call results with timing marks.")
define(
    "direct_deferred_seals",
    True,
    "Owner-based object bookkeeping for direct actor calls (the "
    "reference's ownership model): a small result delivered to its "
    "caller does NOT seal to the head — the caller holds value + seal "
    "and uploads to the head only when the ref is shared into another "
    "submission or evicted from the local cache. Cuts the per-call "
    "worker->agent->head seal chain off the hot path; a failed result "
    "push falls back to worker-side sealing.",
)

# ---------------------------------------------------------------------------
# task leases (owner-cached direct task dispatch)
# ---------------------------------------------------------------------------
define(
    "task_leases",
    True,
    "Lease-cached direct task dispatch: the head grants owners cacheable "
    "worker leases per task shape (fn hash x resources), and same-shape "
    "tasks stream caller->worker with no head hop (the reference's "
    "local_lease_manager worker leases). Off: every task rides the "
    "per-task head-scheduled path.",
)
define(
    "task_lease_ttl_s",
    5.0,
    "Idle TTL of a cached worker lease: the owner returns a lease this "
    "long after its queue drained; the head's expiry sweep revokes "
    "leases not renewed within 3x this (dead-owner safety net).",
)
define(
    "task_lease_max_inflight",
    64,
    "Tasks in flight (sent, result pending) per cached worker lease. "
    "This is PIPELINE depth, not parallelism — the leased worker "
    "executes one task at a time against the lease's single resource "
    "allocation; parallelism comes from holding more leases.",
)
define(
    "task_lease_max_per_shape",
    8,
    "Max concurrent worker leases one owner holds per task shape; the "
    "cache grows toward this while its queues stay deep.",
)
define(
    "task_lease_stall_s",
    1.0,
    "A lease with results owed but none arriving for this long recalls "
    "its queued (not-yet-running) tasks from the worker and spills them "
    "back to head scheduling — a head-of-line task blocked on other "
    "tasks' results (rendezvous peers) delays followers by ~this "
    "instead of deadlocking the lease.",
)

# ---------------------------------------------------------------------------
# owner liveness + lineage reconstruction + epoch fencing (robustness)
# ---------------------------------------------------------------------------
define(
    "owner_liveness",
    True,
    "Owner fate-sharing: clients heartbeat a session lease to the head "
    "(riding the pipelined ClientBatch); an owner that misses "
    "owner_miss_threshold consecutive windows of owner_lease_ttl_s is "
    "declared dead and fully reaped — non-detached actors killed, cached "
    "worker leases revoked immediately, queued/in-flight tasks cancelled, "
    "and unproduced objects failed with OwnerDiedError. Off: crashed "
    "owners leak actors until explicit kill and leases until 3x TTL.",
)
define(
    "owner_lease_ttl_s",
    10.0,
    "Owner session heartbeat window; clients beat at half this period. "
    "Death is declared after owner_miss_threshold consecutive missed "
    "windows (total detection ~ttl x threshold).",
)
define(
    "owner_miss_threshold",
    3,
    "Consecutive missed owner heartbeat windows before the head declares "
    "the owner dead and reaps its actors/leases/objects.",
)
define(
    "owner_lineage_cap_mb",
    64,
    "Byte budget (MiB) for the owner-side lineage cache: leased direct-"
    "dispatch tasks never register a spec with the head, so the OWNER "
    "retains each task's payload keyed by its return ref and resubmits "
    "through head scheduling when the head reports the object lost "
    "without re-executable lineage (the reference's ownership model — "
    "lineage lives with the owner). Oldest entries evict past the cap; "
    "an evicted object's loss is then permanent (ObjectLostError).",
)
define(
    "reconstruction_max_depth",
    8,
    "Bound on the recursive lineage reconstruction walk: an object whose "
    "rebuild requires re-executing more than this many generations of "
    "lost inputs fails with a reconstruction-depth error instead of "
    "walking an unbounded chain.",
)
define(
    "epoch_fencing",
    True,
    "Epoch-fenced control plane: head restarts bump a persisted cluster "
    "epoch; agents and owners stamp their control RPCs with the epoch "
    "they joined under, and stale-epoch traffic is rejected with a "
    "non-retryable RpcStaleEpochError (the sender re-registers to adopt "
    "the new epoch). Off: a partitioned pre-restart agent's reports can "
    "land on a rebuilt head unfenced.",
)

# ---------------------------------------------------------------------------
# serving plane (ray_tpu.serve router/admission/prefix-cache/autoscaler)
# ---------------------------------------------------------------------------
define(
    "serve_push_streams",
    True,
    "Stream token deltas from replicas straight to the ingress process's "
    "push sink (direct worker->ingress RPC, zero head involvement, no "
    "polling). Off: cross-host streams fall back to the legacy polling "
    "_StreamRelayActor bridge.",
)
define(
    "serve_shm_streams",
    True,
    "Prefer the same-host shm ring Channel for token streams when a "
    "same-host replica exists (zero-RPC transport). Off: every stream "
    "rides the push sink — mainly a test lever to force the push path.",
)
define(
    "serve_stream_buffer",
    4096,
    "Per-stream bound on buffered undelivered deltas at the ingress "
    "push sink; writers past it are rejected (backpressure is "
    "depth-based and writer-side, like the relay actor's contract).",
)
define(
    "serve_stream_failover",
    1,
    "Max mid-stream replica failovers per request: on replica death a "
    "resumable deployment is re-dispatched elsewhere with "
    "resume_from=<delivered count> so acked deltas are neither repeated "
    "nor lost. 0 disables failover (streams error on replica death).",
)
define(
    "serve_admission_qps",
    0.0,
    "Token-bucket sustained admission rate for the serving router "
    "(requests/s); 0 = unlimited (depth shedding still applies).",
)
define(
    "serve_admission_burst",
    32.0,
    "Token-bucket burst allowance above the sustained admission rate.",
)
define(
    "serve_admission_max_inflight",
    256,
    "Admitted-but-unfinished request bound at the router; arrivals past "
    "it queue in the WFQ waiting room or shed with Overloaded.",
)
define(
    "serve_admission_wait_cap",
    128,
    "Bound on the admission waiting room (all tenants); past it "
    "arrivals shed immediately with reason=queue_full.",
)
define(
    "serve_admission_timeout_s",
    2.0,
    "Max time one arrival waits in the WFQ room before shedding with "
    "reason=timeout.",
)
define(
    "serve_prefix_cache",
    True,
    "Cross-replica prefix/KV cache in the node's shm arena: page-aligned "
    "prompt prefixes hit as read-only view pins and skip prefill "
    "compute. Off: every prompt prefills from scratch.",
)
define(
    "serve_prefix_cache_bytes",
    64 << 20,
    "Per-inserting-process byte budget for prefix KV entries in the "
    "arena (oldest own entries evict first; arena-full puts evict then "
    "retry once).",
)
define(
    "serve_report_period_s",
    1.0,
    "Router -> head serve-state report period (powers QueryState('serve')"
    "); control-plane cadence, never per-request.",
)
define(
    "serve_autoscale_interval_s",
    0.5,
    "SLO autoscaler control-loop tick.",
)
define(
    "serve_routers",
    1,
    "Ingress router replicas per deployment (the router fleet). Tenants "
    "map to routers by consistent hash; each router runs its own "
    "admission shard and push sink. 1 = the single-router layout.",
)
define(
    "serve_ring_vnodes",
    64,
    "Virtual nodes per router on the tenant->router consistent-hash "
    "ring (higher = smoother ranges, slower ring rebuild).",
)
define(
    "serve_budget_reconcile_s",
    0.25,
    "Router-fleet budget reconcile period: each router reports per-"
    "tenant usage/demand and receives its share of the global admission "
    "rate (and flushes stream delivered-count checkpoints).",
)
define(
    "serve_stream_ckpt_every",
    8,
    "Delivered-count checkpoint granularity for fleet streams: a "
    "stream's row is re-checkpointed to the head once it advanced this "
    "many deltas since the last flush (finished streams always flush).",
)
define(
    "serve_drain_timeout_s",
    30.0,
    "Graceful-drain budget for a retiring replica: in-flight streams "
    "finish within this before the replica is killed anyway.",
)
define(
    "serve_slo_ttft_ms",
    0.0,
    "Target p50 time-to-first-token for SLO autoscaling (ms); sustained "
    "violation scales replicas up. 0 disables the TTFT term (queue-"
    "depth scaling still applies).",
)
define(
    "serve_slo_queue_per_replica",
    4.0,
    "Target admitted-in-flight requests per replica: sustained excess "
    "scales up, sustained idleness (below half) drains one replica.",
)
define(
    "serve_swap_drain_deadline_s",
    30.0,
    "Deadline for swap_params' drain of in-flight sequences: past it, "
    "still-active slots are force-evicted (their output truncated at "
    "the tokens generated so far) and parked submits are rejected with "
    "Overloaded(reason='weights_swap') instead of hanging. 0 restores "
    "the legacy unbounded drain.",
)

# ---------------------------------------------------------------------------
# online-RL loop
# ---------------------------------------------------------------------------
define(
    "rl_staleness_window",
    2,
    "Off-policy staleness window K for the online-RL loop: trajectories "
    "stamped with a weights epoch older than committed-K are dropped "
    "and counted (dropped_stale), never silently trained on.",
)
define(
    "rl_publish_interval_steps",
    4,
    "Trainer steps between weight publishes in the online-RL loop: "
    "every interval the trainer seals params into the object plane and "
    "runs the two-phase (seal->commit) weights-epoch publish.",
)

# ---------------------------------------------------------------------------
# compiled DAG
# ---------------------------------------------------------------------------
define(
    "dag_buffer_bytes",
    1 << 22,
    "Default per-edge shm ring capacity for compiled DAGs.",
)
define(
    "dag_max_inflight",
    16,
    "Default max concurrently admitted executions per compiled DAG.",
)

# ---------------------------------------------------------------------------
# execution-plane hot path (fused event loop + AOT actor pipelines)
# ---------------------------------------------------------------------------
define(
    "hotpath_senders",
    8,
    "Sender-pool size for the owner-side fused submit/result event loop "
    "(blocking lease-window / direct-push RPCs run here; the loop thread "
    "itself never blocks on the wire).",
)
define(
    "native_wire",
    True,
    "Use the C framing hot path (native/wire.cc) for the RTP5 pickle-5 "
    "wire format. Read ONCE at serialization import; set "
    "RAY_TPU_NATIVE_WIRE=0 before the first ray_tpu import to force the "
    "pure-Python framing fallback.",
)
define(
    "pipeline_buffer_bytes",
    1 << 22,
    "Per-stage shm ring capacity for AOT-compiled actor pipelines "
    "(compile_pipeline).",
)
define(
    "pipeline_max_inflight",
    64,
    "Max concurrently admitted executions per compiled actor pipeline "
    "(the slot-multiplexed window; backpressure beyond it).",
)
define(
    "pipeline_stall_s",
    5.0,
    "Per-owed-item quiet budget (capped at 10x) before a compiled "
    "pipeline presumes a stage worker dead and spills every unresolved "
    "execution back to the eager task path.",
)

# ---------------------------------------------------------------------------
# data (streaming executor)
# ---------------------------------------------------------------------------
define(
    "data_inflight_budget_bytes",
    256 << 20,
    "Per-stage in-flight byte budget for the Data streaming executor "
    "(resource_manager.py analog); block bytes are estimated from the "
    "first materialized block of each stage.",
)
define(
    "data_actor_idle_reap_s",
    10.0,
    "Actor-pool map workers idle longer than this (above min_size) are "
    "reaped by the streaming executor.",
)
define(
    "data_max_tasks_in_flight_per_actor",
    2,
    "Default per-actor in-flight cap for actor-pool map operators "
    "(pipelines the next block behind the running one).",
)
define(
    "data_vector_shuffle",
    True,
    "Vectorized shuffle partitioning for numeric blocks (hash/bincount "
    "+ stable-argsort gather instead of per-row list appends; ndarray "
    "blocks keep their partitions as buffer-backed arrays so the "
    "pickle-5 frames scatter-write straight into the shm arena). Off: "
    "the generic row loop, kept as the fallback for non-numeric keys "
    "and as the bench baseline.",
)
define(
    "data_shuffle_eager_free",
    True,
    "Free each shuffle partition's map refs as its reduce task seals "
    "(_flush_frees-style batches) instead of retaining every "
    "map-partition ref until the whole reduce stage completes — bounds "
    "arena fill by in-flight reduces, not dataset size. Freed "
    "partitions are no longer available to re-reconstruct an "
    "ALREADY-SEALED reduce output (same trade as the streaming "
    "executor's eager intermediate frees).",
)
define(
    "data_prefetch_batches",
    2,
    "Default prefetch depth (in blocks) of streaming dataset ingest: "
    "iter_batches pulls this many upcoming blocks over the object "
    "plane concurrently with the consumer's step, so a training loop "
    "overlaps shuffle tail latency instead of stalling per block. Used "
    "by train dataset shards; Dataset.iter_batches defaults to 0 "
    "(off) unless prefetch_batches is passed.",
)
define(
    "elastic_seal_interval_steps",
    10,
    "Elastic training: every N completed steps each rank seals its "
    "param/optimizer state shard into the shm object plane (arena-"
    "direct pickle-5 frames) as the checkpoint-free recovery point for "
    "ranks that later die with their node. 0 disables periodic seals "
    "(break-time seals still happen).",
)
define(
    "elastic_buddy_replicate",
    True,
    "Elastic training: after a periodic state seal, the rank's buddy "
    "(next rank, usually another node) pulls the sealed object through "
    "its agent so the object directory holds a second arena copy — a "
    "single node death can never lose a state shard. Rides the "
    "socket plane like any located pull.",
)
define(
    "elastic_grow_poll_s",
    1.0,
    "Elastic training: driver-side capacity poll period. When the gang "
    "runs below its target world size and the cluster again advertises "
    "enough free capacity, the driver fences the gang and grows the "
    "mesh back.",
)
define(
    "elastic_hub_timeout_s",
    60.0,
    "Elastic training: per-collective rendezvous timeout at the gang "
    "hub. A rank parked past this raises and treats the op as revoked "
    "(the gang-epoch protocol decides whether it really was).",
)
define(
    "elastic_place_wait_s",
    15.0,
    "Elastic training: per-attempt placement-group wait when placing a "
    "gang generation. Short on purpose — an over-optimistic world size "
    "(e.g. the head has not yet declared a corpse dead) must fail fast "
    "into the shrink-to-what-fits retry path instead of parking the "
    "whole gang.",
)
define(
    "gang_sync_max_wait_s",
    20.0,
    "Head-side cap on one GangSync long-poll window; drivers re-arm "
    "the poll, so detection latency is governed by the health loop, "
    "not this cap.",
)
define(
    "elastic_controller",
    False,
    "Unified elasticity plane: one head-resident controller "
    "tick folds serve pressure, gang grow-back wants, and parked task "
    "demand into a single weighted demand matrix and runs one batched "
    "device solve driving provision/retire, serve capacity hints, and "
    "drain-ahead migration. OFF by default: the three legacy loops "
    "(autoscaler tick, serve SLO tick, elastic grow probe) run "
    "bit-for-bit unchanged.",
)
define(
    "elastic_tick_s",
    1.0,
    "Elasticity controller tick period: one snapshot + one device "
    "solve + actuation per tick.",
)
define(
    "elastic_w_serve",
    3.0,
    "Priority weight of SERVE demand rows (per-tenant replica "
    "pressure) in the unified elasticity solve. Higher-weighted "
    "classes take the waterfall extraction first, so they hold first "
    "claim on every node's capacity.",
)
define(
    "elastic_w_gang",
    2.0,
    "Priority weight of GANG demand rows (grow-back deficits) in the "
    "unified elasticity solve.",
)
define(
    "elastic_w_task",
    1.0,
    "Priority weight of TASK demand rows (parked/deferred queue "
    "shapes) in the unified elasticity solve.",
)
define(
    "elastic_provision_max",
    4,
    "Max nodes the elasticity controller will provision per tick; "
    "also the number of simulated-provisionable node rows appended to "
    "the solve, so the solver can only justify what the provider is "
    "allowed to create.",
)
define(
    "elastic_node_cpus",
    2.0,
    "CPU resources of one hypothetical provisionable node when no "
    "provider node_template is attached.",
    float,
)
define(
    "elastic_min_nodes",
    1,
    "Retirement floor: the elasticity controller never drains the "
    "fleet below this many alive nodes.",
)
define(
    "elastic_idle_retire_s",
    30.0,
    "A node must be solver-idle (zero demand placed on it) AND "
    "lease-idle for this long before it becomes a retirement "
    "candidate.",
)
define(
    "elastic_retire_max",
    1,
    "Max nodes entering drain per controller tick — retirement is "
    "deliberately slower than provisioning so a demand blip cannot "
    "flap the fleet.",
)
define(
    "elastic_drain_deadline_s",
    20.0,
    "Drain-ahead deadline: a retiring node gets this long for its "
    "migrated work to land elsewhere before the provider terminates "
    "it regardless.",
)
