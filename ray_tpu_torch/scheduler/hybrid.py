"""Batched hybrid scheduling policy as torch programs.

Port of ``ray_tpu/scheduler/hybrid.py``. Every program there is ``jnp``
code under ``jax.jit``; here each is the same sequence of tensor ops, run
eagerly on the tensors' device (``cuda`` unless the caller passes
``device="cpu"``). ``lax.scan`` and ``fori_loop`` become Python loops over
tensor ops, and no program reads a value back to the host, so a round is
dispatched to the card without a sync.

What the reference's docstring says of the policy holds here: the
fidelity kernel ``hybrid_schedule_batch``, the throughput mode
``hybrid_schedule_rounds`` and the shape-grouped waterfall
``hybrid_schedule_shapes_multi_impl`` with its multi-objective cost
(util, het, frag, locality, starve; ``weights=(1, 0, 0, 0, 0)`` emits no
extra ops), preemption nomination, and the parked-demand ring.

Parity with the JAX kernels (``tests/test_torch_scheduler_*.py``):

- sorts are stable (``torch.argsort(..., stable=True)``), and
  ``lax.top_k(-cost, k)`` is a stable ascending argsort of ``cost`` cut to
  ``k``, so ties go to the lower node index as they do in XLA;
- random draws are ``_jaxrng``'s bit-exact threefry (keys, uniforms,
  ``randint``);
- sums over the resource axis are column-ordered (``_colsum``), as XLA's
  CPU reduction is; cumulative sums take XLA's CPU order (``_cumsum``:
  sequential within blocks of 16, the blocks' totals scanned the same way);
  sums over the node axis use one fixed pairwise tree (``_tree_sum``), so
  the card and the CPU give the same bits;
- division is by tensors only: ``tensor / python_float`` on CUDA multiplies
  by the reciprocal;
- every op is its own kernel, so no product is fused into an FMA. XLA's CPU
  compiler does fuse some (``a - c * d``); where the inputs are multiples of
  1/64 both give the same bits, elsewhere ``avail_out`` may differ by an ulp.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _jaxrng
from .._device import resolve_device
from .resources import CRITICAL_COLUMNS, GPU, TPU

# Comparison tolerance for float32 resource arithmetic. Quantities are
# quantized at 1e-4 (FP_SCALE) host-side; this absorbs f32 rounding only.
_EPS = 1e-5

# Padding demand magnitude (device.py _BIG): pad rows carry this in every
# column so they never place; kernels detect them to mask pads out of the
# fragmentation reference shape.
_BIG_PAD = 1e18

ACCEL_COLUMNS = (GPU, TPU)

_INF = float("inf")


class HybridConfig(NamedTuple):
    """Static policy knobs (reference defaults from ray_config_def.h:198-209)."""

    spread_threshold: float = 0.5
    top_k_fraction: float = 0.2
    top_k_absolute: int = 1
    avoid_accel_nodes: bool = True
    require_available: bool = False


class BatchResult(NamedTuple):
    node: torch.Tensor       # int32[B] chosen node row, -1 = infeasible everywhere
    available: torch.Tensor  # bool[B] chosen node had the resources now (granted)
    avail_out: torch.Tensor  # float32[N,R] availability after grants


class ScoreWeights(NamedTuple):
    """Multi-objective scoring weights (cfg sched_w_util/het/frag/starve/
    locality). ``(1, 0, 0, 0, 0)`` recovers the single-objective program
    exactly: the extra terms are skipped, not multiplied by zero."""

    util: float = 1.0
    het: float = 0.0
    frag: float = 0.0
    starve: float = 0.0
    locality: float = 0.0


#: One-sided quantum of the waterfall kernels' utilization score (see the
#: reference): scores floor to 1/16 buckets and a per-node uniform jitter
#: in [0, 1) picks uniformly inside a bucket.
QUANTIZE_STEPS = 16.0

#: ``ShapesResult.terms`` column order.
TERM_NAMES = ("util", "het", "frag", "locality", "starve_discount")


# ---------------------------------------------------------------------------
# device-independent arithmetic
# ---------------------------------------------------------------------------


def _device_of(device, *xs) -> torch.device:
    """The program's device: ``device`` if given, else the first tensor
    argument's, else ``cuda`` (raises without CUDA)."""
    if device is not None:
        return resolve_device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(None)


def _t(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (tensor, array or scalar) as a ``dtype`` tensor on ``dev``; a
    host array is copied without waiting on the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype, non_blocking=True)
    t = torch.as_tensor(np.asarray(x), dtype=dtype)
    return t.to(dev, non_blocking=True)


def _seed_int(seed) -> int:
    if isinstance(seed, torch.Tensor):
        raise TypeError("seed must be a host integer (a device seed would need a readback)")
    return int(seed) & 0xFFFFFFFF


def _colsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (resource) axis in column order: XLA's CPU order
    for a short reduction, and the same bits on every device."""
    s = x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c]
    return s


def _rowsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis, row after row (short axes only)."""
    s = x[0]
    for i in range(1, x.shape[0]):
        s = s + x[i]
    return s


def _tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` by one fixed pairwise tree (zero-padded to a power
    of two, halves added elementwise): the same bits on the card and the
    CPU, whatever their reduction kernels do. Exact, like any order, for
    integer-valued f32 below 2**24."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    p = 1
    while p < n:
        p *= 2
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


_SCAN_BLOCK = 16


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the first axis in the order XLA's CPU
    compiler gives ``jnp.cumsum``: sequential within blocks of 16, each
    block offset by the scanned (the same way) totals of the blocks before
    it. Bit-identical to JAX on any f32 input, and the same on every device
    (elementwise adds only)."""
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        out = x.clone()
        for i in range(1, n):
            out[i] = out[i - 1] + x[i]
        return out
    pad = (-n) % _SCAN_BLOCK
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    blocks = x.reshape((-1, _SCAN_BLOCK) + tuple(x.shape[1:])).clone()
    for i in range(1, _SCAN_BLOCK):
        blocks[:, i] = blocks[:, i - 1] + blocks[:, i]
    carry = _cumsum(blocks[:, -1])
    blocks[1:] = carry[:-1].unsqueeze(1) + blocks[1:]
    return blocks.reshape((-1,) + tuple(x.shape[1:]))[:n]


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 saturating, as XLA converts (torch leaves an
    out-of-range conversion undefined)."""
    x = x.clamp(min=-2147483648.0, max=2147483648.0)
    return x.to(torch.int64).clamp(max=2147483647).to(torch.int32)


def _take_cols(x: torch.Tensor, cols) -> torch.Tensor:
    """``x[..., cols]`` with the indices clamped to the last axis, as XLA
    clamps an out-of-range gather (a view narrower than the predefined
    columns reads its last column again). A contiguous run is a slice: an
    index list would be copied to the device, and that copy waits on it."""
    last = x.shape[-1] - 1
    cols = [min(c, last) for c in cols]
    if cols == list(range(cols[0], cols[0] + len(cols))):
        return x[..., cols[0]: cols[0] + len(cols)]
    return x[..., cols]


def _stable_argsort(x: torch.Tensor, descending: bool = False) -> torch.Tensor:
    return torch.argsort(x, dim=-1, stable=True, descending=descending)


# ---------------------------------------------------------------------------
# shared scoring helpers
# ---------------------------------------------------------------------------


def quantize_score(score: torch.Tensor) -> torch.Tensor:
    """Bucketized utilization score shared by the shapes path, the ring
    path, and the multi-objective cost."""
    return torch.floor(score * QUANTIZE_STEPS)


def _critical_score(totals: torch.Tensor, avail: torch.Tensor, threshold: float) -> torch.Tensor:
    """float32[N] spread-threshold-zeroed critical resource utilization."""
    t = _take_cols(totals, CRITICAL_COLUMNS)
    a = _take_cols(avail, CRITICAL_COLUMNS)
    pos = t > 0
    util = torch.where(pos, 1.0 - a / torch.where(pos, t, torch.ones_like(t)), torch.zeros_like(t))
    score = util.amax(dim=1)
    return torch.where(score < threshold, torch.zeros_like(score), score)


def _shape_capacity(totals, avail_run, alive, d):
    """(cap f32[N], has_demand bool[], feas bool[N]): how many requests of
    shape ``d`` each node can absorb right now (inf for a zero-demand
    shape on a feasible node; 0 on dead/infeasible nodes), plus the
    totals-feasibility mask. The ONE definition of per-node shape
    capacity."""
    feas = alive & torch.all(totals >= d[None, :] - _EPS, dim=1)
    demanded = d > 0
    ratio = torch.where(
        demanded[None, :],
        torch.floor((avail_run + _EPS) / torch.where(demanded, d, torch.ones_like(d))[None, :]),
        torch.full_like(avail_run, _INF),
    )
    cap = ratio.amin(dim=1)
    has_demand = torch.any(demanded)
    cap = torch.where(has_demand, cap, torch.full_like(cap, _INF))
    cap = torch.where(feas, torch.clamp(cap, min=0.0), torch.zeros_like(cap))
    return cap, has_demand, feas


def _het_penalty(d, ntypes, thr):
    """f32[N] heterogeneity penalty in [0, 1]: 1 - (this node type's
    effective throughput for the shape) / (the best type's). ``thr @ d``
    is a column-ordered sum of products (no GEMM library)."""
    dsum = torch.clamp(_colsum(d), min=_EPS)
    tput = _colsum(thr * d[None, :]) / dsum
    best = torch.clamp(tput.amax(), min=_EPS)
    pen_t = 1.0 - tput / best
    return pen_t[ntypes.long()]


def _frag_penalty(totals, avail_run, d, ref):
    """f32[N] post-placement stranded-capacity estimate in [0, 1] (see the
    reference)."""
    after = avail_run - d[None, :]
    ref_cols = ref > 0
    fits_ref = torch.all(torch.where(ref_cols[None, :], after >= ref[None, :] - _EPS,
                                     torch.ones_like(after, dtype=torch.bool)), dim=1)
    zero = torch.zeros_like(after)
    free = _colsum(torch.where(ref_cols[None, :], torch.clamp(after, min=0.0), zero))
    total = torch.clamp(_colsum(torch.where(ref_cols[None, :], totals, zero)), min=_EPS)
    return torch.where(fits_ref, torch.zeros_like(free), free / total)


def _fits(view, demand):
    """bool[N]: every resource of ``demand`` fits in ``view`` rows."""
    return torch.all(view >= demand[None, :] - _EPS - 1e-6 * demand[None, :], dim=1)


def _shape_cost(totals, avail_run, d, cap, score, jitter, age, ntypes, thr, ref,
                weights: ScoreWeights, loc=None, want_terms: bool = False):
    """f32[N] multi-objective placement cost for one shape (lower is
    better; inf on nodes with no capacity). Terms whose weight is 0 emit
    no ops. ``want_terms`` also returns the f32[5, N] per-node term vectors
    in ``TERM_NAMES`` order; the cost is the same op for op either way."""
    cost = quantize_score(score)
    if weights.util != 1.0:
        cost = weights.util * cost
    util_c = cost
    n = score.shape[0]
    zeros = torch.zeros((n,), dtype=torch.float32, device=score.device) if want_terms else None
    het_c = frag_c = loc_c = zeros
    scale = 1.0
    has_loc = bool(weights.locality) and loc is not None
    if weights.het or weights.frag or has_loc:
        if weights.starve:
            one = torch.ones((), dtype=torch.float32, device=score.device)
            scale = one / (1.0 + weights.starve * age)
        if weights.het:
            het_c = (QUANTIZE_STEPS * weights.het * scale) * _het_penalty(d, ntypes, thr)
            cost = cost + het_c
        if weights.frag:
            frag_c = (QUANTIZE_STEPS * weights.frag * scale) * _frag_penalty(
                totals, avail_run, d, ref)
            cost = cost + frag_c
        if has_loc:
            loc_c = (QUANTIZE_STEPS * weights.locality * scale) * loc
            cost = cost - loc_c
    cost = cost + jitter
    cost = torch.where(cap > 0, cost, torch.full_like(cost, _INF))
    if not want_terms:
        return cost
    scale_row = (scale * torch.ones((n,), dtype=torch.float32, device=score.device)
                 if isinstance(scale, torch.Tensor)
                 else torch.full((n,), scale, dtype=torch.float32, device=score.device))
    terms = torch.stack([util_c, het_c, frag_c, -loc_c, scale_row])
    return cost, terms


def _nominate_preemption(feas, cap, score, jitter, age, unmet):
    """int32 nominated victim node for one shape (-1 = none)."""
    cand = feas & (cap <= 0)
    pscore = torch.where(cand, score + jitter, torch.full_like(score, _INF))
    pn = torch.argmin(pscore).to(torch.int32)
    ok = (age >= 1.0) & unmet & torch.any(cand)
    return torch.where(ok, pn, torch.full_like(pn, -1))


def _reference_shape(shape_rows, real):
    """f32[R] per-column envelope of the round's REAL demand shapes."""
    return torch.where(real[:, None], shape_rows, torch.zeros_like(shape_rows)).amax(dim=0)


def _pick_topk(mask, score, k: int, hi_bits, lo_bits, prefer, prefer_ok):
    """Reference GetBestNode: stable-sort candidates by (score, node index),
    prefer the preferred node if its score ties the minimum, else uniform
    among the first k. ``hi_bits``/``lo_bits`` are the step key's two
    32-bit draws (``_jaxrng.randint`` split in two, so one hash serves the
    step's four picks)."""
    s = torch.where(mask, score, torch.full_like(score, _INF))
    order = _stable_argsort(s)
    num_cand = mask.sum().to(torch.int32)
    kk = torch.clamp(torch.minimum(torch.full_like(num_cand, k), num_cand), min=1)
    r = _randint_from_bits(hi_bits, lo_bits, kk.to(torch.int64))
    chosen = order.gather(0, r.view(1)).squeeze(0)
    best_score = s.gather(0, order[:1]).squeeze(0)
    use_prefer = prefer_ok & (score.gather(0, prefer.view(1)).squeeze(0) <= best_score)
    chosen = torch.where(use_prefer, prefer.long(), chosen)
    has = num_cand > 0
    return torch.where(has, chosen, torch.full_like(chosen, -1)), has


def _randint_from_bits(higher, lower, span):
    """The tail of ``_jaxrng.randint(key, 0, span)`` given its two draws."""
    mask = 0xFFFFFFFF
    multiplier = torch.remainder(torch.full_like(span, 1 << 16), span)
    multiplier = torch.remainder((multiplier * multiplier) & mask, span)
    offset = ((torch.remainder(higher, span) * multiplier) & mask) + torch.remainder(lower, span)
    return torch.remainder(offset & mask, span)


# ---------------------------------------------------------------------------
# fidelity kernel
# ---------------------------------------------------------------------------


def hybrid_schedule_batch(
    totals, avail, alive, demands, prefer, force_spill, seed, *,
    config: HybridConfig = HybridConfig(), num_candidates: Optional[int] = None,
    device=None,
) -> BatchResult:
    """Greedy-faithful batched hybrid scheduling: B sequential steps, each
    deducting from the availability the next one sees."""
    dev = _device_of(device, totals, avail)
    totals = _t(totals, dev, torch.float32)
    avail_run = _t(avail, dev, torch.float32)
    alive = _t(alive, dev, torch.bool)
    demands = _t(demands, dev, torch.float32)
    prefer = _t(prefer, dev, torch.int64)
    force_spill = _t(force_spill, dev, torch.bool)
    n = totals.shape[0]
    b = demands.shape[0]
    k = num_candidates or max(config.top_k_absolute, int(n * config.top_k_fraction))
    base_key = _jaxrng.prng_key(_seed_int(seed), dev)
    # every step's key, split and drawn up front: one hash for all B steps
    keys = _jaxrng.fold_in(base_key, torch.arange(b, device=dev))
    halves = _jaxrng.fold_in(keys[:, None, :], torch.arange(2, device=dev))
    bits = _jaxrng.random_bits(halves, ())  # [B, 2]

    accel_free = torch.all(_take_cols(totals, ACCEL_COLUMNS) <= 0, dim=1)
    arange_n = torch.arange(n, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)
    nodes, granted_all = [], []
    for i in range(b):
        demand, pref, spill = demands[i], prefer[i], force_spill[i]
        hi_bits, lo_bits = bits[i, 0], bits[i, 1]
        feas = alive & _fits(totals, demand)
        availm = feas & _fits(avail_run, demand)
        score = _critical_score(totals, avail_run, config.spread_threshold)
        cand_mask_base = torch.where(spill, arange_n != pref, true)
        wants_accel = torch.any(_take_cols(demand, ACCEL_COLUMNS) > 0)

        def tiered(avail_mask, feas_mask, require_avail):
            m1 = avail_mask & cand_mask_base
            p_ok1 = ~spill & avail_mask.gather(0, pref.view(1)).squeeze(0)
            c1, v1 = _pick_topk(m1, score, k, hi_bits, lo_bits, pref, p_ok1)
            m2 = feas_mask & ~avail_mask & cand_mask_base
            p_ok2 = ~spill & feas_mask.gather(0, pref.view(1)).squeeze(0)
            c2, v2 = _pick_topk(m2, score, k, hi_bits, lo_bits, pref, p_ok2)
            use2 = ~v1 & ~require_avail
            node = torch.where(v1, c1, torch.where(use2, c2, torch.full_like(c2, -1)))
            return node, v1

        node_a, granted_a = tiered(availm & accel_free, feas & accel_free, true)
        node_b, granted_b = tiered(availm, feas, true if config.require_available else ~true)
        use_a = (~wants_accel if config.avoid_accel_nodes else ~true) & (node_a >= 0)
        node = torch.where(use_a, node_a, node_b)
        granted = torch.where(use_a, granted_a, granted_b) & (node >= 0)
        safe_node = torch.clamp(node, min=0)
        deduction = torch.where(granted, demand, torch.zeros_like(demand))
        avail_run = avail_run.index_add(0, safe_node.view(1), (-deduction)[None, :])
        nodes.append(node)
        granted_all.append(granted)
    if b:
        node_t = torch.stack(nodes).to(torch.int32)
        granted_t = torch.stack(granted_all)
    else:
        node_t = torch.zeros((0,), dtype=torch.int32, device=dev)
        granted_t = torch.zeros((0,), dtype=torch.bool, device=dev)
    return BatchResult(node_t, granted_t, avail_run)


# ---------------------------------------------------------------------------
# throughput mode
# ---------------------------------------------------------------------------


class RoundsResult(NamedTuple):
    node: torch.Tensor       # int32[B], -1 = unplaced after all rounds
    avail_out: torch.Tensor  # f32[N,R]


def hybrid_schedule_rounds(totals, avail, alive, demands, seed, *, rounds: int = 8,
                           spread_threshold: float = 0.5, device=None) -> RoundsResult:
    """Throughput-mode placement: simultaneous choice + prefix-sum admission
    (see the reference). Each round every pending request takes its
    cheapest feasible-and-available node (jittered), requests are admitted
    against each node in request order, and the admitted demands are
    deducted."""
    dev = _device_of(device, totals, avail)
    totals = _t(totals, dev, torch.float32)
    avail_run = _t(avail, dev, torch.float32)
    alive = _t(alive, dev, torch.bool)
    demands = _t(demands, dev, torch.float32)
    n, r = totals.shape
    b = demands.shape[0]
    base_key = _jaxrng.prng_key(_seed_int(seed), dev)
    keys = _jaxrng.fold_in(base_key, torch.arange(rounds, device=dev))

    feas = alive[None, :] & torch.all(
        totals[None, :, :] >= demands[:, None, :] * (1 + 1e-6) - _EPS, dim=2)
    assigned = torch.full((b,), -1, dtype=torch.int32, device=dev)
    inf = torch.full((), _INF, dtype=torch.float32, device=dev)
    dummy = torch.full((), n, dtype=torch.int64, device=dev)
    for i in range(rounds):
        pending = assigned < 0
        score = _critical_score(totals, avail_run, spread_threshold)
        fits = torch.all(avail_run[None, :, :] >= demands[:, None, :] - _EPS, dim=2)
        cand = feas & fits & pending[:, None]
        jitter = _jaxrng.uniform(keys[i], (b, n)) * 1e-3
        cost = torch.where(cand, score[None, :] + jitter, inf)
        choice = torch.argmin(cost, dim=1)
        has_cand = torch.any(cand, dim=1)
        choice = torch.where(has_cand & pending, choice, dummy)

        order = _stable_argsort(choice)
        c_sorted = choice.gather(0, order)
        d_sorted = demands.index_select(0, order)
        csum = _cumsum(d_sorted)
        is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                              c_sorted[1:] != c_sorted[:-1]])
        excl = csum - d_sorted
        base = torch.where(is_start[:, None], excl, torch.zeros_like(excl))
        base = torch.cummax(base, dim=0).values
        prefix_excl = csum - d_sorted - base
        node_avail = avail_run.index_select(0, torch.clamp(c_sorted, max=n - 1))
        ok = torch.all(prefix_excl + d_sorted <= node_avail + _EPS, dim=1)
        ok = ok & (c_sorted < n)

        # per-node sums of the admitted demands, accumulated in request
        # order as XLA's scatter-add does (index_put_ with accumulate is the
        # sort-based deterministic kernel on CUDA, not atomics)
        used = torch.zeros((n + 1, r), dtype=torch.float32, device=dev).index_put_(
            (c_sorted,), torch.where(ok[:, None], d_sorted, torch.zeros_like(d_sorted)),
            accumulate=True)[:n]
        avail_run = avail_run - used
        won = torch.where(ok, c_sorted, torch.full_like(c_sorted, -1)).to(torch.int32)
        unsorted = torch.empty_like(won).scatter_(0, order, won)
        assigned = torch.maximum(assigned, unsorted)
    return RoundsResult(assigned, avail_run)


def hybrid_schedule_rounds_chunked(totals, avail, alive, demands, seed, *, rounds: int = 4,
                                   device=None) -> RoundsResult:
    """Chunked throughput mode: C chunks of B requests placed in sequence,
    each against the previous chunks' deductions, with no host round trip
    between them. ``demands`` is f32[C,B,R]."""
    dev = _device_of(device, totals, avail)
    totals = _t(totals, dev, torch.float32)
    avail_run = _t(avail, dev, torch.float32)
    alive = _t(alive, dev, torch.bool)
    demands = _t(demands, dev, torch.float32)
    seed = _seed_int(seed)
    nodes = []
    for i in range(demands.shape[0]):
        res = hybrid_schedule_rounds(totals, avail_run, alive, demands[i],
                                     (seed + i) & 0xFFFFFFFF, rounds=rounds)
        avail_run = res.avail_out
        nodes.append(res.node)
    node = (torch.cat(nodes) if nodes else torch.zeros((0,), dtype=torch.int32, device=dev))
    return RoundsResult(node, avail_run)


# ---------------------------------------------------------------------------
# shape-grouped waterfall (the production round)
# ---------------------------------------------------------------------------


class ShapesResult(NamedTuple):
    node: torch.Tensor          # int32[B], -1 = unplaced
    avail_out: torch.Tensor     # f32[N,R]
    preempt_node: torch.Tensor  # int32[U] per-shape nominated victim, -1 = none
    terms: torch.Tensor         # f32[B, 5] with explain, else a [1, 5] zero placeholder


def hybrid_schedule_shapes_multi_impl(
    totals, avail, alive, ntypes, thr, shape_demands, shape_ids, ages, seed, *,
    spread_threshold: float = 0.5, weights: ScoreWeights = ScoreWeights(),
    preempt: bool = False, locality=None, explain: bool = False, device=None,
) -> ShapesResult:
    """Shape-grouped waterfall placement (see the reference): for each
    shape in priority order, every node's capacity for it, nodes ordered by
    the multi-objective cost, and the request of rank r inside the shape
    placed on the first node whose cumulative capacity exceeds r; per-node
    counts deducted. ``explain`` adds the per-term attribution of each
    winning node and places bit-identically; ``preempt`` adds one victim
    nomination per starving unmet shape."""
    dev = _device_of(device, totals, avail)
    totals = _t(totals, dev, torch.float32)
    avail_run = _t(avail, dev, torch.float32)
    alive = _t(alive, dev, torch.bool)
    ntypes = _t(ntypes, dev, torch.int64)
    thr = _t(thr, dev, torch.float32)
    shape_demands = _t(shape_demands, dev, torch.float32)
    shape_ids = _t(shape_ids, dev, torch.int64)
    ages = _t(ages, dev, torch.float32)
    use_loc = bool(weights.locality) and locality is not None
    if use_loc:
        locality = _t(locality, dev, torch.float32)
    n = totals.shape[0]
    b = shape_ids.shape[0]
    u = shape_demands.shape[0]
    base_key = _jaxrng.prng_key(_seed_int(seed), dev)
    # every shape's jitter in one draw: row u is uniform(fold_in(key, u), (n,))
    jitters = _jaxrng.uniform(_jaxrng.fold_in(base_key, torch.arange(u, device=dev)), (n,))

    if weights.frag:
        real = torch.all(shape_demands < _BIG_PAD * 0.5, dim=1)
        ref = _reference_shape(shape_demands, real)
    else:
        ref = torch.zeros((shape_demands.shape[1],), dtype=torch.float32, device=dev)

    # rank of each request within its shape class
    order = _stable_argsort(shape_ids)
    sorted_ids = shape_ids.gather(0, order)
    idx = torch.arange(b, device=dev)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          sorted_ids[1:] != sorted_ids[:-1]])
    group_start = torch.cummax(torch.where(is_start, idx, torch.zeros_like(idx)), dim=0).values
    rank_sorted = idx - group_start
    rank_f = rank_sorted.to(torch.float32)

    k = min(n, b)
    nodes_sorted = torch.full((b,), -1, dtype=torch.int64, device=dev)
    terms_acc = torch.zeros((b, 5) if explain else (1, 5), dtype=torch.float32, device=dev)
    preempt_nodes = []
    minus_one = torch.full((), -1, dtype=torch.int32, device=dev)
    for uidx in range(u):
        d = shape_demands[uidx]
        cap, has_demand, feas = _shape_capacity(totals, avail_run, alive, d)
        score = _critical_score(totals, avail_run, spread_threshold)
        jitter = jitters[uidx]
        loc_row = locality[uidx] if use_loc else None
        if explain:
            cost, tvec = _shape_cost(totals, avail_run, d, cap, score, jitter, ages[uidx],
                                     ntypes, thr, ref, weights, loc_row, want_terms=True)
        else:
            cost = _shape_cost(totals, avail_run, d, cap, score, jitter, ages[uidx],
                               ntypes, thr, ref, weights, loc_row)
        # lax.top_k(-cost, k): the k cheapest nodes, ties to the lower index
        node_order = _stable_argsort(cost)[:k]
        cap_sorted = cap.gather(0, node_order)
        cumcap = _cumsum(torch.where(torch.isfinite(cap_sorted), cap_sorted,
                                     torch.full_like(cap_sorted, 2.0 * b)))
        sel = sorted_ids == uidx
        pos = torch.searchsorted(cumcap, rank_f, right=True)
        valid = sel & (rank_f < cumcap[-1]) & (pos < k)
        safe_pos = torch.clamp(pos, max=k - 1)
        node_u = torch.where(valid, node_order.gather(0, safe_pos), torch.full_like(pos, -1))
        counts = torch.zeros((n + 1,), dtype=torch.float32, device=dev).index_add_(
            0, torch.where(valid, node_u, torch.full_like(node_u, n)),
            valid.to(torch.float32))[:n]
        avail_run = torch.where(has_demand, avail_run - counts[:, None] * d[None, :], avail_run)
        if explain:
            safe_node = torch.clamp(node_u, min=0)
            contrib = torch.where(valid[:, None], tvec.index_select(1, safe_node).T,
                                  torch.zeros((b, 5), dtype=torch.float32, device=dev))
            terms_acc = terms_acc + contrib
        if preempt:
            unmet = sel.sum() > valid.sum()
            preempt_nodes.append(_nominate_preemption(feas, cap, score, jitter, ages[uidx], unmet))
        else:
            preempt_nodes.append(minus_one)
        nodes_sorted = torch.maximum(nodes_sorted, node_u)
    nodes = torch.full((b,), -1, dtype=torch.int32, device=dev).scatter_(
        0, order, nodes_sorted.to(torch.int32))
    if explain:
        terms = torch.zeros((b, 5), dtype=torch.float32, device=dev).index_copy_(
            0, order, terms_acc)
    else:
        terms = terms_acc
    preempt_node = (torch.stack(preempt_nodes) if preempt_nodes
                    else torch.zeros((0,), dtype=torch.int32, device=dev))
    return ShapesResult(nodes, avail_run, preempt_node, terms)


def hybrid_schedule_shapes_impl(totals, avail, alive, shape_demands, shape_ids, seed, *,
                                spread_threshold: float = 0.5, device=None) -> RoundsResult:
    """Single-objective waterfall: the multi program at weights=(1,0,0,0)
    with homogeneous node types (the extra terms emit no ops)."""
    dev = _device_of(device, totals, avail)
    n, r = np.shape(totals)
    u = np.shape(shape_demands)[0]
    res = hybrid_schedule_shapes_multi_impl(
        totals, avail, alive,
        torch.zeros((n,), dtype=torch.int64, device=dev),
        torch.ones((1, r), dtype=torch.float32, device=dev),
        shape_demands, shape_ids,
        torch.zeros((u,), dtype=torch.float32, device=dev),
        seed, spread_threshold=spread_threshold, device=dev,
    )
    return RoundsResult(res.node, res.avail_out)


# The reference jits these two; eagerly they are the programs themselves.
hybrid_schedule_shapes = hybrid_schedule_shapes_impl
hybrid_schedule_shapes_multi = hybrid_schedule_shapes_multi_impl


# ---------------------------------------------------------------------------
# parked-demand ring and slot estimation
# ---------------------------------------------------------------------------


class RingResult(NamedTuple):
    placed: torch.Tensor        # int32[S] requests placed per ring slot
    per_node: torch.Tensor      # int32[S,N] placements per node per slot
    avail_out: torch.Tensor     # f32[N,R]
    preempt_node: torch.Tensor  # int32[S] nominated victim node per slot, -1=none


def ring_schedule_impl(totals, avail, alive, ntypes, thr, ring_shapes, counts, ages, seed, *,
                       spread_threshold: float = 0.5, weights: ScoreWeights = ScoreWeights(),
                       preempt: bool = False, slots=None, device=None) -> RingResult:
    """Count-driven waterfall over the parked-demand ring: the round's
    placement math, with demand as (resident shape row, count) pairs and
    per-node placement counts as the result.

    ``slots`` (host ints, ascending) are the slots the walk visits; None
    visits all of them, as the reference's scan does. A slot with no
    demand places nothing, leaves ``avail`` as it is and nominates no
    victim, so skipping it gives the same bits: its row is ``placed`` 0,
    a zero ``per_node`` row and ``preempt`` -1. Each visited slot keeps
    the jitter of its own index (``fold_in(key, slot)``)."""
    dev = _device_of(device, totals, avail)
    totals = _t(totals, dev, torch.float32)
    avail_run = _t(avail, dev, torch.float32)
    alive = _t(alive, dev, torch.bool)
    ntypes = _t(ntypes, dev, torch.int64)
    thr = _t(thr, dev, torch.float32)
    ring_shapes = _t(ring_shapes, dev, torch.float32)
    counts = _t(counts, dev, torch.int32)
    ages = _t(ages, dev, torch.float32)
    n = totals.shape[0]
    s = ring_shapes.shape[0]
    slots = list(range(s)) if slots is None else [int(i) for i in slots]
    placed_out = torch.zeros((s,), dtype=torch.int32, device=dev)
    per_node_out = torch.zeros((s, n), dtype=torch.int32, device=dev)
    preempt_out = torch.full((s,), -1, dtype=torch.int32, device=dev)
    if not slots:
        return RingResult(placed_out, per_node_out, avail_run, preempt_out)
    slot_idx = _t(np.asarray(slots, dtype=np.int64), dev, torch.int64)
    base_key = _jaxrng.prng_key(_seed_int(seed), dev)
    jitters = _jaxrng.uniform(_jaxrng.fold_in(base_key, slot_idx), (n,))
    if weights.frag:
        ref = _reference_shape(ring_shapes, counts > 0)
    else:
        ref = torch.zeros((ring_shapes.shape[1],), dtype=torch.float32, device=dev)
    placed_all, per_node_all, preempt_all = [], [], []
    for j, uidx in enumerate(slots):
        d = ring_shapes[uidx]
        want = counts[uidx].to(torch.float32)
        cap, has_demand, feas = _shape_capacity(totals, avail_run, alive, d)
        score = _critical_score(totals, avail_run, spread_threshold)
        jitter = jitters[j]
        cost = _shape_cost(totals, avail_run, d, cap, score, jitter, ages[uidx], ntypes, thr,
                           ref, weights)
        node_order = _stable_argsort(cost)
        cap_sorted = cap.gather(0, node_order)
        # zero-demand shapes have infinite per-node capacity: the first
        # (cheapest) node absorbs the whole count
        cap_fin = torch.where(torch.isfinite(cap_sorted), cap_sorted, want)
        cum_prev = torch.cat([torch.zeros((1,), dtype=torch.float32, device=dev),
                              _cumsum(cap_fin)[:-1]])
        take_sorted = torch.minimum(torch.clamp(want - cum_prev, min=0.0), cap_fin)
        per_node = torch.zeros((n,), dtype=torch.float32, device=dev).scatter_(
            0, node_order, take_sorted)
        avail_run = torch.where(has_demand, avail_run - per_node[:, None] * d[None, :], avail_run)
        placed = _tree_sum(take_sorted)
        if preempt:
            preempt_all.append(_nominate_preemption(feas, cap, score, jitter, ages[uidx],
                                                    placed < want))
        placed_all.append(_to_i32(placed))
        per_node_all.append(_to_i32(per_node))
    placed_out.index_copy_(0, slot_idx, torch.stack(placed_all))
    per_node_out.index_copy_(0, slot_idx, torch.stack(per_node_all))
    if preempt:
        preempt_out.index_copy_(0, slot_idx, torch.stack(preempt_all))
    return RingResult(placed_out, per_node_out, avail_run, preempt_out)


def shape_slots_impl(totals, avail, alive, shapes, *, device=None) -> torch.Tensor:
    """int32[S]: grantable-slot estimate per demand shape over the
    resident arrays (one shape at a time, so the intermediate stays
    [N, R])."""
    dev = _device_of(device, totals, avail)
    totals = _t(totals, dev, torch.float32)
    avail = _t(avail, dev, torch.float32)
    alive = _t(alive, dev, torch.bool)
    shapes = _t(shapes, dev, torch.float32)
    out = []
    for i in range(shapes.shape[0]):
        slots, _, _ = _shape_capacity(totals, avail, alive, shapes[i])
        # zero-demand shapes report "huge", clamped to int32-safe
        out.append(_to_i32(torch.clamp(_tree_sum(slots), max=2.0 ** 31 - 1)))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


def hardest_first_order(shape_rows: np.ndarray) -> np.ndarray:
    """Stable shape-priority order (SortRequiredResources semantics): more
    distinct resources first, then heavier."""
    return np.lexsort(
        (
            np.arange(shape_rows.shape[0]),
            -shape_rows.sum(axis=1),
            -(shape_rows > 0).sum(axis=1),
        )
    )


def dedupe_shapes(demands: np.ndarray):
    """Host helper: unique demand shapes (priority-sorted hardest-first, like
    SortRequiredResources) + per-request shape ids."""
    uniq, inverse = np.unique(demands, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = hardest_first_order(uniq)
    remap = np.empty(len(uniq), dtype=np.int32)
    remap[order] = np.arange(len(uniq), dtype=np.int32)
    return uniq[order].astype(np.float32), remap[inverse].astype(np.int32)


def retire_scores_impl(totals, avail, demand, *, device=None) -> torch.Tensor:
    """Retirement desirability per node for the elasticity plane: higher
    = retire first (see the reference)."""
    dev = _device_of(device, totals, avail)
    totals = _t(totals, dev, torch.float32)
    avail = _t(avail, dev, torch.float32)
    demand = _t(demand, dev, torch.float32)
    cap = torch.clamp(_colsum(totals), min=_EPS)
    idle_frac = _colsum(avail) / cap
    size_bias = cap / torch.clamp(cap.amax(), min=_EPS)
    return idle_frac - 0.5 * size_bias - 1e6 * (demand > 0).to(torch.float32)


def retire_order(totals: np.ndarray, avail: np.ndarray, demand: np.ndarray,
                 device=None) -> np.ndarray:
    """Host wrapper: node indices best-retire-first."""
    scores = retire_scores_impl(totals, avail, demand, device=device).cpu().numpy()
    return np.argsort(-scores, kind="stable")


# ---------------------------------------------------------------------------
# NumPy golden model (host, exact)
# ---------------------------------------------------------------------------


def hybrid_schedule_reference(
    totals: np.ndarray,
    avail: np.ndarray,
    alive: np.ndarray,
    demands: np.ndarray,
    prefer: np.ndarray,
    force_spill: np.ndarray,
    *,
    config: HybridConfig = HybridConfig(),
    rng: Optional[np.random.Generator] = None,
    top_k_override: Optional[int] = None,
):
    """Sequential host implementation of the same semantics (rng=None →
    deterministic: always the single best candidate)."""
    n = totals.shape[0]
    k = top_k_override or max(config.top_k_absolute, int(n * config.top_k_fraction))
    avail = avail.copy()
    out_nodes, out_granted = [], []
    for b in range(demands.shape[0]):
        d = demands[b]
        feas = alive & np.all(totals >= d[None, :] - _EPS, axis=1)
        availm = feas & np.all(avail >= d[None, :] - _EPS, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = totals[:, CRITICAL_COLUMNS,]
            a = avail[:, CRITICAL_COLUMNS,]
            util = np.where(t > 0, 1.0 - a / np.where(t > 0, t, 1.0), 0.0)
        score = util.max(axis=1)
        score = np.where(score < config.spread_threshold, 0.0, score)

        def pick(mask, require_avail_unused=None):
            p = int(prefer[b])
            m = mask.copy()
            if force_spill[b]:
                m[p] = False
            idx = np.flatnonzero(m)
            if idx.size == 0:
                return -1
            ordered = idx[np.lexsort((idx, score[idx]))]
            if not force_spill[b] and mask[p] and score[p] <= score[ordered[0]]:
                return p
            kk = min(k, ordered.size)
            if rng is None:
                return int(ordered[0])
            return int(ordered[rng.integers(0, kk)])

        wants_accel = np.any(d[ACCEL_COLUMNS,] > 0)
        accel_free = np.all(totals[:, ACCEL_COLUMNS,] <= 0, axis=1)
        node, granted = -1, False
        if config.avoid_accel_nodes and not wants_accel:
            c = pick(availm & accel_free)
            if c >= 0:
                node, granted = c, True
        if node < 0:
            c = pick(availm)
            if c >= 0:
                node, granted = c, True
            elif not config.require_available:
                c = pick(feas & ~availm)
                if c >= 0:
                    node, granted = c, False
        if granted:
            avail[node] -= d
        out_nodes.append(node)
        out_granted.append(granted)
    return np.array(out_nodes), np.array(out_granted), avail
