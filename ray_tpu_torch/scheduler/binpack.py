"""Autoscaler bin-packing programs.

Port of ``ray_tpu/scheduler/binpack.py``: the first-fit residual packer
``bin_pack_residual`` (one step per demand), the node-type scorer
``utilization_scores``, the projected-gradient ``solve_pack_counts`` over
deduped (shape, count) pairs with its exact waterfall extraction, and the
device-resident ``DeltaBinPacker``. They run as torch programs on the
tensors' device (``cuda`` unless the caller passes ``device="cpu"``).

The solve's fractional allocation only orders the extraction's nodes. Up
to 32 nodes it follows XLA's CPU order as a probe of it showed it: the load
``einsum("un,ur->nr")`` is a sequential FMA over the shapes (emulated
exactly, ``_fma_sum``), and the node sums run node after node. Above 32
nodes XLA vectorizes its node sums in an order not yet matched, so the
allocation cannot follow JAX's bits there whatever the load does; the port
takes one fixed pairwise tree for the node sums and for the load, whose
emulated FMA chain (shapes × iterations steps of a dozen ops each) would
cost several times the whole solve on the card. The ``ur,nr->un``
gradient is a pairwise tree over the resources at every size. Every op is
elementwise or a fixed-order sum, so the card and the CPU give the same
bits.
"""
from __future__ import annotations

import logging
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..util.metrics import Counter as _MetricCounter
from ..util.metrics import Gauge as _MetricGauge
from .hybrid import _INF, _colsum, _cumsum, _device_of, _stable_argsort, _t, _take_cols, _tree_sum
from .resources import GPU, TPU

logger = logging.getLogger(__name__)

_EPS = 1e-5

# autoscaler solve health (surfaced via head QueryState("sched") so a
# solver regression is observable without a bench run)
SOLVER_RUNS = _MetricCounter(
    "autoscaler_solver_runs_total",
    "Autoscaler residual bin-packs solved by the projected-gradient "
    "kernel (vs the first-fit scan).",
)
SOLVER_FALLBACKS = _MetricCounter(
    "autoscaler_solver_fallbacks_total",
    "Projected-gradient solves that failed and fell back to the exact "
    "first-fit kernel.",
)
SOLVER_ITERS = _MetricGauge(
    "autoscaler_solver_iters",
    "Fixed projected-gradient iteration count of the last solve.",
)


def sort_demands(demands: np.ndarray) -> np.ndarray:
    """Indices ordering demands complex-first, then heavy-first (host-side)."""
    complexity = (demands > 0).sum(axis=1)
    weight = demands.sum(axis=1)
    # reverse=True on (len, sum); stable original order as final tie-break.
    return np.lexsort((np.arange(len(demands)), -weight, -complexity))


class BinPackResult(NamedTuple):
    node: torch.Tensor       # int32[B] node row per demand, -1 = unfulfilled
    avail_out: torch.Tensor  # f32[N,R] residual node resources


def bin_pack_residual(nodes_avail, demands, *, strict_spread: bool = False,
                      device=None) -> BinPackResult:
    """First-fit packing; the kernel behind autoscaler demand satisfaction.
    ``demands`` pre-sorted complex→heavy."""
    dev = _device_of(device, nodes_avail, demands)
    avail = _t(nodes_avail, dev, torch.float32)
    demands = _t(demands, dev, torch.float32)
    n = avail.shape[0]
    used = torch.zeros((n,), dtype=torch.bool, device=dev)
    minus_one = torch.full((), -1, dtype=torch.int32, device=dev)
    nodes = []
    for i in range(demands.shape[0]):
        d = demands[i]
        fits = torch.all(avail >= d[None, :] - _EPS, dim=1) & ~used
        any_fit = torch.any(fits)
        chosen = torch.argmax(fits.to(torch.int32))  # first fitting node
        avail = torch.where(any_fit, avail.index_add(0, chosen.view(1), (-d)[None, :]), avail)
        if strict_spread:
            used = used.index_copy(0, chosen.view(1), used.gather(0, chosen.view(1)) | any_fit)
        nodes.append(torch.where(any_fit, chosen.to(torch.int32), minus_one))
    node = torch.stack(nodes) if nodes else torch.zeros((0,), dtype=torch.int32, device=dev)
    return BinPackResult(node, avail)


class SolveResult(NamedTuple):
    placed: torch.Tensor     # f32[U] requests placed per demand shape
    per_node: torch.Tensor   # f32[U,N] integral placements per node per shape
    avail_out: torch.Tensor  # f32[N,R] residual node resources


def _capacity(avail, d, dm, fallback):
    """f32[N] whole copies of ``d`` each row of ``avail`` can take;
    ``fallback`` where ``d`` demands nothing."""
    one = torch.ones_like(d)
    ratio = torch.where(dm[None, :], torch.floor((avail + _EPS) / torch.where(dm, d, one)[None, :]),
                        torch.full_like(avail, _INF))
    cap = ratio.amin(dim=1)
    return torch.where(torch.any(dm), torch.clamp(cap, min=0.0), fallback)


def _fma_round(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``fma(a, b, c)`` from the exact f64 product ``p = a·b``: the f64
    sum rounded to odd (TwoSum's error term picks the neighbour), then to
    f32, which rounds once, as a fused multiply-add does. Elementwise, so
    the card and the CPU agree."""
    c = c.to(torch.float64)
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, err * _INF), s)
    return s.to(torch.float32)


def _fma_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32[N,R] ``einsum("un,ur->nr", x, y)`` accumulated shape after shape
    with fused multiply-adds: XLA's CPU order for this contraction."""
    x64, y64 = x.to(torch.float64), y.to(torch.float64)
    acc = torch.zeros((x.shape[1], y.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        acc = _fma_round(x64[i][:, None] * y64[i][None, :], acc)
    return acc


_SEQ_NODES = 32  # XLA's CPU compiler sums up to this many nodes in order


def _load(x: torch.Tensor, shapes: torch.Tensor) -> torch.Tensor:
    """f32[N,R] ``einsum("un,ur->nr", x, shapes)``: XLA's FMA chain up to
    ``_SEQ_NODES`` nodes, one pairwise tree over the shapes above."""
    if x.shape[1] <= _SEQ_NODES:
        return _fma_sum(x, shapes)
    return _tree_sum(x[:, :, None] * shapes[:, None, :], 0)


def _node_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (node) axis: node after node up to 32 nodes, as
    XLA's CPU compiler does; one fixed pairwise tree above."""
    n = x.shape[-1]
    if n == 0 or n > _SEQ_NODES:
        return _tree_sum(x, -1)
    s = x[..., 0]
    for i in range(1, n):
        s = s + x[..., i]
    return s


def solve_pack_counts(nodes_avail, shapes, counts, *, iters: int = 24,
                      device=None) -> SolveResult:
    """Projected-gradient residual packing over (shape, count) pairs (see
    the reference): ``iters`` fill/repair steps shape a fractional
    allocation x[U,N], then one exact waterfall over the shapes admits
    integral placements in each shape's solver-preferred node order, so no
    node is ever over-committed."""
    dev = _device_of(device, nodes_avail, shapes)
    nodes_avail = _t(nodes_avail, dev, torch.float32)
    shapes = _t(shapes, dev, torch.float32)
    counts = _t(counts, dev, torch.float32)
    n, r = nodes_avail.shape
    u = shapes.shape[0]
    demanded = shapes > 0  # [U,R]
    zero_n = torch.zeros((n,), dtype=torch.float32, device=dev)
    cap0 = torch.stack([_capacity(nodes_avail, shapes[i], demanded[i], zero_n)
                        for i in range(u)]) if u else torch.zeros((0, n), device=dev)

    scale = torch.clamp(_colsum(shapes * shapes), min=_EPS)  # [U]
    x = torch.zeros((u, n), dtype=torch.float32, device=dev)
    for _ in range(iters):
        # (a) fill: distribute unserved count over remaining headroom
        head = torch.clamp(cap0 - x, min=0.0)
        head_sum = torch.clamp(_node_sum(head), min=_EPS)[:, None]
        slack = torch.clamp(counts - _node_sum(x), min=0.0)
        x = x + (slack[:, None] * head) / head_sum
        # (b) repair: gradient step down the capacity violation
        load = _load(x, shapes)                                        # [N,R]
        over = torch.clamp(load - nodes_avail, min=0.0)
        grad = _tree_sum(shapes[:, None, :] * over[None, :, :], -1)    # [U,N]
        x = torch.clamp(x - grad / scale[:, None], min=0.0)
        # (c) project: never allocate more than the shape's count
        tot = torch.clamp(_node_sum(x), min=_EPS)
        x = x * torch.clamp(counts / tot, max=1.0)[:, None]

    avail_run = nodes_avail
    placed, per_nodes = [], []
    for uidx in range(u):
        d = shapes[uidx]
        want = counts[uidx]
        cap = _capacity(avail_run, d, demanded[uidx], want.expand(n))
        has_demand = torch.any(demanded[uidx])
        # solver-preferred node order (node index breaks ties, mirroring
        # first-fit's in-order walk)
        order = _stable_argsort(-x[uidx])
        cap_sorted = cap.gather(0, order)
        cap_fin = torch.where(torch.isfinite(cap_sorted), cap_sorted, want)
        cum_prev = torch.cat([torch.zeros((1,), dtype=torch.float32, device=dev),
                              _cumsum(cap_fin)[:-1]])
        take_sorted = torch.minimum(torch.clamp(want - cum_prev, min=0.0), cap_fin)
        per_node = torch.zeros((n,), dtype=torch.float32, device=dev).scatter_(0, order, take_sorted)
        avail_run = torch.where(has_demand, avail_run - per_node[:, None] * d[None, :], avail_run)
        placed.append(_tree_sum(take_sorted))
        per_nodes.append(per_node)
    if u:
        return SolveResult(torch.stack(placed), torch.stack(per_nodes), avail_run)
    return SolveResult(torch.zeros((0,), device=dev), torch.zeros((0, n), device=dev), avail_run)


class TypeScore(NamedTuple):
    feasible: torch.Tensor      # bool[T] — at least one demand fits this type
    gpu_ok: torch.Tensor        # bool[T]
    num_matching: torch.Tensor  # int32[T]
    min_util: torch.Tensor      # f32[T]
    mean_util: torch.Tensor     # f32[T]


def utilization_scores(node_types, demands, *, conserve_accel_nodes: bool = True,
                       device=None) -> TypeScore:
    """_resource_based_utilization_scorer semantics over all node types at
    once: every type is filled with the demand list in order."""
    dev = _device_of(device, node_types, demands)
    node = _t(node_types, dev, torch.float32)
    demands = _t(demands, dev, torch.float32)
    resource_types_mask = torch.any(demands > 0, dim=0)  # bool[R]
    any_accel_task = torch.any(_take_cols(demands, (GPU, TPU)) > 0)
    remaining = node
    fit_any = torch.zeros((node.shape[0],), dtype=torch.bool, device=dev)
    for i in range(demands.shape[0]):
        d = demands[i]
        fits = torch.all(remaining >= d[None, :] - _EPS, dim=1)
        remaining = torch.where(fits[:, None], remaining - d[None, :], remaining)
        fit_any = fit_any | fits
    valid = node >= 1.0  # reference skips v < 1 (resources are ~integers)
    util = torch.where(valid, (node - remaining) / torch.where(valid, node, torch.ones_like(node)),
                       torch.zeros_like(node))
    ubr = node * (util * (util * util))  # v · u³ per resource, as XLA's integer_pow
    min_util = torch.where(valid, ubr, torch.full_like(ubr, _INF)).amin(dim=1)
    cnt = _colsum(valid.to(torch.float32))
    mean_util = _colsum(torch.where(valid, ubr, torch.zeros_like(ubr))) / torch.clamp(cnt, min=1.0)
    num_matching = _colsum((valid & resource_types_mask[None, :]).to(torch.int32)).to(torch.int32)
    is_accel_node = torch.any(_take_cols(node, (GPU, TPU)) > 0, dim=1)
    if conserve_accel_nodes:
        gpu_ok = ~(is_accel_node & ~any_accel_task)
    else:
        gpu_ok = torch.ones_like(is_accel_node)
    feasible = fit_any & (cnt > 0)
    return TypeScore(feasible, gpu_ok, num_matching, min_util, mean_util)


class DeltaBinPacker:
    """Device-resident node rows for the autoscaler's residual packing.

    The host-mirror/dirty-row protocol of DeviceSchedulerState: per tick,
    rows whose host value changed are scattered into the resident rows
    (``index_copy_``, bucket-padded by ``pad_scatter``); membership or
    geometry changes re-upload everything. Node and demand axes are
    bucket-padded with zero rows (a real demand never fits one, and
    first-fit prefers the earlier real rows for zero demands). The rows live
    on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
    """

    def __init__(self, device=None):
        from .._device import resolve_device

        self.device = resolve_device(device)
        self._ids: Tuple = ()
        self._mirror = None   # f32[C,R] host
        self._dev = None      # f32[C,R] device

    @staticmethod
    def _bucket(n: int, floor: int = 8) -> int:
        from .device import _bucket

        return _bucket(n, floor)

    def _sync_rows(self, node_ids, rows: np.ndarray) -> tuple:
        """Delta-sync the keyed node rows into the resident device
        mirror (host-mirror/dirty-row protocol); returns (dev, n, r)."""
        rows = np.asarray(rows, dtype=np.float32)
        n, r = rows.shape
        ids = tuple(node_ids)
        n_pad = self._bucket(n)
        if (
            self._mirror is None
            or ids != self._ids
            or self._mirror.shape != (n_pad, r)
        ):
            self._mirror = np.zeros((n_pad, r), dtype=np.float32)
            self._mirror[:n] = rows
            self._dev = torch.from_numpy(self._mirror.copy()).to(self.device)
            self._ids = ids
        else:
            dirty = np.flatnonzero(np.any(self._mirror[:n] != rows, axis=1))
            if dirty.size:
                from .device import pad_scatter

                self._mirror[dirty] = rows[dirty]
                drows, dvals = pad_scatter(
                    dirty.astype(np.int64), self._mirror[dirty]
                )
                self._dev.index_copy_(0, torch.from_numpy(drows).to(self.device),
                                      torch.from_numpy(dvals).to(self.device))
        return self._dev, n, r

    def pack(self, node_ids, rows, demands: np.ndarray) -> np.ndarray:
        """First-fit ``demands`` onto the keyed node ``rows``; returns
        int32[B] row index per demand (-1 = unfulfilled). This is the exact
        small-batch path, the solver's failure fallback, and the
        differential-test oracle."""
        dev, n, r = self._sync_rows(node_ids, rows)
        b = demands.shape[0]
        b_pad = self._bucket(b, 1)
        dmat = np.zeros((b_pad, r), dtype=np.float32)
        dmat[:b] = demands
        res = bin_pack_residual(dev, dmat)
        nodes = res.node.cpu().numpy()[:b].copy()
        nodes[nodes >= n] = -1  # a pad row can never really host a demand
        return nodes

    def pack_or_solve(self, node_ids, rows, demands: np.ndarray) -> np.ndarray:
        """``pack`` semantics through the projected-gradient solve on big
        batches: demands dedupe to (shape, count) pairs, one solve, and the
        per-demand rows are reassembled rank-by-rank from the per-node
        takes. The first-fit scan remains the small-batch path and the
        fallback on a solver failure (counted by SOLVER_FALLBACKS)."""
        from ..config import cfg

        b = demands.shape[0]
        if (
            not cfg.autoscaler_solve
            or b < int(cfg.autoscaler_solve_min_demands)
        ):
            return self.pack(node_ids, rows, demands)
        try:
            dev, n, r = self._sync_rows(node_ids, rows)
            shapes, inverse = np.unique(demands, axis=0, return_inverse=True)
            inverse = inverse.reshape(-1)
            # extraction is a sequential waterfall over shapes: keep the
            # reference's complex→heavy order (sort_demands)
            order = sort_demands(shapes)
            remap = np.empty(len(shapes), dtype=np.int64)
            remap[order] = np.arange(len(shapes))
            shapes = shapes[order]
            inverse = remap[inverse]
            u = shapes.shape[0]
            u_pad = self._bucket(u, 1)
            smat = np.zeros((u_pad, r), dtype=np.float32)
            smat[:u] = shapes
            cvec = np.zeros(u_pad, dtype=np.float32)
            cvec[:u] = np.bincount(inverse, minlength=u)
            iters = max(1, int(cfg.autoscaler_solve_iters))
            res = solve_pack_counts(dev, smat, cvec, iters=iters)
            SOLVER_RUNS.inc()
            SOLVER_ITERS.set(iters)
            # pad node rows hold zero avail (cap 0): clamp to real rows
            per_node = res.per_node.cpu().numpy()[:u, :n].astype(np.int64)
            out = np.full(b, -1, dtype=np.int32)
            node_idx = np.arange(n)
            member_order = np.argsort(inverse, kind="stable")
            counts_b = np.bincount(inverse, minlength=u)
            starts = np.concatenate(([0], np.cumsum(counts_b)[:-1]))
            for uu in range(u):
                members = member_order[
                    starts[uu]: starts[uu] + counts_b[uu]
                ]
                node_rows = np.repeat(node_idx, per_node[uu])
                k = min(node_rows.shape[0], members.shape[0])
                if k:
                    out[members[:k]] = node_rows[:k]
            return out
        except Exception:  # noqa: BLE001 - greedy oracle must keep scaling
            logger.exception("autoscaler solve failed; first-fit fallback")
            SOLVER_FALLBACKS.inc()
            return self.pack(node_ids, rows, demands)


def pick_best_node_type(scores: TypeScore) -> int:
    """Lexicographic argmax over (gpu_ok, num_matching, min_util, mean_util);
    -1 if no type is feasible. Host-side: T is small."""
    scores = TypeScore(*(x.cpu().numpy() if isinstance(x, torch.Tensor) else x for x in scores))
    f = np.asarray(scores.feasible)
    if not f.any():
        return -1
    key = np.stack(
        [
            np.asarray(scores.gpu_ok, dtype=np.float64),
            np.asarray(scores.num_matching, dtype=np.float64),
            np.asarray(scores.min_util, dtype=np.float64),
            np.asarray(scores.mean_util, dtype=np.float64),
        ],
        axis=1,
    )
    key[~f] = -np.inf
    # np.lexsort sorts ascending by last key primary; we want max.
    order = np.lexsort((key[:, 3], key[:, 2], key[:, 1], key[:, 0]))
    return int(order[-1])
