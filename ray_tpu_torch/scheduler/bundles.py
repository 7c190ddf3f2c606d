"""Placement-group bundle bin-packing as torch programs.

Port of ``ray_tpu/scheduler/bundles.py``: PACK, SPREAD, STRICT_PACK and
STRICT_SPREAD over dense ``[nodes, resources]`` / ``[bundles, resources]``
tensors on the tensors' device (``cuda`` unless the caller passes
``device="cpu"``), scored by LeastResourceScorer (higher is better, -1 when
the node can't host the bundle, ties to the lowest node row). Bundle
priority order is sorted on the host (``sort_bundles``); the packing is the
device program. Sums over the resource axis are column-ordered and the
aggregate of STRICT_PACK is summed bundle after bundle, so the card and the
CPU give the same bits.
"""
from __future__ import annotations

import time as _time
from typing import NamedTuple

import numpy as np
import torch

from .hybrid import _INF, _colsum, _device_of, _rowsum, _t
from .resources import CPU, GPU, MEMORY, NUM_PREDEFINED, OBJECT_STORE_MEMORY

_EPS = 1e-5


def sort_bundles(bundles: np.ndarray) -> np.ndarray:
    """Return bundle indices in scheduling priority order (host-side)."""
    b, r = bundles.shape
    # np.lexsort: last key is primary. Priority: GPU, customs (in column
    # order), OBJ, MEM, CPU — all descending; final tie-break: original index.
    keys = [np.arange(b)]
    for col in (CPU, MEMORY, OBJECT_STORE_MEMORY):
        keys.append(-bundles[:, col])
    for col in range(r - 1, NUM_PREDEFINED - 1, -1):
        keys.append(-bundles[:, col])
    keys.append(-bundles[:, GPU])
    return np.lexsort(tuple(keys))


def _least_resource_score(avail_rows: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """LeastResourceScorer over all node rows: f32[N], -1 = can't host."""
    requested = demand > 0
    ok = torch.all(avail_rows >= demand[None, :] - _EPS, dim=1)
    pos = avail_rows > 0
    safe = torch.where(pos, avail_rows, torch.ones_like(avail_rows))
    terms = torch.where(requested[None, :] & pos, (avail_rows - demand[None, :]) / safe,
                        torch.zeros_like(avail_rows))
    score = _colsum(terms)
    return torch.where(ok, score, torch.full_like(score, -1.0))


class PackResult(NamedTuple):
    node: torch.Tensor       # int32[B] node row per bundle (sorted order), -1 on fail
    success: torch.Tensor    # bool scalar — all bundles placed
    avail_out: torch.Tensor  # f32[N,R] availability after placement (valid iff success)


def _inputs(totals, avail, alive, bundles, device):
    dev = _device_of(device, totals, avail)
    return (dev, _t(totals, dev, torch.float32), _t(avail, dev, torch.float32),
            _t(alive, dev, torch.bool), _t(bundles, dev, torch.float32))


def pack_bundles(totals, avail, alive, bundles, *, device=None) -> PackResult:
    """PACK strategy. ``bundles`` must already be priority-sorted: the best
    node for the first unplaced bundle is filled with every unplaced bundle
    that fits, in priority order, then retired; repeat."""
    dev, totals, avail, alive, bundles = _inputs(totals, avail, alive, bundles, device)
    n = totals.shape[0]
    b = bundles.shape[0]
    placed = torch.full((b,), -1, dtype=torch.int32, device=dev)
    cand = alive.clone()
    avail_run = avail
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    neg_inf = torch.full((n,), -_INF, dtype=torch.float32, device=dev)
    rows = torch.arange(b, device=dev)
    for _ in range(min(b, n)):
        unplaced = placed < 0
        any_un = torch.any(unplaced)
        j = torch.argmax(unplaced.to(torch.int32))  # first unplaced (priority order)
        d = bundles.index_select(0, j.view(1)).squeeze(0)
        score = _least_resource_score(avail_run, d)
        score = torch.where(cand & alive, score, neg_inf)
        best = torch.argmax(score)  # first max → lowest row on ties
        best_score = score.gather(0, best.view(1)).squeeze(0)
        ok = (best_score >= 0) & any_un & ~failed
        best32 = best.to(torch.int32)
        node_avail = avail_run.index_select(0, best.view(1)).squeeze(0)
        for idx in range(b):
            d2 = bundles[idx]
            can = ok & (placed[idx] < 0) & torch.all(node_avail >= d2 - _EPS)
            node_avail = torch.where(can, node_avail - d2, node_avail)
            placed = placed.index_copy(0, rows[idx:idx + 1],
                                       torch.where(can, best32, placed[idx]).view(1))
        avail_run = torch.where(ok, avail_run.index_copy(0, best.view(1), node_avail[None, :]),
                                avail_run)
        cand = cand.index_copy(0, best.view(1),
                               (cand.gather(0, best.view(1)) & ~ok))
        failed = failed | (any_un & (best_score < 0))
    success = torch.all(placed >= 0) & ~failed
    return PackResult(placed, success, avail_run)


def spread_bundles(totals, avail, alive, bundles, *, strict: bool = False,
                   device=None) -> PackResult:
    """SPREAD / STRICT_SPREAD: each bundle takes its best not-yet-used node;
    SPREAD falls back to an already-used one."""
    dev, totals, avail, alive, bundles = _inputs(totals, avail, alive, bundles, device)
    n = totals.shape[0]
    fresh = alive.clone()
    avail_run = avail
    neg_inf = torch.full((n,), -_INF, dtype=torch.float32, device=dev)
    nodes = []
    for i in range(bundles.shape[0]):
        d = bundles[i]
        score = _least_resource_score(avail_run, d)
        s1 = torch.where(fresh & alive, score, neg_inf)
        best1 = torch.argmax(s1)
        ok1 = s1.gather(0, best1.view(1)).squeeze(0) >= 0
        if strict:
            best, ok = best1, ok1
        else:
            s2 = torch.where(~fresh & alive, score, neg_inf)
            best2 = torch.argmax(s2)
            ok2 = s2.gather(0, best2.view(1)).squeeze(0) >= 0
            best = torch.where(ok1, best1, best2)
            ok = ok1 | ok2
        avail_run = torch.where(ok, avail_run.index_add(0, best.view(1), (-d)[None, :]),
                                avail_run)
        fresh = fresh.index_copy(0, best.view(1), fresh.gather(0, best.view(1)) & ~ok)
        node = torch.where(ok, best.to(torch.int32), torch.full((), -1, dtype=torch.int32,
                                                                  device=dev))
        nodes.append(node)
    nodes_t = (torch.stack(nodes) if nodes
               else torch.zeros((0,), dtype=torch.int32, device=dev))
    return PackResult(nodes_t, torch.all(nodes_t >= 0), avail_run)


def strict_pack_bundles(totals, avail, alive, bundles, *, device=None) -> PackResult:
    """STRICT_PACK: all bundles on one node (aggregate demand)."""
    dev, totals, avail, alive, bundles = _inputs(totals, avail, alive, bundles, device)
    agg = _rowsum(bundles)
    score = _least_resource_score(avail, agg)
    score = torch.where(alive, score, torch.full_like(score, -_INF))
    best = torch.argmax(score)
    ok = score.gather(0, best.view(1)).squeeze(0) >= 0
    b = bundles.shape[0]
    nodes = torch.where(ok, best.to(torch.int32).expand(b),
                        torch.full((b,), -1, dtype=torch.int32, device=dev))
    avail_out = torch.where(ok, avail.index_add(0, best.view(1), (-agg)[None, :]), avail)
    return PackResult(nodes, ok, avail_out)


def rows_to_avoid_mask(rows, alive) -> "np.ndarray | None":
    """Bool mask over the node axis from a list of row indices (None /
    out-of-range entries dropped). Returns None when nothing survives."""
    width = int(np.shape(alive)[0])
    rows = [
        int(r) for r in rows if r is not None and 0 <= int(r) < width
    ]
    if not rows:
        return None
    mask = np.zeros(width, dtype=bool)
    mask[np.asarray(rows)] = True
    return mask


def schedule_bundles_soft_avoid(
    totals, avail, alive, bundles, strategy, avoid_rows, device=None
):
    """SOFT anti-affinity placement: run with ``avoid_rows`` masked dead,
    then fall back to the full cluster when that is infeasible."""
    avoid = rows_to_avoid_mask(avoid_rows, alive)
    if avoid is not None:
        rows, success, left = schedule_bundles(
            totals, avail, alive, bundles, strategy, avoid=avoid, device=device
        )
        if success:
            return rows, success, left
    return schedule_bundles(totals, avail, alive, bundles, strategy, device=device)


def schedule_bundles(
    totals,
    avail,
    alive,
    bundles: np.ndarray,
    strategy: str = "PACK",
    avoid: "np.ndarray | None" = None,
    device=None,
):
    """Host entry point: sort, pad, dispatch to the strategy program, unsort.

    Returns (node_per_bundle int32[B] in *original* bundle order, success,
    avail_out). The bundle axis is padded to the next power of two with
    zero-demand rows, as the reference pads it for its jit cache: pads
    sort last, place for free and consume nothing, and success counts the
    real rows only.
    """
    bundles = np.asarray(bundles, dtype=np.float32)
    b = bundles.shape[0]
    if b == 0:
        return np.zeros(0, dtype=np.int32), True, avail
    t0 = _time.time()
    t0_mono = _time.perf_counter()
    dev = _device_of(device, totals, avail)
    alive_t = _t(alive, dev, torch.bool)
    if avoid is not None:
        alive_t = alive_t & ~_t(avoid, dev, torch.bool)
    order = sort_bundles(bundles)
    sorted_host = bundles[order]
    padded = 1 << max(0, (b - 1).bit_length())
    if padded > b:
        sorted_host = np.concatenate(
            [
                sorted_host,
                np.zeros((padded - b, bundles.shape[1]), dtype=np.float32),
            ]
        )
    if strategy == "PACK":
        res = pack_bundles(totals, avail, alive_t, sorted_host, device=dev)
    elif strategy == "SPREAD":
        res = spread_bundles(totals, avail, alive_t, sorted_host, strict=False, device=dev)
    elif strategy == "STRICT_SPREAD":
        res = spread_bundles(totals, avail, alive_t, sorted_host, strict=True, device=dev)
    elif strategy == "STRICT_PACK":
        res = strict_pack_bundles(totals, avail, alive_t, sorted_host, device=dev)
    else:
        raise ValueError(f"unknown placement strategy: {strategy}")
    nodes_sorted = res.node.cpu().numpy()[:b]
    nodes = np.full_like(nodes_sorted, -1)
    nodes[order] = nodes_sorted
    success = bool((nodes_sorted >= 0).all())
    # PG rounds are rare (create/reshape), so a span per call is cheap
    try:
        from ..util.tracing import SPANS

        SPANS.record(
            "pg_schedule",
            "scheduler",
            t0,
            _time.perf_counter() - t0_mono,
            pid="scheduler",
            strategy=strategy,
            bundles=int(b),
            success=success,
        )
    except Exception:  # noqa: BLE001 - observability only
        pass
    return nodes, success, res.avail_out
