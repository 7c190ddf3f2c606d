"""Metrics: typed instruments + Prometheus text exposition + federation.

Port of ``ray_tpu/util/metrics.py``, copied.

Analog of the reference's metric pipeline (src/ray/stats/metric.h →
open_telemetry_metric_recorder → per-node agent → Prometheus scrape,
python/ray/_private/metrics_agent.py): typed process-local instruments
with a /metrics text endpoint, plus the cluster-wide federation layer:
every process can snapshot its registry as TYPED deltas
(``DeltaExporter``), ship them over any channel, and a head-side
``FederatedRegistry`` merges them into one scrape body namespaced by
``node``/``role`` labels — histograms, buckets, HELP/TYPE and all.

Exposition strictness: label values are escaped per the Prometheus text
format spec (backslash, double-quote, newline), and
``validate_exposition`` is a strict parser for the full body (TYPE
before samples, no duplicate families or samples, cumulative histogram
buckets with ``+Inf``) — the scrape-validity contract tier-1 enforces.
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "_Metric"] = {}


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, quote,
    newline. An unescaped ``"`` or newline corrupts the whole scrape."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(s: str) -> str:
    """HELP-line escaping (backslash + newline per the spec)."""
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}
        with _registry_lock:
            _registry[name] = self

    def _key(self, labels: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        labels = labels or {}
        return tuple(str(labels.get(k, "")) for k in self.label_names)

    def _fmt_labels(self, key: Tuple[str, ...]) -> str:
        if not self.label_names:
            return ""
        pairs = ",".join(
            f'{k}="{_escape_label_value(v)}"'
            for k, v in zip(self.label_names, key)
        )
        return "{" + pairs + "}"

    def samples(self) -> List[str]:
        with self._lock:
            return [
                f"{self.name}{self._fmt_labels(k)} {v}"
                for k, v in self._values.items()
            ] or [f"{self.name} 0"]

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        """Current value for one label set (0.0 if never touched) —
        programmatic readout for tests and debug surfaces, sparing them a
        prometheus_text() parse."""
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def values_by_label(self) -> Dict[str, float]:
        """Every label set's current value, keyed by the joined label
        values (e.g. ``{"queued": 3.0, "running": 1.0}`` for a
        single-label counter) — the per-dimension readout debug surfaces
        like head QueryState embed without parsing exposition text."""
        with self._lock:
            return {",".join(k): v for k, v in self._values.items()}

    def dump(self) -> dict:
        """Typed cumulative snapshot (federation wire form): plain
        dicts/lists only, so it rides any RPC payload."""
        with self._lock:
            return {
                "name": self.name,
                "kind": self.kind,
                "help": self.description,
                "labels": list(self.label_names),
                "values": [[list(k), float(v)] for k, v in self._values.items()],
            }


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, labels: Optional[Dict] = None) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, labels: Optional[Dict] = None) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, labels: Optional[Dict] = None) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def dec(self, value: float = 1.0, labels: Optional[Dict] = None) -> None:
        self.inc(-value, labels)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries: Sequence[float] = (),
                 label_names: Sequence[str] = ()):
        super().__init__(name, description, label_names)
        self.boundaries = sorted(boundaries) or [
            0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60,
        ]
        self._buckets: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._counts: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, labels: Optional[Dict] = None) -> None:
        k = self._key(labels)
        with self._lock:
            b = self._buckets.setdefault(
                k, [0] * (len(self.boundaries) + 1)
            )
            b[bisect_right(self.boundaries, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1

    def summary(self, labels: Optional[Dict[str, str]] = None) -> Dict[str, float]:
        """(count, sum, mean, p50, p99) for one label set — observability
        surfaces (agent DebugState, head QueryState, bench) read latency
        aggregates here. Percentiles are bucket-interpolated estimates."""
        k = self._key(labels)
        with self._lock:
            count = self._counts.get(k, 0)
            total = self._sums.get(k, 0.0)
            buckets = list(self._buckets.get(k, ()))
        return {
            "count": count,
            "sum": total,
            "mean": (total / count) if count else 0.0,
            "p50": percentile_from_buckets(self.boundaries, buckets, 0.50),
            "p99": percentile_from_buckets(self.boundaries, buckets, 0.99),
        }

    def buckets_snapshot(
        self, labels: Optional[Dict[str, str]] = None
    ) -> List[int]:
        """Copy of the per-bucket (disjoint, NOT Prometheus-cumulative)
        counts, len(boundaries)+1 — callers diff two snapshots to get
        percentiles over a window (``percentile_from_buckets``, which
        expects this disjoint form)."""
        k = self._key(labels)
        with self._lock:
            return list(self._buckets.get(k, [0] * (len(self.boundaries) + 1)))

    def samples(self) -> List[str]:
        out: List[str] = []
        with self._lock:
            for k, buckets in self._buckets.items():
                cum = 0
                base = self._fmt_labels(k)[1:-1] if self.label_names else ""
                for bound, count in zip(self.boundaries, buckets):
                    cum += count
                    lbl = f'le="{bound}"' + (f",{base}" if base else "")
                    out.append(f"{self.name}_bucket{{{lbl}}} {cum}")
                cum += buckets[-1]
                lbl = 'le="+Inf"' + (f",{base}" if base else "")
                out.append(f"{self.name}_bucket{{{lbl}}} {cum}")
                tail = "{" + base + "}" if base else ""
                out.append(f"{self.name}_sum{tail} {self._sums[k]}")
                out.append(f"{self.name}_count{tail} {self._counts[k]}")
        return out

    def dump(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "kind": self.kind,
                "help": self.description,
                "labels": list(self.label_names),
                "boundaries": [float(b) for b in self.boundaries],
                "rows": [
                    [
                        list(k),
                        list(b),
                        float(self._sums.get(k, 0.0)),
                        int(self._counts.get(k, 0)),
                    ]
                    for k, b in self._buckets.items()
                ],
            }


def percentile_from_buckets(
    boundaries: Sequence[float], buckets: Sequence[int], q: float
) -> float:
    """Bucket-interpolated percentile estimate (Prometheus
    histogram_quantile semantics): linear within the target bucket, the
    last (+Inf) bucket reports its lower bound. 0.0 on no observations."""
    total = sum(buckets)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, count in enumerate(buckets):
        if count <= 0:
            continue
        if cum + count >= rank:
            lo = boundaries[i - 1] if i > 0 else 0.0
            if i >= len(boundaries):  # +Inf bucket
                return float(boundaries[-1])
            hi = boundaries[i]
            frac = (rank - cum) / count
            return float(lo + (hi - lo) * frac)
        cum += count
    return float(boundaries[-1])


def sync_counter(name: str, value: float, description: str = "") -> None:
    """Publish an externally-accumulated total as a registry counter.

    Hot paths that cannot afford a locked ``Counter.inc`` per event (e.g.
    the wire-framing counters) accumulate plain ints and sync the
    absolute value here from observability surfaces."""
    with _registry_lock:
        m = _registry.get(name)
    if m is None:
        # Counter.__init__ self-registers (taking _registry_lock), so
        # create outside the lock, then settle the race on the object
        # the registry actually holds — a value written to a losing
        # duplicate would vanish from every scrape
        candidate = Counter(name, description)
        with _registry_lock:
            m = _registry.setdefault(name, candidate)
    with m._lock:
        m._values[m._key(None)] = float(value)


def sync_gauge(name: str, value: float, description: str = "") -> None:
    """``sync_counter``'s gauge twin: publish an externally-computed
    level (ring fill, arena bytes) from an observability tick."""
    with _registry_lock:
        m = _registry.get(name)
    if m is None:
        candidate = Gauge(name, description)
        with _registry_lock:
            m = _registry.setdefault(name, candidate)
    with m._lock:
        m._values[m._key(None)] = float(value)


def prometheus_text() -> str:
    """Render every registered metric in Prometheus exposition format."""
    lines: List[str] = []
    with _registry_lock:
        metrics = list(_registry.values())
    for m in metrics:
        if m.description:
            lines.append(f"# HELP {m.name} {_escape_help(m.description)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        lines.extend(m.samples())
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# federation: typed snapshot → delta ship → head-side merge
# ---------------------------------------------------------------------------


def registry_dump() -> List[dict]:
    """Typed cumulative snapshot of the whole process registry (the
    federation wire form; see ``_Metric.dump``)."""
    with _registry_lock:
        metrics = list(_registry.values())
    return [m.dump() for m in metrics]


class DeltaExporter:
    """Stateful registry snapshotter producing TYPED deltas.

    ``collect()`` diffs the current registry against the previous call:
    counters and histogram rows ship as deltas (so the receiving
    accumulator stays monotone across sender restarts — a reset sender
    simply ships its fresh totals as the next delta), gauges ship
    absolutely whenever they changed. Records with nothing to report are
    dropped, so an idle process ships (nearly) nothing."""

    def __init__(self):
        self._prev_vals: Dict[str, Dict[tuple, float]] = {}
        self._prev_rows: Dict[str, Dict[tuple, tuple]] = {}

    def collect(self) -> List[dict]:
        out: List[dict] = []
        for rec in registry_dump():
            name = rec["name"]
            if rec["kind"] == "histogram":
                prev = self._prev_rows.get(name, {})
                cur: Dict[tuple, tuple] = {}
                rows = []
                for key_l, buckets, total, count in rec["rows"]:
                    key = tuple(key_l)
                    cur[key] = (tuple(buckets), total, count)
                    pb, ps, pc = prev.get(
                        key, ((0,) * len(buckets), 0.0, 0)
                    )
                    if len(pb) != len(buckets) or count < pc:
                        # boundaries changed or sender reset: ship totals
                        pb, ps, pc = (0,) * len(buckets), 0.0, 0
                    db = [b - p for b, p in zip(buckets, pb)]
                    if count - pc <= 0 and not any(db):
                        continue
                    rows.append([key_l, db, total - ps, count - pc])
                self._prev_rows[name] = cur
                if rows:
                    out.append({**rec, "rows": rows})
                continue
            prev_v = self._prev_vals.get(name, {})
            cur_v: Dict[tuple, float] = {}
            vals = []
            for key_l, v in rec["values"]:
                key = tuple(key_l)
                cur_v[key] = v
                if rec["kind"] == "counter":
                    p = prev_v.get(key, 0.0)
                    d = v - p if v >= p else v  # reset → ship totals
                    if d != 0.0:
                        vals.append([key_l, d])
                else:  # gauge (and untyped): absolute, on change
                    if key not in prev_v or prev_v[key] != v:
                        vals.append([key_l, v])
            self._prev_vals[name] = cur_v
            if vals:
                out.append({**rec, "values": vals})
        return out


class _FedMetric:
    __slots__ = ("kind", "help", "labels", "extra", "boundaries",
                 "values", "rows")

    def __init__(self, kind: str, help_: str, labels: Sequence[str]):
        self.kind = kind
        self.help = help_
        self.labels = tuple(labels)
        # which of node/role are APPENDED (a metric already labeled
        # "node" keeps its own — no duplicate label names)
        self.extra = tuple(
            x for x in ("node", "role") if x not in self.labels
        )
        self.boundaries: List[float] = []
        self.values: Dict[tuple, float] = {}
        self.rows: Dict[tuple, list] = {}  # key -> [buckets, sum, count]

    @property
    def all_labels(self) -> tuple:
        return self.labels + self.extra


class FederatedRegistry:
    """Head-side merge target for shipped registry deltas.

    Every sample is namespaced by ``node``/``role`` labels (appended
    unless the metric already carries them). Counters and histograms
    ACCUMULATE deltas — monotone across sender restarts; gauges replace.
    ``replace=True`` applies a CUMULATIVE snapshot instead (used for the
    head's own registry at scrape time: the head re-snapshots rather
    than shipping deltas to itself). Series from dead nodes linger by
    design — counters are history; stale gauges date themselves by the
    node's liveness in /api/nodes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _FedMetric] = {}

    def _coerce_key(
        self, m: _FedMetric, rec_labels: Sequence[str], key: Sequence[str],
        node: str, role: str,
    ) -> tuple:
        if tuple(rec_labels) == m.labels:
            base = tuple(str(k) for k in key)
        else:  # schema drift across versions: re-key by label name
            by_name = dict(zip(rec_labels, key))
            base = tuple(str(by_name.get(k, "")) for k in m.labels)
        extra = {"node": node, "role": role}
        return base + tuple(extra[x] for x in m.extra)

    def apply(self, node: str, role: str, records: List[dict],
              replace: bool = False) -> None:
        with self._lock:
            for rec in records:
                name = rec.get("name")
                if not name:
                    continue
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = _FedMetric(
                        rec.get("kind", "untyped"),
                        rec.get("help", ""),
                        rec.get("labels", ()),
                    )
                if not m.help and rec.get("help"):
                    m.help = rec["help"]
                if rec.get("kind") == "histogram":
                    bounds = [float(b) for b in rec.get("boundaries", ())]
                    if m.boundaries and m.boundaries != bounds:
                        # boundary drift (version skew): adopt the new
                        # grid, dropping incompatible accumulated rows
                        m.rows = {
                            k: v for k, v in m.rows.items()
                            if len(v[0]) == len(bounds) + 1
                        }
                    m.boundaries = bounds
                    for key_l, db, dsum, dcount in rec.get("rows", ()):
                        key = self._coerce_key(
                            m, rec.get("labels", ()), key_l, node, role
                        )
                        row = m.rows.get(key)
                        if row is None or replace or len(row[0]) != len(db):
                            m.rows[key] = [list(db), float(dsum), int(dcount)]
                        else:
                            row[0] = [a + b for a, b in zip(row[0], db)]
                            row[1] += float(dsum)
                            row[2] += int(dcount)
                    continue
                for key_l, v in rec.get("values", ()):
                    key = self._coerce_key(
                        m, rec.get("labels", ()), key_l, node, role
                    )
                    if m.kind == "counter" and not replace:
                        m.values[key] = m.values.get(key, 0.0) + float(v)
                    else:
                        m.values[key] = float(v)

    def text(self) -> str:
        """One parser-valid exposition body: HELP/TYPE once per family,
        every sample labeled, histograms rendered cumulative with +Inf."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    lines.append(f"# HELP {name} {_escape_help(m.help)}")
                lines.append(f"# TYPE {name} {m.kind}")
                names = m.all_labels

                def fmt(key: tuple, extra_pair: str = "") -> str:
                    pairs = [
                        f'{k}="{_escape_label_value(v)}"'
                        for k, v in zip(names, key)
                    ]
                    if extra_pair:
                        pairs.insert(0, extra_pair)
                    return "{" + ",".join(pairs) + "}" if pairs else ""

                if m.kind == "histogram":
                    inf_pair = 'le="+Inf"'
                    for key, (buckets, total, count) in sorted(
                        m.rows.items()
                    ):
                        cum = 0
                        for bound, c in zip(m.boundaries, buckets):
                            cum += c
                            le_pair = 'le="' + str(bound) + '"'
                            lines.append(
                                f"{name}_bucket{fmt(key, le_pair)} {cum}"
                            )
                        cum += buckets[-1] if buckets else 0
                        lines.append(
                            f"{name}_bucket{fmt(key, inf_pair)} {cum}"
                        )
                        lines.append(f"{name}_sum{fmt(key)} {total}")
                        lines.append(f"{name}_count{fmt(key)} {count}")
                    continue
                if not m.values:
                    continue
                for key, v in sorted(m.values.items()):
                    lines.append(f"{name}{fmt(key)} {v}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# strict text-format parser (the scrape-validity gate)
# ---------------------------------------------------------------------------


def _parse_labels(s: str, line: str) -> Tuple[str, ...]:
    """Parse a ``{k="v",...}`` label block (handles spec escapes) into a
    canonical sorted (k, v) tuple. Raises ValueError on malformation."""
    out = []
    i = 0
    while i < len(s):
        j = s.index("=", i)
        k = s[i:j]
        if not k or not all(c.isalnum() or c == "_" for c in k):
            raise ValueError(f"bad label name {k!r} in: {line}")
        if j + 1 >= len(s) or s[j + 1] != '"':
            raise ValueError(f"unquoted label value in: {line}")
        i = j + 2
        val = []
        while True:
            if i >= len(s):
                raise ValueError(f"unterminated label value in: {line}")
            c = s[i]
            if c == "\\":
                if i + 1 >= len(s):
                    raise ValueError(f"dangling escape in: {line}")
                nxt = s[i + 1]
                if nxt not in ('"', "\\", "n"):
                    raise ValueError(f"bad escape \\{nxt} in: {line}")
                val.append("\n" if nxt == "n" else nxt)
                i += 2
                continue
            if c == "\n":
                raise ValueError(f"raw newline in label value: {line}")
            if c == '"':
                i += 1
                break
            val.append(c)
            i += 1
        out.append((k, "".join(val)))
        if i < len(s):
            if s[i] != ",":
                raise ValueError(f"junk after label value in: {line}")
            i += 1
    if len(dict(out)) != len(out):
        raise ValueError(f"duplicate label name in: {line}")
    return tuple(sorted(out))


def _label_block_end(line: str, start: int, ctx: str) -> int:
    """Index of the ``}`` closing a label block opened at ``start`` —
    quote-aware: a ``}`` INSIDE a quoted label value (legal unescaped
    per the spec) must not terminate the block."""
    i = start
    in_quotes = False
    while i < len(line):
        c = line[i]
        if in_quotes:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_quotes = False
        elif c == '"':
            in_quotes = True
        elif c == "}":
            return i
        i += 1
    raise ValueError(f"unterminated label block in: {ctx}")


def validate_exposition(text: str) -> Dict[str, dict]:
    """Strict Prometheus text-format validation of a whole scrape body.

    Enforced: TYPE exactly once per family and BEFORE its samples,
    families contiguous (no interleaving), every sample belongs to a
    TYPEd family (histogram ``_bucket``/``_sum``/``_count`` suffixes map
    to their base), labels escaped/parsable, float values, no duplicate
    (name, labelset) sample, and per-label-group histogram buckets
    cumulative non-decreasing with a ``+Inf`` bucket equal to ``_count``.
    Returns {family: {"kind", "samples": [(name, labels, value)]}};
    raises ValueError on the first malformed line."""
    if not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    families: Dict[str, dict] = {}
    closed: set = set()
    current: Optional[str] = None
    seen_samples: set = set()

    def family_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = name[: -len(suffix)]
                fam = families.get(base)
                if fam is not None and fam["kind"] == "histogram":
                    return base
        return name

    for line in text.splitlines():
        if not line.strip():
            raise ValueError("blank line in exposition")
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"bad comment line: {line}")
            name = parts[2]
            if parts[1] == "TYPE":
                kind = parts[3].strip() if len(parts) > 3 else ""
                if kind not in ("counter", "gauge", "histogram",
                                "summary", "untyped"):
                    raise ValueError(f"bad TYPE kind: {line}")
                if name in families:
                    raise ValueError(f"duplicate TYPE for {name}")
                if current is not None:
                    closed.add(current)
                families[name] = {"kind": kind, "samples": []}
                current = name
            continue
        # sample line
        rest = line
        if "{" in rest.split(" ")[0]:
            name = rest[: rest.index("{")]
            close = _label_block_end(rest, rest.index("{") + 1, line)
            labels = _parse_labels(rest[rest.index("{") + 1: close], line)
            valpart = rest[close + 1:].strip()
        else:
            name, _, valpart = rest.partition(" ")
            labels = ()
            valpart = valpart.strip()
        if not valpart or " " in valpart:
            raise ValueError(f"bad sample value (timestamp?): {line}")
        try:
            value = float(valpart)
        except ValueError:
            raise ValueError(f"non-float sample value: {line}")
        fam = family_of(name)
        if fam not in families:
            raise ValueError(f"sample before/without TYPE: {line}")
        if fam in closed:
            raise ValueError(f"family {fam} interleaved: {line}")
        if current != fam:
            if current is not None:
                closed.add(current)
            current = fam
        if (name, labels) in seen_samples:
            raise ValueError(f"duplicate sample: {line}")
        seen_samples.add((name, labels))
        families[fam]["samples"].append((name, labels, value))

    # histogram shape checks
    for fam, info in families.items():
        if info["kind"] != "histogram" or not info["samples"]:
            continue
        groups: Dict[tuple, dict] = {}
        for name, labels, value in info["samples"]:
            base = tuple(kv for kv in labels if kv[0] != "le")
            g = groups.setdefault(base, {"buckets": [], "sum": None,
                                         "count": None})
            if name == fam + "_bucket":
                le = dict(labels).get("le")
                if le is None:
                    raise ValueError(f"{fam}_bucket without le label")
                g["buckets"].append((le, value))
            elif name == fam + "_sum":
                g["sum"] = value
            elif name == fam + "_count":
                g["count"] = value
        for base, g in groups.items():
            if not g["buckets"]:
                raise ValueError(f"{fam}: histogram group without buckets")
            if g["sum"] is None or g["count"] is None:
                raise ValueError(f"{fam}: missing _sum/_count")
            les = [le for le, _ in g["buckets"]]
            if les[-1] != "+Inf":
                raise ValueError(f"{fam}: last bucket must be +Inf")
            vals = [v for _, v in g["buckets"]]
            if any(b > a for b, a in zip(vals, vals[1:])):
                raise ValueError(f"{fam}: buckets not cumulative")
            if vals[-1] != g["count"]:
                raise ValueError(f"{fam}: +Inf bucket != _count")
    return families


# ---------------------------------------------------------------------------
# scrape endpoint
# ---------------------------------------------------------------------------


class MetricsServer(int):
    """``start_metrics_server``'s handle: an int (the bound port, for
    backward compatibility with callers formatting it into URLs) that
    also owns the server — ``close()`` shuts the listener down and joins
    its thread, so suites stop leaking ThreadingHTTPServer threads."""

    def __new__(cls, port: int, server, thread):
        self = super().__new__(cls, port)
        self._server = server
        self._thread = thread
        return self

    @property
    def port(self) -> int:
        return int(self)

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # context-manager sugar for tests
    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(
    port: int = 0, render=prometheus_text
) -> MetricsServer:
    """Prometheus scrape endpoint (GET /metrics). Returns a
    ``MetricsServer`` handle (int-compatible port) with ``close()``.
    ``render`` defaults to the process-local registry; pass a federated
    renderer to serve a merged body."""
    import threading as _t
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    thread = _t.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return MetricsServer(server.server_address[1], server, thread)


def clear_registry() -> None:
    with _registry_lock:
        _registry.clear()
