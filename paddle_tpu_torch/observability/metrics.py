"""Metrics registry: Counter / Gauge / Histogram with labeled series
(counterpart: paddle_tpu/observability/metrics.py, copied, not imported).

The primitives are the Prometheus trio: ``Counter`` (monotonic totals),
``Gauge`` (last-written levels) and ``Histogram`` (fixed log-spaced
buckets, since decode latencies span 0.1 ms to minutes).

1. **One lock.**  ``LOCK`` (an RLock) guards every series mutation.
2. **Near-zero cost when disabled.**  ``disable()`` turns every
   ``inc``/``set``/``observe`` into one dict lookup.
3. **Views, not migrations.**  ``decode_stats`` keeps its own counters;
   the registry renders it through a view evaluated at collection time.

Exporters (`prometheus_text`, `snapshot`) render one merged collection:
first-class series and every view.  Where the JAX package wraps ``LOCK``
in its sanitizer's tracked lock, the port uses the plain RLock.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.sanitizer import TrackedLock as _TrackedLock

__all__ = [
    "LOCK", "Counter", "Gauge", "Histogram", "MetricRegistry", "Sample",
    "DEFAULT_TIME_BUCKETS", "log_buckets", "default_registry",
    "enable", "disable", "enabled",
]

# THE telemetry lock: every registry series mutation happens under it
# a TrackedLock under the JAX package's name, so FLAGS_sanitize
# records acquisition order (analysis.sanitizer)
LOCK = _TrackedLock(threading.RLock(), "observability.LOCK")

# enabled is a module-level switch (not per-registry) so the hot-path
# check is one dict lookup shared by metrics and span tracing
_state = {"enabled": True}


def enable():
    with LOCK:
        _state["enabled"] = True


def disable():
    with LOCK:
        _state["enabled"] = False


def enabled() -> bool:
    return _state["enabled"]


def log_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` log-spaced bucket upper bounds: start, start*factor, ..."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"need start > 0, factor > 1, count >= 1; got "
            f"({start}, {factor}, {count})")
    out = []
    b = float(start)
    for _ in range(count):
        out.append(b)
        b *= factor
    return tuple(out)


# 0.1ms .. ~209s in powers of two — covers a single decode step
# through a multi-minute batch e2e with ~constant relative resolution
DEFAULT_TIME_BUCKETS = log_buckets(1e-4, 2.0, 22)

# runaway-label backstop: a label accidentally carrying a request id
# would otherwise grow series without bound
MAX_SERIES_PER_METRIC = 4096


class Sample:
    """One metric's renderable state at collection time (views return
    these directly; first-class metrics build them under LOCK)."""

    __slots__ = ("name", "kind", "help", "label_names", "series")

    def __init__(self, name, kind, help, label_names, series):
        self.name = name
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.help = help
        self.label_names = tuple(label_names)
        # series: list of (label_values_tuple, value); histogram value =
        # {"buckets": tuple, "counts": list, "sum": float, "count": int}
        self.series = series


class _Metric:
    __slots__ = ("name", "help", "label_names", "_series", "kind")

    def __init__(self, name, help, label_names):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: Dict[tuple, object] = {}

    def _labels_key(self, labels: dict) -> tuple:
        names = self.label_names
        if len(labels) != len(names):
            raise ValueError(
                f"{self.name}: expected labels {names}, "
                f"got {tuple(sorted(labels))}")
        try:
            # one pass: a wrong label name KeyErrors here instead of
            # paying a separate membership scan on every hot-path bump
            key = tuple(str(labels[k]) for k in names)
        except KeyError:
            raise ValueError(
                f"{self.name}: expected labels {names}, "
                f"got {tuple(sorted(labels))}") from None
        if key not in self._series and \
                len(self._series) >= MAX_SERIES_PER_METRIC:
            raise ValueError(
                f"{self.name}: label cardinality exceeds "
                f"{MAX_SERIES_PER_METRIC} series — a label is carrying "
                f"an unbounded value (request id, timestamp, ...)")
        return key

    def clear(self):
        with LOCK:
            self._series.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, value=1, **labels):
        if not _state["enabled"]:
            return
        if value < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with LOCK:
            key = self._labels_key(labels)
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels) -> float:
        with LOCK:
            return self._series.get(self._labels_key(labels), 0)

    def _reset(self):
        # LOCK is an RLock: safe both standalone and under
        # MetricRegistry.reset's own hold
        with LOCK:
            for k in self._series:
                self._series[k] = 0

    def _collect(self):
        return Sample(self.name, self.kind, self.help, self.label_names,
                      sorted(self._series.items()))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value, **labels):
        if not _state["enabled"]:
            return
        with LOCK:
            self._series[self._labels_key(labels)] = float(value)

    def inc(self, value=1, **labels):
        if not _state["enabled"]:
            return
        with LOCK:
            key = self._labels_key(labels)
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with LOCK:
            return self._series.get(self._labels_key(labels), 0.0)

    def _reset(self):
        with LOCK:
            for k in self._series:
                self._series[k] = 0.0

    _collect = Counter._collect


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets):
        self.counts = [0] * (n_buckets + 1)  # +1: overflow (+Inf) slot
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"
    __slots__ = ("buckets",)

    def __init__(self, name, help, label_names, buckets):
        super().__init__(name, help, label_names)
        b = tuple(float(x) for x in (buckets or DEFAULT_TIME_BUCKETS))
        if list(b) != sorted(set(b)):
            raise ValueError(f"{name}: buckets must strictly increase")
        self.buckets = b

    def observe(self, value, **labels):
        if not _state["enabled"]:
            return
        v = float(value)
        with LOCK:
            key = self._labels_key(labels)
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            # bisect_left: v == bound lands in the bucket whose upper
            # bound IS v (le semantics); v > last bound -> overflow slot
            s.counts[bisect_left(self.buckets, v)] += 1
            s.sum += v
            s.count += 1

    def observe_batch(self, items):
        """Observe several labeled values in ONE lock round —
        ``items`` is an iterable of (labels_dict, value).  The per-step
        phase breakdown (observability.flight) lands 5-8 observations
        per engine step; paying the lock once
        instead of per phase keeps the recorder inside its
        always-cheap budget."""
        if not _state["enabled"]:
            return
        with LOCK:
            for labels, value in items:
                v = float(value)
                key = self._labels_key(labels)
                s = self._series.get(key)
                if s is None:
                    s = self._series[key] = _HistSeries(len(self.buckets))
                s.counts[bisect_left(self.buckets, v)] += 1
                s.sum += v
                s.count += 1

    def quantile(self, q: float, **labels) -> float:
        """Estimate the ``q``-quantile (0..1) of one labeled series
        from its bucket counts — the Prometheus `histogram_quantile`
        estimator, in-process, so latency-threshold alert rules
        (observability.alerts) can gate on e.g. p99 step time without
        a scrape round-trip.

        Linear interpolation WITHIN the winning bucket (observations
        are assumed uniform across it, the standard estimator error);
        the first bucket interpolates from 0; a quantile landing in
        the +Inf overflow bucket CLAMPS to the largest finite bound —
        the estimator cannot know how far past it the tail really
        goes, and a clamped answer keeps thresholds monotone.  An
        empty series returns 0.0 (no evidence, no alert)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"{self.name}: quantile must be in "
                             f"[0, 1], got {q}")
        with LOCK:
            s = self._series.get(self._labels_key(labels))
            if s is None or s.count == 0:
                return 0.0
            counts = list(s.counts)
            total = s.count
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.buckets):
                    return self.buckets[-1]  # overflow: clamp
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - cum) / c
                return lo + min(max(frac, 0.0), 1.0) * (hi - lo)
            cum += c
        return self.buckets[-1]  # pragma: no cover - defensive

    def series_state(self, **labels) -> dict:
        """Snapshot one labeled series: per-bucket (non-cumulative)
        counts, sum, count."""
        with LOCK:
            s = self._series.get(self._labels_key(labels))
            if s is None:
                return {"buckets": self.buckets,
                        "counts": [0] * (len(self.buckets) + 1),
                        "sum": 0.0, "count": 0}
            return {"buckets": self.buckets, "counts": list(s.counts),
                    "sum": s.sum, "count": s.count}

    def _reset(self):
        with LOCK:
            for s in self._series.values():
                s.counts = [0] * (len(self.buckets) + 1)
                s.sum = 0.0
                s.count = 0

    def _collect(self):
        series = [(k, {"buckets": self.buckets, "counts": list(s.counts),
                       "sum": s.sum, "count": s.count})
                  for k, s in sorted(self._series.items())]
        return Sample(self.name, self.kind, self.help, self.label_names,
                      series)


def _fmt(v) -> str:
    if isinstance(v, float):
        # exposition-format spellings for non-finite values FIRST:
        # int(inf) raises, and Prometheus wants +Inf/-Inf/NaN — a
        # gauge legitimately set to inf (a ratio with a zero
        # denominator) must not crash the whole scrape
        if v != v:
            return "NaN"
        if v == float("inf"):
            return "+Inf"
        if v == float("-inf"):
            return "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return format(v, ".10g")
    return str(v)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _label_str(names, values, extra=()) -> str:
    parts = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    parts += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricRegistry:
    """Holds metrics + view callables; renders merged exports."""

    def __init__(self):
        self._metrics: "Dict[str, _Metric]" = {}
        self._views: List[Callable[[], List[Sample]]] = []

    # -- registration --------------------------------------------------------
    def _register(self, cls, name, help, labels, **kw):
        with LOCK:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.label_names}")
                return m
            m = cls(name, help, labels, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets)

    def register_view(self, fn: Callable[[], List[Sample]]):
        """Register a callable evaluated at every collection — the
        bridge for pre-existing telemetry (dispatch_stats,
        decode_stats) that keeps its own storage and public API."""
        with LOCK:
            if fn not in self._views:
                self._views.append(fn)

    # -- lifecycle -----------------------------------------------------------
    def reset(self):
        """Zero every first-class series (label sets survive — a
        scrape after reset sees the same series at zero, the invariant
        tests pin).  Views are NOT reset: their owners expose their own
        reset APIs (``reset_dispatch_stats``, ``decode_stats(reset=)``)."""
        with LOCK:
            for m in self._metrics.values():
                m._reset()

    def retire_label(self, label: str, value) -> int:
        """DELETE every labeled series whose ``label`` equals ``value``
        across all first-class metrics (views own their storage and are
        untouched).  This is how a retired engine id leaves the scrape
        surface entirely — `reset` keeps label sets alive by contract,
        so a dead engine's gauges would otherwise read stale levels
        forever (and grow the series set one abandoned engine at a
        time).  Returns the number of series retired."""
        value = str(value)
        retired = 0
        with LOCK:
            for m in self._metrics.values():
                if label not in m.label_names:
                    continue
                i = m.label_names.index(label)
                dead = [k for k in m._series if k[i] == value]
                for k in dead:
                    del m._series[k]
                retired += len(dead)
        return retired

    # -- collection / export -------------------------------------------------
    def collect(self) -> List[Sample]:
        with LOCK:
            samples = [m._collect() for m in self._metrics.values()]
        for fn in list(self._views):
            samples.extend(fn())
        samples.sort(key=lambda s: s.name)
        return samples

    def prometheus_text(self) -> str:
        """Prometheus text exposition format, deterministic ordering."""
        lines = []
        for s in self.collect():
            if s.help:
                lines.append(f"# HELP {s.name} "
                             + s.help.replace("\\", r"\\")
                             .replace("\n", r"\n"))
            lines.append(f"# TYPE {s.name} {s.kind}")
            for values, v in s.series:
                if s.kind == "histogram":
                    cum = 0
                    for bound, c in zip(v["buckets"], v["counts"]):
                        cum += c
                        lbl = _label_str(s.label_names, values,
                                         extra=[("le", _fmt(bound))])
                        lines.append(f"{s.name}_bucket{lbl} {cum}")
                    lbl = _label_str(s.label_names, values,
                                     extra=[("le", "+Inf")])
                    lines.append(f"{s.name}_bucket{lbl} {v['count']}")
                    base = _label_str(s.label_names, values)
                    lines.append(f"{s.name}_sum{base} {_fmt(v['sum'])}")
                    lines.append(f"{s.name}_count{base} {v['count']}")
                else:
                    lbl = _label_str(s.label_names, values)
                    lines.append(f"{s.name}{lbl} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Structured JSON-serializable snapshot of every series (same
        merged collection Prometheus renders)."""
        out = {}
        for s in self.collect():
            series = []
            for values, v in s.series:
                labels = dict(zip(s.label_names, values))
                if s.kind == "histogram":
                    series.append({"labels": labels,
                                   "buckets": list(v["buckets"]),
                                   "counts": list(v["counts"]),
                                   "sum": v["sum"], "count": v["count"]})
                else:
                    series.append({"labels": labels, "value": v})
            out[s.name] = {"type": s.kind, "help": s.help,
                           "labels": list(s.label_names),
                           "series": series}
        return out


_default = MetricRegistry()


def default_registry() -> MetricRegistry:
    return _default
