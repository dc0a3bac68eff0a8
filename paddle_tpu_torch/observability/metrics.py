"""Metrics registry: Counter / Gauge / Histogram with labeled series
(counterpart: paddle_tpu/observability/metrics.py, copied and cut to
what the serving stack of this port records).

One lock (``LOCK``, an RLock) guards every series mutation.  ``disable``
turns every ``inc``/``set``/``observe`` into one dict lookup.  The JAX
package's registry views, Prometheus text export and sanitizer-tracked
lock belong to the ops plane, which the port has not brought over.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Optional, Tuple

__all__ = ["LOCK", "Counter", "Gauge", "Histogram", "MetricRegistry",
           "DEFAULT_TIME_BUCKETS", "log_buckets", "default_registry",
           "enable", "disable", "enabled"]

LOCK = threading.RLock()

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


# 0.1 ms .. ~209 s in powers of two
DEFAULT_TIME_BUCKETS = log_buckets(1e-4, 2.0, 22)

# a label accidentally carrying a request id would grow without bound
MAX_SERIES_PER_METRIC = 4096


class _Metric:
    def __init__(self, name, help, label_names):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: Dict[tuple, object] = {}

    def _labels_key(self, labels: dict) -> tuple:
        names = self.label_names
        try:
            if len(labels) != len(names):
                raise KeyError
            key = tuple(str(labels[k]) for k in names)
        except KeyError:
            raise ValueError(
                f"{self.name}: expected labels {names}, "
                f"got {tuple(sorted(labels))}") from None
        if key not in self._series and \
                len(self._series) >= MAX_SERIES_PER_METRIC:
            raise ValueError(
                f"{self.name}: label cardinality exceeds "
                f"{MAX_SERIES_PER_METRIC} series")
        return key


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
        for k in self._series:
            self._series[k] = 0


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value, **labels):
        if not _state["enabled"]:
            return
        with LOCK:
            self._series[self._labels_key(labels)] = float(value)

    def value(self, **labels) -> float:
        with LOCK:
            return self._series.get(self._labels_key(labels), 0.0)

    def _reset(self):
        for k in self._series:
            self._series[k] = 0.0


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets):
        self.counts = [0] * (n_buckets + 1)  # +1: overflow (+Inf) slot
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, label_names, buckets=None):
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
            s.counts[bisect_left(self.buckets, v)] += 1
            s.sum += v
            s.count += 1

    def series_state(self, **labels) -> dict:
        """One series: per-bucket (non-cumulative) counts, sum, count."""
        with LOCK:
            s = self._series.get(self._labels_key(labels))
            if s is None:
                return {"buckets": self.buckets,
                        "counts": [0] * (len(self.buckets) + 1),
                        "sum": 0.0, "count": 0}
            return {"buckets": self.buckets, "counts": list(s.counts),
                    "sum": s.sum, "count": s.count}

    def _reset(self):
        for s in self._series.values():
            s.counts = [0] * (len(self.buckets) + 1)
            s.sum = 0.0
            s.count = 0


class MetricRegistry:
    """Holds the metrics by name; `reset` zeroes every series (label
    sets survive), `retire_label` deletes a retired engine's series."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name, help, labels, **kw):
        with LOCK:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.label_names}")
                return m
            m = self._metrics[name] = cls(name, help, labels, **kw)
            return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets)

    def reset(self):
        with LOCK:
            for m in self._metrics.values():
                m._reset()

    def retire_label(self, label: str, value) -> int:
        """Delete every series whose ``label`` equals ``value``; returns
        the number retired."""
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

    def snapshot(self) -> dict:
        """{name: {"type", "labels", "series": [{"labels", "value"} or
        {"labels", "counts", "sum", "count"}]}}, the JAX package's
        snapshot layout."""
        out = {}
        with LOCK:
            for name, m in sorted(self._metrics.items()):
                series = []
                for key, v in sorted(m._series.items()):
                    labels = dict(zip(m.label_names, key))
                    if m.kind == "histogram":
                        series.append({"labels": labels,
                                       "buckets": list(m.buckets),
                                       "counts": list(v.counts),
                                       "sum": v.sum, "count": v.count})
                    else:
                        series.append({"labels": labels, "value": v})
                out[name] = {"type": m.kind, "help": m.help,
                             "labels": list(m.label_names),
                             "series": series}
        return out


_default = MetricRegistry()


def default_registry() -> MetricRegistry:
    return _default
