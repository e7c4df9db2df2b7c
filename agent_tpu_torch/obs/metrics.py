"""Dependency-free metrics: counters, gauges and fixed-bucket histograms —
the part of ``agent_tpu.obs.metrics`` that the agent loop records into.

The agent owns a ``MetricsRegistry`` (thread-safe, label-aware); its
``snapshot()`` is a plain JSON-able dict that rides every lease's
``metrics`` channel, in the reference's snapshot shape, where the
reference's controller merges it into the fleet view. Histograms carry their
bucket bounds in the snapshot. The staging pool's
autotuner reads ``task_phase_seconds`` from the same registry. Rendering,
parsing and merging expositions stay on the controller's side.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

# Seconds-oriented bounds: task phases run 5 ms to minutes. +Inf is implicit
# (the overflow slot).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class _Metric:
    """Base: one named family holding labeled series. Series mutation is
    guarded by the owning registry's lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name!r}")
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Mapping[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(labels)} != declared "
                             f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up ({amount})")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Histogram(_Metric):
    """Fixed-bucket histogram. Each series stores per-bucket (non-cumulative)
    counts with a final +Inf overflow slot, plus sum and count."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, labelnames, lock)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"{name}: buckets must be sorted and unique")
        if any(b != b or b == float("inf") for b in bounds):
            raise ValueError(f"{name}: buckets must be finite (+Inf is implicit)")
        self.buckets = bounds

    def observe(self, value: float, exemplar: Optional[Mapping[str, Any]] = None,
                **labels: Any) -> None:
        """Record one observation. ``exemplar`` (a small label set like
        ``{"trace_id": job_id}``) is attached to the landing bucket — the
        latest observation wins."""
        v = float(value)
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0, "count": 0}
                self._series[key] = series
            i = len(self.buckets)  # +Inf slot
            for j, bound in enumerate(self.buckets):
                if v <= bound:
                    i = j
                    break
            series["counts"][i] += 1
            series["sum"] += v
            series["count"] += 1
            if exemplar:
                series.setdefault("exemplars", {})[str(i)] = {
                    "labels": {str(k): str(lv) for k, lv in exemplar.items()},
                    "value": v,
                    "ts": time.time(),
                }


class MetricsRegistry:
    """Thread-safe named collection of metrics; get-or-create semantics so
    independent modules can reference the same family."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labelnames: Sequence[str],
                       **kwargs: Any) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != tuple(labelnames):
                    raise ValueError(f"metric {name!r} re-registered with a different "
                                     "type/labels")
                return existing
            metric = cls(name, help, labelnames, self._lock, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump of every series — the lease-push wire format."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, m in self._metrics.items():
                fam: Dict[str, Any] = {"type": m.kind, "help": m.help,
                                       "labels": list(m.labelnames), "series": []}
                if isinstance(m, Histogram):
                    fam["buckets"] = list(m.buckets)
                for key, value in m._series.items():
                    labels = dict(zip(m.labelnames, key))
                    if isinstance(m, Histogram):
                        entry = {"labels": labels, "counts": list(value["counts"]),
                                 "sum": value["sum"], "count": value["count"]}
                        if value.get("exemplars"):
                            entry["exemplars"] = {k: dict(v)
                                                  for k, v in value["exemplars"].items()}
                        fam["series"].append(entry)
                    else:
                        fam["series"].append({"labels": labels, "value": value})
                out[name] = fam
        return out

