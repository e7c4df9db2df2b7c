"""Controller-resident metric time series — the trend-retention ring.

Every consumer that wanted a *rate* (swarmtop's tasks/s, bench's scrape
deltas) had to scrape ``/v1/metrics`` twice and subtract client-side — which
means every dashboard frame re-derives history the controller already
lived through, and a freshly-attached client has no history at all.
:class:`TimeSeriesRing` fixes that at the source: the controller samples its
own registry (plus the fleet merge) every ``TSDB_INTERVAL`` seconds into a
bounded ring spanning ``TSDB_WINDOW``, and ``GET /v1/timeseries?name=...``
serves the points — so rates and sparklines come from the controller's
clock, not from whenever the client happened to scrape.

Deliberately *not* a database: fixed cadence, bounded window, flattened
samples (counters/gauges keep their value; histograms flatten to their
``_sum``/``_count`` components — enough for rate math, which is all a trend
ring owes anyone). Dependency-free like the rest of ``agent_tpu_torch.obs``.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

DEFAULT_WINDOW_SEC = 900.0
DEFAULT_INTERVAL_SEC = 10.0


def flatten_snapshot(snap: Mapping[str, Any]) -> Dict[str, Dict[str, float]]:
    """One registry snapshot → ``{family: {label_key: value}}``.

    ``label_key`` is the canonical JSON of the sorted label pairs (the same
    identity ``merge_snapshots`` uses), so a series keeps its key across
    samples. Histograms contribute ``<name>_sum`` and ``<name>_count``
    families plus — since the durable tsdb — a
    ``<name>_bucket`` family with an ``le`` label per slot (``+Inf`` for
    the overflow), so downsampled aggregates keep quantiles computable."""
    out: Dict[str, Dict[str, float]] = {}
    for name, fam in snap.items():
        if not isinstance(fam, Mapping):
            continue
        kind = fam.get("type")
        edges = fam.get("buckets")
        for s in fam.get("series", []):
            labels = s.get("labels", {}) or {}
            key = json.dumps(sorted(labels.items()), separators=(",", ":"))
            if kind == "histogram":
                out.setdefault(f"{name}_sum", {})[key] = float(
                    s.get("sum", 0.0)
                )
                out.setdefault(f"{name}_count", {})[key] = float(
                    s.get("count", 0)
                )
                counts = s.get("counts") or []
                if edges and counts:
                    slots = [str(float(e)) for e in edges] + ["+Inf"]
                    bfam = out.setdefault(f"{name}_bucket", {})
                    for le, c in zip(slots, counts):
                        bkey = json.dumps(
                            sorted(list(labels.items()) + [("le", le)]),
                            separators=(",", ":"),
                        )
                        bfam[bkey] = float(c)
            else:
                out.setdefault(name, {})[key] = float(s.get("value", 0.0))
    return out


def points_to_rates(
    points: List[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """Consecutive-sample deltas per second, clamped at 0 (a counter reset —
    agent restart — reads as a 0-rate sample, not a negative spike). Each
    rate is stamped at the LATER sample's timestamp; n points → n-1 rates."""
    out: List[Tuple[float, float]] = []
    for (t0, v0), (t1, v1) in zip(points, points[1:]):
        dt = t1 - t0
        if dt <= 0:
            continue
        out.append((t1, max(0.0, (v1 - v0) / dt)))
    return out


class TimeSeriesRing:
    """Bounded ring of periodic flattened registry samples.

    ``maybe_sample(sampler)`` is called from the controller's sweep loop and
    (rate-limited by the same interval check) from the lease hot path, so the
    ring fills with or without a sweeper. ``sampler`` is a zero-arg callable
    returning the snapshot dicts to flatten — evaluated only when a sample is
    actually due, so the hot path pays one clock read per call."""

    def __init__(
        self,
        window_sec: float = DEFAULT_WINDOW_SEC,
        interval_sec: float = DEFAULT_INTERVAL_SEC,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.window_sec = max(1.0, float(window_sec))
        self.interval_sec = min(
            self.window_sec, max(0.05, float(interval_sec))
        )
        self._clock = clock
        maxlen = max(2, int(self.window_sec / self.interval_sec) + 1)
        self._samples: "collections.deque" = collections.deque(maxlen=maxlen)
        self._last = float("-inf")
        self._lock = threading.Lock()
        # Persist hook: called OUTSIDE the lock with
        # (wall, mono, data) after every recorded sample — the durable
        # tsdb and the anomaly detector ride every ring sample. Failures
        # are swallowed here (the owner keeps its own error counter);
        # telemetry must never take down the hot path feeding it.
        self.on_sample: Optional[Callable[[float, float, Dict[str, Dict[str, float]]], None]] = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def maybe_sample(
        self,
        sampler: Callable[[], Iterable[Mapping[str, Any]]],
        now: Optional[float] = None,
        wall: Optional[float] = None,
    ) -> bool:
        """Take a sample iff the interval elapsed. Returns whether one was
        taken. The due-check runs under the lock but the sampler itself does
        not — a second caller racing the window simply records one more
        sample, never corrupts the ring."""
        if now is None:
            now = self._clock()
        with self._lock:
            if now - self._last < self.interval_sec:
                return False
            self._last = now
        self.sample(sampler(), now=now, wall=wall)
        return True

    def sample(
        self,
        snapshots: Iterable[Mapping[str, Any]],
        now: Optional[float] = None,
        wall: Optional[float] = None,
    ) -> None:
        """Unconditionally record one sample (tests and forced flushes)."""
        if now is None:
            now = self._clock()
        if wall is None:
            wall = time.time()
        data: Dict[str, Dict[str, float]] = {}
        for snap in snapshots:
            if not isinstance(snap, Mapping):
                continue
            for name, series in flatten_snapshot(snap).items():
                # Same family from controller + fleet merge: later snapshots
                # win per label key (they never overlap in practice —
                # controller families are controller_*/sched_* prefixed).
                data.setdefault(name, {}).update(series)
        self.append_flat(wall, data, now=now)

    def append_flat(
        self,
        wall: float,
        data: Dict[str, Dict[str, float]],
        now: Optional[float] = None,
    ) -> None:
        """Record one already-flattened sample (the router's collector
        replays scraped partition samples through this)."""
        if now is None:
            now = self._clock()
        with self._lock:
            self._samples.append({"mono": now, "wall": wall, "data": data})
        hook = self.on_sample
        if hook is not None:
            try:
                hook(wall, now, data)
            except Exception:  # noqa: BLE001 — see ctor comment
                pass

    def samples_since(
        self, wall: float, limit: int = 0
    ) -> List[Dict[str, Any]]:
        """Samples strictly NEWER than ``wall``, oldest first — the
        ``/v1/timeseries/export`` delta-scrape cursor contract."""
        with self._lock:
            out = [
                {"wall": s["wall"], "data": s["data"]}
                for s in self._samples
                if s["wall"] > wall
            ]
        if limit and len(out) > limit:
            out = out[-limit:]
        return out

    def last_wall(self) -> Optional[float]:
        with self._lock:
            return self._samples[-1]["wall"] if self._samples else None

    def names(self) -> List[str]:
        seen: Dict[str, None] = {}
        with self._lock:
            for s in self._samples:
                for name in s["data"]:
                    seen.setdefault(name)
        return sorted(seen)

    def series(
        self,
        name: str,
        label_filter: Optional[Mapping[str, str]] = None,
        window_sec: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """``[{labels, points: [[wall_ts, value], ...]}, ...]`` for one
        family, newest window first in time order. Unknown names and empty
        windows return ``[]`` — never an error (a ring that hasn't sampled
        yet is a normal state, not a fault)."""
        horizon = None
        if window_sec is not None:
            horizon = self._clock() - max(0.0, float(window_sec))
        grouped: Dict[str, List[Tuple[float, float]]] = {}
        with self._lock:
            samples = list(self._samples)
        for s in samples:
            if horizon is not None and s["mono"] < horizon:
                continue
            for key, value in s["data"].get(name, {}).items():
                grouped.setdefault(key, []).append((s["wall"], value))
        out: List[Dict[str, Any]] = []
        for key in sorted(grouped):
            labels = dict(json.loads(key))
            if label_filter and any(
                labels.get(k) != v for k, v in label_filter.items()
            ):
                continue
            out.append({
                "labels": labels,
                "points": [[round(t, 3), v] for t, v in grouped[key]],
            })
        return out

    def query(
        self,
        name: str,
        label_filter: Optional[Mapping[str, str]] = None,
        rate: bool = False,
        window_sec: Optional[float] = None,
    ) -> Dict[str, Any]:
        """The ``GET /v1/timeseries`` body. ``rate=True`` transforms each
        series' points into per-second deltas (counter rates; a gauge's
        "rate" is its slope, which callers asked for explicitly)."""
        series = self.series(name, label_filter, window_sec=window_sec)
        if rate:
            for s in series:
                s["points"] = [
                    [round(t, 3), round(v, 6)]
                    for t, v in points_to_rates(
                        [(p[0], p[1]) for p in s["points"]]
                    )
                ]
        return {
            "name": name,
            "rate": bool(rate),
            "window_sec": self.window_sec,
            "interval_sec": self.interval_sec,
            "n_samples": len(self),
            "series": series,
        }
