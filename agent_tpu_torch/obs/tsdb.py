"""Durable on-disk time-series store.

The :class:`~agent_tpu_torch.obs.timeseries.TimeSeriesRing` gave the controller
trend history, but it dies with the process: a restart or a standby
promotion silently loses every sample, and "what did queue depth look like
in the 10 minutes before the page" becomes unanswerable the moment the
page actually matters. :class:`TsdbStore` persists every ring sample to
disk, reusing the journal's proven segment machinery (append-only
``<dir>/tsdb.seg-NNNNNNNN`` files, atomic rotate, torn-tail sealing at
reopen) rather than inventing a second storage engine.

Layout — three segment streams inside ``TSDB_DIR``:

- ``tsdb.seg-*``      raw samples, one JSON line per sweep-time sample:
                      ``{"ev":"s","wall":t,"data":{family:{labelkey:v}}}``
- ``tsdb-60.seg-*``   1-minute aggregates
- ``tsdb-600.seg-*``  10-minute aggregates

Aggregate lines carry ``[sum, count, min, max, last]`` per series slot —
enough to recompute means (sum/count), counter rates (``last`` preserves
the cumulative value at bucket end), and merged-histogram quantiles
(per-bucket ``*_bucket`` counters are monotone, so the windowed increase
is ``max - min`` and feeds ``histogram_quantile`` unchanged; see
:func:`quantile_from_bucket_series`). Retention is whole-segment: segments
older than the tier's ``TSDB_RETENTION_*`` age are unlinked, and a global
byte cap evicts oldest-raw-first. The active (highest-seq) segment of a
tier is never deleted.

Dependency-free like the rest of ``agent_tpu_torch.obs``; tolerant of torn
tails both at reopen (``open_for_append`` seals) and at read (unparsable
lines are skipped, never raised).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import (
    Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple,
)

from agent_tpu_torch.obs.metrics import histogram_quantile
from agent_tpu_torch.obs.timeseries import TimeSeriesRing, points_to_rates

if False:  # pragma: no cover — typing only
    from agent_tpu_torch.controller.journal import SegmentedJournal  # noqa: F401


def _journal_machinery():
    """Deferred import: ``controller.core`` imports this module, and the
    ``agent_tpu_torch.controller`` package __init__ imports core — importing
    the journal at module load would close that cycle."""
    from agent_tpu_torch.controller.journal import (
        SegmentedJournal, list_segments,
    )
    return SegmentedJournal, list_segments


def list_tier_segments(base: str) -> List[Tuple[int, str]]:
    _, list_segments = _journal_machinery()
    return list_segments(base)

# Tier resolutions in seconds; 0 is the raw stream.
RESOLUTIONS: Tuple[int, ...] = (60, 600)

DEFAULT_SEGMENT_BYTES = 1 << 20
DEFAULT_RETENTION_RAW_SEC = 3600.0
DEFAULT_RETENTION_1M_SEC = 86400.0
DEFAULT_RETENTION_10M_SEC = 7 * 86400.0
DEFAULT_MAX_BYTES = 256 << 20
DEFAULT_GC_INTERVAL_SEC = 30.0
MAX_POINTS_PER_SERIES = 2000


def _tier_base(directory: str, res: int) -> str:
    return os.path.join(directory, "tsdb" if res == 0 else f"tsdb-{res}")


class TsdbStore:
    """Append-path cost is one JSON line per tier transition plus one per
    sample; reads scan segments (bounded by retention) — the store serves
    forensics and dashboards, not the hot path."""

    def __init__(
        self,
        directory: str,
        segment_max_bytes: int = DEFAULT_SEGMENT_BYTES,
        retention_raw_sec: float = DEFAULT_RETENTION_RAW_SEC,
        retention_1m_sec: float = DEFAULT_RETENTION_1M_SEC,
        retention_10m_sec: float = DEFAULT_RETENTION_10M_SEC,
        max_bytes: int = DEFAULT_MAX_BYTES,
        gc_interval_sec: float = DEFAULT_GC_INTERVAL_SEC,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._clock = clock
        self.retention = {
            0: max(0.0, float(retention_raw_sec)),
            60: max(0.0, float(retention_1m_sec)),
            600: max(0.0, float(retention_10m_sec)),
        }
        self.max_bytes = max(0, int(max_bytes))
        self.gc_interval_sec = max(1.0, float(gc_interval_sec))
        self._lock = threading.RLock()
        SegmentedJournal, _ = _journal_machinery()
        self._journals: Dict[int, "SegmentedJournal"] = {}
        for res in (0,) + RESOLUTIONS:
            j = SegmentedJournal(
                _tier_base(directory, res),
                segment_max_bytes=max(4096, int(segment_max_bytes)),
            )
            j.open_for_append()  # seals any torn tail from a crash
            self._journals[res] = j
        # Open aggregation buckets: {"t0", "n", "data": {fam: {key: slot}}}
        # where slot = [sum, count, min, max, last].
        self._agg_cur: Dict[int, Optional[Dict[str, Any]]] = {
            res: None for res in RESOLUTIONS
        }
        self._last_gc = 0.0
        self.samples_appended = 0
        self.append_errors = 0
        self.gc_segments_removed = 0
        self.closed = False

    # ---- write path ----

    def append_sample(
        self, wall: float, data: Mapping[str, Mapping[str, float]]
    ) -> None:
        """Persist one flattened sample (the ring's ``data`` dict). Never
        raises on I/O trouble — the sweep loop must survive a full disk;
        failures count in ``append_errors``."""
        with self._lock:
            if self.closed:
                return
            try:
                self._journals[0].append(
                    {"ev": "s", "wall": round(float(wall), 3), "data": data}
                )
                for res in RESOLUTIONS:
                    self._feed_agg(res, wall, data)
                self.samples_appended += 1
            except Exception:  # noqa: BLE001 — disk full / unlinked dir
                self.append_errors += 1
                return
            now = self._clock()
            if now - self._last_gc >= self.gc_interval_sec:
                self._last_gc = now
                try:
                    self.gc(now=now)
                except Exception:  # noqa: BLE001
                    self.append_errors += 1

    def _feed_agg(
        self, res: int, wall: float, data: Mapping[str, Mapping[str, float]]
    ) -> None:
        t0 = int(wall // res) * res
        cur = self._agg_cur[res]
        if cur is not None and t0 > cur["t0"]:
            self._flush_agg(res)
            cur = None
        if cur is None:
            cur = {"t0": t0, "n": 0, "data": {}}
            self._agg_cur[res] = cur
        cur["n"] += 1
        for fam, series in data.items():
            dst = cur["data"].setdefault(fam, {})
            for key, v in series.items():
                v = float(v)
                slot = dst.get(key)
                if slot is None:
                    dst[key] = [v, 1, v, v, v]
                else:
                    slot[0] += v
                    slot[1] += 1
                    if v < slot[2]:
                        slot[2] = v
                    if v > slot[3]:
                        slot[3] = v
                    slot[4] = v

    def _flush_agg(self, res: int) -> None:
        cur = self._agg_cur[res]
        if cur is None or not cur["n"]:
            return
        self._journals[res].append({
            "ev": "a", "res": res, "t0": cur["t0"], "t1": cur["t0"] + res,
            "n": cur["n"], "data": cur["data"],
        })
        self._agg_cur[res] = None

    def flush(self) -> None:
        """Force-flush open aggregation buckets (close path and tests —
        a reopened store merging a duplicate ``t0`` at read keeps this
        loss-free)."""
        with self._lock:
            for res in RESOLUTIONS:
                try:
                    self._flush_agg(res)
                except Exception:  # noqa: BLE001
                    self.append_errors += 1

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.flush()
            for j in self._journals.values():
                try:
                    j.close()
                except Exception:  # noqa: BLE001
                    pass
            self.closed = True

    # ---- retention ----

    def gc(self, now: Optional[float] = None) -> int:
        """Whole-segment retention: per-tier age limit, then the global
        byte cap (evict oldest raw first, then 1m, then 10m). The active
        segment of each tier survives both passes. Returns segments
        removed."""
        if now is None:
            now = self._clock()
        removed = 0
        with self._lock:
            survivors: List[Tuple[int, int, str, float, int]] = []
            for res in (0,) + RESOLUTIONS:
                segs = list_tier_segments(
                    _tier_base(self.directory, res)
                )
                limit = self.retention[res]
                for seq, path in segs[:-1]:  # never the active segment
                    try:
                        st = os.stat(path)
                    except OSError:
                        continue
                    if limit > 0 and now - st.st_mtime > limit:
                        try:
                            os.remove(path)
                            removed += 1
                        except OSError:
                            pass
                        continue
                    survivors.append(
                        (res, seq, path, st.st_mtime, st.st_size)
                    )
                if segs:
                    try:
                        st = os.stat(segs[-1][1])
                        survivors.append(
                            (res, segs[-1][0], segs[-1][1],
                             st.st_mtime, st.st_size)
                        )
                    except OSError:
                        pass
            if self.max_bytes > 0:
                total = sum(s[4] for s in survivors)
                if total > self.max_bytes:
                    active = {
                        res: max(
                            (s[1] for s in survivors if s[0] == res),
                            default=-1,
                        )
                        for res in (0,) + RESOLUTIONS
                    }
                    # Oldest-first within raw, then 1m, then 10m.
                    evictable = sorted(
                        (
                            s for s in survivors
                            if s[1] != active[s[0]]
                        ),
                        key=lambda s: ((0,) + RESOLUTIONS).index(s[0]) * 1e12
                        + s[3],
                    )
                    for res, _seq, path, _mt, size in evictable:
                        if total <= self.max_bytes:
                            break
                        try:
                            os.remove(path)
                            total -= size
                            removed += 1
                        except OSError:
                            pass
            self.gc_segments_removed += removed
        return removed

    # ---- read path ----

    def _iter_events(self, res: int) -> Iterator[Dict[str, Any]]:
        base = _tier_base(self.directory, res)
        for _seq, path in list_tier_segments(base):
            try:
                f = open(path, "r", encoding="utf-8")
            except OSError:
                continue
            with f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue  # torn tail / partial flush — skip
                    if isinstance(ev, dict):
                        yield ev

    def samples(
        self,
        since: Optional[float] = None,
        until: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Raw samples (``{"wall", "data"}``) in append order, filtered
        to ``since <= wall <= until``."""
        out: List[Dict[str, Any]] = []
        for ev in self._iter_events(0):
            if ev.get("ev") != "s":
                continue
            wall = ev.get("wall")
            if not isinstance(wall, (int, float)):
                continue
            if since is not None and wall < since:
                continue
            if until is not None and wall > until:
                continue
            out.append({"wall": float(wall), "data": ev.get("data") or {}})
        return out

    def aggregates(
        self, res: int, since: Optional[float] = None
    ) -> List[Dict[str, Any]]:
        """Aggregate buckets for one tier, duplicate ``t0`` events merged
        (a flush-at-close followed by a reopen writing the same bucket
        again is a merge, not a double count... the slots re-merge:
        sums add, min/max widen, ``last`` takes the later event)."""
        merged: Dict[int, Dict[str, Any]] = {}
        for ev in self._iter_events(res):
            if ev.get("ev") != "a" or ev.get("res") != res:
                continue
            t0 = ev.get("t0")
            if not isinstance(t0, (int, float)):
                continue
            t0 = int(t0)
            if since is not None and t0 + res < since:
                continue
            data = ev.get("data") or {}
            have = merged.get(t0)
            if have is None:
                merged[t0] = {
                    "t0": t0, "t1": t0 + res,
                    "n": int(ev.get("n") or 0),
                    "data": {
                        fam: {k: list(slot) for k, slot in series.items()}
                        for fam, series in data.items()
                    },
                }
                continue
            have["n"] += int(ev.get("n") or 0)
            for fam, series in data.items():
                dst = have["data"].setdefault(fam, {})
                for key, slot in series.items():
                    old = dst.get(key)
                    if old is None:
                        dst[key] = list(slot)
                    else:
                        old[0] += slot[0]
                        old[1] += slot[1]
                        old[2] = min(old[2], slot[2])
                        old[3] = max(old[3], slot[3])
                        old[4] = slot[4]
        return [merged[t0] for t0 in sorted(merged)]

    def query(
        self,
        name: str,
        label_filter: Optional[Mapping[str, str]] = None,
        rate: bool = False,
        since: Optional[float] = None,
        until: Optional[float] = None,
        step: Optional[float] = None,
        max_points: int = MAX_POINTS_PER_SERIES,
    ) -> Dict[str, Any]:
        """Historical query. ``step`` picks the tier (>=600s → 10m
        aggregates, >=60s → 1m, else raw). Aggregate-tier series carry
        ``agg_points`` (``[t_end, sum, count, min, max]``) alongside the
        usual ``points`` (``[t, last]`` — counter-rate compatible)."""
        res = 0
        if step is not None:
            if step >= 600:
                res = 600
            elif step >= 60:
                res = 60
        grouped: Dict[str, List[Tuple[float, float]]] = {}
        agg_grouped: Dict[str, List[List[float]]] = {}
        if res == 0:
            for s in self.samples(since=since, until=until):
                for key, v in (s["data"].get(name) or {}).items():
                    grouped.setdefault(key, []).append((s["wall"], v))
        else:
            for bucket in self.aggregates(res, since=since):
                t = float(bucket["t1"])
                if until is not None and bucket["t0"] > until:
                    continue
                for key, slot in (bucket["data"].get(name) or {}).items():
                    grouped.setdefault(key, []).append((t, float(slot[4])))
                    agg_grouped.setdefault(key, []).append(
                        [t, slot[0], slot[1], slot[2], slot[3]]
                    )
        series: List[Dict[str, Any]] = []
        for key in sorted(grouped):
            try:
                labels = dict(json.loads(key))
            except ValueError:
                continue
            if label_filter and any(
                labels.get(k) != v for k, v in label_filter.items()
            ):
                continue
            pts = grouped[key]
            if rate:
                pts = points_to_rates(pts)
            entry: Dict[str, Any] = {
                "labels": labels,
                "points": [
                    [round(t, 3), round(v, 6)] for t, v in
                    pts[-max(1, int(max_points)):]
                ],
            }
            if key in agg_grouped:
                entry["agg_points"] = [
                    [round(p[0], 3)] + [round(x, 6) for x in p[1:]]
                    for p in agg_grouped[key][-max(1, int(max_points)):]
                ]
            series.append(entry)
        return {
            "name": name,
            "rate": bool(rate),
            "since": since,
            "step": res,
            "source": "tsdb",
            "series": series,
        }

    def stats(self) -> Dict[str, Any]:
        tiers: Dict[str, Any] = {}
        total_bytes = 0
        for res in (0,) + RESOLUTIONS:
            segs = list_tier_segments(_tier_base(self.directory, res))
            size = 0
            for _seq, path in segs:
                try:
                    size += os.path.getsize(path)
                except OSError:
                    pass
            total_bytes += size
            tiers["raw" if res == 0 else f"{res}s"] = {
                "segments": len(segs), "bytes": size,
            }
        return {
            "dir": self.directory,
            "tiers": tiers,
            "bytes": total_bytes,
            "max_bytes": self.max_bytes,
            "samples_appended": self.samples_appended,
            "append_errors": self.append_errors,
            "gc_segments_removed": self.gc_segments_removed,
        }


# ---- quantiles from aggregates ----

def quantile_from_bucket_series(
    series: List[Mapping[str, Any]], q: float
) -> Optional[float]:
    """Estimate the q-quantile of the observations a ``<name>_bucket``
    query window covers. Each per-``le`` slot is a monotone counter, so
    its windowed increase is ``last - first`` on raw points and
    ``max(maxes) - min(mins)`` on aggregate points — feeding
    ``histogram_quantile`` with the increases keeps the estimate within
    one bucket width of truth (same bound the live registry gives)."""
    increases: Dict[float, float] = {}
    inf_increase = 0.0
    saw_inf = False
    for s in series:
        le = (s.get("labels") or {}).get("le")
        if le is None:
            continue
        agg = s.get("agg_points")
        if agg:
            lo = min(p[3] for p in agg)
            hi = max(p[4] for p in agg)
            inc = max(0.0, hi - lo)
        else:
            pts = s.get("points") or []
            if len(pts) < 2:
                continue
            inc = max(0.0, float(pts[-1][1]) - float(pts[0][1]))
        if le == "+Inf":
            inf_increase += inc
            saw_inf = True
        else:
            try:
                edge = float(le)
            except (TypeError, ValueError):
                continue
            increases[edge] = increases.get(edge, 0.0) + inc
    if not increases and not saw_inf:
        return None
    edges = sorted(increases)
    counts = [increases[e] for e in edges] + [inf_increase]
    if sum(counts) <= 0:
        return None
    return histogram_quantile(edges, counts, q)


# ---- shared controller/router query view ----

def query_history(
    name: str,
    label_filter: Optional[Mapping[str, str]] = None,
    rate: bool = False,
    since: Optional[float] = None,
    step: Optional[float] = None,
    ring: Optional[TimeSeriesRing] = None,
    store: Optional["TsdbStore"] = None,
) -> Dict[str, Any]:
    """The ``GET /v1/timeseries?since=`` body: disk when a store is open
    (it holds everything the ring does — every ring sample is persisted),
    ring otherwise (bounded window, ``step`` approximated by keeping the
    last point per step bucket). Seamless for callers either way."""
    if store is not None:
        return store.query(
            name, label_filter=label_filter, rate=rate,
            since=since, step=step,
        )
    series: List[Dict[str, Any]] = []
    if ring is not None:
        for s in ring.series(name, label_filter):
            pts = [
                (float(p[0]), float(p[1])) for p in s["points"]
                if since is None or p[0] >= since
            ]
            if step is not None and step > 0 and pts:
                by_bucket: Dict[int, Tuple[float, float]] = {}
                for t, v in pts:
                    by_bucket[int(t // step)] = (t, v)
                pts = [by_bucket[b] for b in sorted(by_bucket)]
            if rate:
                pts = points_to_rates(pts)
            if pts:
                series.append({
                    "labels": s["labels"],
                    "points": [[round(t, 3), round(v, 6)] for t, v in pts],
                })
    return {
        "name": name,
        "rate": bool(rate),
        "since": since,
        "step": float(step) if step else 0,
        "source": "ring",
        "series": series,
    }
