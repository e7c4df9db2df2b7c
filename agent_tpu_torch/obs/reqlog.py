"""Wide-event request log — one structured record per serving request.

Aggregate histograms say *how slow* serving is; the request log
keeps the evidence: one flat record per terminal ``/v1/infer`` request
(tenant, op, bucket, priority, outcome, TTFT/TPOT, the TTFT component
decomposition, tokens, path, prefix hit, KV wait, occupancy, trace ids) in
a bounded ring served at ``GET /v1/debug/requests``.

**Tail-based sampling**: at high request rates keeping every healthy
record is waste — the interesting tail is errors and the slow decile. The
log therefore ALWAYS keeps records whose ``outcome`` is not ``completed``
and records whose TTFT lands in the slowest decile of the recent window,
and keeps the fast/healthy remainder with probability
``SERVE_REQLOG_SAMPLE`` (default 1.0 = everything; 0.0 = tail only). The
sampling decision hashes ``req_id`` — deterministic across replays and
processes, no RNG state to carry.

Dependency-free by the obs charter: stdlib only. Memory is O(capacity)
like the flight recorder, never O(requests).
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 2048
# Recent-TTFT window the slow-decile threshold is computed over. Small
# enough that the per-add sort is noise, large enough to be a stable
# estimate at serving rates.
SLOW_WINDOW = 512
# Below this many observed TTFTs the decile estimate is meaningless —
# keep everything (conservative: the warmup tail is exactly when records
# are scarce and precious).
SLOW_MIN_SAMPLES = 20
SLOW_QUANTILE = 0.90


def _sample_fraction(req_id: str) -> float:
    """Deterministic [0, 1) fraction from the request id — the same
    request samples identically on every replay/process."""
    digest = hashlib.sha1(req_id.encode("utf-8", "replace")).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64)


class RequestLog:
    """Bounded, thread-safe ring of wide request records with tail-based
    sampling. ``add`` is on the serving completion path: it must never
    raise and stays O(SLOW_WINDOW log SLOW_WINDOW) worst case."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        sample: float = 1.0,
    ) -> None:
        self.capacity = max(1, int(capacity))
        self.sample = min(1.0, max(0.0, float(sample)))
        self._lock = threading.Lock()
        self._records: "collections.deque" = collections.deque(
            maxlen=self.capacity
        )
        self._ttfts: "collections.deque" = collections.deque(
            maxlen=SLOW_WINDOW
        )
        self.seen = 0
        self.kept = 0
        self.sampled_out = 0
        self.kept_by_reason: Dict[str, int] = {}

    # ---- ingestion ----

    def _slow_threshold_locked(self) -> Optional[float]:
        if len(self._ttfts) < SLOW_MIN_SAMPLES:
            return None
        ordered = sorted(self._ttfts)
        idx = min(len(ordered) - 1, int(len(ordered) * SLOW_QUANTILE))
        return ordered[idx]

    def add(self, record: Dict[str, Any]) -> Optional[str]:
        """Ingest one record; returns the keep reason (``error`` /
        ``slow`` / ``sampled``) or None when sampled out. The record is
        annotated with ``kept`` (the reason) and ``ts`` when absent."""
        with self._lock:
            self.seen += 1
            outcome = str(record.get("outcome") or "")
            ttft = record.get("ttft_ms")
            threshold = self._slow_threshold_locked()
            if isinstance(ttft, (int, float)) and not isinstance(ttft, bool):
                self._ttfts.append(float(ttft))
            if outcome and outcome != "completed":
                reason = "error"
            elif isinstance(ttft, (int, float)) and (
                threshold is None or float(ttft) >= threshold
            ):
                # Slowest decile of the recent window — or the warmup
                # phase before the decile estimate exists.
                reason = "slow"
            elif self.sample >= 1.0 or _sample_fraction(
                str(record.get("req_id") or "")
            ) < self.sample:
                reason = "sampled"
            else:
                self.sampled_out += 1
                return None
            record = dict(record)
            record["kept"] = reason
            record.setdefault("ts", time.time())
            self._records.append(record)
            self.kept += 1
            self.kept_by_reason[reason] = (
                self.kept_by_reason.get(reason, 0) + 1
            )
            return reason

    # ---- query ----

    def snapshot(
        self,
        tenant: Optional[str] = None,
        outcome: Optional[str] = None,
        slow: bool = False,
        limit: int = 256,
    ) -> List[Dict[str, Any]]:
        """Newest-first records matching the filters. ``slow=True``
        restricts to tail-kept records (``kept`` in error/slow) — the
        ``?slow=1`` debug view."""
        with self._lock:
            records = list(self._records)
        out: List[Dict[str, Any]] = []
        for rec in reversed(records):
            if tenant is not None and rec.get("tenant") != tenant:
                continue
            if outcome is not None and rec.get("outcome") != outcome:
                continue
            if slow and rec.get("kept") not in ("error", "slow"):
                continue
            out.append(dict(rec))
            if len(out) >= max(1, int(limit)):
                break
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "sample": self.sample,
                "seen": self.seen,
                "kept": self.kept,
                "sampled_out": self.sampled_out,
                "kept_by_reason": dict(self.kept_by_reason),
                "size": len(self._records),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


def dominant_component(components: Dict[str, Any]) -> Optional[str]:
    """The TTFT component that dominates one request's decomposition —
    the 'why was THIS request slow' one-worder swarmtop and bench print."""
    best: Optional[str] = None
    best_ms = 0.0
    for name, ms in (components or {}).items():
        if isinstance(ms, (int, float)) and not isinstance(ms, bool) \
                and float(ms) >= best_ms:
            best, best_ms = str(name), float(ms)
    return best
