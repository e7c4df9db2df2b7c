"""Result spool — the port's copy of ``agent_tpu.agent.spool``: a bounded
redelivery queue behind ``post_result``.

A completed result whose ``POST /v1/results`` fails transiently is kept and
redelivered with backoff on later loop iterations instead of dropped; epoch
fencing makes redelivery safe (a result the controller already applied — or
fenced — is rejected idempotently, never applied twice).

Shape:

- **In-memory ring**, bounded at ``capacity`` — when full, the *oldest*
  entry is evicted (newer work is likelier to still be inside its lease
  window); evictions are returned to the caller so it can count the loss
  (``result_redeliveries_total{outcome="dropped_overflow"}``).
- **Optional on-disk JSONL** (``RESULT_SPOOL_PATH``): every mutation
  rewrites the file atomically (tmp + rename; the ring bound caps the
  rewrite cost), so a crashed agent's undelivered results survive restart
  and redeliver from the new incarnation. Unparseable lines (torn final
  write) are dropped at load, counted in ``load_skipped``.

The spool stores the full ``/v1/results`` wire body plus ``op`` (metric
labeling) and ``spooled_at`` (monotonic age for the optional redelivery
deadline). Delivery itself lives in ``Agent.flush_spool`` — the spool is
pure bookkeeping so it can be tested without a controller.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 512


class ResultSpool:
    """Bounded FIFO of undelivered result bodies, optionally disk-backed."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        path: Optional[str] = None,
        clock=time.monotonic,
    ) -> None:
        self.capacity = max(1, int(capacity))
        self.path = path or None
        self._clock = clock
        self._entries: "collections.deque[Dict[str, Any]]" = collections.deque()
        self.load_skipped = 0
        if self.path:
            self._load()

    # ---- persistence ----

    def _load(self) -> None:
        if not self.path or not os.path.exists(self.path):
            return
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except ValueError:
                    self.load_skipped += 1  # torn final write from a crash
                    continue
                if isinstance(entry, dict):
                    self._entries.append(entry)
        while len(self._entries) > self.capacity:
            self._entries.popleft()
            self.load_skipped += 1

    def _persist(self) -> None:
        """Atomic rewrite — a crash mid-persist leaves the previous file, so
        at worst an already-delivered entry redelivers (fenced, harmless),
        never a lost one."""
        if not self.path:
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                for entry in self._entries:
                    f.write(json.dumps(entry, default=str) + "\n")
            os.replace(tmp, self.path)
        except OSError:
            # Disk trouble must not take down the drain; the in-memory ring
            # still redelivers within this incarnation.
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # ---- queue surface ----

    def put(
        self,
        lease_id: str,
        job_id: str,
        job_epoch: Any,
        status: str,
        result: Any = None,
        error: Any = None,
        op: str = "?",
    ) -> Optional[Dict[str, Any]]:
        """Spool one undelivered result. Returns the evicted entry when the
        ring was full (the caller counts it), else None."""
        entry = {
            "lease_id": lease_id,
            "job_id": job_id,
            "job_epoch": job_epoch,
            "status": status,
            "result": result,
            "error": error,
            "op": op,
            "spooled_at": self._clock(),
        }
        evicted = None
        if len(self._entries) >= self.capacity:
            evicted = self._entries.popleft()
        self._entries.append(entry)
        self._persist()
        return evicted

    def head(self) -> Optional[Dict[str, Any]]:
        return self._entries[0] if self._entries else None

    def pop_head(self) -> Optional[Dict[str, Any]]:
        if not self._entries:
            return None
        entry = self._entries.popleft()
        self._persist()
        return entry

    def age_of_head(self) -> float:
        """Seconds the oldest entry has been waiting (0 when empty)."""
        if not self._entries:
            return 0.0
        spooled = self._entries[0].get("spooled_at")
        if not isinstance(spooled, (int, float)) or isinstance(spooled, bool):
            return 0.0
        return max(0.0, self._clock() - float(spooled))

    def entries(self) -> List[Dict[str, Any]]:
        return list(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def wire_body(entry: Dict[str, Any]) -> Dict[str, Any]:
        """The ``/v1/results`` body for a spooled entry (strips the
        bookkeeping fields)."""
        return {
            k: entry.get(k)
            for k in (
                "lease_id", "job_id", "job_epoch", "status", "result", "error"
            )
        }
