"""Automatic incident forensics bundles.

When an SLO pages or an anomaly confirms, the operator's first question
is "what was happening" — and the answer used to be scattered across two
flight-recorder dumps, an in-memory request log, and a time-series ring
that may already have rotated past the event. The :class:`IncidentBundler`
snapshots ONE correlated bundle at the moment of the event: the telemetry
window around it, the flight-recorder tail, the reqlog slow tail, the
traces of the K worst requests, controller status and health — bounded,
content-addressed, deduplicated per episode, rate-limited per key.

Bundles are kept in a bounded in-memory ring and (when ``INCIDENT_DIR``
is set) written to ``<dir>/<id>.json`` via tmp+rename, so they survive
the crash they are usually documenting. On open, existing bundle files
are indexed (headers only) — ``GET /v1/incidents`` lists them after a
restart and ``GET /v1/incidents/<id>`` reads the body back from disk.

The id is content-addressed: ``inc-`` + sha256 of the canonical bundle
JSON (sans id), so identical forensics dedupe naturally and a bundle file
can be integrity-checked against its own name.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

DEFAULT_CAPACITY = 32
DEFAULT_MIN_INTERVAL_SEC = 60.0
DEFAULT_MAX_BUNDLE_BYTES = 512 * 1024
SCHEMA_VERSION = 1


def _canonical(doc: Any) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"),
                      default=str)


class IncidentBundler:
    def __init__(
        self,
        directory: str = "",
        capacity: int = DEFAULT_CAPACITY,
        min_interval_sec: float = DEFAULT_MIN_INTERVAL_SEC,
        max_bundle_bytes: int = DEFAULT_MAX_BUNDLE_BYTES,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.directory = directory
        self.capacity = max(1, int(capacity))
        self.min_interval_sec = max(0.0, float(min_interval_sec))
        self.max_bundle_bytes = max(4096, int(max_bundle_bytes))
        self._clock = clock
        self._lock = threading.Lock()
        self._bundles: "collections.OrderedDict[str, Dict[str, Any]]" = \
            collections.OrderedDict()
        # Disk-only index after a restart: id -> header (no body in RAM).
        self._disk_index: Dict[str, Dict[str, Any]] = {}
        self._last_by_key: Dict[str, float] = {}
        self.captured = 0
        self.suppressed = 0
        if directory:
            os.makedirs(directory, exist_ok=True)
            self._reindex_disk()

    def _reindex_disk(self) -> None:
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return
        for fname in names:
            if not (fname.startswith("inc-") and fname.endswith(".json")):
                continue
            path = os.path.join(self.directory, fname)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue  # torn write — the tmp+rename path makes this
                # rare; a corrupt bundle is skipped, not fatal.
            if not isinstance(doc, Mapping) or "id" not in doc:
                continue
            self._disk_index[str(doc["id"])] = {
                k: doc.get(k)
                for k in ("id", "wall", "kind", "key", "reason", "schema")
            }

    # ---- capture ----

    def capture(
        self,
        kind: str,
        key: str,
        reason: Mapping[str, Any],
        sections: Mapping[str, Any],
        wall: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Build + persist one bundle; returns it, or None when the
        (kind, key) episode is rate-limited. Never raises — forensics
        must not take down the path being diagnosed."""
        if wall is None:
            wall = self._clock()
        dedup_key = f"{kind}:{key}"
        with self._lock:
            last = self._last_by_key.get(dedup_key)
            if last is not None and wall - last < self.min_interval_sec:
                self.suppressed += 1
                return None
            self._last_by_key[dedup_key] = wall
        try:
            bundle = self._build(kind, key, reason, sections, wall)
        except Exception:  # noqa: BLE001
            return None
        with self._lock:
            self._bundles[bundle["id"]] = bundle
            while len(self._bundles) > self.capacity:
                self._bundles.popitem(last=False)
            self.captured += 1
        if self.directory:
            self._write(bundle)
        return bundle

    def _build(
        self,
        kind: str,
        key: str,
        reason: Mapping[str, Any],
        sections: Mapping[str, Any],
        wall: float,
    ) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "wall": round(float(wall), 3),
            "kind": str(kind),
            "key": str(key),
            "reason": dict(reason),
            "sections": dict(sections),
        }
        # Bound: drop the largest section until the bundle fits. What was
        # dropped is named, so a truncated bundle is visibly truncated.
        dropped: List[str] = []
        while True:
            body = _canonical(doc)
            if len(body) <= self.max_bundle_bytes or not doc["sections"]:
                break
            largest = max(
                doc["sections"],
                key=lambda name: len(_canonical(doc["sections"][name])),
            )
            doc["sections"].pop(largest)
            dropped.append(largest)
            doc["truncated_sections"] = list(dropped)
        digest = hashlib.sha256(_canonical(doc).encode("utf-8")).hexdigest()
        doc["id"] = f"inc-{digest[:12]}"
        return doc

    def _write(self, bundle: Mapping[str, Any]) -> None:
        path = os.path.join(self.directory, f"{bundle['id']}.json")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, sort_keys=True, default=str)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # ---- query ----

    def _header(self, doc: Mapping[str, Any]) -> Dict[str, Any]:
        return {
            "id": doc.get("id"),
            "wall": doc.get("wall"),
            "kind": doc.get("kind"),
            "key": doc.get("key"),
            "reason": doc.get("reason"),
            "truncated_sections": doc.get("truncated_sections"),
        }

    def list(self) -> List[Dict[str, Any]]:
        """Headers, newest first; disk-indexed bundles from before a
        restart included."""
        with self._lock:
            live = [self._header(b) for b in self._bundles.values()]
            live_ids = set(self._bundles)
            disk = [
                dict(h) for bid, h in self._disk_index.items()
                if bid not in live_ids
            ]
        out = live + disk
        out.sort(key=lambda h: (h.get("wall") or 0.0), reverse=True)
        return out

    def get(self, incident_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            bundle = self._bundles.get(incident_id)
            known_on_disk = incident_id in self._disk_index
        if bundle is not None:
            return dict(bundle)
        if not (known_on_disk and self.directory):
            return None
        path = os.path.join(self.directory, f"{incident_id}.json")
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "captured": self.captured,
                "suppressed": self.suppressed,
                "in_memory": len(self._bundles),
                "on_disk_index": len(self._disk_index),
                "dir": self.directory,
            }
