"""Content-addressed result cache.

A bounded LRU keyed ``stable_hash(op, canonical_payload, model_version)``.
The controller consults it at workflow-stage submit/lease time for
cacheable ops (deterministic, marked in the op registry's
``CACHEABLE_OPS``) and at the ``/v1/infer`` front door before bucketing —
plain ``POST /v1/jobs`` submits always execute (submitted == executed is
the pre-DAG contract) but their results still populate the cache. Hits
bill at cache price in the
usage ledger and journal as cache-hit terminal result events, so replay
reproduces the exact same stored bytes whether a result was computed or
served from cache.

Keying follows the partition layer's ``stable_hash`` idiom (keyed blake2b
over a canonical byte string) rather than Python ``hash()`` so keys are
stable across processes — the same property that makes rendezvous placement
and the serving bucketer's byte-bucket key replay-safe. The payload is
canonicalized as compact sorted-key JSON; non-JSON values degrade to
``repr`` (deterministic for the scalar/list/dict payloads the ops take).

Invalidation is by model-version bump: the version participates in the key,
and ``set_model_version`` additionally drops the old generation eagerly so
capacity is never wasted on unreachable entries.

Thread-safe; all mutation happens under one lock (same discipline as the
controller's single-lock core). Stored results are deep-copied on both put
and get so callers can never alias cache memory — bit-identical replay
depends on entries being immutable once stored.
"""

from __future__ import annotations

import copy
import hashlib
import json
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional


def canonical_payload(payload: Dict[str, Any]) -> str:
    """Deterministic byte-stable JSON encoding of an op payload."""
    return json.dumps(
        payload, sort_keys=True, separators=(",", ":"), default=repr
    )


def result_key(op: str, payload: Dict[str, Any], model_version: str) -> str:
    """``stable_hash(op, canonical_payload, model_version)`` -> hex digest."""
    blob = "\x1f".join((op, model_version, canonical_payload(payload)))
    return hashlib.blake2b(blob.encode("utf-8"), digest_size=16).hexdigest()


class ResultCache:
    """Bounded LRU of op results, content-addressed and version-fenced."""

    def __init__(self, capacity: int = 4096, model_version: str = "v1") -> None:
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.capacity = max(0, int(capacity))
        self.model_version = str(model_version)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.invalidations = 0

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def key(self, op: str, payload: Dict[str, Any]) -> str:
        return result_key(op, payload, self.model_version)

    def get(self, op: str, payload: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Return a private copy of the cached result, or None (counted)."""
        if not self.enabled:
            return None
        k = self.key(op, payload)
        with self._lock:
            entry = self._entries.get(k)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(k)
            self.hits += 1
            return copy.deepcopy(entry)

    def put(self, op: str, payload: Dict[str, Any], result: Any) -> bool:
        """Store a computed result; evict LRU past capacity. Non-dict
        results are refused (the op contract returns dicts; anything else
        is a malformed agent report and must not be replayed from cache)."""
        if not self.enabled or not isinstance(result, dict):
            return False
        k = self.key(op, payload)
        with self._lock:
            self._entries[k] = copy.deepcopy(result)
            self._entries.move_to_end(k)
            self.puts += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
        return True

    def set_model_version(self, version: str) -> bool:
        """Model-version bump: fence the key space AND drop the old
        generation (entries under the old version are unreachable — keeping
        them would silently shrink effective capacity)."""
        version = str(version)
        if version == self.model_version:
            return False
        with self._lock:
            self.model_version = version
            self.invalidations += 1
            self._entries.clear()
        return True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "puts": self.puts,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
                "model_version": self.model_version,
            }
