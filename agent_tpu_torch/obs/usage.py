"""Per-tenant / per-job resource accounting — the port of
``agent_tpu.obs.usage``.

The agent's half is :func:`stamp_usage`: it accumulates a task's usage
fields into ``ctx.tags["usage"]``, which the result carries as its
``usage`` block. The agent stamps ``device_s`` (the same seconds that feed
``device_busy_seconds_total``), ``chips``, ``flops`` (from the op's
``device_attr``) and ``host_s`` (stage and finalize); the ops stamp
``rows`` and the serving ops ``cache_hit_rows``.

The controller's half is :class:`UsageLedger`: it bills each *accepted*
result application keyed ``{tenant, tier, op}`` and per job, deduped by
``(job_id, attempt)``, so a redelivered duplicate never bills twice.
Failed attempts that produced a structured result bill too; error-only
failures carry no usage block and under-count. Billed usage rides the
journal's ``result`` events and replays into a fresh ledger
(``export_state`` / ``load_state``).

Bounded by design: the aggregate map is small (tenants × tiers × ops); the
per-job map holds at most ``max_jobs`` entries, evicting the smallest
device-seconds consumer first — top-K stays exact until eviction starts,
approximate (biased toward keeping the expensive jobs) after.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Mapping, Optional, Tuple

# Numeric usage-block fields agents may stamp (anything else is dropped —
# the wire is agent-controlled input).
USAGE_FIELDS = (
    "device_s", "host_s", "flops", "rows", "chips", "wire_bytes",
    "cache_hit_rows", "result_cache_hits",
)

_ZERO = {
    "tasks": 0,
    "device_seconds": 0.0,
    "chip_seconds": 0.0,
    "host_seconds": 0.0,
    "flops": 0.0,
    "rows": 0,
    "wire_bytes": 0,
    # Rows whose prefill was served from the prefix cache: the
    # showback line that says how much compute a tenant's repeated prefixes
    # DIDN'T cost the fleet.
    "cache_hit_rows": 0,
    # Whole results served from the content-addressed result cache
    # billed at cache price instead of chip-seconds; the
    # per-tenant result_dedupe_ratio derives from this.
    "result_cache_hits": 0,
}


def sanitize_usage(raw: Any) -> Dict[str, float]:
    """The numeric subset of an agent-stamped usage block: known fields,
    finite non-negative numbers only (the wire is untrusted input — a NaN
    here would poison every aggregate it touches)."""
    out: Dict[str, float] = {}
    if not isinstance(raw, Mapping):
        return out
    for key in USAGE_FIELDS:
        v = raw.get(key)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        v = float(v)
        if v != v or v < 0 or v == float("inf"):
            continue
        out[key] = v
    return out


def _accumulate(bucket: Dict[str, Any], usage: Mapping[str, float],
                wire_bytes: int) -> None:
    bucket["tasks"] += 1
    dev = usage.get("device_s", 0.0)
    bucket["device_seconds"] += dev
    bucket["chip_seconds"] += dev * max(1.0, usage.get("chips", 1.0))
    bucket["host_seconds"] += usage.get("host_s", 0.0)
    bucket["flops"] += usage.get("flops", 0.0)
    bucket["rows"] += int(usage.get("rows", 0))
    bucket["wire_bytes"] += int(wire_bytes) + int(usage.get("wire_bytes", 0))
    bucket["cache_hit_rows"] += int(usage.get("cache_hit_rows", 0))
    bucket["result_cache_hits"] += int(usage.get("result_cache_hits", 0))


def _rounded(bucket: Mapping[str, Any]) -> Dict[str, Any]:
    return {
        "tasks": int(bucket["tasks"]),
        "device_seconds": round(bucket["device_seconds"], 6),
        "chip_seconds": round(bucket["chip_seconds"], 6),
        "host_seconds": round(bucket["host_seconds"], 6),
        "flops": float(bucket["flops"]),
        "rows": int(bucket["rows"]),
        "wire_bytes": int(bucket["wire_bytes"]),
        "cache_hit_rows": int(bucket["cache_hit_rows"]),
        "result_cache_hits": int(bucket["result_cache_hits"]),
    }


class UsageLedger:
    """Thread-safe accounting of accepted result applications."""

    def __init__(
        self,
        registry: Any = None,
        top_k: int = 10,
        max_jobs: int = 4096,
        cost_per_chip_hour: float = 0.0,
        cache_price_per_hit: float = 0.0,
    ) -> None:
        self.top_k = max(1, int(top_k))
        self.max_jobs = max(16, int(max_jobs))
        self.cost_per_chip_hour = max(0.0, float(cost_per_chip_hour))
        # The "cache price": est-cost charged per result served from the
        # content-addressed result cache instead of chip-seconds.
        self.cache_price_per_hit = max(0.0, float(cache_price_per_hit))
        self.started_wall = time.time()
        self._lock = threading.Lock()
        # {(tenant, tier, op): bucket} — the showback aggregate.
        self._by_key: Dict[Tuple[str, int, str], Dict[str, Any]] = {}
        # {job_id: bucket + identity + billed attempt set} — the top-K feed.
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self.billed_tasks = 0
        self.evicted_jobs = 0
        # Prometheus mirrors (when a registry is injected): the series the
        # time-series ring turns into per-tenant rate sparklines.
        self._m_device = self._m_tasks = self._m_rows = None
        if registry is not None:
            self._m_device = registry.counter(
                "usage_device_seconds_total",
                "Billed device-dispatch seconds per tenant and op "
                "(accepted result applications only)", ("tenant", "op"))
            self._m_tasks = registry.counter(
                "usage_tasks_total",
                "Billed result applications per tenant and op",
                ("tenant", "op"))
            self._m_rows = registry.counter(
                "usage_rows_total",
                "Rows processed per tenant and op (ops that stamp rows)",
                ("tenant", "op"))

    def bill(
        self,
        job_id: str,
        tenant: str,
        tier: int,
        op: str,
        attempt: Any,
        usage: Any = None,
        wire_bytes: int = 0,
    ) -> Optional[Dict[str, float]]:
        """Bill one accepted result application. Returns the sanitized usage
        actually billed (what the caller journals), or ``None`` when this
        ``(job_id, attempt)`` was already billed — the structural guard
        that makes "billed exactly once" hold under duplicate delivery."""
        clean = sanitize_usage(usage)
        if not clean and wire_bytes <= 0:
            return None  # nothing measurable to bill
        attempt_key = int(attempt) if isinstance(attempt, int) \
            and not isinstance(attempt, bool) else -1
        wire_bytes = max(0, int(wire_bytes))
        with self._lock:
            entry = self._jobs.get(job_id)
            if entry is not None and attempt_key in entry["attempts"]:
                return None
            if entry is None:
                entry = {
                    "job_id": job_id,
                    "tenant": tenant,
                    "tier": int(tier),
                    "op": op,
                    "attempts": set(),
                    **dict(_ZERO),
                }
                self._jobs[job_id] = entry
                if len(self._jobs) > self.max_jobs:
                    self._evict_locked(keep=job_id)
            entry["attempts"].add(attempt_key)
            _accumulate(entry, clean, wire_bytes)
            key = (tenant, int(tier), op)
            bucket = self._by_key.get(key)
            if bucket is None:
                bucket = dict(_ZERO)
                self._by_key[key] = bucket
            _accumulate(bucket, clean, wire_bytes)
            self.billed_tasks += 1
        if self._m_tasks is not None:
            self._m_tasks.inc(tenant=tenant, op=op)
            if clean.get("device_s"):
                self._m_device.inc(clean["device_s"], tenant=tenant, op=op)
            if clean.get("rows"):
                self._m_rows.inc(int(clean["rows"]), tenant=tenant, op=op)
        billed = dict(clean)
        if wire_bytes:
            billed["wire_bytes"] = billed.get("wire_bytes", 0) + wire_bytes
        return billed

    def _evict_locked(self, keep: str) -> None:
        victim = min(
            (jid for jid in self._jobs if jid != keep),
            key=lambda jid: self._jobs[jid]["device_seconds"],
            default=None,
        )
        if victim is not None:
            del self._jobs[victim]
            self.evicted_jobs += 1

    def export_state(self) -> Dict[str, Any]:
        """JSON-serializable image of the ledger for the controller's
        compacting journal snapshot: aggregates, per-job table
        (billed-attempt sets as sorted lists), and the counters. Exact —
        ``import_state`` rebuilds a ledger indistinguishable from one that
        replayed the full journal."""
        with self._lock:
            return {
                "by_key": [
                    [t, tier, op, _rounded(b)]
                    for (t, tier, op), b in self._by_key.items()
                ],
                "jobs": [
                    {
                        **{k: v for k, v in e.items() if k != "attempts"},
                        "attempts": sorted(e["attempts"]),
                    }
                    for e in self._jobs.values()
                ],
                "billed_tasks": self.billed_tasks,
                "evicted_jobs": self.evicted_jobs,
            }

    def import_state(
        self, doc: Mapping[str, Any], mirror: bool = True
    ) -> None:
        """Rehydrate from ``export_state`` output (snapshot replay). With
        ``mirror`` the Prometheus counters re-increment from the
        aggregates so a snapshot-based replay exports the same totals a
        full-journal replay would; a standby RESYNC passes ``mirror=False``
        (its mirrors already counted the events it applied live —
        re-incrementing would double them)."""
        with self._lock:
            self._by_key = {}
            for item in doc.get("by_key") or []:
                try:
                    tenant, tier, op, bucket = item
                except (TypeError, ValueError):
                    continue
                b = dict(_ZERO)
                for f in _ZERO:
                    v = (bucket or {}).get(f)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        b[f] = type(_ZERO[f])(v)
                self._by_key[(str(tenant), int(tier), str(op))] = b
            self._jobs = {}
            for rec in doc.get("jobs") or []:
                if not isinstance(rec, Mapping) or "job_id" not in rec:
                    continue
                entry = {
                    "job_id": str(rec["job_id"]),
                    "tenant": str(rec.get("tenant", "default")),
                    "tier": int(rec.get("tier", 0)),
                    "op": str(rec.get("op", "?")),
                    "attempts": set(
                        a for a in rec.get("attempts") or []
                        if isinstance(a, int)
                    ),
                    **dict(_ZERO),
                }
                for f in _ZERO:
                    v = rec.get(f)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        entry[f] = type(_ZERO[f])(v)
                self._jobs[entry["job_id"]] = entry
            self.billed_tasks = int(doc.get("billed_tasks", 0))
            self.evicted_jobs = int(doc.get("evicted_jobs", 0))
            by_key = dict(self._by_key)
        if self._m_tasks is not None and mirror:
            for (tenant, _tier, op), b in by_key.items():
                if b["tasks"]:
                    self._m_tasks.inc(b["tasks"], tenant=tenant, op=op)
                if b["device_seconds"]:
                    self._m_device.inc(
                        b["device_seconds"], tenant=tenant, op=op
                    )
                if b["rows"]:
                    self._m_rows.inc(int(b["rows"]), tenant=tenant, op=op)

    def job_billed_attempts(self) -> Dict[str, int]:
        """``{job_id: distinct billed attempts}`` — what the chaos soak pins
        ("retries/duplicates billed exactly once" = every value here is 1
        on a drain where each job's result applied once)."""
        with self._lock:
            return {jid: len(e["attempts"]) for jid, e in self._jobs.items()}

    def _cost(self, chip_seconds: float) -> Optional[float]:
        if self.cost_per_chip_hour <= 0:
            return None
        return round(chip_seconds / 3600.0 * self.cost_per_chip_hour, 6)

    def _est_cost(self, bucket: Mapping[str, Any]) -> Optional[float]:
        """Chip-second cost plus the cache price for deduped results —
        None when neither price is configured (showback without rates)."""
        chip = self._cost(float(bucket.get("chip_seconds", 0.0)))
        cache = None
        if self.cache_price_per_hit > 0:
            cache = round(
                float(bucket.get("result_cache_hits", 0) or 0)
                * self.cache_price_per_hit, 6
            )
        if chip is None and cache is None:
            return None
        return round((chip or 0.0) + (cache or 0.0), 6)

    def report(
        self,
        top_k: Optional[int] = None,
        pending_by_tenant: Optional[Mapping[str, int]] = None,
    ) -> Dict[str, Any]:
        """The ``GET /v1/usage`` body: grand totals, per-tenant rollups with
        per-op and per-tier splits, and the top-K jobs by device seconds."""
        k = self.top_k if top_k is None else max(1, int(top_k))
        with self._lock:
            by_key = {key: dict(b) for key, b in self._by_key.items()}
            jobs = [
                {kk: vv for kk, vv in e.items() if kk != "attempts"}
                | {"attempts_billed": len(e["attempts"])}
                for e in self._jobs.values()
            ]
            billed = self.billed_tasks
            evicted = self.evicted_jobs
        totals = dict(_ZERO)
        tenants: Dict[str, Dict[str, Any]] = {}
        for (tenant, tier, op), bucket in sorted(by_key.items()):
            for f in _ZERO:
                totals[f] += bucket[f]
            t = tenants.setdefault(tenant, {
                **dict(_ZERO), "by_op": {}, "by_tier": {},
            })
            for f in _ZERO:
                t[f] += bucket[f]
            op_b = t["by_op"].setdefault(op, dict(_ZERO))
            tier_b = t["by_tier"].setdefault(str(tier), dict(_ZERO))
            for f in _ZERO:
                op_b[f] += bucket[f]
                tier_b[f] += bucket[f]
        top = sorted(
            jobs, key=lambda e: e["device_seconds"], reverse=True
        )[:k]
        out: Dict[str, Any] = {
            "enabled": True,
            "since_wall": round(self.started_wall, 3),
            "billed_tasks": billed,
            "evicted_jobs": evicted,
            "cost_per_chip_hour": self.cost_per_chip_hour,
            "cache_price_per_hit": self.cache_price_per_hit,
            "totals": {
                **_rounded(totals),
                "est_cost": self._est_cost(totals),
                "prefix_dedupe_ratio": _dedupe_ratio(totals),
                "result_dedupe_ratio": _result_dedupe_ratio(totals),
            },
            "by_tenant": {
                tenant: {
                    **_rounded(t),
                    "est_cost": self._est_cost(t),
                    # What fraction of this tenant's prefill rows the prefix
                    # cache absorbed: cache_hit_rows
                    # was billed all along but never surfaced as a rate.
                    "prefix_dedupe_ratio": _dedupe_ratio(t),
                    # What fraction of this tenant's billed results the
                    # content-addressed result cache served.
                    "result_dedupe_ratio": _result_dedupe_ratio(t),
                    "by_op": {
                        op: _rounded(b) for op, b in sorted(t["by_op"].items())
                    },
                    "by_tier": {
                        tier: _rounded(b)
                        for tier, b in sorted(t["by_tier"].items())
                    },
                }
                for tenant, t in sorted(tenants.items())
            },
            "top_jobs": [
                {
                    "job_id": e["job_id"],
                    "tenant": e["tenant"],
                    "tier": e["tier"],
                    "op": e["op"],
                    "attempts_billed": e["attempts_billed"],
                    **_rounded(e),
                }
                for e in top
            ],
        }
        if pending_by_tenant is not None:
            out["pending_by_tenant"] = {
                t: int(n) for t, n in sorted(pending_by_tenant.items())
            }
        return out


def _dedupe_ratio(bucket: Mapping[str, Any]) -> Optional[float]:
    """cache_hit_rows / (rows + cache_hit_rows) — the share of prefill
    demand the prefix cache deduplicated away. None when no rows billed
    yet (0/0 is "no data", not "no dedupe")."""
    hits = float(bucket.get("cache_hit_rows", 0) or 0)
    rows = float(bucket.get("rows", 0) or 0)
    denom = rows + hits
    if denom <= 0:
        return None
    return round(hits / denom, 4)


def _result_dedupe_ratio(bucket: Mapping[str, Any]) -> Optional[float]:
    """result_cache_hits / tasks — the share of billed result applications
    the content-addressed result cache served instead of the fleet
    computing them. None before anything billed."""
    tasks = float(bucket.get("tasks", 0) or 0)
    if tasks <= 0:
        return None
    hits = float(bucket.get("result_cache_hits", 0) or 0)
    return round(hits / tasks, 4)


def stamp_usage(tags: Optional[Dict[str, Any]], **fields: float) -> None:
    """Add each field into ``tags["usage"]``; ``chips`` is a level, not an
    accumulator (last writer wins), and a None field is skipped."""
    if tags is None:
        return
    u = tags.setdefault("usage", {})
    for key, value in fields.items():
        if value is None:
            continue
        if key == "chips":
            u["chips"] = float(value)
        else:
            u[key] = u.get(key, 0.0) + float(value)
