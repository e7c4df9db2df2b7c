"""Stateless HTTP router fronting N controller partitions — the port's
counterpart of ``agent_tpu.controller.router``, host code that imports no
torch.

``python -m agent_tpu_torch.controller.router`` is the one address clients and
agents see: it proxies the write path (``/v1/jobs``, ``/v1/infer``,
``/v1/leases``, ``/v1/results``) to the home partition picked by the
consistent hash in ``controller/partition.py`` and fans out + merges the
read path (``/v1/status``, ``/v1/health``, ``/v1/usage``, ``/v1/metrics``,
``/v1/timeseries``, ``/v1/debug/requests``) so the fleet reads as one
controller. By-id lookups (``/v1/jobs/<id>``, ``/v1/infer/<id>``,
``/v1/trace/<id>``) fan out and return the first partition that knows the
id.

The router holds no durable state — placement is a pure hash, lease
routing rides the ``<partition>!<lease_id>`` tags, and per-partition depth
samples are a TTL cache — so it can be restarted (or replicated) freely;
robustness lives in the partitions' own journals and standbys. 429s
aggregate by construction: only the home partition is asked, so a submit
is rejected exactly when its home partition rejects it, and the
partition's ``retry_after_ms`` (and ``Retry-After`` header) pass through
untouched, with the partition name stamped into the body so loadgen can
count drops per partition.

Deployment modes (env):

- ``PARTITION_URLS="p0=http://a|http://a-standby,p1=http://b"`` — front an
  existing fleet of ``python -m agent_tpu_torch.controller.server`` processes
  (each started with ``CONTROLLER_PARTITION=<name>`` and its own
  ``CONTROLLER_JOURNAL``); the ``|`` alternates are each partition's
  failover slots (where its promoted hot standby serves).
- ``PARTITIONS=N`` (no URLs) — boot N in-process partitions on ephemeral
  ports (journals at ``$CONTROLLER_JOURNAL.pI``): the single-host
  convenience mode. For real throughput run one server process per
  partition — N partitions in one process share a GIL.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from agent_tpu_torch.controller.partition import (
    LocalPartitionSet,
    PartitionDown,
    PartitionMap,
    RouterCore,
)
from agent_tpu_torch.obs.metrics import parse_exposition
from agent_tpu_torch.obs.timeseries import TimeSeriesRing
from agent_tpu_torch.obs.tsdb import TsdbStore, query_history
from agent_tpu_torch.sched.steal import StealPolicy

_VERDICT_RANK = {"ok": 0, "warn": 1, "page": 2}


def http_post_json(
    url: str, path: str, body: Dict[str, Any], timeout: float
) -> Tuple[int, Any]:
    """The RouterCore transport: POST JSON, return (status, parsed body).
    HTTP error statuses (429, 400, ...) are RESPONSES to pass through,
    not transport failures; only the OSError family (URLError, timeouts,
    refused connections) propagates for URL rotation."""
    data = json.dumps(body, default=str).encode()
    req = urllib.request.Request(
        url + path,
        data=data,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read()
    except http.client.HTTPException as exc:
        # A partition dying mid-response surfaces as IncompleteRead /
        # RemoteDisconnected — http.client exceptions, NOT OSErrors. The
        # RouterCore's failover/PartitionDown handling keys on OSError, so
        # normalize.
        raise ConnectionError(f"partition died mid-response: {exc}") from exc
    try:
        parsed = json.loads(raw.decode("utf-8")) if raw else None
    except ValueError:
        parsed = None
    return status, parsed


def http_get_json(url: str, path: str, timeout: float) -> Tuple[int, Any]:
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read()
    except http.client.HTTPException as exc:
        raise ConnectionError(f"partition died mid-response: {exc}") from exc
    try:
        parsed = json.loads(raw.decode("utf-8")) if raw else None
    except ValueError:
        parsed = raw.decode("utf-8", errors="replace") if raw else None
    return status, parsed


# ---- fan-out merges ----


def _worst_verdict(verdicts: List[str]) -> str:
    return max(verdicts or ["ok"], key=lambda v: _VERDICT_RANK.get(v, 2))


def _sum_counts(
    docs: List[Dict[str, Any]], key: str
) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for doc in docs:
        for k, v in (doc.get(key) or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = out.get(k, 0) + int(v)
    return out


def deep_sum(docs: List[Any]) -> Any:
    """Generic numeric merge for /v1/usage: dicts merge recursively,
    numbers sum, lists concatenate, anything else keeps the first
    partition's value. Usage reports are per-tenant/per-op numeric
    rollups, which this folds exactly; stray strings (enabled flags,
    names) stay stable."""
    docs = [d for d in docs if d is not None]
    if not docs:
        return None
    first = docs[0]
    if isinstance(first, dict):
        keys: List[str] = []
        for d in docs:
            if isinstance(d, dict):
                for k in d:
                    if k not in keys:
                        keys.append(k)
        return {
            k: deep_sum([
                d.get(k) for d in docs if isinstance(d, dict) and k in d
            ])
            for k in keys
        }
    if isinstance(first, bool):
        return any(d for d in docs if isinstance(d, bool))
    if isinstance(first, (int, float)):
        total = sum(
            d for d in docs
            if isinstance(d, (int, float)) and not isinstance(d, bool)
        )
        return total if not isinstance(first, int) or isinstance(
            total, float
        ) else int(total)
    if isinstance(first, list):
        out: List[Any] = []
        for d in docs:
            if isinstance(d, list):
                out.extend(d)
        return out
    return first


def merge_status(
    results: Dict[str, Optional[Dict[str, Any]]],
    pmap: PartitionMap,
    router_stats: Dict[str, Any],
) -> Dict[str, Any]:
    """One /v1/status doc for the whole partitioned plane: fleet-summed
    counters, agents deduped by name (an agent that stole shows up in two
    partitions' registries), and one row per partition — queue depth,
    journal block, reachability — for swarmtop's partition table."""
    up = {n: d for n, d in results.items() if isinstance(d, dict)}
    docs = list(up.values())
    rows = []
    for name in pmap.names:
        doc = results.get(name)
        row: Dict[str, Any] = {
            "name": name,
            "url": pmap.urls(name)[0],
            "ok": isinstance(doc, dict),
        }
        if isinstance(doc, dict):
            row.update({
                "queue_depth": doc.get("queue_depth", 0),
                "counts": doc.get("counts") or {},
                "drained": bool(doc.get("drained")),
                "journal": doc.get("journal") or {},
            })
        rows.append(row)
    agents: Dict[str, Any] = {}
    for doc in docs:
        for name, row in (doc.get("agents") or {}).items():
            prev = agents.get(name)
            if prev is None or (
                row.get("last_seen_sec_ago", 1e9)
                < prev.get("last_seen_sec_ago", 1e9)
            ):
                agents[name] = row
    counts_by_op: Dict[str, Dict[str, int]] = {}
    for doc in docs:
        for op, per in (doc.get("counts_by_op") or {}).items():
            tgt = counts_by_op.setdefault(op, {})
            for state, n in per.items():
                tgt[state] = tgt.get(state, 0) + int(n)
    serving_docs = [
        doc.get("serving") for doc in docs
        if isinstance(doc.get("serving"), dict)
    ]
    serving: Dict[str, Any] = {
        "enabled": any(d.get("enabled") for d in serving_docs),
    }
    if serving["enabled"]:
        serving.update({
            "requests": _sum_counts(serving_docs, "requests"),
            "open_buckets": sum(
                int(d.get("open_buckets", 0)) for d in serving_docs
            ),
            "bucketed": sum(
                int(d.get("bucketed", 0)) for d in serving_docs
            ),
            "jobs_in_flight": sum(
                int(d.get("jobs_in_flight", 0)) for d in serving_docs
            ),
            "rejected": sum(
                int(d.get("rejected", 0)) for d in serving_docs
            ),
        })
    ops: Dict[str, Dict[str, Any]] = {}
    phases: Dict[str, Any] = {}
    uptime = 0.0
    for doc in docs:
        summary = doc.get("summary") or {}
        uptime = max(uptime, float(summary.get("uptime_sec") or 0.0))
        for op, entry in (summary.get("ops") or {}).items():
            tgt = ops.setdefault(
                op, {"succeeded": 0, "failed": 0, "tasks_per_sec": 0.0}
            )
            tgt["succeeded"] += int(entry.get("succeeded", 0))
            tgt["failed"] += int(entry.get("failed", 0))
            tgt["tasks_per_sec"] = round(
                tgt["tasks_per_sec"] + float(entry.get("tasks_per_sec", 0.0)),
                3,
            )
        for op, per in (summary.get("task_phase_seconds") or {}).items():
            phases.setdefault(op, per)
    return {
        "partitioned": True,
        "partitions": rows,
        "router": router_stats,
        "counts": _sum_counts(docs, "counts"),
        "counts_by_op": counts_by_op,
        "queue_depth": sum(int(d.get("queue_depth", 0)) for d in docs),
        # A fleet with an unreachable partition is NOT drained — its jobs
        # are unobservable, not done.
        "drained": len(up) == len(pmap.names)
        and all(bool(d.get("drained")) for d in docs),
        "stale_results": sum(int(d.get("stale_results", 0)) for d in docs),
        "agents": agents,
        "summary": {
            "uptime_sec": uptime,
            "ops": ops,
            "task_phase_seconds": phases,
        },
        "journal": {
            name: (results[name] or {}).get("journal") or {}
            for name in pmap.names
            if isinstance(results.get(name), dict)
        },
        "serving": serving,
        "last_metrics": {},
    }


def merge_health(
    results: Dict[str, Optional[Dict[str, Any]]],
    pmap: PartitionMap,
) -> Dict[str, Any]:
    """One /v1/health verdict: the WORST partition wins, an unreachable
    partition pages (its jobs and journal are dark), reasons carry their
    partition, objectives concatenate suffixed ``@partition``."""
    up = {n: d for n, d in results.items() if isinstance(d, dict)}
    docs = list(up.values())
    verdicts = [str(d.get("verdict", "page")) for d in docs]
    reasons: List[Dict[str, Any]] = []
    rows = []
    for name in pmap.names:
        doc = results.get(name)
        ok = isinstance(doc, dict)
        rows.append({
            "name": name,
            "ok": ok,
            "verdict": str(doc.get("verdict")) if ok else "page",
        })
        if not ok:
            verdicts.append("page")
            reasons.append({
                "kind": "partition_unreachable", "partition": name,
            })
            continue
        for reason in doc.get("reasons") or []:
            reasons.append(dict(reason, partition=name))
    objectives: List[Dict[str, Any]] = []
    for name, doc in up.items():
        for obj in (doc.get("slo") or {}).get("objectives") or []:
            entry = dict(obj)
            if len(pmap.names) > 1:
                entry["objective"] = f"{obj.get('objective')}@{name}"
            objectives.append(entry)
    agents: Dict[str, Any] = {}
    for doc in docs:
        for name, row in (doc.get("agents") or {}).items():
            prev = agents.get(name)
            if prev is None or (
                row.get("last_seen_sec_ago", 1e9)
                < prev.get("last_seen_sec_ago", 1e9)
            ):
                agents[name] = row
    by_tier: Dict[str, int] = {}
    starvation: Optional[float] = None
    for doc in docs:
        q = doc.get("queue") or {}
        for tier, n in (q.get("by_tier") or {}).items():
            by_tier[tier] = by_tier.get(tier, 0) + int(n)
        age = q.get("starvation_age_sec")
        if isinstance(age, (int, float)):
            starvation = max(starvation or 0.0, float(age))
    return {
        "verdict": _worst_verdict(verdicts),
        "reasons": reasons,
        "generated_at": round(time.time(), 3),
        "partitioned": True,
        "partitions": rows,
        "slo": {
            "enabled": any(
                (d.get("slo") or {}).get("enabled") for d in docs
            ),
            "objectives": objectives,
        },
        "queue": {
            "depth": sum(
                int((d.get("queue") or {}).get("depth", 0)) for d in docs
            ),
            "by_tier": by_tier,
            "starvation_age_sec": starvation,
        },
        "counts": _sum_counts(docs, "counts"),
        "fleet": {
            "n_agents": len(agents),
            "n_stale": sum(1 for r in agents.values() if r.get("stale")),
        },
        "agents": agents,
    }


def _escape_label(value: Any) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def merge_metrics(
    texts: Dict[str, Optional[str]], router_stats: Dict[str, Any]
) -> str:
    """One exposition for the plane: every partition's samples re-emitted
    with a ``partition`` label (cumulative families sum correctly across
    label sets downstream — swarmtop's quantile/total helpers already
    merge label sets), plus the router's own counters. Untyped on purpose:
    HELP/TYPE metadata doesn't survive a merge of N sources cleanly, and
    every consumer in this repo parses samples, not metadata."""
    lines: List[str] = []
    for name in sorted(texts):
        text = texts[name]
        if not text:
            continue
        try:
            samples = parse_exposition(text)
        except ValueError:
            continue
        for family in sorted(samples):
            for labels, value in samples[family]:
                merged = dict(labels, partition=name)
                label_s = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(merged.items())
                )
                lines.append(f"{family}{{{label_s}}} {float(value)!r}")
    for key, value in sorted(router_stats.items()):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        lines.append(f"router_{key} {float(value)!r}")
    return "\n".join(lines) + "\n"


# ---- fleet telemetry collection ----


def _relabel_partition(
    data: Dict[str, Any], partition: str
) -> Dict[str, Dict[str, float]]:
    """Inject ``partition=<name>`` into every series label key of one
    scraped sample — the fleet store's series identity."""
    out: Dict[str, Dict[str, float]] = {}
    for fam, series in (data or {}).items():
        if not isinstance(series, dict):
            continue
        dst = out.setdefault(fam, {})
        for key, v in series.items():
            try:
                labels = [
                    list(p) for p in json.loads(key)
                    if isinstance(p, (list, tuple)) and len(p) == 2
                    and p[0] != "partition"
                ]
            except ValueError:
                continue
            labels.append(["partition", partition])
            dst[json.dumps(sorted(labels), separators=(",", ":"))] = \
                float(v)
    return out


class FleetCollector:
    """Scrapes each partition's ``/v1/timeseries/export`` deltas into one
    fleet store (``partition``-labelled), so the router's
    ``GET /v1/timeseries?since=`` answers fleet-wide historical queries —
    the durable follow-up to the live-only fan-out merge. One wall-clock
    cursor per partition; a partition restart resets its ring but not the
    cursor (walls are wall-clock, so history never replays twice)."""

    def __init__(
        self,
        pmap: PartitionMap,
        interval_sec: float = 10.0,
        window_sec: float = 900.0,
        tsdb_dir: str = "",
        timeout_sec: float = 5.0,
        get_fn: Optional[Any] = None,
    ) -> None:
        self.pmap = pmap
        self.interval_sec = max(0.25, float(interval_sec))
        self.timeout_sec = timeout_sec
        self.get_fn = get_fn if get_fn is not None else http_get_json
        # The fleet ring holds len(pmap) partitions' samples per scrape
        # round — size its slot budget accordingly.
        self.ring = TimeSeriesRing(
            window_sec=max(self.interval_sec, float(window_sec)),
            interval_sec=self.interval_sec / max(1, len(pmap.names)),
        )
        self.store: Optional[TsdbStore] = None
        if tsdb_dir:
            self.store = TsdbStore(tsdb_dir)
        self._cursors: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scrapes = 0
        self.scrape_errors = 0
        self.samples_collected = 0

    def collect_once(self) -> int:
        """One scrape round across all partitions; returns samples
        collected. Each partition's failover slots are tried in order —
        a promoted standby keeps feeding the fleet view."""
        collected = 0
        for name in self.pmap.names:
            cursor = self._cursors.get(name, 0.0)
            doc = None
            for url in self.pmap.urls(name):
                try:
                    status, parsed = self.get_fn(
                        url,
                        f"/v1/timeseries/export?since={cursor!r}",
                        self.timeout_sec,
                    )
                except (OSError, ConnectionError):
                    continue
                if status == 200 and isinstance(parsed, dict):
                    doc = parsed
                    break
            self.scrapes += 1
            if doc is None:
                self.scrape_errors += 1
                continue
            for sample in doc.get("samples") or []:
                if not isinstance(sample, dict):
                    continue
                wall = sample.get("wall")
                if not isinstance(wall, (int, float)):
                    continue
                data = _relabel_partition(sample.get("data") or {}, name)
                self.ring.append_flat(float(wall), data)
                if self.store is not None:
                    self.store.append_sample(float(wall), data)
                cursor = max(cursor, float(wall))
                collected += 1
            self._cursors[name] = cursor
        self.samples_collected += collected
        return collected

    def query(
        self,
        name: str,
        label_filter: Optional[Dict[str, str]] = None,
        rate: bool = False,
        since: Optional[float] = None,
        step: Optional[float] = None,
    ) -> Dict[str, Any]:
        out = query_history(
            name, label_filter=label_filter, rate=rate,
            since=since, step=step, ring=self.ring, store=self.store,
        )
        out["fleet"] = True
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "interval_sec": self.interval_sec,
            "scrapes": self.scrapes,
            "scrape_errors": self.scrape_errors,
            "samples_collected": self.samples_collected,
            "cursors": {k: round(v, 3) for k, v in self._cursors.items()},
            "store": self.store.stats() if self.store is not None else None,
        }

    def start(self) -> "FleetCollector":
        if self._thread is None:
            self._stop.clear()

            def loop() -> None:
                while not self._stop.wait(self.interval_sec):
                    try:
                        self.collect_once()
                    except Exception:  # noqa: BLE001 — a scrape hiccup
                        # must not kill the collector; next round retries.
                        self.scrape_errors += 1

            self._thread = threading.Thread(
                target=loop, name="fleet-collector", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.store is not None:
            self.store.close()


# ---- the HTTP process ----


class _RouterHandler(BaseHTTPRequestHandler):
    core: RouterCore              # set by RouterServer on the built class
    fanout_timeout_sec: float = 5.0
    collector: Optional[FleetCollector] = None  # set by RouterServer

    def log_message(self, *args: Any) -> None:
        pass

    def _read_json(self) -> Optional[Dict[str, Any]]:
        try:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length) if length else b"{}"
            body = json.loads(raw or b"{}")
        except (ValueError, OSError):
            return None
        return body if isinstance(body, dict) else None

    def _send(self, status: int, body: Any = None) -> None:
        self.send_response(status)
        if body is None:
            self.end_headers()
            return
        data = json.dumps(body, default=str).encode()
        self.send_header("Content-Type", "application/json")
        if status == 429 and isinstance(body, dict):
            # Pass the partition's backpressure hint through header-level
            # too, matching the controller's own 429 shape.
            retry_ms = body.get("retry_after_ms")
            if isinstance(retry_ms, (int, float)):
                self.send_header(
                    "Retry-After", str(max(1, (int(retry_ms) + 999) // 1000))
                )
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_text(self, status: int, text: str, content_type: str) -> None:
        data = text.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # ---- fan-out helpers ----

    def _fanout_get(self, path: str) -> Dict[str, Any]:
        """GET ``path`` from every partition; unreachable/parse-failed
        partitions map to None."""
        core = self.core
        out: Dict[str, Any] = {}
        for name in core.pmap.names:
            try:
                status, parsed = core.get_partition(name, path)
            except (PartitionDown, OSError):
                out[name] = None
                continue
            out[name] = parsed if status == 200 else None
        return out

    def _first_found(self, path: str) -> None:
        """By-id lookups: the owning partition answers 200, the rest 404 —
        return the first 200 (or the last 404)."""
        last: Tuple[int, Any] = (404, {"error": f"no partition knows {path}"})
        for name in self.core.pmap.names:
            try:
                status, parsed = self.core.get_partition(name, path)
            except (PartitionDown, OSError):
                continue
            if status == 200:
                self._send(200, parsed)
                return
            last = (status, parsed)
        self._send(last[0], last[1] if isinstance(last[1], dict) else None)

    def _proxy_stream_infer(self, body: Dict[str, Any]) -> None:
        """stream:true /v1/infer — relay the partition's chunked NDJSON
        lifecycle stream byte-for-byte (urllib de-chunks; we re-frame)."""
        core = self.core
        params = body.get("params")
        tenant = body.get("tenant") or (
            params.get("tenant") if isinstance(params, dict) else None
        )
        name = core.home_for_tenant(tenant)
        url = core.pmap.urls(name)[0]
        req = urllib.request.Request(
            url + "/v1/infer",
            data=json.dumps(body, default=str).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            upstream = urllib.request.urlopen(req, timeout=None)
        except urllib.error.HTTPError as exc:
            raw = exc.read()
            try:
                self._send(exc.code, json.loads(raw.decode()))
            except ValueError:
                self._send(exc.code, {"error": raw.decode(errors="replace")})
            return
        except OSError:
            self._send(503, {"error": f"partition {name} unreachable"})
            return
        with upstream:
            self.send_response(upstream.status)
            self.send_header(
                "Content-Type",
                upstream.headers.get("Content-Type", "application/x-ndjson"),
            )
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                while True:
                    chunk = upstream.read(65536)
                    if not chunk:
                        break
                    self.wfile.write(
                        f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n"
                    )
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass

    # ---- HTTP surface ----

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        body = self._read_json()
        if body is None:
            self._send(400, {"error": "invalid JSON body"})
            return
        core = self.core
        try:
            if self.path == "/v1/jobs":
                status, parsed = core.route_submit(body)
            elif self.path == "/v1/workflows":
                status, parsed = core.route_workflow(body)
            elif self.path == "/v1/leases":
                status, parsed = core.route_lease(body)
            elif self.path == "/v1/results":
                status, parsed = core.route_result(body)
            elif self.path == "/v1/infer":
                if body.get("stream"):
                    self._proxy_stream_infer(body)
                    return
                status, parsed = core.route_infer(body)
            elif self.path == "/v1/profile/capture":
                # Capture requests target an agent, and any partition that
                # agent leases from can deliver the alert — hand it to the
                # agent's home partition.
                name = core.home_for_agent(str(body.get("agent") or ""))
                status, parsed = core.post_partition(
                    name, "/v1/profile/capture", body
                )
            else:
                self._send(404, {"error": f"no route {self.path}"})
                return
        except PartitionDown as exc:
            self._send(
                503,
                {"error": str(exc), "partition": exc.partition},
            )
            return
        if status == 204:
            self._send(204)
        else:
            self._send(
                status, parsed if isinstance(parsed, (dict, list)) else None
            )

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        core = self.core
        path = self.path
        if path == "/v1/status":
            self._send(200, merge_status(
                self._fanout_get("/v1/status"), core.pmap, core.stats()
            ))
        elif path == "/v1/health":
            self._send(
                200, merge_health(self._fanout_get("/v1/health"), core.pmap)
            )
        elif path.startswith("/v1/usage"):
            results = self._fanout_get(path)
            docs = [d for d in results.values() if isinstance(d, dict)]
            merged = deep_sum(docs) if docs else {"enabled": False}
            merged["partitions"] = {
                name: {
                    "ok": isinstance(doc, dict),
                    "billed_tasks": (doc or {}).get("billed_tasks"),
                }
                for name, doc in results.items()
            }
            self._send(200, merged)
        elif path == "/v1/metrics":
            texts = {}
            for name in core.pmap.names:
                try:
                    status, parsed = core.get_partition(name, "/v1/metrics")
                except (PartitionDown, OSError):
                    texts[name] = None
                    continue
                texts[name] = parsed if (
                    status == 200 and isinstance(parsed, str)
                ) else None
            self._send_text(
                200,
                merge_metrics(texts, core.stats()),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif path == "/v1/depth":
            depths = core.leasable_depths()
            self._send(200, {
                "partitions": depths,
                "leasable": sum(v or 0 for v in depths.values()),
            })
        elif path == "/v1/router":
            self._send(200, core.stats())
        elif path.startswith("/v1/timeseries"):
            split = urlsplit(path)
            q = parse_qs(split.query)
            if (
                self.collector is not None
                and split.path == "/v1/timeseries"
                and ("since" in q or "step" in q)
            ):
                # Historical fleet query: served from the
                # router's own collected store, partition-labelled.
                name = q.get("name", [None])[0]
                if not name:
                    self._send(400, {"error": "name is required"})
                    return
                try:
                    since = (
                        float(q["since"][0]) if "since" in q else None
                    )
                    step = float(q["step"][0]) if "step" in q else None
                except ValueError:
                    self._send(400, {
                        "error": "since/step must be numbers"
                    })
                    return
                if since is not None and since <= 1e6:
                    since = time.time() - max(0.0, since)
                rate = q.get("rate", ["0"])[0] in ("1", "true", "yes")
                label_filter = {
                    k: v[0] for k, v in q.items()
                    if k not in
                    ("name", "rate", "window_sec", "since", "step") and v
                }
                body = self.collector.query(
                    name, label_filter or None, rate=rate,
                    since=since, step=step,
                )
                body["enabled"] = True
                self._send(200, body)
                return
            results = self._fanout_get(path)
            series: List[Any] = []
            enabled = False
            name_field = None
            for doc in results.values():
                if not isinstance(doc, dict):
                    continue
                enabled = enabled or bool(doc.get("enabled"))
                name_field = name_field or doc.get("name")
                series.extend(doc.get("series") or [])
            self._send(
                200,
                {"enabled": enabled, "name": name_field, "series": series},
            )
        elif path == "/v1/incidents":
            results = self._fanout_get(path)
            incidents: List[Any] = []
            enabled = False
            for pname, doc in results.items():
                if not isinstance(doc, dict):
                    continue
                enabled = enabled or bool(doc.get("enabled"))
                for header in doc.get("incidents") or []:
                    if isinstance(header, dict):
                        header = dict(header)
                        header["partition"] = pname
                        incidents.append(header)
            incidents.sort(
                key=lambda h: (h.get("wall") or 0.0), reverse=True
            )
            self._send(200, {"enabled": enabled, "incidents": incidents})
        elif path.startswith("/v1/debug/requests"):
            results = self._fanout_get(path)
            merged_reqs: List[Any] = []
            enabled = False
            for doc in results.values():
                if not isinstance(doc, dict):
                    continue
                enabled = enabled or bool(doc.get("enabled"))
                merged_reqs.extend(doc.get("requests") or [])
            self._send(200, {"enabled": enabled, "requests": merged_reqs})
        elif path.startswith((
            "/v1/jobs/", "/v1/infer/", "/v1/trace/", "/v1/traces",
            "/v1/debug/events", "/v1/profile/", "/v1/workflows/",
            "/v1/incidents/",
        )):
            self._first_found(path)
        else:
            self._send(404, {"error": f"no route {path}"})


class RouterServer:
    """Owns a RouterCore + an HTTP server on a background thread — the
    router-side twin of ``ControllerServer`` (``port=0`` binds ephemeral;
    ``url`` is what CONTROLLER_URL(S) point at)."""

    def __init__(
        self,
        pmap: PartitionMap,
        host: str = "127.0.0.1",
        port: int = 0,
        steal: Optional[StealPolicy] = None,
        depth_cache_sec: float = 0.25,
        timeout_sec: float = 30.0,
        fanout_timeout_sec: float = 5.0,
        collect_interval_sec: float = 0.0,
        fleet_tsdb_dir: str = "",
        fleet_window_sec: float = 900.0,
    ) -> None:
        def post_fn(url, path, body, _timeout):  # noqa: ANN001
            return http_post_json(url, path, body, timeout_sec)

        def get_fn(url, path, _timeout):  # noqa: ANN001
            return http_get_json(url, path, fanout_timeout_sec)

        self.core = RouterCore(
            pmap,
            post_fn,
            get_fn=get_fn,
            steal=steal,
            depth_cache_sec=depth_cache_sec,
            timeout_sec=timeout_sec,
        )
        # Fleet telemetry collection: >0 scrapes each
        # partition's export deltas into one partition-labelled store.
        self.collector: Optional[FleetCollector] = None
        if collect_interval_sec > 0:
            self.collector = FleetCollector(
                pmap,
                interval_sec=collect_interval_sec,
                window_sec=fleet_window_sec,
                tsdb_dir=fleet_tsdb_dir,
                timeout_sec=fanout_timeout_sec,
            )
        handler = type(
            "Handler",
            (_RouterHandler,),
            {
                "core": self.core,
                "fanout_timeout_sec": fanout_timeout_sec,
                "collector": self.collector,
            },
        )
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "RouterServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="router-http", daemon=True
        )
        self._thread.start()
        if self.collector is not None:
            self.collector.start()
        return self

    def stop(self) -> None:
        if self.collector is not None:
            self.collector.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def main() -> int:
    """Standalone router: ``python -m agent_tpu_torch.controller.router``. Env:
    ROUTER_HOST (default 0.0.0.0), ROUTER_PORT (default 8800),
    PARTITION_URLS (front an existing partition fleet) or PARTITIONS=N
    (boot N in-process partitions, journals at ``$CONTROLLER_JOURNAL.pI``),
    ROUTER_DEPTH_CACHE_SEC / ROUTER_TIMEOUT_SEC, and the STEAL_* knobs
    (see sched/steal.py)."""
    import signal

    from agent_tpu_torch.config import (
        JournalConfig,
        ObsConfig,
        PartitionConfig,
        SchedConfig,
        ServeConfig,
        SloConfig,
        env_bool,
        env_float,
        env_int,
        env_str,
    )

    cfg = PartitionConfig.from_env()
    local: Optional[LocalPartitionSet] = None
    if cfg.partition_urls:
        pmap = PartitionMap.parse(cfg.partition_urls)
    elif cfg.partitions >= 1:
        journal = env_str("CONTROLLER_JOURNAL", "") or None
        sweep = env_float("CONTROLLER_SWEEP_SEC", 5.0)
        local = LocalPartitionSet(
            cfg.partitions,
            journal_base=journal,
            controller_kwargs=dict(
                lease_ttl_sec=env_float("LEASE_TTL_SEC", 30.0),
                sweep_interval_sec=sweep if sweep > 0 else None,
                max_attempts=max(1, env_int("MAX_ATTEMPTS", 2)),
                requeue_delay_sec=env_float("REQUEUE_DELAY_SEC", 1.0),
                sched=SchedConfig.from_env(),
                wire_binary=env_bool("WIRE_BINARY", True),
                slo=SloConfig.from_env(),
                obs=ObsConfig.from_env(),
                journal=JournalConfig.from_env(),
                serve=ServeConfig.from_env(),
            ),
        ).start()
        pmap = local.pmap
        assert pmap is not None
    else:
        print(
            "[agent-tpu-router] set PARTITION_URLS (front an existing "
            "fleet) or PARTITIONS=N (boot N in-process partitions)",
            flush=True,
        )
        return 2

    obs = ObsConfig.from_env()
    server = RouterServer(
        pmap,
        host=cfg.router_host,
        port=cfg.router_port,
        steal=StealPolicy.from_env(),
        depth_cache_sec=cfg.depth_cache_sec,
        timeout_sec=cfg.timeout_sec,
        # Fleet telemetry collection: ROUTER_COLLECT_SEC=0
        # disables; ROUTER_TSDB_DIR="" keeps the fleet view in-memory.
        collect_interval_sec=env_float(
            "ROUTER_COLLECT_SEC", obs.tsdb_interval_sec
        ),
        fleet_tsdb_dir=env_str("ROUTER_TSDB_DIR", "").strip(),
        fleet_window_sec=obs.tsdb_window_sec,
    )
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    server.start()
    mode = (
        f"{len(pmap)} in-process partition(s)" if local is not None
        else f"{len(pmap)} partition(s) via PARTITION_URLS"
    )
    print(
        f"[agent-tpu-router] routing on {server.url} for {mode}: "
        + ", ".join(
            f"{name}={pmap.urls(name)[0]}" for name in pmap.names
        ),
        flush=True,
    )
    stop.wait()
    server.stop()
    if local is not None:
        local.stop()
    print("[agent-tpu-router] stopped", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
