"""HTTP adapter for the controller core — the server side of SURVEY.md §2.9.

Speaks exactly the contract the agent client expects (and the reference client
at ``app.py:143-218`` spoke): JSON bodies, ``POST /v1/leases`` answering 200
``{lease_id, tasks}`` or 204 when idle, ``POST /v1/results`` answering 200
``{accepted: ...}``. Stdlib ``ThreadingHTTPServer`` — no framework dependency,
good enough for a single-process controller and for in-process tests.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from agent_tpu_torch.controller.core import Controller
from agent_tpu_torch.sched import AdmissionError


class _Handler(BaseHTTPRequestHandler):
    controller: Controller  # set by ControllerServer on the class it builds

    def log_message(self, *args: Any) -> None:  # silence per-request stderr spam
        pass

    def _read_json(self) -> Optional[Dict[str, Any]]:
        self._request_bytes = 0
        try:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length) if length else b"{}"
            self._request_bytes = length
            body = json.loads(raw or b"{}")
        except (ValueError, OSError):
            return None
        return body if isinstance(body, dict) else None

    def _send(self, status: int, body: Optional[Dict[str, Any]] = None) -> int:
        self.send_response(status)
        if body is None:
            self.end_headers()
            return 0
        data = json.dumps(body, default=str).encode()
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)
        return len(data)

    def _send_text(self, status: int, text: str, content_type: str) -> None:
        data = text.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_admission(self, exc: AdmissionError) -> None:
        """Backpressure, not failure: 429 + retry_after_ms is the admission
        contract — classify_http already calls 429 transient, so an
        unmodified RetryPolicy backs off. Shared by /v1/jobs and /v1/infer."""
        self.send_response(429)
        data = json.dumps({
            "error": str(exc),
            "retry_after_ms": exc.retry_after_ms,
            "tenant": exc.tenant,
            "scope": exc.scope,
        }).encode()
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.send_header(
            "Retry-After",
            str(max(1, (exc.retry_after_ms + 999) // 1000)),
        )
        self.end_headers()
        self.wfile.write(data)

    # ---- online serving front door ----

    def _infer_wait_timeout(self, body: Dict[str, Any]) -> float:
        """Client ``timeout_ms`` capped by the server's SERVE_WAIT_TIMEOUT."""
        cap = self.controller.serve_config.wait_timeout_sec
        raw = body.get("timeout_ms")
        if isinstance(raw, (int, float)) and not isinstance(raw, bool) \
                and raw > 0:
            return min(float(raw) / 1e3, cap)
        return cap

    def _stream_infer(self, req_id: str, timeout_sec: float) -> None:
        """Chunked NDJSON lifecycle stream: one JSON line per request state
        (``queued`` → ``batched`` → ``done``/``failed``), the terminal line
        carrying the result — the framing PROTOCOL.CONTRACT.md documents.
        Manual chunked framing: BaseHTTPRequestHandler won't do it for us."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj: Dict[str, Any]) -> None:
            data = (json.dumps(obj, default=str) + "\n").encode()
            self.wfile.write(
                f"{len(data):x}\r\n".encode() + data + b"\r\n"
            )
            self.wfile.flush()

        deadline = time.monotonic() + timeout_sec
        snap = self.controller.infer_snapshot(req_id)
        try:
            while snap is not None:
                chunk(snap)
                if snap["state"] in ("done", "failed"):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    chunk({"req_id": req_id, "state": snap["state"],
                           "event": "timeout"})
                    break
                nxt = self.controller.wait_infer_change(
                    req_id, snap["state"], remaining
                )
                if nxt is None or nxt["state"] == snap["state"]:
                    continue
                snap = nxt
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up mid-stream; the request completes anyway

    def _handle_infer_post(self, body: Dict[str, Any]) -> None:
        try:
            req_id = self.controller.submit_infer(
                op=str(body.get("op", "")),
                text=body.get("text"),
                params=body.get("params")
                if isinstance(body.get("params"), dict) else None,
                tenant=(
                    str(body["tenant"])
                    if body.get("tenant") is not None else None
                ),
                priority=body.get("priority"),
            )
        except AdmissionError as exc:
            self._send_admission(exc)
            return
        except (RuntimeError, KeyError, ValueError, TypeError) as exc:
            disabled = isinstance(exc, RuntimeError)
            self._send(501 if disabled else 400, {"error": str(exc)})
            return
        timeout = self._infer_wait_timeout(body)
        if body.get("stream"):
            self._stream_infer(req_id, timeout)
        elif body.get("wait", True):
            self._send(200, self.controller.wait_infer(req_id, timeout))
        else:
            self._send(200, {"req_id": req_id, "state": "queued"})

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        body = self._read_json()
        if body is None:
            self._send(400, {"error": "invalid JSON body"})
            return
        if self.path == "/v1/leases":
            try:
                # max_tasks=0 is a metrics-only poll (the drain-end flush
                # channel) — it must NOT coerce to 1 like the old `or 1` did.
                raw_max = body.get("max_tasks")
                max_tasks = 1 if raw_max is None else int(raw_max)
            except (TypeError, ValueError):
                self._send(400, {"error": "max_tasks must be an int"})
                return
            lease = self.controller.lease(
                agent=str(body.get("agent", "")),
                capabilities=body.get("capabilities"),
                max_tasks=max_tasks,
                worker_profile=body.get("worker_profile"),
                metrics=body.get("metrics"),
                labels=body.get("labels")
                if isinstance(body.get("labels"), dict)
                else None,
                # Drain handshake: a retiring agent's final
                # flush carries draining=true; /v1/status marks it.
                draining=bool(body.get("draining")),
            )
            if lease is None:
                n_out = self._send(204)
            else:
                n_out = self._send(200, lease)
            # Data-plane byte accounting: task bodies leave on
            # lease responses — real wire bytes, straight off this socket.
            self.controller.note_http_bytes("/v1/leases", "in",
                                            self._request_bytes)
            self.controller.note_http_bytes("/v1/leases", "out", n_out)
        elif self.path == "/v1/results":
            out = self.controller.report(
                lease_id=str(body.get("lease_id", "")),
                job_id=str(body.get("job_id", "")),
                job_epoch=body.get("job_epoch"),
                status=str(body.get("status", "")),
                result=body.get("result"),
                error=body.get("error"),
                # Piggybacked agent spans — optional, absent from
                # legacy agents.
                spans=body.get("spans"),
                # Per-task result-wire attribution: the measured
                # request size, billed into the usage ledger.
                wire_bytes=self._request_bytes,
            )
            n_out = self._send(200, out)
            # Result bodies arrive on this route — the other half of the
            # wire-bytes/row arithmetic bench's binary-wire leg reports.
            self.controller.note_http_bytes("/v1/results", "in",
                                            self._request_bytes)
            self.controller.note_http_bytes("/v1/results", "out", n_out)
        elif self.path == "/v1/jobs":
            # Operator surface: submit one job or a sharded CSV job.
            try:
                # Per-job retry budget: absent → controller default.
                max_attempts = (
                    int(body["max_attempts"])
                    if body.get("max_attempts") is not None
                    else None
                )
                # Scheduling fields: absent → controller defaults
                # (SCHED_DEFAULT_PRIORITY, tenant "default", no deadline).
                priority = (
                    int(body["priority"])
                    if body.get("priority") is not None
                    else None
                )
                tenant = (
                    str(body["tenant"])
                    if body.get("tenant") is not None
                    else None
                )
                deadline_sec = (
                    float(body["deadline_sec"])
                    if body.get("deadline_sec") is not None
                    else None
                )
                if "source_uri" in body:
                    shard_ids, reduce_id = self.controller.submit_csv_job(
                        source_uri=str(body["source_uri"]),
                        total_rows=int(body["total_rows"]),
                        # Absent → None → profile-derived shard sizing.
                        shard_size=(
                            int(body["shard_size"])
                            if body.get("shard_size") is not None
                            else None
                        ),
                        map_op=str(body.get("map_op", "read_csv_shard")),
                        extra_payload=body.get("extra_payload"),
                        reduce_op=body.get("reduce_op"),
                        reduce_payload=body.get("reduce_payload"),
                        required_labels=body.get("required_labels"),
                        collect_partials=bool(body.get("collect_partials")),
                        max_attempts=max_attempts,
                        priority=priority,
                        tenant=tenant,
                        deadline_sec=deadline_sec,
                    )
                    self._send(200, {"job_ids": shard_ids, "reduce_id": reduce_id})
                else:
                    job_id = self.controller.submit(
                        op=str(body["op"]),
                        payload=body.get("payload"),
                        # Client-chosen id: a submitter that
                        # lost the response to a dead primary resubmits
                        # the SAME id to the standby — the duplicate-id
                        # 400 is its exactly-once acknowledgment.
                        job_id=(
                            str(body["job_id"])
                            if body.get("job_id") is not None else None
                        ),
                        required_labels=body.get("required_labels"),
                        max_attempts=max_attempts,
                        priority=priority,
                        tenant=tenant,
                        deadline_sec=deadline_sec,
                    )
                    self._send(200, {"job_id": job_id})
            except AdmissionError as exc:
                self._send_admission(exc)
            except (KeyError, ValueError, TypeError) as exc:
                self._send(400, {"error": str(exc)})
        elif self.path == "/v1/workflows":
            # Workflow DAG engine: a fan-out/fan-in graph
            # submitted as ONE unit; stages become ordinary dep-gated jobs.
            try:
                out = self.controller.submit_workflow(
                    workflow=body,
                    tenant=(
                        str(body["tenant"])
                        if body.get("tenant") is not None else None
                    ),
                    priority=body.get("priority"),
                    deadline_sec=(
                        float(body["deadline_sec"])
                        if body.get("deadline_sec") is not None else None
                    ),
                    workflow_id=(
                        str(body["workflow_id"])
                        if body.get("workflow_id") is not None else None
                    ),
                )
                self._send(200, out)
            except AdmissionError as exc:
                self._send_admission(exc)
            except (KeyError, ValueError, TypeError) as exc:
                self._send(400, {"error": str(exc)})
            except RuntimeError as exc:
                # FLOW_ENABLED=0: the subsystem is configured off.
                self._send(501, {"error": str(exc)})
        elif self.path == "/v1/infer":
            # Online serving front door: one classify/summarize
            # request; blocks to the result by default, ?wait:false returns
            # the req_id for GET polling, stream:true frames the lifecycle
            # as chunked NDJSON.
            self._handle_infer_post(body)
        elif self.path == "/v1/profile/capture":
            # On-demand deep capture: arm one profiler trace
            # on the named agent; the request rides its next granted lease.
            try:
                out = self.controller.request_capture(
                    agent=body.get("agent"),
                    op=body.get("op"),
                    duration_ms=body.get("duration_ms"),
                )
                self._send(200, {"capture_id": out["capture_id"],
                                 "capture": out})
            except (ValueError, TypeError) as exc:
                self._send(400, {"error": str(exc)})
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        parts = urlsplit(self.path)
        path, query = parts.path, parse_qs(parts.query)
        if path == "/v1/traces":
            # Newest-first trace summaries; ?limit=N caps the listing.
            try:
                limit = int(query.get("limit", ["20"])[0])
            except ValueError:
                self._send(400, {"error": "limit must be an int"})
                return
            self._send(200, {"traces": self.controller.traces_json(limit)})
            return
        if path.startswith("/v1/trace/"):
            # Assembled span tree for one job — or one serving request
            # (a req_id resolves to its stitched tree, the batch
            # job traces it links to inlined under ``linked_traces``).
            # ?format=perfetto returns the Chrome-trace JSON Perfetto loads
            # directly; ?format=jsonl the span-per-line dump; default is
            # the assembled wire schema.
            trace_id = path[len("/v1/trace/"):]
            assembled = self.controller.trace_json(trace_id)
            if assembled is None:
                self._send(404, {"error": f"no trace {trace_id!r}"})
                return
            fmt = query.get("format", ["json"])[0]
            # Flat exports flatten the stitched view: the trace's own spans
            # plus every linked trace's, one timeline.
            flat_spans = list(assembled["spans"])
            for lt in assembled.get("linked_traces", ()):
                flat_spans.extend(lt["spans"])
            if fmt == "perfetto":
                from agent_tpu_torch.obs.trace import to_chrome_trace

                self._send(200, to_chrome_trace(flat_spans))
            elif fmt == "jsonl":
                from agent_tpu_torch.obs.trace import to_jsonl

                self._send_text(
                    200, to_jsonl(flat_spans),
                    "application/jsonl; charset=utf-8",
                )
            else:
                self._send(200, assembled)
            return
        if path == "/v1/debug/events":
            # Flight-recorder dump on demand — the controller half of the
            # post-hoc diagnosis story (the agent half is SIGUSR1).
            # ?job_id= filters to one job's life;
            # ?req_id= to one serving request's.
            job_id = query.get("job_id", [None])[0]
            req_id = query.get("req_id", [None])[0]
            self._send(
                200,
                {
                    "events": self.controller.recorder.events(
                        job_id=job_id, req_id=req_id
                    ),
                    "dropped": self.controller.recorder.dropped,
                    "capacity": self.controller.recorder.capacity,
                },
            )
            return
        if path == "/v1/debug/requests":
            # Wide-event request log: one tail-sampled record
            # per terminal serving request. ?tenant= / ?outcome= filter,
            # ?slow=1 restricts to the kept tail (errors + slow decile),
            # ?limit=N caps, ?format=jsonl exports record-per-line.
            try:
                limit = int(query.get("limit", ["256"])[0])
            except ValueError:
                self._send(400, {"error": "limit must be an int"})
                return
            body = self.controller.requests_json(
                tenant=query.get("tenant", [None])[0],
                outcome=query.get("outcome", [None])[0],
                slow=query.get("slow", ["0"])[0] in ("1", "true", "yes"),
                limit=limit,
            )
            if query.get("format", ["json"])[0] == "jsonl":
                self._send_text(
                    200,
                    "".join(
                        json.dumps(rec, sort_keys=True, default=str) + "\n"
                        for rec in body["requests"]
                    ),
                    "application/jsonl; charset=utf-8",
                )
            else:
                self._send(200, body)
            return
        if path == "/v1/workflows":
            # Workflow DAG summary list + result-cache stats —
            # swarmtop's Workflows panel reads this.
            self._send(200, self.controller.workflows_json())
            return
        if path.startswith("/v1/workflows/"):
            wf_id = path[len("/v1/workflows/"):]
            out = self.controller.workflow_json(wf_id)
            if out is None:
                self._send(404, {"error": f"unknown workflow {wf_id!r}"})
            else:
                self._send(200, out)
            return
        if path == "/v1/usage":
            # Showback report: billed device/host seconds, FLOPs,
            # rows, and wire bytes per tenant/tier/op + top-K jobs + the
            # live per-tenant queue depth. ?top_k=N resizes the job list.
            try:
                top_k = (
                    int(query["top_k"][0]) if "top_k" in query else None
                )
            except ValueError:
                self._send(400, {"error": "top_k must be an int"})
                return
            self._send(200, self.controller.usage_json(top_k=top_k))
            return
        if path == "/v1/timeseries":
            # Controller trend ring: ?name=<family> (required),
            # ?rate=1 for per-second deltas, ?window_sec=N to narrow, and
            # any other query key=value pairs filter series labels
            # (?op=map_classify_tpu&tenant=a). ?since=<epoch>/?step=<sec>
            # serve history from the durable store; values of
            # since up to 1e6 are read as "seconds ago".
            name = query.get("name", [None])[0]
            if not name:
                self._send(400, {
                    "error": "name is required",
                    "names": self.controller.timeseries_names(),
                })
                return
            try:
                window = (
                    float(query["window_sec"][0])
                    if "window_sec" in query else None
                )
                since = (
                    float(query["since"][0]) if "since" in query else None
                )
                step = (
                    float(query["step"][0]) if "step" in query else None
                )
            except ValueError:
                self._send(400, {
                    "error": "window_sec/since/step must be numbers"
                })
                return
            if since is not None and since <= 1e6:
                since = time.time() - max(0.0, since)
            rate = query.get("rate", ["0"])[0] in ("1", "true", "yes")
            label_filter = {
                k: v[0] for k, v in query.items()
                if k not in ("name", "rate", "window_sec", "since", "step")
                and v
            }
            self._send(200, self.controller.timeseries_json(
                name, label_filter or None, rate=rate, window_sec=window,
                since=since, step=step,
            ))
            return
        if path == "/v1/timeseries/export":
            # Delta-scrape surface: raw ring samples newer than
            # ?since=<epoch> — the router collector's cursor endpoint.
            try:
                since = float(query.get("since", ["0"])[0])
            except ValueError:
                self._send(400, {"error": "since must be a number"})
                return
            self._send(200, self.controller.timeseries_export_json(since))
            return
        if path == "/v1/incidents":
            self._send(200, self.controller.incidents_json())
            return
        if path.startswith("/v1/incidents/"):
            incident_id = path[len("/v1/incidents/"):]
            out = self.controller.incidents_json(incident_id)
            if out.get("enabled") and out.get("incident") is None:
                self._send(404, {"error": f"unknown incident "
                                          f"{incident_id!r}"})
            else:
                self._send(200, out)
            return
        if path == "/v1/profile/host":
            # Host sampling profiler: collapsed-stack flamegraph
            # text of the controller process (flamegraph.pl format).
            text = self.controller.host_profile_text()
            if text is None:
                self._send(404, {"error": "host profiler disabled "
                                          "(PROFILE_HOST_ENABLED=0)"})
                return
            self._send_text(200, text, "text/plain; charset=utf-8")
            return
        if path == "/v1/profile/captures":
            self._send(200, self.controller.captures_json())
            return
        if path.startswith("/v1/infer/"):
            # Serving request status/result; ?wait_ms=N long-polls
            # to a terminal state (capped by SERVE_WAIT_TIMEOUT_SEC).
            req_id = path[len("/v1/infer/"):]
            try:
                wait_ms = (
                    float(query["wait_ms"][0]) if "wait_ms" in query else 0.0
                )
            except ValueError:
                self._send(400, {"error": "wait_ms must be a number"})
                return
            if wait_ms > 0:
                try:
                    snap = self.controller.wait_infer(
                        req_id,
                        min(wait_ms / 1e3,
                            self.controller.serve_config.wait_timeout_sec),
                    )
                except RuntimeError as exc:  # serving disabled
                    self._send(501, {"error": str(exc)})
                    return
            else:
                snap = self.controller.infer_snapshot(req_id)
            if snap is None:
                self._send(404, {"error": f"unknown request {req_id!r}"})
            else:
                self._send(200, snap)
            return
        if path == "/v1/health":
            # Fleet health verdict: per-tier SLO attainment +
            # burn-rate alert states, per-agent duty cycle/MFU/liveness,
            # queue pressure, one rolled-up ok|warn|page verdict — the
            # machine-readable signal vector the autoscaler (ROADMAP item
            # 4) and scripts/swarmtop.py consume.
            self._send(200, self.controller.health_json())
            return
        if path == "/v1/depth":
            # Partitioned control plane: the steal probe. A
            # deliberately tiny payload the router polls per idle lease —
            # /v1/status computes fleet merges and is far too heavy for
            # that loop.
            self._send(
                200,
                {
                    "partition": self.controller.partition,
                    "queue_depth": self.controller.queue_depth(),
                    "leasable": self.controller.leasable_depth(),
                },
            )
            return
        if self.path == "/v1/status":
            status_body = {
                "counts": self.controller.counts(),
                "counts_by_op": self.controller.counts_by_op(),
                "queue_depth": self.controller.queue_depth(),
                "drained": self.controller.drained(),
                "stale_results": self.controller.stale_results,
                "agents": self.controller.agents_summary(),
                "summary": self.controller.status_summary(),
                # Journal durability block: replay
                # damage (torn FINAL line vs mid-file corruption) plus
                # segment count/bytes, last-snapshot age, and the last
                # replay's duration — the O(live state) claim as a
                # number operators can read off one status call.
                "journal": self.controller.journal_status(),
                # Serving front-door block: request states,
                # open buckets, in-flight batch jobs, 429 drops.
                "serving": self.controller.serve_status(),
                "last_metrics": self.controller.last_metrics,
            }
            # Partitioned mode only: the router's fan-out merge
            # keys on this. A standalone controller's status schema stays
            # byte-stable.
            if self.controller.partition:
                status_body["partition"] = self.controller.partition
            self._send(200, status_body)
        elif self.path == "/v1/metrics":
            # Prometheus text exposition: controller series + fleet-merged
            # agent series + per-agent liveness (see Controller.metrics_text).
            self._send_text(
                200,
                self.controller.metrics_text(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif self.path.startswith("/v1/jobs/"):
            job_id = self.path[len("/v1/jobs/"):]
            try:
                self._send(200, self.controller.job_snapshot(job_id))
            except KeyError:
                self._send(404, {"error": f"unknown job {job_id!r}"})
        else:
            self._send(404, {"error": f"no route {self.path}"})


class ControllerServer:
    """Owns a Controller + an HTTP server on a background thread.

    ``port=0`` binds an ephemeral port; ``url`` reports the bound address —
    tests point an agent's CONTROLLER_URL at it.
    """

    def __init__(
        self,
        controller: Optional[Controller] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        self.controller = controller or Controller()
        handler = type("Handler", (_Handler,), {"controller": self.controller})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ControllerServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="controller-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self) -> "ControllerServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def main() -> int:
    """Standalone controller: ``python -m agent_tpu_torch.controller.server``.
    Env: CONTROLLER_HOST (default 0.0.0.0),
    CONTROLLER_PORT (default 8080), LEASE_TTL_SEC (default 30),
    MAX_ATTEMPTS (default retry budget, 2), REQUEUE_DELAY_SEC (retried jobs
    held back this long, default 1), WIRE_BINARY (0 disables the binary
    shard wire; default on), plus the SCHED_* scheduler knobs
    (SCHED_POLICY fifo|fair, SCHED_MAX_PENDING[_PER_TENANT],
    SCHED_TENANT_WEIGHTS, … — see config.SchedConfig)."""
    import signal

    from agent_tpu_torch.config import (
        FlowConfig,
        JournalConfig,
        ObsConfig,
        SchedConfig,
        ServeConfig,
        SloConfig,
        env_bool,
        env_float,
        env_int,
        env_str,
    )

    host = env_str("CONTROLLER_HOST", "0.0.0.0")
    port = env_int("CONTROLLER_PORT", 8080)
    ttl = env_float("LEASE_TTL_SEC", 30.0)
    journal = env_str("CONTROLLER_JOURNAL", "") or None
    sweep = env_float("CONTROLLER_SWEEP_SEC", 5.0)
    # CONTROLLER_PARTITION: this process is one shard of a
    # partitioned control plane — ids it generates carry the name and the
    # router's fan-out merges key on it. Empty = standalone controller.
    partition = env_str("CONTROLLER_PARTITION", "") or None
    sched = SchedConfig.from_env()
    controller = Controller(
        partition=partition,
        lease_ttl_sec=ttl,
        journal_path=journal,
        sweep_interval_sec=sweep if sweep > 0 else None,
        max_attempts=max(1, env_int("MAX_ATTEMPTS", 2)),
        requeue_delay_sec=env_float("REQUEUE_DELAY_SEC", 1.0),
        sched=sched,
        # WIRE_BINARY=0 runs a JSON-only controller (binary-capable agents
        # simply never get the `wire` answer and stay on JSON).
        wire_binary=env_bool("WIRE_BINARY", True),
        # SLO_* / HEALTH_* knobs: declarative objectives, burn
        # thresholds, windows; SLO_ENABLED=0 no-ops the judgment path.
        slo=SloConfig.from_env(),
        # USAGE_* / TSDB_* / PROFILE_* knobs: showback ledger,
        # trend ring, host profiler, on-demand deep captures.
        obs=ObsConfig.from_env(),
        # JOURNAL_* / SNAPSHOT_* knobs: segment rotation,
        # compacting snapshots, optional fdatasync. Defaults reproduce the
        # historical single-file journal byte for byte.
        journal=JournalConfig.from_env(),
        # SERVE_* knobs: the POST /v1/infer front door —
        # coalescing deadline/batch caps, length buckets, admission budget.
        serve=ServeConfig.from_env(),
        # FLOW_* / CACHE_* knobs: workflow DAG limits + the
        # content-addressed result cache (capacity, model version, price).
        flow=FlowConfig.from_env(),
    )
    server = ControllerServer(controller, host=host, port=port)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    server.start()
    print(
        f"[agent-tpu-controller] serving on {server.url} "
        f"(sched policy={sched.policy})",
        flush=True,
    )
    stop.wait()
    server.stop()
    controller.close()
    print("[agent-tpu-controller] stopped", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
