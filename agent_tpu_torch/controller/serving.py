"""Online-serving front door: request coalescing for ``POST /v1/infer``.

The swarm's historical unit of work is a *shard* — hundreds of rows, seconds
of device time. This adds the *request* story: a user posts ONE
classify/summarize request and wants an answer now. This module is the
controller half of that path:

- :class:`InferRequest` — one request's life: ``queued`` (waiting in a
  coalescing bucket) → ``batched`` (riding a submitted interactive-tier job)
  → ``done``/``failed``, with arrival/TTFT/latency stamps.
- :class:`ServeFrontDoor` — length-bucketed batch coalescing under a
  ``SERVE_MAX_WAIT_MS`` deadline + ``SERVE_MAX_BATCH`` cap. Requests bucket
  by ``(op, tenant, priority, decode-param signature, length bucket)`` so a
  flushed batch is one compiled shape with bounded padding waste; a bucket
  flushes the moment it fills, and the controller's lease/sweep cadence
  flushes deadline-expired remainders. The flushed batch becomes an
  ordinary job (``serve_classify`` / ``serve_summarize``) on the existing
  queue — interactive-tier priority via the fair scheduler, epoch fencing,
  journal, retries, and the 429 admission path all for free.

Threading: the front door owns ONE condition/lock guarding requests +
buckets + the job map. The controller never calls into it while holding its
own state lock (and vice versa), so lock order cannot invert. Completion
``notify_all``s the condition — the long-poll side of ``POST /v1/infer``
and ``GET /v1/infer/{id}?wait_ms=`` blocks on it.

Serving state is deliberately in-memory only: a request is an open HTTP
conversation, not durable work. The *batch jobs* journal like any job (so a
restarted controller finishes them), but their waiters are gone — the
completion fan-out for an unknown job id is a counted no-op.
"""

from __future__ import annotations

import collections
import json
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from agent_tpu_torch.config import ServeConfig
from agent_tpu_torch.sched import AdmissionError

# Request op → the leaseable op the flushed batch job carries. Serving ops
# are real registry ops (ops/serve_infer.py), so capability matching routes
# them exactly like any other op.
SERVE_OPS = {
    "classify": "serve_classify",
    "summarize": "serve_summarize",
}

# Decode/serving parameters a request may carry. Everything here is part of
# the bucket signature (one flushed batch = one compiled shape/config);
# ``max_length`` is deliberately NOT — it rides per request and becomes the
# continuous engine's per-slot token limit, which is exactly what lets short
# requests exit the running batch early.
BATCH_PARAM_KEYS = (
    "model_config", "num_beams", "min_length", "length_penalty",
    "early_stopping", "topk",
)
PER_REQUEST_PARAM_KEYS = ("max_length",)

QUEUED = "queued"
BATCHED = "batched"
DONE = "done"
FAILED = "failed"

# Completed requests retained for GET /v1/infer/{id} after the fact.
DONE_RETENTION = 4096


@dataclass
class InferRequest:
    req_id: str
    op: str                       # "classify" | "summarize"
    text: str
    params: Dict[str, Any]        # bucket-signature params
    max_length: Optional[int]
    tenant: str
    priority: int
    arrived_wall: float
    arrived_clock: float
    state: str = QUEUED
    job_id: Optional[str] = None
    batched_clock: Optional[float] = None
    result: Any = None
    error: Any = None
    ttft_ms: Optional[float] = None
    latency_ms: Optional[float] = None
    tokens: int = 0
    # ---- request-level observability ----
    bucket: int = 0                         # length bucket the request rode
    flush_reason: Optional[str] = None      # "full" | "deadline"
    batched_wall: Optional[float] = None
    prefill_job_id: Optional[str] = None    # disagg: the serve_prefill leg
    # The request's OWN trace (trace_id = req_id): root "infer" span plus
    # the bucket-wait child, opened at submit, closed at flush/terminal.
    root_span_id: Optional[str] = None
    bucket_span_id: Optional[str] = None
    # Per-request decode telemetry the agent ships inside its batch result
    # entry (prefill/seat/first-token walls, KV wait, occupancy-at-join,
    # prefix cache hit, steps) — the TTFT decomposition's raw material.
    telemetry: Optional[Dict[str, Any]] = None

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "req_id": self.req_id,
            "op": self.op,
            "state": self.state,
            "tenant": self.tenant,
            "priority": self.priority,
            "job_id": self.job_id,
        }
        if self.state == DONE:
            out["result"] = self.result
            out["ttft_ms"] = self.ttft_ms
            out["latency_ms"] = self.latency_ms
            out["tokens"] = self.tokens
        elif self.state == FAILED:
            out["error"] = self.error
            out["latency_ms"] = self.latency_ms
        return out


@dataclass(frozen=True)
class _BucketKey:
    op: str
    tenant: str
    priority: int
    bucket: int          # padded input length (bytes — the byte tokenizer's unit)
    sig: str             # canonical JSON of the batch-level params


@dataclass
class ServeBatch:
    """One flushed bucket, ready to become a job."""

    key: _BucketKey
    requests: List[InferRequest]
    reason: str          # "full" | "deadline"

    def job_payload(self) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "requests": [
                {
                    "req_id": r.req_id,
                    "text": r.text,
                    "arrived_wall": r.arrived_wall,
                    **(
                        {"max_length": r.max_length}
                        if r.max_length is not None else {}
                    ),
                }
                for r in self.requests
            ],
            "bucket": self.key.bucket,
        }
        payload.update(json.loads(self.key.sig))
        return payload


class ServeFrontDoor:
    """Request registry + length-bucketed coalescing (see module docstring).

    Every public method takes the front door's own lock; callers must NOT
    hold the controller state lock when calling in (the controller calls
    this before/after its locked sections, never inside them).
    """

    def __init__(
        self,
        config: Optional[ServeConfig] = None,
        clock=time.monotonic,
        traces=None,
        partition=None,
    ) -> None:
        self.config = config if config is not None else ServeConfig()
        self._clock = clock
        # Partitioned control plane: bucket keys already include
        # the tenant, so the router sends a tenant's whole serve stream to
        # one home partition and coalescing stays partition-local; the
        # partition name rides the generated req ids (and /v1/status via
        # stats()) so any req id names its owning partition.
        self.partition = str(partition) if partition else None
        # Controller's TraceStore: each request opens its own
        # trace (trace_id = req_id) with an "infer" root and a
        # "bucket.wait" child closed at flush time. None = tracing off.
        self._traces = traces
        self._cond = threading.Condition()
        self._requests: Dict[str, InferRequest] = {}
        self._buckets: "collections.OrderedDict[_BucketKey, List[InferRequest]]" = (
            collections.OrderedDict()
        )
        self._jobs: Dict[str, List[str]] = {}      # job_id -> req_ids
        self._done_ring: "collections.deque[str]" = collections.deque()
        self.rejected = 0

    # ---- intake ----

    def _bucket_len(self, text: str) -> int:
        n = len(text.encode("utf-8", errors="replace"))
        for edge in self.config.len_buckets:
            if n <= edge:
                return edge
        return self.config.len_buckets[-1]

    def _pending_count_locked(self) -> int:
        return sum(
            1 for r in self._requests.values()
            if r.state in (QUEUED, BATCHED)
        )

    def submit(
        self,
        op: str,
        text: Any,
        params: Optional[Dict[str, Any]] = None,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
        now_wall: Optional[float] = None,
    ) -> Tuple[InferRequest, List[ServeBatch]]:
        """Validate + enqueue one request. Returns the request and any
        bucket that FILLED on this enqueue (the caller submits those as
        jobs — outside this lock). Raises ``ValueError`` on a malformed
        request and ``AdmissionError`` (the wire's 429) past the pending
        budget."""
        if op not in SERVE_OPS:
            raise ValueError(
                f"op must be one of {sorted(SERVE_OPS)}, got {op!r}"
            )
        if not isinstance(text, str) or not text:
            raise ValueError("text must be a non-empty string")
        params = dict(params or {})
        unknown = set(params) - set(BATCH_PARAM_KEYS) - set(
            PER_REQUEST_PARAM_KEYS
        )
        if unknown:
            raise ValueError(f"unknown params: {sorted(unknown)}")
        max_length = params.pop("max_length", None)
        if max_length is not None and (
            isinstance(max_length, bool)
            or not isinstance(max_length, int) or max_length < 1
        ):
            raise ValueError("max_length must be a positive int")
        if tenant is not None and (
            not isinstance(tenant, str) or not tenant
        ):
            raise ValueError("tenant must be a non-empty string")
        if priority is not None and (
            isinstance(priority, bool) or not isinstance(priority, int)
            or not 0 <= priority <= 9
        ):
            raise ValueError("priority must be an int in [0, 9]")
        sig = json.dumps(params, sort_keys=True)
        now_wall = time.time() if now_wall is None else now_wall
        req = InferRequest(
            req_id=(
                f"req-{self.partition + '-' if self.partition else ''}"
                f"{uuid.uuid4().hex[:12]}"
            ),
            op=op,
            text=text,
            params=params,
            max_length=max_length,
            tenant=tenant if tenant is not None else "default",
            priority=(
                priority if priority is not None else self.config.priority
            ),
            arrived_wall=now_wall,
            arrived_clock=self._clock(),
        )
        key = _BucketKey(
            op=op, tenant=req.tenant, priority=req.priority,
            bucket=self._bucket_len(text), sig=sig,
        )
        req.bucket = key.bucket
        with self._cond:
            budget = self.config.max_pending
            if budget and self._pending_count_locked() + 1 > budget:
                self.rejected += 1
                raise AdmissionError(
                    f"serving pending budget exhausted "
                    f"({self._pending_count_locked()} in flight, budget "
                    f"{budget})",
                    retry_after_ms=int(self.config.max_wait_ms) or 1000,
                    tenant=req.tenant, scope="serving",
                )
            self._requests[req.req_id] = req
            self._buckets.setdefault(key, []).append(req)
            full: List[ServeBatch] = []
            if len(self._buckets[key]) >= self.config.max_batch:
                full.append(
                    ServeBatch(key, self._buckets.pop(key), reason="full")
                )
        # Open the request's OWN trace (outside the lock — the TraceStore
        # has its own; admission rejections above never mint spans). The
        # spans anchor at arrived_clock, so opening after enqueue costs no
        # timing accuracy.
        if self._traces is not None:
            req.root_span_id = self._traces.open(
                req.req_id, "infer", start_clock=req.arrived_clock,
                attributes={
                    "op": op, "tenant": req.tenant,
                    "priority": req.priority, "bucket": key.bucket,
                },
            )
            req.bucket_span_id = self._traces.open(
                req.req_id, "bucket.wait", req.root_span_id,
                start_clock=req.arrived_clock,
                attributes={"bucket": key.bucket},
            )
        return req, full

    def pop_due(self, now_clock: Optional[float] = None) -> List[ServeBatch]:
        """Buckets whose OLDEST request has waited out ``max_wait_ms`` —
        the deadline flush, driven by the controller's lease/sweep cadence.
        An empty queue stays idle: no buckets, no flushes, no work."""
        now = self._clock() if now_clock is None else now_clock
        deadline = self.config.max_wait_ms / 1e3
        out: List[ServeBatch] = []
        with self._cond:
            for key in list(self._buckets):
                reqs = self._buckets[key]
                if reqs and now - reqs[0].arrived_clock >= deadline:
                    out.append(
                        ServeBatch(key, self._buckets.pop(key),
                                   reason="deadline")
                    )
        return out

    def mark_batched(
        self,
        batch: ServeBatch,
        job_id: str,
        prefill_job_id: Optional[str] = None,
    ) -> None:
        now = self._clock()
        now_wall = time.time()
        with self._cond:
            self._jobs[job_id] = [r.req_id for r in batch.requests]
            for r in batch.requests:
                r.state = BATCHED
                r.job_id = job_id
                r.prefill_job_id = prefill_job_id
                r.batched_clock = now
                r.batched_wall = now_wall
                r.flush_reason = batch.reason
            self._cond.notify_all()
        # Close each rider's bucket-wait span with the flush verdict (why
        # did it leave the bucket: full or deadline) and the job it rides.
        if self._traces is not None:
            for r in batch.requests:
                attrs: Dict[str, Any] = {
                    "reason": batch.reason, "job_id": job_id,
                }
                if prefill_job_id:
                    attrs["prefill_job_id"] = prefill_job_id
                self._traces.finish(
                    r.req_id, r.bucket_span_id, now, attributes=attrs
                )

    def fail_batch(self, batch: ServeBatch, error: Any) -> List[InferRequest]:
        """A flushed batch whose job submission was refused (admission on
        the job queue): every rider fails with the refusal."""
        now = self._clock()
        with self._cond:
            for r in batch.requests:
                r.state = FAILED
                r.error = error
                r.latency_ms = round(
                    (now - r.arrived_clock) * 1e3, 3
                )
                self._retire_locked(r)
            self._cond.notify_all()
        if self._traces is not None:
            for r in batch.requests:
                self._traces.finish(
                    r.req_id, r.bucket_span_id, now,
                    attributes={"reason": "rejected"},
                )
        return list(batch.requests)

    # ---- completion fan-out ----

    def job_ids(self) -> List[str]:
        with self._cond:
            return list(self._jobs)

    def is_serve_job(self, job_id: str) -> bool:
        with self._cond:
            return job_id in self._jobs

    def complete_job(
        self, job_id: str, ok: bool, result: Any = None, error: Any = None
    ) -> List[InferRequest]:
        """Fan one terminal job's result out to its riding requests.
        Returns the requests that just completed (for metrics/SLO feeds).
        Unknown job ids (a replayed serve job from a dead incarnation, a
        non-serving job) return [] — a counted no-op at the caller."""
        with self._cond:
            req_ids = self._jobs.pop(job_id, None)
            if not req_ids:
                return []
            by_req: Dict[str, Any] = {}
            if ok and isinstance(result, dict):
                for entry in result.get("results") or []:
                    if isinstance(entry, dict) and entry.get("req_id"):
                        by_req[entry["req_id"]] = entry
            now = self._clock()
            completed: List[InferRequest] = []
            for rid in req_ids:
                req = self._requests.get(rid)
                if req is None or req.state in (DONE, FAILED):
                    continue
                entry = by_req.get(rid)
                if ok and entry is not None:
                    req.state = DONE
                    req.result = {
                        k: v for k, v in entry.items()
                        if k not in ("req_id", "telemetry")
                    }
                    tel = entry.get("telemetry")
                    req.telemetry = tel if isinstance(tel, dict) else None
                    ttft = entry.get("ttft_ms")
                    req.ttft_ms = (
                        round(float(ttft), 3)
                        if isinstance(ttft, (int, float)) else None
                    )
                    toks = entry.get("tokens")
                    req.tokens = (
                        int(toks) if isinstance(toks, (int, float)) else 0
                    )
                else:
                    req.state = FAILED
                    req.error = error if error is not None else {
                        "type": "MissingServeResult",
                        "message": "batch result carried no entry for "
                                   "this request",
                    }
                req.latency_ms = round((now - req.arrived_clock) * 1e3, 3)
                if req.ttft_ms is None and req.state == DONE:
                    # No agent-side stamp (e.g. classify on a legacy agent):
                    # first byte IS the completed answer.
                    req.ttft_ms = req.latency_ms
                self._retire_locked(req)
                completed.append(req)
            self._cond.notify_all()
        return completed

    def complete_cached(
        self,
        op: str,
        text: Any,
        result: Dict[str, Any],
        params: Optional[Dict[str, Any]] = None,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
    ) -> InferRequest:
        """Mint an already-DONE request for a front-door result-cache hit
       : the request never joins a bucket and never becomes a
        job — the cached batch entry IS the answer, delivered at submit
        time with TTFT ≈ 0. Only the fields the cache key does NOT cover
        (tenant/priority) need validating here: a hit implies the keyed
        fields (op/text/params) already passed ``submit`` validation once,
        byte-for-byte."""
        if op not in SERVE_OPS:
            raise ValueError(
                f"op must be one of {sorted(SERVE_OPS)}, got {op!r}"
            )
        if not isinstance(text, str) or not text:
            raise ValueError("text must be a non-empty string")
        if tenant is not None and (
            not isinstance(tenant, str) or not tenant
        ):
            raise ValueError("tenant must be a non-empty string")
        if priority is not None and (
            isinstance(priority, bool) or not isinstance(priority, int)
            or not 0 <= priority <= 9
        ):
            raise ValueError("priority must be an int in [0, 9]")
        now = self._clock()
        req = InferRequest(
            req_id=(
                f"req-{self.partition + '-' if self.partition else ''}"
                f"{uuid.uuid4().hex[:12]}"
            ),
            op=op,
            text=text,
            params=dict(params or {}),
            max_length=None,
            tenant=tenant if tenant is not None else "default",
            priority=(
                priority if priority is not None else self.config.priority
            ),
            arrived_wall=time.time(),
            arrived_clock=now,
        )
        req.bucket = self._bucket_len(text)
        req.state = DONE
        req.result = result
        toks = result.get("tokens") if isinstance(result, dict) else None
        req.tokens = int(toks) if isinstance(toks, (int, float)) else 0
        req.latency_ms = 0.0
        req.ttft_ms = 0.0
        with self._cond:
            self._requests[req.req_id] = req
            self._retire_locked(req)
            self._cond.notify_all()
        if self._traces is not None:
            req.root_span_id = self._traces.open(
                req.req_id, "infer", start_clock=now,
                attributes={
                    "op": op, "tenant": req.tenant,
                    "priority": req.priority, "bucket": req.bucket,
                },
            )
            self._traces.finish(
                req.req_id, req.root_span_id, now,
                attributes={"outcome": "completed", "cache_hit": True},
            )
        return req

    def _retire_locked(self, req: InferRequest) -> None:
        self._done_ring.append(req.req_id)
        while len(self._done_ring) > DONE_RETENTION:
            old = self._done_ring.popleft()
            if old != req.req_id:
                self._requests.pop(old, None)

    # ---- read side ----

    def get(self, req_id: str) -> Optional[InferRequest]:
        with self._cond:
            return self._requests.get(req_id)

    def snapshot(self, req_id: str) -> Optional[Dict[str, Any]]:
        with self._cond:
            req = self._requests.get(req_id)
            return req.snapshot() if req is not None else None

    def wait(
        self, req_id: str, timeout_sec: float
    ) -> Optional[Dict[str, Any]]:
        """Block until the request reaches a terminal state or the timeout
        elapses; returns the latest snapshot either way (None = unknown)."""
        deadline = time.monotonic() + max(0.0, timeout_sec)
        with self._cond:
            while True:
                req = self._requests.get(req_id)
                if req is None:
                    return None
                if req.state in (DONE, FAILED):
                    return req.snapshot()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return req.snapshot()
                self._cond.wait(timeout=min(remaining, 1.0))

    def wait_change(
        self, req_id: str, last_state: str, timeout_sec: float
    ) -> Optional[Dict[str, Any]]:
        """Block until the request's state differs from ``last_state`` (or
        timeout) — the chunked-streaming event loop's primitive."""
        deadline = time.monotonic() + max(0.0, timeout_sec)
        with self._cond:
            while True:
                req = self._requests.get(req_id)
                if req is None:
                    return None
                if req.state != last_state:
                    return req.snapshot()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return req.snapshot()
                self._cond.wait(timeout=min(remaining, 1.0))

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            states: Dict[str, int] = {}
            for r in self._requests.values():
                states[r.state] = states.get(r.state, 0) + 1
            out = {
                "requests": states,
                "open_buckets": len(self._buckets),
                "bucketed": sum(
                    len(v) for v in self._buckets.values()
                ),
                "jobs_in_flight": len(self._jobs),
                "rejected": self.rejected,
            }
            if self.partition:
                out["partition"] = self.partition
            return out
