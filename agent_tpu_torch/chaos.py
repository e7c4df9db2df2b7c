"""Seeded chaos-testing primitives — the port's counterpart of
``agent_tpu.chaos``. The same seed and call sequence give the reference's
fault pattern; ``LoopbackSession`` follows the port's controller server.

The controller's original fault surface was three *one-shot* ``inject()``
faults — enough to unit-test a single fence, useless for exercising
sustained failure. This module makes failure a first-class, reproducible
input:

- ``FaultPlan`` — a seeded, probabilistic plan over named fault kinds. One
  ``random.Random(seed)`` drives every decision, so the same seed + the same
  call sequence replays the same fault pattern (the property
  the chaos tests pin). Every injected fault is counted in
  ``plan.counts`` so a soak can reconcile *injected* against *observed*.
- ``ChaosSession`` — wraps any ``session.post`` with plan-driven transport
  faults on the agent side of the wire: drop the request (never delivered),
  drop the response (delivered, answer lost — the nasty case: the controller
  applied the result but the agent must assume it didn't), fabricate an
  HTTP 500 after delivery, deliver a result twice, or delay. Counted into
  ``chaos_faults_injected_total{fault,path}`` when given a registry.
- ``LoopbackSession`` — an in-process "HTTP" session: ``post`` calls a
  ``Controller`` directly with the same request/response shapes as
  ``controller/server.py``. Lets the chaos soak drive the *real* ``Agent``
  loop against a *real* ``Controller`` deterministically, no sockets.
- ``GatedSession`` — a controller-outage switch: while ``down``, every post
  raises a transport error. The soak uses it to prove a controller outage
  shorter than the lease TTL causes zero shard re-executions (the spool
  redelivers instead).

The controller side (probabilistic ``drop_lease`` / ``duplicate_task`` /
``stale_epoch``) consumes the same plan via ``Controller.inject(plan=...)``.
"""

from __future__ import annotations

import json as _json
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class ChaosTransportError(ConnectionError):
    """The transport-failure exception injected faults raise — a
    ``ConnectionError`` so real retry paths treat it exactly like a dropped
    TCP connection."""


@dataclass
class FaultPlan:
    """A seeded probability per fault kind; 0.0 disables a kind.

    Agent-side kinds (``ChaosSession``): ``drop_request``, ``drop_response``,
    ``http_500``, ``duplicate_result``, ``delay`` (+ ``delay_max_sec``).
    Controller-side kinds (``Controller.inject(plan=...)``): ``drop_lease``,
    ``duplicate_task``, ``stale_epoch``. Harness-level: ``agent_crash``
    (the soak abandons a granted lease and restarts the agent), plus the
    preemption kinds: ``spot_reclaim`` — SIGTERM with a grace
    window, the member runs the full drain path (finish/release the
    in-flight lease, flush spool + final metrics, exit clean) before the
    capacity disappears — and ``hard_kill`` — SIGKILL mid-execute, no
    drain: in-flight work is lost and must be recovered by lease-TTL
    expiry + epoch fencing while the autoscaler replaces the capacity.
    ``controller_kill`` SIGKILLs the PRIMARY CONTROLLER itself
    mid-drain; recovery is hot-standby promotion + agent CONTROLLER_URLS
    failover + spool redelivery.
    """

    seed: int = 0
    # agent-side transport faults
    drop_request: float = 0.0
    drop_response: float = 0.0
    http_500: float = 0.0
    duplicate_result: float = 0.0
    delay: float = 0.0
    delay_max_sec: float = 0.0
    # controller-side faults
    drop_lease: float = 0.0
    duplicate_task: float = 0.0
    stale_epoch: float = 0.0
    # harness-level faults
    agent_crash: float = 0.0
    # preemption faults: decided per live member per churn tick
    spot_reclaim: float = 0.0
    hard_kill: float = 0.0
    # control-plane fault: SIGKILL the PRIMARY CONTROLLER
    # mid-drain — no close(), no journal fsync, a possibly-torn final
    # journal line. Recovery is the hot-standby promotion path
    # (controller/standby.py): journal tail + seal + epoch-fenced requeue,
    # with agents failing over via CONTROLLER_URLS and the spool
    # redelivering completed results to the new incarnation. Decided by
    # the soak harness per tick (the reference's scripts/controller_failover_soak.py).
    controller_kill: float = 0.0
    counts: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    def decide(self, fault: str) -> bool:
        """One Bernoulli draw for ``fault``; hits are tallied in ``counts``.
        A zero-probability kind consumes no randomness, so enabling one
        fault never perturbs another's sequence."""
        prob = float(getattr(self, fault))
        if prob <= 0.0:
            return False
        with self._lock:
            hit = self._rng.random() < prob
            if hit:
                self.counts[fault] = self.counts.get(fault, 0) + 1
        return hit

    def draw_delay(self) -> float:
        with self._lock:
            return self._rng.uniform(0.0, max(0.0, self.delay_max_sec))

    def total_injected(self) -> int:
        with self._lock:
            return sum(self.counts.values())


class _FakeResponse:
    """The minimal response surface the agent reads."""

    def __init__(self, status_code: int, body: Any = None) -> None:
        self.status_code = status_code
        self._body = body
        self.text = "" if body is None else _json.dumps(body, default=str)

    def json(self) -> Any:
        if self._body is None:
            raise ValueError("no body")
        return self._body


def _path_of(url: str) -> str:
    if url.endswith("/v1/leases"):
        return "leases"
    if url.endswith("/v1/results"):
        return "results"
    if url.endswith("/v1/jobs"):
        return "jobs"
    if url.endswith("/v1/workflows"):
        return "workflows"
    return "other"


class LoopbackSession:
    """In-process stand-in for ``requests.Session`` over a ``Controller`` —
    the same dispatch ``controller/server.py`` does, minus the sockets."""

    def __init__(self, controller: Any) -> None:
        self.controller = controller

    def post(self, url: str, json: Any = None, timeout: Any = None):  # noqa: A002
        body = json or {}
        path = _path_of(url)
        if path == "leases":
            raw_max = body.get("max_tasks")
            out = self.controller.lease(
                agent=str(body.get("agent", "")),
                capabilities=body.get("capabilities"),
                max_tasks=1 if raw_max is None else int(raw_max),
                worker_profile=body.get("worker_profile"),
                metrics=body.get("metrics"),
                labels=body.get("labels")
                if isinstance(body.get("labels"), dict) else None,
                # Drain handshake: a retiring agent's final
                # metrics-only poll marks it `draining` in /v1/status.
                draining=bool(body.get("draining")),
            )
            return (
                _FakeResponse(204) if out is None else _FakeResponse(200, out)
            )
        if path == "results":
            out = self.controller.report(
                lease_id=str(body.get("lease_id", "")),
                job_id=str(body.get("job_id", "")),
                job_epoch=body.get("job_epoch"),
                status=str(body.get("status", "")),
                result=body.get("result"),
                error=body.get("error"),
                spans=body.get("spans"),
            )
            return _FakeResponse(200, out)
        if path == "jobs":
            # Single-job submit with the scheduling fields — the
            # same dispatch controller/server.py does, including the 429
            # admission response, so soaks can exercise backpressure
            # in-process.
            from agent_tpu_torch.sched import AdmissionError

            try:
                job_id = self.controller.submit(
                    op=str(body.get("op", "")),
                    payload=body.get("payload"),
                    # Client-chosen id: same exactly-once
                    # resubmission contract as controller/server.py.
                    job_id=(
                        str(body["job_id"])
                        if body.get("job_id") is not None else None
                    ),
                    required_labels=body.get("required_labels"),
                    max_attempts=body.get("max_attempts"),
                    priority=body.get("priority"),
                    tenant=body.get("tenant"),
                    deadline_sec=body.get("deadline_sec"),
                )
            except AdmissionError as exc:
                return _FakeResponse(429, {
                    "error": str(exc),
                    "retry_after_ms": exc.retry_after_ms,
                    "tenant": exc.tenant,
                    "scope": exc.scope,
                })
            except (KeyError, ValueError, TypeError) as exc:
                return _FakeResponse(400, {"error": str(exc)})
            return _FakeResponse(200, {"job_id": job_id})
        if path == "workflows":
            # Workflow DAG submit — same dispatch and error
            # mapping as controller/server.py's POST /v1/workflows.
            from agent_tpu_torch.sched import AdmissionError

            try:
                out = self.controller.submit_workflow(
                    workflow=body,
                    tenant=body.get("tenant"),
                    priority=body.get("priority"),
                    deadline_sec=body.get("deadline_sec"),
                    workflow_id=body.get("workflow_id"),
                )
            except AdmissionError as exc:
                return _FakeResponse(429, {
                    "error": str(exc),
                    "retry_after_ms": exc.retry_after_ms,
                    "tenant": exc.tenant,
                    "scope": exc.scope,
                })
            except (KeyError, ValueError, TypeError) as exc:
                return _FakeResponse(400, {"error": str(exc)})
            except RuntimeError as exc:
                return _FakeResponse(501, {"error": str(exc)})
            return _FakeResponse(200, out)
        return _FakeResponse(404, {"error": f"no route {url}"})


class GatedSession:
    """Wraps a session with an on/off outage switch: while ``down``, posts
    raise ``ChaosTransportError`` without reaching the inner session."""

    def __init__(self, inner: Any) -> None:
        self.inner = inner
        self.down = False
        self.rejected = 0

    def post(self, url: str, json: Any = None, timeout: Any = None):  # noqa: A002
        if self.down:
            self.rejected += 1
            raise ChaosTransportError("chaos: controller outage")
        return self.inner.post(url, json=json, timeout=timeout)


class ChaosSession:
    """Plan-driven transport faults around any session's ``post``.

    Fault order per request: delay → drop_request (never delivered) →
    deliver → duplicate_result (results only: delivered again; the first
    response is returned, so the agent believes one clean post happened
    while the controller saw two) → drop_response (delivered, answer lost)
    → http_500 (delivered, but the agent is told the server failed). The
    post-delivery faults are the interesting ones: they force redelivery of
    results the controller already applied, which epoch fencing and the
    duplicate guard must absorb without double-applying.
    """

    def __init__(
        self,
        inner: Any,
        plan: FaultPlan,
        registry: Any = None,
        recorder: Any = None,
        sleep=time.sleep,
    ) -> None:
        self.inner = inner
        self.plan = plan
        self.recorder = recorder
        self._sleep = sleep
        self._m = (
            registry.counter(
                "chaos_faults_injected_total",
                "Transport faults injected by the chaos session",
                ("fault", "path"),
            )
            if registry is not None
            else None
        )

    def _note(self, fault: str, path: str) -> None:
        if self._m is not None:
            self._m.inc(fault=fault, path=path)
        if self.recorder is not None:
            self.recorder.record("chaos_fault", fault=fault, path=path)

    def post(self, url: str, json: Any = None, timeout: Any = None):  # noqa: A002
        plan = self.plan
        path = _path_of(url)
        if plan.decide("delay"):
            self._note("delay", path)
            self._sleep(plan.draw_delay())
        if plan.decide("drop_request"):
            self._note("drop_request", path)
            raise ChaosTransportError(f"chaos: dropped request to {path}")
        resp = self.inner.post(url, json=json, timeout=timeout)
        if path == "results" and plan.decide("duplicate_result"):
            self._note("duplicate_result", path)
            self.inner.post(url, json=json, timeout=timeout)
        if plan.decide("drop_response"):
            self._note("drop_response", path)
            raise ChaosTransportError(f"chaos: dropped response from {path}")
        if plan.decide("http_500"):
            self._note("http_500", path)
            return _FakeResponse(500, {"error": "chaos: injected 500"})
        return resp
