"""The agent loop — counterpart of ``agent_tpu.agent.app``: lease tasks from
the reference's controller, run them through the op table on the card, and
report the results.

Wire protocol (``agent_tpu/controller/PROTOCOL.CONTRACT.md``):

- ``POST /v1/leases`` body ``{agent, capabilities: {ops, queue_depth,
  wire_formats?, device_kind?, mesh_devices?}, max_tasks, timeout_ms,
  labels, worker_profile, metrics}``; 204 (or empty tasks) = idle, else
  ``{lease_id, tasks: [{id|job_id, op, payload, job_epoch}], wire?}``.
- ``POST /v1/results`` body ``{lease_id, job_id, job_epoch, status:
  "succeeded"|"failed"|"released", result, error}``; the echoed
  ``job_epoch`` is the fencing token that lets the controller discard stale
  retries.

Behaviour kept from the reference:

- one thread dispatches to the device (the serial loop's, or the
  pipeline's device thread); no forks, no process pools;
- status 0 = transport error; lease errors back off with capped
  exponential backoff and decorrelated jitter, an idle lease sleeps
  ``idle_sleep_sec`` ±25 %;
- a result whose post fails transiently is spooled and redelivered, epoch
  fencing making redelivery idempotent; a permanent rejection is dropped;
- the ``b1`` binary wire is offered in the lease and used for result
  columns once the controller grants it;
- SIGINT/SIGTERM drain: finish the in-flight task, release the unstarted
  remainder of the lease, flush the spool and the final metrics, exit 0;
- exit code 2 when ``TASKS`` resolves to no ops or names an unknown one.

Differences: the default session is ``urllib`` (``utils.http``), so the
agent runs where ``requests`` is not installed. An agent whose ``TASKS``
include a device op (``ops.DEVICE_OPS``) builds the runtime when it
starts — on ``cuda:0``, failing there without CUDA — and an agent of host
ops only never builds one. A result carries the op's ``usage`` block (rows,
``cache_hit_rows``). Not ported yet: spans and the flight recorder, the
agent's own usage stamps (device and host seconds, chips, FLOPs), the
health/MFU and memory gauges, profile captures, SLO alert
dumps, the ``CONTROLLER_URLS`` failover list, the partition map and
multi-host slices.

Run it as ``python -m agent_tpu_torch.agent.app`` with ``CONTROLLER_URL``
and ``TASKS`` set.
"""

from __future__ import annotations

import signal
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from agent_tpu_torch.agent.spool import ResultSpool
from agent_tpu_torch.config import Config
from agent_tpu_torch.data import wire
from agent_tpu_torch.obs.metrics import MetricsRegistry
from agent_tpu_torch.ops import DEVICE_OPS, OpFn, load_ops
from agent_tpu_torch.utils.errors import structured_error
from agent_tpu_torch.utils.logging import RateLimiter, log
from agent_tpu_torch.utils.retry import PERMANENT, RetryPolicy, classify_http, jittered

# result-timings key -> task_phase_seconds phase label. The ops stamp
# milliseconds into ctx.tags["timings"]; the loops observe them in seconds.
PHASE_KEYS = (
    ("stage_ms", "stage"),
    ("queue_ms", "queue"),
    ("device_ms", "execute"),
    ("fetch_ms", "fetch"),
    ("finalize_ms", "finalize"),
)

STATUS_TRANSPORT_ERROR = 0  # "could not reach the controller at all"


def collect_host_metrics() -> Dict[str, Any]:
    """``{cpu_util: 0..1, ram_mb}`` via psutil; empty when psutil is missing."""
    try:
        import psutil  # type: ignore

        return {
            "cpu_util": psutil.cpu_percent(interval=None) / 100.0,
            "ram_mb": int(psutil.virtual_memory().used / (1024 * 1024)),
        }
    except Exception:  # noqa: BLE001 — psutil optional
        return {}


def _default_session():
    from agent_tpu_torch.utils.http import UrllibSession

    return UrllibSession()


class Agent:
    """One agent process: leases tasks, executes them, reports.

    ``session`` is any object with ``post(url, json=, timeout=) ->
    response`` (``status_code``, ``json()``, ``text``); the default is the
    ``urllib`` session. ``runtime`` is the ``TorchRuntime`` handed to ops;
    left None it is built here when ``TASKS`` include a device op.
    """

    def __init__(self, config: Optional[Config] = None, session: Any = None,
                 runtime: Any = None) -> None:
        self.config = config or Config.from_env()
        self.session = session if session is not None else _default_session()
        self.running = True
        # Set by request_drain (SIGTERM): stop leasing, finish the in-flight
        # task, release the unstarted remainder of the lease, flush, exit.
        self.draining = False
        a = self.config.agent
        self.rate = RateLimiter(a.error_log_every_sec)
        self.obs = MetricsRegistry()  # its snapshot rides every lease
        self.m_tasks = self.obs.counter(
            "tasks_total", "Tasks completed by op and status", ("op", "status"))
        self.m_phase = self.obs.histogram(
            "task_phase_seconds",
            "Per-task phase latency (stage/queue/execute/fetch/finalize)", ("op", "phase"))
        self.m_lease = self.obs.counter(
            "lease_requests_total", "Lease polls by outcome", ("outcome",))
        self.m_queue = self.obs.gauge(
            "queue_depth", "Pipeline queue occupancy (staged/post)", ("queue",))
        self.m_device_idle = self.obs.counter(
            "device_idle_seconds_total",
            "Device-thread seconds blocked waiting for staged work")
        self.m_device_busy = self.obs.counter(
            "device_busy_seconds_total",
            "Device-thread seconds dispatching op execute phases, per op", ("op",))
        self.m_post_fail = self.obs.counter(
            "result_post_failures_total",
            "Result posts that failed (then spooled, or dropped if permanent)", ("op",))
        self.m_redeliveries = self.obs.counter(
            "result_redeliveries_total",
            "Spooled-result redelivery outcomes (delivered/dropped_permanent/"
            "dropped_overflow/expired)", ("outcome",))
        self.m_spool_depth = self.obs.gauge(
            "result_spool_depth", "Completed results awaiting redelivery")
        self.m_serve_occupancy = self.obs.gauge(
            "serve_batch_occupancy",
            "Continuous-batching running batch: requests currently seated "
            "(0 when no serving work is in flight)")
        self.spool = ResultSpool(capacity=a.result_spool_max, path=a.result_spool_path or None)
        self._retry_policy = RetryPolicy(base_sec=a.retry_base_sec, max_sec=a.retry_max_sec)
        self._lease_retry = RetryPolicy(base_sec=a.error_backoff_sec,
                                        max_sec=a.retry_max_sec).start()
        self._spool_retry = self._retry_policy.start()
        self._spool_next_try = 0.0
        self.m_spool_depth.set(len(self.spool))  # disk-loaded backlog
        self._progress = {"t": time.monotonic(), "n": 0}
        # Unknown or disabled op names fail here, not mid-lease.
        self.handlers: Dict[str, OpFn] = load_ops(list(a.tasks))
        if runtime is None and DEVICE_OPS & set(self.handlers):
            from agent_tpu_torch.runtime.runtime import get_runtime

            runtime = get_runtime()  # cuda:0, or a RuntimeError without CUDA
        self.runtime = runtime
        self._profile: Optional[Dict[str, Any]] = None
        self.tasks_done = 0
        # Live staged-queue depth (set by PipelineRunner), shipped in the
        # lease capabilities.
        self.staged_depth_fn: Optional[Any] = None
        # The wire format the controller granted on the last lease ("b1"),
        # None against a JSON-only controller; finalize reads it from the
        # op context.
        self.wire_format: Optional[str] = None
        # Staging-pool grant ask: lease max(MAX_TASKS, hint) tasks.
        self.lease_batch_hint: Optional[int] = None
        # Poster-thread session factory; None = a fresh default session.
        self.post_session_factory: Optional[Any] = None

    # ---- controller I/O ----

    def _post_json(self, path: str, body: Dict[str, Any],
                   session: Any = None) -> Tuple[int, Any]:
        """POST JSON -> (status, parsed body). Status 0 = transport error;
        a body that is not JSON comes back as text. ``session`` overrides
        the agent's (the poster thread brings its own)."""
        url = f"{self.config.agent.controller_url}{path}"
        try:
            resp = (session or self.session).post(
                url, json=body, timeout=self.config.agent.http_timeout_sec)
        except Exception as exc:  # noqa: BLE001 — any transport failure
            return STATUS_TRANSPORT_ERROR, repr(exc)
        if resp.status_code == 204:
            return 204, None
        try:
            return resp.status_code, resp.json()
        except ValueError:
            return resp.status_code, getattr(resp, "text", None)

    def worker_profile(self) -> Dict[str, Any]:
        """The worker profile, built once per process (probing is not free)."""
        if self._profile is None:
            from agent_tpu_torch.sizing.profile import build_worker_profile

            self._profile = build_worker_profile(self.config.sizing)
        return self._profile

    def _staged_depth(self) -> int:
        try:
            if self.staged_depth_fn is not None:
                return max(0, int(self.staged_depth_fn()))
            return max(0, int(self.m_queue.value(queue="staged")))
        except Exception:  # noqa: BLE001 — telemetry must never kill a lease
            return 0

    def capabilities(self) -> Dict[str, Any]:
        """The lease ``capabilities``: ops, the staged backlog, the binary
        wire offer and, once a runtime exists, its platform and size."""
        caps: Dict[str, Any] = {"ops": sorted(self.handlers), "queue_depth": self._staged_depth()}
        if self.config.agent.wire_binary:
            caps["wire_formats"] = list(wire.FORMATS)
        if self.runtime is not None:
            caps["device_kind"] = self.runtime.platform
            caps["mesh_devices"] = self.runtime.n_devices
        return caps

    def note_device_time(self, op: str, seconds: float) -> None:
        """Device-thread seconds spent dispatching one op's execute."""
        self.m_device_busy.inc(max(0.0, seconds), op=op)

    def _metrics(self) -> Dict[str, Any]:
        m = collect_host_metrics()
        if self.runtime is not None:
            try:
                m["device"] = self.runtime.describe()
            except Exception:  # noqa: BLE001 — telemetry must never kill a lease
                pass
        m["obs"] = self.obs.snapshot()
        return m

    def push_metrics(self) -> bool:
        """Metrics-only lease poll (``max_tasks=0``) after the last result,
        so the final counters reach the fleet view; best-effort."""
        a = self.config.agent
        body: Dict[str, Any] = {
            "agent": a.agent_name,
            "capabilities": {"ops": [], "queue_depth": self._staged_depth()},
            "max_tasks": 0,
            "labels": a.labels,
            "metrics": self._metrics(),
        }
        if self.draining:
            body["draining"] = True  # the retiring agent's half of the handshake
        status, _ = self._post_json("/v1/leases", body)
        return status in (200, 204)

    def record_phase_timings(self, op: str, timings: Optional[Dict[str, Any]],
                             keys: Optional[Tuple[str, ...]] = None) -> None:
        """ctx.tags["timings"] (milliseconds) -> ``task_phase_seconds``.
        ``keys`` restricts which timing keys count: the pipelined runner
        measures stage/execute/finalize itself and takes only queue/fetch
        from the op's timings."""
        for key, phase in PHASE_KEYS:
            if keys is not None and key not in keys:
                continue
            v = (timings or {}).get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.m_phase.observe(float(v) / 1000.0, op=op, phase=phase)

    def note_progress(self, queues: Optional[Dict[str, int]] = None) -> None:
        """Rate-limited progress summary (tasks/s over the window, queue
        depths)."""
        if not self.rate.ready("progress"):
            return
        now = time.monotonic()
        dt = now - self._progress["t"]
        dn = self.tasks_done - self._progress["n"]
        self._progress = {"t": now, "n": self.tasks_done}
        fields: Dict[str, Any] = {"tasks_done": self.tasks_done}
        if dt > 0:
            fields["tasks_per_sec"] = round(dn / dt, 3)
        if queues:
            fields.update(queues)
        log("progress", **fields)

    def lease_once(self) -> Optional[Tuple[str, List[Dict[str, Any]]]]:
        """One ``/v1/leases`` round trip -> ``(lease_id, tasks)``, or None
        when idle. Raises RuntimeError on transport/protocol errors so the
        caller backs off."""
        a = self.config.agent
        hint = self.lease_batch_hint
        max_tasks = a.max_tasks if hint is None else max(a.max_tasks, int(hint))
        status, body = self._post_json("/v1/leases", {
            "agent": a.agent_name,
            "capabilities": self.capabilities(),
            "max_tasks": max_tasks,
            "timeout_ms": a.lease_timeout_ms,
            "labels": a.labels,
            "worker_profile": self.worker_profile(),
            "metrics": self._metrics(),
        })
        if status == STATUS_TRANSPORT_ERROR:
            self.m_lease.inc(outcome="error")
            raise RuntimeError(f"lease transport error: {body}")
        if status == 204:
            self.m_lease.inc(outcome="idle")
            return None
        if status != 200 or not isinstance(body, dict):
            self.m_lease.inc(outcome="error")
            raise RuntimeError(f"lease HTTP {status}: {str(body)[:200]}")
        tasks = body.get("tasks")
        lease_id = body.get("lease_id")
        if not tasks:
            self.m_lease.inc(outcome="idle")
            return None
        if not isinstance(lease_id, str) or not isinstance(tasks, list):
            self.m_lease.inc(outcome="error")
            raise RuntimeError(f"malformed lease response: {str(body)[:200]}")
        # The controller stamps every lease it negotiated, so re-deriving it
        # here follows a controller that changed its mind.
        fmt = body.get("wire")
        self.wire_format = fmt if fmt in wire.FORMATS else None
        self.m_lease.inc(outcome="tasks")
        return lease_id, tasks

    def post_result(self, lease_id: str, job_id: str, job_epoch: Any, status: str,
                    result: Any = None, error: Any = None, session: Any = None,
                    op: str = "?") -> bool:
        """Post one result; a transient failure spools it for redelivery, a
        permanent one (the controller rejected the request itself) is
        counted and dropped."""
        http_status, body = self._post_json("/v1/results", {
            "lease_id": lease_id,
            "job_id": job_id,
            "job_epoch": job_epoch,
            "status": status,
            "result": result,
            "error": error,
        }, session=session)
        if http_status in (200, 204):
            return True
        self.m_post_fail.inc(op=op)
        failure_class = classify_http(http_status)
        self.rate.log("result", "post failed", status=http_status,
                      failure_class=failure_class, body=str(body)[:200])
        if failure_class == PERMANENT:
            return False
        evicted = self.spool.put(lease_id, job_id, job_epoch, status,
                                 result=result, error=error, op=op)
        if evicted is not None:
            self.m_redeliveries.inc(outcome="dropped_overflow")
        self.m_spool_depth.set(len(self.spool))
        return False

    def release_job(self, lease_id: str, job_id: str, job_epoch: Any, op: str = "?") -> bool:
        """Hand one unstarted leased task back (``status="released"``): the
        job is leasable again at once, without burning an attempt."""
        self.m_tasks.inc(op=op, status="released")
        return self.post_result(lease_id, job_id, job_epoch, "released", op=op)

    def release_task(self, lease_id: str, task: Any) -> bool:
        """:meth:`release_job` from a raw task dict."""
        if not isinstance(task, dict):
            return False
        job_id = task.get("id", task.get("job_id"))
        if not isinstance(job_id, str) or not job_id:
            return False
        op = task.get("op") if isinstance(task.get("op"), str) else "?"
        return self.release_job(lease_id, job_id, task.get("job_epoch"), op=op)

    def flush_spool(self, session: Any = None, force: bool = False) -> int:
        """Redeliver spooled results, oldest first, honouring the backoff
        window between attempts (``force`` ignores it). Stops at the first
        transient failure; drops entries the controller rejects permanently
        or that outlived ``retry_deadline_sec``. Returns the number
        delivered."""
        if not len(self.spool):
            return 0
        if not force and time.monotonic() < self._spool_next_try:
            return 0
        deadline = self.config.agent.retry_deadline_sec
        delivered = 0
        while len(self.spool):
            if deadline > 0 and self.spool.age_of_head() >= deadline:
                self.spool.pop_head()
                self.m_redeliveries.inc(outcome="expired")
                continue
            entry = self.spool.head()
            status, _ = self._post_json("/v1/results", ResultSpool.wire_body(entry),
                                        session=session)
            if status in (200, 204):
                self.spool.pop_head()
                delivered += 1
                self.m_redeliveries.inc(outcome="delivered")
                self._spool_retry.reset()
                self._spool_next_try = 0.0
            elif classify_http(status) == PERMANENT:
                self.spool.pop_head()
                self.m_redeliveries.inc(outcome="dropped_permanent")
            else:
                self._spool_next_try = time.monotonic() + self._spool_retry.next_backoff()
                break
        self.m_spool_depth.set(len(self.spool))
        return delivered

    # ---- task execution ----

    @staticmethod
    def extract_task(task: Any) -> Tuple[str, str, Dict[str, Any], Any]:
        """Task dict -> ``(job_id, op, payload, job_epoch)``; accepts ``id``
        or ``job_id``, strict types."""
        if not isinstance(task, dict):
            raise ValueError(f"task must be a dict, got {type(task).__name__}")
        job_id = task.get("id", task.get("job_id"))
        op = task.get("op")
        payload = task.get("payload", {})
        epoch = task.get("job_epoch")
        if not isinstance(job_id, str) or not job_id:
            raise ValueError("task missing string id/job_id")
        if not isinstance(op, str) or not op:
            raise ValueError("task missing string op")
        if payload is None:
            payload = {}
        if not isinstance(payload, dict):
            raise ValueError("task payload must be a dict")
        return job_id, op, payload, epoch

    def op_context(self, job_id: str, lease_id: Optional[str] = None, attempt: Any = None):
        """The task's ``OpContext``: the runtime, the trace triple the result
        carries, and the negotiated wire format finalize reads."""
        from agent_tpu_torch.runtime.context import OpContext

        tags: Dict[str, Any] = {
            "job_id": job_id,
            "trace": {"job_id": job_id, "attempt": attempt, "lease_id": lease_id},
        }
        if self.wire_format:
            tags["wire"] = self.wire_format
        return OpContext(runtime=self.runtime, tags=tags, config=self.config)

    def resolve_task(self, task: Any) -> Tuple[Optional[str], str, Dict[str, Any], Any,
                                               Optional[OpFn], Optional[Dict[str, Any]]]:
        """Task dict -> ``(job_id, op, payload, epoch, handler, error)``: the
        one definition of malformed-task salvage and the UnknownOp error,
        shared by the serial loop and the pipeline. ``handler`` is None iff
        ``error`` is set; a malformed task with no salvageable id returns
        ``job_id=None`` (nothing to report against)."""
        try:
            job_id, op, payload, epoch = self.extract_task(task)
            if wire.is_binary_payload(payload):
                payload = wire.decode_task_payload(payload)
        except ValueError as exc:
            self.rate.log("task:bad", "malformed task", error=str(exc))
            jid = task.get("id") if isinstance(task, dict) else None
            jid = jid if isinstance(jid, str) and jid else None
            return jid, "?", {}, None, None, structured_error(exc)
        fn = self.handlers.get(op)
        if fn is None:
            return job_id, op, payload, epoch, None, {
                "type": "UnknownOp",
                "message": f"op {op!r} not in capabilities {sorted(self.handlers)}",
                "trace": "",
            }
        return job_id, op, payload, epoch, fn, None

    @staticmethod
    def finish_result(result: Any, ctx: Any, duration_ms: float) -> None:
        """Stamp the loop's fields into an op's result dict: the op's
        ``usage`` block too, which the reference controller's showback
        ledger bills."""
        if isinstance(result, dict):
            result.setdefault("duration_ms", duration_ms)
            if ctx is not None:
                if ctx.tags.get("timings"):
                    result.setdefault("timings", ctx.tags["timings"])
                result.setdefault("trace", ctx.tags.get("trace"))
                if ctx.tags.get("usage"):
                    result.setdefault("usage", ctx.tags["usage"])

    def run_task(self, lease_id: str, task: Any) -> None:
        """Execute one leased task inline and report its result. A raised
        exception becomes a ``failed`` result with the structured error; the
        agent never dies on an op error."""
        t0 = time.perf_counter()
        job_id, op, payload, epoch, fn, resolve_error = self.resolve_task(task)
        if resolve_error is not None:
            if job_id is not None:
                self.m_tasks.inc(op=op, status="failed")
                self.post_result(lease_id, job_id, epoch, "failed", error=resolve_error, op=op)
            return
        ctx = self.op_context(job_id, lease_id=lease_id, attempt=task.get("attempt"))
        t_exec0 = time.perf_counter()
        try:
            result, status, error = fn(payload, ctx), "succeeded", None
        except Exception as exc:  # noqa: BLE001 — every op error -> failed result
            result, status, error = None, "failed", structured_error(exc)
            self.rate.log("exec", "op raised", op=op, type=type(exc).__name__)
        t_done = time.perf_counter()
        self.note_device_time(op, t_done - t_exec0)
        self.finish_result(result, ctx, (t_done - t0) * 1000.0)
        self.post_result(lease_id, job_id, epoch, status, result=result, error=error, op=op)
        self.tasks_done += 1
        self.m_tasks.inc(op=op, status=status)
        self.record_phase_timings(op, ctx.tags.get("timings"))
        self.note_progress()

    # ---- main loop ----

    def step(self) -> bool:
        """One serial-loop iteration; True if a lease brought tasks."""
        self.flush_spool()
        try:
            leased = self.lease_once()
        except RuntimeError as exc:
            self.rate.log("lease", str(exc))
            time.sleep(self._lease_retry.next_backoff())
            return False
        self._lease_retry.reset()
        if leased is None:
            time.sleep(jittered(self.config.agent.idle_sleep_sec))
            return False
        lease_id, tasks = leased
        for task in tasks:
            if self.running:
                self.run_task(lease_id, task)
            elif self.draining:
                self.release_task(lease_id, task)
            # else: hard stop — abandoned, the lease TTL re-queues.
        return True

    def run(self, max_steps: Optional[int] = None) -> None:
        """The pipelined runner when ``PIPELINE_DEPTH`` > 0 (and no step
        limit), else the serial loop; either ends when ``running`` flips."""
        if max_steps is None and self.config.agent.pipeline_depth > 0:
            from agent_tpu_torch.agent.pipeline import PipelineRunner

            PipelineRunner(self, depth=self.config.agent.pipeline_depth).run()
            return
        steps = 0
        while self.running:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self.flush_spool(force=True)
        self.push_metrics()

    def request_drain(self, reason: str = "drain") -> None:
        """Begin graceful retirement: stop leasing, finish the in-flight
        task, release the unstarted remainder, flush, exit clean."""
        if not self.draining:
            self.draining = True
            log("drain requested", reason=reason)
        self.running = False

    def shutdown(self, *_args: Any) -> None:
        """Signal handler (SIGINT/SIGTERM): the drain path."""
        self.request_drain(reason="signal")


def main(argv: Optional[List[str]] = None) -> int:
    config = Config.from_env()
    if not config.agent.tasks:
        print("[agent-tpu-torch] no TASKS configured; refusing to start", flush=True)
        return 2
    try:
        agent = Agent(config)
    except KeyError as exc:
        # An unknown or disabled op name: the same start failure as no TASKS.
        print(f"[agent-tpu-torch] bad TASKS: {exc}", flush=True)
        return 2
    except RuntimeError as exc:
        # A device op without a CUDA device: the port never runs it on the CPU.
        print(f"[agent-tpu-torch] cannot start: {exc}", flush=True)
        return 1
    signal.signal(signal.SIGINT, agent.shutdown)
    signal.signal(signal.SIGTERM, agent.shutdown)
    log("agent up", agent=config.agent.agent_name, controller=config.agent.controller_url,
        ops=sorted(agent.handlers),
        device=None if agent.runtime is None else str(agent.runtime.device))
    agent.run()
    log("agent drained", tasks_done=agent.tasks_done)
    return 0


if __name__ == "__main__":
    sys.exit(main())
