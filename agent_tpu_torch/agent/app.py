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

Telemetry, as the reference's: the runner's own phase measurements become
spans (``stage``, ``queue``, ``execute``, ``post``, ``result.redeliver``)
parented to the controller's lease span; they ride ``POST /v1/results``
and the lease ``metrics`` channel, and are requeued when a post fails. Each
execute feeds ``device_busy_seconds_total{op}``, the rolling
``device_duty_cycle``, ``device_flops_total{op,shape}`` and
``device_mfu{op}`` (the ops' analytic FLOPs over busy seconds over the
card's peak, ``obs.health``), and stamps the result's ``usage`` block with
the same ``device_s``, ``chips``, ``flops`` and the host's ``host_s``.
``device_hbm_bytes{device,kind}`` reads every card the runtime owns
(``obs.profile``). A flight recorder (``obs.recorder``) keeps the last
events; ``SIGUSR1`` dumps it, as does a fatal error and an ``slo_page``
alert on a lease (once per episode). ``PROFILE_DIR`` writes a
``torch.profiler`` Chrome trace of the first ``PROFILE_TASKS`` tasks'
execute; a ``profile_capture`` alert wraps the next matching execute in
one, and its completion record rides the lease metrics
(``profile_captures``). ``CONTROLLER_URLS`` is the failover list: a
transport error rotates to the next controller.

Differences: the default session is ``urllib`` (``utils.http``), so the
agent runs where ``requests`` is not installed. An agent whose ``TASKS``
include a device op (``ops.DEVICE_OPS``) builds the runtime when it
starts — on ``cuda:0``, failing there without CUDA — and an agent of host
ops only never builds one. Not ported yet: the partition map (ROADMAP
Queue 1).

Several processes, one lease loop (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``; ``runtime.distributed``): process 0,
the leader, leases, broadcasts each task to the followers before it runs
it, and alone posts; a follower opens no HTTP session and runs every task
it receives in lockstep until the leader's shutdown. An op that raises on
any process takes the whole slice down (the leader first posts the
failure), since a process that moved on would wait in a collective its
peers never enter. Several processes run the serial loop, never the
pipelined runner.

Run it as ``python -m agent_tpu_torch.agent.app`` with ``CONTROLLER_URL``
and ``TASKS`` set.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from agent_tpu_torch.agent.spool import ResultSpool
from agent_tpu_torch.config import Config
from agent_tpu_torch.data import wire
from agent_tpu_torch.obs import trace as obs_trace
from agent_tpu_torch.obs.health import RollingWindow, resolve_peak_flops
from agent_tpu_torch.obs.metrics import MetricsRegistry
from agent_tpu_torch.obs.profile import KINDS, device_memory_stats
from agent_tpu_torch.obs.recorder import FlightRecorder, default_dump_path
from agent_tpu_torch.obs.trace import SpanBuffer, TraceContext, make_span, new_span_id, use_context
from agent_tpu_torch.obs.usage import stamp_usage
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

# The rolling duty cycle's window: "is the device busy right now".
DUTY_WINDOW_SEC = 60.0


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


def _profiler_active() -> bool:
    """A torch.profiler session is already recording in this process (the
    agent never nests one inside another)."""
    import torch

    enabled = getattr(torch._C._autograd, "_profiler_enabled", None)
    return bool(enabled()) if enabled is not None else False


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
        # Join the group first: the runtime and the session depend on this
        # process's place.
        self.dist = self._dist_info()
        if session is None and self.dist.is_leader:
            session = _default_session()
        self.session = session  # a follower opens none
        self.running = True
        # Set by request_drain (SIGTERM): stop leasing, finish the in-flight
        # task, release the unstarted remainder of the lease, flush, exit.
        self.draining = False
        a = self.config.agent
        self.rate = RateLimiter(a.error_log_every_sec)
        self.obs = MetricsRegistry()  # its snapshot rides every lease
        self.recorder = FlightRecorder()
        # Closed spans wait here for the next result post or lease.
        self.tracer = SpanBuffer()
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
        self.m_duty = self.obs.gauge(
            "device_duty_cycle",
            "Rolling duty cycle: device-busy seconds inside the last "
            f"{int(DUTY_WINDOW_SEC)}s window / window span")
        self.m_flops = self.obs.counter(
            "device_flops_total",
            "Analytic model FLOPs dispatched, per op and shape bucket "
            "(matmul terms only — the ops' own estimate)", ("op", "shape"))
        self.m_mfu = self.obs.gauge(
            "device_mfu",
            "Model FLOPs utilization per op: analytic FLOPs / device-busy "
            "seconds / peak dense-bf16 FLOP/s (absent when the peak is "
            "unknown — PEAK_TFLOPS overrides)", ("op",))
        self.m_hbm = self.obs.gauge(
            "device_hbm_bytes",
            "Per-card device memory (allocator used/peak, card total), across "
            "every card the runtime owns (absent on the CPU)", ("device", "kind"))
        self.m_failover = self.obs.counter(
            "controller_failovers_total",
            "Active-controller rotations after transport errors "
            "(CONTROLLER_URLS failover list)")
        self.m_post_fail = self.obs.counter(
            "result_post_failures_total",
            "Result posts that failed (then spooled, or dropped if permanent)", ("op",))
        self.m_redeliveries = self.obs.counter(
            "result_redeliveries_total",
            "Spooled-result redelivery outcomes (delivered/dropped_permanent/"
            "dropped_overflow/expired)", ("outcome",))
        self.m_spool_depth = self.obs.gauge(
            "result_spool_depth", "Completed results awaiting redelivery")
        self.m_launches = self.obs.gauge(
            "kernel_launches",
            "Hand-written CUDA kernel launches since the process started, per "
            "kernel (the wrappers' LAUNCH_COUNTS; 0 on the CPU)", ("kernel",))
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
        # The failover candidates, primary first; a transport error rotates
        # the active index (sticky on success), for the lease loop and the
        # poster alike.
        urls = list(a.controller_urls) or [a.controller_url]
        if a.controller_url not in urls:
            urls.insert(0, a.controller_url)
        self._controller_urls = urls
        self._url_index = 0
        # Unknown or disabled op names fail here, not mid-lease.
        self.handlers: Dict[str, OpFn] = load_ops(list(a.tasks))
        if runtime is None and DEVICE_OPS & set(self.handlers):
            from agent_tpu_torch.runtime.runtime import get_runtime

            # cuda:0 (or CHIP_SLICE's card), a CPU runtime for TPU_DISABLED,
            # else a RuntimeError without CUDA.
            runtime = get_runtime(self.config.device)
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
        # Utilization: the rolling duty window and each op's busy seconds
        # and FLOPs for the MFU gauge; the device thread alone touches them.
        self._duty = RollingWindow(DUTY_WINDOW_SEC)
        self._busy_by_op: Dict[str, float] = {}
        self._flops_by_op: Dict[str, float] = {}
        self._peak_flops: Optional[float] = None
        self._usage_chips: Optional[float] = None
        # SLO page alerts: the objectives whose page episode this agent has
        # dumped its recorder for (once an episode; a cleared one re-arms).
        self._page_dumped: set = set()
        self.slo_dump_paths: List[str] = []
        # Profile captures: requests from lease alerts, waiting for their
        # op's next execute, and completion records waiting for a lease.
        self._pending_captures: List[Dict[str, Any]] = []
        self._captures_seen: set = set()
        self._capture_done: List[Dict[str, Any]] = []
        self.profiled_tasks = 0  # PROFILE_DIR traces written
        self._last_broadcast = time.monotonic()  # the leader's, for the keep-alive

    # ---- controller I/O ----

    def active_controller_url(self) -> str:
        """The controller currently targeted (rotates on transport errors)."""
        urls = self._controller_urls
        return urls[self._url_index % len(urls)]

    def _note_transport_error(self, url: str) -> None:
        """Rotate to the next failover candidate. Only the thread whose URL
        is still the active one advances it, so concurrent errors rotate
        once; a success leaves the index where it landed."""
        urls = self._controller_urls
        if len(urls) < 2:
            return
        if urls[self._url_index % len(urls)] == url:
            self._url_index = (self._url_index + 1) % len(urls)
            self.m_failover.inc()
            self.recorder.record("controller_failover", failed=url,
                                 active=urls[self._url_index])
            log("controller unreachable — failing over", failed=url,
                active=urls[self._url_index])

    def _post_json(self, path: str, body: Dict[str, Any],
                   session: Any = None) -> Tuple[int, Any]:
        """POST JSON -> (status, parsed body). Status 0 = transport error;
        a body that is not JSON comes back as text. ``session`` overrides
        the agent's (the poster thread brings its own)."""
        base = self.active_controller_url()
        try:
            resp = (session or self.session).post(
                f"{base}{path}", json=body, timeout=self.config.agent.http_timeout_sec)
        except Exception as exc:  # noqa: BLE001 — any transport failure
            self._note_transport_error(base)
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

            self._profile = build_worker_profile(self.config.sizing, self.config.device)
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
        wire offer, the chip slice and, once a runtime exists, its platform
        and size."""
        caps: Dict[str, Any] = {"ops": sorted(self.handlers), "queue_depth": self._staged_depth()}
        if self.config.agent.wire_binary:
            caps["wire_formats"] = list(wire.FORMATS)
        if self.config.device.chip_slice:
            caps["chip_slice"] = self.config.device.chip_slice
        if self.runtime is not None:
            caps["device_kind"] = self.runtime.platform
            caps["mesh_devices"] = self.runtime.n_devices
        return caps

    def note_device_time(self, op: str, seconds: float,
                         tags: Optional[Dict[str, Any]] = None) -> None:
        """After every execute on the device thread: the busy counter, the
        rolling duty cycle, the FLOPs counter and MFU gauge from the op's
        ``ctx.tags["device_attr"]``, and the task's usage stamp, whose
        ``device_s`` is the very float the busy counter adds (``tags`` None:
        no stamp, as for a serving step shared by several jobs)."""
        seconds = max(0.0, seconds)
        self.m_device_busy.inc(seconds, op=op)
        self._duty.add(seconds)
        self.m_duty.set(round(self._duty.fraction(), 4))
        self._busy_by_op[op] = self._busy_by_op.get(op, 0.0) + seconds
        task_flops = 0.0
        attr = (tags or {}).get("device_attr")
        if isinstance(attr, dict):
            flops = attr.get("flops")
            if isinstance(flops, (int, float)) and flops > 0:
                task_flops = float(flops)
                self.m_flops.inc(task_flops, op=op, shape=str(attr.get("shape", "?")))
                self._flops_by_op[op] = self._flops_by_op.get(op, 0.0) + task_flops
        if self._usage_chips is None:
            # A device second spans every card of the mesh; 1 without a runtime.
            self._usage_chips = float(self.runtime.n_devices) if self.runtime is not None \
                else 1.0
        stamp_usage(tags, device_s=seconds, chips=self._usage_chips, flops=task_flops or None)
        if self._peak_flops is None:
            self._peak_flops = resolve_peak_flops(self.runtime)
        busy = self._busy_by_op[op]
        flops_total = self._flops_by_op.get(op, 0.0)
        if self._peak_flops and busy > 0 and flops_total > 0:
            self.m_mfu.set(round(flops_total / busy / self._peak_flops, 6), op=op)

    def note_alerts(self, alerts: Any) -> None:
        """React to the alerts on a granted lease: a ``profile_capture``
        arms one capture of the next matching execute (deduped by id); an
        objective entering ``page`` dumps this agent's flight recorder,
        once per objective per episode (one that clears re-arms)."""
        active: set = set()
        for a in alerts or []:
            if not isinstance(a, dict):
                continue
            if a.get("kind") == "profile_capture":
                cid = a.get("capture_id")
                if isinstance(cid, str) and cid and cid not in self._captures_seen:
                    self._captures_seen.add(cid)
                    self._pending_captures.append({"capture_id": cid, "op": a.get("op"),
                                                   "duration_ms": a.get("duration_ms")})
                continue
            if a.get("state") != "page":
                continue
            objective = a.get("objective")
            if not objective:
                continue
            active.add(objective)
            if objective in self._page_dumped:
                continue
            self._page_dumped.add(objective)
            bits = "-".join(f"{k}{a[k]}" for k in ("tier", "tenant", "op") if a.get(k)) or "all"
            path = default_dump_path(
                f"agent-{self.config.agent.agent_name}-slo-{objective}-{bits}")
            self.recorder.record("slo_page", objective=objective, path=path,
                                 **{k: a[k] for k in ("tier", "tenant", "op") if a.get(k)})
            try:
                n = self.recorder.dump(path)
                self.slo_dump_paths.append(path)
                log("slo page — agent flight recorder dumped", objective=objective,
                    path=path, events=n)
            except OSError:
                pass  # a failing dump must not stop the drain
        self._page_dumped &= active

    def _refresh_hbm_gauges(self) -> None:
        """``device_hbm_bytes{device,kind}`` over every card the runtime
        owns, refreshed at snapshot time; a CPU runtime exports nothing."""
        if self.runtime is None:
            return
        try:
            for entry in device_memory_stats(self.runtime.devices):
                for kind in KINDS:
                    if kind in entry:
                        self.m_hbm.set(entry[kind], device=entry["device"], kind=kind)
        except Exception:  # noqa: BLE001 — telemetry must never kill a lease
            pass

    def _metrics(self) -> Dict[str, Any]:
        m = collect_host_metrics()
        # The duty decays while idle: a quiet agent reads 0, not its last
        # busy moment.
        self.m_duty.set(round(self._duty.fraction(), 4))
        self._refresh_hbm_gauges()
        kernels = sys.modules.get("agent_tpu_torch.kernels.flash_attention")
        if kernels is not None:  # imported by a model op: never imported here
            for name, n in kernels.LAUNCH_COUNTS.items():
                self.m_launches.set(n, kernel=name)
        if self.runtime is not None:
            try:
                m["device"] = self.runtime.describe()
            except Exception:  # noqa: BLE001 — telemetry must never kill a lease
                pass
        m["obs"] = self.obs.snapshot()
        return m

    def _piggyback(self, metrics: Dict[str, Any]) -> Tuple[list, list]:
        """Move the pending spans and capture completions into a lease's
        ``metrics``; the caller requeues them when the post fails."""
        spans = self.tracer.drain()
        if spans:
            metrics["spans"] = spans
        captures, self._capture_done = self._capture_done, []
        if captures:
            metrics["profile_captures"] = captures
        return spans, captures

    def _requeue(self, spans: list, captures: list) -> None:
        if spans:
            self.tracer.requeue(spans)
        if captures:
            self._capture_done = captures + self._capture_done

    def push_metrics(self, session: Any = None) -> bool:
        """Metrics-only lease poll (``max_tasks=0``) after the last result,
        so the final counters, spans and capture records reach the
        controller; best-effort."""
        spans: list = []
        captures: list = []
        try:
            a = self.config.agent
            metrics = self._metrics()
            spans, captures = self._piggyback(metrics)
            body: Dict[str, Any] = {
                "agent": a.agent_name,
                "capabilities": {"ops": [], "queue_depth": self._staged_depth()},
                "max_tasks": 0,
                "labels": a.labels,
                "metrics": metrics,
            }
            if self.draining:
                body["draining"] = True  # the retiring agent's half of the handshake
            status, _ = self._post_json("/v1/leases", body, session=session)
        except Exception:  # noqa: BLE001 — a flush must never fail a drain
            status = STATUS_TRANSPORT_ERROR
        if status not in (200, 204):
            self._requeue(spans, captures)
        return status in (200, 204)

    def record_phase_timings(self, op: str, timings: Optional[Dict[str, Any]],
                             keys: Optional[Tuple[str, ...]] = None,
                             trace_id: Optional[str] = None) -> None:
        """ctx.tags["timings"] (milliseconds) -> ``task_phase_seconds``.
        ``keys`` restricts which timing keys count: the pipelined runner
        measures stage/execute/finalize itself and takes only queue/fetch
        from the op's timings. ``trace_id`` (the job id) rides as the
        exemplar."""
        exemplar = {"trace_id": trace_id} if trace_id and obs_trace.enabled() else None
        for key, phase in PHASE_KEYS:
            if keys is not None and key not in keys:
                continue
            v = (timings or {}).get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.m_phase.observe(float(v) / 1000.0, exemplar=exemplar, op=op, phase=phase)

    # ---- spans ----

    @staticmethod
    def task_trace(task: Any) -> Tuple[Optional[str], Optional[str]]:
        """``(trace_id, parent_span_id)`` from the controller's trace
        context on the task; ``(None, None)`` without one (the agent then
        records no span for it)."""
        if isinstance(task, dict) and isinstance(task.get("trace"), dict):
            t = task["trace"]
            tid, sid = t.get("trace_id"), t.get("span_id")
            if isinstance(tid, str) and tid:
                return tid, sid if isinstance(sid, str) and sid else None
        return None, None

    def _process_name(self) -> str:
        return f"agent:{self.config.agent.agent_name}"

    def trace_span(self, name: str, trace_id: Optional[str], parent_span_id: Optional[str],
                   start_mono: float, duration_s: float, span_id: Optional[str] = None,
                   **attributes: Any) -> None:
        """Buffer one closed span; nothing without a trace id or with
        tracing off."""
        if not trace_id or not obs_trace.enabled():
            return
        self.tracer.add(make_span(
            name, trace_id, parent_span_id, start_mono=start_mono, duration_s=duration_s,
            span_id=span_id, process=self._process_name(),
            attributes={k: v for k, v in attributes.items() if v is not None}))

    def trace_context(self, trace_id: Optional[str], job_id: str,
                      exec_span_id: str) -> TraceContext:
        """The ambient context set around an op's execute."""
        return TraceContext(trace_id=trace_id or job_id, parent_span_id=exec_span_id,
                            tracer=self.tracer, registry=self.obs,
                            process=self._process_name())

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
        metrics = self._metrics()
        spans, captures = self._piggyback(metrics)
        hint = self.lease_batch_hint
        max_tasks = a.max_tasks if hint is None else max(a.max_tasks, int(hint))
        status, body = self._post_json("/v1/leases", {
            "agent": a.agent_name,
            "capabilities": self.capabilities(),
            "max_tasks": max_tasks,
            "timeout_ms": a.lease_timeout_ms,
            "labels": a.labels,
            "worker_profile": self.worker_profile(),
            "metrics": metrics,
        })
        if status not in (200, 204):
            self._requeue(spans, captures)
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
        self.note_alerts(body.get("alerts"))
        self.m_lease.inc(outcome="tasks")
        self.recorder.record("lease", lease_id=lease_id, n_tasks=len(tasks),
                             job_ids=[t.get("id") for t in tasks if isinstance(t, dict)])
        return lease_id, tasks

    def post_result(self, lease_id: str, job_id: str, job_epoch: Any, status: str,
                    result: Any = None, error: Any = None, session: Any = None,
                    op: str = "?") -> bool:
        """Post one result, with the pending spans; a transient failure
        spools it for redelivery and requeues the spans, a permanent one
        (the controller rejected the request itself) is counted and
        dropped."""
        body = {
            "lease_id": lease_id,
            "job_id": job_id,
            "job_epoch": job_epoch,
            "status": status,
            "result": result,
            "error": error,
        }
        # The spans ride the post but never the spool: a failed batch is
        # requeued and ships with the next post or lease.
        spans = self.tracer.drain()
        if spans:
            body["spans"] = spans
        http_status, resp = self._post_json("/v1/results", body, session=session)
        if http_status in (200, 204):
            return True
        self._requeue(spans, [])
        self.m_post_fail.inc(op=op)
        failure_class = classify_http(http_status)
        self.recorder.record("result_post_failed", job_id=job_id, op=op, lease_id=lease_id,
                             status=http_status, **{"class": failure_class})
        self.rate.log("result", "post failed", status=http_status,
                      failure_class=failure_class, body=str(resp)[:200])
        if failure_class == PERMANENT:
            return False
        evicted = self.spool.put(lease_id, job_id, job_epoch, status,
                                 result=result, error=error, op=op)
        if evicted is not None:
            self.m_redeliveries.inc(outcome="dropped_overflow")
            self.recorder.record("spool_overflow", job_id=evicted.get("job_id"),
                                 op=evicted.get("op"))
        self.m_spool_depth.set(len(self.spool))
        return False

    def release_job(self, lease_id: str, job_id: str, job_epoch: Any, op: str = "?",
                    session: Any = None) -> bool:
        """Hand one unstarted leased task back (``status="released"``): the
        job is leasable again at once, without burning an attempt."""
        self.m_tasks.inc(op=op, status="released")
        self.recorder.record("task_released", job_id=job_id, op=op, lease_id=lease_id)
        return self.post_result(lease_id, job_id, job_epoch, "released", op=op,
                                session=session)

    def release_task(self, lease_id: str, task: Any, session: Any = None) -> bool:
        """:meth:`release_job` from a raw task dict."""
        if not isinstance(task, dict):
            return False
        job_id = task.get("id", task.get("job_id"))
        if not isinstance(job_id, str) or not job_id:
            return False
        op = task.get("op") if isinstance(task.get("op"), str) else "?"
        return self.release_job(lease_id, job_id, task.get("job_epoch"), op=op, session=session)

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
                entry = self.spool.pop_head()
                self.m_redeliveries.inc(outcome="expired")
                self.recorder.record("spool_expired", job_id=(entry or {}).get("job_id"),
                                     op=(entry or {}).get("op"))
                continue
            entry = self.spool.head()
            t_try = time.perf_counter()
            status, _ = self._post_json("/v1/results", ResultSpool.wire_body(entry),
                                        session=session)
            if status in (200, 204):
                self.spool.pop_head()
                delivered += 1
                self.m_redeliveries.inc(outcome="delivered")
                self.recorder.record("result_redelivered", job_id=entry.get("job_id"),
                                     op=entry.get("op"))
                self._trace_redelivery(entry, t_try, "delivered")
                self._spool_retry.reset()
                self._spool_next_try = 0.0
            elif classify_http(status) == PERMANENT:
                self.spool.pop_head()
                self.m_redeliveries.inc(outcome="dropped_permanent")
                self.recorder.record("spool_dropped_permanent", job_id=entry.get("job_id"),
                                     op=entry.get("op"), status=status)
                self._trace_redelivery(entry, t_try, "dropped_permanent")
            else:
                self._spool_next_try = time.monotonic() + self._spool_retry.next_backoff()
                break
        self.m_spool_depth.set(len(self.spool))
        return delivered

    def _trace_redelivery(self, entry: Dict[str, Any], t_start: float, outcome: str) -> None:
        """A span for one spool redelivery, parented to the job's lease span
        when the spooled result carried the trace context."""
        job_id = entry.get("job_id")
        if not isinstance(job_id, str) or not job_id:
            return
        parent = None
        res = entry.get("result")
        if isinstance(res, dict) and isinstance(res.get("trace"), dict):
            sid = res["trace"].get("span_id")
            parent = sid if isinstance(sid, str) and sid else None
        self.trace_span("result.redeliver", job_id, parent, start_mono=t_start,
                        duration_s=time.perf_counter() - t_start, op=entry.get("op"),
                        outcome=outcome)

    # ---- profile captures ----

    def _take_capture(self, op: str) -> Optional[Dict[str, Any]]:
        """Pop the first pending capture for ``op`` (one without an op takes
        the next task of any op)."""
        for i, cap in enumerate(self._pending_captures):
            want = cap.get("op")
            if not want or want == op:
                return self._pending_captures.pop(i)
        return None

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.runtime is not None and self.runtime.platform == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def _profiled(self, op: str, thunk: Any, trace_path: str) -> Tuple[Any, Optional[str]]:
        """``thunk()`` inside a torch.profiler session whose Chrome trace is
        written to ``trace_path`` -> ``(result, None)``, or ``(result,
        reason)`` when the profiler did not start or the trace was not
        written: diagnostics never fail the task they observe, and the op's
        own exception is never masked by the profiler's."""
        from torch.profiler import record_function

        try:
            if _profiler_active():
                raise RuntimeError("a torch.profiler session is already recording")
            prof = self._profiler()
            prof.start()
        except Exception as exc:  # noqa: BLE001
            return thunk(), f"profiler did not start: {exc}"[:300]
        try:
            with record_function(f"op:{op}"):
                out = thunk()
        finally:
            try:
                prof.stop()
            except Exception:  # noqa: BLE001 — the export below reports it
                pass
        try:
            prof.export_chrome_trace(trace_path)
        except Exception as exc:  # noqa: BLE001
            return out, f"trace export failed: {exc}"[:300]
        return out, None

    def _captured_call(self, op: str, thunk: Any, cap: Dict[str, Any]) -> Any:
        """One on-demand capture: this execute under torch.profiler, its
        Chrome trace (``trace.json``) in a per-capture artifact directory
        (``$PROFILE_CAPTURE_DIR/capture-<id>``, else a temp dir), and the
        completion record queued for the next lease's metrics. A capture
        that cannot be taken gives an ``error`` record and the plain
        result."""
        import tempfile

        cid = cap.get("capture_id")
        record: Dict[str, Any] = {"capture_id": cid, "agent": self.config.agent.agent_name,
                                  "op": op, "status": "done"}
        try:
            base = os.environ.get("PROFILE_CAPTURE_DIR", "").strip()
            if base:
                artifact = os.path.join(base, f"capture-{cid}")
                os.makedirs(artifact, exist_ok=True)
            else:
                artifact = tempfile.mkdtemp(prefix=f"agent_tpu_torch_capture_{cid}_")
        except OSError as exc:
            record.update(status="error", error=str(exc)[:300])
            self._capture_done.append(record)
            return thunk()
        t0 = time.perf_counter()
        try:
            out, reason = self._profiled(op, thunk, os.path.join(artifact, "trace.json"))
            if reason:
                record.update(status="error", error=reason)
            return out
        except Exception:
            record["status"] = "op_failed"  # the op raised; its trace is kept
            raise
        finally:
            dt_ms = round((time.perf_counter() - t0) * 1e3, 3)
            n_files = sum(len(files) for _, _, files in os.walk(artifact))
            record.update(artifact=artifact, actual_duration_ms=dt_ms,
                          summary={"op": op, "n_trace_files": n_files, "duration_ms": dt_ms})
            self._capture_done.append(record)
            self.recorder.record("profile_capture", capture_id=cid, op=op, artifact=artifact,
                                 status=record["status"])
            log("deep capture complete", op=op, artifact=artifact, capture_id=cid)

    def profiled_call(self, op: str, thunk: Any) -> Any:
        """Run ``thunk`` (an op's execute): under a pending capture for this
        op, or, with ``PROFILE_DIR`` set, under torch.profiler for the first
        ``PROFILE_TASKS`` tasks (one Chrome trace each), else plainly. Shared
        by the serial loop and the pipeline's device thread."""
        if self._pending_captures:
            cap = self._take_capture(op)
            if cap is not None:
                return self._captured_call(op, thunk, cap)
        dev = self.config.device
        if dev.profile_dir and self.profiled_tasks < dev.profile_tasks:
            self.profiled_tasks += 1
            path = os.path.join(dev.profile_dir, f"trace-{self.config.agent.agent_name}-"
                                                 f"{os.getpid()}-{self.profiled_tasks}-{op}.json")
            try:
                os.makedirs(dev.profile_dir, exist_ok=True)
            except OSError as exc:
                self.rate.log("profile", "PROFILE_DIR not writable", error=str(exc))
                return thunk()
            out, reason = self._profiled(op, thunk, path)
            if reason:
                self.rate.log("profile", "no trace", path=path, reason=reason)
            return out
        return thunk()

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

    def task_context(self, task: Dict[str, Any], job_id: str, lease_id: str):
        """The task's ``OpContext``: the runtime, the trace tags the result
        carries (the attempt; ``span_id``, the controller's lease span, and
        ``tenant`` when the controller stamped them on the task), and the
        negotiated wire format finalize reads."""
        from agent_tpu_torch.runtime.context import OpContext

        trace: Dict[str, Any] = {"job_id": job_id, "attempt": task.get("attempt"),
                                 "lease_id": lease_id}
        tenant = task.get("tenant")
        if isinstance(tenant, str) and tenant:
            trace["tenant"] = tenant
        _, span_parent = self.task_trace(task)
        if span_parent:
            trace["span_id"] = span_parent
        tags: Dict[str, Any] = {"job_id": job_id, "trace": trace}
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
        """Stamp the loop's fields into an op's result dict: the ``usage``
        block too, which the reference controller's showback ledger bills."""
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
        attempt = task.get("attempt") if isinstance(task, dict) else None
        trace_id, span_parent = self.task_trace(task)
        if resolve_error is not None:
            if job_id is not None:
                self.m_tasks.inc(op=op, status="failed")
                self.recorder.record("task", job_id=job_id, op=op, status="failed",
                                     lease_id=lease_id, attempt=attempt,
                                     error_type=resolve_error.get("type"))
                self.post_result(lease_id, job_id, epoch, "failed", error=resolve_error, op=op)
            return
        ctx = self.task_context(task, job_id, lease_id)
        # Minted before the call, so spans recorded inside the op can parent
        # to the execute span.
        exec_span_id = new_span_id()
        t_exec0 = time.perf_counter()
        try:
            # Several processes: the followers run the same op in lockstep,
            # so the leader publishes the task before it runs it.
            self._broadcast_to_followers(op, payload)
            t_exec0 = time.perf_counter()
            # The serial loop's "stage": resolving (and broadcasting) the
            # task before the call.
            self.trace_span("stage", trace_id, span_parent, start_mono=t0,
                            duration_s=t_exec0 - t0, op=op)
            stamp_usage(ctx.tags, host_s=t_exec0 - t0)
            with use_context(self.trace_context(trace_id, job_id, exec_span_id)):
                result = self.profiled_call(op, lambda: fn(payload, ctx))
            status, error = "succeeded", None
        except Exception as exc:  # noqa: BLE001 — every op error -> failed result
            result, status, error = None, "failed", structured_error(exc)
            self.rate.log("exec", "op raised", op=op, type=type(exc).__name__)
            if self.dist.process_count > 1:
                # The followers that raised the same way crash; a leader
                # that moved on would enter the next broadcast against dead
                # or desynchronised peers and hang there. Post the failure,
                # then crash with them: the slice restarts clean.
                self.post_result(lease_id, job_id, epoch, status, result=None, error=error,
                                 op=op)
                raise
        t_done = time.perf_counter()
        self.trace_span("execute", trace_id, span_parent, span_id=exec_span_id,
                        start_mono=t_exec0, duration_s=t_done - t_exec0, op=op, status=status)
        self.note_device_time(op, t_done - t_exec0, ctx.tags)
        duration_ms = (t_done - t0) * 1000.0
        self.finish_result(result, ctx, duration_ms)
        t_post0 = time.perf_counter()
        self.post_result(lease_id, job_id, epoch, status, result=result, error=error, op=op)
        # Recorded after the post (a span cannot ship itself): it rides the
        # next post or the final metrics flush.
        self.trace_span("post", trace_id, span_parent, start_mono=t_post0,
                        duration_s=time.perf_counter() - t_post0, op=op, status=status)
        self.tasks_done += 1
        self.m_tasks.inc(op=op, status=status)
        self.record_phase_timings(op, ctx.tags.get("timings"), trace_id=job_id)
        self.recorder.record("task", job_id=job_id, op=op, status=status, lease_id=lease_id,
                             attempt=attempt, duration_ms=round(duration_ms, 3),
                             error_type=(error or {}).get("type") if error else None)
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
            self._keepalive()
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
        """A follower's loop on a process other than the leader; else the
        pipelined runner when ``PIPELINE_DEPTH`` > 0 (one process, no step
        limit), else the serial loop; either ends when ``running`` flips."""
        info = self.dist
        if not info.is_leader:
            self.run_follower()
            return
        if max_steps is None and info.process_count == 1 \
                and self.config.agent.pipeline_depth > 0:
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
        # A clean exit only: after an op raised, the followers are gone or
        # desynchronised, and the shutdown broadcast is itself a collective.
        if info.process_count > 1:
            from agent_tpu_torch.runtime.distributed import broadcast_shutdown

            broadcast_shutdown()

    # ---- several processes: leader and followers ----

    def _dist_info(self):
        """This process's place; without ``COORDINATOR_ADDRESS`` nothing of
        ``torch.distributed`` is touched."""
        from agent_tpu_torch.runtime.distributed import DistInfo, maybe_initialize

        cfg = self.config.device
        if cfg.coordinator_address is None:
            return DistInfo(process_index=0, process_count=1)
        return maybe_initialize(cfg.coordinator_address, cfg.num_processes, cfg.process_id)

    def _broadcast_to_followers(self, op: str, payload: Dict[str, Any]) -> None:
        if self.dist.process_count == 1:
            return
        from agent_tpu_torch.runtime.distributed import broadcast_task

        broadcast_task({"op": op, "payload": payload})
        self._last_broadcast = time.monotonic()

    def _keepalive(self) -> None:
        """An idle leader's sign of life to its followers, well inside the
        group's timeout (``distributed.KEEPALIVE_SEC``)."""
        if self.dist.process_count == 1:
            return
        from agent_tpu_torch.runtime import distributed

        if time.monotonic() - self._last_broadcast >= distributed.KEEPALIVE_SEC:
            distributed.broadcast_keepalive()
            self._last_broadcast = time.monotonic()

    def run_follower(self) -> None:
        """A follower: run every task the leader broadcasts, in lockstep,
        and drop the results (the leader posts them); leave on the
        leader's shutdown. A drain op's ``source_uri`` must be readable on
        every process."""
        from agent_tpu_torch.runtime.distributed import broadcast_task, is_keepalive, is_shutdown

        log("follower up", process=self.dist.process_index)
        while self.running:
            task = broadcast_task(None)
            if is_keepalive(task):
                continue
            if task is None or is_shutdown(task):
                break
            fn = self.handlers.get(task.get("op"))
            if fn is None:
                # The leader broadcasts only ops it resolved, and it is
                # already running this one: skipping it would leave the
                # slice waiting in different collectives.
                raise RuntimeError(
                    f"follower has no handler for broadcast op {task.get('op')!r}: TASKS "
                    f"must be identical on every process of a slice (have "
                    f"{sorted(self.handlers)})")
            try:
                fn(task.get("payload") or {}, self.task_context(task, "follower", None))
            except Exception as exc:  # noqa: BLE001 — re-raised below
                # Moving on would put this process in the next broadcast
                # while the leader waits elsewhere: crash instead, and the
                # leader, raising the same way, posts the failure.
                log("follower op raised — crashing to avoid a slice hang",
                    op=task.get("op"), type=type(exc).__name__, error=str(exc)[:200])
                raise
            self.tasks_done += 1
        log("follower drained", tasks_done=self.tasks_done)

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
    except (RuntimeError, ValueError) as exc:
        # A device op without a CUDA device (the port never runs it on the
        # CPU unasked), or a device knob the port refuses.
        print(f"[agent-tpu-torch] cannot start: {exc}", flush=True)
        return 1
    signal.signal(signal.SIGINT, agent.shutdown)
    signal.signal(signal.SIGTERM, agent.shutdown)
    # SIGUSR1 dumps the flight recorder on demand; a fatal error dumps it
    # before the process dies.
    from agent_tpu_torch.obs.recorder import install_sigusr1_dump

    dump_path = default_dump_path(f"agent-{config.agent.agent_name}")
    if install_sigusr1_dump(agent.recorder, dump_path):
        log("flight recorder armed", signal="SIGUSR1", path=dump_path)
    log("agent up", agent=config.agent.agent_name, controller=agent.active_controller_url(),
        ops=sorted(agent.handlers),
        device=None if agent.runtime is None else str(agent.runtime.device))
    try:
        agent.run()
    except BaseException:
        try:
            n = agent.recorder.dump(dump_path)
            log("fatal error — flight recorder dumped", path=dump_path, events=n)
        except OSError:
            pass
        raise
    log("agent drained", tasks_done=agent.tasks_done)
    return 0


if __name__ == "__main__":
    sys.exit(main())
