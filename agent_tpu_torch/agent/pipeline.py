"""Pipelined drain — counterpart of ``agent_tpu.agent.pipeline``: host-side
double buffering around the device loop.

The serial loop pays, per task, lease RTT -> CSV read + tokenize/pad ->
device compute -> serialize + result RTT on one thread, so the device idles
while the host stages and posts. This runner overlaps them:

- **staging pool** (``data/staging.py``): a feeder thread owns the lease
  loop and N autotuned workers run op ``stage`` phases (pure host) into a
  bounded queue of depth ``pipeline_depth`` — the backpressure that keeps
  staging about one shard ahead of the device;
- **device (calling) thread**: pops staged work and runs the op's
  ``execute`` phase; every device dispatch stays on this one thread. With
  ``FEED_DOUBLE_BUFFER`` (default on) it first *pre-feeds* the next staged
  item: ``runtime.put_batch`` queues its host-to-device copies, and the op's
  own ``put_batch`` later passes the placed tensors through;
- **poster thread**: runs ``finalize`` and posts the result over its own
  session. The model ops' execute queues their result's copy to the host
  and records an event after it (``runtime.HostCopy``), so finalize waits
  for that shard's copy alone, not for the next shard the device thread has
  already queued. The bounded post queue caps how many such shards are in
  flight.

Ops advertise phases as attributes on their registered handler
(``fn.stage/.execute/.finalize``); ops without them run whole on the device
thread, so the pipeline is safe for every op. Results may post out of task
order; the protocol keys them by ``job_id``.

Continuous serving: an op with serving hooks (``serve_admit``,
``serve_pump``, ``serve_done``, ``serve_collect``: ``serve_summarize``,
``serve_decode``) is admitted to its decode engine instead of executed
whole, and the device loop interleaves one engine step a pass with the
other staged work. While decode is in flight the loop never blocks on the
staged queue; several jobs sharing one engine get one pump a pass; and
in-flight serving work keeps pumping through shutdown until it has posted.

Spans come from the runner's own clocks, no second one: ``stage`` (a pool
worker), ``queue`` (staged until the device thread took it), ``execute``
(the device thread's dispatch, or a serving item's admit to its last
step) and ``post`` (finalize and the result post), each parented to the
controller's lease span; the execute runs under ``use_context`` and
``agent.profiled_call``. Every execute feeds ``agent.note_device_time``
with the task's tags (its usage stamp); an engine step shared by several
serving jobs is charged once, to the first job's op, with no stamp. The
flight recorder gets each phase transition and error.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from agent_tpu_torch.obs.trace import new_span_id, use_context
from agent_tpu_torch.obs.usage import stamp_usage
from agent_tpu_torch.utils.errors import structured_error
from agent_tpu_torch.utils.logging import log


@dataclass
class _Item:
    """One leased task moving through the pipeline."""

    lease_id: str
    job_id: str
    epoch: Any
    op: str
    payload: Dict[str, Any]
    ctx: Any
    t_start: float
    fn: Any = None
    staged: Any = None            # op state between stage and execute
    executed: Any = None          # op state between execute and finalize
    result: Any = None            # terminal result (skips later phases)
    status: str = "succeeded"
    error: Any = None
    monolithic: bool = False      # op has no phase hooks
    # The task's trace context (the lease span is the phases' parent) and
    # the end of staging, where the queue span starts.
    trace_id: Any = None
    span_parent: Any = None
    t_staged: float = 0.0
    # Continuous serving: the engine handle while this item's requests ride
    # the running batch, and the admit instant its execute time counts from.
    serve_handle: Any = None
    t_serve0: float = 0.0


_STOP = object()

# How long a shutting-down device thread keeps waiting for the poster to free
# a post-queue slot before giving up (wedged-poster escape; see _put_post).
SHUTDOWN_GRACE_SEC = 30.0


class PipelineRunner:
    """Owns the staging pool and the poster thread around the caller's
    device loop. ``run()`` blocks until ``agent.running`` flips false, then
    drains both queues so no staged task is dropped."""

    def __init__(self, agent, depth: int = 2) -> None:
        from agent_tpu_torch.data.staging import StagingPool

        self.agent = agent
        self.depth = max(1, depth)
        self.staged_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        # Bounded like staged_q: every queued item holds a shard's device
        # result, so this bound caps the device memory in flight.
        self.post_q: "queue.Queue" = queue.Queue(maxsize=self.depth + 1)
        self.pool = StagingPool(agent, self.staged_q, self._stage_one, _STOP,
                                base_depth=self.depth)
        self.double_buffer = agent.config.agent.feed_double_buffer
        agent.staged_depth_fn = self.pool.backlog
        self.tasks_posted = 0
        self._peeked: Any = None
        self._poster = threading.Thread(target=self._post_loop, name="agent-poster",
                                        daemon=True)

    # ---- staging (the pool's worker threads) ----

    def _stage_one(self, lease_id: str, task: Any) -> Optional[_Item]:
        agent = self.agent
        t0 = time.perf_counter()
        job_id, op, payload, epoch, fn, resolve_error = agent.resolve_task(task)
        attempt = task.get("attempt") if isinstance(task, dict) else None
        trace_id, span_parent = agent.task_trace(task)
        if resolve_error is not None:
            if job_id is None:
                return None
            return _Item(lease_id, job_id, epoch, op, {}, None, t0, status="failed",
                         error=resolve_error, trace_id=trace_id, span_parent=span_parent)
        item = _Item(lease_id, job_id, epoch, op, payload,
                     agent.task_context(task, job_id, lease_id), t0, fn=fn,
                     trace_id=trace_id, span_parent=span_parent)
        stage = getattr(fn, "stage", None)
        if stage is None:
            item.monolithic = True
            item.t_staged = time.perf_counter()
            return item
        try:
            phase, value = stage(payload, item.ctx)
        except Exception as exc:  # noqa: BLE001 — same contract as run_task
            item.status = "failed"
            item.error = structured_error(exc)
            agent.rate.log("exec", "stage raised", op=op, type=type(exc).__name__)
            agent.recorder.record("error", phase="stage", job_id=job_id, op=op,
                                  lease_id=lease_id, attempt=attempt,
                                  type=type(exc).__name__, message=str(exc)[:200])
            return item
        item.t_staged = time.perf_counter()
        agent.m_phase.observe(item.t_staged - t0, exemplar={"trace_id": job_id},
                              op=op, phase="stage")
        stamp_usage(item.ctx.tags, host_s=item.t_staged - t0)
        agent.trace_span("stage", trace_id, span_parent, start_mono=t0,
                         duration_s=item.t_staged - t0, op=op)
        agent.recorder.record("phase", phase="staged", job_id=job_id, op=op,
                              lease_id=lease_id, attempt=attempt)
        if phase == "done":
            item.result = value
        else:
            item.staged = value
        return item

    # ---- device (calling) thread ----

    def _put_post(self, item: Any) -> bool:
        """Blocking put into the bounded post queue (the backpressure that
        caps in-flight shards). Escapes: a dead poster, or a shutdown whose
        poster has stopped draining for SHUTDOWN_GRACE_SEC."""
        waited = 0.0
        while True:
            try:
                self.post_q.put(item, timeout=0.5)
                self.agent.m_queue.set(self.post_q.qsize(), queue="post")
                return True
            except queue.Full:
                if not self._poster.is_alive():
                    return False  # the lease TTL re-queues the task
                if self.agent.running:
                    waited = 0.0
                    continue
                waited += 0.5
                if waited >= SHUTDOWN_GRACE_SEC:
                    return False

    def _prefeed(self, item: Any) -> None:
        """Queue the NEXT item's host-to-device copies before the current
        item's execute. Only the staged-chunk layout ``state["chunks"] =
        [(ids, lengths, n), ...]`` of numpy arrays is pre-fed; anything else
        is left alone. Purely an optimization: it never fails an item."""
        runtime = self.agent.runtime
        if (runtime is None or item.monolithic or item.staged is None
                or item.result is not None or item.status == "failed"):
            return
        state = item.staged
        chunks = state.get("chunks") if isinstance(state, dict) else None
        if not isinstance(chunks, list):
            return
        try:
            fed = []
            for chunk in chunks:
                if (isinstance(chunk, (tuple, list)) and len(chunk) == 3
                        and isinstance(chunk[0], np.ndarray)
                        and isinstance(chunk[1], np.ndarray)):
                    fed.append((runtime.put_batch(chunk[0]), runtime.put_batch(chunk[1]),
                                chunk[2]))
                else:
                    fed.append(chunk)
            state["chunks"] = fed
        except Exception:  # noqa: BLE001 — the op puts the batch itself anyway
            pass

    def _serve_admit(self, item: Any, serving: list) -> None:
        """Join a serving item's requests to its continuous decode engine:
        the prefill runs now, on this (the device) thread; the decode steps
        run in :meth:`_serve_pump_once`, between everything else the loop
        does."""
        agent = self.agent
        t0 = time.perf_counter()
        item.t_serve0 = t0
        try:
            item.serve_handle = item.fn.serve_admit(item.staged, item.ctx)
        except Exception as exc:  # noqa: BLE001 — op error -> failed
            item.status = "failed"
            item.error = structured_error(exc)
            agent.rate.log("exec", "serve admit raised", op=item.op, type=type(exc).__name__)
            agent.recorder.record("error", phase="execute", job_id=item.job_id, op=item.op,
                                  lease_id=item.lease_id, type=type(exc).__name__,
                                  message=str(exc)[:200])
            self._put_post(item)
            return
        # The prefill is this job's device time; the decode steps bill per
        # pump.
        agent.note_device_time(item.op, time.perf_counter() - t0,
                               item.ctx.tags if item.ctx is not None else None)
        agent.recorder.record("phase", phase="serve_admitted", job_id=item.job_id, op=item.op,
                              lease_id=item.lease_id)
        serving.append(item)

    def _serve_pump_once(self, serving: list) -> None:
        """One step of every distinct engine with items in flight (jobs
        sharing an engine advance together on one pump), then post the
        items whose requests have all finished."""
        agent = self.agent
        engines: Dict[int, Any] = {}
        for item in serving:
            engines.setdefault(id(item.serve_handle["engine"]), item)
        t0 = time.perf_counter()
        occupancy = 0
        for item in engines.values():
            occupancy = max(occupancy, item.fn.serve_pump(item.serve_handle))
        if engines:
            # One dispatch advanced every item on it: charged once, to the
            # first item's op, with no job's usage stamp.
            agent.note_device_time(next(iter(engines.values())).op, time.perf_counter() - t0,
                                   None)
            agent.m_serve_occupancy.set(occupancy)
        for item in [it for it in serving if it.fn.serve_done(it.serve_handle)]:
            serving.remove(item)
            try:
                item.executed = item.fn.serve_collect(item.serve_handle)
            except Exception as exc:  # noqa: BLE001
                item.status = "failed"
                item.error = structured_error(exc)
                agent.recorder.record("error", phase="execute", job_id=item.job_id,
                                      op=item.op, lease_id=item.lease_id,
                                      type=type(exc).__name__, message=str(exc)[:200])
            item.serve_handle = None
            dt = time.perf_counter() - item.t_serve0
            agent.m_phase.observe(dt, exemplar={"trace_id": item.job_id}, op=item.op,
                                  phase="execute")
            agent.trace_span("execute", item.trace_id, item.span_parent,
                             start_mono=item.t_serve0, duration_s=dt, op=item.op,
                             status=item.status)
            agent.recorder.record("phase", phase="executed", job_id=item.job_id, op=item.op,
                                  lease_id=item.lease_id, status=item.status)
            self._put_post(item)
        if not serving:
            agent.m_serve_occupancy.set(0)

    def _execute_loop(self) -> None:
        agent = self.agent
        pending: Any = None
        # Serving items riding a decode engine: the loop runs one engine
        # step a pass beside the other staged work, so decode keeps
        # stepping while shards stage and new serving jobs join between
        # steps.
        serving: list = []
        stopping = False
        try:
            while True:
                item = None
                if pending is not None:
                    item, pending = pending, None
                elif not stopping:
                    if serving:
                        # Decode in flight: never block on the queue; an
                        # empty poll makes this pass pure decode.
                        try:
                            item = self.staged_q.get_nowait()
                        except queue.Empty:
                            item = None
                    else:
                        # Time blocked here is device idle; time inside the
                        # op dispatch is device busy.
                        t_wait = time.perf_counter()
                        item = self.staged_q.get()
                        agent.m_device_idle.inc(time.perf_counter() - t_wait)
                if item is _STOP:
                    # Keep pumping until the serving work in flight has
                    # posted: a leased request answers even through shutdown.
                    stopping = True
                    item = None
                if item is not None:
                    self._execute_item(item, serving)
                    pending, self._peeked = self._peeked, None
                if serving:
                    self._serve_pump_once(serving)
                if stopping and not serving and pending is None:
                    break
        finally:
            self._put_post(_STOP)

    def _execute_item(self, item: Any, serving: list) -> None:
        agent = self.agent
        agent.m_queue.set(self.staged_q.qsize(), queue="staged")
        if item.result is not None or item.status == "failed":
            self._put_post(item)
            return
        if getattr(item.fn, "serve_admit", None) is not None and not item.monolithic:
            self._serve_admit(item, serving)
            return
        if self.double_buffer:
            # Peek ahead: take the next staged item (if any) and queue its
            # copies now; the loop consumes it next, so it is never lost.
            try:
                peeked = self.staged_q.get_nowait()
            except queue.Empty:
                peeked = None
            if peeked is not None and peeked is not _STOP:
                self._prefeed(peeked)
            self._peeked = peeked
        t_exec = time.perf_counter()
        if item.t_staged:
            # Staged until this thread took it: the backpressure gap.
            agent.trace_span("queue", item.trace_id, item.span_parent,
                             start_mono=item.t_staged, duration_s=t_exec - item.t_staged,
                             op=item.op)
        exec_span_id = new_span_id()
        try:
            with use_context(agent.trace_context(item.trace_id, item.job_id, exec_span_id)):
                if item.monolithic:
                    item.result = agent.profiled_call(
                        item.op, lambda i=item: i.fn(i.payload, i.ctx))
                else:
                    item.executed = agent.profiled_call(
                        item.op, lambda i=item: i.fn.execute(i.staged, i.ctx))
        except Exception as exc:  # noqa: BLE001 — op error -> failed
            item.status = "failed"
            item.error = structured_error(exc)
            agent.rate.log("exec", "op raised", op=item.op, type=type(exc).__name__)
            agent.recorder.record("error", phase="execute", job_id=item.job_id, op=item.op,
                                  lease_id=item.lease_id, type=type(exc).__name__,
                                  message=str(exc)[:200])
        dt = time.perf_counter() - t_exec
        agent.note_device_time(item.op, dt, item.ctx.tags if item.ctx is not None else None)
        agent.m_phase.observe(dt, exemplar={"trace_id": item.job_id}, op=item.op,
                              phase="execute")
        agent.trace_span("execute", item.trace_id, item.span_parent, span_id=exec_span_id,
                         start_mono=t_exec, duration_s=dt, op=item.op, status=item.status)
        agent.recorder.record("phase", phase="executed", job_id=item.job_id, op=item.op,
                              lease_id=item.lease_id, status=item.status)
        self._put_post(item)

    # ---- poster thread ----

    def _post_loop(self) -> None:
        from agent_tpu_torch.agent.app import _default_session

        agent = self.agent
        factory = agent.post_session_factory
        session = factory() if factory is not None else _default_session()
        while True:
            item = self.post_q.get()
            if item is _STOP:
                # One last redelivery pass past the backoff window.
                agent.flush_spool(session=session, force=True)
                break
            agent.m_queue.set(self.post_q.qsize(), queue="post")
            t_fin = time.perf_counter()
            try:
                if item.executed is not None:
                    item.result = item.fn.finalize(item.executed, item.ctx)
            except Exception as exc:  # noqa: BLE001
                item.status = "failed"
                item.error = structured_error(exc)
                item.result = None
                agent.recorder.record("error", phase="finalize", job_id=item.job_id,
                                      op=item.op, lease_id=item.lease_id,
                                      type=type(exc).__name__, message=str(exc)[:200])
            finalize_s = time.perf_counter() - t_fin
            agent.m_phase.observe(finalize_s, exemplar={"trace_id": item.job_id},
                                  op=item.op, phase="finalize")
            if item.ctx is not None:
                # The poster's host seconds join the stage's.
                stamp_usage(item.ctx.tags, host_s=finalize_s)
                timings = item.ctx.tags.setdefault("timings", {})
                timings["finalize_ms"] = round(finalize_s * 1000.0, 3)
                # stage/execute/finalize were measured by the runner's
                # threads; queue and fetch come from the op's own timings.
                agent.record_phase_timings(item.op, timings, keys=("queue_ms", "fetch_ms"),
                                           trace_id=item.job_id)
            duration_ms = (time.perf_counter() - item.t_start) * 1000.0
            agent.finish_result(item.result, item.ctx, duration_ms)
            agent.post_result(item.lease_id, item.job_id, item.epoch, item.status,
                              result=item.result, error=item.error, session=session,
                              op=item.op)
            # Finalize (with the device-to-host wait) and the post as one
            # span; it ships with the next post or the final flush.
            agent.trace_span("post", item.trace_id, item.span_parent, start_mono=t_fin,
                             duration_s=time.perf_counter() - t_fin, op=item.op,
                             status=item.status, finalize_ms=round(finalize_s * 1e3, 3))
            agent.flush_spool(session=session)
            self.tasks_posted += 1
            agent.tasks_done += 1
            agent.m_tasks.inc(op=item.op, status=item.status)
            agent.recorder.record("phase", phase="posted", job_id=item.job_id, op=item.op,
                                  lease_id=item.lease_id, status=item.status,
                                  duration_ms=round(duration_ms, 3))
            agent.note_progress(queues={"staged_q": self.staged_q.qsize(),
                                        "post_q": self.post_q.qsize()})

    # ---- lifecycle ----

    def run(self) -> None:
        log("pipelined drain up", depth=self.depth, stage_workers=self.pool.max_workers,
            autotune=self.pool.autotune, double_buffer=self.double_buffer)
        self.pool.start()
        self._poster.start()
        try:
            self._execute_loop()  # device work stays on the caller's thread
        finally:
            self.agent.running = False
            self.pool.join(timeout=30)
            # Tasks still queued for staging are handed back when draining.
            self.pool.release_pending()
            self._poster.join(timeout=30)
            self.agent.push_metrics()
        log("pipelined drain stopped", tasks_posted=self.tasks_posted)
