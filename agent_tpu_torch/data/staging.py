"""Parallel autotuned staging pool — the port's copy of
``agent_tpu.data.staging``, with its logic unchanged.

When an op's ``stage()`` (CSV shard read + fused tokenize+pad) costs more
wall clock than its ``execute()`` dispatch, one stager is the pipeline's
limiter and the device idles. This module runs N stage workers concurrently:

- a **feeder** thread owns the lease loop (one thread keeps the lease RTT
  serialized and the grant accounting simple) and fans raw tasks into a
  bounded ``task_q``;
- **worker** threads pull tasks, run the op's ``stage()`` phase (pure host
  by contract — no device state), and push staged items into the runner's
  bounded ``staged_q``;
- an **autotuner** (``STAGE_AUTOTUNE``) re-reads the agent's own metrics
  registry — ``task_phase_seconds{phase=stage}`` vs ``{phase=execute}``,
  the measurements the pipeline already records; no new clock — and sizes
  the *effective* parallelism (an adjustable gate, so threads never need
  respawning) and the prefetch depth to the live stage/execute ratio.

The staging workers run Python and numpy under the interpreter lock, beside
the device thread that issues the card's launches; the autotune's constants
are the reference's and have not been tuned for this port.

Ordering: the feeder enqueues tasks in lease order and a 1-worker pool
preserves it end to end; with N workers staged items may reorder, which the
protocol explicitly permits (results key by ``job_id``). Stage itself is a
pure per-task function, so multi-worker output is bit-identical to
single-worker output.

Shutdown: the feeder stops leasing when ``agent.running`` flips, workers
drop undrained tasks (the lease TTL re-queues them, or a draining agent
releases them), and the LAST worker to exit owns delivering the ``_STOP``
sentinel to the device loop — a lost sentinel would leave the device thread
blocked in ``get()`` forever.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time
from typing import Any, Callable, Optional, Tuple

from agent_tpu_torch.utils.logging import log
from agent_tpu_torch.utils.retry import jittered

# Auto worker count: min(4, cpu_count) — staging is numpy/tokenize-bound,
# and the device thread + poster need cores too.
DEFAULT_MAX_WORKERS = 4

# Autotuner cadence: re-reading the registry snapshot is cheap but not free.
RETUNE_INTERVAL_SEC = 1.0
# Minimum fresh per-phase samples before a retune acts — two tasks of noise
# must not thrash the worker gate.
RETUNE_MIN_SAMPLES = 3


def default_workers() -> int:
    return max(1, min(DEFAULT_MAX_WORKERS, os.cpu_count() or 1))


def desired_workers(
    stage_sec: float, exec_sec: float, max_workers: int
) -> int:
    """Workers needed so aggregate staging throughput matches the device:
    ``ceil(stage/execute)``, clamped to [1, max_workers]. A zero/unknown
    execute time with real stage cost means the device is starving —
    saturate; with neither measured, stay at 1."""
    if stage_sec <= 0:
        return 1
    if exec_sec <= 0:
        return max_workers
    return max(1, min(max_workers, math.ceil(stage_sec / exec_sec)))


class AdjustableGate:
    """Counting gate whose permit limit can change at runtime — the
    autotuner's lever. Workers park here instead of being torn down, so a
    limit bump takes effect on the very next task."""

    def __init__(self, limit: int) -> None:
        self._cond = threading.Condition()
        self._limit = max(1, int(limit))
        self._active = 0

    @property
    def limit(self) -> int:
        return self._limit

    def set_limit(self, limit: int) -> None:
        with self._cond:
            self._limit = max(1, int(limit))
            self._cond.notify_all()

    def acquire(self, timeout: float = 0.5) -> bool:
        with self._cond:
            if self._active < self._limit:
                self._active += 1
                return True
            self._cond.wait(timeout)
            if self._active < self._limit:
                self._active += 1
                return True
            return False

    def release(self) -> None:
        with self._cond:
            self._active = max(0, self._active - 1)
            self._cond.notify()


class PhaseRatioSampler:
    """Windowed stage/execute seconds-per-task from the agent's metrics
    registry — the regulator reads the obs the pipeline already records
    (``task_phase_seconds`` sums/counts, all ops), never a second clock."""

    def __init__(self, registry: Any) -> None:
        self._registry = registry
        self._last = {"stage": (0.0, 0), "execute": (0.0, 0)}

    def sample(self) -> Optional[Tuple[float, float]]:
        """→ (stage_sec_per_task, execute_sec_per_task) over the window
        since the previous call, or None when too few new samples landed."""
        try:
            fam = self._registry.snapshot().get("task_phase_seconds") or {}
        except Exception:  # noqa: BLE001 — telemetry must never kill staging
            return None
        totals = {"stage": [0.0, 0], "execute": [0.0, 0]}
        for series in fam.get("series", []):
            phase = (series.get("labels") or {}).get("phase")
            if phase in totals:
                totals[phase][0] += float(series.get("sum", 0.0))
                totals[phase][1] += int(series.get("count", 0))
        out = []
        fresh_ok = True
        for phase in ("stage", "execute"):
            s, c = totals[phase]
            ls, lc = self._last[phase]
            ds, dc = s - ls, c - lc
            if dc < RETUNE_MIN_SAMPLES:
                fresh_ok = False
            out.append(ds / dc if dc > 0 else 0.0)
        if not fresh_ok:
            return None
        self._last = {
            "stage": (totals["stage"][0], totals["stage"][1]),
            "execute": (totals["execute"][0], totals["execute"][1]),
        }
        return out[0], out[1]


class StagingPool:
    """Owns the feeder + worker threads in front of a bounded staged queue.

    ``stage_fn(lease_id, task) -> item | None`` is the runner's per-task
    staging function (``PipelineRunner._stage_one``); ``stop_token`` is the
    sentinel the device loop expects exactly once on ``staged_q``.
    """

    def __init__(
        self,
        agent: Any,
        staged_q: "queue.Queue",
        stage_fn: Callable[[str, Any], Any],
        stop_token: Any,
        base_depth: int = 2,
    ) -> None:
        self.agent = agent
        self.staged_q = staged_q
        self.stage_fn = stage_fn
        self.stop_token = stop_token
        cfg = agent.config.agent
        # STAGE_WORKERS (0 = auto) and STAGE_AUTOTUNE.
        self.max_workers = max(1, cfg.stage_workers or default_workers())
        self.autotune = cfg.stage_autotune
        self.base_depth = max(1, base_depth)
        # Start saturated: until the first retune window closes there is no
        # ratio to regulate from, and idle workers cost nothing.
        self.gate = AdjustableGate(self.max_workers)
        self.task_q: "queue.Queue" = queue.Queue(
            maxsize=max(2, 2 * self.max_workers)
        )
        self._sampler = PhaseRatioSampler(agent.obs)
        self._last_retune = time.monotonic()
        self._alive_lock = threading.Lock()
        self._workers_alive = 0
        self._g_workers = agent.obs.gauge(
            "stage_pool_workers",
            "Staging-pool effective parallelism (autotuned gate limit)")
        self._g_depth = agent.obs.gauge(
            "stage_prefetch_depth",
            "Staged-queue bound (autotuned prefetch depth)")
        self._g_workers.set(self.gate.limit)
        self._g_depth.set(self.staged_q.maxsize)
        self._feeder = threading.Thread(
            target=self._feed_loop, name="agent-feeder", daemon=True
        )
        self._threads = [self._feeder]
        for i in range(self.max_workers):
            self._threads.append(threading.Thread(
                target=self._worker_loop, name=f"agent-stager-{i}",
                daemon=True,
            ))

    # ---- lifecycle ----

    def start(self) -> None:
        self._workers_alive = self.max_workers
        for t in self._threads:
            t.start()

    def join(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))

    def backlog(self) -> int:
        """Leased-but-not-executed depth (staged + awaiting a worker) — the
        load number the lease capabilities advertise."""
        return self.staged_q.qsize() + self.task_q.qsize()

    # ---- feeder thread (lease loop) ----

    def _feed_loop(self) -> None:
        agent = self.agent
        try:
            while agent.running:
                # The grant ask tracks the live gate limit so an autotuned-up
                # pool doesn't starve on 1-task grants (the controller may
                # still shrink the grant — that stays advisory downward).
                agent.lease_batch_hint = self.gate.limit
                self._maybe_retune()
                try:
                    leased = agent.lease_once()
                except RuntimeError as exc:
                    agent.rate.log("lease", str(exc))
                    time.sleep(agent._lease_retry.next_backoff())
                    continue
                agent._lease_retry.reset()
                if leased is None:
                    time.sleep(jittered(agent.config.agent.idle_sleep_sec))
                    continue
                lease_id, tasks = leased
                for task in tasks:
                    if agent.running:
                        self._put_task((lease_id, task))
                    elif getattr(agent, "draining", False):
                        # Drain: hand unstarted tasks back instead of
                        # abandoning them to the lease TTL.
                        agent.release_task(lease_id, task)
        finally:
            # One sentinel per worker, delivered even if the feeder died
            # unexpectedly; the last worker converts them into the device
            # loop's single stop token.
            for _ in range(self.max_workers):
                self._put_task(self.stop_token, force=True)

    def _put_task(self, entry: Any, force: bool = False) -> None:
        while True:
            try:
                self.task_q.put(entry, timeout=0.5)
                return
            except queue.Full:
                if not self.agent.running and not force:
                    self._release_entry(entry)
                    return  # drain aborted; released, or TTL re-queues
                if force and self._workers_alive_count() == 0:
                    return  # nobody left to read the sentinel

    def _workers_alive_count(self) -> int:
        with self._alive_lock:
            return self._workers_alive

    def _release_entry(self, entry: Any) -> None:
        """Hand a dropped ``(lease_id, task)`` back during a graceful drain —
        without this every drop point strands the lease until the TTL. A
        non-draining stop abandons it to the TTL."""
        if entry is self.stop_token or not getattr(
            self.agent, "draining", False
        ):
            return
        try:
            lease_id, task = entry
        except (TypeError, ValueError):
            return
        self.agent.release_task(lease_id, task)

    def release_pending(self) -> int:
        """Drain-release every task still queued for staging after the
        workers exited (a worker that parked at the gate during shutdown
        leaves its queue tail unread). Called by the runner once the pool
        has joined; returns how many were handed back."""
        released = 0
        while True:
            try:
                entry = self.task_q.get_nowait()
            except queue.Empty:
                return released
            if entry is self.stop_token:
                continue
            self._release_entry(entry)
            released += 1

    # ---- worker threads ----

    def _worker_loop(self) -> None:
        agent = self.agent
        try:
            while True:
                try:
                    entry = self.task_q.get(timeout=0.5)
                except queue.Empty:
                    if not agent.running:
                        break
                    continue
                if entry is self.stop_token:
                    break
                lease_id, task = entry
                # The autotuner's lever: workers above the gate limit park
                # here instead of staging, shedding parallelism without
                # tearing threads down.
                dropped = False
                while not self.gate.acquire(timeout=0.5):
                    if not agent.running:
                        self._release_entry(entry)
                        dropped = True  # released, or TTL re-queues
                        break
                if dropped:
                    return
                try:
                    item = self.stage_fn(lease_id, task)
                finally:
                    self.gate.release()
                if item is not None:
                    self._put_staged(item)
        finally:
            last = False
            with self._alive_lock:
                self._workers_alive -= 1
                last = self._workers_alive == 0
            if last:
                # Exactly one stop token for the device loop, from whichever
                # worker dies last (mirrors the single-stager guarantee).
                self.staged_q.put(self.stop_token)

    def _put_staged(self, item: Any) -> None:
        """Blocking put that notices shutdown AND live maxsize changes (the
        autotuner may widen the bound mid-wait; the timeout loop re-reads
        it)."""
        while True:
            try:
                self.staged_q.put(item, timeout=0.5)
                self.agent.m_queue.set(self.staged_q.qsize(), queue="staged")
                return
            except queue.Full:
                if not self.agent.running:
                    if getattr(self.agent, "draining", False):
                        # Staged but never executed: nothing applied, so a
                        # release is correct — the work re-runs elsewhere.
                        self.agent.release_job(
                            item.lease_id, item.job_id, item.epoch,
                            op=item.op,
                        )
                    return  # drain aborted; released, or TTL re-queues

    # ---- autotuner ----

    def _maybe_retune(self) -> None:
        if not self.autotune:
            return
        now = time.monotonic()
        if now - self._last_retune < RETUNE_INTERVAL_SEC:
            return
        self._last_retune = now
        sample = self._sampler.sample()
        if sample is None:
            return
        stage_sec, exec_sec = sample
        want = desired_workers(stage_sec, exec_sec, self.max_workers)
        if want != self.gate.limit:
            log(
                "staging pool retuned",
                workers=want,
                stage_ms=round(stage_sec * 1e3, 2),
                execute_ms=round(exec_sec * 1e3, 2),
            )
            self.gate.set_limit(want)
            self._g_workers.set(want)
        # Prefetch depth rides the worker count: enough slack that every
        # active stager has somewhere to land its item plus one in reserve,
        # never below the configured pipeline depth (queue.Queue reads
        # maxsize under its own mutex on every put, so widening/narrowing
        # here is picked up by the workers' timeout-put loop).
        depth = max(self.base_depth, want + 1)
        if depth != self.staged_q.maxsize:
            self.staged_q.maxsize = depth
            self._g_depth.set(depth)
