"""Elastic fleet autoscaler — the loop that *changes fleet size under load*;
the port's counterpart of ``agent_tpu.autoscale``. Its process fleet
launches the port's members (``python -m agent_tpu_torch.agent.fleet``) on
``fleet.PLATFORMS`` (``cpu`` or ``cuda``); a ``cuda`` member that cannot
see its card fails, it never falls back to the CPU.

The control plane can already crash agents (chaos), judge the fleet
(``GET /v1/health``), and bill it (``/v1/usage``) — this module closes the
loop: it consumes the signal vector health already exports (queue depth and
per-tier pressure, starvation age, SLO burn states, per-agent duty cycle,
staleness) and spawns or retires fleet members to match the offered load.

Design:

- **Signals, not bespoke probes.** :func:`read_signals` is a pure projection
  of the ``/v1/health`` body (in-process ``Controller.health_json()`` or an
  HTTP scrape — the autoscaler cannot tell the difference).
- **Hysteresis + cooldown, never flap.** Scale-up triggers on queue pressure
  per live agent, SLO burn with work queued, or starvation age; scale-down
  requires ``down_idle_evals`` *consecutive* idle judgments (queue empty and
  every live agent's duty cycle under ``down_max_duty``) and honors separate
  up/down cooldowns. Capacity *replacement* after a reclaim (live < min, or
  live below the last desired size because a member died) bypasses the up
  cooldown — repairing a spot reclaim is not a scaling decision.
- **Graceful retirement.** Scale-down retires members through the drain
  protocol (``Agent.request_drain`` / SIGTERM): the member stops asking for
  work, finishes or releases its in-flight lease, flushes its spool and
  final metrics (the lease poll carries ``draining: true`` so
  ``/v1/status`` marks it), then exits. The scheduler never places on it
  again because a draining member never asks — the pull protocol is the
  fence.
- **Pluggable actuation.** A :class:`FleetDriver` owns member lifecycles:
  :class:`ProcessFleetDriver` spawns real pinned agent processes via
  ``agent/fleet.py``; :class:`ThreadFleetDriver` runs in-process ``Agent``
  loops for deterministic soaks and tests (the reference's ``scripts/elastic_soak.py``).

Observability (the new ``autoscale_*`` / ``fleet_size`` families): desired
vs actual vs draining member counts, every decision with its reason, and
scale-event counters — wired into whatever registry the caller passes
(the soak passes the controller's, so ``/v1/metrics`` serves them).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from agent_tpu_torch.config import AutoscaleConfig
from agent_tpu_torch.obs.metrics import MetricsRegistry
from agent_tpu_torch.utils.logging import log

# Decision actions (the `action` label of autoscale_decisions_total).
UP = "up"
DOWN = "down"
HOLD = "hold"
REPLACE = "replace"


@dataclass(frozen=True)
class Signals:
    """The autoscaler's view of one ``/v1/health`` body."""

    queue_depth: int = 0
    starvation_age_sec: Optional[float] = None
    # True when any SLO objective is in warn/page (burning budget).
    slo_burning: bool = False
    verdict: str = "ok"
    # Live = polled recently AND not draining; duty cycles are the live
    # members' rolling device_duty_cycle gauges (None = no data yet).
    live_agents: int = 0
    draining_agents: int = 0
    max_duty: Optional[float] = None
    # Non-terminal job count (pending + leased): the "work still exists"
    # signal that keeps scale-down honest while leases are in flight.
    active_jobs: int = 0
    healthy: bool = True


def read_signals(health: Optional[Dict[str, Any]]) -> Signals:
    """Project a ``/v1/health`` body into :class:`Signals`. ``None`` (an
    unreachable controller) yields ``healthy=False`` — the loop holds
    rather than acting blind."""
    if not isinstance(health, dict):
        return Signals(healthy=False)
    queue = health.get("queue") or {}
    slo = health.get("slo") or {}
    burning = any(
        obj.get("state") in ("warn", "page")
        for obj in slo.get("objectives") or []
    )
    live = 0
    draining = 0
    duties: List[float] = []
    for row in (health.get("agents") or {}).values():
        if row.get("draining"):
            draining += 1
            continue
        if row.get("stale"):
            continue
        live += 1
        duty = row.get("duty_cycle")
        if isinstance(duty, (int, float)):
            duties.append(float(duty))
    counts = health.get("counts") or {}
    active = int(counts.get("pending", 0)) + int(counts.get("leased", 0))
    return Signals(
        queue_depth=int(queue.get("depth") or 0),
        starvation_age_sec=queue.get("starvation_age_sec"),
        slo_burning=burning,
        verdict=str(health.get("verdict", "ok")),
        live_agents=live,
        draining_agents=draining,
        max_duty=max(duties) if duties else None,
        active_jobs=active,
        healthy=True,
    )


@dataclass(frozen=True)
class Decision:
    action: str
    n: int = 0
    reason: str = ""


class FleetDriver:
    """Actuation interface: member lifecycles. ``size()`` counts live
    (non-retired) members — the capacity the controller can lease to;
    ``spawn(n)`` adds members; ``retire(n)`` gracefully drains the
    driver's choice of ``n`` members and returns their names."""

    def size(self) -> int:
        raise NotImplementedError

    def spawn(self, n: int) -> List[str]:
        raise NotImplementedError

    def retire(self, n: int) -> List[str]:
        raise NotImplementedError


class Autoscaler:
    """The control loop. ``health_fn`` returns a ``/v1/health`` body (dict)
    or None; ``driver`` actuates. One ``step()`` = read → decide → act;
    ``run()`` loops until the stop event fires."""

    def __init__(
        self,
        driver: FleetDriver,
        health_fn: Callable[[], Optional[Dict[str, Any]]],
        config: Optional[AutoscaleConfig] = None,
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.driver = driver
        self.health_fn = health_fn
        self.config = config or AutoscaleConfig()
        self._clock = clock
        self._idle_evals = 0
        self._last_up = float("-inf")
        self._last_scale = float("-inf")  # either direction (down cooldown)
        # The size the last decision wanted — live members below it mean a
        # member died (reclaim) and replacement is repair, not scaling.
        self.desired = max(self.config.min_agents, 0)
        self.scale_ups = 0
        self.scale_downs = 0
        self.replacements = 0
        m = registry if registry is not None else MetricsRegistry()
        self.metrics = m
        self._g_size = m.gauge(
            "fleet_size",
            "Elastic fleet membership by state "
            "(desired/actual/draining)", ("state",))
        self._m_decisions = m.counter(
            "autoscale_decisions_total",
            "Autoscaler decisions by action and reason",
            ("action", "reason"))
        self._m_events = m.counter(
            "autoscale_scale_events_total",
            "Members actually added/retired", ("direction",))
        self._g_size.set(self.desired, state="desired")

    # ---- decision (pure given Signals + internal hysteresis state) ----

    def decide(self, sig: Signals, now: Optional[float] = None) -> Decision:
        cfg = self.config
        if now is None:
            now = self._clock()
        if not sig.healthy:
            self._idle_evals = 0
            return Decision(HOLD, reason="health_unreachable")
        actual = self.driver.size()
        # Repair before policy: capacity the controller believes in but the
        # driver lost (spot reclaim, hard kill, crashed member) comes back
        # immediately — a reclaim must never silently shrink the fleet
        # below what the load earned.
        floor = max(cfg.min_agents, min(self.desired, cfg.max_agents))
        if actual < floor:
            self._idle_evals = 0
            return Decision(
                REPLACE, n=floor - actual,
                reason="below_min" if actual < cfg.min_agents
                else "capacity_lost",
            )
        pressure = sig.queue_depth / max(1, actual)
        starving = (
            sig.starvation_age_sec is not None
            and sig.starvation_age_sec > cfg.up_starvation_sec
        )
        want_up = (
            pressure > cfg.up_queue_per_agent
            or (sig.slo_burning and sig.queue_depth > 0)
            or starving
        )
        if want_up:
            self._idle_evals = 0
            if actual >= cfg.max_agents:
                return Decision(HOLD, reason="at_max")
            if now - self._last_up < cfg.up_cooldown_sec:
                return Decision(HOLD, reason="up_cooldown")
            reason = (
                "queue_pressure" if pressure > cfg.up_queue_per_agent
                else ("slo_burn" if sig.slo_burning else "starvation")
            )
            n = min(cfg.step_up, cfg.max_agents - actual)
            return Decision(UP, n=n, reason=reason)
        idle = (
            sig.queue_depth == 0
            and sig.active_jobs == 0
            and (sig.max_duty is None or sig.max_duty < cfg.down_max_duty)
        )
        if not idle:
            self._idle_evals = 0
            return Decision(HOLD, reason="busy")
        self._idle_evals += 1
        if actual <= cfg.min_agents:
            return Decision(HOLD, reason="at_min")
        if self._idle_evals < cfg.down_idle_evals:
            return Decision(HOLD, reason="idle_confirming")
        if now - self._last_scale < cfg.down_cooldown_sec:
            return Decision(HOLD, reason="down_cooldown")
        n = min(cfg.step_down, actual - cfg.min_agents)
        return Decision(DOWN, n=n, reason="idle")

    # ---- actuation ----

    def apply(self, decision: Decision, now: Optional[float] = None) -> None:
        if now is None:
            now = self._clock()
        self._m_decisions.inc(action=decision.action, reason=decision.reason)
        if decision.action in (UP, REPLACE) and decision.n > 0:
            names = self.driver.spawn(decision.n)
            self._m_events.inc(len(names), direction="up")
            if decision.action == UP:
                self.scale_ups += 1
                self._last_up = now
                self._last_scale = now
                self.desired = min(
                    self.config.max_agents, self.driver.size()
                )
            else:
                self.replacements += 1
            log(
                "autoscale: spawned members", n=len(names),
                reason=decision.reason, fleet=self.driver.size(),
            )
        elif decision.action == DOWN and decision.n > 0:
            names = self.driver.retire(decision.n)
            self._m_events.inc(len(names), direction="down")
            self.scale_downs += 1
            self._last_scale = now
            self._idle_evals = 0
            self.desired = max(self.config.min_agents, self.driver.size())
            log(
                "autoscale: retired members", names=names,
                reason=decision.reason, fleet=self.driver.size(),
            )

    def step(self) -> Decision:
        sig = read_signals(self.health_fn())
        now = self._clock()
        decision = self.decide(sig, now)
        self.apply(decision, now)
        self._g_size.set(self.desired, state="desired")
        self._g_size.set(self.driver.size(), state="actual")
        self._g_size.set(sig.draining_agents, state="draining")
        return decision

    def run(
        self,
        stop: threading.Event,
        interval_sec: Optional[float] = None,
    ) -> None:
        interval = (
            self.config.interval_sec if interval_sec is None
            else max(0.05, float(interval_sec))
        )
        while not stop.wait(interval):
            try:
                self.step()
            except Exception as exc:  # noqa: BLE001 — the loop must outlive
                # one bad evaluation; a dead autoscaler strands the fleet.
                log("autoscale step failed", error=str(exc)[:200])


# ---- drivers ----

class ThreadFleetDriver(FleetDriver):
    """In-process members: each ``spawn`` builds an ``Agent`` via
    ``agent_factory(name)`` and runs its real loop on a daemon thread;
    ``retire`` requests the drain path (``Agent.request_drain``) and joins.
    The deterministic actuation the elastic soak and tests use — same drain
    code the SIGTERM handler runs, no processes to babysit.

    ``kill(name)`` is the hard-preemption hook (chaos ``hard_kill``): the
    member's transport is severed and its loop stopped WITHOUT the drain
    path — in-flight work is lost and must be recovered by lease-TTL expiry
    + epoch fencing, exactly like a SIGKILLed process."""

    def __init__(
        self,
        agent_factory: Callable[[str], Any],
        name_prefix: str = "elastic",
        join_timeout_sec: float = 30.0,
    ) -> None:
        self.agent_factory = agent_factory
        self.name_prefix = name_prefix
        self.join_timeout_sec = join_timeout_sec
        self._lock = threading.Lock()
        self._members: Dict[str, Dict[str, Any]] = {}
        self.retired: List[Dict[str, Any]] = []
        self.killed: List[str] = []
        self._seq = 0

    def size(self) -> int:
        with self._lock:
            return len(self._members)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._members)

    def agent(self, name: str) -> Optional[Any]:
        with self._lock:
            entry = self._members.get(name)
        return entry["agent"] if entry else None

    def spawn(self, n: int) -> List[str]:
        names = []
        for _ in range(max(0, n)):
            with self._lock:
                self._seq += 1
                name = f"{self.name_prefix}-{self._seq}"
            agent = self.agent_factory(name)
            thread = threading.Thread(
                target=agent.run, name=f"member-{name}", daemon=True
            )
            with self._lock:
                self._members[name] = {"agent": agent, "thread": thread}
            thread.start()
            names.append(name)
        return names

    def retire(self, n: int) -> List[str]:
        """Gracefully drain the ``n`` newest members (LIFO keeps the
        longest-lived — warmest — members serving)."""
        with self._lock:
            victims = list(self._members)[-max(0, n):] if n > 0 else []
        return [name for name in victims if self.retire_member(name)]

    def retire_member(self, name: str) -> bool:
        with self._lock:
            entry = self._members.pop(name, None)
        if entry is None:
            return False
        agent, thread = entry["agent"], entry["thread"]
        agent.request_drain(reason="autoscale_retire")
        thread.join(timeout=self.join_timeout_sec)
        self.retired.append({
            "name": name,
            "agent": agent,
            "clean_exit": not thread.is_alive(),
            "spool_len": len(agent.spool),
        })
        return True

    def kill(self, name: str) -> bool:
        """Hard preemption: sever transport, stop the loop, no drain."""
        with self._lock:
            entry = self._members.pop(name, None)
        if entry is None:
            return False
        agent, thread = entry["agent"], entry["thread"]
        from agent_tpu_torch.chaos import GatedSession

        dead = GatedSession(agent.session)
        dead.down = True
        agent.session = dead
        agent.running = False
        thread.join(timeout=self.join_timeout_sec)
        self.killed.append(name)
        return True


class ProcessFleetDriver(FleetDriver):
    """Real pinned agent processes via ``agent/fleet.py``: ``spawn`` launches
    ``python -m agent_tpu_torch.agent.fleet`` children with unique names against
    ``controller_url``; ``retire`` sends SIGTERM — the agent's handler runs
    the same drain path as autoscaler retirement (finish/release the
    in-flight lease, flush spool + final metrics, exit 0) — and a later
    ``reap()`` collects the exit. Device slices come from a bounded pool of
    ``max_agents`` disjoint ``CHIP_SLICE`` assignments, recycled on exit.
    ``history`` keeps each member's lifecycle (``time.monotonic`` of its
    spawn, SIGTERM and reaped exit, and its return code), which the
    reference's driver does not record."""

    def __init__(
        self,
        controller_url: str,
        tasks: str,
        max_agents: int = 4,
        devices_per_agent: int = 1,
        platform: str = "cpu",
        name_prefix: str = "elastic",
        extra_env: Optional[Dict[str, str]] = None,
        log_dir: Optional[str] = None,
    ) -> None:
        self.controller_url = controller_url
        self.tasks = tasks
        self.max_agents = max(1, max_agents)
        self.devices_per_agent = max(1, devices_per_agent)
        self.platform = platform
        self.name_prefix = name_prefix
        self.extra_env = dict(extra_env or {})
        self.log_dir = log_dir
        self._lock = threading.Lock()
        self._members: Dict[str, Dict[str, Any]] = {}
        self._draining: Dict[str, Dict[str, Any]] = {}
        self._free_slots = list(range(self.max_agents))
        self.retired: List[str] = []
        self.history: Dict[str, Dict[str, Any]] = {}

    def size(self) -> int:
        self.reap()
        with self._lock:
            return len(self._members)

    def spawn(self, n: int) -> List[str]:
        import subprocess
        import sys

        from agent_tpu_torch.agent.fleet import agent_env

        names: List[str] = []
        for _ in range(max(0, n)):
            with self._lock:
                if not self._free_slots:
                    break
                slot = self._free_slots.pop(0)
            name = f"{self.name_prefix}-{uuid.uuid4().hex[:6]}"
            env = agent_env(
                slot, self.max_agents, self.devices_per_agent,
                controller_url=self.controller_url, tasks=self.tasks,
                platform=self.platform, name_prefix=self.name_prefix,
                extra_env=self.extra_env,
            )
            env["AGENT_NAME"] = name
            out: Any = None
            if self.log_dir:
                import os

                os.makedirs(self.log_dir, exist_ok=True)
                out = open(
                    os.path.join(self.log_dir, f"{name}.log"), "ab"
                )
            proc = subprocess.Popen(
                [sys.executable, "-m", "agent_tpu_torch.agent.fleet"],
                env=env, stdout=out,
                stderr=subprocess.STDOUT if out else None,
                close_fds=True,
            )
            if out is not None:
                out.close()
            with self._lock:
                self._members[name] = {"proc": proc, "slot": slot}
                self.history[name] = {"spawned": time.monotonic()}
            names.append(name)
        return names

    def retire(self, n: int) -> List[str]:
        with self._lock:
            victims = list(self._members)[-max(0, n):] if n > 0 else []
            moved = {}
            for name in victims:
                moved[name] = self._members.pop(name)
                self._draining[name] = moved[name]
        for name, entry in moved.items():
            try:
                entry["proc"].terminate()  # SIGTERM → the agent drain path
            except OSError:
                pass
            entry["since"] = time.monotonic()
            self.history[name]["retired"] = entry["since"]
        return list(moved)

    def reap(self, kill_after_sec: float = 60.0) -> None:
        """Collect exited members (crashed live ones free their slot so
        replacement can land; drained ones finish retirement), escalating
        to SIGKILL past ``kill_after_sec`` of drain."""
        now = time.monotonic()
        with self._lock:
            for name in list(self._members):
                if self._members[name]["proc"].poll() is not None:
                    entry = self._members.pop(name)
                    self._free_slots.append(entry["slot"])
                    self._note_exit(name, entry)
            for name in list(self._draining):
                entry = self._draining[name]
                if entry["proc"].poll() is not None:
                    self._draining.pop(name)
                    self._free_slots.append(entry["slot"])
                    self.retired.append(name)
                    self._note_exit(name, entry)
                elif now - entry.get("since", now) > kill_after_sec:
                    try:
                        entry["proc"].kill()
                    except OSError:
                        pass

    def _note_exit(self, name: str, entry: Dict[str, Any]) -> None:
        self.history[name].update(exited=time.monotonic(),
                                  rc=entry["proc"].returncode)

    def stop_all(self, timeout: float = 30.0) -> None:
        with self._lock:
            entries = list(self._members.items()) + list(
                self._draining.items()
            )
            self._members.clear()
            self._draining.clear()
        for name, entry in entries:
            try:
                entry["proc"].terminate()
            except OSError:
                pass
            self.history[name].setdefault("retired", time.monotonic())
        deadline = time.monotonic() + timeout
        for name, entry in entries:
            try:
                entry["proc"].wait(
                    timeout=max(0.1, deadline - time.monotonic())
                )
            except Exception:  # noqa: BLE001
                try:
                    entry["proc"].kill()
                    entry["proc"].wait()
                except OSError:
                    pass
            self._note_exit(name, entry)


def main(argv: Optional[List[str]] = None) -> int:
    """Operator CLI: ``python -m agent_tpu_torch.autoscale --controller URL
    --tasks op1,op2`` — scales a process fleet against a live controller's
    ``/v1/health`` with the AUTOSCALE_* env knobs."""
    import argparse

    from agent_tpu_torch.agent.fleet import PLATFORMS
    from agent_tpu_torch.obs.scrape import fetch_health

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--controller", required=True)
    ap.add_argument("--tasks", required=True,
                    help="TASKS for spawned members (comma-separated ops)")
    ap.add_argument("--platform", default="cpu", choices=PLATFORMS)
    ap.add_argument("--devices-per-agent", type=int, default=1)
    ap.add_argument("--log-dir", default="")
    args = ap.parse_args(argv)

    cfg = AutoscaleConfig.from_env()
    driver = ProcessFleetDriver(
        args.controller, args.tasks, max_agents=cfg.max_agents,
        devices_per_agent=args.devices_per_agent, platform=args.platform,
        log_dir=args.log_dir or None,
    )
    scaler = Autoscaler(
        driver, lambda: fetch_health(args.controller), config=cfg
    )
    stop = threading.Event()
    import signal

    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    log(
        "autoscaler up", controller=args.controller,
        min=cfg.min_agents, max=cfg.max_agents,
        interval_sec=cfg.interval_sec,
    )
    try:
        scaler.run(stop)
    finally:
        driver.stop_all()
    log(
        "autoscaler stopped", scale_ups=scaler.scale_ups,
        scale_downs=scaler.scale_downs, replacements=scaler.replacements,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
