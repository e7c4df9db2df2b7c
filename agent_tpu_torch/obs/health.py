"""Fleet health — counterpart of
``agent_tpu.obs.health``. The agent's half: :class:`RollingWindow` turns the device thread's
busy seconds into a rolling duty cycle, and :func:`resolve_peak_flops`
gives the card's peak dense-bf16 FLOP/s, the denominator of the agent's
``device_mfu{op}`` gauge. Both are estimates by design: duty counts the
device thread's wall time inside op execute, MFU the ops' analytic matmul
FLOPs over that time.

The controller's half assembles the ``/v1/health`` verdict:
:func:`agent_health` reads one agent's liveness and utilization from its
pushed snapshot, and :func:`build_health` rolls SLO judgments, queue
pressure, starvation, anomalies and per-agent health into one
machine-readable dict. Verdict: ``page`` iff any SLO objective is paging;
``warn`` when any objective warns, an agent has gone stale while work is
queued, or jobs are queued with no live agent at all; else ``ok``; every
non-ok verdict carries ``reasons``. Pure functions of their inputs.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

# An agent whose last lease poll is older than this is "stale" to the
# verdict (HEALTH_AGENT_STALE_SEC overrides at the controller).
DEFAULT_AGENT_STALE_SEC = 60.0

# Peak dense-bf16 tensor-core FLOP/s (without sparsity) by
# torch.cuda.get_device_name, from NVIDIA's H100 Tensor Core GPU datasheet.
# An unlisted card gives no MFU rather than a guess; PEAK_TFLOPS overrides.
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,  # H100 SXM
    "NVIDIA H100 PCIe": 756.0,
    "NVIDIA H100 NVL": 835.0,
}


def resolve_peak_flops(runtime: Any = None) -> Optional[float]:
    """Peak dense-bf16 FLOP/s of the runtime's card: the ``PEAK_TFLOPS``
    env override first, else the table above by the card's name; None on a
    CPU runtime or an unlisted card (the MFU gauge is then absent)."""
    env = os.environ.get("PEAK_TFLOPS")
    if env:
        try:
            return float(env) * 1e12
        except ValueError:
            pass
    device = getattr(runtime, "device", None)
    if getattr(device, "type", None) != "cuda":
        return None
    try:
        import torch

        name = torch.cuda.get_device_name(device)
    except Exception:  # noqa: BLE001 — telemetry must never raise
        return None
    tf = PEAK_BF16_TFLOPS.get(name)
    return tf * 1e12 if tf else None


class RollingWindow:
    """Busy seconds inside a sliding window: ``add(seconds)`` records one
    busy span ending now, ``fraction()`` is busy seconds inside the window
    over its span (clipped to the window's own lifetime, so a fresh agent
    does not read idle). Spans coalesce per wall second."""

    def __init__(self, window_sec: float = 60.0, clock=None) -> None:
        self.window_sec = max(1e-6, float(window_sec))
        self._clock = clock if clock is not None else time.monotonic
        self._events: "collections.deque" = collections.deque()
        self._born = self._clock()

    def _trim(self, now: float) -> None:
        horizon = now - self.window_sec
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def add(self, seconds: float, now: Optional[float] = None) -> None:
        if seconds <= 0:
            return
        if now is None:
            now = self._clock()
        slot = int(now)
        if self._events and self._events[-1][0] == slot:
            self._events[-1][1] += float(seconds)
        else:
            self._events.append([slot, float(seconds)])
        self._trim(now)

    def total(self, now: Optional[float] = None) -> float:
        if now is None:
            now = self._clock()
        self._trim(now)
        return sum(v for _t, v in self._events)

    def fraction(self, now: Optional[float] = None) -> float:
        if now is None:
            now = self._clock()
        span = min(self.window_sec, max(now - self._born, 1e-6))
        return min(1.0, self.total(now) / span)


def _gauge_value(
    snap: Mapping[str, Any], name: str, **labels: str
) -> Optional[float]:
    fam = snap.get(name)
    if not isinstance(fam, Mapping):
        return None
    for s in fam.get("series", []):
        if all(s.get("labels", {}).get(k) == v for k, v in labels.items()):
            return float(s.get("value", 0.0))
    return None


def _series_by_label(
    snap: Mapping[str, Any], name: str, label: str
) -> Dict[str, float]:
    fam = snap.get(name)
    out: Dict[str, float] = {}
    if not isinstance(fam, Mapping):
        return out
    for s in fam.get("series", []):
        key = s.get("labels", {}).get(label)
        if key is not None:
            out[key] = out.get(key, 0.0) + float(s.get("value", 0.0))
    return out


def agent_health(
    entry: Mapping[str, Any], now_wall: Optional[float] = None
) -> Dict[str, Any]:
    """One agent's health row from its ``controller.agent_metrics`` entry:
    liveness plus the utilization series its obs snapshot carries. The
    rolling ``device_duty_cycle`` gauge is preferred; agents predating it
    degrade to the cumulative busy/(busy+idle) ratio."""
    if now_wall is None:
        now_wall = time.time()
    last_seen = float(entry.get("last_seen_wall", 0.0))
    snap = entry.get("obs") if isinstance(entry.get("obs"), Mapping) else {}
    busy_by_op = _series_by_label(snap, "device_busy_seconds_total", "op")
    busy = sum(busy_by_op.values())
    if not busy_by_op:
        # Older agents exported the counter unlabeled.
        busy = _gauge_value(snap, "device_busy_seconds_total") or 0.0
    idle = _gauge_value(snap, "device_idle_seconds_total") or 0.0
    duty = _gauge_value(snap, "device_duty_cycle")
    if duty is None and busy + idle > 0:
        duty = busy / (busy + idle)
    mfu = _series_by_label(snap, "device_mfu", "op")
    out: Dict[str, Any] = {
        "last_seen_sec_ago": round(max(0.0, now_wall - last_seen), 3),
        # Retiring member: the autoscaler must not count it as
        # live capacity, and operators see the drain in flight.
        "draining": bool(entry.get("draining")),
        "duty_cycle": round(duty, 4) if duty is not None else None,
        "device_busy_s": round(busy, 3),
        "device_busy_s_by_op": {
            op: round(v, 3) for op, v in sorted(busy_by_op.items())
        },
        "mfu": {op: round(v, 4) for op, v in sorted(mfu.items())} or None,
        "queue_depth": _gauge_value(snap, "queue_depth", queue="staged"),
    }
    return out


def build_health(
    *,
    slo_enabled: bool,
    slo_objectives: Sequence[Mapping[str, Any]] = (),
    counts: Optional[Mapping[str, int]] = None,
    queue_depth: int = 0,
    queue_by_tier: Optional[Mapping[int, int]] = None,
    starvation_age_sec: Optional[float] = None,
    agents: Optional[Mapping[str, Mapping[str, Any]]] = None,
    agent_stale_sec: float = DEFAULT_AGENT_STALE_SEC,
    now_wall: Optional[float] = None,
    partition: Optional[str] = None,
    anomalies: Sequence[Mapping[str, Any]] = (),
) -> Dict[str, Any]:
    """Assemble the ``GET /v1/health`` body. Pure: every input is data the
    controller already holds (SLO evaluations, job counts, scheduler depth,
    per-agent telemetry entries)."""
    if now_wall is None:
        now_wall = time.time()
    agents = agents or {}
    agent_rows = {
        name: agent_health(entry, now_wall=now_wall)
        for name, entry in sorted(agents.items())
    }
    stale = [
        name for name, row in agent_rows.items()
        if row["last_seen_sec_ago"] > agent_stale_sec
    ]
    for name, row in agent_rows.items():
        row["stale"] = name in stale

    reasons: List[Dict[str, Any]] = []
    verdict = "ok"
    for obj in slo_objectives:
        state = obj.get("state", "ok")
        if state == "ok":
            continue
        reasons.append({
            "kind": "slo_burn",
            "objective": obj.get("objective"),
            "state": state,
            "burn_rate_short": obj.get("burn_rate_short"),
            "burn_rate_long": obj.get("burn_rate_long"),
        })
        if state == "page":
            verdict = "page"
        elif verdict == "ok":
            verdict = "warn"
    # Confirmed anomaly episodes warn like any other burn
    # signal — robust-baseline detection feeds the same verdict machinery.
    for ev in anomalies:
        reasons.append({
            "kind": "anomaly",
            "watch": ev.get("watch"),
            "value": ev.get("value"),
            "baseline_median": ev.get("baseline_median"),
            "z": ev.get("z"),
            "direction": ev.get("direction"),
            "wall": ev.get("wall"),
        })
        if verdict == "ok":
            verdict = "warn"
    live = [n for n in agent_rows if n not in stale]
    if queue_depth > 0 and agent_rows and not live:
        reasons.append({"kind": "no_live_agents", "queued": queue_depth})
        if verdict == "ok":
            verdict = "warn"
    elif stale and queue_depth > 0:
        reasons.append({"kind": "stale_agents", "agents": stale})
        if verdict == "ok":
            verdict = "warn"

    out = {
        "verdict": verdict,
        "reasons": reasons,
        "generated_at": round(now_wall, 3),
        "slo": {
            "enabled": bool(slo_enabled),
            "objectives": list(slo_objectives),
        },
        "queue": {
            "depth": int(queue_depth),
            "by_tier": {
                str(k): int(v)
                for k, v in sorted((queue_by_tier or {}).items())
            },
            "starvation_age_sec": (
                round(starvation_age_sec, 3)
                if starvation_age_sec is not None else None
            ),
        },
        "counts": dict(counts or {}),
        "fleet": {
            "n_agents": len(agent_rows),
            "n_stale": len(stale),
        },
        "agents": agent_rows,
    }
    if partition:
        # Partitioned control plane: which shard of the control
        # plane produced this verdict — the router's fan-out merge keys on
        # it, and a single-partition reader sees where it is pointed.
        out["partition"] = partition
    return out
