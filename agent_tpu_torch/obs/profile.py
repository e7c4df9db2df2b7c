"""Device memory telemetry — the part of ``agent_tpu.obs.profile`` the agent
uses, read from CUDA's caching allocator instead of jax's
``memory_stats()``: :func:`device_memory_stats` (used, peak and limit of
every card the runtime owns) and :func:`hbm_totals` (their sums and the
per-card list). ``runtime.describe()`` and the agent's
``device_hbm_bytes{device,kind}`` gauges both read through here.

The controller's half: :class:`HostProfiler`, a sampling profiler of the
host process (``sys._current_frames()`` walks aggregated into collapsed
stacks, the ``/v1/profile/host`` flamegraph), and
:class:`CaptureCoordinator`, the bookkeeping of on-demand device captures
(requested, handed to the target agent's next lease as an alert, completed
with the agent's artifact).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Mapping, Optional, Sequence

KINDS = ("used", "limit", "peak")


def device_memory_stats(devices: Sequence[Any]) -> List[Dict[str, Any]]:
    """``[{device, platform, used, peak, limit}, ...]``, one entry per
    distinct CUDA card in ``devices`` (``device`` is its CUDA index). A card
    listed several times, as by an sp ring on one card, counts once. ``used``
    and ``peak`` are the allocator's ``allocated_bytes.all.current`` and
    ``.peak``, ``limit`` the card's total memory (``mem_get_info``). CPU
    devices, and a card whose stats cannot be read, contribute nothing, so
    the empty list is the "no device memory here" answer, never an error."""
    import torch

    out: List[Dict[str, Any]] = []
    seen = set()
    for dev in devices:
        try:
            dev = torch.device(dev)
        except (TypeError, RuntimeError):
            continue
        if dev.type != "cuda":
            continue
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index in seen:
            continue
        seen.add(index)
        try:
            stats = torch.cuda.memory_stats(index)
            limit = torch.cuda.mem_get_info(index)[1]
        except Exception:  # noqa: BLE001 — telemetry must never raise
            continue
        entry: Dict[str, Any] = {"device": str(index), "platform": "cuda",
                                 "limit": int(limit)}
        for raw, kind in (("allocated_bytes.all.current", "used"),
                          ("allocated_bytes.all.peak", "peak")):
            v = stats.get(raw)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                entry[kind] = int(v)
        out.append(entry)
    return out


def hbm_totals(devices: Sequence[Any]) -> Optional[Dict[str, Any]]:
    """Summed used/limit/peak over the cards that reported, with the
    per-card list; None when none did (a CPU runtime)."""
    per_device = device_memory_stats(devices)
    if not per_device:
        return None
    out: Dict[str, Any] = {"per_device": per_device}
    for kind in KINDS:
        vals = [e[kind] for e in per_device if kind in e]
        if vals:
            out[kind] = int(sum(vals))
    return out


class HostProfiler:
    """Sampling host profiler: periodic ``sys._current_frames()`` walks
    aggregated into collapsed stacks.

    Frames render as ``file.py:function`` (definition identity, not the
    current line — a hot loop must aggregate into one stack, not one stack
    per bytecode line). Distinct-stack count is bounded (``max_stacks``);
    overflow samples aggregate under a sentinel stack so the memory bound
    holds against pathological stack diversity while the sample count stays
    truthful."""

    OVERFLOW_KEY = ("(overflow)",)

    def __init__(
        self,
        hz: float = 19.0,
        max_stacks: int = 4096,
        max_depth: int = 48,
    ) -> None:
        # Off the round-number grid on purpose: a 20 Hz sampler beats in
        # lockstep with 100ms periodic work and sees only its edges.
        self.hz = min(250.0, max(0.1, float(hz)))
        self.max_stacks = max(16, int(max_stacks))
        self.max_depth = max(4, int(max_depth))
        self._counts: Dict[tuple, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.n_samples = 0
        self.started_wall: Optional[float] = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "HostProfiler":
        if self.running:
            return self
        self._stop.clear()
        self.started_wall = time.time()
        self._thread = threading.Thread(
            target=self._loop, name="host-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — the profiler must never crash
                pass            # its host; a lost sample is a lost sample

    @staticmethod
    def _frame_name(frame: Any) -> str:
        code = frame.f_code
        # ';' and ' ' are collapsed-format structure; scrub them from paths.
        fname = os.path.basename(code.co_filename).replace(";", ":")
        return f"{fname}:{code.co_name}".replace(" ", "_")

    def sample_once(self) -> None:
        """Walk every live thread's stack once and count the collapsed
        stacks. Callable directly (tests, forced flushes) — the background
        loop is just this on a timer."""
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        stacks: List[tuple] = []
        for tid, frame in frames.items():
            if tid == me:
                continue  # the sampler observing itself is pure noise
            stack: List[str] = []
            f = frame
            while f is not None and len(stack) < self.max_depth:
                stack.append(self._frame_name(f))
                f = f.f_back
            thread = str(names.get(tid, f"tid-{tid}")).replace(";", ":")
            # Root-first (flamegraph collapsed order): thread;outer;...;leaf.
            stacks.append((thread, *reversed(stack)))
        with self._lock:
            for key in stacks:
                if key not in self._counts and \
                        len(self._counts) >= self.max_stacks:
                    key = self.OVERFLOW_KEY
                self._counts[key] = self._counts.get(key, 0) + 1
            self.n_samples += 1

    def collapsed(self) -> str:
        """The flamegraph.pl collapsed-stack text: one ``a;b;c count`` line
        per distinct stack, deterministically ordered."""
        with self._lock:
            items = sorted(self._counts.items())
        return "\n".join(
            f"{';'.join(key)} {count}" for key, count in items
        ) + ("\n" if items else "")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "samples": self.n_samples,
                "distinct_stacks": len(self._counts),
                "hz": self.hz,
                "started_wall": self.started_wall,
            }


class CaptureCoordinator:
    """On-demand deep-capture bookkeeping (the controller half).

    Lifecycle: ``request()`` (POST /v1/profile/capture) → ``pending_for()``
    hands the request to the target agent's next *granted* lease as an
    ``alerts`` entry (``kind: "profile_capture"`` — old agents ignore
    unknown alert kinds by construction) → the agent wraps one matching op
    execution in a ``torch.profiler`` session (its artifact: a directory
    holding one Chrome trace) and ships
    ``metrics["profile_captures"]`` back on a later lease →
    ``complete()`` records the artifact path + summary. Bounded; oldest
    records evict first."""

    def __init__(self, max_captures: int = 64) -> None:
        self.max_captures = max(1, int(max_captures))
        self._captures: Dict[str, Dict[str, Any]] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()

    def request(
        self,
        agent: str,
        op: Optional[str] = None,
        duration_ms: Optional[float] = None,
    ) -> Dict[str, Any]:
        if not isinstance(agent, str) or not agent:
            raise ValueError("capture request needs a target agent name")
        if op is not None and (not isinstance(op, str) or not op):
            raise ValueError("op must be a non-empty string when given")
        if duration_ms is not None:
            if isinstance(duration_ms, bool) or not isinstance(
                duration_ms, (int, float)
            ) or duration_ms <= 0:
                raise ValueError("duration_ms must be a positive number")
        capture_id = f"cap-{uuid.uuid4().hex[:12]}"
        record = {
            "capture_id": capture_id,
            "agent": agent,
            "op": op,
            "duration_ms": duration_ms,
            "status": "requested",
            "requested_wall": round(time.time(), 3),
        }
        with self._lock:
            self._captures[capture_id] = record
            self._order.append(capture_id)
            while len(self._order) > self.max_captures:
                self._captures.pop(self._order.pop(0), None)
        return dict(record)

    def pending_for(self, agent: str) -> List[Dict[str, Any]]:
        """Undelivered requests targeting ``agent``, as lease-alert payloads.
        Marks them delivered — the channel is at-most-once by design (a lost
        lease response loses the capture; the operator re-requests, which is
        cheaper than building redelivery for a diagnostic)."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for cid in self._order:
                rec = self._captures.get(cid)
                if rec is None or rec["agent"] != agent \
                        or rec["status"] != "requested":
                    continue
                rec["status"] = "delivered"
                rec["delivered_wall"] = round(time.time(), 3)
                out.append({
                    "kind": "profile_capture",
                    "capture_id": cid,
                    "op": rec["op"],
                    "duration_ms": rec["duration_ms"],
                })
        return out

    def complete(self, payload: Any) -> bool:
        """Record one agent-shipped completion. Unknown/duplicate ids are
        dropped (the piggyback channel may redeliver)."""
        if not isinstance(payload, Mapping):
            return False
        cid = payload.get("capture_id")
        with self._lock:
            rec = self._captures.get(cid)
            if rec is None or rec["status"] in ("done", "error"):
                return False
            status = payload.get("status")
            rec["status"] = status if status in ("done", "error", "op_failed") \
                else "done"
            rec["completed_wall"] = round(time.time(), 3)
            for key in ("artifact", "summary", "error", "actual_duration_ms"):
                if payload.get(key) is not None:
                    rec[key] = payload[key]
        return True

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(self._captures[cid]) for cid in self._order
                    if cid in self._captures]
