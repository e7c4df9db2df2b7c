"""Device utilization accounting — the agent-side half of
``agent_tpu.obs.health``: :class:`RollingWindow` turns the device thread's
busy seconds into a rolling duty cycle, and :func:`resolve_peak_flops`
gives the card's peak dense-bf16 FLOP/s, the denominator of the agent's
``device_mfu{op}`` gauge. Both are estimates by design: duty counts the
device thread's wall time inside op execute, MFU the ops' analytic matmul
FLOPs over that time. The ``/v1/health`` verdict is the controller's.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Optional

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
