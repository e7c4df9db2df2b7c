"""Retry/backoff core — counterpart of ``agent_tpu.utils.retry``, kept as
the port's own copy (the agent's lease retries and spool redelivery use
it).

Two halves:

- **Classification.** An HTTP failure is either ``transient`` (worth
  retrying: transport errors, HTTP 5xx, 429) or ``permanent`` (other 4xx:
  resending the same bytes cannot succeed).
- **Backoff.** ``RetryPolicy`` + ``RetryState`` implement capped exponential
  backoff with *decorrelated jitter* (the AWS-architecture variant: each
  sleep is uniform in ``[base, prev * multiplier]``, capped) — a restarted
  fleet decorrelates instead of thundering back in lockstep. ``jittered``
  is the lighter helper for spreading fixed sleeps (idle polls).

Policy knobs ride the env surface (``RETRY_BASE_SEC``, ``RETRY_MAX_SEC`` —
see ``config.AgentConfig``); everything here is dependency-free.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Optional

TRANSIENT = "transient"
PERMANENT = "permanent"


def classify_http(status: Any) -> str:
    """HTTP status → ``transient`` | ``permanent``.

    Status 0 is the agent's transport-error sentinel (could not reach the
    controller at all) — transient by definition. 429 is explicit backpressure
    and 5xx is a server-side fault: both transient. Remaining 4xx mean the
    request itself is wrong; resending the same bytes cannot succeed.
    """
    try:
        s = int(status)
    except (TypeError, ValueError):
        return TRANSIENT
    if s == 429:
        return TRANSIENT
    if 400 <= s < 500:
        return PERMANENT
    return TRANSIENT


def jittered(
    value: float, frac: float = 0.25, rng: Optional[random.Random] = None
) -> float:
    """``value`` ± ``frac`` uniform jitter, floored at 0 — spreads fixed
    sleeps (idle polls) so a fleet restarted together doesn't long-poll in
    lockstep."""
    if value <= 0:
        return 0.0
    r = (rng or random).uniform(-frac, frac)
    return max(0.0, value * (1.0 + r))


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with decorrelated jitter."""

    base_sec: float = 0.5
    max_sec: float = 30.0
    multiplier: float = 3.0

    def start(self, rng: Optional[random.Random] = None) -> "RetryState":
        return RetryState(self, rng=rng)


class RetryState:
    """Mutable per-operation backoff state (one per thing being retried)."""

    def __init__(self, policy: RetryPolicy, rng: Optional[random.Random] = None) -> None:
        self.policy = policy
        self._rng = rng or random.Random()
        self._prev = 0.0

    def next_backoff(self) -> float:
        """The next sleep: uniform in ``[base, prev * multiplier]``, capped at
        ``max_sec``. The first call returns something in ``[base, base *
        multiplier]``; repeated failures grow toward the cap without ever
        synchronizing two independent retriers."""
        p = self.policy
        prev = self._prev if self._prev > 0 else p.base_sec
        hi = max(p.base_sec, prev * p.multiplier)
        sleep = min(p.max_sec, self._rng.uniform(p.base_sec, hi))
        self._prev = sleep
        return sleep

    def reset(self) -> None:
        """Forget the failure streak (call on success)."""
        self._prev = 0.0
