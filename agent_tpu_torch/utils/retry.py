"""Retry/backoff core — counterpart of ``agent_tpu.utils.retry``, kept as
the port's own copy (the agent's lease retries and spool redelivery use
it).

Two halves:

- **Classification.** A failure is either ``transient`` (worth retrying:
  transport errors, HTTP 5xx, 429) or ``permanent`` (no retry can fix it:
  other 4xx, ``UnknownOp``, malformed tasks). The controller uses the same
  table to decide whether a failed job gets its retry budget or sticks
  ``failed`` immediately.
- **Backoff.** ``RetryPolicy`` + ``RetryState`` implement capped exponential
  backoff with *decorrelated jitter* (the AWS-architecture variant: each
  sleep is uniform in ``[base, prev * multiplier]``, capped) — a restarted
  fleet decorrelates instead of thundering back in lockstep. ``jittered``
  is the lighter helper for spreading fixed sleeps (idle polls).

Policy knobs ride the env surface (``RETRY_BASE_SEC``, ``RETRY_MAX_SEC``,
``RETRY_DEADLINE_SEC`` — see ``config.AgentConfig``); everything here is
dependency-free.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

TRANSIENT = "transient"
PERMANENT = "permanent"

# Structured-error ``type`` names (utils.errors.structured_error) that no
# retry can fix: re-running the same task yields the same failure. Anything
# not listed is assumed transient — device flakes, OOMs under contention and
# transport hiccups surface as RuntimeError/OSError subtypes, and wrongly
# retrying a permanent error once is cheaper than wrongly killing a
# recoverable job.
PERMANENT_ERROR_TYPES = frozenset(
    {"UnknownOp", "ValueError", "TypeError", "KeyError", "OpError"}
)


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


def classify_error(error: Any) -> str:
    """Structured error (dict with ``type``, or a bare type name) →
    ``transient`` | ``permanent``."""
    name = error.get("type") if isinstance(error, dict) else error
    if isinstance(name, str) and name in PERMANENT_ERROR_TYPES:
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
    """Capped exponential backoff with decorrelated jitter.

    ``deadline_sec`` is the overall budget for one logical operation (0 =
    unbounded); ``RetryState.expired()`` reports when it is spent, and the
    caller decides what giving up means.
    """

    base_sec: float = 0.5
    max_sec: float = 30.0
    multiplier: float = 3.0
    deadline_sec: float = 0.0

    def start(self, rng: Optional[random.Random] = None,
              clock: Callable[[], float] = time.monotonic) -> "RetryState":
        return RetryState(self, rng=rng, clock=clock)


class RetryState:
    """Mutable per-operation backoff state (one per thing being retried)."""

    def __init__(self, policy: RetryPolicy, rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.policy = policy
        self._rng = rng or random.Random()
        self._clock = clock
        self._prev = 0.0
        self._started: Optional[float] = None
        self.attempts = 0

    def next_backoff(self) -> float:
        """The next sleep: uniform in ``[base, prev * multiplier]``, capped at
        ``max_sec``. The first call returns something in ``[base, base *
        multiplier]``; repeated failures grow toward the cap without ever
        synchronizing two independent retriers."""
        if self._started is None:
            self._started = self._clock()
        self.attempts += 1
        p = self.policy
        prev = self._prev if self._prev > 0 else p.base_sec
        hi = max(p.base_sec, prev * p.multiplier)
        sleep = min(p.max_sec, self._rng.uniform(p.base_sec, hi))
        self._prev = sleep
        return sleep

    def expired(self) -> bool:
        """True once the overall deadline is spent (never before the first
        ``next_backoff``; a policy without a deadline never expires)."""
        return (
            self.policy.deadline_sec > 0
            and self._started is not None
            and self._clock() - self._started >= self.policy.deadline_sec
        )

    def reset(self) -> None:
        """Forget the failure streak (call on success)."""
        self._prev = 0.0
        self._started = None
        self.attempts = 0
