"""Scheduler interface — the seam between lease mechanics and lease *policy*.

The controller owns correctness (job state machine, epoch fencing, label
matching, dependency gating, journal durability); a ``Scheduler`` owns only
*order and placement*: which of the currently-leasable jobs go out on this
lease, and how many. That split is what lets ``fifo`` stay bit-compatible
with the pre-scheduler controller (the policy replays the exact inline scan
it replaced) while ``fair`` layers priority tiers, tenant fair-share, and
load-aware placement on the same state machine.

Contract:

- The controller calls ``add(job)`` whenever a job becomes queued (submit,
  retry requeue, lease-expiry requeue) and ``take(ctx, eligible)`` under its
  lock on every lease. ``take`` returns jobs **removed** from the queue in
  dispatch order; jobs not returned must keep their relative order (the
  fifo compatibility guarantee) or their policy-defined position (fair).
- ``eligible(job)`` is the controller's leasability check (state, not_before,
  capability ops, labels, dependencies). Policies never re-implement it; they
  only decide *among* eligible jobs — plus placement deferral, which may skip
  an eligible job a bounded number of times waiting for a better-suited agent.
- Queues hold Job references (the controller's own objects); the scheduler
  never mutates job state except the placement-deferral counter.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, List, Optional

PRIORITY_MIN = 0
PRIORITY_MAX = 9
DEFAULT_PRIORITY = 4
DEFAULT_TENANT = "default"


class AdmissionError(Exception):
    """Submit rejected by admission control (wire: HTTP 429).

    Carries ``retry_after_ms`` so the HTTP layer can tell the client when to
    come back; ``utils/retry.py`` already classifies 429 as transient, so an
    unmodified agent-side ``RetryPolicy`` backs off and retries correctly.
    """

    def __init__(
        self,
        message: str,
        retry_after_ms: int = 1000,
        tenant: Optional[str] = None,
        scope: str = "global",
    ) -> None:
        super().__init__(message)
        self.retry_after_ms = int(retry_after_ms)
        self.tenant = tenant
        self.scope = scope


@dataclass(frozen=True)
class LeaseContext:
    """Everything a policy may consider about the polling agent.

    ``limit`` is the number of distinct jobs the controller will actually
    hand out this lease (post fault-injection accounting); ``requested`` is
    the agent's raw ``max_tasks``. The device/load fields come from the
    enriched lease ``capabilities`` (``device_kind``/``mesh_devices`` from
    ``TorchRuntime.describe()``, ``queue_depth`` = the agent's staged-queue
    occupancy) and are None for agents that predate the enrichment — a
    policy must degrade to capability-only behavior for those.
    """

    agent: str = ""
    now: float = 0.0
    limit: int = 1
    requested: int = 1
    ops: FrozenSet[str] = frozenset()
    labels: Dict[str, Any] = field(default_factory=dict)
    device_kind: Optional[str] = None
    mesh_devices: Optional[int] = None
    queue_depth: Optional[int] = None


class Scheduler:
    """Base policy: queue bookkeeping shared by every implementation."""

    name = "?"

    def __init__(
        self, on_decision: Optional[Callable[..., None]] = None
    ) -> None:
        # Counter hook (controller-provided): policy-internal decisions
        # (placement deferrals) surface in sched_decisions_total without the
        # policy importing the metrics registry. Policies that know WHICH
        # job a decision concerns pass ``job_id=`` so the controller can
        # also pin a span to that job's trace; hooks that ignore
        # it must accept the kwarg.
        self.on_decision = on_decision or (
            lambda decision, **_kw: None
        )
        self._depth_by_tenant: Dict[str, int] = {}

    # -- bookkeeping helpers for subclasses --

    def _note_add(self, job: Any) -> None:
        t = job.tenant
        self._depth_by_tenant[t] = self._depth_by_tenant.get(t, 0) + 1

    def _note_remove(self, job: Any) -> None:
        t = job.tenant
        n = self._depth_by_tenant.get(t, 0) - 1
        if n <= 0:
            self._depth_by_tenant.pop(t, None)
        else:
            self._depth_by_tenant[t] = n

    # -- depth introspection (admission control + gauges) --

    def total(self) -> int:
        return sum(self._depth_by_tenant.values())

    def depth_for(self, tenant: str) -> int:
        return self._depth_by_tenant.get(tenant, 0)

    def depth_by_tenant(self) -> Dict[str, int]:
        return dict(self._depth_by_tenant)

    def depth_by_priority(self) -> Dict[int, int]:
        """Queued jobs per priority tier — the per-tier queue-pressure feed
        ``GET /v1/health`` reports next to SLO attainment.
        Subclasses with a cheaper view override; the default derives it
        from ``queued_ids`` via the policy's own job references and is only
        called off the hot path (health endpoint, swarmtop)."""
        return {}

    # -- the policy surface (subclasses implement) --

    def add(self, job: Any) -> None:
        raise NotImplementedError

    def discard(self, job_id: str) -> bool:
        """Drop a queued job (deadline death while pending). Returns whether
        it was queued."""
        raise NotImplementedError

    def reprioritize(self, job: Any) -> None:
        """Re-bucket a queued job after its ``priority`` changed (deadline
        escalation). Default: discard + re-add (tail of the new tier)."""
        if self.discard(job.job_id):
            self.add(job)

    def take(
        self,
        ctx: LeaseContext,
        eligible: Callable[[Any], bool],
    ) -> List[Any]:
        raise NotImplementedError

    def queued_ids(self) -> List[str]:
        raise NotImplementedError


def make_scheduler(
    config: Any = None,
    on_decision: Optional[Callable[[str], None]] = None,
) -> Scheduler:
    """Build the policy named by ``config.policy`` (``SCHED_POLICY``).

    ``fifo`` (default) is bit-compatible with the pre-scheduler controller;
    ``fair`` enables priority tiers + tenant fair-share + placement.
    """
    from agent_tpu_torch.sched.fair import FairScheduler
    from agent_tpu_torch.sched.fifo import FifoScheduler

    policy = getattr(config, "policy", "fifo") or "fifo"
    if policy == "fifo":
        return FifoScheduler(on_decision=on_decision)
    if policy == "fair":
        return FairScheduler(config, on_decision=on_decision)
    raise ValueError(f"unknown SCHED_POLICY {policy!r} (want fifo|fair)")
