"""Fair policy: priority tiers → weighted deficit-round-robin → FIFO,
with load- and capability-aware placement.

Dispatch order (the contract):

1. **Priority tier first.** Jobs carry ``priority`` 0–9 (9 = most urgent);
   a lower tier never dispatches while a higher tier has an eligible job
   for this agent.
2. **Deficit round-robin across tenants within a tier.** Each tier keeps a
   rotation of tenants (arrival order); every visit banks the tenant's
   weight (``SCHED_TENANT_WEIGHTS``, default 1) into a deficit counter and
   serves one job per unit of deficit. A tenant with weight 3 drains 3×
   the jobs per rotation of a weight-1 tenant; with equal weights this is
   plain round-robin — one tenant's 10k-shard bulk job can no longer starve
   another tenant's interactive singles. Deficits do not bank while a
   tenant has nothing serviceable (classic DRR anti-hoarding).
3. **FIFO within a tenant.** Arrival order, with ineligible jobs skipped in
   place (a dependency-gated reduce must not block the shards behind it).

Placement (the MPMD insight — unequal work belongs on unequal hardware,
arXiv:2412.14374 — applied to the lease protocol):

- A device-bound job (op name ``*_tpu`` or a truthy ``tpu`` required label,
  the reference's names) **prefers** agents advertising an accelerator
  ``device_kind`` (:data:`DEVICE_KINDS`: ``"cuda"``, the port's card, and
  ``"tpu"``): any other agent is refused the job up to
  ``SCHED_PLACEMENT_PATIENCE`` times, after which any capable agent may
  take it — preference, never starvation. The reference counts ``"tpu"``
  alone, so it would defer ``map_classify_tpu`` away from a CUDA agent.
- Bulk shards (``shard-*`` job ids) prefer **idle** agents: an agent whose
  advertised staged ``queue_depth`` exceeds ``SCHED_BUSY_QUEUE_DEPTH`` is
  deferred the same bounded way.
- Disaggregated-serving prefill jobs (``serve_prefill``) prefer
  agents that do **not** advertise ``serve_decode`` — encoder bursts stay
  off the continuous-decode fleet — with the same bounded deferral.
- Deep-queue agents get **shrunken grants**: the grant limit drops by the
  staged backlog beyond the busy threshold (floor 1), so a backed-up agent
  stops accumulating work it cannot start — the tf.data backpressure idea
  (arXiv:2101.12127) applied to ``max_tasks``.

Everything is deterministic: no randomness, dict/deque iteration in
insertion order, the rotation cursor persists across leases. The same
submit/lease sequence always yields the same dispatch order (pinned by
``tests/test_sched.py``; the chaos soak relies on it for seeded replay).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from agent_tpu_torch.config import TRUTHY_TOKENS
from agent_tpu_torch.sched.base import LeaseContext, Scheduler


def _truthy(value: Any) -> bool:
    if isinstance(value, str):
        return value.strip().lower() in TRUTHY_TOKENS
    return bool(value)


# Device kinds that count as the accelerator for device-bound jobs: the
# agent advertises ``runtime.platform`` ("cuda" on the card).
DEVICE_KINDS = frozenset({"cuda", "tpu"})


def wants_tpu(job: Any) -> bool:
    """TPU-tagged: the op is device-bound by name convention (``*_tpu``) or
    the submitter required a truthy ``tpu`` label."""
    if job.op.endswith("_tpu"):
        return True
    return _truthy(job.required_labels.get("tpu"))


def is_bulk(job: Any) -> bool:
    """Bulk shard of a sharded drain (``submit_csv_job`` id convention)."""
    return job.job_id.startswith("shard-")


class FairScheduler(Scheduler):
    name = "fair"

    def __init__(
        self,
        config: Any = None,
        on_decision: Optional[Callable[[str], None]] = None,
    ) -> None:
        super().__init__(on_decision=on_decision)
        weights = dict(getattr(config, "tenant_weights", None) or {})
        self._weights: Dict[str, float] = {
            str(k): max(0.0, float(v)) for k, v in weights.items()
        }
        self.placement_patience = max(
            0, int(getattr(config, "placement_patience", 3))
        )
        self.busy_queue_depth = max(
            0, int(getattr(config, "busy_queue_depth", 2))
        )
        # priority → tenant → FIFO of Job refs
        self._tiers: Dict[int, Dict[str, Deque[Any]]] = {}
        # priority → persistent DRR rotation (deque of tenant names); the
        # head is the next tenant to visit, surviving across take() calls.
        self._rotation: Dict[int, Deque[str]] = {}
        # priority → tenant → banked deficit
        self._deficit: Dict[int, Dict[str, float]] = {}
        # job_id → (priority, tenant) for O(1) discard
        self._where: Dict[str, Tuple[int, str]] = {}

    # ---- queue maintenance ----

    def _weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def add(self, job: Any) -> None:
        prio = int(job.priority)
        tier = self._tiers.setdefault(prio, {})
        if job.tenant not in tier:
            tier[job.tenant] = deque()
            self._rotation.setdefault(prio, deque()).append(job.tenant)
            self._deficit.setdefault(prio, {}).setdefault(job.tenant, 0.0)
        tier[job.tenant].append(job)
        self._where[job.job_id] = (prio, job.tenant)
        self._note_add(job)

    def discard(self, job_id: str) -> bool:
        loc = self._where.pop(job_id, None)
        if loc is None:
            return False
        prio, tenant = loc
        q = self._tiers.get(prio, {}).get(tenant)
        if q is None:
            return False
        for job in q:
            if job.job_id == job_id:
                q.remove(job)
                self._note_remove(job)
                self._gc_tenant(prio, tenant)
                return True
        return False

    def _gc_tenant(self, prio: int, tenant: str) -> None:
        """Drop empty tenant queues (and tiers) so rotation stays tight.
        Deficit resets with the queue: an empty tenant banks nothing."""
        tier = self._tiers.get(prio)
        if tier is None:
            return
        q = tier.get(tenant)
        if q is not None and not q:
            del tier[tenant]
            self._deficit.get(prio, {}).pop(tenant, None)
            rot = self._rotation.get(prio)
            if rot is not None and tenant in rot:
                rot.remove(tenant)
        if not tier:
            self._tiers.pop(prio, None)
            self._rotation.pop(prio, None)
            self._deficit.pop(prio, None)

    def depth_by_priority(self) -> Dict[int, int]:
        # Health-endpoint feed: the tier structure already holds
        # the split, so this is O(tiers × tenants), not O(jobs).
        return {
            prio: sum(len(q) for q in tier.values())
            for prio, tier in self._tiers.items()
            if tier
        }

    # ---- placement ----

    def score(self, job: Any, ctx: LeaseContext) -> float:
        """Suitability of handing ``job`` to ``ctx``'s agent, >= 0 means
        acceptable now. Unknown fields (legacy agents) never penalize —
        a fleet that predates the enrichment behaves capability-only."""
        s = 1.0
        if wants_tpu(job) and ctx.device_kind is not None:
            if ctx.device_kind in DEVICE_KINDS:
                # Bigger meshes edge out smaller ones for device-bound work.
                s += 2.0 + min(int(ctx.mesh_devices or 0), 64) / 64.0
            else:
                s -= 2.0
        if is_bulk(job) and ctx.queue_depth is not None:
            s -= 0.5 * max(0, int(ctx.queue_depth) - self.busy_queue_depth)
        if job.op == "serve_prefill" and "serve_decode" in ctx.ops:
            # Disaggregated serving: prefill is a bulk encoder
            # burst; landing it on an agent that also runs the continuous
            # decode engine steals decode iterations and blows TTFT. Steer
            # it toward prefill-only agents the bounded way (same
            # preference-never-starvation contract as the device rule): a
            # decode-capable agent defers it up to placement_patience.
            s -= 1.0
        return s

    def _placement_ok(self, job: Any, ctx: LeaseContext) -> bool:
        if self.score(job, ctx) >= 0.5:
            return True
        if job.placement_defers >= self.placement_patience:
            return True  # patience exhausted: any capable agent may take it
        job.placement_defers += 1
        # job_id lets the controller pin the deferral onto the job's trace
        # (a sched.defer span) as well as the aggregate counter.
        self.on_decision("deferred_placement", job_id=job.job_id)
        return False

    # ---- dispatch ----

    def _grant_limit(self, ctx: LeaseContext) -> int:
        limit = ctx.limit
        if ctx.queue_depth is not None:
            excess = max(0, int(ctx.queue_depth) - self.busy_queue_depth)
            if excess:
                limit = max(1, limit - excess)
        return limit

    def take(
        self, ctx: LeaseContext, eligible: Callable[[Any], bool]
    ) -> List[Any]:
        limit = self._grant_limit(ctx)
        out: List[Any] = []
        for prio in sorted(self._tiers, reverse=True):
            if len(out) >= limit:
                break
            self._take_tier(prio, ctx, eligible, limit, out)
        return out

    def _take_tier(
        self,
        prio: int,
        ctx: LeaseContext,
        eligible: Callable[[Any], bool],
        limit: int,
        out: List[Any],
    ) -> None:
        rotation = self._rotation.get(prio)
        if not rotation:
            return
        deficits = self._deficit.setdefault(prio, {})
        # Classic DRR with a persistent cursor: the head of ``rotation`` is
        # the tenant currently being served. Arriving at a tenant with a
        # spent deficit banks its weight once; it then serves jobs until
        # the deficit runs out (cursor advances) or the grant fills (cursor
        # STAYS, so the next lease resumes this tenant's turn — that
        # carry-over is what makes per-lease grants of 1 still honor the
        # weights). A full fruitless cycle (every tenant visited, nothing
        # serviceable for this agent) terminates the pass.
        fruitless = 0
        while len(out) < limit and rotation and fruitless < len(rotation):
            tenant = rotation[0]
            q = self._tiers.get(prio, {}).get(tenant)
            if not q:
                deficits[tenant] = 0.0
                rotation.rotate(-1)
                fruitless += 1
                continue
            if deficits.get(tenant, 0.0) < 1.0:
                deficits[tenant] = (
                    deficits.get(tenant, 0.0) + self._weight(tenant)
                )
            if deficits[tenant] < 1.0:
                # Sub-unit weight: still banking toward its next grant.
                rotation.rotate(-1)
                fruitless += 1
                continue
            served = 0
            while deficits[tenant] >= 1.0 and len(out) < limit:
                job = self._pop_serviceable(q, ctx, eligible)
                if job is None:
                    # Nothing serviceable now: no banking (anti-hoard).
                    deficits[tenant] = 0.0
                    break
                self._where.pop(job.job_id, None)
                self._note_remove(job)
                out.append(job)
                deficits[tenant] -= 1.0
                served += 1
            fruitless = 0 if served else fruitless + 1
            if (
                len(out) >= limit
                and deficits.get(tenant, 0.0) >= 1.0
                and q
            ):
                break  # mid-turn: cursor stays for the next lease
            self._gc_tenant(prio, tenant)
            if prio not in self._tiers:
                return  # tier fully drained; rotation is gone
            if tenant in rotation:
                rotation.rotate(-1)

    def _pop_serviceable(
        self,
        q: Deque[Any],
        ctx: LeaseContext,
        eligible: Callable[[Any], bool],
    ) -> Optional[Any]:
        """First job in FIFO order that is leasable *and* placeable on this
        agent; ineligible/deferred jobs keep their positions (no
        head-of-line blocking by a dep-gated reduce or a device-bound job
        waiting out its placement patience).

        Critical-path-first: when workflow stage jobs are queued
        (``critical_path`` > 0 = longest remaining stage count), the
        serviceable job with the most downstream work wins the pop; ties —
        and the all-plain-jobs case — keep exact FIFO order, so non-DAG
        drains are byte-identical to the pre-DAG scheduler."""
        if any(getattr(j, "critical_path", 0) > 0 for j in q):
            best = None
            for job in q:
                if (
                    (best is None or getattr(job, "critical_path", 0)
                     > getattr(best, "critical_path", 0))
                    and eligible(job)
                    and self._placement_ok(job, ctx)
                ):
                    best = job
            if best is not None:
                q.remove(best)
            return best
        for job in q:
            if eligible(job) and self._placement_ok(job, ctx):
                q.remove(job)
                return job
        return None

    def queued_ids(self) -> List[str]:
        out: List[str] = []
        for prio in sorted(self._tiers, reverse=True):
            rot = self._rotation.get(prio)
            tenants = list(rot) if rot else list(self._tiers[prio])
            for tenant in tenants:
                out.extend(
                    j.job_id for j in self._tiers[prio].get(tenant, ())
                )
        return out
