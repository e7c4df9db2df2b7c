"""FIFO policy — bit-compatible with the pre-scheduler controller.

This is the exact inline scan ``Controller.lease`` used to run over its
``self._queue: List[str]``: walk the queue in arrival order, take eligible
jobs until the grant limit, and leave every other job in its original
relative position. Priority, tenant, and the agent's load advertisement are
deliberately ignored — ``SCHED_POLICY=fifo`` must produce the same drain
order (and therefore the same journal bytes) as HEAD for any interleaving
of submit/lease/report/expire, which ``tests/test_sched.py`` pins with a
model-based property test.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from agent_tpu_torch.sched.base import LeaseContext, Scheduler


class FifoScheduler(Scheduler):
    name = "fifo"

    def __init__(self, on_decision: Optional[Callable[[str], None]] = None
                 ) -> None:
        super().__init__(on_decision=on_decision)
        self._order: List[Any] = []  # Job refs in arrival order

    def add(self, job: Any) -> None:
        self._order.append(job)
        self._note_add(job)

    def discard(self, job_id: str) -> bool:
        for i, job in enumerate(self._order):
            if job.job_id == job_id:
                del self._order[i]
                self._note_remove(job)
                return True
        return False

    def reprioritize(self, job: Any) -> None:
        # Priority has no queue effect under FIFO: escalation updates the
        # job's field (visible in snapshots) but must not reorder anything.
        pass

    def take(
        self, ctx: LeaseContext, eligible: Callable[[Any], bool]
    ) -> List[Any]:
        # The historical scan with one refinement: jobs on a
        # workflow's critical path (``critical_path`` = longest remaining
        # stage count, 0 for plain jobs) are scanned first. The sort is
        # stable, so with no DAG jobs queued the scan order — and therefore
        # the drain order and journal bytes — is bit-identical to the
        # historical one-pass walk. Linear chains have strictly decreasing
        # critical_path along arrival order, so they also degrade to plain
        # FIFO (pinned by tests/test_flow.py's property test). Non-taken
        # jobs keep their original arrival positions either way.
        scan = sorted(
            self._order, key=lambda j: -getattr(j, "critical_path", 0)
        )
        taken: List[Any] = []
        taken_ids: set = set()
        for job in scan:
            if len(taken) >= ctx.limit:
                break
            if eligible(job):
                taken.append(job)
                taken_ids.add(id(job))
                self._note_remove(job)
        if taken:
            self._order = [j for j in self._order if id(j) not in taken_ids]
        return taken

    def queued_ids(self) -> List[str]:
        return [job.job_id for job in self._order]

    def depth_by_priority(self) -> dict:
        # Health-endpoint feed: O(queue), called off the hot path.
        # FIFO ignores priority for ORDER but the pressure split is still
        # the signal the autoscaler wants.
        out: dict = {}
        for job in self._order:
            out[job.priority] = out.get(job.priority, 0) + 1
        return out
