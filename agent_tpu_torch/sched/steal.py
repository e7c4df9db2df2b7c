"""Cross-partition work stealing policy.

A partitioned control plane shards jobs by consistent hash of
``{tenant, job_id}`` (``controller/partition.py``), which balances *keys*,
not *load*: one hot tenant can pile work onto a single partition while the
others idle. The fix is the classic work-stealing move — an agent whose
home partition has nothing leasable takes work from the partition with the
deepest leasable queue — and the decision of *when* that is worth doing is
a scheduling concern, so it lives here, next to the dispatch policies.

The policy is deliberately stateless and side-effect free: callers (the
router's lease path, or an agent running with an explicit partition map)
feed it the home partition plus a depth sample per partition and get back
the victim to poll, or ``None``. Safety does not depend on this policy at
all — a stolen lease is just an ordinary lease against the partition that
owns the job, so epoch fencing and the terminal-state duplicate guard make
the handoff idempotent; stealing only decides where an idle agent polls
next.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from agent_tpu_torch.config import env_bool, env_int


@dataclass(frozen=True)
class StealPolicy:
    """When does an idle agent poll a foreign partition?

    ``min_advantage`` is the hysteresis: a victim's leasable depth must
    exceed the home partition's by at least this many jobs. 1 steals
    aggressively (any deeper queue qualifies); larger values keep agents
    home unless the imbalance is real, which bounds the extra lease
    traffic stealing adds to an already-loaded partition.
    """

    enabled: bool = True          # STEAL_ENABLED
    min_advantage: int = 1        # STEAL_MIN_ADVANTAGE

    @staticmethod
    def from_env() -> "StealPolicy":
        return StealPolicy(
            enabled=env_bool("STEAL_ENABLED", True),
            min_advantage=max(1, env_int("STEAL_MIN_ADVANTAGE", 1)),
        )

    def pick_victim(
        self, home: str, depths: Dict[str, Optional[int]]
    ) -> Optional[str]:
        """The partition an idle-at-home agent should steal from, or None.

        ``depths`` maps partition name -> leasable queue depth (None =
        unknown/unreachable, never stolen from). Deterministic: deepest
        eligible victim wins, ties break by name — two routers looking at
        the same sample send their idle agents to the same place, which is
        fine (the victim fences via its own lease path).
        """
        if not self.enabled:
            return None
        home_depth = depths.get(home) or 0
        best: Optional[str] = None
        best_depth = 0
        for name in sorted(depths):
            if name == home:
                continue
            depth = depths.get(name)
            if depth is None:
                continue
            if depth - home_depth < self.min_advantage:
                continue
            if depth > best_depth:
                best, best_depth = name, depth
        return best
