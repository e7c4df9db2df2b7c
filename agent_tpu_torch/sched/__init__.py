"""Swarm scheduler subsystem.

The controller delegates every lease decision here. ``fifo`` (default)
replays the historical inline scan bit-for-bit; ``fair`` adds priority
tiers, weighted tenant fair-share (deficit round-robin), load-aware
placement, admission control, and deadline handling — see ``base.py`` for
the policy contract and ``fair.py`` for the dispatch rules.
"""

from agent_tpu_torch.sched.base import (
    DEFAULT_PRIORITY,
    DEFAULT_TENANT,
    PRIORITY_MAX,
    PRIORITY_MIN,
    AdmissionError,
    LeaseContext,
    Scheduler,
    make_scheduler,
)
from agent_tpu_torch.sched.fair import FairScheduler
from agent_tpu_torch.sched.fifo import FifoScheduler

__all__ = [
    "AdmissionError",
    "DEFAULT_PRIORITY",
    "DEFAULT_TENANT",
    "FairScheduler",
    "FifoScheduler",
    "LeaseContext",
    "PRIORITY_MAX",
    "PRIORITY_MIN",
    "Scheduler",
    "make_scheduler",
]
