"""The controller — the other half of the lease protocol, the port's
counterpart of ``agent_tpu.controller``:

- :class:`~agent_tpu_torch.controller.core.Controller` — the in-memory
  scheduler: job queue, capability matching, lease issuance and expiry,
  ``job_epoch`` fencing, result collection, CSV shard splitting, workflows,
  the ``/v1/infer`` front door (``controller/serving.py``), journal replay,
  and fault-injection hooks.
- :class:`~agent_tpu_torch.controller.server.ControllerServer` — a stdlib
  ``ThreadingHTTPServer`` speaking ``POST /v1/leases`` / ``POST
  /v1/results`` and the rest of the HTTP surface; ``python -m
  agent_tpu_torch.controller.server`` runs one standalone.
- :class:`~agent_tpu_torch.controller.journal.SegmentedJournal` — the
  durable journal (bounded segments, atomic snapshots, torn-tail sealing),
  which ``obs.tsdb`` also stores its tiers in.

Host code only: nothing here imports torch.
"""

from agent_tpu_torch.controller.core import Controller, Job
from agent_tpu_torch.controller.journal import (
    JournalTailer,
    SegmentedJournal,
    list_segments,
    load_snapshot,
)
from agent_tpu_torch.controller.server import ControllerServer

__all__ = ["Controller", "ControllerServer", "Job", "JournalTailer", "SegmentedJournal",
           "list_segments", "load_snapshot"]
