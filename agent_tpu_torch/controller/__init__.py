"""The controller's side of the port. For now only its durable journal:
:class:`~agent_tpu_torch.controller.journal.SegmentedJournal` (bounded
segments, atomic snapshots, torn-tail sealing), which ``obs.tsdb`` stores
its tiers in. The controller itself and its HTTP server come later."""

from agent_tpu_torch.controller.journal import (
    JournalTailer,
    SegmentedJournal,
    list_segments,
    load_snapshot,
)

__all__ = ["JournalTailer", "SegmentedJournal", "list_segments", "load_snapshot"]
