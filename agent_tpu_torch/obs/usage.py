"""Usage stamping — the agent-side part of ``agent_tpu.obs.usage``:
:func:`stamp_usage` accumulates a task's usage fields into
``ctx.tags["usage"]``, which the result carries as its ``usage`` block for
the reference controller's ``UsageLedger`` to bill. The agent stamps
``device_s`` (the same seconds that feed ``device_busy_seconds_total``),
``chips``, ``flops`` (from the op's ``device_attr``) and ``host_s`` (stage
and finalize); the ops stamp ``rows`` and the serving ops
``cache_hit_rows``. The ledger itself is the controller's."""

from __future__ import annotations

from typing import Any, Dict, Optional


def stamp_usage(tags: Optional[Dict[str, Any]], **fields: float) -> None:
    """Add each field into ``tags["usage"]``; ``chips`` is a level, not an
    accumulator (last writer wins), and a None field is skipped."""
    if tags is None:
        return
    u = tags.setdefault("usage", {})
    for key, value in fields.items():
        if value is None:
            continue
        if key == "chips":
            u["chips"] = float(value)
        else:
            u[key] = u.get(key, 0.0) + float(value)
