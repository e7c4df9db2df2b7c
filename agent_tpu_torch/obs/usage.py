"""Usage stamping — the part of ``agent_tpu.obs.usage`` the serving ops
use: :func:`stamp_usage`, which accumulates a task's usage fields into
``ctx.tags["usage"]`` (the reference's ledger and showback lines are not
ported yet)."""

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
