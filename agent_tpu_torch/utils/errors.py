"""Error contracts: ops return ``{"ok": False, "error": "..."}`` for bad
input instead of raising (the ``agent_tpu.utils.errors`` contract)."""

from __future__ import annotations

from typing import Any, Dict


def bad_input(message: str, **extra: Any) -> Dict[str, Any]:
    """The ops-level soft-failure shape."""
    out: Dict[str, Any] = {"ok": False, "error": message}
    out.update(extra)
    return out
