"""Error contracts, as ``agent_tpu.utils.errors`` has them:

- ops return ``{"ok": False, "error": "..."}`` for bad input instead of
  raising;
- the agent loop turns a raised exception into the structured
  ``{"type", "message", "trace"}`` error shipped with a ``failed`` result.
"""

from __future__ import annotations

import traceback
from typing import Any, Dict


class OpError(Exception):
    """Raised by ops for contract violations that should fail the task
    (``utils.retry`` classifies it as permanent)."""


def structured_error(exc: BaseException) -> Dict[str, Any]:
    """Exception -> the wire error shape the controller expects."""
    return {
        "type": type(exc).__name__,
        "message": str(exc),
        "trace": "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)
        )[-4000:],
    }


def bad_input(message: str, **extra: Any) -> Dict[str, Any]:
    """The ops-level soft-failure shape."""
    out: Dict[str, Any] = {"ok": False, "error": message}
    out.update(extra)
    return out
