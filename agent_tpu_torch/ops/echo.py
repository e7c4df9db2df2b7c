"""Diagnostic echo op — counterpart of ``agent_tpu.ops.echo``: returns the
payload verbatim under ``echo`` with ``ok: True``, tolerating ``None``.
Host-only: the first op a fresh deployment runs, before any device runtime
exists."""

from __future__ import annotations

from typing import Any, Dict, Optional

from agent_tpu_torch.ops import register_op


@register_op("echo")
def run(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    if payload is None:
        payload = {}
    return {"ok": True, "echo": payload}
