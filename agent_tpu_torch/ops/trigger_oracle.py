"""Oracle SCM Cloud inventory-transaction webhook op — counterpart of
``agent_tpu.ops.trigger_oracle``: posts an inventory transaction built from
``{event, item, qty}``, with credentials from ORACLE_HOST/ORA_USER/ORA_PASS.
With no ORACLE_HOST, or ``dry_run: true``, it returns the request that
would be sent. The post goes through the standard library
(``utils.http``), not ``requests``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from agent_tpu_torch.ops import register_op
from agent_tpu_torch.utils.errors import bad_input

REST_PATH = "/fscmRestApi/resources/11.13.18.05/inventoryStagedTransactions"


@register_op("trigger_oracle")
def run(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    if not isinstance(payload, dict):
        return bad_input("payload must be a dict")
    event = payload.get("event", "inventory_adjustment")
    item = payload.get("item")
    qty = payload.get("qty", 0)
    if not isinstance(item, str) or not item:
        return bad_input("item is required and must be a non-empty string")
    if isinstance(qty, bool) or not isinstance(qty, (int, float)):
        return bad_input("qty must be numeric")

    host = os.environ.get("ORACLE_HOST")
    body = {"TransactionType": event, "ItemNumber": item, "TransactionQuantity": qty}
    request = {"method": "POST", "url": f"{host or '<ORACLE_HOST unset>'}{REST_PATH}",
               "json": body}

    if not host or payload.get("dry_run", False):
        return {"ok": True, "dry_run": True, "request": request}

    from agent_tpu_torch.utils.http import post_json

    try:
        resp = post_json(f"{host}{REST_PATH}", body, timeout=10,
                         auth=(os.environ.get("ORA_USER", ""), os.environ.get("ORA_PASS", "")))
        return {"ok": resp.status_code < 300, "status": resp.status_code, "request": request}
    except (OSError, ValueError) as exc:
        return {"ok": False, "error": f"oracle request failed: {exc}", "request": request}
