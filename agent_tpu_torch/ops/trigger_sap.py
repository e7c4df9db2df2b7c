"""SAP S/4HANA Quality Notification webhook op — counterpart of
``agent_tpu.ops.trigger_sap``: posts an OData Quality Notification built
from ``{event_type, material, text}``, with credentials from
SAP_HOST/SAP_USER/SAP_PASS. With no SAP_HOST, or ``dry_run: true``, it
returns the request it would send. The post goes through the standard
library (``utils.http``), not ``requests``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from agent_tpu_torch.ops import register_op
from agent_tpu_torch.utils.errors import bad_input

ODATA_PATH = "/sap/opu/odata/sap/API_QUALITYNOTIFICATION_SRV/A_QualityNotification"


@register_op("trigger_sap")
def run(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    if not isinstance(payload, dict):
        return bad_input("payload must be a dict")
    event_type = payload.get("event_type", "quality_alert")
    material = payload.get("material")
    text = payload.get("text", "")
    if not isinstance(material, str) or not material:
        return bad_input("material is required and must be a non-empty string")

    host = os.environ.get("SAP_HOST")
    body = {
        "NotificationType": "Q1" if event_type == "quality_alert" else "Q2",
        "Material": material,
        "NotificationText": str(text)[:40],  # S/4 short-text limit
    }
    request = {"method": "POST", "url": f"{host or '<SAP_HOST unset>'}{ODATA_PATH}", "json": body}

    if not host or payload.get("dry_run", False):
        return {"ok": True, "dry_run": True, "request": request}

    from agent_tpu_torch.utils.http import post_json

    try:
        resp = post_json(f"{host}{ODATA_PATH}", body, timeout=10,
                         auth=(os.environ.get("SAP_USER", ""), os.environ.get("SAP_PASS", "")))
        return {"ok": resp.status_code < 300, "status": resp.status_code, "request": request}
    except (OSError, ValueError) as exc:
        return {"ok": False, "error": f"sap request failed: {exc}", "request": request}
