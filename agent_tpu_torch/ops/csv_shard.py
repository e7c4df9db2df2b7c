"""CSV shard op ``read_csv_shard`` — counterpart of ``agent_tpu.ops.csv_shard``,
the swarm's data-distribution primitive.

- Accepts the payload directly or wrapped in a task dict under ``payload``.
- Payload: ``source_uri`` (required), ``start_row`` (default 0),
  ``shard_size`` (default 100), ``mode`` in ``rows`` | ``count``, and an
  optional ``dataset_id`` echoed back.
- Bad input comes back as a soft ``{"ok": False, "error"}``.

Shards are byte-range reads over the cached quote-aware row index
(``agent_tpu_torch.data.csv_index``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from agent_tpu_torch.data.csv_index import CsvIndex, resolve_shard_payload
from agent_tpu_torch.ops import register_op
from agent_tpu_torch.utils.errors import bad_input


@register_op("read_csv_shard")
def run(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    from agent_tpu_torch.ops._model_common import stamp_rows

    if isinstance(payload, dict) and isinstance(payload.get("payload"), dict):
        payload = payload["payload"]  # task-wrapped form
    if not isinstance(payload, dict):
        return bad_input("payload must be a dict")
    try:
        path, start_row, shard_size = resolve_shard_payload(payload)
    except ValueError as exc:
        return bad_input(str(exc))
    source_uri = payload["source_uri"]

    mode = payload.get("mode", "rows")
    if mode not in ("rows", "count"):
        return bad_input(f"mode must be 'rows' or 'count', got {mode!r}")
    try:
        index = CsvIndex.for_file(path)
    except OSError as exc:
        return bad_input(f"cannot open {source_uri!r}: {exc}")

    dataset_id = payload.get("dataset_id", "unknown_dataset")
    total = index.n_data_rows
    if mode == "count":
        in_range = max(0, min(shard_size, total - start_row))
        stamp_rows(ctx, in_range)
        return {
            "ok": True,
            "mode": "count",
            "dataset_id": dataset_id,
            "source_uri": source_uri,
            "start_row": start_row,
            "end_row": start_row + in_range,
            "shard_size": shard_size,
            "count": in_range,
            "row_count": in_range,
            "total_rows": total,
        }

    rows = index.read_dict_rows(start_row, shard_size)
    stamp_rows(ctx, len(rows))
    return {
        "ok": True,
        "mode": "rows",
        "dataset_id": dataset_id,
        "source_uri": source_uri,
        "start_row": start_row,
        "end_row": start_row + len(rows),
        "shard_size": shard_size,
        "rows": rows,
        "count": len(rows),
        "row_count": len(rows),
        "total_rows": total,
    }
