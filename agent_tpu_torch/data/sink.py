"""Result-sink utilities — the port's copy of ``agent_tpu.data.sink``:
validate and merge the JSONL shard files the model ops write in
``output_uri`` mode.

A drain leaves ``<op>_rows_<start_row>.jsonl`` files behind (one per shard,
line ``k`` = dataset row ``start_row + k``; see ``_model_common.
write_output_shard``). These helpers are the consumer side of that contract:

- :func:`scan_sink` — inventory a sink directory for one op.
- :func:`validate_sink` — prove the drain is complete: shard starts form the
  expected arithmetic progression, no gaps, no overlaps, per-file row counts
  sum to ``total_rows``.
- :func:`merge_sink` — concatenate the shards into one JSONL in dataset row
  order (streaming; never holds more than one shard in memory).

Also runnable as a CLI:

    python -m agent_tpu_torch.data.sink validate <dir> --op map_summarize \
        --total-rows 10000000
    python -m agent_tpu_torch.data.sink merge <dir> --op map_summarize \
        --out merged.jsonl
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

_SHARD_RE = re.compile(r"^(?P<op>.+)_rows_(?P<start>\d{12})\.jsonl$")


@dataclass(frozen=True)
class SinkShard:
    path: str
    start_row: int
    n_rows: int


def scan_sink(directory: str, op: str) -> List[SinkShard]:
    """Shard files for ``op`` under ``directory``, sorted by start_row.
    Row counts come from counting lines (the receipts hold the same number;
    the file is the source of truth here)."""
    shards: List[SinkShard] = []
    for name in os.listdir(directory):
        m = _SHARD_RE.match(name)
        if not m or m.group("op") != op:
            continue
        path = os.path.join(directory, name)
        with open(path, "rb") as f:
            n = sum(1 for _ in f)
        shards.append(SinkShard(path, int(m.group("start")), n))
    return sorted(shards, key=lambda s: s.start_row)


def validate_sink(
    directory: str, op: str, total_rows: Optional[int] = None,
    shards: Optional[List[SinkShard]] = None,
) -> Dict[str, object]:
    """Completeness proof for a drained sink → summary dict.

    Raises ValueError naming the first problem: a gap (missing shard), an
    overlap (a shard wrote more rows than the next shard's start allows),
    or a total mismatch. A retried shard is fine — atomic writes mean the
    file holds exactly one shard's rows. ``shards`` lets a caller that
    already scanned (``merge_sink``) validate that exact list — no rescan,
    no window for the file set to change between validation and use.
    """
    if shards is None:
        shards = scan_sink(directory, op)
    if not shards:
        raise ValueError(f"no {op!r} shard files in {directory}")
    if shards[0].start_row != 0:
        raise ValueError(
            f"first shard starts at row {shards[0].start_row}, expected 0"
        )
    expect = 0
    for s in shards:
        if s.start_row > expect:
            raise ValueError(
                f"gap: rows [{expect}, {s.start_row}) missing "
                f"(no shard file before {os.path.basename(s.path)})"
            )
        if s.start_row < expect:
            raise ValueError(
                f"overlap at {os.path.basename(s.path)}: starts at "
                f"{s.start_row} but previous shard covered up to {expect}"
            )
        expect = s.start_row + s.n_rows
    if total_rows is not None and expect != total_rows:
        raise ValueError(
            f"row total mismatch: shards cover {expect} rows, "
            f"expected {total_rows}"
        )
    return {
        "op": op,
        "shards": len(shards),
        "rows": expect,
        "first": shards[0].start_row,
        "last": shards[-1].start_row,
    }


def merge_sink(
    directory: str, op: str, out_path: str,
    total_rows: Optional[int] = None,
) -> Dict[str, object]:
    """Validate then concatenate the shards in dataset row order into
    ``out_path`` (atomic: tmp + rename). One scan: the validated list is
    the list that gets copied (streamed shard by shard)."""
    shards = scan_sink(directory, op)
    summary = validate_sink(directory, op, total_rows, shards=shards)
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as out:
        for shard in shards:
            with open(shard.path, "rb") as f:
                for line in f:
                    out.write(line)
    os.replace(tmp, out_path)
    summary["out"] = out_path
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("validate", "merge"):
        p = sub.add_parser(name)
        p.add_argument("directory")
        p.add_argument("--op", required=True)
        p.add_argument("--total-rows", type=int, default=None)
        if name == "merge":
            p.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    try:
        if args.cmd == "validate":
            out = validate_sink(args.directory, args.op, args.total_rows)
        else:
            out = merge_sink(args.directory, args.op, args.out,
                             args.total_rows)
    except ValueError as exc:
        print(json.dumps({"ok": False, "error": str(exc)}))
        return 1
    print(json.dumps({"ok": True, **out}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
