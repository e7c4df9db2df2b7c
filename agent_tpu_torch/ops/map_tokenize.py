"""Tokenize op — counterpart of ``agent_tpu.ops.map_tokenize``.

- ``text``/``data`` single-string mode and ``items`` list mode, with
  flattened chunks and per-item counts.
- ``mode: "chars"``: fixed-size character windows (default
  ``chunk_size`` 1024), with the reference wire's aliases (``tokens``,
  ``count``, ``total_chars``, ``n_chars`` / ``items_count``).
- ``mode: "tokens"`` (the default): the byte tokenizer, ``tokenizer:
  "wordpiece"`` with a local ``vocab_path`` (a vocab.txt), or ``tokenizer:
  "bpe"`` with a local ``vocab_path`` directory (vocab.json + merges.txt,
  e.g. an HF BART checkpoint's; ids equal the reference's), chunking the
  token stream into windows of ``chunk_size`` ids.
- Validation errors come back as ``{"ok": False, "error": ...}``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from agent_tpu_torch.ops import register_op
from agent_tpu_torch.utils.errors import bad_input

DEFAULT_CHUNK_SIZE = 1024


def _chunks(seq, size: int) -> List:
    return [seq[i: i + size] for i in range(0, len(seq), size)] or [seq[:0]]


@register_op("map_tokenize")
def run(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    if not isinstance(payload, dict):
        return bad_input("payload must be a dict")

    chunk_size = payload.get("chunk_size", DEFAULT_CHUNK_SIZE)
    if not isinstance(chunk_size, int) or chunk_size <= 0:
        return bad_input("chunk_size must be a positive int")
    mode = payload.get("mode", "tokens")
    if mode not in ("tokens", "chars"):
        return bad_input(f"unknown mode {mode!r} (expected 'tokens' or 'chars')")

    if "items" in payload:
        items = payload["items"]
        if not isinstance(items, list) or not all(isinstance(t, str) for t in items):
            return bad_input("items must be a list of strings")
        single = False
    else:
        text = payload.get("text", payload.get("data"))
        if not isinstance(text, str):
            return bad_input("payload requires 'text'/'data' string or 'items' list")
        items = [text]
        single = True

    if mode == "chars":
        per_item = [_chunks(t, chunk_size) for t in items]
        flat = [c for cs in per_item for c in cs]
        out: Dict[str, Any] = {
            "ok": True,
            "mode": "chars",
            "chunk_size": chunk_size,
            "chunks": flat,
            "counts": [len(cs) for cs in per_item],
            "n_items": len(items),
            "n_chunks": len(flat),
            "tokens": flat,
            "count": len(flat),
            "total_chars": sum(len(t) for t in items),
        }
        if single:
            out["n_chars"] = len(items[0])
        else:
            out["items_count"] = len(items)
        return out

    from agent_tpu_torch.models.tokenizer import get_tokenizer

    try:
        tok = get_tokenizer(payload.get("tokenizer", "byte"), payload.get("vocab_path"))
    except (ValueError, OSError) as exc:
        return bad_input(str(exc))
    try:
        encoded = [tok.encode(t) for t in items]
    except KeyError as exc:
        # An inconsistent vocab/merges pair is caller input, not a crash.
        return bad_input(f"vocab is missing token {exc} (inconsistent "
                         "vocab.json/merges.txt?)")
    per_item = [_chunks(ids, chunk_size) for ids in encoded]
    flat = [c for cs in per_item for c in cs]
    return {
        "ok": True,
        "mode": "tokens",
        "tokenizer": payload.get("tokenizer", "byte"),
        "vocab_size": tok.vocab_size,
        "chunk_size": chunk_size,
        "chunks": flat,
        "counts": [len(cs) for cs in per_item],
        "token_counts": [len(ids) for ids in encoded],
        "n_items": len(items),
        "n_chunks": len(flat),
        "n_tokens": sum(len(ids) for ids in encoded),
    }
