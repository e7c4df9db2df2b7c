"""Compact binary shard wire ``b1`` — the port's copy of
``agent_tpu.data.wire``. Its bytes are the reference's for the same columns
(``tests/test_torch_wire.py`` holds them byte for byte), since either
package's controller decodes what either package's agent posts.

The lease/result protocol is JSON, and at drain scale the JSON bodies are
the transport cost. This module packs the bulk columns of classify and
summarize task and result payloads into one columnar, length-prefixed,
optionally zlib-compressed blob that rides the JSON wire base64-encoded
under a single ``"__bin__"`` key.

Blob layout (little-endian throughout)::

    magic  b"AW"
    u8     flags            bit0 = body is zlib-compressed
    body   u8 n_cols, then per column:
             u8 name_len, name utf-8
             u8 kind:
               0 json:     u32 len, utf-8 JSON bytes
               1 strings:  u32 count, u32[count] byte lengths, utf-8 concat
               2 ndarray:  u8 dtype code, u8 ndim, u32[ndim] shape,
                           u32 byte len, raw array bytes

Compression is *adaptive* by default: the body is deflated and kept only if
it shrank (random float columns may not compress; repetitive text columns
crush), so the uncompressed fallback is part of the format, not an error.

**Equivalence contract** — the whole point of the codec is that a binary
drain is bit-identical to a JSON drain once decoded:

- string columns round-trip exact UTF-8 (non-ASCII included);
- integer arrays may be width-shrunk on the wire (int32 column whose values
  fit int8 ships 1 byte/value) — ``tolist()`` of any width yields the same
  Python ints JSON would have carried;
- float columns ship their exact bit patterns and decode via ``tolist()``,
  so an op that would have serialized ``np.round(vals, 6).tolist()`` passes
  the *rounded f32 array* here and the decoded floats are the very same
  widened doubles;
- everything that is not a bulk column lumps into one JSON side-channel
  column (name ``""``), serialized with the same ``json`` semantics as the
  plain wire.

Negotiation (the reference's ``controller/PROTOCOL.CONTRACT.md``): agents advertise
``capabilities.wire_formats = ["b1"]``; a binary-capable controller answers
leases with ``wire: "b1"`` and may encode task payloads; the agent then
encodes result columns. Either side staying silent keeps the other on plain
JSON — old controllers and old agents see byte-identical traffic.
"""

from __future__ import annotations

import base64
import json
import struct
import zlib
from typing import Any, Dict, Optional

import numpy as np

FORMAT = "b1"
FORMATS = (FORMAT,)
# The envelope key on the JSON wire. A payload/result dict carrying it is a
# binary envelope; everything else is legacy JSON.
KEY = "__bin__"

MAGIC = b"AW"
_FLAG_ZLIB = 0x01

_K_JSON, _K_STRS, _K_ARR = 0, 1, 2

_DTYPES = (
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "float32", "float64",
)
_DTYPE_CODE = {np.dtype(d): i for i, d in enumerate(_DTYPES)}

# Ops whose task payloads the controller may binary-encode (their bulk
# column is ``texts``). Results self-select: ops attach columns only for
# their own shard-shaped outputs.
ENCODABLE_OPS = frozenset({"map_classify_tpu", "map_summarize"})


def _shrink_int(arr: np.ndarray) -> np.ndarray:
    """Smallest signed width that holds the values (wire-only: ``tolist()``
    of any int width yields the same Python ints)."""
    if arr.dtype.kind not in "iu" or arr.size == 0:
        return arr
    lo, hi = int(arr.min()), int(arr.max())
    for cand in (np.int8, np.int16, np.int32, np.int64):
        info = np.iinfo(cand)
        if info.min <= lo and hi <= info.max:
            if np.dtype(cand).itemsize >= arr.dtype.itemsize:
                return arr  # never widen (uint8 must not become int16)
            return arr.astype(cand)
    return arr  # uint64 beyond int64 range keeps its own dtype


def encode_blob(cols: Dict[str, Any], compress: Optional[bool] = None) -> bytes:
    """Pack ``cols`` into one blob. Values: ``np.ndarray`` → array column,
    ``list[str]`` → string column, anything else → JSON column.
    ``compress``: None = adaptive (keep zlib only if smaller), True/False
    force. Raises ValueError on unsupported dtypes / oversized names."""
    if len(cols) > 255:
        raise ValueError(f"too many columns ({len(cols)})")
    body = bytearray()
    body += struct.pack("<B", len(cols))
    for name, value in cols.items():
        nb = str(name).encode("utf-8")
        if len(nb) > 255:
            raise ValueError(f"column name too long ({len(nb)} bytes)")
        body += struct.pack("<B", len(nb))
        body += nb
        if isinstance(value, np.ndarray):
            arr = _shrink_int(np.ascontiguousarray(value))
            code = _DTYPE_CODE.get(arr.dtype)
            if code is None:
                raise ValueError(f"unsupported array dtype {arr.dtype}")
            if arr.ndim > 255:
                raise ValueError("array rank > 255")
            data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
            body += struct.pack("<BBB", _K_ARR, code, arr.ndim)
            body += struct.pack(f"<{arr.ndim}I", *arr.shape)
            body += struct.pack("<I", len(data))
            body += data
        elif isinstance(value, list) and all(
            isinstance(t, str) for t in value
        ):
            encoded = [t.encode("utf-8") for t in value]
            body += struct.pack("<BI", _K_STRS, len(encoded))
            body += np.fromiter(
                (len(b) for b in encoded), dtype="<u4", count=len(encoded)
            ).tobytes()
            body += b"".join(encoded)
        else:
            data = json.dumps(value, separators=(",", ":")).encode("utf-8")
            body += struct.pack("<BI", _K_JSON, len(data))
            body += data
    raw = bytes(body)
    flags = 0
    out = raw
    if compress is not False:
        z = zlib.compress(raw, 6)
        if compress is True or len(z) < len(raw):
            out, flags = z, _FLAG_ZLIB
    return MAGIC + struct.pack("<B", flags) + out


def decode_blob(blob: bytes) -> Dict[str, Any]:
    """Inverse of :func:`encode_blob`, producing JSON-able values (arrays
    come back as nested lists via ``tolist()`` — the decoded dict is exactly
    what the plain JSON wire would have carried). Raises ValueError on any
    malformed input (bad magic, truncation, bad zlib, bad UTF-8)."""
    try:
        if blob[:2] != MAGIC:
            raise ValueError("bad magic")
        flags = blob[2]
        body = blob[3:]
        if flags & _FLAG_ZLIB:
            body = zlib.decompress(body)
        view = memoryview(body)
        pos = 0

        def take(n: int) -> memoryview:
            nonlocal pos
            if pos + n > len(view):
                raise ValueError("truncated blob")
            out = view[pos:pos + n]
            pos += n
            return out

        (n_cols,) = struct.unpack("<B", take(1))
        cols: Dict[str, Any] = {}
        for _ in range(n_cols):
            (name_len,) = struct.unpack("<B", take(1))
            name = bytes(take(name_len)).decode("utf-8")
            (kind,) = struct.unpack("<B", take(1))
            if kind == _K_JSON:
                (n,) = struct.unpack("<I", take(4))
                cols[name] = json.loads(bytes(take(n)).decode("utf-8"))
            elif kind == _K_STRS:
                (count,) = struct.unpack("<I", take(4))
                lens = np.frombuffer(take(4 * count), dtype="<u4")
                total = int(lens.sum())
                data = bytes(take(total))
                out, off = [], 0
                for ln in lens.tolist():
                    out.append(data[off:off + ln].decode("utf-8"))
                    off += ln
                cols[name] = out
            elif kind == _K_ARR:
                code, ndim = struct.unpack("<BB", take(2))
                if code >= len(_DTYPES):
                    raise ValueError(f"unknown dtype code {code}")
                shape = struct.unpack(f"<{ndim}I", take(4 * ndim))
                (n,) = struct.unpack("<I", take(4))
                arr = np.frombuffer(
                    take(n), dtype=np.dtype(_DTYPES[code]).newbyteorder("<")
                ).reshape(shape)
                cols[name] = arr.tolist()
            else:
                raise ValueError(f"unknown column kind {kind}")
        return cols
    except ValueError:
        raise
    except Exception as exc:  # zlib.error, struct.error, Unicode errors, …
        raise ValueError(f"malformed wire blob: {exc}") from exc


def pack_b64(cols: Dict[str, Any], compress: Optional[bool] = None) -> str:
    """Blob → the base64 ASCII string that rides the JSON wire."""
    return base64.b64encode(encode_blob(cols, compress)).decode("ascii")


def unpack_b64(data: str) -> Dict[str, Any]:
    if not isinstance(data, str):
        raise ValueError("wire envelope payload must be a base64 string")
    try:
        blob = base64.b64decode(data.encode("ascii"), validate=True)
    except Exception as exc:  # noqa: BLE001 — binascii.Error, UnicodeError
        raise ValueError(f"bad base64 envelope: {exc}") from exc
    return decode_blob(blob)


# ---- task payloads (controller → agent) ----


def encodable_task(op: str, payload: Any) -> bool:
    """Should the controller binary-encode this task's payload? Only the
    text ops, and only when the payload actually carries a bulk ``texts``
    column (shard-addressed ``source_uri`` payloads are already tiny)."""
    if op not in ENCODABLE_OPS or not isinstance(payload, dict):
        return False
    texts = payload.get("texts")
    return (
        isinstance(texts, list)
        and bool(texts)
        and all(isinstance(t, str) for t in texts)
    )


def encode_task_payload(payload: Dict[str, Any]) -> Dict[str, Any]:
    """``{texts: […], **rest}`` → ``{"__bin__": <b64>}``. The non-bulk keys
    ride the JSON side-channel column, so the decoded payload is value-equal
    to the original."""
    rest = {k: v for k, v in payload.items() if k != "texts"}
    return {KEY: pack_b64({"texts": payload["texts"], "": rest})}


def is_binary_payload(payload: Any) -> bool:
    return isinstance(payload, dict) and isinstance(payload.get(KEY), str)


def decode_task_payload(payload: Dict[str, Any]) -> Dict[str, Any]:
    """A controller-encoded task payload (``{"__bin__": <b64>}``: the bulk
    ``texts`` column plus the other keys in the JSON side column) -> the
    plain payload; raises ValueError on a malformed envelope (the agent
    reports it like any malformed task)."""
    cols = unpack_b64(payload[KEY])
    out: Dict[str, Any] = {}
    rest = cols.pop("", None)
    if isinstance(rest, dict):
        out.update(rest)
    out.update(cols)
    return out


# ---- results (agent → controller) ----


def attach_result_columns(
    result: Dict[str, Any],
    cols: Dict[str, Any],
    compress: Optional[bool] = None,
) -> Dict[str, Any]:
    """Op-finalize fast path: hand the bulk columns over as raw arrays /
    string lists instead of ``tolist()``-ing them into the JSON body. The
    decoded result merges the columns back under their own keys."""
    result[KEY] = pack_b64(cols, compress)
    return result


def is_binary_result(result: Any) -> bool:
    return isinstance(result, dict) and isinstance(result.get(KEY), str)


def decode_result(result: Dict[str, Any]) -> Dict[str, Any]:
    """Controller-side decode: the stored result is exactly what a JSON-wire
    agent would have posted (envelope key dropped, columns merged)."""
    cols = unpack_b64(result[KEY])
    out = {k: v for k, v in result.items() if k != KEY}
    rest = cols.pop("", None)
    if isinstance(rest, dict):
        out.update(rest)
    out.update(cols)
    return out
