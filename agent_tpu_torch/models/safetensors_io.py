"""The ``.safetensors`` checkpoint format, read and written without the
``safetensors`` package (which the card's machine does not have).

A file is an 8-byte little-endian header length N, then N bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`` (padded with spaces), then the tensors' raw little-endian bytes,
offsets counted from the end of the header. :func:`load_file` maps the file
copy-on-write and gives each tensor a ``torch.frombuffer`` view of its bytes,
so reading a checkpoint copies nothing until a tensor is converted or moved;
a header that does not describe the file raises :class:`SafetensorsError`.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional

import torch

# The format's dtype names -> torch dtypes (the file is little-endian, as the
# hosts this runs on are).
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# A header longer than this is not a checkpoint's (safetensors' own limit).
MAX_HEADER_BYTES = 100_000_000


class SafetensorsError(RuntimeError):
    """The file is not a well-formed ``.safetensors`` file: a corrupt
    checkpoint, which fails the request (a retryable integrity error, not
    the caller's bad input)."""


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file at ``path``, by name, on the CPU."""
    with open(path, "rb") as f:
        try:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        except ValueError as exc:  # an empty file cannot be mapped
            raise SafetensorsError(f"{path}: empty file") from exc
    size = len(buf)
    if size < 8:
        raise SafetensorsError(f"{path}: {size} bytes, shorter than the header length")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > MAX_HEADER_BYTES or 8 + n > size:
        raise SafetensorsError(f"{path}: header length {n} does not fit the file's "
                               f"{size} bytes")
    try:
        header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise SafetensorsError(f"{path}: header is not JSON: {exc}") from exc
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    start, data_bytes = 8 + n, size - 8 - n
    out: Dict[str, torch.Tensor] = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = DTYPES[entry["dtype"]]
            shape = [int(s) for s in entry["shape"]]
            begin, end = (int(o) for o in entry["data_offsets"])
        except (KeyError, TypeError, ValueError) as exc:
            raise SafetensorsError(f"{path}: bad header entry {name!r}: {entry!r}") from exc
        nbytes = _numel(shape) * torch.empty((), dtype=dtype).element_size()
        if min(shape, default=0) < 0 or not 0 <= begin <= end <= data_bytes \
                or end - begin != nbytes:
            raise SafetensorsError(f"{path}: {name!r} {entry['dtype']}{shape} does not "
                                   f"match its offsets [{begin}, {end}] in {data_bytes} "
                                   "bytes of data")
        if nbytes == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=_numel(shape),
                                         offset=start + begin).view(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; contiguous copies are taken on the CPU)
    to ``path`` in the format :func:`load_file` reads."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                        .numpy().tobytes())


def load_hf_weights(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a local HF checkpoint directory, in the reference
    loaders' order: ``model.safetensors`` (read by :func:`load_file`), else
    ``pytorch_model.bin`` (``torch.load`` with ``weights_only=True``,
    memory-mapped); FileNotFoundError when the directory has neither."""
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        return load_file(st_path)
    bin_path = os.path.join(path, "pytorch_model.bin")
    if not os.path.exists(bin_path):
        raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under {path}")
    return torch.load(bin_path, map_location="cpu", weights_only=True, mmap=True)
