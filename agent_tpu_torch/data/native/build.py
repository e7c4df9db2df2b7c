"""Lazy g++ build and ctypes load of the native CSV scanner — the port's own
copy of ``agent_tpu.data.native.build``.

The shared object compiles once per source change into ``_build/`` beside
the source (git-ignored; nothing outside the checkout is written), named by
a hash of ``csv_scan.cpp`` so an edit rebuilds and a stale binary never
loads. Everything is best-effort: no compiler, a failed compile or a failed
load all mean "return None", and the caller uses the numpy scanner
(``csv_index._scan_row_offsets_py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csv_scan.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> Optional[str]:
    """Compile csv_scan.cpp -> the cached .so; returns its path or None."""
    gxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if gxx is None or not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"csv_scan_{digest}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc = subprocess.run(
            [gxx, "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
            capture_output=True,
            timeout=120,
        )
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
        return out
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        so = _build()
        if so is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.csv_scan_offsets.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ]
            lib.csv_scan_offsets.restype = ctypes.c_int64
            lib.csv_scan_free.argtypes = [ctypes.POINTER(ctypes.c_int64)]
            lib.csv_scan_free.restype = None
            _lib = lib
        except OSError:
            _load_failed = True
        return _lib


def scan_row_offsets_native(path: str) -> Optional[np.ndarray]:
    """Row-start offsets via the C++ scanner, or None to use the numpy path."""
    lib = _get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_int64)()
    n = lib.csv_scan_offsets(os.fsencode(path), ctypes.byref(out))
    if n < 0:
        return None
    try:
        return np.ctypeslib.as_array(out, shape=(n,)).astype(np.int64, copy=True)
    finally:
        lib.csv_scan_free(out)


def native_available() -> bool:
    return _get_lib() is not None
