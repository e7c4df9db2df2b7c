"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` (the directory is
git-ignored). The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads the existing library. A file lock per
kernel keeps concurrent processes from building the same library twice.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# name -> loaded library, and name -> seconds the build took in this process
# (0.0 when an up-to-date library was found).
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of agent_tpu_torch build with the CUDA toolkit"
    )


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str, so: Path) -> subprocess.Popen:
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every kernel in ``names`` that has no up-to-date library, all
    ``nvcc`` processes at once, and return name -> library path. Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in names}
    locks, procs, t0 = {}, {}, time.perf_counter()
    try:
        for name, so in targets.items():
            lock = open(BUILD_DIR / f"{name}.lock", "w")
            fcntl.flock(lock, fcntl.LOCK_EX)
            locks[name] = lock
            if so.exists():
                BUILD_SECONDS.setdefault(name, 0.0)
            else:
                procs[name] = _start(name, so)
        for name, proc in procs.items():
            log, _ = proc.communicate()
            so = targets[name]
            tmp = so.with_suffix(f".tmp{os.getpid()}.so")
            (BUILD_DIR / f"{name}.nvcc.log").write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log[-4000:]}")
            os.replace(tmp, so)
            BUILD_SECONDS[name] = time.perf_counter() - t0
    finally:
        for lock in locks.values():
            fcntl.flock(lock, fcntl.LOCK_UN)
            lock.close()
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _LIBS[name] = lib
        return lib
