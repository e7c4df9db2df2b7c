"""Checkpoint save for model parameters — the ``.npz`` half of
``agent_tpu.models.checkpoint`` (``flatten_params``, ``save_npz``,
``params_equal``).

The format is the reference's: one flat ``.npz`` of dotted-key f32 arrays
(``blocks.0.attn.wq``), the inverse of ``layers.assign_from_npz``, so
either package loads what the other writes. Orbax's sharded save has no
counterpart here yet.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, List, Tuple

import numpy as np
import torch


def _key_order(key: str) -> tuple:
    """Sort key matching the reference's tree walk: dict keys sorted, list
    indices in numeric order."""
    return tuple(int(p) if p.isdigit() else p for p in key.split("."))


def flatten_params(params: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """Param tree (nested dicts/lists of arrays or tensors) or an encoder
    (a module, or sharded over a mesh) -> ``[('blocks.0.attn.wq', leaf),
    ...]`` in the reference's deterministic order."""
    if hasattr(params, "to_flat_numpy"):
        flat = params.to_flat_numpy()
        return [(k, flat[k]) for k in sorted(flat, key=_key_order)]
    out: List[Tuple[str, Any]] = []
    if isinstance(params, dict):
        for k in sorted(params):
            out.extend(flatten_params(params[k], f"{prefix}{k}."))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.extend(flatten_params(v, f"{prefix}{i}."))
    else:
        out.append((prefix[:-1], params))
    return out


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_npz(params: Any, path: str) -> str:
    """Write params (a module or a tree) to ``path`` as a flat ``.npz``;
    returns ``path``. Device tensors are copied to the host. The write is
    atomic (temp file + rename), so a crash never leaves a half-written
    artifact at a path an op might load."""
    flat = {k: _to_numpy(v) for k, v in flatten_params(params)}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def params_equal(a: Any, b: Any, atol: float = 0.0) -> bool:
    """Exact (or atol-bounded) leaf-wise equality of two param trees or
    modules: same keys in the same order, same shapes, close values."""
    fa, fb = flatten_params(a), flatten_params(b)
    if [k for k, _ in fa] != [k for k, _ in fb]:
        return False
    for (_, va), (_, vb) in zip(fa, fb):
        va, vb = _to_numpy(va), _to_numpy(vb)
        if va.shape != vb.shape or not np.allclose(va, vb, rtol=0.0, atol=atol):
            return False
    return True
