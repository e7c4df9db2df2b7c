"""Checkpoint save and restore for model parameters — counterpart of
``agent_tpu.models.checkpoint`` (``flatten_params``, ``save_npz``,
``params_equal``, and the sharded save/restore).

Two formats:

- ``.npz``: the reference's, one flat file of dotted-key f32 arrays
  (``blocks.0.attn.wq``), the inverse of ``layers.assign_from_npz``, so
  either package loads what the other writes;
- sharded, the port's own, in the role of the reference's Orbax
  ``save_orbax``/``load_orbax``: a directory with one ``.safetensors``
  file per mesh position that holds a distinct set of pieces, each piece
  written as it lives (dtype and the cut of ``parallel.shardings``'
  ``shard_flat``; nothing is gathered), and ``index.json`` (the keys,
  global shapes, dtypes, specs and mesh shape). The process that holds a
  position writes it; process 0 writes the index last, into a temporary
  directory renamed into place, so a failed save leaves the old checkpoint.
  :func:`load_sharded` puts the leaves where ``like``'s live: on the same
  layout each position reads its own file, on another (tp 2 onto tp 4, or
  onto one device) the pieces are put together (``gather_flat``) and cut
  again.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

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


# ---- sharded checkpoints ----

INDEX = "index.json"
FORMAT = "agent_tpu_torch.sharded/1"
Held = Callable[[Dict[str, int]], Dict[str, Any]]


def sharded_available() -> bool:
    """The sharded format needs nothing beyond the port (the reference's
    ``orbax_available`` guards an optional package)."""
    return True


def _layout(obj: Any, specs=None, mesh=None) -> Tuple[Any, Dict[str, int], Dict[str, tuple],
                                                       Held]:
    """``obj``'s placement -> ``(mesh or None, mesh shape, specs, held)``,
    ``held(coords)`` the leaves the position at ``coords`` holds (live
    tensors, or a tree's leaves). A sharded model (``ShardedEncoder``,
    ``ShardedBert``) brings its own; a module is one position; a tree is
    one position, or cut over ``mesh`` by ``specs`` as ``shard_flat`` cuts
    it."""
    from agent_tpu_torch.parallel.shardings import slice_of

    if hasattr(obj, "held") and hasattr(obj, "specs") and hasattr(obj, "mesh"):
        return obj.mesh, dict(obj.mesh.shape), obj.specs, \
            lambda c: obj.held(c.get("dp", 0), c.get("tp", 0), c.get("ep", 0))
    if isinstance(obj, torch.nn.Module):
        if hasattr(obj, "stages"):
            raise TypeError("save_sharded/load_sharded: a pipelined encoder's stages are not "
                            "a shard_flat layout")
        leaves = {n: t for n, t in [*obj.named_parameters(), *obj.named_buffers()]
                  if not t.is_meta}
        return None, {}, {}, lambda c: leaves
    flat = dict(flatten_params(obj))
    if mesh is None:
        return None, {}, {}, lambda c: flat
    shape = dict(mesh.shape)
    specs = specs or {}
    return mesh, shape, specs, lambda c: {k: slice_of(v, specs.get(k, ()), shape, c)
                                          for k, v in flat.items()}


def _split(spec, shape: Dict[str, int], ndim: int) -> Tuple[Optional[str], ...]:
    """A spec as it cuts on ``shape``: one entry a dim, the axis name where
    the dim is split over an axis of size > 1, else None."""
    spec = tuple(spec or ())
    return tuple(a if a is not None and shape.get(a, 1) > 1 else None
                 for a in (spec + (None,) * ndim)[:ndim])


def _written(shape: Dict[str, int], splitting: set) -> List[Tuple[int, Dict[str, int]]]:
    """The positions that hold a distinct set of pieces, ``(index in
    shard_flat's order, coords)``: every coordinate 0 on the axes that
    split no leaf (dp replicas hold what replica 0 holds)."""
    from agent_tpu_torch.parallel.shardings import positions

    if not shape:
        return [(0, {})]
    return [(n, c) for n, c in enumerate(positions(shape))
            if all(v == 0 or a in splitting for a, v in c.items())]


def _file_of(n: int) -> str:
    return f"shard-{n:05d}.safetensors"


def _as_tensor(leaf: Any) -> torch.Tensor:
    return leaf.detach() if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))


def save_sharded(params: Any, path: str, specs=None, mesh=None) -> str:
    """Write ``params`` (a sharded model, a module, or a tree, cut over
    ``mesh`` by ``specs`` when given) to the directory ``path``; returns
    ``path``. Every process of a mesh over several processes calls it: each
    writes the positions it holds, process 0 the index, and the directory
    lands whole or not at all."""
    from agent_tpu_torch.models.safetensors_io import _NAMES, save_file
    from agent_tpu_torch.runtime.distributed import barrier, current

    mesh, shape, specs, held = _layout(params, specs, mesh)
    first = held({a: 0 for a in shape})
    leaves = {}
    for k, t in first.items():
        t = _as_tensor(t)
        cut = _split(specs.get(k), shape, t.dim())
        leaves[k] = {"shape": [d * (shape[a] if a else 1) for d, a in zip(t.shape, cut)],
                     "dtype": _NAMES[t.dtype], "spec": list(cut)}
    splitting = {a for v in leaves.values() for a in v["spec"] if a}
    leader = current().is_leader
    path = os.path.abspath(path)
    tmp = path + ".partial"
    if leader:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    barrier()
    try:
        files = {}
        for n, coords in _written(shape, splitting):
            files[_file_of(n)] = coords
            if not (leader if mesh is None else mesh.is_local(**coords)):
                continue
            save_file({k: _as_tensor(t) for k, t in held(coords).items()},
                      os.path.join(tmp, _file_of(n)))
        barrier()
        if leader:
            with open(os.path.join(tmp, INDEX), "w", encoding="utf-8") as fh:
                json.dump({"format": FORMAT, "mesh_shape": shape, "leaves": leaves,
                           "files": files}, fh)
            old = None
            if os.path.exists(path):
                old = tempfile.mkdtemp(dir=os.path.dirname(path), suffix=".old")
                os.replace(path, os.path.join(old, "ckpt"))
            os.replace(tmp, path)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
    finally:
        if leader:
            shutil.rmtree(tmp, ignore_errors=True)
    barrier()
    return path


def load_sharded(path: str, like: Any) -> Any:
    """Restore the checkpoint at ``path`` into ``like``, in place, and
    return it: a sharded model's leaves at the positions this process
    holds, a module's, or a tree's whole leaves (tensors or numpy arrays),
    each in its own dtype and device. Where a leaf is cut as it was saved,
    each position reads its own file; otherwise the leaf is put together
    from its pieces and cut again."""
    from agent_tpu_torch.models.safetensors_io import load_file
    from agent_tpu_torch.parallel.shardings import gather_flat, positions, slice_of

    with open(os.path.join(path, INDEX), encoding="utf-8") as fh:
        index = json.load(fh)
    if index.get("format") != FORMAT:
        raise ValueError(f"{path}: not a sharded checkpoint of this format")
    saved = index["leaves"]
    s_shape = index["mesh_shape"]
    s_specs = {k: tuple(v["spec"]) for k, v in saved.items()}
    s_splitting = {a for sp in s_specs.values() for a in sp if a}
    files: Dict[str, Dict[str, torch.Tensor]] = {}

    def read(coords: Dict[str, int]) -> Dict[str, torch.Tensor]:
        """The file of the written position at ``coords`` (absent axes 0)."""
        name = next(f for f, c in index["files"].items()
                    if all(v == coords.get(a, 0) for a, v in c.items()))
        if name not in files:
            files[name] = load_file(os.path.join(path, name))
        return files[name]

    mesh, shape, specs, held = _layout(like)
    same_axes = all(shape.get(a, 1) == s_shape.get(a, 1) for a in s_splitting)
    whole: Dict[str, Any] = {}

    def source(k: str, target: Any, coords: Dict[str, int]) -> torch.Tensor:
        cut = _split(specs.get(k), shape,
                     target.dim() if isinstance(target, torch.Tensor) else np.ndim(target))
        if cut == s_specs[k] and all(shape[a] == s_shape.get(a) for a in cut if a):
            # Cut as saved: this position's own file (its dp replica 0's)
            # on the saved layout, else the file of the piece's coords.
            own = s_splitting if same_axes else {a for a in cut if a}
            return read({a: coords.get(a, 0) for a in own})[k]
        if k not in whole:
            whole[k] = gather_flat(lambda c: read(c), {k: s_specs[k]}, s_shape)[k]
        return slice_of(whole[k], cut, shape, coords)

    done = set()  # dp replicas that share a device share their tensors
    for coords in (positions(shape) if shape else [{}]):
        if mesh is not None and not mesh.is_local(**coords):
            continue
        for k, t in held(coords).items():
            if k not in saved:
                raise KeyError(f"{path}: no leaf {k!r}")
            if id(t) in done:
                continue
            done.add(id(t))
            src = source(k, t, coords)
            if isinstance(t, torch.Tensor):
                with torch.no_grad():
                    t.copy_(src)
            else:
                np.copyto(t, src.to(torch.from_numpy(np.empty(0, t.dtype)).dtype).numpy())
    return like

