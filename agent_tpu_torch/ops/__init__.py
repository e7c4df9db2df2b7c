"""Op registry and dispatch — counterpart of ``agent_tpu.ops``.

``register_op(name)`` fills the registry when an op module is imported; op
modules load lazily on first ``get_op`` and import failures are recorded in
``OPS_LOAD_ERRORS``, never raised at package import. The ``TASKS``
environment variable gates which ops are visible (``*``/``all`` = all,
``none`` = none, unset = all).

Op call contract: ``fn(payload: dict, ctx: OpContext | None = None) -> dict``.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

OpFn = Callable[..., Dict[str, Any]]

OPS_REGISTRY: Dict[str, OpFn] = {}
OPS_LOAD_ERRORS: List[Tuple[str, str]] = []

# Op name -> submodule of agent_tpu_torch.ops: every op name the reference registers.
OP_TO_MODULE: Dict[str, str] = {
    "echo": "echo",
    "map_tokenize": "map_tokenize",
    "read_csv_shard": "csv_shard",
    "trigger_sap": "trigger_sap",
    "trigger_oracle": "trigger_oracle",
    "risk_accumulate": "risk_accumulate",
    "map_classify_tpu": "map_classify_tpu",
    "map_summarize": "map_summarize",
    "train_classifier": "train_classifier",
    "serve_classify": "serve_infer",
    "serve_summarize": "serve_infer",
    "serve_prefill": "serve_infer",
    "serve_decode": "serve_infer",
    "summarize_encode": "summarize_mpmd",
    "summarize_decode": "summarize_mpmd",
}

# The ops that need a device runtime: an agent serving any of them builds
# the runtime at start (and fails there without CUDA); an agent of the other
# ops, which run on the host, never builds one. serve_classify reaches the
# runtime through map_classify_tpu.
DEVICE_OPS = frozenset({"map_classify_tpu", "map_summarize", "train_classifier",
                        "serve_classify", "serve_summarize", "serve_prefill", "serve_decode",
                        "summarize_encode", "summarize_decode"})

_imported: Dict[str, bool] = {}
_lock = threading.Lock()


def register_op(name: str) -> Callable[[OpFn], OpFn]:
    def deco(fn: OpFn) -> OpFn:
        OPS_REGISTRY[name] = fn
        return fn

    return deco


def _parse_tasks_env(raw: Optional[str] = None) -> Optional[List[str]]:
    """TASKS env -> enabled-op filter; None means all enabled."""
    if raw is None:
        raw = os.environ.get("TASKS", "")
    toks = [t.strip() for t in raw.split(",") if t.strip()]
    if not toks:
        return None
    low = [t.lower() for t in toks]
    if "*" in toks or "all" in low:
        return None
    if low == ["none"]:
        return []
    return toks


def list_ops() -> List[str]:
    """All known op names, filtered by the TASKS gate."""
    enabled = _parse_tasks_env()
    names = sorted(OP_TO_MODULE)
    return names if enabled is None else [n for n in names if n in enabled]


def _import_op_module(module: str) -> None:
    with _lock:
        if _imported.get(module):
            return
        try:
            importlib.import_module(f"agent_tpu_torch.ops.{module}")
            _imported[module] = True
        except Exception as exc:  # noqa: BLE001 — recorded, reported by get_op
            OPS_LOAD_ERRORS.append((module, repr(exc)))
            _imported[module] = False


def get_op(name: str) -> OpFn:
    """Resolve an op name to its handler, or raise ``KeyError`` saying why."""
    enabled = _parse_tasks_env()
    if enabled is not None and name not in enabled:
        raise KeyError(
            f"op {name!r} is not enabled by TASKS={os.environ.get('TASKS', '')!r}; "
            f"enabled ops: {list_ops()}"
        )
    module = OP_TO_MODULE.get(name)
    if module is None:
        raise KeyError(f"unknown op {name!r}; known ops: {sorted(OP_TO_MODULE)}")
    _import_op_module(module)
    fn = OPS_REGISTRY.get(name)
    if fn is None:
        errs = "; ".join(f"{m}: {e}" for m, e in OPS_LOAD_ERRORS[:10])
        raise KeyError(
            f"op {name!r} did not register (module {module!r}). "
            f"import errors: {errs or 'none'}"
        )
    return fn


def load_ops(tasks: List[str]) -> Dict[str, OpFn]:
    """Resolve a list of op names; raise early on any unknown/disabled name."""
    return {name: get_op(name) for name in tasks}
