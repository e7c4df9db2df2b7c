"""Op registry and dispatch — counterpart of ``agent_tpu.ops``.

``register_op(name)`` fills the registry when an op module is imported; op
modules load lazily on first ``get_op`` and import failures are recorded in
``OPS_LOAD_ERRORS``, never raised at package import. The ``TASKS``
environment variable gates which ops are visible (``*``/``all`` = all,
``none`` = none, unset = all). ``OPS_PLUGIN_PATH`` names extra op files
(``:``-separated) that ``load_ops`` loads once, before it resolves names.

Op call contract: ``fn(payload: dict, ctx: OpContext | None = None) -> dict``.
"""

from __future__ import annotations

import importlib
import importlib.util
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

# Deterministic ops whose results may be served from the content-addressed
# result cache (``flow.result_cache``): same payload + model version =>
# bit-identical result dict. Excluded on purpose: ``read_csv_shard`` (reads
# mutable files behind a URI), the ERP triggers (external side effects),
# ``train_classifier`` (writes an artifact), and the decode-side serving ops
# (their payloads embed per-request ids).
CACHEABLE_OPS = frozenset({"echo", "map_tokenize", "map_classify_tpu", "map_summarize",
                           "summarize_encode", "summarize_decode", "risk_accumulate"})


def is_cacheable(name: str) -> bool:
    """True when ``name`` is registered as deterministic/cache-safe."""
    return name in CACHEABLE_OPS


_imported: Dict[str, bool] = {}
_lock = threading.Lock()
_plugins_loaded = False


def register_op(name: str) -> Callable[[OpFn], OpFn]:
    def deco(fn: OpFn) -> OpFn:
        OPS_REGISTRY[name] = fn
        return fn

    return deco


def load_plugins(paths: Optional[str] = None) -> List[str]:
    """Load extra op modules from ``OPS_PLUGIN_PATH`` (``:``-separated files).

    Each path is executed as a module; its ``register_op`` decorations land
    in the registry and in ``OP_TO_MODULE``, so the TASKS gate and
    ``list_ops`` see them. Missing files and import errors are recorded in
    ``OPS_LOAD_ERRORS``, never raised: the agent boots without its plugins.
    With ``paths`` None the environment is read, once per process.

    Returns the op names newly registered by plugins.
    """
    global _plugins_loaded
    raw = paths if paths is not None else os.environ.get("OPS_PLUGIN_PATH", "")
    if paths is None:
        with _lock:
            if _plugins_loaded:
                return []
            _plugins_loaded = True
    new_names: List[str] = []
    for path in [p for p in (raw or "").split(":") if p.strip()]:
        before = set(OPS_REGISTRY)
        try:
            spec = importlib.util.spec_from_file_location(
                f"agent_tpu_torch_plugin_{abs(hash(path)) & 0xFFFF:04x}", path)
            if spec is None or spec.loader is None:
                raise ImportError(f"cannot load plugin {path!r}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception as exc:  # noqa: BLE001 — recorded, not raised
            OPS_LOAD_ERRORS.append((f"plugin:{path}", repr(exc)))
            # An op registered by a plugin that then failed would sit in the
            # registry with no OP_TO_MODULE entry: registered but unreachable.
            for name in set(OPS_REGISTRY) - before:
                if name not in OP_TO_MODULE:
                    del OPS_REGISTRY[name]
            continue
        for name in set(OPS_REGISTRY) - before:
            if name in OP_TO_MODULE:
                # A builtin registered by the plugin's own imports keeps its
                # builtin module.
                continue
            OP_TO_MODULE[name] = f"plugin:{path}"
            _imported[f"plugin:{path}"] = True
            new_names.append(name)
    return new_names


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
    """Resolve a list of op names; raise early on any unknown/disabled name.
    ``OPS_PLUGIN_PATH``'s ops join the registry first (once)."""
    load_plugins()
    return {name: get_op(name) for name in tasks}
