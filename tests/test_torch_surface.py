"""The port's surface against the reference's, name by name.

Every module under ``agent_tpu/`` is parsed with ``ast`` (never imported):
its public top-level functions, classes, class methods and UPPER_CASE
constants, and every environment variable it reads (``os.environ``,
``os.getenv``, the ``env_*`` helpers). Each must have a counterpart in
``agent_tpu_torch`` (the same module path and name, or a mapping written
below) or a ``NOT_PORTED`` entry with its reason. A second walk maps each
script in ``scripts/`` that imports ``agent_tpu`` to its counterpart in the
repo, or to ``ROADMAP.md``'s queue of scripts still to port.
"""

from __future__ import annotations

import ast
import importlib
import re
from pathlib import Path
from typing import Dict, List, Set, Tuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "agent_tpu"
PORT = ROOT / "agent_tpu_torch"

# Functions whose string argument at the given position names an env var.
ENV_READERS = {"env_str": 0, "env_int": 0, "env_float": 0, "env_bool": 0, "getenv": 0,
               "resolve_model_id": 1}

# Reference modules whose counterpart has another path in the port.
MODULES = {"runtime/executor.py": "agent_tpu_torch.runtime.runtime"}

# "module:Name" in the reference -> "port.module:Name" in the port. A class
# mapped here carries its methods with it.
RENAMED = {
    "runtime/runtime.py:TpuRuntime": "agent_tpu_torch.runtime.runtime:TorchRuntime",
    "runtime/executor.py:ExecutableCache": "agent_tpu_torch.runtime.runtime:BuildOnceCache",
    # The functional JAX layers are modules in the port.
    "models/layers.py:attention": "agent_tpu_torch.models.layers:Attention",
    "models/layers.py:ffn": "agent_tpu_torch.models.layers:FFN",
    "models/layers.py:encoder_block": "agent_tpu_torch.models.layers:EncoderBlock",
    "models/layers.py:decoder_block": "agent_tpu_torch.models.layers:DecoderBlock",
    "models/encoder.py:forward": "agent_tpu_torch.models.encoder:Encoder.forward",
    "models/encoder.py:moe_cfg_of": "agent_tpu_torch.models.moe:moe_cfg_of",
    "models/moe.py:moe_ffn": "agent_tpu_torch.models.moe:MoeFFN",
    "models/moe.py:moe_block": "agent_tpu_torch.models.moe:MoeBlock",
    "models/moe.py:moe_param_specs": "agent_tpu_torch.parallel.shardings:moe_specs",
    # Spec trees: the port's placement reads them (parallel.shardings).
    "parallel/shardings.py:encoder_param_specs": "agent_tpu_torch.parallel.shardings:encoder_specs",
    "parallel/shardings.py:bert_param_specs": "agent_tpu_torch.parallel.shardings:bert_specs",
    "parallel/shardings.py:seq2seq_param_specs": "agent_tpu_torch.parallel.shardings:seq2seq_specs",
    "parallel/shardings.py:t5_param_specs": "agent_tpu_torch.parallel.shardings:t5_specs",
    "parallel/shardings.py:bart_param_specs": "agent_tpu_torch.parallel.shardings:bart_specs",
    "models/train.py:place_sharded": "agent_tpu_torch.parallel.shardings:shard_flat",
    "models/train.py:train_step_sharded": "agent_tpu_torch.models.train:make_train_step",
    # One quantized leaf format with a mode ("int8" or "w8a16") in the port.
    "models/quant.py:is_quantized": "agent_tpu_torch.models.quant:leaf_mode",
    "models/quant.py:is_weight_only": "agent_tpu_torch.models.quant:leaf_mode",
    "models/quant.py:quantize_weight_w8a16": "agent_tpu_torch.models.quant:quantize_weight",
    "models/quant.py:quantize_dense_w8a16": "agent_tpu_torch.models.quant:quantize_dense",
    "models/quant.py:qdense": "agent_tpu_torch.models.quant:dense",
    "models/quant.py:wdense": "agent_tpu_torch.models.quant:dense",
    "models/quant.py:qproj_in": "agent_tpu_torch.models.quant:proj_in",
    "models/quant.py:wproj_in": "agent_tpu_torch.models.quant:proj_in",
    "models/quant.py:qproj_out": "agent_tpu_torch.models.quant:proj_out",
    "models/quant.py:wproj_out": "agent_tpu_torch.models.quant:proj_out",
    "models/quant.py:qmoe_expert": "agent_tpu_torch.models.quant:moe_expert",
    "models/quant.py:wmoe_expert": "agent_tpu_torch.models.quant:moe_expert",
    "models/quant.py:quantize_for_family": "agent_tpu_torch.models.quant:quantize_tree",
    "models/quant.py:quantize_specs_for_family": "agent_tpu_torch.parallel.shardings:quantize_specs",
    "models/quant.py:quantize_encoder_specs": "agent_tpu_torch.parallel.shardings:quantize_specs",
    "models/quant.py:quantize_bert_specs": "agent_tpu_torch.parallel.shardings:quantize_specs",
    "models/quant.py:quantize_seq2seq_specs": "agent_tpu_torch.parallel.shardings:quantize_specs",
    "models/quant.py:quantize_bart_specs": "agent_tpu_torch.parallel.shardings:quantize_specs",
    "models/quant.py:quantize_t5_specs": "agent_tpu_torch.parallel.shardings:quantize_specs",
    "ops/_model_common.py:maybe_quantize_params": "agent_tpu_torch.models.quant:quantize_tree",
    "ops/_model_common.py:maybe_quantize_specs": "agent_tpu_torch.parallel.shardings:quantize_specs",
    "ops/_model_common.py:resolve_dp": "agent_tpu_torch.ops._model_common:stage_divisor",
    # The kernels run at every length the launchers support, training too.
    "kernels/flash_attention.py:selects_flash_train": "agent_tpu_torch.kernels.flash_attention:selects_flash",
}

PARTITION_SPECS = ("a JAX PartitionSpec builder; the port places tensors by its spec trees "
                   "(parallel/shardings.py) and splits rows by dp itself")
NOT_PORTED = {
    "utils/compat.py": "a shim over JAX's moved shard_map API; the port calls no shard_map",
    "runtime/runtime.py:TpuRuntime.sharding": PARTITION_SPECS,
    "runtime/runtime.py:TpuRuntime.data_sharding": PARTITION_SPECS,
    "runtime/runtime.py:TpuRuntime.replicated": PARTITION_SPECS,
    "parallel/shardings.py:batch_spec": PARTITION_SPECS,
    "parallel/shardings.py:label_spec": PARTITION_SPECS,
    "parallel/pipeline.py:stage_specs": PARTITION_SPECS,
    "models/moe.py:expert_batch_spec": PARTITION_SPECS,
    "parallel/pipeline.py:stack_blocks": ("stacks blocks for a P('pp') shard_map operand; the "
                                          "port's stages hold their blocks as lists"),
    "runtime/runtime.py:detect_platform": ("the port never picks its platform by probing: "
                                           "TorchRuntime takes cuda:0 or raises, and runs on "
                                           "the CPU only when asked (TPU_DISABLED)"),
    "sizing/profile.py:detect_tpu": "TPU detection; the port claims no TPU (detect_gpu)",
    "agent/fleet.py:force_host_devices": ("rewrites XLA_FLAGS, which PyTorch ignores; a CPU "
                                          "fleet member asks for the CPU"),
    "models/checkpoint.py:save_orbax": "orbax; the port's sharded format is save_sharded",
    "models/checkpoint.py:load_orbax": "orbax; the port's sharded format is load_sharded",
    "models/checkpoint.py:orbax_available": "orbax; the port's sharded format is save_sharded",
    "obs/trace.py:record_compile": ("the executor cache's xla.compile spans, which the port "
                                    "leaves out on purpose (ROADMAP, Differences)"),
    "obs/trace.py:record_cache_event": ("the executor cache's runtime_compile_cache_total, "
                                        "left out with its xla.compile spans"),
    "obs/trace.py:get_tracer": ("the process-global span buffer that only record_compile "
                                "fills; the agent owns its SpanBuffer"),
}

ENV_NOT_PORTED = {
    "PROFILE_PORT": ("jax.profiler.start_server has no PyTorch counterpart; PROFILE_DIR "
                     "captures stay"),
    "JAX_COMPILATION_CACHE_DIR": "the kernels' build directory takes its place",
    "JAX_PLATFORM_NAME": "a TPU detection hint; the port claims no TPU",
    "TPU_NAME": "a TPU detection hint; the port claims no TPU",
    "TPU_TYPE": "a TPU detection hint; the port claims no TPU",
    "TPU_KIND": "a TPU detection hint; the port claims no TPU",
}

# Reference scripts that import agent_tpu -> their counterpart: a path in the
# repo ("path::text" when the text must appear in it), or "ROADMAP" for a
# script in ROADMAP.md's queue of scripts still to port.
SCRIPTS = {
    "drain_at_scale.py": "agent_tpu_torch/scripts/drain_at_scale.py",
    "fleet.py": "agent_tpu_torch/agent/fleet_cli.py",
    "check_dag_pipeline.py": "tests/test_torch_chip_smoke_control.py",
    "check_data_plane.py": "tests/test_torch_agent_parts.py",
    "check_metrics_endpoint.py": "tests/test_torch_obs_controller.py::validate_exposition",
    "check_multichip_drain.py": "tests/test_torch_fleet.py",
    "check_partitioned_controller.py": "tests/test_torch_chip_smoke_partition.py",
    "check_profile_pipeline.py": "tests/test_torch_usage.py",
    "check_sched_fairness.py": "tests/test_torch_sched.py",
    "check_slo_pipeline.py": "tests/test_torch_slo.py",
    "check_trace_pipeline.py": "tests/test_torch_trace.py",
    "check_request_trace.py": "ROADMAP",
    "check_serving_pipeline.py": "ROADMAP",
    "check_telemetry_pipeline.py": "ROADMAP",
    "chaos_soak.py": "ROADMAP",
    "controller_bench.py": "ROADMAP",
    "controller_failover_soak.py": "ROADMAP",
    "elastic_soak.py": "ROADMAP",
    "swarmtop.py": "ROADMAP",
}


# ---- the walk ---------------------------------------------------------------

def _const_str(node) -> str | None:
    return node.value if isinstance(node, ast.Constant) and isinstance(node.value, str) else None


def env_reads(tree: ast.AST) -> Set[str]:
    """Env var names read in ``tree``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            on_environ = (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Attribute)
                          and f.value.attr == "environ")
            pos = ENV_READERS.get(name)
            if on_environ and name in ("get", "pop", "setdefault"):
                pos = 0
            if pos is not None and len(node.args) > pos and _const_str(node.args[pos]):
                out.add(node.args[pos].value)
        elif isinstance(node, ast.Subscript):
            v = node.value
            if isinstance(v, ast.Attribute) and v.attr == "environ" and _const_str(node.slice):
                out.add(node.slice.value)
        elif isinstance(node, ast.Compare) and isinstance(node.ops[0], (ast.In, ast.NotIn)):
            c = node.comparators[0]
            if isinstance(c, ast.Attribute) and c.attr == "environ" and _const_str(node.left):
                out.add(node.left.value)
    return out


def public_names(tree: ast.Module) -> List[str]:
    """Public top-level functions, classes, class methods ("Cls.method") and
    UPPER_CASE constants."""
    names: List[str] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                names.append(node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            names.append(node.name)
            names += [f"{node.name}.{b.name}" for b in node.body
                      if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                      and not b.name.startswith("_")]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names += [t.id for t in targets if isinstance(t, ast.Name) and t.id.isupper()
                      and not t.id.startswith("_")]
    return names


def reference_surface(root: Path) -> Tuple[Dict[str, str], Dict[str, str]]:
    """({"rel/path.py:Name": rel, ...} plus one "rel/path.py" key a module,
    {ENV_VAR: rel})."""
    names: Dict[str, str] = {}
    env: Dict[str, str] = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        tree = ast.parse(path.read_text(encoding="utf-8"))
        names[rel] = rel
        names.update({f"{rel}:{n}": rel for n in public_names(tree)})
        for var in env_reads(tree):
            env.setdefault(var, rel)
    return names, env


def port_env(root: Path = PORT) -> Set[str]:
    out: Set[str] = set()
    for path in root.rglob("*.py"):
        out |= env_reads(ast.parse(path.read_text(encoding="utf-8")))
    return out


def _target(key: str) -> str:
    """The port's "module:attr.path" for a reference "rel:Name" key."""
    if key in RENAMED:
        return RENAMED[key]
    rel, _, name = key.partition(":")
    cls, dot, rest = name.partition(".")
    if dot and f"{rel}:{cls}" in RENAMED:
        return f"{RENAMED[f'{rel}:{cls}']}.{rest}"
    module = MODULES.get(rel) or "agent_tpu_torch." + rel[:-3].replace("/", ".")
    return f"{module.removesuffix('.__init__')}:{name}"


def resolves(target: str) -> bool:
    module, _, attrs = target.partition(":")
    try:
        obj = importlib.import_module(module)
    except ImportError:
        return False
    for part in filter(None, attrs.split(".")):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def unmatched(root: Path, not_ported=NOT_PORTED, env_not_ported=ENV_NOT_PORTED,
              ported_env=None) -> List[str]:
    names, env = reference_surface(root)
    ported_env = port_env() if ported_env is None else ported_env
    missing = []
    for key, rel in names.items():
        if key in not_ported or rel in not_ported:
            continue
        if ":" not in key:
            if not resolves(_target(key + ":")):
                missing.append(key)
        elif not resolves(_target(key)):
            missing.append(key)
    missing += [f"env {var} ({rel})" for var, rel in sorted(env.items())
                if var not in ported_env and var not in env_not_ported]
    return missing


# ---- the tests ---------------------------------------------------------------

def test_every_reference_name_has_a_counterpart_or_a_reason():
    assert unmatched(REFERENCE) == []


def test_every_not_ported_entry_names_a_reference_name_without_a_counterpart():
    names, env = reference_surface(REFERENCE)
    for key, reason in NOT_PORTED.items():
        assert key in names, f"NOT_PORTED names {key}, which the reference lacks"
        assert reason and "not needed" not in reason
        if ":" in key:
            assert not resolves(_target(key)), f"{key} has a counterpart now: drop its entry"
    ported = port_env()
    for var, reason in ENV_NOT_PORTED.items():
        assert var in env and var not in ported and reason


def test_every_mapping_points_at_a_reference_name_and_resolves():
    names, _ = reference_surface(REFERENCE)
    for key, target in RENAMED.items():
        assert key in names, key
        assert resolves(target), target


def test_an_unmatched_name_fails_the_walk(tmp_path):
    """A synthetic reference module: one name with a counterpart, one
    without, and an env var the port never reads."""
    mod = tmp_path / "utils" / "errors.py"
    mod.parent.mkdir()
    mod.write_text("import os\n"
                   "class OpError(Exception):\n    pass\n"
                   "def no_such_counterpart():\n    pass\n"
                   "LEVEL = os.environ.get('NO_SUCH_PORTED_ENV')\n")
    got = unmatched(tmp_path, not_ported={}, env_not_ported={})
    assert got == ["utils/errors.py:no_such_counterpart", "utils/errors.py:LEVEL",
                   "env NO_SUCH_PORTED_ENV (utils/errors.py)"]
    assert unmatched(tmp_path, not_ported={"utils/errors.py:no_such_counterpart": "x",
                                           "utils/errors.py:LEVEL": "x"},
                     env_not_ported={"NO_SUCH_PORTED_ENV": "x"}) == []


def test_the_env_walk_sees_every_form_of_read():
    tree = ast.parse("import os\n"
                     "a = os.environ.get('A')\nb = os.environ['B']\nc = 'C' in os.environ\n"
                     "d = os.getenv('D')\ne = env_int('E', 1)\nf = env_bool('F', False)\n"
                     "g = resolve_model_id(p, 'G', 'x')\nh = os.environ.pop('H', None)\n")
    assert env_reads(tree) == set("ABCDEFGH")


def _imports_reference(path: Path) -> bool:
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        if any(m == "agent_tpu" or m.startswith("agent_tpu.") for m in mods):
            return True
    return False


def _roadmap_scripts_queue() -> str:
    text = (ROOT / "ROADMAP.md").read_text(encoding="utf-8")
    m = re.search(r"^### Queue 4 — the reference's scripts.*?(?=^### |^## )", text,
                  re.S | re.M)
    assert m, "ROADMAP.md has no queue of the reference's scripts"
    return m.group(0)


def test_every_reference_script_maps_to_a_counterpart_or_the_queue():
    scripts = sorted(p.name for p in (ROOT / "scripts").glob("*.py")
                     if _imports_reference(p))
    assert scripts == sorted(SCRIPTS)
    queue = _roadmap_scripts_queue()
    for name in scripts:
        assert f"`{name}`" in queue, f"ROADMAP's scripts queue omits {name}"
        where = SCRIPTS[name]
        if where == "ROADMAP":
            continue
        path, _, text = where.partition("::")
        assert (ROOT / path).is_file(), where
        assert text in (ROOT / path).read_text(encoding="utf-8"), where


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_a_ported_script_is_named_in_the_queue_with_its_counterpart(name):
    queue = _roadmap_scripts_queue()
    line = next((ln for ln in queue.splitlines() if f"`{name}`" in ln), "")
    where = SCRIPTS[name]
    if where != "ROADMAP":
        assert where.partition("::")[0] in queue, (name, line)
