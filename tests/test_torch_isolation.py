"""agent_tpu_torch and chip_smoke.py must import nothing of JAX and nothing
of the JAX package, and none of the packages the card's machine lacks
(``regex``, ``safetensors``, ``transformers``; this environment has them,
so a port leaning on them would pass here and fail on the card). Checked
on the source (AST), because this environment preloads jax into every
interpreter, so sys.modules cannot show it."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "agent_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "agent_tpu", "regex", "safetensors", "transformers")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_the_port_has_files_to_scan():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_agent_tpu_imports(path):
    """Nor regex, safetensors or transformers (the name is older than them)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_catches_each_forbidden_package():
    for name in FORBIDDEN:
        for source in (f"import {name}", f"from {name}.x import y", f"import {name}.sub as s",
                       f"importlib.import_module('{name}')"):
            assert [m for m in _imported_modules(ast.parse(source))
                    if m.split(".")[0] == name], source
