"""The port imports neither JAX nor the JAX package (checked on the source, with ``ast``)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "gymnasium_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module in ("jax", "gymnasium_tpu") or module.startswith(("jax.", "gymnasium_tpu."))


def test_sources_exist():
    assert len(SOURCES) > 10 and all(path.exists() for path in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            modules = [node.module or ""]
        else:
            continue
        bad = [m for m in modules if _forbidden(m)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"
