"""The port imports neither JAX nor the JAX package (checked on the source,
with ``ast``), and calling its jax-named conversions imports no JAX module."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = (sorted((ROOT / "gymnasium_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "examples").glob("torch_*.py")))


def _forbidden(module: str) -> bool:
    return module in ("jax", "gymnasium_tpu") or module.startswith(("jax.", "gymnasium_tpu."))


def test_sources_exist():
    assert len(SOURCES) > 10 and all(path.exists() for path in SOURCES)
    assert len([path for path in SOURCES if path.parent.name == "examples"]) == 5


JAX_NAMED_CALLS = """
import sys
import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.wrappers as W
from gymnasium_tpu_torch.error import DependencyNotInstalled
from gymnasium_tpu_torch.wrappers import jax_to_numpy, jax_to_torch
from gymnasium_tpu_torch.wrappers.array_conversion import module_namespace

env = gym.make("CartPole-v1")
envs = gym.make_vec("CartPole-v1", 2, vectorization_mode="sync")
calls = [lambda: W.JaxToNumpy(env), lambda: W.JaxToTorch(env), lambda: W.vector.JaxToNumpy(envs),
         lambda: W.vector.JaxToTorch(envs), lambda: jax_to_numpy.jax_to_numpy(1),
         lambda: jax_to_numpy.numpy_to_jax(1), lambda: jax_to_torch.jax_to_torch(1),
         lambda: jax_to_torch.torch_to_jax(1), lambda: module_namespace("jax.numpy")]
raised = 0
for call in calls:
    try:
        call()
    except DependencyNotInstalled:
        raised += 1
print(raised, sorted(m for m in sys.modules if m in ("jax", "gymnasium_tpu") or m.startswith(("jax.", "jaxlib", "gymnasium_tpu."))))
"""


def test_jax_named_conversions_import_no_jax_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", JAX_NAMED_CALLS], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "9 []"


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
