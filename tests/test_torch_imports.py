"""The port stands alone: ``stlt_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``stlt_tpu``."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "stlt_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _port_modules():
    import stlt_tpu_torch

    return ["stlt_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(stlt_tpu_torch.__path__, "stlt_tpu_torch.")
    ]


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "stlt_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_importing_the_port_loads_no_jax_module():
    modules = _port_modules()
    assert "stlt_tpu_torch.predict" in modules and "stlt_tpu_torch.ops._kernels" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('LOADED', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_source_imports_no_jax_module(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {bad}"
