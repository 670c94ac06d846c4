"""The port stands alone: ``stlt_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``stlt_tpu`` (nor flax's
``msgpack``: the port reads and writes the format itself); h5py and Pillow
load only where the appearance data modules read frames."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "stlt_tpu")


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
    yield os.path.join(ROOT, "tests", "ring_worker.py")  # the ranks of tests/test_torch_ring.py


def test_importing_the_port_loads_no_jax_module():
    modules = _port_modules()
    assert "stlt_tpu_torch.predict" in modules and "stlt_tpu_torch.ops._kernels" in modules
    assert {"stlt_tpu_torch.parallel.mesh", "stlt_tpu_torch.parallel.distributed",
            "stlt_tpu_torch.ops.ring"} <= set(modules)
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


def test_importing_the_port_its_models_and_ops_loads_no_image_library():
    """h5py and Pillow are imported lazily, where the appearance pipeline
    reads frames: importing the package, its models (the appearance and
    fusion models included), its ops, its data factories and its CLIs loads
    neither."""
    modules = ["stlt_tpu_torch", "stlt_tpu_torch.data", "stlt_tpu_torch.predict",
               "stlt_tpu_torch.inference"] + [
        m for m in _port_modules() if m.startswith(("stlt_tpu_torch.models", "stlt_tpu_torch.ops"))]
    assert "stlt_tpu_torch.models.fusion" in modules and "stlt_tpu_torch.ops.fused_encoder" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('h5py', 'PIL'))\n"
        "print('LOADED', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout, proc.stdout
