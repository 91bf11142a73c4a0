"""The port stands alone: no file under ``src/repro_torch/`` nor
``chip_smoke.py`` imports jax, ml_dtypes (absent on the card's machine) or
the reference package ``repro``, importing every port module pulls in no
jax, and the entry points default to CUDA."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert path.exists()
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    # no dynamic import by name either
    text = path.read_text()
    for name in ("import_module(\"jax", "import_module('jax",
                 "__import__(\"jax", "__import__('jax"):
        assert name not in text


def test_walk_reaches_every_module():
    """The file walk above covers every package and module of the port,
    the model families' modules among them."""
    files = {str(p.relative_to(PORT)) for p in _port_files()
             if p.is_relative_to(PORT)}
    for pkg in (p for p in PORT.rglob("*") if p.is_dir()
                and p.name != "__pycache__" and p.name != "csrc"):
        assert str((pkg / "__init__.py").relative_to(PORT)) in files, pkg
    for name in ("transformer", "moe", "xlstm", "ssm", "hybrid", "encdec"):
        assert f"models/{name}.py" in files
    for name in ("launch/mesh.py", "launch/specs.py", "launch/steps.py",
                 "dist/sharding.py", "dist/collectives.py",
                 "dist/transport.py", "data/prefetch.py"):
        assert name in files


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        .replace(".__init__", "")
        for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m.rstrip('.'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_cuda():
    import inspect

    from repro_torch.launch.train import build_parser, run_training
    args = build_parser().parse_args([])
    assert args.device == "cuda"
    assert "device" not in inspect.signature(run_training).parameters
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            run_training(args)


def test_mesh_layer_imports_alone_and_defaults_to_cuda():
    """The mesh, sharding, specs and steps modules, and the mesh step's
    collectives, transport and placement, import torch and the port only,
    and their mesh functions make CUDA meshes unless asked."""
    import inspect

    from repro_torch.data import prefetch
    from repro_torch.dist import collectives, sharding, transport
    from repro_torch.launch import mesh, specs, steps, train
    for mod in (mesh, specs, steps, sharding, collectives, transport,
                prefetch, train):
        roots = set(_imported_roots(Path(mod.__file__)))
        assert not roots & set(FORBIDDEN), (mod.__name__, roots)
    for fn in (mesh.make_production_mesh, mesh.make_global_mesh,
               mesh.make_sharded_mesh):
        assert inspect.signature(fn).parameters[
            "device_type"].default == "cuda"
