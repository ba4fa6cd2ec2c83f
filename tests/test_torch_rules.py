"""The port's ground rules: no JAX anywhere in rift_tpu_torch (its
`parallel/` package and the imports inside functions included),
chip_smoke.py or scatter_ab.py; h5py (not on the card's machine) only
inside the two h5 readers; entry points default to the card and raise
without one; chip_smoke.py fails where there is no card or no
package."""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rift_tpu")


def _port_files():
    pkg = os.path.join(ROOT, "rift_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scatter_ab.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_rift_tpu():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imported_roots(p)
           if m in FORBIDDEN]
    assert not bad, bad


NEW_MODULES = ("parallel/__init__.py", "parallel/mesh.py", "parallel/sharded_ops.py",
               "ops/sampling.py", "data/modelnet40.py", "train/loop.py", "cli.py",
               "ops/se3.py", "registration/pose_graph.py", "registration/bundle_adjust.py",
               "registration/sequence.py")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_data_parallel_and_sampling_modules_import_no_jax(module):
    """The rule above covers `parallel/`, the modules of the classifier's
    workflow and those of the sequence mapping, with the imports inside
    their functions (`ast.walk` reaches every node, not only the top
    level)."""
    path = os.path.join(ROOT, "rift_tpu_torch", module)
    assert path in _port_files()
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), roots


def test_the_import_rule_sees_function_local_imports(tmp_path):
    path = tmp_path / "m.py"
    path.write_text("import os\n\ndef f():\n    if True:\n        from jax import numpy\n"
                    "    import rift_tpu.ops as o\n")
    assert set(_imported_roots(str(path))) == {"os", "jax", "rift_tpu"}


def _h5py_imports(path):
    """(enclosing class.function or '<module>') of each import of h5py."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, scope + [child.name])
                continue
            if isinstance(child, ast.Import) and any(a.name.split(".")[0] == "h5py"
                                                     for a in child.names):
                found.append(".".join(scope) or "<module>")
            elif isinstance(child, ast.ImportFrom) and (child.module or "").startswith("h5py"):
                found.append(".".join(scope) or "<module>")
            visit(child, scope)

    visit(tree, [])
    return found


def test_h5py_is_imported_only_inside_the_two_readers():
    where = {(os.path.relpath(p, ROOT), scope) for p in _port_files() for scope in _h5py_imports(p)}
    assert where == {("rift_tpu_torch/data/synthetic_pairs.py", "H5TestPairs.__init__"),
                     ("rift_tpu_torch/data/sequences.py", "SyntheticSequence.__init__")}
    # Without h5py the card's paths and the command line still run.
    code = ("import sys\n"
            "sys.modules['h5py'] = None\n"
            "from rift_tpu_torch.cli import main\n"
            "from rift_tpu_torch.data import get_pairs\n"
            "print(len(get_pairs(None, 64, 'icl_nuim', 3)))\n"
            "print(main(['presets']) == 0)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:2] == ["3", "mn40_cu_dg"] and out.stdout.split()[-1] == "True"


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=ROOT, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_imports_and_builds_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'rift_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch, rift_tpu_torch\n"
        "from rift_tpu_torch.models import PVCNNClassifier\n"
        "from rift_tpu_torch.registration import register_batch\n"
        "from rift_tpu_torch.data import SyntheticPairs\n"
        "m = PVCNNClassifier(blocks=((8, 1, 4),), local_neighbors=8).eval()\n"
        "s, d, _ = SyntheticPairs(num_pairs=1, num_points=64).arrays()\n"
        "print(tuple(register_batch(m, s, d, device='cpu').shape))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(1, 4, 4)"


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from rift_tpu_torch import resolve_device
    from rift_tpu_torch.models import PVCNNClassifier
    from rift_tpu_torch.registration import register_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    model = PVCNNClassifier(blocks=((8, 1, 4),), local_neighbors=8).eval()
    pts = np.zeros((1, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        register_batch(model, pts, pts)
    from rift_tpu_torch.train import get_config, train

    with pytest.raises(RuntimeError, match="CUDA"):
        train(get_config("tiny_smoke"))
    from rift_tpu_torch import cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["evaluate", "--preset", "reg_icl_nuim", "--untrained"])


def test_kernel_wrappers_never_fall_back_on_other_devices():
    from rift_tpu_torch.ops.cuda import (corner_gather, corner_scatter, neighborhood_moments,
                                         scatter_mean)

    meta = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError):
        neighborhood_moments(meta, 4, 0.01)
    with pytest.raises(ValueError):
        scatter_mean(meta, torch.zeros((1, 8), dtype=torch.long, device="meta"), 4)
    with pytest.raises(ValueError):
        corner_gather(meta, torch.zeros((1, 8, 8), dtype=torch.long, device="meta"),
                      torch.zeros((1, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        corner_scatter(meta, torch.zeros((1, 8, 8), dtype=torch.long, device="meta"),
                       torch.zeros((1, 8, 8), device="meta"), 4)


def test_importing_chip_smoke_runs_nothing():
    out = _run("import chip_smoke; print('imported', callable(chip_smoke.main))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported True"


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
