"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``.

An AST scan of every import statement (top level or inside a function).
Relative imports stay inside ``repro_torch`` and are allowed.  The port's
layer check, ``tools/check_layers_torch.py``, passes on the tree and
rejects an upward import and a ``jax``/``repro`` import.
"""
import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/sparse.py" in names
    for module in ("core/coordinator.py", "core/tuner.py", "obs/trace.py",
                   "obs/profile.py", "obs/report.py", "robust/faults.py",
                   "exec/health.py", "core/values.py",
                   "checkpoint/checkpoint.py", "dynamic/registry.py",
                   "dynamic/delta.py", "dynamic/tuning.py",
                   "serve/spmm_service.py", "examples/dynamic_serving.py",
                   "distributed/mesh.py", "models/config.py",
                   "models/moe.py", "models/ssm.py", "models/transformer.py",
                   "models/model.py", "configs/base.py",
                   "data/pipeline.py", "serve/engine.py", "launch/serve.py",
                   "examples/moe_serving.py", "train/optimizer.py",
                   "train/compression.py", "train/train_loop.py",
                   "train/controller.py", "launch/train.py",
                   "examples/lm_training.py", "distributed/sharding.py",
                   "launch/mesh.py", "launch/step_analysis.py",
                   "launch/specs.py", "launch/roofline.py",
                   "launch/dryrun.py", "launch/report.py",
                   "launch/perf.py"):
        assert f"src/repro_torch/{module}" in names, module
    assert len(names) > 20


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom repro.core import spmm\n"
                     "def f():\n    import jax.numpy as jnp\n"
                     "    importlib.import_module('repro.exec')\n"
                     "from . import sibling\n")
    assert [m for _, m in _imported_roots(probe) if m in FORBIDDEN] == [
        "repro", "jax", "repro"]


def _layer_checker():
    spec = importlib.util.spec_from_file_location(
        "check_layers_torch", ROOT / "tools" / "check_layers_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_layer_check_passes_on_the_tree():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_layers_torch.py")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "import layering ok" in out.stdout


def _fake_port(tmp_path, files):
    for rel, text in files.items():
        path = tmp_path / "repro_torch" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return str(tmp_path)


def test_layer_check_rejects_upward_and_foreign_imports(tmp_path):
    check = _layer_checker()
    src = _fake_port(tmp_path, {
        "__init__.py": "",
        "errors.py": "",
        "core/__init__.py": "",
        # upward: core must not reach the facade, even inside a function
        "core/spmm.py": "def f():\n    from .. import sparse\n",
        "kernels/ops.py": ("from ..core.cost_model import x\n"
                           "from ..exec import api\n"),
        "obs/metrics.py": "from ..errors import ReproError\n",
        "exec/api.py": "from ..dynamic import update_values\n",
        # data sits beside dynamic: nothing below dynamic imports it
        "exec/pipeline.py": "from ..data import graphs\n",
        "data/graphs.py": "def f():\n    from ..dynamic.delta import x\n",
        "checkpoint/checkpoint.py": "from ..errors import ReproError\n",
        "sparse.py": "import importlib\nimportlib.import_module('jax')\n",
        "models/layers.py": "from repro.core import spmm\n",
    })
    smoke = tmp_path / "chip_smoke.py"
    smoke.write_text("import jax.numpy as jnp\n")
    found = check.check_tree(src, extra_files=(str(smoke),))
    joined = "\n".join(found)
    assert "repro_torch/core/spmm.py:2: core must not import " \
        "repro_torch.sparse" in joined
    assert "kernels must not import repro_torch.exec" in joined
    assert "obs must not import repro_torch.errors" in joined
    assert "repro_torch/sparse.py:2: imports jax" in joined
    assert "repro_torch/models/layers.py:1: imports repro.core" in joined
    assert "chip_smoke.py:1: imports jax.numpy" in joined
    # exec sits below dynamic: the backward's update_values is core's
    assert "repro_torch/exec/api.py:1: exec must not import " \
        "repro_torch.dynamic" in joined
    assert "exec must not import repro_torch.data" in joined
    assert "checkpoint must not import repro_torch.errors" in joined
    # the allowances: kernels -> core.cost_model, data -> dynamic
    assert "cost_model" not in joined and "data/graphs.py" not in joined
    assert len(found) == 9, found


def test_exec_imports_nothing_of_dynamic():
    """``exec`` sits below ``dynamic``: no module under ``exec/`` imports
    it, and the checker's one allowance is ``core/spmm.py``'s lazy
    forward of the execution names."""
    check = _layer_checker()
    assert check.ALLOWED == {("repro_torch/core/spmm.py", "repro_torch.exec")}
    exec_dir = ROOT / "src" / "repro_torch" / "exec"
    for path in sorted(exec_dir.glob("*.py")):
        rel = path.relative_to(ROOT / "src").as_posix()
        tree = ast.parse(path.read_text(), filename=str(path))
        targets = [t for _, t in check.iter_imports(rel, tree)]
        assert not [t for t in targets
                    if t.startswith("repro_torch.dynamic")], (rel, targets)


def test_layer_check_puts_serve_on_top_and_keeps_seams_downward(tmp_path):
    """``serve`` sits above every layer but the examples; the tuner's
    store hook is called only from ``dynamic``/``serve``, and no fault
    seam fires in ``core`` or ``kernels``."""
    check = _layer_checker()
    src = _fake_port(tmp_path, {
        "__init__.py": "",
        # serve may import every layer below it
        "serve/spmm_service.py": ("from ..dynamic import PlanRegistry\n"
                                  "from ..core import tuner\n"
                                  "from ..robust.faults import HARNESS\n"
                                  "HARNESS.fire('dispatch')\n"),
        # nothing below serve imports it
        "dynamic/registry.py": "from ..serve import SpmmService\n",
        "sparse.py": "def f():\n    from .serve import spmm_service\n",
        "examples/demo.py": "from ..serve import SpmmService\n",
        # the store seam: defined in core, called from dynamic only
        "core/tuner.py": ("def install_store(s):\n    pass\n"
                          "install_store(None)\n"),
        "dynamic/tuning.py": ("from ..core import tuner\n"
                              "tuner.install_store(None)\n"),
        # no fault seam fires in core or kernels
        "core/spmm.py": ("from ..robust.faults import HARNESS\n"
                         "HARNESS.fire('fold_build')\n"),
        "kernels/ops.py": "HARNESS.fire('dispatch')\n",
    })
    found = check.check_tree(src, extra_files=())
    joined = "\n".join(found)
    assert ("repro_torch/dynamic/registry.py:1: dynamic must not import "
            "repro_torch.serve") in joined
    assert ("repro_torch/sparse.py:2: sparse must not import "
            "repro_torch.serve") in joined
    assert "repro_torch/core/tuner.py:3: install_store()" in joined
    assert "repro_torch/core/spmm.py:2: core must not fire" in joined
    assert "repro_torch/kernels/ops.py:1: kernels must not fire" in joined
    assert "serve/spmm_service.py" not in joined
    assert "examples/demo.py" not in joined
    assert "dynamic/tuning.py" not in joined
    assert len(found) == 5, found


def test_tuner_installs_no_store_and_fires_no_seam():
    """The rule on the tree itself: ``core/tuner.py`` defines the store
    hook and calls neither it nor a fault seam."""
    check = _layer_checker()
    path = ROOT / "src" / "repro_torch" / "core" / "tuner.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not list(check.iter_calls(tree, check.STORE_SEAM_HOOK))
    assert not list(check.iter_calls(tree, check.FAULT_SEAM_HOOK))
    assert "def install_store" in path.read_text()


def test_sharded_path_runs_with_jax_and_the_reference_unimportable():
    """The mesh and every module of the sharded path import and run with
    ``jax`` and ``repro`` blocked: a 2-shard plan on the repeated CPU
    through the facade, a value update, a routed sidecar, the registry
    and the service."""
    code = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import tempfile
import numpy as np
import torch
import repro_torch.sparse as sp
from repro_torch.distributed import make_spmm_mesh
from repro_torch.dynamic import GraphDelta, PlanRegistry
from repro_torch.serve import SpmmService
mesh = make_spmm_mesh(devices=["cpu"] * 2)
rng = np.random.RandomState(0)
rows, cols = np.nonzero(rng.rand(300, 40) < 0.1)
vals = rng.randn(rows.size)
A = sp.from_coo(rows, cols, vals, (300, 40), mesh=mesh, dynamic=True)
A.plan.update(GraphDelta.inserts([0, 5], [1, 2], [1.0, 2.0]))
A.plan.update(GraphDelta.updates(rows[:2], cols[:2], [3.0, 4.0]))
out = sp.spmm(A, torch.ones((40, 4)))
assert out.shape == (300, 4) and A.plan.is_sharded
reg = PlanRegistry(tempfile.mkdtemp())
reg.save("g", A.plan)
svc = SpmmService(A.plan.config, registry=reg)
svc.warm_start("g", mesh=mesh)
t = svc.submit("g", torch.ones((40, 4)))
svc.flush()
assert torch.equal(svc.fetch(t), out)
svc.close()
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m, mod in sys.modules.items() if mod is not None)
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_layer_check_places_the_lm_stack(tmp_path):
    """``configs`` sits above ``models``; ``launch`` sits on top beside
    ``examples``; the LM batch pipeline sits in ``data``."""
    check = _layer_checker()
    src = _fake_port(tmp_path, {
        "__init__.py": "",
        # allowed: each imports only layers below it
        "configs/base.py": "from ..models.config import ModelConfig\n",
        "serve/engine.py": "from ..models import model\n",
        "launch/serve.py": ("from ..configs import get_arch\n"
                            "from ..serve import ServeEngine\n"
                            "from ..data import pipeline\n"),
        "examples/moe_serving.py": "from ..configs import get_arch\n",
        "interop.py": "from .models import model\n",
        # upward: models must not reach the registry, nor data the models
        "models/model.py": "from ..configs import get_arch\n",
        "data/pipeline.py": "def f():\n    from ..models import model\n",
        "serve/spmm_service.py": "from ..launch import serve\n",
        "launch/train.py": "from ..examples import moe_serving\n",
        "examples/demo.py": "from ..launch.serve import main\n",
        "configs/gemma.py": "from ..interop import lm_params_from_arrays\n",
    })
    found = check.check_tree(src, extra_files=())
    joined = "\n".join(found)
    assert ("repro_torch/models/model.py:1: models must not import "
            "repro_torch.configs") in joined
    assert ("repro_torch/data/pipeline.py:2: data must not import "
            "repro_torch.models") in joined
    assert "serve must not import repro_torch.launch" in joined
    assert "launch must not import repro_torch.examples" in joined
    assert "examples must not import repro_torch.launch" in joined
    assert "configs must not import repro_torch.interop" in joined
    assert len(found) == 6, found


def test_lm_entry_points_run_with_jax_and_the_reference_unimportable():
    """The serve launcher and the MoE serving example run on the CPU with
    ``jax`` and ``repro`` blocked."""
    code = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
from repro_torch.examples import moe_serving
from repro_torch.launch import serve
assert serve.main(["--arch", "zamba2-1.2b", "--smoke", "--batch", "2",
                   "--prompt-len", "8", "--gen", "3", "--device", "cpu"]) > 0
assert moe_serving.main("cpu").sum() == 64
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m, mod in sys.modules.items() if mod is not None)
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_layer_check_places_train(tmp_path):
    """``train`` sits above ``configs`` and below ``interop``: it may
    import the models, the checkpoint layout and the data pipeline; the
    train launcher and the example may import it; nothing below it may,
    and it imports no layer above it."""
    check = _layer_checker()
    src = _fake_port(tmp_path, {
        "__init__.py": "",
        # allowed
        "train/train_loop.py": ("from ..models import model\n"
                                "from ..data import pipeline\n"),
        "train/controller.py": "from ..checkpoint import checkpoint\n",
        "interop.py": "from .train.optimizer import OptState\n",
        "launch/train.py": "from ..train import controller\n",
        "examples/lm_training.py": "from ..train import train_loop\n",
        # upward
        "models/moe.py": "from ..train import optimizer\n",
        "configs/base.py": "def f():\n    from ..train import optimizer\n",
        "train/optimizer.py": "from ..interop import lm_params_from_arrays\n",
        "train/compression.py": "from ..serve import ServeEngine\n",
    })
    found = check.check_tree(src, extra_files=())
    joined = "\n".join(found)
    assert "models must not import repro_torch.train" in joined
    assert "configs must not import repro_torch.train" in joined
    assert "train must not import repro_torch.interop" in joined
    assert "train must not import repro_torch.serve" in joined
    assert len(found) == 4, found


def test_lm_training_entry_points_run_with_jax_and_the_reference_unimportable():
    """The train launcher and the LM training example run on the CPU with
    ``jax`` and ``repro`` blocked."""
    code = """
import sys, tempfile
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
from repro_torch.examples import lm_training
from repro_torch.launch import train
from repro_torch.distributed import sharding
with tempfile.TemporaryDirectory() as d:
    log = train.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                      "--steps", "2", "--global-batch", "2", "--seq-len",
                      "16", "--device", "cpu", "--ckpt-dir", d])
assert len(log) == 2
log = lm_training.main(["--device", "cpu", "--steps", "24", "--d-model",
                        "64", "--layers", "2", "--batch", "4", "--seq",
                        "32"])
assert len(log) > 24
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m, mod in sys.modules.items() if mod is not None)
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_layer_check_puts_the_dry_run_above_the_model_stack(tmp_path):
    """``launch``'s dry-run modules may import ``configs``, ``models``,
    ``train`` and ``distributed``; none of those imports ``launch``."""
    check = _layer_checker()
    src = _fake_port(tmp_path, {
        "__init__.py": "",
        "launch/dryrun.py": ("from ..configs import get_arch\n"
                             "from ..distributed import sharding\n"
                             "from .specs import build_cell\n"),
        "launch/specs.py": ("from ..models import model\n"
                            "from ..train import train_loop\n"
                            "from ..distributed.mesh import use_mesh\n"),
        "launch/step_analysis.py": "from ..core.cost_model import HBM\n",
        "models/model.py": "def f():\n    from ..launch import specs\n",
        "train/train_loop.py": "from ..launch.dryrun import run_cell\n",
        "configs/base.py": "from ..launch import mesh\n",
        "distributed/sharding.py": "from ..launch import step_analysis\n",
    })
    found = check.check_tree(src, extra_files=())
    joined = "\n".join(found)
    assert "launch/" not in joined.replace("repro_torch.launch", "")
    for rel, layer in (("models/model.py:2", "models"),
                       ("train/train_loop.py:1", "train"),
                       ("configs/base.py:1", "configs"),
                       ("distributed/sharding.py:1", "distributed")):
        assert f"repro_torch/{rel}: {layer} must not import " \
            "repro_torch.launch" in joined, (rel, joined)
    assert len(found) == 4, found
