"""Nothing the benchmark imports is JAX or the JAX package, by top-level
module name compared whole (``repro_torch`` is the port; ``repro`` is
not), and the reference imports nothing of the program either."""
import json
import subprocess
import sys
import types
from pathlib import Path

NSBENCH = Path(__file__).resolve().parents[1]
CHECKOUT = NSBENCH.parent

SCRIPT = r"""
import importlib.util, json, sys
sys.path[:0] = [{src!r}, {root!r}]
import nsbench.harness, nsbench.drive, nsbench.trace, nsbench.control
import nsbench.faults, nsbench.counts, nsbench.graphs
bench = nsbench.harness.Bench.load({bench!r})
for m in bench.spec["per_layer"]:
    bench.reader(m["name"])
for w in bench.spec["workloads"]:
    bench.setting(w["name"])
    bench.generator(bench.config(w["config"])["graph"]["generator"])
import repro_torch.sparse, repro_torch.examples.gcn_training
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCE_ONLY = r"""
import json, sys
sys.path[:0] = [{root!r}]
import nsbench.reference
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(script: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", script.format(
            src=str(CHECKOUT / "src"), root=str(CHECKOUT),
            bench=str(CHECKOUT / "BENCHMARK.json"))],
        capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_mixes_metrics_and_program_load_no_jax():
    names = _top_level(SCRIPT)
    assert "repro_torch" in names and "nsbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_neither_jax_nor_the_program():
    names = _top_level(REFERENCE_ONLY)
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_compared_whole(monkeypatch):
    from nsbench import harness

    names = ("repro_torch_x", "reprox", "repro.core", "jax", "jaxlib.xla",
             "flaxen")
    for n in names:
        monkeypatch.setitem(sys.modules, n, types.ModuleType(n))
    found = set(harness.forbidden_modules()) & set(names)
    assert found == {"repro.core", "jax", "jaxlib.xla"}
