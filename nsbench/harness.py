"""Runs one cell of ``BENCHMARK.json`` once and builds its result line.

Everything is found by name under the benchmark's folder:

- ``configs/<config>.json``: the configuration (graph, model, sources);
  its graph's ``generator`` names ``generators/<generator>.py``, whose
  ``build(graph, device)`` makes the structure;
- ``traffic/<mix>.json``: the mix's parameters, whose ``kind`` names
  ``kinds/<kind>.py``: its ``Load`` runs the mix, its ``control`` gives
  the control's readings and its ``FAULTS`` the faults a run can have;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``
  for each per-layer metric; where there is none, the reader of the name
  before its first dot (``idle_frac.py`` reads ``idle_frac.gcn``);
- ``limits/<cell>.json``: the limit of each number the check compares.

A new cell, mix, kind, generator or metric is new files and new entries
in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
import types
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

_MODULES: Dict[Path, types.ModuleType] = {}


def load_module(path: Path) -> types.ModuleType:
    """The module in ``path``, loaded once per process, so that a fault
    planted in it is seen by every caller."""
    path = Path(path).resolve()
    if path not in _MODULES:
        name = "nsbench_" + "_".join(path.with_suffix("").parts[-2:]) \
            .replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


class Recorder:
    """Host-clock spans at the harness's calls into the program's layers;
    in a traced run each is also a ``record_function("nsbench.<name>")``
    range, so the profiler's trace attributes device work to it."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.trace:
            from torch.profiler import record_function
            ctx = record_function("nsbench." + name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans[name].append(time.perf_counter() - t0)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, spec: dict, root: Path = HERE):
        self.spec, self.root = spec, Path(root)

    @classmethod
    def load(cls, path: Path, root: Path = HERE) -> "Bench":
        return cls(json.loads(Path(path).read_text()), root)

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.root / kind / f"{name}.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> Dict[str, float]:
        return self._json("limits", cell)["limits"]

    def kind(self, name: str) -> types.ModuleType:
        return load_module(self.root / "kinds" / f"{name}.py")

    def kind_of(self, cell: str) -> types.ModuleType:
        return self.kind(self.traffic(self.cell(cell)["traffic"])["kind"])

    def generator(self, name: str) -> types.ModuleType:
        return load_module(self.root / "generators" / f"{name}.py")

    def reader(self, metric: str):
        path = self.root / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.root / "metrics" / f"{metric.split('.')[0]}.py"
        return load_module(path).read

    def metrics_of(self, cell: str, group: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
        that list it, and those that list no cells."""
        return [m for m in self.spec[group]
                if cell in m.get("workloads", [cell])]

    def setting(self, cell: str):
        """``(cell, configuration, mix, kind module)`` of a workload."""
        w = self.cell(cell)
        mix = self.traffic(w["traffic"])
        return w, self.config(w["config"]), mix, self.kind(mix["kind"])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of the JAX stack's or
    the JAX package's, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def _device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: Optional[float] = None) -> dict:
    """Set the cell up, measure its window, check it; the result line as a
    dict, ``compared`` last."""
    import torch

    from . import trace as tracing

    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, mix, kind = bench.setting(workload)
    limits = bench.limits(workload)
    dev = torch.device(device)
    rec = Recorder(trace)
    load = kind.Load(bench, cfg, mix, seed, dev, rec)
    load.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    with rec.span("window"):
        e2e = load.window(seconds)
    summary = None
    if prof is not None:
        prof.stop()
        summary = tracing.summarize(prof)
        del prof
    device_info = _device_info(dev, cell["chips"])
    load.release()
    compared = load.check(limits)

    run = types.SimpleNamespace(
        spans=dict(rec.spans), counters=dict(load.counters), trace=summary,
        setup_s=setup_s, cell=cell, config=cfg, mix=mix)
    metrics = {}
    if trace:
        for m in bench.metrics_of(workload, "per_layer"):
            value = bench.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            device_info.update(busy_s=summary.busy_s,
                               window_s=summary.window_s)
    else:
        measured = dict(e2e, setup_s=setup_s)
        for m in bench.metrics_of(workload, "end_to_end"):
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    correct = (load.failed == 0
               and all(v <= limits[k] for k, v in compared.items()))
    line = {"correct": correct,
            "attempted": load.attempted, "failed": load.failed,
            "metrics": metrics, "device": device_info}
    if summary is not None:
        line["breakdown"] = {
            "device_ops": [list(kv) for kv in summary.device_ops],
            "idle_gaps": [list(kv) for kv in summary.idle_gaps]}
    line["compared"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in compared.items()}
    return line
