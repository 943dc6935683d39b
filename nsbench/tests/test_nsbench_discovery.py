"""A configuration, a traffic mix, a kind of load, a generator and a
per-layer metric written as new files, with new entries in the
benchmark's description, become a cell that runs: no existing file of the
harness changes."""
import json

import torch

from nsbench import control
from nsbench.harness import Bench, run_cell


def test_new_files_make_a_new_cell(tiny_bench, tmp_path):
    root = tiny_bench.root
    # a new configuration: a smaller symmetric power-law graph
    cfg = json.loads((root / "configs" / "reddit.json").read_text())
    cfg["name"] = "toy"
    cfg["graph"].update(n=800, nonzeros=14000, avg_degree=9.0, skew=1.4,
                        seed=3)
    (root / "configs" / "toy.json").write_text(json.dumps(cfg))
    # a new mix: narrower right-hand sides, one in flight
    (root / "traffic" / "narrow.json").write_text(json.dumps(
        {"kind": "spmm_closed_loop", "n_rhs": 32, "pool": 2,
         "in_flight": 1, "warmup_rounds": 1, "check_outputs": 2}))
    # a new metric: calls completed in the window
    (root / "metrics" / "calls.toy.py").write_text(
        "def read(run):\n    return float(run.counters['calls'])\n")
    (root / "limits" / "toy.narrow.json").write_text(json.dumps(
        {"limits": {"spmm_err": 1e-5}}))
    spec = dict(tiny_bench.spec)
    spec["configs"] = spec["configs"] + [{"name": "toy"}]
    spec["workloads"] = spec["workloads"] + [
        {"name": "toy.narrow", "config": "toy", "traffic": "narrow",
         "chips": 1, "why": "test"}]
    spec["per_layer"] = spec["per_layer"] + [
        {"name": "calls.toy", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "executor",
         "moves": "spmm_gflops", "workloads": ["toy.narrow"]}]
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + ["toy.narrow"])
                          if m["name"] == "spmm_gflops" else m
                          for m in spec["end_to_end"]]
    bench = Bench(spec, root)

    line = run_cell(bench, "toy.narrow", 5, 0.1, False, "cpu")
    assert line["correct"], line
    assert set(line["metrics"]) == {"spmm_gflops", "setup_s"}
    assert line["attempted"] > 0

    line = run_cell(bench, "toy.narrow", 5, 0.1, True, "cpu")
    assert line["correct"], line
    assert line["metrics"]["calls.toy"]["value"] == line["attempted"]
    assert list(line)[-1] == "compared"


def test_cells_report_only_their_metrics(tiny_bench):
    b = tiny_bench
    e2e = {m["name"] for m in b.metrics_of("ogbn-arxiv.gcn_train",
                                          "end_to_end")}
    assert e2e == {"gcn_epoch_ms", "gcn_epoch_p95_ms", "setup_s"}
    layer = {m["name"] for m in b.metrics_of("reddit.spmm", "per_layer")}
    assert layer == {"prepare_s", "dispatch_ms.spmm", "spmm_roofline",
                     "idle_frac.spmm"}


NEW_KIND = """
import time

import torch

from nsbench import counts, drive, faults, reference


class Load(drive.Load):
    # each call multiplies A by B and then by the result: A @ (A @ B)

    def setup(self):
        self.prepare()
        self.b = torch.randn((self.counters["k"], self.mix["n_rhs"]),
                             generator=drive.generator(self.device, self.seed),
                             device=self.device)
        self.counters["n_rhs"] = self.mix["n_rhs"]

    def window(self, seconds):
        import repro_torch.sparse as sp

        calls, t0 = 0, time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            with self.rec.span("dispatch"):
                self.c = sp.spmm(self.a, sp.spmm(self.a, self.b))
            calls += 1
        window_s = time.perf_counter() - t0
        self.attempted = calls
        self.counters.update(calls=2 * calls, window_s=window_s)
        flops = counts.spmm_flops(self.counters["nnz"], self.mix["n_rhs"])
        return {"spmm_gflops": counts.gflops(flops, 2 * calls, window_s)}

    def check(self, limits):
        rows, cols, vals, shape = self.coo
        op = reference.CooOperator(rows, cols, vals, shape, self.device)
        want = op.matmul(op.matmul(self.b))
        gap = float((self.c.double() - want).norm() / want.norm())
        return {"two_hop_gap": gap}


def control(bench, cfg, mix, seed, device):
    return {"two_hop_gap": 1.0}


FAULTS = {"none": lambda: faults.patched({"x": 0}, "x", 1)}
"""

NEW_GENERATOR = """
import numpy as np


def build(g, device):
    # a ring: each node linked to the next ``hops`` nodes
    n, hops = g["n"], g["hops"]
    rows = np.repeat(np.arange(n), hops)
    cols = (rows + np.tile(np.arange(1, hops + 1), n)) % n
    return rows, cols, None, (n, n), None
"""


def test_new_kind_and_generator_from_new_files(tiny_bench):
    root = tiny_bench.root
    (root / "kinds" / "two_hop.py").write_text(NEW_KIND)
    (root / "generators" / "ring.py").write_text(NEW_GENERATOR)
    (root / "configs" / "ring.json").write_text(json.dumps(
        {"name": "ring", "graph": {"generator": "ring", "n": 500, "hops": 3},
         "values": "seed"}))
    (root / "traffic" / "two_hop.json").write_text(json.dumps(
        {"kind": "two_hop", "n_rhs": 8}))
    (root / "limits" / "ring.two_hop.json").write_text(json.dumps(
        {"limits": {"two_hop_gap": 1e-5}}))
    spec = dict(tiny_bench.spec)
    spec["workloads"] = spec["workloads"] + [
        {"name": "ring.two_hop", "config": "ring", "traffic": "two_hop",
         "chips": 1, "why": "test"}]
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + ["ring.two_hop"])
                          if m["name"] == "spmm_gflops" else m
                          for m in spec["end_to_end"]]
    spec["per_layer"] = [dict(m, workloads=m["workloads"] + ["ring.two_hop"])
                         if m["name"] == "dispatch_ms.spmm" else m
                         for m in spec["per_layer"]]
    bench = Bench(spec, root)

    line = run_cell(bench, "ring.two_hop", 3, 0.1, False, "cpu")
    assert line["correct"], line
    assert set(line["metrics"]) == {"spmm_gflops", "setup_s"}
    line = run_cell(bench, "ring.two_hop", 3, 0.1, True, "cpu")
    assert line["correct"], line
    assert line["metrics"]["dispatch_ms.spmm"]["value"] > 0
    assert control.control_readings(bench, "ring.two_hop", [1],
                                    torch.device("cpu")) == [
        {"two_hop_gap": 1.0}]
    assert list(bench.kind_of("ring.two_hop").FAULTS) == ["none"]


def test_reader_falls_back_to_the_name_before_the_dot(tiny_bench):
    assert (tiny_bench.reader("idle_frac.spmm")
            is tiny_bench.reader("idle_frac.gcn"))
    assert (tiny_bench.reader("dispatch_ms.spmm")
            is tiny_bench.reader("dispatch_ms.gcn"))
