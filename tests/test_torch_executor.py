"""repro_torch ``execute`` against ``repro.exec.api.execute`` and fp64 dense.

Plans come from the port's ``prepare`` and, independently of it, from the
JAX package's ``prepare`` carried across with
``repro_torch.interop.plan_from_arrays``.  Operands are (K, N) and
(batch, K, N), made with numpy from a seed.  Tolerance:
max |diff| <= 1e-5 * max(1, max |ref|) (fp32 on both sides, summed in a
different order); against the fp64 dense product the same bound.
"""
import dataclasses

import numpy as np
import pytest
import torch

# held against the JAX package: skip where it is not installed (the
# card's machine need not have it; tests/test_torch_gpu.py runs there)
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import spmm as jax_spmm  # noqa: E402
from repro.data import graphs  # noqa: E402
from repro.exec import api as jax_api  # noqa: E402
from repro_torch.core import spmm  # noqa: E402
from repro_torch.core.plan_ir import LEAF_NAMES, SpmmConfig  # noqa: E402
from repro_torch.errors import DispatchError, PlanBuildError  # noqa: E402
from repro_torch.exec import api, cache  # noqa: E402
from repro_torch.interop import plan_from_arrays  # noqa: E402
from conftest import make_sparse  # noqa: E402

TOL = 1e-5
_PORT_FIELDS = {f.name for f in dataclasses.fields(SpmmConfig)}


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= TOL * scale, (err, scale)


def _dense(rows, cols, vals, shape):
    a = np.zeros(shape, np.float64)
    np.add.at(a, (rows, cols), np.asarray(vals, np.float64))
    return a


def _carried(jplan, impl="torch"):
    """The port plan made from a JAX plan's leaves and metadata."""
    leaves, _ = jplan.tree_flatten()
    cfg = {k: v for k, v in dataclasses.asdict(jplan.config).items()
           if k in _PORT_FIELDS}
    cfg["impl"] = impl
    return plan_from_arrays(
        {n: np.asarray(x) for n, x in zip(LEAF_NAMES, leaves)},
        dict(shape=jplan.shape, config=cfg, stats=jplan.stats,
             fringe_tier=jplan.fringe_tier, fringe_bk=jplan.fringe_bk,
             matrix_format=jplan.matrix_format,
             format_params=jplan.format_params))


def _check_plan_pair(rows, cols, vals, shape, n=40, batch=3, **cfg):
    rng = np.random.RandomState(shape[0] + n)
    b = rng.randn(shape[1], n).astype(np.float32)
    bb = rng.randn(batch, shape[1], n).astype(np.float32)
    ours = spmm.prepare(rows, cols, vals, shape,
                        SpmmConfig(impl="torch", **cfg))
    jplan = jax_spmm.prepare(rows, cols, vals, shape,
                             jax_spmm.SpmmConfig(impl="xla", **cfg))
    carried = _carried(jplan)
    a = _dense(rows, cols, vals, shape)
    want = np.asarray(jax_api.execute(jplan, jnp.asarray(b)))
    want_b = np.asarray(jax_api.execute(jplan, jnp.asarray(bb)))
    for plan in (ours, carried):
        got = api.execute(plan, torch.from_numpy(b))
        _close(got, want)
        _close(got, a @ b.astype(np.float64))
        got_b = api.execute(plan, torch.from_numpy(bb))
        _close(got_b, want_b)
        _close(got_b, np.einsum("mk,bkn->bmn", a, bb.astype(np.float64)))
    return ours, carried


@pytest.mark.parametrize("name", ["cora", "ogbn-arxiv", "F1", "reddit"])
def test_execute_matches_reference_on_panel(name):
    spec = graphs.PAPER_DATASETS[name]
    spec = dataclasses.replace(spec, m=min(spec.m, 2048),
                               k=min(spec.k, 2048))
    rows, cols, vals = graphs.generate(spec)
    _check_plan_pair(rows, cols, vals, (spec.m, spec.k), n=72)


def test_execute_ksharded_plan_matches_reference():
    """The ogbn-arxiv stand-in takes the streaming tier at full size."""
    spec = graphs.PAPER_DATASETS["ogbn-arxiv"]
    rows, cols, vals = graphs.generate(spec)
    ours, carried = _check_plan_pair(rows, cols, vals, (spec.m, spec.k),
                                     n=24, batch=2)
    assert ours.fringe_tier == carried.fringe_tier == "ksharded"


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(alpha=1.0),
    dict(alpha=1e-9, enable_col_stage=False),
    dict(reorder_cols=True),
    dict(fringe_chunk=5),
    dict(bm=32, bk=16, bn=128),
])
def test_execute_matches_reference_across_configs(cfg):
    rng = np.random.RandomState(3)
    _, rows, cols, vals = make_sparse(rng, 150, 130, 0.08, n_dense_rows=6)
    _check_plan_pair(rows, cols, vals, (150, 130), **cfg)


@pytest.mark.parametrize("budget", [None, 60_000, 4_096])
def test_execute_each_tier_matches_reference(budget):
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 60, 400)
    cols = rng.randint(0, 96, 400)
    vals = rng.randn(400).astype(np.float32)
    _check_plan_pair(rows, cols, vals, (60, 96), bn=128, alpha=1.0,
                     fringe_vmem_budget=budget)


def test_carried_pallas_plan_keeps_its_kbucketed_stream():
    rows, cols, vals = (np.random.RandomState(0).randint(0, 60, 400),
                        np.random.RandomState(1).randint(0, 96, 400),
                        np.random.RandomState(2).randn(400))
    jplan = jax_spmm.prepare(
        rows, cols, vals, (60, 96),
        jax_spmm.SpmmConfig(impl="pallas", bn=128, alpha=1.0,
                            fringe_vmem_budget=60_000))
    carried = _carried(jplan)
    assert carried.fringe_tier == "ksharded"
    assert np.array_equal(carried.fringe_kb_rows.numpy(),
                          np.asarray(jplan.fringe_kb_rows))
    b = np.random.RandomState(4).randn(96, 20).astype(np.float32)
    _close(api.execute(carried, torch.from_numpy(b)),
           _dense(rows, cols, vals, (60, 96)) @ b.astype(np.float64))


def test_carried_ksharded_plan_without_stream_refuses_the_card_impl():
    """A plan the reference built with impl="xla" holds dummy kb leaves; the
    streaming kernel cannot run it, so carrying it to impl="cuda" raises
    (the check precedes any device test)."""
    rows, cols, vals = (np.random.RandomState(0).randint(0, 60, 400),
                        np.random.RandomState(1).randint(0, 96, 400),
                        np.random.RandomState(2).randn(400))
    jplan = jax_spmm.prepare(
        rows, cols, vals, (60, 96),
        jax_spmm.SpmmConfig(impl="xla", bn=128, alpha=1.0,
                            fringe_vmem_budget=60_000))
    with pytest.raises(PlanBuildError, match="k-bucketed"):
        _carried(jplan, impl="cuda")


def test_empty_matrix_executes_to_zeros():
    empty = np.zeros(0, np.int64)
    plan = spmm.prepare(empty, empty, np.zeros(0, np.float32), (32, 48),
                        SpmmConfig(impl="torch"))
    out = api.execute(plan, torch.ones(48, 16))
    assert out.shape == (32, 16) and not out.any()
    outb = api.execute(plan, torch.ones(2, 48, 16))
    assert outb.shape == (2, 32, 16) and not outb.any()


def test_executor_cache_builds_once_for_repeated_calls():
    rng = np.random.RandomState(9)
    _, rows, cols, vals = make_sparse(rng, 120, 100, 0.06, n_dense_rows=4)
    plan = spmm.prepare(rows, cols, vals, (120, 100),
                        SpmmConfig(impl="torch", seed=123))
    b = torch.from_numpy(rng.randn(100, 48).astype(np.float32))
    api.execute(plan, b)
    builds, dispatches = cache.fused_trace_count(), cache.dispatch_count()
    hits = cache.EXECUTOR_CACHE.hits
    for _ in range(5):
        api.execute(plan, b)
    assert cache.fused_trace_count() == builds
    assert cache.dispatch_count() == dispatches + 5
    assert cache.EXECUTOR_CACHE.hits == hits + 5
    # a batched operand is its own executor, built once too
    bb = b.expand(2, -1, -1).contiguous()
    api.execute(plan, bb)
    api.execute(plan, bb)
    assert cache.fused_trace_count() == builds + 1


def test_executor_cache_is_bounded():
    c = cache.ExecutorCache(capacity=2)
    evictions = c.evictions
    for key in range(4):
        c.get_or_build(("k", key), lambda: object())
    assert len(c) == 2 and c.evictions == evictions + 2
    assert ("k", 3) in c and ("k", 0) not in c


def test_execute_rejects_bad_operands():
    rng = np.random.RandomState(0)
    _, rows, cols, vals = make_sparse(rng, 30, 20, 0.2)
    plan = spmm.prepare(rows, cols, vals, (30, 20), SpmmConfig(impl="torch"))
    with pytest.raises(ValueError, match="K=19"):
        api.execute(plan, torch.ones(19, 4))
    with pytest.raises(ValueError, match="b must be"):
        api.execute(plan, torch.ones(20))
    with pytest.raises(DispatchError):
        api.execute(plan, torch.ones(20, 4, device="meta"))


def test_metrics_registry_counts_and_caps_series():
    from repro_torch.obs import REGISTRY, MetricsRegistry

    snap = REGISTRY.snapshot()
    assert {"core_prepares_total", "exec_traces_total",
            "exec_dispatches_total", "exec_cache_events_total"} <= set(snap)
    reg = MetricsRegistry()
    c = reg.counter("x_total", "a counter", labelnames=("k",), max_series=2)
    assert reg.counter("x_total", labelnames=("k",)) is c
    with pytest.raises(ValueError):
        reg.counter("x_total", labelnames=("other",))
    with pytest.raises(ValueError):
        c.inc(-1, k="a")
    for key in ("a", "b", "c", "d"):
        c.inc(k=key)
    assert c.value(k="a") == 1 and c.value(k="__other__") == 2
    assert c.total() == 4
    assert reg.snapshot()["__dropped_series__"] == {"x_total": 2}
    reg.reset_values()
    assert c.total() == 0 and reg.get("x_total") is c
