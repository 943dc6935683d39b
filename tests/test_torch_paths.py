"""Per-path execution and adaptive coordination (paper §5.3) of the port.

``repro_torch.exec.api.execute_matrix_path`` / ``execute_vector_path``,
``neutron_spmm`` and ``NeutronSpMM`` against ``repro.exec.api``'s on
``impl="xla"`` (never ``"pallas_interpret"``: the reference's fringe
kernels do not run on this jax), on the same numpy inputs from a seed;
and the synchronised timer of ``repro_torch.core.tuner`` with its
calibration use in ``EngineCostModel.measure``.

Tolerances: against the reference, max |diff| <= 1e-5 * max(1, max|ref|)
(the tolerance of ``tests/test_fused_executor.py``: fp32 on both sides,
summed in a different order); against fp64 dense in the epoch loop,
rtol = atol = 1e-4 (the reference's ``test_epoch_loop_adapts``).  The sum
of the two paths is held bit for bit against the port's fused
``execute``: the fused body adds the same two tensors in the same order.
Plan leaves after each re-prepare are held exactly.

The ``gpu`` tests at the end run the "cuda" paths on the card against the
plain versions and time the two paths on two streams; they skip without a
card.
"""
import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.core import spmm, tuner
from repro_torch.core.cost_model import EngineCostModel, default_cost_model
from repro_torch.core.plan_ir import LEAF_NAMES, SpmmConfig
from repro_torch.data.graphs import PAPER_DATASETS, generate
from repro_torch.errors import DispatchError
from repro_torch.exec import api
from repro_torch.kernels import ops
from conftest import make_sparse

TOL = 1e-5
TOL_DENSE = 1e-4
PANEL = ["cora", "ogbn-arxiv", "F1", "reddit"]
ALPHAS = [None, 1.0, 1e-9]


def _jax():
    """The JAX package's modules, or a skip where it is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import spmm as jax_spmm
    from repro.exec import api as jax_api

    return types.SimpleNamespace(jnp=jnp, spmm=jax_spmm, api=jax_api)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size \
        else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, (err, scale)


def _bitwise(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal bit for bit, NaN cells included (NaN payloads aside)."""
    assert got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert torch.equal(got[keep], want[keep])


def _panel(name, max_dim=2048):
    spec = PAPER_DATASETS[name]
    spec = dataclasses.replace(spec, m=min(spec.m, max_dim),
                               k=min(spec.k, max_dim))
    rows, cols, vals = generate(spec)
    return rows, cols, vals, (spec.m, spec.k)


def _pair(j, rows, cols, vals, shape, **cfg):
    ours = spmm.prepare(rows, cols, vals, shape,
                        SpmmConfig(impl="torch", **cfg))
    theirs = j.spmm.prepare(rows, cols, vals, shape,
                            j.spmm.SpmmConfig(impl="xla", **cfg))
    return ours, theirs


@pytest.mark.parametrize("alpha", ALPHAS, ids=lambda a: f"alpha={a}")
@pytest.mark.parametrize("name", PANEL)
def test_paths_match_reference_on_panel(name, alpha):
    j = _jax()
    rows, cols, vals, shape = _panel(name)
    ours, theirs = _pair(j, rows, cols, vals, shape, alpha=alpha)
    b = np.random.RandomState(shape[0]).randn(shape[1], 40).astype(
        np.float32)
    bt, bj = torch.from_numpy(b), j.jnp.asarray(b)
    cm = api.execute_matrix_path(ours, bt)
    cv = api.execute_vector_path(ours, bt)
    _close(cm, j.api.execute_matrix_path(theirs, bj))
    _close(cv, j.api.execute_vector_path(theirs, bj))
    _bitwise(cm + cv, api.execute(ours, bt))


@pytest.mark.parametrize("planted", ["finite", "inf", "nan", "inf+nan"])
@pytest.mark.parametrize("cfg", [
    dict(),
    dict(alpha=1.0),
    dict(alpha=1e-9, enable_col_stage=False),
    dict(reorder_cols=True),
    dict(fringe_vmem_budget=60_000),    # the streaming tier
    dict(bm=32, bk=16, fringe_chunk=5),
], ids=["default", "all-fringe", "all-core", "reorder-cols", "ksharded",
        "small-tiles"])
def test_path_sum_is_fused_execute_bitwise(cfg, planted):
    """The two paths' sum equals the fused executor bit for bit, also with
    +Inf and NaN in B (NaN and Inf fall in the same cells)."""
    rng = np.random.RandomState(5)
    _, rows, cols, vals = make_sparse(rng, 150, 130, 0.08, n_dense_rows=6)
    plan = spmm.prepare(rows, cols, vals, (150, 130),
                        SpmmConfig(impl="torch", **cfg))
    b = torch.from_numpy(rng.randn(130, 24).astype(np.float32))
    if "inf" in planted:
        b[7, 3] = float("inf")
        b[11, 5] = -float("inf")
    if "nan" in planted:
        b[int(cols[0]), 9] = float("nan")
    fused = api.execute(plan, b)
    both = api.execute_matrix_path(plan, b) + api.execute_vector_path(plan, b)
    _bitwise(both, fused)
    if planted != "finite":
        assert not torch.isfinite(fused).all()


def _spy(monkeypatch, name):
    calls = []
    real = getattr(ops, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, name, spy)
    return calls


@pytest.mark.parametrize("empty", ["core", "fringe", "both"])
def test_empty_path_is_zeros_without_launches(monkeypatch, empty):
    rng = np.random.RandomState(2)
    _, rows, cols, vals = make_sparse(rng, 90, 70, 0.08, n_dense_rows=4)
    cfg = {"core": dict(alpha=1.0),
           "fringe": dict(alpha=1e-9, enable_col_stage=False),
           "both": {}}[empty]
    if empty == "both":
        rows, cols, vals = rows[:0], cols[:0], vals[:0]
    plan = spmm.prepare(rows, cols, vals, (90, 70),
                        SpmmConfig(impl="torch", **cfg))
    assert plan.has_core == (empty == "fringe")
    assert plan.has_fringe == (empty == "core")
    b = torch.from_numpy(rng.randn(70, 12).astype(np.float32))
    calls_m = _spy(monkeypatch, "block_stream_spmm")
    calls_v = _spy(monkeypatch, "fringe_spmm")
    ops.reset_launch_counts()
    paths = {"core": api.execute_matrix_path, "fringe": api.execute_vector_path}
    for which, path in paths.items():
        out = path(plan, b)
        if empty in (which, "both"):
            assert out.dtype == torch.float32 and out.shape == (90, 12)
            assert not out.any()
    assert len(calls_m) == (empty == "fringe")
    assert len(calls_v) == (empty == "core")
    assert not any(ops.launch_counts().values())


def _nm_coo(rng, m, k, n_pat, m_pat):
    """A seeded n:m-pruned (m, k) matrix as sorted COO."""
    groups = rng.rand(m, k // m_pat, m_pat).argsort(axis=2) < n_pat
    keep = groups.reshape(m, k)
    rows, cols = np.nonzero(keep)
    vals = rng.randn(rows.size).astype(np.float32)
    return rows.astype(np.int64), cols.astype(np.int64), vals


def test_matrix_path_runs_the_general_stream_on_an_nm_plan(monkeypatch):
    """As the reference's: ``execute_matrix_path`` runs B1 on the general
    tiles of an N:M plan, never the N:M kernel."""
    j = _jax()
    rows, cols, vals = _nm_coo(np.random.RandomState(24), 256, 256, 2, 4)
    ours, theirs = _pair(j, rows, cols, vals, (256, 256),
                         structure_hint=("nm", 2, 4))
    assert ours.matrix_format == theirs.matrix_format == "nm"
    b = np.random.RandomState(1).randn(256, 32).astype(np.float32)
    fused = api.execute(ours, torch.from_numpy(b))

    def refused(*args, **kwargs):
        raise AssertionError("the matrix path ran the N:M kernel")

    monkeypatch.setattr(ops, "nm_stream_spmm", refused)
    general = _spy(monkeypatch, "block_stream_spmm")
    cm = api.execute_matrix_path(ours, torch.from_numpy(b))
    assert general == ["block_stream_spmm"]
    _close(cm, j.api.execute_matrix_path(theirs, j.jnp.asarray(b)))
    cv = api.execute_vector_path(ours, torch.from_numpy(b))
    _close(cm + cv, fused)


def test_neutron_spmm_matches_reference():
    j = _jax()
    rng = np.random.RandomState(4)
    a, rows, cols, vals = make_sparse(rng, 120, 100, 0.06, n_dense_rows=5)
    b = rng.randn(100, 20).astype(np.float32)
    got = api.neutron_spmm(rows, cols, vals, a.shape, torch.from_numpy(b),
                           SpmmConfig(impl="torch"), device="cpu")
    want = j.api.neutron_spmm(rows, cols, vals, a.shape, j.jnp.asarray(b),
                              j.spmm.SpmmConfig(impl="xla"))
    _close(got, want)
    _close(got, a.astype(np.float64) @ b.astype(np.float64))


class _InjectedClock:
    """A host clock that stands still; the paths move it."""

    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _inject(monkeypatch, module, clock, times):
    """Make ``module``'s per-path executors advance ``clock`` by
    ``times["matrix"]`` / ``times["vector"]`` seconds per call."""
    for key, name in (("matrix", "execute_matrix_path"),
                      ("vector", "execute_vector_path")):
        real = getattr(module, name)

        def timed(plan, b, _real=real, _key=key):
            out = _real(plan, b)
            clock.t += times[_key]
            return out

        monkeypatch.setattr(module, name, timed)


# per-epoch (matrix, vector) path seconds: the matrix path slower, then
# the vector path, then balanced (within 1 + epsilon: no rebalance)
EPOCH_TIMES = [(3e-3, 1e-3), (3e-3, 1e-3), (1e-3, 2.5e-3), (2e-3, 1e-3),
               (1e-3, 1e-3), (1.0005e-3, 1.0006e-3), (1.3e-3, 1e-3)]


def test_epoch_loop_matches_reference_with_injected_times(monkeypatch):
    """The same path times into both clocks give the reference's alpha
    trajectory and re-prepared leaves exactly equal to its own; every
    epoch's result is correct against fp64 dense (the port of
    ``tests/test_spmm.py::test_epoch_loop_adapts``)."""
    j = _jax()
    rng = np.random.RandomState(0)
    a, rows, cols, vals = make_sparse(rng, 256, 128, 0.05, n_dense_rows=16)
    b = rng.randn(128, 128).astype(np.float32)
    times = {"matrix": 0.0, "vector": 0.0}
    ours_clock, theirs_clock = _InjectedClock(), _InjectedClock()
    monkeypatch.setattr(api, "_clock", ours_clock)
    monkeypatch.setattr(j.api, "time",
                        types.SimpleNamespace(perf_counter=theirs_clock))
    _inject(monkeypatch, api, ours_clock, times)
    _inject(monkeypatch, j.api, theirs_clock, times)
    ours = api.NeutronSpMM(rows, cols, vals, a.shape,
                           SpmmConfig(impl="torch"), device="cpu")
    theirs = j.api.NeutronSpMM(rows, cols, vals, a.shape,
                               j.spmm.SpmmConfig(impl="xla"))
    expect = a.astype(np.float64) @ b.astype(np.float64)
    alphas = set()
    for t_m, t_v in EPOCH_TIMES:
        times.update(matrix=t_m, vector=t_v)
        out = ours.run_epoch(torch.from_numpy(b))
        out_ref = theirs.run_epoch(j.jnp.asarray(b))
        np.testing.assert_allclose(out.numpy(), expect, rtol=TOL_DENSE,
                                   atol=TOL_DENSE)
        _close(out, out_ref)
        alphas.add(ours._alpha)
        assert ours._alpha == theirs._alpha
        assert ours.plan.stats_dict["alpha"] == theirs.plan.stats_dict[
            "alpha"]
        ref_leaves, _ = theirs.plan.tree_flatten()
        for name, ref_leaf in zip(LEAF_NAMES, ref_leaves):
            got = getattr(ours.plan, name).numpy()
            want = np.asarray(ref_leaf)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert np.array_equal(got, want), name
    keys = ("t_matrix", "t_vector", "skew", "alpha")
    assert [{k: e[k] for k in keys} for e in ours.epoch_log] == \
        theirs.epoch_log
    assert len(alphas) >= 3     # the loop moved alpha both ways
    assert all(e["t_matrix_device"] is None and e["t_vector_device"] is None
               for e in ours.epoch_log)   # no CUDA events on the CPU
    assert len(ours.prepare_seconds) == len(alphas)


def test_cuda_paths_raise_without_a_card():
    """A "cuda" NeutronSpMM (and so every per-path call on its plan) has
    no CPU fallback: with no card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")
    rng = np.random.RandomState(1)
    a, rows, cols, vals = make_sparse(rng, 40, 30, 0.1)
    with pytest.raises(Exception, match="(?i)cuda"):
        api.NeutronSpMM(rows, cols, vals, a.shape)
    with pytest.raises(Exception, match="(?i)cuda"):
        api.neutron_spmm(rows, cols, vals, a.shape,
                         torch.zeros(30, 4), SpmmConfig())
    plan = spmm.prepare(rows, cols, vals, a.shape, SpmmConfig(impl="torch"))
    elsewhere = torch.zeros((30, 4), device="meta")
    for path in (api.execute_matrix_path, api.execute_vector_path):
        with pytest.raises(DispatchError):
            path(plan, elsewhere)
        with pytest.raises(ValueError):
            path(plan, torch.zeros((2, 30, 4)))   # one (K, N) operand


class _Queue:
    """A stand-in for a CUDA stream: calls queue work and return at once;
    the work (a sleep) happens when ``torch.cuda.synchronize`` is called.
    ``clock`` is a simulated clock that advances by the queued work at each
    synchronisation, for tests that must not read the wall clock."""

    def __init__(self):
        self.pending = 0.0
        self.now = 0.0
        self.log = []

    def clock(self):
        return self.now

    def submit(self, seconds, tag):
        self.pending += seconds
        self.log.append(("call", tag))
        return types.SimpleNamespace(device=torch.device("cuda", 0))

    def synchronize(self, device=None):
        self.log.append(("sync", str(device)))
        time.sleep(self.pending)
        self.now += self.pending
        self.pending = 0.0


def test_timed_best_of_synchronizes_after_each_call(monkeypatch):
    q = _Queue()
    monkeypatch.setattr(torch.cuda, "synchronize", q.synchronize)
    real_clock = time.perf_counter

    def clock():
        q.log.append(("clock",))
        return real_clock()

    monkeypatch.setattr(tuner, "time", types.SimpleNamespace(
        perf_counter=clock))
    t = tuner.timed_best_of(lambda: q.submit(0.003, "f"), repeats=2,
                            warmup=1)
    assert t >= 0.003   # without the sync this measures the ~0 s enqueue
    assert q.log == [
        ("call", "f"), ("sync", "cuda:0"),                        # warm-up
        ("clock",), ("call", "f"), ("sync", "cuda:0"), ("clock",),
        ("clock",), ("call", "f"), ("sync", "cuda:0"), ("clock",),
    ]
    # nested results: each device of each tensor, once per call
    q.log.clear()
    two = (types.SimpleNamespace(device=torch.device("cuda", 0)),
           {"x": [types.SimpleNamespace(device=torch.device("cuda", 1))]},
           torch.zeros(2))
    tuner.synchronize(two)
    assert q.log == [("sync", "cuda:0"), ("sync", "cuda:1")]


def test_measure_calibration_synchronizes_async_benches(monkeypatch):
    """The port of ``tests/test_cost_model.py``'s calibration test: a bench
    whose cost hides behind an asynchronous launch must still calibrate
    (best of 3).  The timer reads the queue's simulated clock, which moves
    only when the queue synchronises, so a loaded host cannot decide it."""
    q = _Queue()
    monkeypatch.setattr(torch.cuda, "synchronize", q.synchronize)
    monkeypatch.setattr(tuner, "time", types.SimpleNamespace(
        perf_counter=q.clock))
    cm = EngineCostModel.measure(
        lambda: q.submit(0.0, "matrix"), lambda: q.submit(0.004, "vector"),
        1000.0, 1000.0, repeats=3,
    )
    # the slow vector engine calibrates a much lower rate; without the
    # sync both benches measure their enqueue and the ratio is ~1
    assert cm.p_matrix > 5 * cm.p_vector


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_pair(cuda):
    rows, cols, vals, shape = _panel("reddit", 4096)
    # both at the reference's split, which gives this panel a core
    alpha = default_cost_model().alpha
    ours = spmm.prepare(rows, cols, vals, shape,
                        SpmmConfig(impl="cuda", alpha=alpha), device=cuda)
    plain = spmm.prepare(rows, cols, vals, shape,
                         SpmmConfig(impl="torch", alpha=alpha))
    b = np.random.RandomState(3).randn(shape[1], 256).astype(np.float32)
    return ours, plain, torch.from_numpy(b)


@pytest.mark.gpu
def test_cuda_paths_match_plain(cuda):
    ours, plain, b = _cuda_pair(cuda)
    assert ours.has_core and ours.has_fringe
    bc = b.to(cuda)
    ops.reset_launch_counts()
    cm = api.execute_matrix_path(ours, bc)
    torch.cuda.synchronize()
    counts_m = ops.launch_counts()
    ops.reset_launch_counts()
    cv = api.execute_vector_path(ours, bc)
    torch.cuda.synchronize()
    counts_v = ops.launch_counts()
    assert counts_m["dense_tile_spmm"] == 1 and sum(counts_m.values()) == 1
    assert sum(counts_v.values()) == 1 and counts_v["dense_tile_spmm"] == 0
    for got, want in ((cm, api.execute_matrix_path(plain, b)),
                      (cv, api.execute_vector_path(plain, b))):
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-4 * max(1.0, want.abs().max().item()), err
    _bitwise(cm + cv, api.execute(ours, bc))


@pytest.mark.gpu
def test_cuda_paths_on_two_streams(cuda):
    """The two paths launched on two streams from one synchronised start give
    the one-stream results bit for bit; the wall time to a synchronised
    end is read for each way."""
    ours, _, b = _cuda_pair(cuda)
    bc = b.to(cuda)
    serial = (api.execute_matrix_path(ours, bc),
              api.execute_vector_path(ours, bc))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for stream, path in zip(streams, (api.execute_matrix_path,
                                          api.execute_vector_path)):
            with torch.cuda.stream(stream):
                outs.append(path(ours, bc))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    for got, want in zip(outs, serial):
        _bitwise(got, want)
    assert min(walls) > 0
