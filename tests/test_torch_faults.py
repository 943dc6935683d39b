"""The port's fault harness and health-gated dispatch, on the CPU.

Mirrors ``tests/test_faults.py`` where a test does not assume a degrade
tier: the seven harness tests, ``chaos_schedule(seed)`` against the
reference's for the same seeds, the chaos smoke test, a ``"torch"``
plan's build fault propagating as it is (the reference's ``"xla"`` test),
and the three registry tests (``registry_write`` raises a clean
``RegistryError`` and keeps the previous generation; ``registry_read``
falls back one generation, or raises once every generation fails).

The port has no degrade tier: a ``"cuda"`` dispatch that fails raises
``KernelLoweringError`` and is recorded in ``exec.health.HEALTH``; inside
its backoff, and once demoted, it raises without building or launching
anything.  No ``"cuda"`` plan can be prepared here, so those tests call
``exec.api._guarded_call`` on a ``"cuda"``-tagged signature with a stub
``make_fn`` that runs the real executor build (which fires the seams) and
returns a stand-in for the launch.

Left out, and why:

- ``test_pallas_build_failure_degrades_bit_identically``,
  ``test_pallas_lowering_failure_degrades``,
  ``test_degrade_disabled_surfaces_kernel_lowering_error`` and
  ``test_dispatch_error_when_every_tier_fails``: there is no degrade tier
  (and no ``SpmmConfig.degrade_to_xla``); their gating is covered by the
  raising counterparts below.

Plans get unique shapes per test: the executor cache is process-wide, and
the build seams fire per *build*, so a shape reused from another test
would hit the cache and never reach the seam.
"""
import os
import threading
import warnings
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from repro.robust import faults as ref_faults
from repro_torch.core import spmm
from repro_torch.core.plan_ir import (
    SIG_IMPL, build_delta_fringe, general_format_sig,
)
from repro_torch.dynamic import DynamicPlan, PlanRegistry, RegistryError
from repro_torch.errors import (
    DispatchError, FaultInjected, KernelLoweringError, ReproError,
)
from repro_torch.exec import api
from repro_torch.exec.health import HEALTH, HealthTable
from repro_torch.exec.pipeline import build_executor
from repro_torch.robust.faults import HARNESS, SEAMS, armed, chaos_schedule
from conftest import make_sparse

CFG_KW = dict(bm=32, bk=16, bn=32)


@pytest.fixture(autouse=True)
def _clean_harness():
    HARNESS.reset()
    HEALTH.reset()
    yield
    HARNESS.reset()
    HEALTH.reset()


def _plan(rng, m, k, **cfg_kw):
    a, rows, cols, vals = make_sparse(rng, m, k, 0.08, n_dense_rows=2)
    cfg = spmm.SpmmConfig(impl="torch", **{**CFG_KW, **cfg_kw})
    return a, spmm.prepare(rows, cols, vals, a.shape, cfg, device="cpu")


# ---------------------------------------------------------------------------
# harness mechanics
# ---------------------------------------------------------------------------
def test_unknown_seam_rejected():
    with pytest.raises(ValueError, match="unknown fault seam"):
        HARNESS.arm("not_a_seam")
    with pytest.raises(ValueError, match="unknown fault seam"):
        HARNESS.calls("not_a_seam")
    assert "executor_build" in SEAMS and len(SEAMS) == 6
    assert SEAMS == ref_faults.SEAMS


def test_disarmed_fire_only_counts():
    before = HARNESS.calls("dispatch")
    HARNESS.fire("dispatch", context="m")
    assert HARNESS.calls("dispatch") == before + 1
    assert HARNESS.fired("dispatch") == 0


def test_fail_once_fail_n_and_after_policies():
    HARNESS.arm("dispatch", times=2, after=1)
    HARNESS.fire("dispatch")  # after=1: first matching call passes
    for _ in range(2):
        with pytest.raises(FaultInjected):
            HARNESS.fire("dispatch")
    HARNESS.fire("dispatch")  # budget (times=2) exhausted
    assert HARNESS.fired("dispatch") == 2

    HARNESS.arm("dispatch", times=None)  # fail forever
    for _ in range(3):
        with pytest.raises(FaultInjected):
            HARNESS.fire("dispatch")


def test_match_predicate_filters_context_without_consuming_budget():
    HARNESS.arm("fold_build", times=1, match=lambda ctx: ctx == "bad")
    HARNESS.fire("fold_build", context="good")  # filtered: no fire
    HARNESS.fire("fold_build", context="good")
    with pytest.raises(FaultInjected):
        HARNESS.fire("fold_build", context="bad")
    HARNESS.fire("fold_build", context="bad")  # fail-once budget spent


def test_custom_exception_and_message():
    HARNESS.arm("registry_write", exc=OSError, message="disk full")
    with pytest.raises(OSError, match="disk full"):
        HARNESS.fire("registry_write")


def test_armed_context_manager_disarms_on_exit():
    with armed("dispatch"):
        assert "dispatch" in HARNESS.armed_seams()
        with pytest.raises(FaultInjected):
            HARNESS.fire("dispatch")
    assert "dispatch" not in HARNESS.armed_seams()
    HARNESS.fire("dispatch")  # disarmed again


def test_chaos_schedule_is_deterministic():
    s1 = chaos_schedule(1234)
    HARNESS.reset()
    s2 = chaos_schedule(1234)
    assert s1 == s2 and set(s1) == set(SEAMS)
    assert set(HARNESS.armed_seams()) == set(SEAMS)  # all armed fail-once
    counters = HARNESS.counters()
    assert set(counters) == {"calls", "fired"}


@pytest.mark.parametrize("seed", [0, 1, 1234, 2 ** 31 - 1])
@pytest.mark.parametrize("max_offset", [3, 8])
def test_chaos_schedule_matches_reference(seed, max_offset):
    """One seed draws the same offsets in both packages."""
    try:
        want = ref_faults.chaos_schedule(seed, max_offset=max_offset)
    finally:
        ref_faults.HARNESS.reset()
    assert chaos_schedule(seed, max_offset=max_offset) == want
    assert {s: p.after for s, p in HARNESS.armed_seams().items()} == want


def test_chaos_seeded_schedule_smoke(rng):
    """The schedule builder composes with real dispatches: whatever fires
    surfaces as a typed ReproError, never a bare crash."""
    seed = int(os.environ.get("REPRO_CHAOS_SEED", "0")) % (2 ** 31)
    schedule = chaos_schedule(seed, max_offset=3)
    assert set(schedule) == set(SEAMS)
    _, plan = _plan(rng, 44, 28)
    b = torch.from_numpy(
        np.random.RandomState(2).randn(28, 4).astype(np.float32))
    for _ in range(6):
        try:
            api.execute(plan, b)
        except ReproError:
            pass  # injected faults must surface typed


# ---------------------------------------------------------------------------
# "torch" signatures: no gate, faults propagate as they are
# ---------------------------------------------------------------------------
def test_torch_plan_build_failure_propagates_fault(rng):
    """"torch" plans are the reference's "xla" path: a build fault
    propagates as it is, and the failed build is not cached."""
    a, plan = _plan(rng, 84, 36)
    b = torch.from_numpy(
        np.random.RandomState(5).randn(36, 8).astype(np.float32))
    with armed("executor_build", times=1):
        with pytest.raises(FaultInjected):
            api.execute(plan, b)
    out = api.execute(plan, b)  # failed builds are not cached: retry works
    np.testing.assert_allclose(out.numpy(), a @ b.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert HEALTH.snapshot()["signatures"] == 0  # never gated


def test_pallas_lowering_fires_for_cuda_signatures_only(rng):
    _, plan = _plan(rng, 88, 36)
    b = torch.ones(36, 3)
    with armed("pallas_lowering", times=None):
        api.execute(plan, b)  # a "torch" build does not lower anything
        with pytest.raises(FaultInjected):
            build_executor(_cuda_sig(plan), batch=7)
    assert HARNESS.calls("pallas_lowering") == 1


# ---------------------------------------------------------------------------
# "cuda" signatures: the health gate, with no degrade tier
# ---------------------------------------------------------------------------
def _cuda_sig(plan):
    sig = plan.signature()
    return sig[:SIG_IMPL] + ("cuda",) + sig[SIG_IMPL + 1:]


class _Launcher:
    """``make_fn`` for ``_guarded_call``: the real executor build of the
    signature (which fires the seams), then a stand-in for the launch that
    counts its calls and raises while ``fail_launches`` lasts."""

    def __init__(self, fail_launches=0):
        self.launches = 0
        self.fail_launches = fail_launches

    def __call__(self, sig):
        build_executor(sig, batch=3)

        def launch(x):
            self.launches += 1
            if self.fail_launches:
                self.fail_launches -= 1
                raise DispatchError("dense_tile_spmm launch failed with "
                                    "cudaError_t 9")
            return x * 2

        return launch


def _dispatch(sig, make_fn, x=None):
    x = torch.arange(4.0) if x is None else x
    return api._guarded_call(sig, make_fn, (x,), "batched")


@pytest.mark.parametrize("where", ["executor_build", "pallas_lowering",
                                   "launch"])
def test_cuda_failure_raises_backs_off_then_recovers(rng, where):
    m = {"executor_build": 60, "pallas_lowering": 61, "launch": 62}[where]
    _, plan = _plan(rng, m, 44)
    sig = _cuda_sig(plan)
    make_fn = _Launcher(fail_launches=int(where == "launch"))
    cause = DispatchError if where == "launch" else FaultInjected
    with armed(where, times=1) if where != "launch" else nullcontext():
        with pytest.raises(KernelLoweringError) as err:
            _dispatch(sig, make_fn)
    assert isinstance(err.value.__cause__, cause)
    assert HEALTH.state(sig) == "retrying"
    assert cause.__name__ in HEALTH.last_error(sig)
    launched = make_fn.launches
    # dispatch 2 is inside the backoff (next attempt at dispatch 3): it
    # raises, naming the state, and neither builds nor launches
    builds = HARNESS.calls("executor_build")
    with pytest.raises(KernelLoweringError,
                       match="retrying.*next attempt at dispatch 3"):
        _dispatch(sig, make_fn)
    assert make_fn.launches == launched
    assert HARNESS.calls("executor_build") == builds
    x = torch.arange(4.0)
    out = _dispatch(sig, make_fn, x)  # dispatch 3: the retry succeeds
    assert torch.equal(out, x * 2)
    assert HEALTH.state(sig) == "healthy"
    snap = HEALTH.snapshot()
    assert snap["recoveries"] == 1 and snap["failures"] == 1
    assert snap["fallbacks"] == 0 and snap["demotions"] == 0


def test_cuda_demotion_sticks_after_disarming(rng):
    _, plan = _plan(rng, 64, 46)
    sig = _cuda_sig(plan)
    make_fn = _Launcher()
    raised = 0
    with armed("pallas_lowering", times=None):
        while HEALTH.state(sig) != "demoted":
            with pytest.raises(KernelLoweringError):
                _dispatch(sig, make_fn)
            raised += 1
            assert raised <= 40
    # failures at dispatches 1, 3, 7 and 15: backoff 2, 4, 8, then demoted
    assert raised == 15
    assert HEALTH.snapshot()["failures"] == 4
    assert HEALTH.snapshot()["demotions"] == 1
    with pytest.raises(KernelLoweringError, match="demoted") as err:
        _dispatch(sig, make_fn)  # disarmed: still refused
    assert "FaultInjected" in str(err.value)  # names the last error
    assert make_fn.launches == 0
    HEALTH.reset()  # the only way back
    assert torch.equal(_dispatch(sig, make_fn), torch.arange(4.0) * 2)
    assert make_fn.launches == 1


def test_cuda_gate_is_per_signature(rng):
    _, plan = _plan(rng, 66, 30)
    _, other = _plan(rng, 67, 30)
    sig, sig2 = _cuda_sig(plan), _cuda_sig(other)
    with armed("executor_build", times=1, match=lambda s: s == sig):
        with pytest.raises(KernelLoweringError):
            _dispatch(sig, _Launcher())
        _dispatch(sig2, _Launcher())  # a neighbour is not poisoned
    assert HEALTH.state(sig) == "retrying"
    assert HEALTH.state(sig2) == "healthy"


def test_fused_delta_build_fault_raises_and_launches_nothing(rng):
    """A fresh ``fused+delta`` build (the dynamic plan's sidecar
    executor) with ``executor_build`` armed raises KernelLoweringError,
    launches nothing, and counts against the base plan's general-payload
    signature, which ``execute_with_delta`` gates on."""
    _, plan = _plan(rng, 68, 42)
    rows, cols = np.array([1, 5, 9]), np.array([2, 3, 40])
    delta = build_delta_fringe(rows, cols, np.ones(3), plan.shape,
                               plan.config)
    sig = general_format_sig(_cuda_sig(plan))
    launches = []

    def make_fn(s):
        build_executor(s, delta_sig=delta.sig)
        return lambda x: launches.append(x) or x

    builds = HARNESS.calls("executor_build")
    with armed("executor_build", times=1):
        with pytest.raises(KernelLoweringError) as err:
            api._guarded_call(sig, make_fn, (torch.ones(3),), "fused+delta")
    assert isinstance(err.value.__cause__, FaultInjected)
    assert HARNESS.calls("executor_build") == builds + 1
    assert launches == [] and HEALTH.state(sig) == "retrying"
    # the same sidecar through the "torch" plan: a build fault propagates
    # as it is, and the retry computes base + sidecar
    b = torch.ones(42, 2)
    with armed("executor_build", times=1):
        with pytest.raises(FaultInjected):
            api.execute_with_delta(plan, delta, b)
    out = api.execute_with_delta(plan, delta, b)
    assert torch.allclose(out, api.execute(plan, b) + api.
                          execute_delta_contribution(plan.shape, plan.config,
                                                     delta, b))


# ---------------------------------------------------------------------------
# registry seams: write faults stay clean, read faults fall back a
# generation
# ---------------------------------------------------------------------------
def _dplan(rng, m=64, k=48):
    a, plan = _plan(rng, m, k)
    return a, DynamicPlan(plan)


def test_registry_write_fault_is_a_clean_registry_error(rng, tmp_path):
    a, dp = _dplan(rng)
    reg = PlanRegistry(str(tmp_path))
    reg.save("g", dp)
    with armed("registry_write"):
        with pytest.raises(RegistryError, match="persist"):
            reg.save("g", dp)
    # the previous generation still loads (atomic layout untouched)
    restored = reg.load("g")
    assert restored.plan.shape == a.shape
    assert reg.generation_fallbacks == 0


def test_registry_read_fault_falls_back_one_generation(rng, tmp_path):
    _, dp = _dplan(rng)
    reg = PlanRegistry(str(tmp_path), keep=2)
    reg.save("g", dp)
    reg.save("g", dp)  # two retained generations
    with armed("registry_read", times=1):  # the newest read dies
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            restored = reg.load("g")
    assert restored is not None
    assert reg.generation_fallbacks == 1
    assert any("serving step_" in str(w.message) for w in caught)


def test_registry_read_fault_on_all_generations_aggregates(rng, tmp_path):
    _, dp = _dplan(rng)
    reg = PlanRegistry(str(tmp_path), keep=2)
    reg.save("g", dp)
    reg.save("g", dp)
    with armed("registry_read", times=None):
        with pytest.raises(RegistryError, match="every retained generation"):
            reg.load("g")


# ---------------------------------------------------------------------------
# the health table itself
# ---------------------------------------------------------------------------
def test_health_table_snapshot_reset_race():
    """The port of ``tests/test_telemetry_integration.py``'s regression:
    with ``max_retries=0`` the first failure of a fresh signature bumps
    the failure and demotion counters and marks it demoted inside one lock
    acquisition, so every atomic snapshot must observe ``failures ==
    demotions == demoted``; ``reset()`` clears signatures and counters
    together."""
    table = HealthTable(max_retries=0)
    n_threads, n_iter = 4, 200
    stop = threading.Event()
    torn = []

    def record(tid):
        for i in range(n_iter):
            table.record_failure((tid, i), RuntimeError("x"))

    def observe():
        while not stop.is_set():
            snap = table.snapshot()
            if not (snap["failures"] == snap["demotions"]
                    == snap["demoted"]):
                torn.append(snap)
            table.reset()

    workers = [threading.Thread(target=record, args=(t,))
               for t in range(n_threads)]
    watcher = threading.Thread(target=observe)
    watcher.start()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    stop.set()
    watcher.join(timeout=60)
    assert not any(t.is_alive() for t in workers + [watcher])
    assert not torn, f"torn snapshots: {torn[:3]}"
    table.reset()
    snap = table.snapshot()
    assert snap["failures"] == 0 and snap["demotions"] == 0
    assert snap["fallbacks"] == 0


def test_health_schema_matches_reference():
    from repro.exec.health import HealthTable as RefTable

    assert set(HealthTable().snapshot()) == set(RefTable().snapshot())
