"""The port's autotuner (``repro_torch.core.tuner``) and its registry store
(``repro_torch.dynamic.tuning``) against the JAX package's, on the CPU.

Each test of ``tests/test_tuner.py`` but the service one (which
``tests/test_torch_service.py`` mirrors) runs here on both packages at
once, ``impl="xla"`` in the reference and ``"torch"`` in the port, with
the timer injected through ``set_timer``, and must give the same
answers: resolve modes and counters, tuned decisions and their demote-only
validation, the registry round trip, corruption and generation fallback,
and results that no decision may change (bit for bit, on integer data).

Beyond the mirror:

- ``shape_class`` strings are equal but for the last field, the impl;
- the same ``decisions`` give equal ``TunedCostModel`` answers (tiers,
  the ``bk`` clamp, ``tile_shape``, thresholds), and for a ``"cuda"``
  config the H100 rule: a stored ``"xla"`` tier is ignored and counted;
- ``prepare`` with ``autotune="offline"`` and the same injected record in
  both tables builds the same plan leaves;
- a table saved by the reference's ``RegistryTuningStore`` is read by the
  port's store given ``impl="torch"``, with the same decisions.

The ``"cuda"`` microbenchmarks (B1, B2 and B3 timed, no plain version
called) are the ``gpu``-marked tests at the end; they skip without a card.
"""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import spmm as jax_spmm  # noqa: E402
from repro.exec import execute as jax_execute  # noqa: E402
from repro.core import tuner as jax_tuner  # noqa: E402
from repro.core.cost_model import (  # noqa: E402
    EngineCostModel as JaxEngineCostModel,
)
from repro.core.cost_model import (  # noqa: E402
    default_cost_model as jax_default_cost_model,
)
from repro.dynamic import PlanRegistry as JaxPlanRegistry  # noqa: E402
from repro.dynamic.tuning import (  # noqa: E402
    RegistryTuningStore as JaxRegistryTuningStore,
)
from repro.dynamic.tuning import (  # noqa: E402
    install_registry_store as jax_install_registry_store,
)
from repro_torch.core import spmm, tuner  # noqa: E402
from repro_torch.core.cost_model import (  # noqa: E402
    EngineCostModel, default_cost_model, fringe_ksharded_bytes,
    fringe_resident_bytes,
)
from repro_torch.dynamic import PlanRegistry  # noqa: E402
from repro_torch.dynamic.tuning import (  # noqa: E402
    RegistryTuningStore, install_registry_store,
)
from repro_torch.exec.api import execute  # noqa: E402
from _hyp import given, settings, st  # noqa: E402
from test_torch_prepare import _check  # noqa: E402

XLA = jax_spmm.SpmmConfig(impl="xla")
TORCH = spmm.SpmmConfig(impl="torch")
CUDA = spmm.SpmmConfig(impl="cuda")


@pytest.fixture(autouse=True)
def _fresh_tuners():
    tuner.reset_for_tests()
    jax_tuner.reset_for_tests()
    yield
    tuner.reset_for_tests()
    jax_tuner.reset_for_tests()


def _fake_timer(value=1e-3):
    """Timer double: never runs fn (nothing is built), fixed time."""
    return lambda fn: value


def _set_timers(value=1e-3):
    tuner.set_timer(_fake_timer(value))
    jax_tuner.set_timer(_fake_timer(value))


def _tuned(decisions, **over):
    am = default_cost_model()
    kw = dict(p_matrix=am.p_matrix, p_vector=am.p_vector, r=am.r,
              n_cols=am.n_cols, decisions=decisions)
    kw.update(over)
    return tuner.TunedCostModel(**kw)


def _jax_tuned(decisions, **over):
    am = jax_default_cost_model()
    kw = dict(p_matrix=am.p_matrix, p_vector=am.p_vector, r=am.r,
              n_cols=am.n_cols, decisions=decisions)
    kw.update(over)
    return jax_tuner.TunedCostModel(**kw)


def _both_counters():
    return (tuner.get_tuner().counters(),
            jax_tuner.get_tuner().counters())


# --- resolve modes ---------------------------------------------------------


def test_autotune_off_resolves_analytic_with_zero_benchmarks():
    cm = tuner.resolve_cost_model("spmm", 64, 64, 300, TORCH)
    ref = jax_tuner.resolve_cost_model("spmm", 64, 64, 300, XLA)
    assert type(cm) is EngineCostModel and type(ref) is JaxEngineCostModel
    assert (cm.p_matrix, cm.p_vector) == (ref.p_matrix, ref.p_vector)
    assert tuner.tune_call_count() == jax_tuner.tune_call_count() == 0


def test_offline_cold_falls_back_to_analytic_and_counts():
    cm = tuner.resolve_cost_model(
        "spmm", 64, 64, 300, dataclasses.replace(TORCH, autotune="offline"))
    ref = jax_tuner.resolve_cost_model(
        "spmm", 64, 64, 300, dataclasses.replace(XLA, autotune="offline"))
    assert type(cm) is EngineCostModel and type(ref) is JaxEngineCostModel
    assert tuner.tune_call_count() == jax_tuner.tune_call_count() == 0
    assert tuner.tuning_fallback_count() == jax_tuner.tuning_fallback_count()
    assert tuner.tuning_fallback_count() == 1
    ours, theirs = _both_counters()
    assert ours == theirs and ours["cold_misses"] == 1


def test_inline_measure_then_table_serves_second_resolve():
    _set_timers()
    cfg = dataclasses.replace(TORCH, autotune=True)
    jcfg = dataclasses.replace(XLA, autotune=True)
    cm = tuner.resolve_cost_model("spmm", 64, 64, 300, cfg)
    ref = jax_tuner.resolve_cost_model("spmm", 64, 64, 300, jcfg)
    assert isinstance(cm, tuner.TunedCostModel) and cm.source == "measured"
    assert tuner.tune_call_count() == jax_tuner.tune_call_count() > 0
    # the same timer gives the same record: rates and decisions
    assert (cm.p_matrix, cm.p_vector) == (ref.p_matrix, ref.p_vector)
    assert cm.decisions == ref.decisions
    tuner.reset_tune_call_count()
    jax_tuner.reset_tune_call_count()
    cm2 = tuner.resolve_cost_model("spmm", 64, 64, 300, cfg)
    jax_tuner.resolve_cost_model("spmm", 64, 64, 300, jcfg)
    assert isinstance(cm2, tuner.TunedCostModel) and cm2.source == "table"
    assert tuner.tune_call_count() == 0
    ours, theirs = _both_counters()
    assert ours == theirs and ours["table_hits"] == 1


def test_shape_class_buckets_families_not_exact_shapes():
    a = tuner.shape_class("spmm", 64, 64, 300, TORCH)
    assert a == tuner.shape_class("spmm", 60, 50, 280, TORCH)
    assert a != tuner.shape_class("spmm", 64, 2048, 300, TORCH)
    assert a != tuner.shape_class("sddmm", 64, 64, 300, TORCH)
    ja = jax_tuner.shape_class("spmm", 64, 64, 300, XLA)
    assert (ja == jax_tuner.shape_class("spmm", 60, 50, 280, XLA)) and (
        ja != jax_tuner.shape_class("spmm", 64, 2048, 300, XLA))


# --- tuned decisions are validated, never load-bearing ---------------------


def test_tuned_resident_preference_demotes_when_it_cannot_fit():
    cm = _tuned({"fringe_tier": ["resident", 0]})
    ref = _jax_tuned({"fringe_tier": ["resident", 0]})
    assert fringe_resident_bytes(20_000, 100, 256) > 12 * 1024 * 1024
    tier, bk = cm.select_fringe_tier(20_000, 100, 256)
    assert (tier, bk) == default_cost_model().select_fringe_tier(
        20_000, 100, 256)
    assert (tier, bk) == ref.select_fringe_tier(20_000, 100, 256)


def test_tuned_ksharded_bk_is_clamped_to_the_legal_cap():
    cm = _tuned({"fringe_tier": ["ksharded", 1 << 20]})
    ref = _jax_tuned({"fringe_tier": ["ksharded", 1 << 20]})
    tier, bk = cm.select_fringe_tier(20_000, 100, 256)
    assert tier == "ksharded"
    assert fringe_ksharded_bytes(bk, 100, 256) <= 12 * 1024 * 1024
    assert 2 * bk < 20_000
    assert (tier, bk) == ref.select_fringe_tier(20_000, 100, 256)
    assert cm.select_fringe_tier(16, 16, 256)[0] == "resident"
    assert ref.select_fringe_tier(16, 16, 256)[0] == "resident"


def test_tuned_xla_demotion_always_honored():
    cm = _tuned({"fringe_tier": ["xla", 0]})
    ref = _jax_tuned({"fringe_tier": ["xla", 0]})
    for shape in ((64, 16, 256), (20_000, 100, 256)):
        assert cm.select_fringe_tier(*shape) == ("xla", 0)
        assert ref.select_fringe_tier(*shape) == ("xla", 0)


def test_tuned_sddmm_tier_is_demote_only():
    promote = _tuned({"sddmm_tier": "resident"})
    demote = _tuned({"sddmm_tier": "xla"})
    assert promote.select_sddmm_tier(64, 100, 100, vmem_budget=0) == "xla"
    assert demote.select_sddmm_tier(64, 100, 100) == "xla"
    assert _jax_tuned({"sddmm_tier": "resident"}).select_sddmm_tier(
        64, 100, 100, vmem_budget=0) == "xla"
    assert _jax_tuned({"sddmm_tier": "xla"}).select_sddmm_tier(
        64, 100, 100) == "xla"


def test_tuned_thresholds_and_occupancy_come_from_decisions():
    decisions = {
        "delta_max_fraction": 0.4, "delta_max_slowdown": 2.0,
        "densify_occupancy": 0.6, "shard_imbalance_threshold": 1.7,
    }
    cm, ref = _tuned(decisions), _jax_tuned(decisions)
    assert cm.compaction_thresholds() == ref.compaction_thresholds() == (
        0.4, 2.0)
    assert cm.densify_occupancy() == ref.densify_occupancy() == 0.6
    assert cm.imbalance_threshold() == ref.imbalance_threshold() == 1.7
    empty = _tuned({})
    assert empty.compaction_thresholds() == \
        default_cost_model().compaction_thresholds()
    assert empty.densify_occupancy() is None
    assert empty.compaction_thresholds() == \
        _jax_tuned({}).compaction_thresholds()


# --- persistence: registry round trip, warm process, corruption ------------


def _entry_steps(root, fingerprint):
    name = "tuning-" + fingerprint.replace(":", "_")
    d = os.path.join(root, name)
    return sorted(
        os.path.join(d, s) for s in os.listdir(d) if s.startswith("step_"))


def _truncate_npy(step):
    for f in glob.glob(os.path.join(step, "*.npy")):
        with open(f, "r+b") as fh:
            fh.truncate(os.path.getsize(f) // 2)


def test_registry_round_trip_warm_process_zero_benchmarks(tmp_path):
    _set_timers()
    ours_root, ref_root = str(tmp_path / "port"), str(tmp_path / "ref")
    install_registry_store(ours_root)
    jax_install_registry_store(ref_root)
    cfg = dataclasses.replace(TORCH, autotune=True)
    jcfg = dataclasses.replace(XLA, autotune=True)
    tuner.resolve_cost_model("spmm", 64, 64, 300, cfg)
    jax_tuner.resolve_cost_model("spmm", 64, 64, 300, jcfg)
    assert tuner.tune_call_count() == jax_tuner.tune_call_count() > 0
    assert _entry_steps(ours_root, tuner.device_fingerprint("cpu"))
    assert _entry_steps(ref_root, jax_tuner.device_fingerprint())

    tuner.reset_for_tests(keep_store=True)
    jax_tuner.reset_for_tests(keep_store=True)
    cm = tuner.resolve_cost_model("spmm", 64, 64, 300, cfg)
    ref = jax_tuner.resolve_cost_model("spmm", 64, 64, 300, jcfg)
    assert isinstance(cm, tuner.TunedCostModel) and cm.source == "table"
    assert tuner.tune_call_count() == jax_tuner.tune_call_count() == 0
    assert cm.decisions == ref.decisions
    ours, theirs = _both_counters()
    assert ours == theirs and ours["store_errors"] == 0


def test_corrupt_table_degrades_to_analytic_with_counter(tmp_path):
    _set_timers()
    ours_root, ref_root = str(tmp_path / "port"), str(tmp_path / "ref")
    install_registry_store(ours_root)
    jax_install_registry_store(ref_root)
    tuner.resolve_cost_model("spmm", 64, 64, 300,
                             dataclasses.replace(TORCH, autotune=True))
    jax_tuner.resolve_cost_model("spmm", 64, 64, 300,
                                 dataclasses.replace(XLA, autotune=True))
    for step in _entry_steps(ours_root, tuner.device_fingerprint("cpu")):
        _truncate_npy(step)
    for step in _entry_steps(ref_root, jax_tuner.device_fingerprint()):
        _truncate_npy(step)

    tuner.reset_for_tests(keep_store=True)
    jax_tuner.reset_for_tests(keep_store=True)
    cm = tuner.resolve_cost_model(
        "spmm", 64, 64, 300, dataclasses.replace(TORCH, autotune="offline"))
    ref = jax_tuner.resolve_cost_model(
        "spmm", 64, 64, 300, dataclasses.replace(XLA, autotune="offline"))
    assert type(cm) is EngineCostModel and type(ref) is JaxEngineCostModel
    ours, theirs = _both_counters()
    assert ours == theirs and ours["store_errors"] == 1
    assert tuner.tuning_fallback_count() == \
        jax_tuner.tuning_fallback_count() >= 1


def test_corrupt_newest_generation_falls_back_to_older(tmp_path):
    _set_timers()
    reg = PlanRegistry(str(tmp_path / "port"))
    jreg = JaxPlanRegistry(str(tmp_path / "ref"))
    install_registry_store(reg)
    jax_install_registry_store(jreg)
    for m, k, nnz in ((64, 64, 300), (64, 2048, 3000)):  # two saves
        tuner.resolve_cost_model(
            "spmm", m, k, nnz, dataclasses.replace(TORCH, autotune=True))
        jax_tuner.resolve_cost_model(
            "spmm", m, k, nnz, dataclasses.replace(XLA, autotune=True))
    steps = _entry_steps(reg.root, tuner.device_fingerprint("cpu"))
    jsteps = _entry_steps(jreg.root, jax_tuner.device_fingerprint())
    assert len(steps) == len(jsteps) == 2
    _truncate_npy(steps[-1])
    _truncate_npy(jsteps[-1])

    tuner.reset_for_tests(keep_store=True)
    jax_tuner.reset_for_tests(keep_store=True)
    install_registry_store(reg)
    jax_install_registry_store(jreg)
    cm = tuner.resolve_cost_model(
        "spmm", 64, 64, 300, dataclasses.replace(TORCH, autotune="offline"))
    ref = jax_tuner.resolve_cost_model(
        "spmm", 64, 64, 300, dataclasses.replace(XLA, autotune="offline"))
    assert isinstance(cm, tuner.TunedCostModel)
    assert isinstance(ref, jax_tuner.TunedCostModel)
    assert reg.generation_fallbacks == jreg.generation_fallbacks == 1
    ours, theirs = _both_counters()
    assert ours == theirs and ours["store_errors"] == 0


def test_table_from_other_device_is_ignored(tmp_path):
    for Registry, Store, root in (
            (PlanRegistry, RegistryTuningStore, tmp_path / "port"),
            (JaxPlanRegistry, JaxRegistryTuningStore, tmp_path / "ref")):
        store = Store(Registry(str(root)))
        store.save({"other|spmm|m6|k6|d-2|bn256|xla": {
            "table_format_version": tuner.TABLE_FORMAT_VERSION}})
        fingerprint = (tuner.device_fingerprint() if Store is
                       RegistryTuningStore else jax_tuner.device_fingerprint())
        step = _entry_steps(str(root), fingerprint)[-1]
        manifest_path = os.path.join(step, "manifest.json")
        with open(manifest_path) as f:
            manifest = json.load(f)
        manifest["meta"]["device_fingerprint"] = "tpu:v9"
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)
        assert store.load() is None  # a foreign table is absent


def test_save_failure_is_counted_never_raised():
    class BrokenStore:
        def load(self):
            return None

        def save(self, table):
            raise IOError("disk full")

    tuner.install_store(BrokenStore())
    jax_tuner.install_store(BrokenStore())
    _set_timers()
    cm = tuner.resolve_cost_model("spmm", 64, 64, 300,
                                  dataclasses.replace(TORCH, autotune=True))
    jax_tuner.resolve_cost_model("spmm", 64, 64, 300,
                                 dataclasses.replace(XLA, autotune=True))
    assert isinstance(cm, tuner.TunedCostModel)
    ours, theirs = _both_counters()
    assert ours == theirs and ours["store_errors"] == 1


def test_stale_format_version_records_are_dropped_on_load():
    class Store:
        def __init__(self, key):
            self.table = {key: {"table_format_version": -1}}

        def load(self):
            return self.table

        def save(self, table):
            self.table = table

    tuner.install_store(Store(tuner.table_key("spmm", 64, 64, 300, TORCH)))
    jax_tuner.install_store(
        Store(jax_tuner.table_key("spmm", 64, 64, 300, XLA)))
    cm = tuner.resolve_cost_model(
        "spmm", 64, 64, 300, dataclasses.replace(TORCH, autotune="offline"))
    ref = jax_tuner.resolve_cost_model(
        "spmm", 64, 64, 300, dataclasses.replace(XLA, autotune="offline"))
    assert type(cm) is EngineCostModel and type(ref) is JaxEngineCostModel
    ours, theirs = _both_counters()
    assert ours == theirs and ours["cold_misses"] == 1


# --- decisions may differ, results may not ---------------------------------


def _exact_coo(rng, m, k, density=0.12):
    """Integer-valued fp32 matrix: any summation order is exact."""
    mask = rng.rand(m, k) < density
    rows, cols = np.nonzero(mask)
    vals = rng.randint(-4, 5, rows.size).astype(np.float64)
    return rows.astype(np.int64), cols.astype(np.int64), vals


def _variant_models(tuned, default):
    am = default()
    return [
        tuned({"fringe_tier": ["xla", 0]}),
        tuned({}, p_matrix=am.p_matrix * 64),   # vector-hungry split
        tuned({}, p_vector=am.p_vector * 64),   # matrix-hungry split
        tuned({"densify_occupancy": 0.05}),
        tuned({"densify_occupancy": 0.9}),
    ]


def _run(rows, cols, vals, shape, b, cfg=TORCH, cm=None):
    plan = spmm.prepare(rows, cols, vals, shape, cfg, cost_model=cm)
    return execute(plan, torch.from_numpy(b)).numpy()


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(24, 72), st.integers(16, 64))
def test_dispatch_decisions_never_change_results(seed, m, k):
    """Analytic model, tuned models and a forced tier agree bit for bit in
    the port, and with the reference's result on the same integer data."""
    rng = np.random.RandomState(seed)
    rows, cols, vals = _exact_coo(rng, m, k)
    b = rng.randint(-4, 5, (k, 8)).astype(np.float32)
    ref = _run(rows, cols, vals, (m, k), b)
    theirs = np.asarray(jax_execute(
        jax_spmm.prepare(rows, cols, vals, (m, k), XLA), jnp.asarray(b)))
    assert np.array_equal(ref, theirs)
    for cm in _variant_models(_tuned, default_cost_model):
        assert np.array_equal(_run(rows, cols, vals, (m, k), b, cm=cm), ref)
    forced = dataclasses.replace(TORCH, fringe_vmem_budget=16)
    assert np.array_equal(_run(rows, cols, vals, (m, k), b, forced), ref)


def _record(key, am, decisions, **rates):
    rec = {"table_format_version": tuner.TABLE_FORMAT_VERSION,
           "p_matrix": am.p_matrix, "p_vector": am.p_vector,
           "r": am.r, "n_cols": am.n_cols, "key": key,
           "decisions": dict(decisions)}
    rec.update(rates)
    return rec


def test_tuned_table_execution_is_bit_identical():
    """Through the autotune config path: an adopted record with aggressive
    decisions, resolved through ``autotune="offline"``, executes bit for
    bit as the analytic plan, in both packages."""
    rng = np.random.RandomState(0)
    rows, cols, vals = _exact_coo(rng, 48, 40)
    b = rng.randint(-4, 5, (40, 8)).astype(np.float32)
    ref = _run(rows, cols, vals, (48, 40), b)
    off = dataclasses.replace(TORCH, autotune="offline")
    joff = dataclasses.replace(XLA, autotune="offline")
    am = default_cost_model()
    decisions = {"fringe_tier": ["xla", 0], "densify_occupancy": 0.9}
    key = tuner.table_key("spmm", 48, 40, len(vals), off)
    jkey = jax_tuner.table_key("spmm", 48, 40, len(vals), joff)
    tuner.get_tuner().adopt(key, _record(key, am, decisions,
                                         p_matrix=am.p_matrix * 64))
    jax_tuner.get_tuner().adopt(jkey, _record(jkey, am, decisions,
                                              p_matrix=am.p_matrix * 64))
    got = _run(rows, cols, vals, (48, 40), b, off)
    assert np.array_equal(got, ref)
    theirs = np.asarray(jax_execute(
        jax_spmm.prepare(rows, cols, vals, (48, 40), joff), jnp.asarray(b)))
    assert np.array_equal(got, theirs)
    # the reference resolves again at execute time for its densify
    # crossover, which no executor of the port reads: one hit here, two
    # there
    ours, theirs_c = _both_counters()
    assert ours["table_hits"] == 1 and theirs_c["table_hits"] == 2
    assert {k: v for k, v in ours.items() if k != "table_hits"} == {
        k: v for k, v in theirs_c.items() if k != "table_hits"}


# --- beyond the mirror: keys, decisions, leaves, tables across packages ----


@pytest.mark.parametrize("op,m,k,nnz,bn", [
    ("spmm", 64, 64, 300, 256),
    ("spmm", 60, 50, 280, 256),
    ("spmm", 169_343, 169_343, 2_481_327, 256),
    ("spmm", 1, 1, 0, 64),
    ("sddmm", 90, 70, 500, 128),
])
def test_shape_class_strings_equal_but_the_impl(op, m, k, nnz, bn):
    ours = tuner.shape_class(op, m, k, nnz, dataclasses.replace(TORCH, bn=bn))
    theirs = jax_tuner.shape_class(op, m, k, nnz,
                                   dataclasses.replace(XLA, bn=bn))
    assert ours.rsplit("|", 1) == [theirs.rsplit("|", 1)[0], "torch"]
    assert tuner.table_key(op, m, k, nnz, dataclasses.replace(
        TORCH, bn=bn)) == f"cpu:cpu|{ours}"
    assert jax_tuner.table_key(op, m, k, nnz, dataclasses.replace(
        XLA, bn=bn)) == f"{jax_tuner.device_fingerprint()}|{theirs}"
    assert tuner.device_fingerprint("cpu") == jax_tuner.device_fingerprint()


DECISIONS = [
    {},
    {"fringe_tier": ["resident", 0]},
    {"fringe_tier": ["ksharded", 1 << 20]},
    {"fringe_tier": ["ksharded", 4]},
    {"fringe_tier": ["ksharded", 52]},
    {"fringe_tier": ["xla", 0]},
    {"sddmm_tier": "xla"},
    {"sddmm_tier": "resident"},
    {"tile_shape": [256, 64]},
    {"tile_shape": [128, 12]},          # not a sublane multiple
    {"tile_shape": [384, 64]},          # taller than the padded operand
    {"tile_shape": [256, 4096]},        # past the VMEM claim
    {"delta_max_fraction": 0.4, "delta_max_slowdown": 2.0,
     "densify_occupancy": 0.6, "shard_imbalance_threshold": 1.7},
]
FRINGE_SHAPES = [(20_000, 100, 256, None), (64, 16, 256, None),
                 (16, 16, 256, None), (4096, 300, 256, 2 << 20),
                 (4096, 300, 256, 0)]
SDDMM_SHAPES = [(64, 100, 100, None), (64, 100, 100, 0),
                (256, 200_000, 200_000, None)]
TILE_SHAPES = [(300, 200, 256, 4000), (100, 40, 256, 300),
               (5000, 5000, 512, 10**5)]


@pytest.mark.parametrize("decisions", DECISIONS)
def test_same_decisions_give_the_reference_answers(decisions):
    """A ``"torch"`` config (the port's impl argument at its default): the
    same injected decisions answer as the reference's model does."""
    cm, ref = _tuned(decisions), _jax_tuned(decisions)
    for k, rows, bn, budget in FRINGE_SHAPES:
        assert cm.select_fringe_tier(k, rows, bn, vmem_budget=budget) == \
            ref.select_fringe_tier(k, rows, bn, vmem_budget=budget)
    for d, src, dst, budget in SDDMM_SHAPES:
        assert cm.select_sddmm_tier(d, src, dst, vmem_budget=budget) == \
            ref.select_sddmm_tier(d, src, dst, vmem_budget=budget)
    for shape in TILE_SHAPES:
        assert cm.tile_shape(*shape) == ref.tile_shape(*shape)
    assert cm.compaction_thresholds() == ref.compaction_thresholds()
    assert cm.densify_occupancy() == ref.densify_occupancy()
    assert cm.imbalance_threshold() == ref.imbalance_threshold()
    assert cm.alpha == ref.alpha


@pytest.mark.parametrize("decisions", DECISIONS)
def test_cuda_config_never_gets_xla_and_counts_the_ignored(decisions):
    """The H100 rule for a ``"cuda"`` plan: a stored ``"xla"`` tier is
    ignored (and counted); the answer is then the port's analytic one with
    the rule, and every other decision is the reference's."""
    cm, ref = _tuned(decisions), _jax_tuned(decisions)
    before = tuner.get_tuner().xla_ignored
    analytic = default_cost_model()
    for k, rows, bn, budget in FRINGE_SHAPES:
        got = cm.select_fringe_tier(k, rows, bn, vmem_budget=budget,
                                    impl="cuda")
        assert got[0] != "xla"
        if decisions.get("fringe_tier", [None])[0] == "xla":
            assert got == analytic.select_fringe_tier(
                k, rows, bn, vmem_budget=budget, impl="cuda")
        elif ref.select_fringe_tier(k, rows, bn,
                                    vmem_budget=budget)[0] != "xla":
            assert got == ref.select_fringe_tier(k, rows, bn,
                                                 vmem_budget=budget)
    for d, src, dst, budget in SDDMM_SHAPES:
        assert cm.select_sddmm_tier(d, src, dst, vmem_budget=budget,
                                    impl="cuda") == "resident"
    for shape in TILE_SHAPES:
        assert cm.tile_shape(*shape) == ref.tile_shape(*shape)
    ignored = tuner.get_tuner().xla_ignored - before
    n_xla = (len(FRINGE_SHAPES) * (decisions.get("fringe_tier", [""])[0]
                                   == "xla")
             + len(SDDMM_SHAPES) * (decisions.get("sddmm_tier") == "xla"))
    assert ignored == n_xla
    assert tuner.tuning_report()["xla_ignored"] == tuner.get_tuner(
    ).xla_ignored


@pytest.mark.parametrize("decisions,rates", [
    ({}, {}),
    ({"fringe_tier": ["xla", 0]}, {"p_matrix_x": 64}),
    ({"fringe_tier": ["ksharded", 16]}, {"p_vector_x": 8}),
    ({"tile_shape": [256, 64]}, {}),
    ({"tile_shape": [128, 32], "fringe_tier": ["resident", 0]},
     {"p_matrix_x": 0.05}),
])
def test_prepare_leaves_equal_with_the_same_injected_table(decisions, rates):
    """``prepare`` with ``autotune="offline"`` and one record adopted in
    both tables (rates, a fringe tier, a tile shape) builds the
    reference's plan leaves."""
    rng = np.random.RandomState(4)
    a = (rng.rand(300, 260) < 0.05) * rng.randn(300, 260)
    a[rng.choice(300, 6, replace=False)] = rng.randn(6, 260)
    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    off = dataclasses.replace(TORCH, autotune="offline")
    joff = dataclasses.replace(XLA, autotune="offline")
    am = default_cost_model()
    over = {"p_matrix": am.p_matrix * rates.get("p_matrix_x", 1),
            "p_vector": am.p_vector * rates.get("p_vector_x", 1)}
    key = tuner.table_key("spmm", 300, 260, rows.size, off)
    jkey = jax_tuner.table_key("spmm", 300, 260, rows.size, joff)
    tuner.get_tuner().adopt(key, _record(key, am, decisions, **over))
    jax_tuner.get_tuner().adopt(jkey, _record(jkey, am, decisions, **over))
    ours = spmm.prepare(rows, cols, vals, a.shape, off)
    theirs = jax_spmm.prepare(rows, cols, vals, a.shape, joff)
    _check(ours, theirs)
    if "tile_shape" in decisions:
        assert (ours.config.bm, ours.config.bk) == tuple(
            decisions["tile_shape"])
    ours_c, theirs_c = _both_counters()
    assert ours_c == theirs_c and ours_c["table_hits"] >= 1


def test_reference_table_reads_through_the_port_store(tmp_path):
    """A table the reference's ``RegistryTuningStore`` saved, read by the
    port's store given ``impl="torch"``: the same records, under the
    port's keys, with the same decisions; without ``impl`` the reference's
    records are left out."""
    _set_timers()
    jreg = JaxPlanRegistry(str(tmp_path))
    jax_install_registry_store(jreg)
    shapes = ((64, 64, 300), (300, 260, 4000), (64, 2048, 3000))
    for m, k, nnz in shapes:
        jax_tuner.resolve_cost_model(
            "spmm", m, k, nnz, dataclasses.replace(XLA, autotune=True))
    jax_tuner.get_tuner().adopt(
        jax_tuner.table_key("spmm", 90, 70, 500, XLA),
        _record(jax_tuner.table_key("spmm", 90, 70, 500, XLA),
                default_cost_model(), {"fringe_tier": ["ksharded", 16],
                                       "tile_shape": [256, 64]}))
    saved = JaxRegistryTuningStore(jreg).load()
    assert len(saved) == 4

    reg = PlanRegistry(str(tmp_path))
    assert RegistryTuningStore(reg).load() == {}
    install_registry_store(reg, impl="torch")
    off = dataclasses.replace(TORCH, autotune="offline")
    for m, k, nnz in shapes + ((90, 70, 500),):
        cm = tuner.resolve_cost_model("spmm", m, k, nnz, off)
        ref = jax_tuner.resolve_cost_model(
            "spmm", m, k, nnz, dataclasses.replace(XLA, autotune="offline"))
        assert isinstance(cm, tuner.TunedCostModel), (m, k, nnz)
        assert cm.source == "table"
        assert cm.decisions == ref.decisions
        assert (cm.p_matrix, cm.p_vector) == (ref.p_matrix, ref.p_vector)
        assert cm.key == tuner.table_key("spmm", m, k, nnz, off)
    assert tuner.tune_call_count() == 0
    assert tuner.get_tuner().counters()["table_hits"] == 4
    # a cuda read of the CPU table finds no record of its device
    cuda_store = RegistryTuningStore(reg, impl="cuda")
    if not torch.cuda.is_available():
        assert cuda_store.load() == {}
    with pytest.raises(ValueError, match="impl"):
        RegistryTuningStore(reg, impl="xla")


def test_autotune_true_prepare_measures_inline_like_the_reference():
    """``SpmmConfig(autotune=True)`` no longer raises: both packages
    measure the same record inline (same timer) and build equal leaves;
    a second prepare of the class measures nothing."""
    _set_timers()
    rng = np.random.RandomState(2)
    a = (rng.rand(120, 100) < 0.08) * rng.randn(120, 100)
    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    cfg = dataclasses.replace(TORCH, autotune=True)
    jcfg = dataclasses.replace(XLA, autotune=True)
    _check(spmm.prepare(rows, cols, vals, a.shape, cfg),
           jax_spmm.prepare(rows, cols, vals, a.shape, jcfg))
    n = tuner.tune_call_count()
    assert n == jax_tuner.tune_call_count() > 0
    spmm.prepare(rows, cols, vals, a.shape, cfg)
    assert tuner.tune_call_count() == n


# --- the card's microbenchmarks --------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _no_plain_versions(monkeypatch):
    """Make every plain version raise, so a "cuda" record that reached
    one fails."""
    from repro_torch.kernels import ref

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran in a cuda record")

    for name in dir(ref):
        if name.startswith("ref_"):
            monkeypatch.setattr(ref, name, refuse)
    for mod_name in ("gather_spmm", "dense_tile_spmm"):
        mod = __import__(f"repro_torch.kernels.{mod_name}",
                         fromlist=["x"])
        for name in dir(mod):
            if name.startswith("ref_"):
                monkeypatch.setattr(mod, name, refuse)


@pytest.mark.gpu
def test_cuda_record_times_the_kernels(cuda, monkeypatch):
    """A ``"cuda"`` record launches B2 (the vector rate and the resident
    candidate), B3 (each k-sharded candidate) and B1 (each tile shape),
    times no ``"xla"`` candidate and runs no plain version."""
    from repro_torch.kernels import ops

    _no_plain_versions(monkeypatch)
    ops.reset_launch_counts()
    key, rec = tuner.get_tuner().build_record("spmm", 2000, 2000, 40_000,
                                              CUDA)
    counts = ops.launch_counts()
    assert counts["gather_spmm"] > 0, counts
    assert counts["gather_spmm_ksharded"] > 0, counts
    assert counts["dense_tile_spmm"] > 0, counts
    labels = set(rec["bench_us"])
    assert "fringe:resident:0" in labels
    assert any(x.startswith("fringe:ksharded:") for x in labels)
    assert not any(x.startswith("fringe:xla") for x in labels)
    assert any(x.startswith("tile:") for x in labels)
    assert "sddmm_tier" not in rec["decisions"]
    assert key.startswith("cuda:") and key.endswith("|cuda")
    assert all(v > 0 for v in rec["bench_us"].values())


@pytest.mark.gpu
def test_cuda_sddmm_record_has_no_tier(cuda, monkeypatch):
    _no_plain_versions(monkeypatch)
    _, rec = tuner.get_tuner().build_record("sddmm", 2000, 2000, 40_000,
                                            CUDA)
    assert "sddmm_tier" not in rec["decisions"]
    assert not any(x.startswith("sddmm:") for x in rec["bench_us"])


@pytest.mark.gpu
def test_cuda_warm_process_makes_no_microbenchmarks(cuda, tmp_path):
    install_registry_store(str(tmp_path))
    cfg = dataclasses.replace(CUDA, autotune=True)
    first = tuner.resolve_cost_model("spmm", 2000, 2000, 40_000, cfg)
    assert tuner.tune_call_count() > 0
    tuner.reset_for_tests(keep_store=True)
    again = tuner.resolve_cost_model(
        "spmm", 2000, 2000, 40_000,
        dataclasses.replace(CUDA, autotune="offline"))
    assert tuner.tune_call_count() == 0
    assert again.source == "table" and again.decisions == first.decisions
