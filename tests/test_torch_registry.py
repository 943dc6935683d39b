"""The port's plan registry (``repro_torch.dynamic.PlanRegistry``) and
checkpoint layout (``repro_torch.checkpoint``), on the CPU.

Mirrors the single-device tests of ``tests/test_dynamic_registry.py``
(round trips with no ``prepare``, the overlay, warm and cold
``load_or_prepare``, truncated or mismatched shards, bad manifests,
version drift, retention, crashes mid-save, generation fallback) and
``tests/test_checkpoint.py`` (round trip, shard files, retention, no
temporary directory left behind, a given step, shape mismatch).  The
reference's sharded-entry tests run in ``tests/test_torch_sharded_dynamic.py``;
here a single-device entry whose manifest says ``"sharded"`` raises.

Across packages, on one disk layout: an entry written by ``repro`` loads
in ``repro_torch`` and the reverse.  The one field mapped is the impl
(``"xla"`` <-> ``"torch"``): the port loads onto the impl it is given,
and the test rewrites the impl in the port's manifest (its config and
signature) before the reference loads it.  (The reference's
``degrade_to_xla``, an execution-only field the port has no use for, is
dropped by the port's loader; the port's manifest lacks it, and the
reference's config takes its default.)  Every leaf, map and overlay array
must come back equal, and the results agree within 1e-5 * max(1,
max|ref|).  A structured plan's ``structure_hint`` comes back a tuple in
the port and a list in the reference (C10).
"""
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jax_ck  # noqa: E402
from repro.core import spmm as jax_spmm  # noqa: E402
from repro.dynamic import DynamicPlan as JaxDynamicPlan  # noqa: E402
from repro.dynamic import GraphDelta as JaxGraphDelta  # noqa: E402
from repro.dynamic import PlanRegistry as JaxPlanRegistry  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.core import spmm  # noqa: E402
from repro_torch.core.plan_ir import LEAF_NAMES  # noqa: E402
from repro_torch.dynamic import (  # noqa: E402
    DynamicPlan, GraphDelta, PlanRegistry, RegistryError, coo_fingerprint,
)
from conftest import make_sparse  # noqa: E402

CFG = spmm.SpmmConfig(impl="torch")
JCFG = jax_spmm.SpmmConfig(impl="xla")
TOL = 1e-5
MAPS = ("rows", "cols", "vals", "path", "core_lin", "fringe_pos", "kb_pos",
        "core_lin_sorted", "core_members_sorted", "key_sorted", "key_order")


def _graph(rng, m=80, k=64):
    return make_sparse(rng, m, k, 0.08, n_dense_rows=3)


def _prep(rows, cols, vals, shape, cfg=CFG):
    return spmm.prepare(rows, cols, vals, shape, cfg, device="cpu")


def _entry_dir(root, name):
    d = os.path.join(root, name)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    return os.path.join(d, steps[-1])


def _b(rng, k, n=8):
    return torch.from_numpy(rng.randn(k, n).astype(np.float32))


def _rel_err(out, expect):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return np.abs(out - expect).max() / (np.abs(expect).max() + 1e-9)


# ---------------------------------------------------------------------------
# checkpoint layout
# ---------------------------------------------------------------------------
def _tree(seed=0):
    r = np.random.RandomState(seed)
    return {"a": {"w": torch.from_numpy(r.randn(10, 6).astype(np.float32))},
            "b": [r.randn(4).astype(np.float32), np.int32(7)]}


def _leaves(tree):
    return [np.asarray(x) for _, x in ck._leaf_paths(tree)]


def test_checkpoint_round_trip(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 5, t, meta={"note": "x"})
    step, restored = ck.restore(str(tmp_path), t)
    assert step == 5
    assert isinstance(restored["b"], list)
    for a, b in zip(_leaves(t), _leaves(restored)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_layout_is_the_reference_one(tmp_path):
    """Leaf names, manifest keys and shard files are the reference's, so
    each package restores what the other saved."""
    t = _tree(3)
    ck.save(str(tmp_path / "port"), 2, t)
    jax_ck.save(str(tmp_path / "ref"), 2, {"a": {"w": np.asarray(t["a"]["w"])},
                                          "b": t["b"]})
    for sub in ("port", "ref"):
        d = tmp_path / sub / "step_000000002"
        assert sorted(os.listdir(d)) == sorted(
            os.listdir(tmp_path / "ref" / "step_000000002"))
        manifest = json.loads((d / "manifest.json").read_text())
        assert set(manifest) == {"step", "meta", "leaves", "treedef"}
        assert set(manifest["leaves"]) == {"a_w", "b_0", "b_1"}
    _, from_ref = ck.restore(str(tmp_path / "ref"), t)
    _, from_port = jax_ck.restore(str(tmp_path / "port"),
                                  {"a": {"w": np.asarray(t["a"]["w"])},
                                   "b": t["b"]})
    for got in (from_ref, from_port):
        for a, b in zip(_leaves(t), _leaves(got)):
            np.testing.assert_array_equal(a, b)


def test_checkpoint_sharded_files_created(tmp_path):
    d = ck.save(str(tmp_path), 1, {"w": np.zeros((10, 4))}, num_shards=3)
    assert len([f for f in os.listdir(d) if f.startswith("w.s")]) == 3


def test_checkpoint_latest_and_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, _tree(), keep=3)
    assert ck.latest_step(str(tmp_path)) == 5
    assert ck.all_steps(str(tmp_path)) == [3, 4, 5]


def test_checkpoint_no_tmp_left_behind(tmp_path):
    ck.save(str(tmp_path), 9, _tree())
    assert not [d for d in os.listdir(str(tmp_path)) if d.startswith(".tmp")]


def test_checkpoint_restore_specific_step(tmp_path):
    t1, t2 = _tree(1), _tree(2)
    ck.save(str(tmp_path), 1, t1, keep=5)
    ck.save(str(tmp_path), 2, t2, keep=5)
    _, restored = ck.restore(str(tmp_path), t1, step=1)
    np.testing.assert_array_equal(restored["a"]["w"], t1["a"]["w"].numpy())


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ck.save(str(tmp_path), 1, {"w": np.zeros((4, 4))})
    with pytest.raises(AssertionError):
        ck.restore(str(tmp_path), {"w": np.zeros((5, 4))})


# ---------------------------------------------------------------------------
# the registry (the reference's single-device tests)
# ---------------------------------------------------------------------------
def test_registry_round_trip_without_prepare(rng, tmp_path):
    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path))
    dp = DynamicPlan(_prep(rows, cols, vals, a.shape))
    b = _b(rng, 64, 12)
    want = dp.execute(b)
    reg.save("g", dp)

    before = spmm.prepare_call_count()
    restored = reg.load("g")
    assert spmm.prepare_call_count() == before  # no prepare on restore
    assert torch.equal(restored.execute(b), want)
    for name in LEAF_NAMES:
        assert torch.equal(getattr(restored.plan, name),
                           getattr(dp.plan, name)), name
    assert restored.plan.signature() == dp.plan.signature()
    # restored plans stay updatable (maps round-tripped)
    idx = rng.choice(rows.size, 5, replace=False)
    nv = rng.randn(5)
    restored.update(GraphDelta.updates(rows[idx], cols[idx], nv))
    vals2 = vals.astype(np.float64)
    vals2[idx] = nv
    ref = _prep(rows, cols, vals2, a.shape)
    assert torch.equal(restored.plan.fringe_vals, ref.fringe_vals)


def test_registry_round_trips_delta_state(rng, tmp_path):
    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path))
    dp = DynamicPlan(_prep(rows, cols, vals, a.shape), auto_compact=False)
    dense = np.zeros(a.shape, np.float64)
    np.add.at(dense, (rows, cols), vals)
    zr, zc = np.nonzero(dense == 0)
    pick = rng.choice(zr.size, 7, replace=False)
    iv = rng.randn(7)
    dp.update(GraphDelta.inserts(zr[pick], zc[pick], iv))
    dense[zr[pick], zc[pick]] += iv
    dp.update(GraphDelta.deletes(rows[:3], cols[:3]))
    dense[rows[:3], cols[:3]] = 0
    reg.save("g", dp)

    restored = reg.load("g")
    assert restored._overlay == dp._overlay
    b = _b(rng, 64)
    assert torch.equal(restored.execute(b), dp.execute(b))
    assert _rel_err(restored.execute(b), dense @ b.numpy()) < 1e-4


def test_load_or_prepare_warm_and_cold(rng, tmp_path):
    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path))
    dp = reg.load_or_prepare("g", rows, cols, vals, a.shape, CFG,
                             device="cpu")
    assert reg.has("g") and reg.names() == ["g"]
    assert reg.stored_coo_hash("g") == coo_fingerprint(rows, cols, vals,
                                                       a.shape, CFG)
    before = spmm.prepare_call_count()
    warm = reg.load_or_prepare("g", rows, cols, vals, a.shape, CFG,
                               device="cpu")
    assert spmm.prepare_call_count() == before  # warm: no prepare
    b = _b(rng, 64)
    assert torch.equal(warm.execute(b), dp.execute(b))
    # a different matrix under the same name must not reuse the entry
    vals2 = vals.copy()
    vals2[0] += 1.0
    cold = reg.load_or_prepare("g", rows, cols, vals2, a.shape, CFG,
                               device="cpu")
    assert spmm.prepare_call_count() > before
    a2 = a.astype(np.float64).copy()
    a2[rows[0], cols[0]] += 1.0
    assert _rel_err(cold.execute(b), a2 @ b.numpy()) < 1e-4


def test_truncated_shard_raises_then_falls_back(rng, tmp_path):
    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path))
    reg.save("g", DynamicPlan(_prep(rows, cols, vals, a.shape)))
    victim = os.path.join(_entry_dir(str(tmp_path), "g"),
                          "leaf_flat_values.s0.npy")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(RegistryError, match="corrupt|truncated"):
        reg.load("g")
    before = spmm.prepare_call_count()
    dp = reg.load_or_prepare("g", rows, cols, vals, a.shape, CFG,
                             device="cpu")
    assert spmm.prepare_call_count() > before  # fell back to prepare
    b = _b(rng, 64)
    assert _rel_err(dp.execute(b), a.astype(np.float64) @ b.numpy()) < 1e-4


def test_shape_mismatched_shard_is_rejected(rng, tmp_path):
    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path))
    reg.save("g", DynamicPlan(_prep(rows, cols, vals, a.shape)))
    np.save(os.path.join(_entry_dir(str(tmp_path), "g"), "maps_vals.s0.npy"),
            np.zeros(3, np.float32))
    with pytest.raises(RegistryError, match="does not match its manifest"):
        reg.load("g")


def test_corrupt_manifest_raises(rng, tmp_path):
    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path))
    reg.save("g", DynamicPlan(_prep(rows, cols, vals, a.shape)))
    with open(os.path.join(_entry_dir(str(tmp_path), "g"), "manifest.json"),
              "w") as f:
        f.write("{not json")
    with pytest.raises(RegistryError, match="manifest"):
        reg.load("g")


@pytest.mark.parametrize("field,match", [
    ("plan_format_version", "plan format"),
    ("registry_format_version", "registry format"),
    ("signature", "signature"),
    # a "sharded" kind reads the entry as the base COO of a sharded plan,
    # which a single-device entry lacks (the id is the case's earlier name)
    pytest.param("kind", "does not reconstruct", id="kind-A-queue 6"),
])
def test_manifest_drift_raises(rng, tmp_path, field, match):
    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path))
    reg.save("g", DynamicPlan(_prep(rows, cols, vals, a.shape)))
    mpath = os.path.join(_entry_dir(str(tmp_path), "g"), "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["meta"][field] = {"signature": "(2, 'other')",
                               "kind": "sharded"}.get(field, -1)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(RegistryError, match=match):
        reg.load("g")


def test_missing_entry_bad_names_and_foreign_impl(rng, tmp_path):
    reg = PlanRegistry(str(tmp_path))
    with pytest.raises(RegistryError, match="no registry entry"):
        reg.load("nope")
    with pytest.raises(RegistryError, match="filesystem-safe"):
        reg.save("../evil", None)
    a, rows, cols, vals = _graph(rng)
    JaxPlanRegistry(str(tmp_path)).save(
        "j", JaxDynamicPlan(jax_spmm.prepare(rows, cols, vals, a.shape,
                                             JCFG)))
    with pytest.raises(RegistryError, match="impl"):
        reg.load("j")  # written for "xla": the caller must name an impl


def test_registry_retention_keeps_newest(rng, tmp_path):
    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path), keep=2)
    dp = DynamicPlan(_prep(rows, cols, vals, a.shape))
    for _ in range(4):
        reg.save("g", dp)
    d = os.path.join(str(tmp_path), "g")
    assert len([x for x in os.listdir(d) if x.startswith("step_")]) == 2
    reg.load("g")


def test_crash_during_shard_write_preserves_previous_generation(
        rng, tmp_path, monkeypatch):
    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path))
    dp = DynamicPlan(_prep(rows, cols, vals, a.shape))
    reg.save("g", dp)

    real_save, calls = np.save, []

    def dying_save(path, arr, **kw):
        calls.append(path)
        if len(calls) >= 2:  # the first shard lands, the next write dies
            raise OSError("disk died mid-shard")
        return real_save(path, arr, **kw)

    monkeypatch.setattr(ck.np, "save", dying_save)
    with pytest.raises(RegistryError, match="persist"):
        reg.save("g", dp)
    monkeypatch.setattr(ck.np, "save", real_save)
    b = _b(rng, 64)
    assert torch.equal(reg.load("g").execute(b), dp.execute(b))
    assert reg.generation_fallbacks == 0


def test_interrupted_manifest_replace_preserves_previous_generation(
        rng, tmp_path, monkeypatch):
    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path))
    dp = DynamicPlan(_prep(rows, cols, vals, a.shape))
    reg.save("g", dp)

    def dying_replace(src, dst):
        raise OSError("power loss during rename")

    monkeypatch.setattr(ck.os, "replace", dying_replace)
    with pytest.raises(RegistryError, match="persist"):
        reg.save("g", dp)
    monkeypatch.undo()
    assert reg.load("g").plan.shape == a.shape
    assert reg.generation_fallbacks == 0


def test_corrupt_newest_generation_falls_back_with_warning(rng, tmp_path):
    import warnings

    a, rows, cols, vals = _graph(rng)
    reg = PlanRegistry(str(tmp_path), keep=2)
    dp = DynamicPlan(_prep(rows, cols, vals, a.shape))
    b = _b(rng, 64)
    want = dp.execute(b)
    reg.save("g", dp)
    reg.save("g", dp)
    with open(os.path.join(_entry_dir(str(tmp_path), "g"), "manifest.json"),
              "w") as f:
        f.write('{"meta": {')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        restored = reg.load("g")
    assert torch.equal(restored.execute(b), want)
    assert reg.generation_fallbacks == 1
    assert any(issubclass(w.category, RuntimeWarning)
               and "serving step_" in str(w.message) for w in caught)
    with open(os.path.join(str(tmp_path), "g", "step_000000001",
                           "manifest.json"), "w") as f:
        f.write("not json")
    with pytest.raises(RegistryError, match="every retained generation"):
        reg.load("g")


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def _mutated_pair(rng, a, rows, cols, vals):
    """The same DynamicPlan in both packages, with value updates and a
    pending overlay."""
    port = DynamicPlan(_prep(rows, cols, vals, a.shape), auto_compact=False)
    ref = JaxDynamicPlan(jax_spmm.prepare(rows, cols, vals, a.shape, JCFG),
                         auto_compact=False)
    dense = np.zeros(a.shape)
    np.add.at(dense, (rows, cols), vals)
    zr, zc = np.nonzero(dense == 0)
    batch = dict(ins_rows=zr[:5], ins_cols=zc[:5], ins_vals=rng.randn(5),
                 del_rows=rows[:2], del_cols=cols[:2],
                 upd_rows=rows[5:9], upd_cols=cols[5:9],
                 upd_vals=rng.randn(4))
    port.update(GraphDelta(**batch))
    ref.update(JaxGraphDelta(**batch))
    assert port.delta_nnz == ref.delta_nnz == 7
    return port, ref


def _assert_state_equal(port, ref):
    for name in LEAF_NAMES:
        assert np.array_equal(getattr(port.plan, name).numpy(),
                              np.asarray(getattr(ref.plan, name))), name
    for name in MAPS:
        got, want = (getattr(port.maps, name), getattr(ref.maps, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert port._overlay == ref._overlay
    assert port.compactions == ref.compactions


def test_reference_entry_loads_in_the_port(rng, tmp_path):
    a, rows, cols, vals = _graph(rng)
    _, ref = _mutated_pair(rng, a, rows, cols, vals)
    JaxPlanRegistry(str(tmp_path)).save("g", ref)
    before = spmm.prepare_call_count()
    port = PlanRegistry(str(tmp_path)).load("g", impl="torch")  # the map
    assert spmm.prepare_call_count() == before
    assert port.config.impl == "torch"
    _assert_state_equal(port, ref)
    b = np.random.RandomState(1).randn(64, 8).astype(np.float32)
    out = port.execute(torch.from_numpy(b)).numpy()
    want = np.asarray(ref.execute(jnp.asarray(b)))
    assert np.abs(out - want).max() <= TOL * max(1.0, np.abs(want).max())


def test_port_entry_loads_in_the_reference(rng, tmp_path):
    a, rows, cols, vals = _graph(rng)
    port, _ = _mutated_pair(rng, a, rows, cols, vals)
    reg = PlanRegistry(str(tmp_path))
    reg.save("g", port)
    # the one field mapped: the impl, in the config and the signature
    mpath = os.path.join(_entry_dir(str(tmp_path), "g"), "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    meta = manifest["meta"]
    assert meta["config"]["impl"] == "torch"
    meta["config"]["impl"] = "xla"
    meta["signature"] = meta["signature"].replace("'torch'", "'xla'", 1)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    before = jax_spmm.prepare_call_count()
    ref = JaxPlanRegistry(str(tmp_path)).load("g")
    assert jax_spmm.prepare_call_count() == before
    _assert_state_equal(port, ref)
    b = np.random.RandomState(2).randn(64, 8).astype(np.float32)
    out = port.execute(torch.from_numpy(b)).numpy()
    want = np.asarray(ref.execute(jnp.asarray(b)))
    assert np.abs(out - want).max() <= TOL * max(1.0, np.abs(want).max())
    # and back: the port loads the entry the reference reads
    again = reg.load("g", impl="torch")
    _assert_state_equal(again, ref)


def test_structured_entry_keeps_its_hint_through_a_fold(rng, tmp_path):
    """An N:M plan prepared with ``structure_hint=("nm", 2, 4)``: the
    registry's JSON stores the hint as a list; the port's loader makes it
    a tuple again, so the loaded plan's leaves and signature are the
    saved ones and a fold still packs 2:4.  (C10: the reference's loader
    keeps the list, so its fold falls back to the general payload; this
    test shows that too.)"""
    m, k = 64, 64
    g = rng.randn(m, k // 4, 4)
    keep = np.argsort(rng.rand(*g.shape), axis=-1) < 2
    w = np.where(keep, g, 0.0).reshape(m, k)
    rows, cols = np.nonzero(w)
    vals = w[rows, cols]
    kw = dict(bm=32, bk=16, structure_hint=("nm", 2, 4), alpha=1e-9,
              enable_col_stage=False)
    cfg = spmm.SpmmConfig(impl="torch", **kw)
    plan = _prep(rows, cols, vals, (m, k), cfg)
    assert plan.matrix_format == "nm"
    reg = PlanRegistry(str(tmp_path))
    reg.save("w", DynamicPlan(plan, auto_compact=False))
    loaded = reg.load("w")
    assert loaded.config == cfg and hash(loaded.config) == hash(cfg)
    assert loaded.plan.signature() == plan.signature()
    for name in LEAF_NAMES:
        assert torch.equal(getattr(loaded.plan, name), getattr(plan, name))
    loaded.compact()
    assert loaded.plan.matrix_format == "nm"
    assert loaded.plan.format_params == (2, 4)
    # the reference, on the same entry layout
    jreg = JaxPlanRegistry(str(tmp_path))
    jreg.save("j", JaxDynamicPlan(jax_spmm.prepare(
        rows, cols, vals, (m, k), jax_spmm.SpmmConfig(impl="xla", **kw)),
        auto_compact=False))
    jl = jreg.load("j")
    assert isinstance(jl.config.structure_hint, list)
    jl.compact()
    assert jl.plan.matrix_format == "general"
