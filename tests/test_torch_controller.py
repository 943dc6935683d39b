"""The port's fault-tolerant controller (``repro_torch.train.controller``)
against the JAX package's, and the training checkpoint across packages.

The four tests of ``tests/test_controller.py`` run on both packages, each
as itself; then a restarted run's final params and moments equal an
uninterrupted run's bit for bit on the CPU.  The checkpoint tests pin two
repairs of ``repro_torch.checkpoint``:

- C14: a tree holding a ``NamedTuple`` (the optimizer's ``OptState``)
  saves under the reference's leaf names (``1_step``, ``1_m_w``, ...) and
  restores, in both directions between the packages;
- C15: bfloat16 leaves save as the reference writes them (the same
  manifest and ``.npy`` bytes) and restore.  The reference's own
  ``restore`` cannot cast its ``<V2`` items back to bfloat16 here (reference
  caveat C17), so the reverse direction is held to the bytes: the port's
  files are the reference's, and the reference's restore treats both
  alike.
"""
import filecmp
import os
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import port_cfg  # noqa: E402
from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.data import pipeline  # noqa: E402
from repro.models.config import ModelConfig  # noqa: E402
from repro.train import controller as jctl, optimizer as jopt  # noqa: E402
from repro.train import train_loop as jtl  # noqa: E402
from repro_torch.checkpoint import checkpoint as tck  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    lm_params_from_arrays, opt_state_from_arrays,
)
from repro_torch.train import controller as tctl  # noqa: E402
from repro_torch.train import optimizer as topt, train_loop as ttl  # noqa: E402

CFG = ModelConfig(name="t", family="dense", num_layers=2, d_model=48,
                  num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=128,
                  kv_chunk=16, compute_dtype=jnp.float32)
DCFG = pipeline.DataConfig(global_batch=4, seq_len=24, vocab_size=128)
PACKAGES = ["repro", "repro_torch"]


def _setup(pkg, tmp_path, save_every=5):
    if pkg == "repro":
        tcfg = jtl.TrainConfig(optimizer=jopt.OptimizerConfig(
            lr=1e-3, warmup_steps=2, total_steps=100))
        params, opt = jtl.init_train_state(jax.random.PRNGKey(0), CFG, tcfg)
        step = jax.jit(jtl.make_train_step(CFG, tcfg))
        ctl = jctl.TrainController(
            step, lambda s: jax.tree.map(jnp.asarray,
                                         pipeline.make_batch(DCFG, s)),
            jctl.ControllerConfig(ckpt_dir=str(tmp_path),
                                  save_every=save_every))
        return params, opt, ctl, jctl
    tcfg = ttl.TrainConfig(optimizer=topt.OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=100))
    params, opt = ttl.init_train_state(
        port_cfg(CFG), tcfg, torch.Generator().manual_seed(0), "cpu")
    step = ttl.make_train_step(port_cfg(CFG), tcfg)
    ctl = tctl.TrainController(
        step, lambda s: pipeline.make_batch(DCFG, s),
        tctl.ControllerConfig(ckpt_dir=str(tmp_path), save_every=save_every))
    return params, opt, ctl, tctl


# --- the four tests of tests/test_controller.py, on both packages ----------
@pytest.mark.parametrize("pkg", PACKAGES)
def test_restart_resumes_from_checkpoint(pkg, tmp_path):
    params, opt, ctl, _ = _setup(pkg, tmp_path)
    p, o, log = ctl.run(params, opt, 16,
                        failure_at=lambda s: s == 12 and not ctl.restart_events)
    assert ctl.restart_events == [12]
    steps = [entry["step"] for entry in log]
    assert steps[-1] == 15
    # steps 10..12 replayed after restore from step-10 checkpoint
    assert steps.count(11) == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_restart_is_deterministic(pkg, tmp_path):
    """The replayed steps produce identical losses (deterministic data)."""
    params, opt, ctl, _ = _setup(pkg, tmp_path)
    _, _, log = ctl.run(params, opt, 14,
                        failure_at=lambda s: s == 11 and not ctl.restart_events)
    by_step = {}
    replays = 0
    for entry in log:
        if entry["step"] in by_step:
            assert abs(by_step[entry["step"]] - entry["loss"]) < 1e-5
            replays += 1
        by_step[entry["step"]] = entry["loss"]
    assert replays > 0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_straggler_detection(pkg, tmp_path):
    """The reference's test, whose injected step sleeps 1 s; here it
    sleeps at least 4x the median step so far, so that a loaded machine's
    slow steps (an eager CPU step under six test workers) cannot hide it
    under the 3x threshold."""
    params, opt, ctl, _ = _setup(pkg, tmp_path, save_every=100)
    orig = ctl.train_step

    def slow_step(p, o, b, _n=[0]):
        _n[0] += 1
        if _n[0] == 12:
            time.sleep(max(1.0, 4 * float(np.median(ctl.step_times))))
        return orig(p, o, b)

    ctl.train_step = slow_step
    ctl.run(params, opt, 14)
    assert len(ctl.straggler_events) >= 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_gives_up_after_max_restarts(pkg, tmp_path):
    params, opt, ctl, mod = _setup(pkg, tmp_path)
    ctl.cfg.max_restarts = 2
    with pytest.raises(mod.SimulatedFailure):
        ctl.run(params, opt, 10, failure_at=lambda s: s == 3)


# --- the port's restart, bit for bit -------------------------------------
def test_restart_equals_uninterrupted_bit_for_bit(tmp_path):
    """Save every 5 steps, fail at step 6, run to 10: the params, moments
    and step equal an uninterrupted run's exactly; restored leaves are
    back in their dtypes, and params require grad again."""
    runs = {}
    for name, fail in (("plain", None), ("restarted", 6)):
        params, opt, ctl, _ = _setup("repro_torch", tmp_path / name)
        failure = (None if fail is None else
                   (lambda s, ctl=ctl: s == fail and not ctl.restart_events))
        p, o, log = ctl.run(params, opt, 10, failure_at=failure)
        runs[name] = (p, o, ctl.restart_events)
    assert runs["restarted"][2] == [6] and runs["plain"][2] == []
    (pa, oa, _), (pb, ob, _) = runs["plain"], runs["restarted"]
    assert int(oa.step) == int(ob.step) == 10
    for a, b in zip(topt.tree_leaves((pa, oa)), topt.tree_leaves((pb, ob))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(p.requires_grad for p in topt.tree_leaves(pb))


# --- C14 and C15: the training checkpoint across packages ----------------
def _reference_state():
    tcfg = jtl.TrainConfig(optimizer=jopt.OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=100))
    params, opt = jtl.init_train_state(jax.random.PRNGKey(0), CFG, tcfg)
    step = jax.jit(jtl.make_train_step(CFG, tcfg))
    params, opt, _ = step(params, opt, jax.tree.map(
        jnp.asarray, pipeline.make_batch(DCFG, 0)))
    return params, opt


def _port_state(jparams, jopt_state):
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                   port_cfg(CFG), device="cpu")
    return params, opt_state_from_arrays(jax.tree.map(np.asarray,
                                                      jopt_state), params)


def test_namedtuple_leaves_are_named_by_field():
    """C14: ``OptState``'s fields name its leaves, as in the reference."""
    jparams, jstate = _reference_state()
    params, state = _port_state(jparams, jstate)
    want = [name for name, _ in jck._leaf_paths((jparams, jstate))]
    got = [name for name, _ in tck._leaf_paths((params, state))]
    assert got == want
    assert "1_step" in got and any(n.startswith("1_m_") for n in got)


def test_reference_training_checkpoint_restores_in_the_port(tmp_path):
    """C14: ``(params, OptState)`` written by the reference restores in
    the port (leaf for leaf equal, an ``OptState`` again)."""
    jparams, jstate = _reference_state()
    jck.save(str(tmp_path), 1, (jparams, jstate))
    params, state = _port_state(jparams, jstate)
    step, (rp, rs) = tck.restore(str(tmp_path), (params, state))
    assert step == 1 and isinstance(rs, topt.OptState)
    for want, got in zip(jax.tree.leaves((jparams, jstate)),
                         topt.tree_leaves((rp, rs))):
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_port_training_checkpoint_restores_in_the_reference(tmp_path):
    """C14, the reverse: the port's ``(params, OptState)`` restores in the
    reference, and the two packages' files are the same bytes."""
    jparams, jstate = _reference_state()
    params, state = _port_state(jparams, jstate)
    tck.save(str(tmp_path / "port"), 1, (params, state))
    jck.save(str(tmp_path / "ref"), 1, (jparams, jstate))
    step, (rp, rs) = jck.restore(str(tmp_path / "port"), (jparams, jstate))
    assert step == 1 and isinstance(rs, jopt.OptState)
    for want, got in zip(topt.tree_leaves((params, state)),
                         jax.tree.leaves((rp, rs))):
        assert np.array_equal(np.asarray(got), want.numpy())
    _same_files(tmp_path / "port", tmp_path / "ref")


def _same_files(a, b):
    da, db = a / "step_000000001", b / "step_000000001"
    names = sorted(os.listdir(da))
    assert names == sorted(os.listdir(db))
    for n in names:
        assert filecmp.cmp(da / n, db / n, shallow=False), n


def _bf16_trees():
    rng = np.random.RandomState(0)
    w = rng.randn(6, 5).astype(np.float32)
    s = np.float32(rng.randn())
    f = rng.randn(3).astype(np.float32)
    jtree = {"w": jnp.asarray(w, jnp.bfloat16),
             "s": jnp.asarray(s, jnp.bfloat16), "f": jnp.asarray(f)}
    ttree = {"w": torch.from_numpy(w).bfloat16(),
             "s": torch.tensor(s).bfloat16(), "f": torch.from_numpy(f)}
    return jtree, ttree


def test_bf16_tree_round_trips_through_both_packages(tmp_path):
    """C15: the port saves bf16 leaves (it raised on ``.numpy()``) in the
    reference's bytes, restores them bit for bit, and restores the
    reference's own bf16 checkpoint."""
    jtree, ttree = _bf16_trees()
    tck.save(str(tmp_path / "port"), 1, ttree)
    jck.save(str(tmp_path / "ref"), 1, jtree)
    _same_files(tmp_path / "port", tmp_path / "ref")
    for where in ("port", "ref"):
        _, back = tck.restore(str(tmp_path / where), ttree)
        for k in ttree:
            got = torch.as_tensor(back[k])
            assert got.dtype == ttree[k].dtype and torch.equal(got, ttree[k])
    # the reference reads the port's files as it reads its own (C17: on
    # this jax its restore cannot cast <V2 items to bfloat16)
    outcomes = []
    for where in ("port", "ref"):
        try:
            _, back = jck.restore(str(tmp_path / where), jtree)
            outcomes.append([np.asarray(back[k]).tobytes() for k in jtree])
        except ValueError as err:
            outcomes.append(str(err))
    assert outcomes[0] == outcomes[1]


def test_bf16_moments_checkpoint_through_the_controller(tmp_path):
    """C15 on the training path: ``moment_dtype=bfloat16`` saves, and a
    restore puts each leaf back in its live dtype and device."""
    tcfg = ttl.TrainConfig(optimizer=topt.OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=100,
        moment_dtype=torch.bfloat16))
    params, opt = ttl.init_train_state(
        port_cfg(CFG), tcfg, torch.Generator().manual_seed(0), "cpu")
    ctl = tctl.TrainController(
        ttl.make_train_step(port_cfg(CFG), tcfg),
        lambda s: pipeline.make_batch(DCFG, s),
        tctl.ControllerConfig(ckpt_dir=str(tmp_path), save_every=2))
    p, o, _ = ctl.run(params, opt, 4,
                      failure_at=lambda s: s == 3 and not ctl.restart_events)
    assert ctl.restart_events == [3]
    assert all(m.dtype == torch.bfloat16 for m in topt.tree_leaves(o.m))
    _, (rp, ro) = tck.restore(str(tmp_path), (p, o))
    for a, b in zip(topt.tree_leaves((p, o)), topt.tree_leaves((rp, ro))):
        assert torch.equal(torch.as_tensor(b), a.detach())
