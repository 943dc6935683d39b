"""The port's training substrate (``repro_torch.train``) against the JAX
package's, on the CPU.

The six tests of ``tests/test_train.py`` run on both packages, each
package as itself (its own init, its own step); then the optimizer's
pieces against the reference's on the same inputs (``schedule``,
``global_norm``, ``apply_updates`` within 1e-6 * max(1, max |ref|), fp32
on both sides, moments in fp32 and bf16), compression bit for bit, the
gradient under ``remat="full"`` equal to ``"none"`` bit for bit, and the
launcher and the example at small sizes.  One train step of each family
from the same state is in ``tests/test_torch_train_step.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import port_cfg  # noqa: E402
from repro.data import pipeline  # noqa: E402
from repro.models.config import ModelConfig  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt, train_loop as jtl  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.examples import lm_training  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as pm  # noqa: E402
from repro_torch.train import compression as pcomp  # noqa: E402
from repro_torch.train import optimizer as popt, train_loop as ptl  # noqa: E402

CFG = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                  kv_chunk=16, compute_dtype=jnp.float32)
DCFG = pipeline.DataConfig(global_batch=4, seq_len=32, vocab_size=128)
PACKAGES = ["repro", "repro_torch"]


class _Jax:
    """The reference test's calls."""
    opt, comp = jopt, jcomp

    @staticmethod
    def array(x):
        return jnp.asarray(x)

    @staticmethod
    def numpy(x):
        return np.asarray(x)

    @staticmethod
    def train(tcfg_kw, opt_cfg):
        tcfg = jtl.TrainConfig(optimizer=jopt.OptimizerConfig(**opt_cfg),
                               **tcfg_kw)
        params, opt = jtl.init_train_state(jax.random.PRNGKey(0), CFG, tcfg)
        return params, opt, jax.jit(jtl.make_train_step(CFG, tcfg))

    @staticmethod
    def batch(step):
        return jax.tree.map(jnp.asarray, pipeline.make_batch(DCFG, step))

    @staticmethod
    def leaves(tree):
        return [np.asarray(x) for x in jax.tree.leaves(tree)]


class _Torch:
    """The same calls on the port: its own init (seed 0) and step."""
    opt, comp = popt, pcomp

    @staticmethod
    def array(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    @staticmethod
    def numpy(x):
        return x.detach().numpy()

    @staticmethod
    def train(tcfg_kw, opt_cfg):
        tcfg = ptl.TrainConfig(optimizer=popt.OptimizerConfig(**opt_cfg),
                               **tcfg_kw)
        params, opt = ptl.init_train_state(
            port_cfg(CFG), tcfg, torch.Generator().manual_seed(0), "cpu")
        return params, opt, ptl.make_train_step(port_cfg(CFG), tcfg)

    @staticmethod
    def batch(step):
        return pipeline.make_batch(DCFG, step)

    @staticmethod
    def leaves(tree):
        return [x.detach().numpy().copy() for x in popt.tree_leaves(tree)]


BACKENDS = {"repro": _Jax, "repro_torch": _Torch}


# --- the six tests of tests/test_train.py, on both packages ---------------
@pytest.mark.parametrize("pkg", PACKAGES)
def test_loss_decreases(pkg):
    be = BACKENDS[pkg]
    params, opt, step = be.train(
        {}, dict(lr=1e-3, warmup_steps=2, total_steps=50))
    losses = []
    for s in range(15):
        params, opt, m = step(params, opt, be.batch(s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


@pytest.mark.parametrize("pkg", PACKAGES)
def test_microbatch_equivalence(pkg):
    """scan-accumulated, unrolled, and single-shot grads must agree."""
    be = BACKENDS[pkg]
    opt_cfg = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    outs = {}
    for name, kw in [
        ("single", dict(num_microbatches=1)),
        ("scan", dict(num_microbatches=2)),
        ("unroll", dict(num_microbatches=2, unroll_microbatches=True)),
    ]:
        params, opt, step = be.train(kw, opt_cfg)
        p2, _, m = step(params, opt, be.batch(0))
        outs[name] = (be.leaves(p2), float(m["loss"]))
    for a, b in [("scan", "unroll"), ("single", "scan")]:
        for x, y in zip(outs[a][0], outs[b][0]):
            np.testing.assert_allclose(x, y, rtol=2e-3, atol=2e-4)
    assert outs["scan"][1] == pytest.approx(outs["unroll"][1], rel=1e-5)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_optimizer_schedule(pkg):
    opt = BACKENDS[pkg].opt
    cfg = opt.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_frac=0.1)
    arr = BACKENDS[pkg].array
    assert float(opt.schedule(arr(0), cfg)) == 0.0
    assert float(opt.schedule(arr(10), cfg)) == pytest.approx(1.0)
    assert float(opt.schedule(arr(100), cfg)) == pytest.approx(0.1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_grad_clip(pkg):
    be = BACKENDS[pkg]
    cfg = be.opt.OptimizerConfig(clip_norm=1.0)
    params = {"w": be.array(np.ones(4))}
    grads = {"w": be.array(np.full(4, 100.0))}
    state = be.opt.init_opt_state(params, cfg)
    _, _, m = be.opt.apply_updates(params, grads, state, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_compression_error_feedback_telescopes(pkg):
    """Property: with error feedback, the cumulative applied update tracks
    the cumulative true gradient (bias telescopes away)."""
    be = BACKENDS[pkg]
    rng = np.random.RandomState(0)
    g_true = [rng.randn(64).astype(np.float32) * 10 ** rng.randn()
              for _ in range(20)]
    err = {"g": be.array(np.zeros(64))}
    applied = np.zeros(64)
    for g in g_true:
        deq, err = be.comp.compress_grads_with_feedback({"g": be.array(g)},
                                                        err)
        applied += be.numpy(deq["g"])
    total_true = np.sum(g_true, axis=0)
    resid = np.abs(be.numpy(err["g"])).max()
    assert np.abs(applied - total_true).max() <= resid + 1e-4


@pytest.mark.parametrize("pkg", PACKAGES)
def test_compression_quantization_error_bounded(pkg):
    be = BACKENDS[pkg]
    w = np.random.RandomState(1).randn(1000) * 5
    g = {"w": jnp.asarray(w) if pkg == "repro" else torch.from_numpy(w)}
    err0 = be.comp.init_error_feedback(g)
    deq, err = be.comp.compress_grads_with_feedback(g, err0)
    scale = float(np.abs(be.numpy(g["w"])).max()) / 127.0
    assert float(np.abs(be.numpy(err["w"])).max()) <= scale * 0.5 + 1e-6


# --- the optimizer's pieces against the reference ------------------------
def _tree(rng, scale=1.0):
    """A params-like tree: stacked 2-D/3-D leaves and 1-D ones, keys out
    of sorted order."""
    shapes = {"stack": {"w_in": (3, 8, 16), "norm": (3, 16)},
              "embed": {"table": (32, 16)}, "final": {"scale": (16,)}}
    return {k: {n: (rng.randn(*s) * scale).astype(np.float32)
                for n, s in v.items()} for k, v in shapes.items()}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return popt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _within(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def test_tree_leaves_in_the_reference_order():
    tree = _tree(np.random.RandomState(0))
    for a, b in zip(jax.tree.leaves(tree), popt.tree_leaves(tree)):
        assert a is b


def test_schedule_matches_reference():
    for kw in (dict(), dict(warmup_steps=7, total_steps=50, lr=2e-3),
               dict(warmup_steps=0, total_steps=10, min_lr_frac=0.0)):
        jc, pc = jopt.OptimizerConfig(**kw), popt.OptimizerConfig(**kw)
        for s in (0, 1, 3, 7, 10, 49, 50, 100, 10000, 20000):
            want = float(jopt.schedule(jnp.asarray(s, jnp.int32), jc))
            got = float(popt.schedule(torch.tensor(s, dtype=torch.int32),
                                      pc))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (kw, s)


def test_global_norm_matches_reference():
    tree = _tree(np.random.RandomState(1), scale=3.0)
    want = float(jopt.global_norm(_jtree(tree)))
    assert float(popt.global_norm(_ttree(tree))) == pytest.approx(
        want, rel=1e-6)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moments, monkeypatch):
    """Three steps from the same state, clipped (grad norm above
    ``clip_norm``); the port's chunked in-place update against the
    reference's ``upd``, with chunks smaller than a leaf."""
    monkeypatch.setattr(popt, "CHUNK", 100)
    rng = np.random.RandomState(2)
    params = _tree(rng)
    jcfg = jopt.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=5,
                                moment_dtype=getattr(jnp, moments))
    pcfg = popt.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=5,
                                moment_dtype=getattr(torch, moments))
    jp, tp = _jtree(params), _ttree(params)
    js, ts = jopt.init_opt_state(jp, jcfg), popt.init_opt_state(tp, pcfg)
    for _ in range(3):
        grads = _tree(rng, scale=2.0)
        jp, js, jm = jopt.apply_updates(jp, _jtree(grads), js, jcfg)
        tp, ts, tm = popt.apply_updates(tp, _ttree(grads), ts, pcfg)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts.step) == int(js.step) == 3
    tol = 1e-6 if moments == "float32" else 1e-2   # one bf16 ulp
    for want, got in zip(jax.tree.leaves(jp), popt.tree_leaves(tp)):
        _within(got.numpy(), want, 1e-6)
    for tree_j, tree_t in ((js.m, ts.m), (js.v, ts.v)):
        for want, got in zip(jax.tree.leaves(tree_j),
                             popt.tree_leaves(tree_t)):
            assert got.dtype == getattr(torch, moments)
            _within(got.float().numpy(), np.asarray(want, np.float32), tol)


def test_opt_state_from_arrays_carries_bf16_moments():
    """``interop.opt_state_from_arrays`` carries the reference's state,
    bf16 moments bit for bit, onto the params' device."""
    from repro_torch.interop import opt_state_from_arrays

    rng = np.random.RandomState(6)
    params = _tree(rng)
    cfg = jopt.OptimizerConfig(moment_dtype=jnp.bfloat16)
    jp = _jtree(params)
    _, state, _ = jopt.apply_updates(jp, _jtree(_tree(rng)),
                                     jopt.init_opt_state(jp, cfg), cfg)
    got = opt_state_from_arrays(jax.tree.map(np.asarray, state),
                                _ttree(params))
    assert isinstance(got, popt.OptState) and int(got.step) == 1
    for tree_j, tree_t in ((state.m, got.m), (state.v, got.v)):
        for want, t in zip(jax.tree.leaves(tree_j), popt.tree_leaves(tree_t)):
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_apply_updates_in_place():
    """The update overwrites the params and moments it is given."""
    params = _ttree(_tree(np.random.RandomState(3)))
    cfg = popt.OptimizerConfig()
    state = popt.init_opt_state(params, cfg)
    before = popt.tree_leaves(params)
    ptrs = [t.data_ptr() for t in before + popt.tree_leaves(state.m)]
    p2, s2, _ = popt.apply_updates(params, _ttree(_tree(
        np.random.RandomState(4))), state, cfg)
    after = popt.tree_leaves(p2) + popt.tree_leaves(s2.m)
    assert [t.data_ptr() for t in after] == ptrs


def test_compression_bit_for_bit():
    """Five steps of error feedback on leaves of mixed magnitude: the
    dequantised grads and the residuals equal the reference's bit for bit
    (the same fp32 operations; ``round`` half-to-even in both)."""
    rng = np.random.RandomState(5)
    shapes = {"a": {"w": (40, 7)}, "b": {"v": (300,), "z": (5, 3, 2)}}
    jerr = jcomp.init_error_feedback(
        {k: {n: jnp.zeros(s) for n, s in v.items()}
         for k, v in shapes.items()})
    terr = pcomp.init_error_feedback(
        {k: {n: torch.zeros(s) for n, s in v.items()}
         for k, v in shapes.items()})
    for step in range(5):
        g = {k: {n: (rng.randn(*s) * 10.0 ** rng.randint(-3, 3)).astype(
            np.float32) for n, s in v.items()} for k, v in shapes.items()}
        g["b"]["v"][:3] = [0.5, -0.5, 1.5]    # ties for the rounding
        jdeq, jerr = jcomp.compress_grads_with_feedback(_jtree(g), jerr)
        tdeq, terr = pcomp.compress_grads_with_feedback(_ttree(g), terr)
        for tree_j, tree_t in ((jdeq, tdeq), (jerr, terr)):
            for want, got in zip(jax.tree.leaves(tree_j),
                                 popt.tree_leaves(tree_t)):
                assert np.array_equal(got.numpy(), np.asarray(want)), step


# --- remat, the launcher and the example ---------------------------------
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "granite-moe-3b-a800m",
                                  "zamba2-1.2b"])
def test_remat_full_gives_the_same_gradients(arch):
    """``remat="full"`` recomputes each group in the backward: the same
    loss and gradients as ``"none"``, bit for bit, on the CPU."""
    cfg = dataclasses.replace(get_arch(arch).smoke,
                              compute_dtype=torch.float32)
    batch = pipeline.make_batch(pipeline.DataConfig(
        global_batch=2, seq_len=16, vocab_size=cfg.vocab_size), 0)
    out = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        params = pm.init_params(c, torch.Generator().manual_seed(0), "cpu")
        leaves = popt.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = pm.loss_fn(params, batch, c)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves,
                                                         allow_unused=True))
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_launch_train_smoke_on_the_cpu(tmp_path):
    log = launch_train.main(["--arch", "qwen1.5-4b", "--smoke", "--device",
                             "cpu", "--steps", "3", "--microbatches", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert [entry["step"] for entry in log] == [0, 1, 2]
    assert all(np.isfinite(entry["loss"]) for entry in log)


def test_launch_train_with_compression_and_checkpoints(tmp_path):
    log = launch_train.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                             "--device", "cpu", "--steps", "4",
                             "--save-every", "2", "--grad-compression",
                             "--ckpt-dir", str(tmp_path)])
    assert len(log) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000002", "step_000000004"]


def test_lm_training_example_small_on_the_cpu():
    """The example at a small size; it asserts that the loss fell after
    its injected restart."""
    log = lm_training.main(["--device", "cpu", "--steps", "24",
                            "--d-model", "64", "--layers", "2",
                            "--batch", "4", "--seq", "32"])
    assert len(log) > 24     # the replayed steps after the restart


def test_entry_points_refuse_the_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen1.5-4b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_training.main(["--steps", "1"])
