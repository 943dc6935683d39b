"""LM training on the card, at a small size: ``chip_smoke.py`` phase 12's
checks.

Marked ``gpu``: they need a CUDA device and skip without one.  Run them on
a machine with a card::

    python -m pytest -m gpu tests/test_torch_lm_train_gpu.py

This file imports only the port (the machine with the card has no JAX).
Tolerances: fp32 compute, TF32 off; a loss and gradients within 1e-4 *
max(1, max |ref|) of the CPU's, ``apply_updates`` within 1e-6 * max(1,
max |ref|); remat and the restart drill bit for bit, with deterministic
kernels (the embedding's and the MoE gather's backward add with atomics
otherwise).
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.examples import lm_training
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import model
from repro_torch.train import controller, optimizer as opt_lib, train_loop

pytestmark = pytest.mark.gpu

FAMILIES = ["qwen1.5-4b", "granite-moe-3b-a800m", "mamba2-1.3b",
            "zamba2-1.2b", "phi-3-vision-4.2b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def _cfg(name):
    return dataclasses.replace(get_arch(name).smoke,
                               compute_dtype=torch.float32)


def _dcfg(cfg, batch=4, seq=32):
    return pipeline.DataConfig(
        global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
        num_patches=cfg.num_patches)


def _close(got, want, tol):
    got, want = got.detach().float(), want.detach().float().to(got.device)
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item() if got.numel() else 0.0
    assert err <= tol * max(1.0, want.abs().max().item()), err


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.cpu().numpy()


@pytest.mark.parametrize("name", ["qwen1.5-4b", "granite-moe-3b-a800m"])
def test_steps_are_finite_in_bf16(cuda, name):
    """The configs' own bf16 compute, remat full, 2 microbatches."""
    cfg = get_arch(name).smoke
    tcfg = train_loop.TrainConfig(num_microbatches=2)
    params, opt = train_loop.init_train_state(
        cfg, tcfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    step = train_loop.make_train_step(cfg, tcfg)
    for s in range(3):
        params, opt, m = step(params, opt, pipeline.make_batch(_dcfg(cfg), s))
        assert np.isfinite(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))


@pytest.mark.parametrize("name", ["qwen1.5-4b", "granite-moe-3b-a800m"])
def test_remat_gives_the_same_gradients(cuda, deterministic, name):
    cfg = _cfg(name)
    params = model.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                               cuda)
    leaves = opt_lib.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = pipeline.make_batch(_dcfg(cfg), 0)
    out = {}
    for remat in ("full", "none"):
        loss, _ = model.loss_fn(params, batch,
                                dataclasses.replace(cfg, remat=remat))
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(out["full"][1], out["none"][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_step_on_the_card_against_the_cpu(cuda, name):
    cfg = _cfg(name)
    tree = _numpy_tree(model.init_params(cfg, torch.Generator().manual_seed(1),
                                         "cpu"))
    batch = pipeline.make_batch(_dcfg(cfg, 2, 24), 0)
    res = {}
    for where in ("cpu", cuda):
        p = lm_params_from_arrays(tree, cfg, device=where)
        leaves = opt_lib.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = model.loss_fn(p, batch, cfg)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        res[str(where)] = (loss, [x if x is not None else torch.zeros_like(t)
                                  for x, t in zip(g, leaves)], p)
    (lc, gc, pc), (lg, gg, pg) = res["cpu"], res[str(cuda)]
    _close(lg.reshape(1), lc.reshape(1), 1e-4)
    for a, b in zip(gg, gc):
        _close(a, b, 1e-4)
    ocfg = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    states = []
    for p in (pc, pg):
        st = opt_lib.init_opt_state(p, ocfg)
        flat = {id(t): x.to(t.device) for t, x in
                zip(opt_lib.tree_leaves(p), gc)}
        grads = opt_lib.tree_map(lambda t: flat[id(t)], p)
        for _ in range(2):
            p, st, _ = opt_lib.apply_updates(p, grads, st, ocfg)
        states.append(opt_lib.tree_leaves((p, st.m, st.v)))
    for a, b in zip(states[1], states[0]):
        _close(a, b, 1e-6)


def test_restart_drill_bit_for_bit(cuda, deterministic, tmp_path):
    cfg = _cfg("qwen1.5-4b")
    tcfg = train_loop.TrainConfig(optimizer=opt_lib.OptimizerConfig(
        lr=3e-4, warmup_steps=2, total_steps=10))
    finals = []
    for fail in (None, 6):
        params, opt = train_loop.init_train_state(
            cfg, tcfg, torch.Generator(device=cuda).manual_seed(0), cuda)
        ctl = controller.TrainController(
            train_loop.make_train_step(cfg, tcfg),
            lambda s: pipeline.make_batch(_dcfg(cfg), s),
            controller.ControllerConfig(ckpt_dir=str(tmp_path / str(fail)),
                                        save_every=5))
        params, opt, _ = ctl.run(
            params, opt, 10, failure_at=None if fail is None else
            (lambda s, c=ctl: s == fail and not c.restart_events))
        assert ctl.restart_events == ([] if fail is None else [6])
        finals.append(opt_lib.tree_leaves((params, opt)))
        assert all(t.device.type == "cuda" for t in finals[-1])
    for a, b in zip(*finals):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_example_small_on_the_card(cuda):
    log = lm_training.main(["--device", "cuda", "--steps", "24",
                            "--d-model", "64", "--layers", "2",
                            "--batch", "4", "--seq", "32"])
    assert len(log) > 24
