"""One train step of the port against the reference's ``make_train_step``
from the same state, for the dense, moe, ssm, hybrid, vlm and audio smoke
configs at fp32 compute, on the CPU.

The state is carried over from the reference (``interop.
lm_params_from_arrays``, ``interop.opt_state_from_arrays``) after one
reference step, so the moments and the step count are not zero.  From
there the port runs with 1 and 2 microbatches, compression on and off,
remat none and full; the reference runs its jitted ``make_train_step``
with 2 microbatches and compression, and composes the other three cases
from its own pieces (``jax.grad(loss_fn)`` per microbatch, ``acc + g /
n``, ``compress_grads_with_feedback``, ``apply_updates``).

Tolerances: the loss within 1e-5 relative; the gradients within 1e-4 *
max(1, max |ref|) per leaf (``jax.grad`` against the port's backward);
params, moments and error feedback after the step within the reference
test's own rtol 2e-3 / atol 2e-4 (``tests/test_train.py``).  With
compression, one exemption: where a gradient lies within the two
packages' difference of a rounding boundary of the int8 grid, the two
round to neighbouring steps, the residuals differ by one quantisation
step (at most twice the largest residual), and that entry's update
differs; at most 0.1 % of a leaf's entries may, and those entries are
left out of the params' and moments' comparison.  Also the
gradient of the head for a padded vocabulary (granite's 49,155 -> 49,280)
and with ``final_softcap`` (gemma2).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import carry, close, port_cfg  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.data import pipeline  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt, train_loop as jtl  # noqa: E402
from repro_torch.interop import opt_state_from_arrays  # noqa: E402
from repro_torch.models import model as pm  # noqa: E402
from repro_torch.train import optimizer as popt, train_loop as ptl  # noqa: E402

FAMILIES = {"dense": "qwen1.5-4b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-1.3b", "hybrid": "zamba2-1.2b",
            "vlm": "phi-3-vision-4.2b", "audio": "hubert-xlarge"}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5


def _cfg(arch):
    return dataclasses.replace(get_arch(arch).smoke,
                               compute_dtype=jnp.float32)


def _batch(cfg, step):
    return pipeline.make_batch(pipeline.DataConfig(
        global_batch=4, seq_len=32, vocab_size=cfg.vocab_size,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
        num_patches=cfg.num_patches), step)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _micro(batch, n):
    m = len(next(iter(batch.values()))) // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


@pytest.fixture(scope="module", params=list(FAMILIES), ids=list(FAMILIES))
def case(request):
    """The reference's state after one step, and its second step in each
    of the four (microbatches, compression) cases."""
    cfg = _cfg(FAMILIES[request.param])
    ocfg = jopt.OptimizerConfig(**OPT)
    tcfg = jtl.TrainConfig(optimizer=ocfg, num_microbatches=2,
                           grad_compression=True)
    step = jax.jit(jtl.make_train_step(cfg, tcfg))
    p0, o0 = jtl.init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    e0 = jcomp.init_error_feedback(p0)
    b0, b1 = (jax.tree.map(jnp.asarray, _batch(cfg, s)) for s in (0, 1))
    p1, o1, e1, _ = step(p0, o0, b0, e0)
    state = (_np(p1), _np(o1), _np(e1))

    grad = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True),
                   static_argnums=2)
    (loss_full, _), g_full = grad(p1, b1, cfg)
    micro = [grad(p1, mb, cfg) for mb in _micro(b1, 2)]
    g_acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), p1)
    loss_acc = 0.0
    for (loss, _), g in micro:
        g_acc = jax.tree.map(lambda a, g: a + g.astype(jnp.float32) / 2,
                             g_acc, g)
        loss_acc = loss_acc + loss / 2

    ref = {}
    p2, o2, e2, m2 = step(p1, o1, b1, e1)
    ref[(2, True)] = (float(m2["loss"]), _np(p2), _np(o2), _np(e2))
    for n, loss, g in ((1, loss_full, g_full), (2, loss_acc, g_acc)):
        for comp in (False, True):
            if (n, comp) == (2, True):
                continue
            err = e1
            if comp:
                g, err = jcomp.compress_grads_with_feedback(g, e1)
            p, o, _ = jopt.apply_updates(p1, g, o1, ocfg)
            ref[(n, comp)] = (float(loss), _np(p), _np(o),
                              _np(err) if comp else None)
    return {"cfg": cfg, "state": state, "batch": _batch(cfg, 1),
            "grads": _np(g_full), "ref": ref}


def _port_state(case, cfg):
    p1, o1, e1 = case["state"]
    params = carry(p1, case["cfg"])
    for p in popt.tree_leaves(params):
        p.requires_grad_(True)
    opt = opt_state_from_arrays(o1, params)
    err = popt.tree_map(lambda a: torch.from_numpy(np.array(a)), e1)
    return params, opt, err


def _rounding_flips(got, want):
    """Per leaf, the entries whose error feedback differs by a whole
    quantisation step (the int8 rounding fell on either side)."""
    flips = []
    for g, w in zip(popt.tree_leaves(got), jax.tree.leaves(want)):
        g = np.asarray(g)
        off = ~np.isclose(g, w, rtol=2e-3, atol=2e-4)
        assert off.mean() <= 1e-3, off.sum()
        assert np.all(np.abs(g - w)[off] <= 2 * np.abs(w).max() + 2e-4)
        flips.append(off)
    return flips


def _assert_tree(got, want, skip=None):
    want = jax.tree.leaves(want)
    got = popt.tree_leaves(got)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        keep = ~skip[i] if skip is not None else np.ones(w.shape, bool)
        np.testing.assert_allclose(np.asarray(g.detach().float())[keep],
                                   np.asarray(w, np.float32)[keep],
                                   rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("comp", [False, True], ids=["plain", "compressed"])
@pytest.mark.parametrize("n", [1, 2], ids=["1micro", "2micro"])
def test_train_step_matches_reference(case, n, comp, remat):
    cfg = dataclasses.replace(port_cfg(case["cfg"]), remat=remat)
    params, opt, err = _port_state(case, cfg)
    tcfg = ptl.TrainConfig(optimizer=popt.OptimizerConfig(**OPT),
                           num_microbatches=n, grad_compression=comp)
    out = ptl.make_train_step(cfg, tcfg)(
        params, opt, case["batch"], *((err,) if comp else ()))
    loss, p2, o2, e2 = case["ref"][(n, comp)]
    assert float(out[-1]["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
    flips = _rounding_flips(out[2], e2) if comp else None
    _assert_tree(out[0], p2, flips)
    assert int(out[1].step) == int(o2.step) == 2
    _assert_tree(out[1].m, o2.m, flips)
    _assert_tree(out[1].v, o2.v, flips)


def test_gradients_match_jax_grad(case):
    """The port's backward (remat full, the configs' setting) against
    ``jax.grad(loss_fn)`` at the carried state."""
    params, _, _ = _port_state(case, None)
    loss, _ = pm.loss_fn(params, case["batch"], port_cfg(case["cfg"]))
    loss.backward()
    for want, got in zip(jax.tree.leaves(case["grads"]),
                         popt.tree_leaves(params)):
        # a leaf the loss does not reach (the audio model's embedding
        # table) has no gradient here and a zero one in JAX
        close(got.grad if got.grad is not None else torch.zeros_like(got),
              want)


@pytest.mark.parametrize("arch,over", [
    ("granite-moe-3b-a800m", {"vocab_size": 49155}),
    ("gemma2-9b", {}),
], ids=["padded_vocab", "final_softcap"])
def test_head_gradient(arch, over):
    """The head's padding columns, masked in place (autograd accepts it:
    the masked tensor is a product's output, which no backward reads), and
    the final soft-cap under autograd: loss and every gradient against
    ``jax.grad``."""
    cfg = dataclasses.replace(_cfg(arch), **over)
    assert cfg.padded_vocab != cfg.vocab_size or cfg.final_softcap
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    batch = pipeline.make_batch(pipeline.DataConfig(
        global_batch=2, seq_len=16, vocab_size=cfg.vocab_size), 0)
    (jloss, _), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, batch), cfg)
    params = carry(jp, cfg)
    leaves = popt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = pm.loss_fn(params, batch, port_cfg(cfg))
    loss.backward()
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    for want, got in zip(jax.tree.leaves(jg), leaves):
        close(got.grad, want)
