"""The port's backward (``exec.api.SpMMFunction``, ``SDDMMFunction``,
``SpMMOperator``) and GCN training against the JAX package, on the CPU.

- the port's ``SpMMOperator``, forward and gradient, against the JAX
  ``SpMMOperator`` (``impl="xla"``); its transpose plan leaf for leaf
  against the reference's ``plan_t``;
- ``sp.spmm`` and ``sp.bspmm`` gradients against ``Aᵀ G`` in fp64, and
  after ``with_values`` (the transpose structure is shared by every plan a
  value update derives, its values are not);
- ``sp.sddmm`` gradients in X and Y against ``jax.grad`` of
  ``repro.sparse.sddmm`` (``impl="xla"``) on a COO with duplicates;
- one SGD step of the two-layer ``SparseGraphConv`` GCN, on weights carried
  across with ``interop.graph_conv_from_arrays``, against JAX's;
- the port's ``make_graph`` at its defaults bit-equal to the reference
  example's, and the training example on the CPU;
- the SDDMM fringe walk (row order, positions, the Y^T rows through the
  column permutation) against numpy, and ``execute_sddmm`` on a shuffled
  COO against the reference.

Inputs come from numpy seeds.  Tolerance: max |diff| <= 1e-4 * max(1,
max |ref|) (fp32 on both sides, summed in different orders).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.sparse as jsp  # noqa: E402
from repro.core import spmm as jax_spmm  # noqa: E402
from repro.exec.api import SpMMOperator as JaxSpMMOperator  # noqa: E402
from repro.models.layers import SparseGraphConv as JaxConv  # noqa: E402
import repro_torch.sparse as sp  # noqa: E402
from repro_torch.core import plan_ir  # noqa: E402
from repro_torch.core.plan_ir import LEAF_NAMES, SpmmConfig  # noqa: E402
from repro_torch.examples import gcn_training  # noqa: E402
from repro_torch.exec import api  # noqa: E402
from repro_torch.interop import graph_conv_from_arrays  # noqa: E402
from conftest import make_sparse  # noqa: E402

TOL = 1e-4
_ROOT = Path(__file__).resolve().parents[1]


def _close(got, want, tol=TOL):
    got = (got.detach().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got))
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, (err, scale)


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_gcn_training", _ROOT / "examples" / "gcn_training.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def matrix():
    rng = np.random.RandomState(0)
    a, rows, cols, vals = make_sparse(rng, 120, 100, 0.06, n_dense_rows=6)
    return a, rows, cols, vals


# --- SpMMOperator -------------------------------------------------------------


def test_spmm_operator_forward_and_grad(matrix):
    """Mirrors tests/test_operator_and_reuse.py::
    test_spmm_operator_forward_and_grad, against the JAX operator."""
    a, rows, cols, vals = matrix
    rng = np.random.RandomState(1)
    b = rng.randn(100, 64).astype(np.float32)
    w = rng.randn(120, 64).astype(np.float32)
    jop = JaxSpMMOperator(rows, cols, vals, a.shape,
                          jax_spmm.SpmmConfig(impl="xla"))
    op = api.SpMMOperator(rows, cols, vals, a.shape, SpmmConfig(impl="torch"))
    bt = torch.from_numpy(b).requires_grad_(True)
    out = op(bt)
    _close(out, np.asarray(jop(jnp.asarray(b))))
    (out * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda bb: jnp.sum(jop(bb) * jnp.asarray(w)))(
        jnp.asarray(b))
    _close(bt.grad, np.asarray(want))
    _close(bt.grad, a.T.astype(np.float64) @ w)
    assert op.plan_t.shape == (100, 120)


@pytest.mark.parametrize("cfg", [
    dict(), dict(alpha=1.0), dict(alpha=1e-9, enable_col_stage=False),
    dict(reorder_cols=True),
])
def test_transpose_plan_matches_reference_plan_t(matrix, cfg):
    """The transpose plan is prepare of (cols, rows, vals), shape (K, M),
    the same config: leaf for leaf the reference's plan_t."""
    a, rows, cols, vals = matrix
    jop = JaxSpMMOperator(rows, cols, vals, a.shape,
                          jax_spmm.SpmmConfig(impl="xla", **cfg))
    plan = sp.from_coo(rows, cols, vals, a.shape, device="cpu", **cfg).plan
    ours = api.transpose_structure(plan)
    assert ours is api.transpose_structure(plan)  # built once
    assert ours.shape == (100, 120) and ours.config == plan.config
    theirs, _ = jop.plan_t.tree_flatten()
    for name, want in zip(LEAF_NAMES, theirs):
        got = getattr(ours, name).numpy()
        assert np.array_equal(got, np.asarray(want)), name


# --- spmm / bspmm gradients ----------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("cfg", [
    dict(), dict(alpha=1.0), dict(alpha=1e-9, enable_col_stage=False),
    dict(reorder_cols=True),
])
def test_spmm_gradient_is_at_g(matrix, batched, cfg):
    a, rows, cols, vals = matrix
    A = sp.from_coo(rows, cols, vals, a.shape, device="cpu", **cfg)
    rng = np.random.RandomState(2)
    shape = (3, 100, 9) if batched else (100, 9)
    b = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    g = rng.randn(*shape[:-2], 120, 9)
    b.requires_grad_(True)
    out = sp.bspmm(A, b) if batched else sp.spmm(A, b)
    (out * torch.from_numpy(g.astype(np.float32))).sum().backward()
    _close(b.grad, np.einsum("mk,...mn->...kn", a.astype(np.float64), g))


def test_gradient_in_float64_operand_keeps_its_dtype(matrix):
    a, rows, cols, vals = matrix
    A = sp.from_coo(rows, cols, vals, a.shape, device="cpu")
    b = torch.randn(100, 4, dtype=torch.float64, requires_grad=True)
    sp.spmm(A, b).sum().backward()
    assert b.grad.dtype == torch.float64
    _close(b.grad, a.T.astype(np.float64) @ np.ones((120, 4)))


def test_gradient_after_with_values_uses_the_new_values(matrix):
    """Every plan with_values derives shares plan.derived, and with it the
    transpose structure: each gradient must use its own plan's values,
    whichever plan asked first."""
    a, rows, cols, vals = matrix
    A = sp.from_coo(rows, cols, vals, a.shape, device="cpu")
    rng = np.random.RandomState(4)
    new = rng.randn(rows.size).astype(np.float32)
    a2 = np.zeros_like(a, dtype=np.float64)
    a2[rows, cols] = new
    g = rng.randn(120, 5)
    gt = torch.from_numpy(g.astype(np.float32))

    def grad(m):
        b = torch.zeros(100, 5, requires_grad=True)
        (sp.spmm(m, b) * gt).sum().backward()
        return b.grad

    _close(grad(A), a.T.astype(np.float64) @ g)
    A2 = A.with_values(new)
    assert A2.plan.derived is A.plan.derived
    _close(grad(A2), a2.T @ g)
    _close(grad(A), a.T.astype(np.float64) @ g)
    # a fresh pattern whose first gradient is taken on the updated plan
    B = sp.from_coo(rows, cols, vals, a.shape, device="cpu")
    B2 = B.with_values(new)
    _close(grad(B2), a2.T @ g)
    _close(grad(B), a.T.astype(np.float64) @ g)
    # the structure holds the values of the plan that first asked (B2's);
    # another plan's transpose is built once and kept while it is the last
    assert api.transpose_plan(B2.plan) is api.transpose_structure(B.plan)
    own = api.transpose_plan(B.plan)
    assert own is not api.transpose_structure(B.plan)
    assert api.transpose_plan(B.plan) is own
    # equal values in another array are another plan's: built anew, right
    B3 = B.with_values(vals.copy())
    assert api.transpose_plan(B3.plan) is not own
    _close(grad(B3), a.T.astype(np.float64) @ g)


def test_attention_aggregation_gradient_uses_the_attention_weights(matrix):
    """The attention layer aggregates on a with_values plan: the gradient
    of that SpMM in its dense operand is (A_att)ᵀ g."""
    a, rows, cols, vals = matrix
    A = sp.from_coo(rows, cols, vals, a.shape, device="cpu")
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(120, 8).astype(np.float32))
    y = torch.from_numpy(rng.randn(8, 100).astype(np.float32))
    scores = torch.softmax(sp.sddmm(A, x, y), 0)
    att = A.with_values(scores)
    v = torch.from_numpy(rng.randn(100, 6).astype(np.float32))
    v.requires_grad_(True)
    sp.spmm(att, v).sum().backward()
    dense = np.zeros(a.shape)
    dense[rows, cols] = scores.detach().numpy()
    _close(v.grad, dense.T @ np.ones((120, 6)))


# --- sddmm gradients -----------------------------------------------------------


def _dup_coo(rng, m=70, k=60, nnz=900):
    """A shuffled COO with duplicate entries and one dense row."""
    rows = np.concatenate([rng.randint(0, m, nnz), np.full(k, 3)])
    cols = np.concatenate([rng.randint(0, k, nnz), np.arange(k)])
    dup = rng.choice(rows.size, 80, replace=False)
    rows = np.concatenate([rows, rows[dup]])
    cols = np.concatenate([cols, cols[dup]])
    perm = rng.permutation(rows.size)
    rows, cols = rows[perm], cols[perm]
    return rows, cols, rng.randn(rows.size).astype(np.float32), (m, k)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("cfg", [dict(), dict(reorder_cols=True),
                                 dict(alpha=1.0)])
def test_sddmm_gradients_match_jax(batched, cfg):
    rng = np.random.RandomState(6)
    rows, cols, vals, shape = _dup_coo(rng)
    m, k = shape
    lead = (2,) if batched else ()
    x = rng.randn(*lead, m, 12).astype(np.float32)
    y = rng.randn(*lead, 12, k).astype(np.float32)
    g = rng.randn(*lead, rows.size).astype(np.float32)
    ja = jsp.from_coo(rows, cols, vals, shape, impl="xla", **cfg)
    A = sp.from_coo(rows, cols, vals, shape, device="cpu", **cfg)
    xt, yt = (torch.from_numpy(t).requires_grad_(True) for t in (x, y))
    out = sp.sddmm(A, xt, yt)
    _close(out, np.asarray(jsp.sddmm(ja, jnp.asarray(x), jnp.asarray(y))))
    (out * torch.from_numpy(g)).sum().backward()
    jdx, jdy = jax.grad(
        lambda xx, yy: jnp.sum(jsp.sddmm(ja, xx, yy) * jnp.asarray(g)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    _close(xt.grad, np.asarray(jdx))
    _close(yt.grad, np.asarray(jdy))


def test_sddmm_gradient_in_one_operand_only():
    rng = np.random.RandomState(7)
    rows, cols, vals, shape = _dup_coo(rng)
    A = sp.from_coo(rows, cols, vals, shape, device="cpu")
    x = torch.from_numpy(rng.randn(shape[0], 5).astype(np.float32))
    y = torch.from_numpy(rng.randn(5, shape[1]).astype(np.float32))
    y.requires_grad_(True)
    sp.sddmm(A, x, y).sum().backward()
    s = np.zeros(shape)
    np.add.at(s, (rows, cols), 1.0)
    _close(y.grad, (s.T @ x.numpy().astype(np.float64)).T)
    assert x.grad is None


# --- GCN ----------------------------------------------------------------------


def test_gcn_sgd_step_matches_jax():
    """One SGD step of the two-layer SparseGraphConv GCN on carried
    weights: the loss, both gradients and both updated weights."""
    rows, cols, vals, feats, labels, n_classes = gcn_training.make_graph(
        n=512, avg_deg=8)
    n = feats.shape[0]
    rng = np.random.RandomState(8)
    w1 = (rng.randn(feats.shape[1], 32) * 0.1).astype(np.float32)
    w2 = (rng.randn(32, n_classes) * 0.1).astype(np.float32)
    lr = 2.0
    ja = jsp.from_coo(rows, cols, vals, (n, n), impl="xla")
    x, y = jnp.asarray(feats), jnp.asarray(labels)

    def jloss(p):
        h = jax.nn.relu(JaxConv(ja, p["w1"])(x))
        logp = jax.nn.log_softmax(JaxConv(ja, p["w2"])(h))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

    params = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}
    jl, jg = jax.value_and_grad(jloss)(params)

    A = sp.from_coo(rows, cols, vals, (n, n), device="cpu")
    model = gcn_training.GCN(A, torch.zeros(1), torch.zeros(1))
    model.conv1 = graph_conv_from_arrays(A, w1)
    model.conv2 = graph_conv_from_arrays(A, w2)
    loss = gcn_training.sgd_step(model, torch.from_numpy(feats),
                                 torch.from_numpy(labels).long(), lr)
    _close(loss, np.asarray(jl))
    _close(model.conv1.w.grad, np.asarray(jg["w1"]))
    _close(model.conv2.w.grad, np.asarray(jg["w2"]))
    _close(model.conv1.w, np.asarray(params["w1"] - lr * jg["w1"]))
    _close(model.conv2.w, np.asarray(params["w2"] - lr * jg["w2"]))


def test_make_graph_defaults_match_reference():
    want = _reference_example().make_graph()
    got = gcn_training.make_graph()
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_make_graph_symmetric_is_symmetric():
    rows, cols, vals, feats, labels, nc = gcn_training.make_graph(
        n=600, avg_deg=4, n_classes=6, n_features=20, symmetric=True)
    dense = np.zeros((600, 600))
    dense[rows, cols] = vals
    assert np.array_equal(dense, dense.T)
    assert feats.shape == (600, 20) and nc == 6 and labels.max() == 5
    assert np.all(dense[np.arange(600), np.arange(600)] > 0)  # self-loops


def test_gcn_training_example_runs_on_the_cpu():
    loss, acc = gcn_training.main("cpu", epochs=100)
    assert acc > 0.9 and np.isfinite(loss)


# --- the SDDMM fringe walk ----------------------------------------------------


@pytest.mark.parametrize("reorder_cols", [False, True])
def test_fringe_walk_matches_numpy(reorder_cols):
    """Row order (stable), positions and Y^T rows of the walk, on a
    shuffled COO: entries of a row keep their input order, each reads the
    permuted panel's row that holds its column."""
    rng = np.random.RandomState(9)
    rows, cols, vals, shape = _dup_coo(rng)
    A = sp.from_coo(rows, cols, vals, shape, device="cpu",
                    reorder_cols=reorder_cols, alpha=0.3)
    plan = A.plan
    smaps = plan_ir.build_sddmm_maps(plan)
    fringe = np.flatnonzero(plan.update_maps.core_lin < 0)
    assert plan.has_core and fringe.size
    order = np.argsort(rows[fringe], kind="stable")
    want_pos = fringe[order]
    walk = smaps.walk
    assert np.array_equal(walk.pos.numpy(), want_pos)
    want_ptr = np.zeros(shape[0] + 1, np.int64)
    want_ptr[1:] = np.cumsum(np.bincount(rows[fringe], minlength=shape[0]))
    assert np.array_equal(walk.indptr.numpy(), want_ptr)
    perm = plan.col_perm.numpy()
    panel = perm if reorder_cols else np.arange(shape[1])
    assert np.array_equal(panel[walk.cols.numpy()], cols[want_pos])
    assert walk.indptr.dtype == walk.cols.dtype == walk.pos.dtype == \
        torch.int32


@pytest.mark.parametrize("cfg", [dict(), dict(reorder_cols=True),
                                 dict(alpha=1.0)])
def test_execute_sddmm_on_shuffled_coo_matches_reference(cfg):
    rng = np.random.RandomState(10)
    rows, cols, vals, shape = _dup_coo(rng)
    x = rng.randn(shape[0], 7).astype(np.float32)
    y = rng.randn(7, shape[1]).astype(np.float32)
    ja = jsp.from_coo(rows, cols, vals, shape, impl="xla", **cfg)
    A = sp.from_coo(rows, cols, vals, shape, device="cpu", **cfg)
    got = sp.sddmm(A, x, y)
    _close(got, np.asarray(jsp.sddmm(ja, jnp.asarray(x), jnp.asarray(y))),
           tol=1e-5)
    _close(got, (x.astype(np.float64) @ y)[rows, cols], tol=1e-5)
