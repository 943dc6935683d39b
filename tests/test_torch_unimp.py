"""UniMP's graph transformer on the port, and the value update it rides on.

- The port's ``models.UniMP`` (batched heads, the last layer's mean over
  heads, the root weight and the gate, LayerNorm, the label embedding)
  against the plain reference ``nsbench/reference_unimp.py`` (float64,
  imports nothing of the port) on seeded weights, on a small Chung-Lu
  graph with self-loops and one duplicate COO entry.  Tolerance: the
  logits within 1e-5 of the reference's norm, and every entry within
  1e-4 * max(1, max|ref|): fp32 sums of a few hundred terms a row through
  three layers and two LayerNorms lose about 1e-7 of the norm here; TF32
  operands lose 1e-4 (the benchmark's control), so the first bound would
  catch that.
- ``sparse.SparseMatrix.with_values`` writes the leaves on the device
  (``core.values.set_values``): bit-equal to a fresh ``prepare`` of the
  same values on the tile stream and the fringe, with tile cells of two
  and three contributors and signed zeros, and the input plan left as it
  was (the k-bucketed stream, which only a plan carried from the JAX
  package holds off the card, in ``tests/test_torch_dynamic.py``).
- ``SparseGraphAttention`` is the one-head case of the new layer.

On the card (``gpu``): the layer and the value update against the CPU.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.sparse as sp
from repro_torch.core import spmm
from repro_torch.core.plan_ir import SpmmConfig
from repro_torch.core.values import set_values, update_values
from repro_torch.models import (
    GraphTransformerConv, SparseGraphAttention, UniMP,
)
from conftest import make_sparse

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from nsbench import reference_unimp  # noqa: E402
from nsbench.harness import load_module  # noqa: E402

VALUE_LEAVES = ("flat_values", "fringe_vals", "fringe_kb_vals")


def _graph(n=400, nonzeros=9000, seed=5):
    """A Chung-Lu graph with self-loops (the benchmark's generator at a
    small size), one COO entry repeated, values normalised."""
    gen = load_module(ROOT / "nsbench" / "generators" / "chung_lu_gcn.py")
    rows, cols, vals, shape, _ = gen.build(
        {"n": n, "nonzeros": nonzeros, "avg_degree": nonzeros / n,
         "skew": 1.05, "seed": seed, "classes": 7}, torch.device("cpu"))
    rows = np.concatenate([rows, rows[7:8]])
    cols = np.concatenate([cols, cols[7:8]])
    vals = np.concatenate([vals, vals[7:8]])
    return rows, cols, vals, shape


def _reference_weights(model: UniMP) -> dict:
    layers = [{"weight": c.weight.detach(), "bias": c.bias.detach(),
               "w_beta": c.w_beta.detach(), "heads": c.heads,
               "concat": c.concat, "root": c.root} for c in model.convs]
    return {"emb": model.label_emb.weight.detach(), "layers": layers,
            "norms": [(nm.weight.detach(), nm.bias.detach())
                      for nm in model.norms]}


def _close(got, want, tol=1e-4):
    got, want = got.detach().double(), want.double()
    assert float((got - want).norm() / want.norm()) <= 1e-5
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


def test_unimp_matches_plain_reference():
    rows, cols, vals, shape = _graph()
    n = shape[0]
    a = sp.from_coo(rows, cols, vals, shape, device="cpu")
    assert a.plan.has_core and a.plan.has_fringe
    gen = torch.Generator().manual_seed(3)
    model = UniMP.init(a, 24, 32, 7, 3, 4, generator=gen).eval()
    assert [c.concat for c in model.convs] == [True, True, False]
    assert [c.out_dim for c in model.convs] == [32, 32, 7]
    x = torch.randn((n, 24), generator=gen)
    labels = torch.randint(0, 7, (n,), generator=gen)
    known = torch.arange(0, n, 3)
    with torch.no_grad():
        got = model(x, labels, known)
        alpha = model.convs[0].edge_scores(
            x.index_add(0, known, model.label_emb(labels[known])))
    graph = reference_unimp.Graph(rows, cols, n)
    want, alpha_ref = reference_unimp.forward(
        graph, x, labels, known, _reference_weights(model), want_alpha=True)
    assert got.shape == (n, 7) and alpha.shape == (4, rows.size)
    _close(got, want)
    _close(alpha, alpha_ref)
    # the graph's values are left as they were
    assert np.array_equal(a.val, vals)


def test_unimp_layer_without_gate_adds_the_root():
    rows, cols, vals, shape = _graph(n=200, nonzeros=3000)
    a = sp.from_coo(rows, cols, vals, shape, device="cpu")
    gen = torch.Generator().manual_seed(4)
    gated = GraphTransformerConv.init(a, 12, 5, 2, generator=gen)
    plain = GraphTransformerConv(a, gated.weight, gated.bias, heads=2,
                                 root=10)
    x = torch.randn((shape[0], 12), generator=gen)
    with torch.no_grad():
        z = plain.project(x)
        alpha = plain.attention(z)
        v = plain._heads(z, 2)
        want = torch.cat([torch.from_numpy(
            a.with_values(alpha[h]).dense()).float() @ v[h]
            for h in range(2)], 1) + z[:, 30:]
        _close(plain(x), want)
    # the layer owns its weights: no storage shared with the caller's
    assert plain.weight.data_ptr() != gated.weight.data_ptr()


def test_sparse_graph_attention_is_the_one_head_case():
    rows, cols, vals, shape = _graph(n=200, nonzeros=3000)
    a = sp.from_coo(rows, cols, vals, shape, device="cpu")
    gen = torch.Generator().manual_seed(0)
    layer = SparseGraphAttention.init(a, 12, 6, generator=gen)
    assert isinstance(layer, GraphTransformerConv)
    assert layer.heads == 1 and not layer.root and layer.w_beta is None
    assert not any(p.requires_grad for p in layer.parameters())
    x = torch.randn((shape[0], 12), generator=gen)
    want, _ = reference_unimp.Graph(rows, cols, shape[0]).attend(
        x @ layer.wq, x @ layer.wk, x @ layer.wv)
    _close(layer(x), want)
    assert layer.edge_scores(x).shape == (rows.size,)


# --- the value update on the device -----------------------------------------


def _bits(t) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_value_leaves_bit_equal(got, want):
    for name in VALUE_LEAVES:
        assert np.array_equal(_bits(getattr(got, name)),
                              _bits(getattr(want, name))), name
    assert int(got.a_unsplittable) == int(want.a_unsplittable)
    assert got.signature() == want.signature()


def _duplicated(seed):
    """A matrix with dense rows (tiles) and a fringe, some nonzeros repeated
    twice and three times, and signed zeros among the values."""
    rng = np.random.RandomState(seed)
    _, rows, cols, vals = make_sparse(rng, 300, 260, 0.02, n_dense_rows=10)
    dup = rng.choice(rows.size, 200, replace=False)
    rows = np.concatenate([rows, rows[dup], rows[dup[:40]]])
    cols = np.concatenate([cols, cols[dup], cols[dup[:40]]])
    vals = np.concatenate([vals, vals[dup] * 1e4, vals[dup[:40]] * -3e-4])
    return rows, cols, vals, rng


@pytest.mark.parametrize("as_tensor", [False, True])
def test_with_values_on_the_device_is_a_fresh_prepare(as_tensor):
    rows, cols, vals, rng = _duplicated(12)
    cfg = SpmmConfig(impl="torch")
    plan = spmm.prepare(rows, cols, vals, (300, 260), cfg)
    assert plan.has_core and plan.has_fringe
    # cells of the tile stream with two and three contributors
    lin = plan.update_maps.core_lin_sorted
    counts = np.unique(lin, return_counts=True)[1]
    assert counts.max() >= 3
    before = {n: getattr(plan, n).clone() for n in VALUE_LEAVES}
    new = (rng.randn(rows.size) * 1e3).astype(np.float32)
    new[::17] = -0.0
    a = sp.SparseMatrix(plan)
    updated = a.with_values(torch.from_numpy(new) if as_tensor else new).plan
    fresh = spmm.prepare(rows, cols, new, (300, 260), cfg)
    _assert_value_leaves_bit_equal(updated, fresh)
    assert updated.derived is plan.derived
    # the new values stay on the plan's device, and read back whole
    assert updated.update_maps.vals.device == plan.device
    assert np.array_equal(_bits(updated.update_maps.host_values()),
                          _bits(new))
    # the input plan is left as it was
    for n in VALUE_LEAVES:
        assert torch.equal(getattr(plan, n), before[n]), n
    assert np.array_equal(plan.update_maps.vals, vals)
    # and an update of some values after it merges into the new ones
    idx = rng.choice(rows.size, 50, replace=False)
    upd = rng.randn(50)
    more = update_values(updated, idx, upd)
    new2 = new.copy()
    new2[idx] = upd.astype(np.float32)
    _assert_value_leaves_bit_equal(
        more, spmm.prepare(rows, cols, new2, (300, 260), cfg))


@pytest.mark.parametrize("which", ["multi-contributor-cells", "fringe",
                                   "repeated-index"])
def test_update_values_of_a_few_nonzeros_is_a_fresh_prepare(which):
    rows, cols, vals, rng = _duplicated(21)
    cfg = SpmmConfig(impl="torch")
    plan = spmm.prepare(rows, cols, vals, (300, 260), cfg)
    maps = plan.update_maps
    lin = maps.core_lin_sorted
    if which == "fringe":
        idx = np.flatnonzero(maps.core_lin < 0)[:5]
    else:
        # a member of each of the first cells with three contributors
        cells, counts = np.unique(lin, return_counts=True)
        shared = np.isin(lin, cells[counts >= 3][:4])
        idx = maps.core_members_sorted[shared][::3]
    upd = rng.randn(idx.size)
    if which == "repeated-index":
        # the last value of a repeated index holds
        idx = np.concatenate([idx, idx[:2]])
        upd = np.concatenate([upd, [7.5, -0.0]])
    before = {n: getattr(plan, n).clone() for n in VALUE_LEAVES}
    got = update_values(plan, idx, upd)
    want_vals = vals.copy()
    want_vals[idx] = upd.astype(vals.dtype)
    _assert_value_leaves_bit_equal(
        got, spmm.prepare(rows, cols, want_vals, (300, 260), cfg))
    assert np.array_equal(got.update_maps.host_values(), want_vals)
    # only the touched slots were found: no layout of the whole structure
    assert "value_slots" not in plan.derived
    for n in VALUE_LEAVES:
        assert torch.equal(getattr(plan, n), before[n]), n


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_with_values_on_the_card_is_a_fresh_prepare(cuda):
    rows, cols, vals, rng = _duplicated(3)
    plan = spmm.prepare(rows, cols, vals, (300, 260),
                        SpmmConfig(impl="cuda", alpha=0.006), device=cuda)
    new = (rng.randn(rows.size) * 1e3).astype(np.float32)
    new[::13] = -0.0
    got = set_values(plan, torch.from_numpy(new).to(cuda))
    want = spmm.prepare(rows, cols, new, (300, 260),
                        SpmmConfig(impl="cuda", alpha=0.006), device=cuda)
    for name in VALUE_LEAVES:
        assert np.array_equal(_bits(getattr(got, name).cpu()),
                              _bits(getattr(want, name).cpu())), name


@pytest.mark.gpu
def test_unimp_on_the_card_matches_the_cpu(cuda):
    rows, cols, vals, shape = _graph(n=3000, nonzeros=120000)
    n = shape[0]
    a_cpu = sp.from_coo(rows, cols, vals, shape, device="cpu")
    a_gpu = sp.from_coo(rows, cols, vals, shape, device=cuda)
    gen = torch.Generator().manual_seed(2)
    model = UniMP.init(a_cpu, 24, 256, 41, 3, 4, generator=gen).eval()
    x = torch.randn((n, 24), generator=gen)
    labels = torch.randint(0, 41, (n,), generator=gen)
    known = torch.arange(0, n, 2)
    with torch.no_grad():
        want = model(x, labels, known)
        model_gpu = UniMP.init(a_gpu, 24, 256, 41, 3, 4).eval()
        model_gpu.load_state_dict(model.state_dict())
        got = model_gpu(x.to(cuda), labels.to(cuda), known.to(cuda))
    _close(got.cpu(), want)
