"""repro_torch graph layers and examples against the JAX package, on the CPU.

``SparseGraphConv`` and ``SparseGraphAttention`` get the JAX layers'
weights (``interop.graph_conv_from_arrays`` / ``graph_attention_from_arrays``)
and the same graph, prepared by the port or carried over from the JAX plan;
features come from a numpy seed.  Tolerance: max |diff| <= 1e-4 *
max(1, max |ref|) for the layers' outputs (after the softmax, fp32 on both
sides), and 1e-5 for the raw SDDMM scores.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.sparse as jsp  # noqa: E402
from repro.models.layers import (  # noqa: E402
    SparseGraphAttention as JaxAttention, SparseGraphConv as JaxConv,
)
import repro_torch.sparse as sp  # noqa: E402
from repro_torch.core import plan_ir  # noqa: E402
from repro_torch.core.plan_ir import LEAF_NAMES, SpmmConfig  # noqa: E402
from repro_torch.examples import gat_attention, quickstart  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    graph_attention_from_arrays, graph_conv_from_arrays, plan_from_arrays,
    update_maps_from_arrays,
)
from repro_torch.models import SparseGraphAttention, SparseGraphConv  # noqa: E402

TOL = 1e-4
_PORT_FIELDS = {f.name for f in dataclasses.fields(SpmmConfig)}
_MAP_FIELDS = [f.name for f in dataclasses.fields(plan_ir.UpdateMaps)]


def _close(got, want, tol=TOL):
    got = (got.detach().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got))
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _carried(jplan):
    leaves, _ = jplan.tree_flatten()
    cfg = {k: v for k, v in dataclasses.asdict(jplan.config).items()
           if k in _PORT_FIELDS}
    cfg["impl"] = "torch"
    return sp.from_plan(plan_from_arrays(
        {n: np.asarray(x) for n, x in zip(LEAF_NAMES, leaves)},
        dict(shape=jplan.shape, config=cfg, stats=jplan.stats,
             fringe_tier=jplan.fringe_tier, fringe_bk=jplan.fringe_bk,
             update_maps=update_maps_from_arrays(
                 {n: getattr(jplan.update_maps, n) for n in _MAP_FIELDS}))))


@pytest.fixture(scope="module")
def graph():
    rows, cols, vals, feats, _, _ = gat_attention.make_graph(n=1024,
                                                            avg_deg=10)
    n = feats.shape[0]
    ja = jsp.from_coo(rows, cols, vals, (n, n), impl="xla")
    ours = sp.from_coo(rows, cols, vals, (n, n), device="cpu")
    assert ours.plan.has_core and ours.plan.has_fringe
    return ja, ours, _carried(ja.plan), feats


def _weights(d_in, d_out, count, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(d_in, d_out) / np.sqrt(d_in)).astype(np.float32)
            for _ in range(count)]


@pytest.mark.parametrize("which", ["port", "carried"])
def test_graph_conv_matches_reference(graph, which):
    ja, ours, carried, feats = graph
    (w,) = _weights(feats.shape[1], 24, 1, 0)
    want = np.asarray(JaxConv(ja, jnp.asarray(w))(jnp.asarray(feats)))
    layer = graph_conv_from_arrays(ours if which == "port" else carried, w)
    assert isinstance(layer, SparseGraphConv)
    _close(layer(torch.from_numpy(feats)), want)


@pytest.mark.parametrize("which", ["port", "carried"])
@pytest.mark.parametrize("d_head", [8, 32])
def test_graph_attention_matches_reference(graph, which, d_head):
    ja, ours, carried, feats = graph
    wq, wk, wv = _weights(feats.shape[1], d_head, 3, d_head)
    jlayer = JaxAttention(ja, *map(jnp.asarray, (wq, wk, wv)))
    layer = graph_attention_from_arrays(
        ours if which == "port" else carried, wq, wk, wv)
    assert isinstance(layer, SparseGraphAttention)
    x = torch.from_numpy(feats)
    _close(layer.edge_scores(x), np.asarray(jlayer.edge_scores(
        jnp.asarray(feats))), tol=1e-5)
    _close(layer(x), np.asarray(jlayer(jnp.asarray(feats))))
    # the forward leaves the layer's graph as it was
    assert np.array_equal(layer.a.val, ja.val)


def test_graph_attention_matches_dense_softmax(graph):
    _, ours, _, feats = graph
    n, d = feats.shape
    gen = torch.Generator().manual_seed(0)
    layer = SparseGraphAttention.init(ours, d, 16, generator=gen)
    assert layer.wq.shape == (d, 16) and layer.wv.dtype == torch.float32
    x = torch.from_numpy(feats)
    out = layer(x).numpy()
    q = (x @ layer.wq).double().numpy()
    k = (x @ layer.wk).double().numpy()
    v = (x @ layer.wv).double().numpy()
    scores = q @ k.T / np.sqrt(16)
    mask = np.zeros((n, n), bool)
    mask[ours.row, ours.col] = True
    scores[~mask] = -np.inf
    att = np.exp(scores - scores.max(1, keepdims=True))
    att /= att.sum(1, keepdims=True)
    _close(out, att @ v)


def test_graph_conv_init_and_dense_product(graph):
    _, ours, _, feats = graph
    gen = torch.Generator().manual_seed(1)
    layer = SparseGraphConv.init(ours, feats.shape[1], 12, generator=gen)
    x = torch.from_numpy(feats)
    want = ours.dense() @ (x @ layer.w).detach().double().numpy()
    _close(layer(x), want)
    # the weight trains: a parameter, under the state_dict key "w"
    assert dict(layer.named_parameters()).keys() == {"w"}
    assert layer.state_dict().keys() == {"w"}


def test_gat_example_runs_on_the_cpu():
    assert gat_attention.main("cpu") < 1e-4


def test_quickstart_example_runs_on_the_cpu():
    assert quickstart.main("cpu") < 1e-3
