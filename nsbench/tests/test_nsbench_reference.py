"""The plain reference: its SpMM against dense float64, its GCN gradients
against autograd, the TF32 rounding bit by bit, and the comparison run
against the program's plain (``impl="torch"``) plan on a small graph."""
import numpy as np
import pytest
import torch

from nsbench import graphs, reference


def _random_coo(m, k, deg, seed):
    """A directed graph with row degrees from 1 to 2·deg, no repeats."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(m), rng.randint(1, 2 * deg, m))
    key = graphs.sorted_unique(rows * k + rng.randint(0, k, rows.size))
    return (key // k, key % k,
            rng.randn(key.size).astype(np.float32))


def _dense(rows, cols, vals, shape):
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals.astype(np.float64))
    return a


def _tf32_by_hand(x: np.ndarray) -> np.ndarray:
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    lsb = (u >> 13) & 1
    u = ((u + 0xFFF + lsb) & ~np.uint64(0x1FFF)) & np.uint64(0xFFFFFFFF)
    return u.astype(np.uint32).view(np.float32)


def test_to_tf32_rounds_to_nearest_even():
    x = np.array([1.0, 1 + 2 ** -12, 1 + 3 * 2 ** -12, 1 + 2 ** -11,
                  1 + 3 * 2 ** -11, -1 - 3 * 2 ** -12, 3.3e-20, 0.0],
                 np.float32)
    got = reference.to_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _tf32_by_hand(x))
    # 1 + 2^-11 is a tie and goes to the even neighbour 1; 1 + 3*2^-11 to
    # 1 + 2^-9
    assert got[3] == 1.0 and got[4] == np.float32(1 + 2 ** -9)
    r = np.random.RandomState(0).randn(10000).astype(np.float32)
    got = reference.to_tf32(torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(got, _tf32_by_hand(r))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    assert np.abs(got / r - 1).max() <= 2.0 ** -11


def test_spmm_equals_dense_float64():
    rows, cols, vals = _random_coo(700, 500, 30, 4)
    shuffle = np.random.RandomState(1).permutation(rows.size)
    op = reference.CooOperator(rows[shuffle], cols[shuffle], vals[shuffle],
                               (700, 500))
    b = torch.randn(500, 24, generator=torch.Generator().manual_seed(0))
    want = _dense(rows, cols, vals, (700, 500)) @ b.double().numpy()
    np.testing.assert_allclose(op.matmul(b).numpy(), want, rtol=1e-12,
                               atol=1e-12)
    at = op.transpose()
    np.testing.assert_allclose(
        at.matmul(b[:, :7].new_ones(700, 7)).numpy(),
        _dense(rows, cols, vals, (700, 500)).T @ np.ones((700, 7)),
        rtol=1e-12, atol=1e-12)


def test_program_plain_plan_within_float32_and_control_above():
    import repro_torch.sparse as sp

    rows, cols, vals = _random_coo(1500, 1500, 40, 10)
    a = sp.from_coo(rows, cols, vals, (1500, 1500), device="cpu")
    b = torch.randn(1500, 64, generator=torch.Generator().manual_seed(3))
    c = sp.spmm(a, b)
    op = reference.CooOperator(rows, cols, vals, (1500, 1500))
    (err,), ctl = reference.componentwise_errors(op, b, [c],
                                                 tf32_control=True)
    assert err < 1e-5
    assert ctl > 30 * err
    # one wrong entry is an error of order one
    bad = c.clone()
    bad[7, 3] += 1.0
    (err_bad,), _ = reference.componentwise_errors(op, b, [bad])
    assert err_bad > 1e-2


def _ogb_inputs(n=300, d_in=12, hidden=16, classes=5, layers=3):
    rows, cols, vals, labels = graphs.sbm_structure(n, 4.0, classes, 0,
                                                    symmetric=False)
    a = reference.CooOperator(rows, cols, vals, (n, n))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, d_in, generator=gen)
    d = [d_in] + [hidden] * (layers - 1) + [classes]
    leaves = []
    for i, (p, q) in enumerate(zip(d, d[1:])):
        leaves += [torch.randn(p, q, generator=gen) * 0.3,
                   torch.randn(q, generator=gen) * 0.1]
        if i < layers - 1:
            leaves += [1 + 0.1 * torch.randn(q, generator=gen),
                       0.1 * torch.randn(q, generator=gen)]
    y = torch.from_numpy(labels).long()
    train = torch.arange(0, n, 2)
    return a, _dense(rows, cols, vals, (n, n)), x, y, train, leaves


def _dense_ogb_steps(ad, x, y, train, leaves, masks, lr, steps):
    """OGB's GCN on the dense matrix in float64 by autograd and
    ``torch.optim.Adam``: what the reference has to equal."""
    ad = torch.from_numpy(ad)
    p = [t.double().clone().requires_grad_() for t in leaves]
    opt = torch.optim.Adam(p, lr=lr)
    losses, grads = [], None
    for step in range(steps):
        h, i = x.double(), 0
        for layer in range(len(masks[step]) + 1):
            h = ad @ (h @ p[i]) + p[i + 1]
            i += 2
            if layer < len(masks[step]):
                mu = h.mean(0)
                var = ((h - mu) ** 2).mean(0)
                h = (h - mu) / torch.sqrt(var + 1e-5) * p[i] + p[i + 1]
                h = torch.relu(h) * masks[step][layer].double()
                i += 2
        out = torch.log_softmax(h, 1)
        loss = -out[train, y[train]].mean()
        opt.zero_grad()
        loss.backward()
        losses.append(float(loss.detach()))
        if grads is None:
            grads = [t.grad.clone() for t in p]
        opt.step()
    return losses, grads, [t.detach() for t in p]


def test_gcn_steps_equal_dense_autograd():
    a, ad, x, y, train, leaves = _ogb_inputs()
    out = reference.gcn_steps(a, a.transpose(), x, y, train, leaves, 7, 0.5,
                              0.01, 3)
    gen = torch.Generator().manual_seed(7)
    masks = [reference.dropout_masks(gen, 2, 300, 16, 0.5, "cpu")
             for _ in range(3)]
    losses, grads, last = _dense_ogb_steps(ad, x, y, train, leaves, masks,
                                           0.01, 3)
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-12)
    assert out["losses"][2] < out["losses"][0]
    for got, want in zip(out["grads"], grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                                   atol=1e-14)
    # a bias ahead of a batch norm has a gradient of round-off alone,
    # which Adam turns into steps of ±lr either way: left out
    norms = [float(g.norm()) for g in grads]
    live = [i for i, v in enumerate(norms) if v >= 1e-3 * np.median(norms)]
    assert live == [0, 2, 3, 4, 6, 7, 8, 9]
    for i in live:
        np.testing.assert_allclose(out["weights"][-1][i].numpy(),
                                   last[i].numpy(), rtol=1e-9, atol=1e-12)
    assert out["out"].shape == (300, 5)


def test_dropout_masks_keep_about_half_and_scale():
    m = reference.dropout_masks(torch.Generator().manual_seed(1), 2, 1000,
                                64, 0.5, "cpu")
    assert m.shape == (2, 1000, 64) and m.dtype == torch.float32
    assert set(m.unique().tolist()) == {0.0, 2.0}
    assert abs(float((m > 0).float().mean()) - 0.5) < 0.01


def test_tf32_gcn_steps_depart_from_float64():
    a, _, x, y, train, leaves = _ogb_inputs()
    ref = reference.gcn_steps(a, a.transpose(), x, y, train, leaves, 7, 0.5,
                              0.01, 2)
    low = reference.gcn_steps(a, a.transpose(), x, y, train, leaves, 7, 0.5,
                              0.01, 2, tf32=True)
    gap = abs(low["losses"][0] - ref["losses"][0]) / ref["losses"][0]
    assert 1e-7 < gap < 1e-2
