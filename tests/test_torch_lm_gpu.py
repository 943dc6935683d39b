"""The LM stack on the card, at a small size: ``chip_smoke.py`` phase 11's
checks 2-4.

Marked ``gpu``: they need a CUDA device and skip without one.  Run them on
a machine with a card::

    python -m pytest -m gpu tests/test_torch_lm_gpu.py

This file imports only the port (the machine with the card has no JAX).
Tolerance: max |x - ref| <= 1e-4 * max(1, max |ref|), fp32 compute on both
sides, TF32 off.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import layers, model
from repro_torch.serve import ServeConfig, ServeEngine

pytestmark = pytest.mark.gpu

TOL = 1e-4
FAMILIES = ["qwen1.5-4b", "granite-moe-3b-a800m", "gemma2-9b", "mamba2-1.3b",
            "zamba2-1.2b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    """Entries of magnitude 1e29 and more are the head's -1e30 masks of
    padded vocab columns: equal, and out of the scale."""
    got, want = got.float(), want.float().to(got.device)
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    real = want.abs() < 1e29
    assert torch.equal(got[~real], want[~real])
    err = (got - want)[real].abs().max().item()
    assert err <= TOL * max(1.0, want[real].abs().max().item()), err


def _fp32(name, which="smoke"):
    cfg = dataclasses.replace(getattr(get_arch(name), which),
                              compute_dtype=torch.float32)
    if cfg.moe_num_experts:  # no capacity drops, as the reference's test
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    return cfg


def _tokens(cfg, batch, seq, device):
    return torch.from_numpy(pipeline.make_batch(pipeline.DataConfig(
        global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size),
        0)["tokens"]).to(device)


def _plain(q, k, v, q_offset):
    d = q.shape[-1]
    groups = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    qp = q_offset + torch.arange(q.shape[1], device=q.device)
    kp = torch.arange(k.shape[1], device=q.device)
    logits = logits.masked_fill(kp[None, :] > qp[:, None], -float("inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
def test_blockwise_attention_against_plain_softmax(cuda, kv):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, s, h, d, chunk, s_cache = 2, 100, 4, 32, 64, 120
    q = torch.randn((b, s, h, d), generator=g, device=cuda)
    k = torch.randn((b, s_cache, kv, d), generator=g, device=cuda)
    v = torch.randn((b, s_cache, kv, d), generator=g, device=cuda)
    got = layers.blockwise_attention(q, k[:, :s], v[:, :s], causal=True,
                                     kv_chunk=chunk)
    _close(got, _plain(q, k[:, :s], v[:, :s], 0))
    kv_len = 70  # one query; kv_len short of the cache, across chunks
    got = layers.blockwise_attention(q[:, -1:], k, v, causal=True,
                                     q_offset=kv_len - 1, kv_chunk=chunk,
                                     kv_len=kv_len)
    _close(got, _plain(q[:, -1:], k[:, :kv_len], v[:, :kv_len], kv_len - 1))


@pytest.mark.parametrize("name", ["qwen1.5-4b", "granite-moe-3b-a800m"])
def test_decode_against_forward_teacher_forced(cuda, name):
    cfg = _fp32(name)
    params = model.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    n_pre, n_dec = 12, 5
    seq = _tokens(cfg, 2, n_pre + n_dec, cuda)
    ref, _ = model.forward(params, {"tokens": seq}, cfg)
    cache = model.init_cache(cfg, 2, n_pre + n_dec + 8, device=cuda)
    lp, cache = model.prefill(params, {"tokens": seq[:, :n_pre]}, cfg, cache)
    _close(lp, ref[:, n_pre - 1])
    for i in range(n_dec - 1):
        ld, cache = model.decode_step(params, seq[:, n_pre + i:n_pre + i + 1],
                                      cache, n_pre + i, cfg)
        _close(ld, ref[:, n_pre + i])
    # greedy generate equals greedy over forward
    eng = ServeEngine(cfg, params, ServeConfig(batch_size=2, max_len=32),
                      device=cuda)
    toks, _ = eng.generate(seq[:, :8], 5)
    cur = seq[:, :8]
    for i in range(5):
        logits, _ = model.forward(params, {"tokens": cur}, cfg)
        nxt = torch.argmax(logits[:, -1], -1)
        assert torch.equal(nxt.to(torch.int32), toks[:, i])
        cur = torch.cat([cur, nxt[:, None]], dim=1)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.cpu().numpy()


@pytest.mark.parametrize("name", FAMILIES)
def test_family_on_the_card_against_the_cpu(cuda, name):
    cfg = _fp32(name)
    tree = _numpy_tree(model.init_params(
        cfg, torch.Generator().manual_seed(1), "cpu"))
    tokens = _tokens(cfg, 2, 20, "cpu")
    out = {}
    for where in ("cpu", cuda):
        p = lm_params_from_arrays(tree, cfg, device=where)
        t = tokens.to(where)
        fl, _ = model.forward(p, {"tokens": t}, cfg)
        cache = model.init_cache(cfg, 2, 32, device=where)
        lp, cache = model.prefill(p, {"tokens": t}, cfg, cache)
        tok, steps = torch.argmax(lp, -1)[:, None], []
        for i in range(3):
            ld, cache = model.decode_step(p, tok, cache, 20 + i, cfg)
            steps.append(ld)
            tok = torch.argmax(ld, -1)[:, None]
        out[str(where)] = [fl, lp] + steps
    for got, want in zip(out[str(cuda)], out["cpu"]):
        _close(got, want)
    assert np.isfinite(out["cpu"][0].numpy()).all()
