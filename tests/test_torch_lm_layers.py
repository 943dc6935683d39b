"""The port's LM layers (``repro_torch.models.layers``, ``moe``, ``ssm``)
against the JAX package's, on the CPU.

Params come from the reference's ``init_*`` and are copied over; inputs
come from a numpy seed.  Tolerances (``tests/_torch_lm.py``): fp32 within
1e-4 * max(1, max |ref|), bf16 within 5e-2 * max(1, max |ref|).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import close, close_bf16, to_torch  # noqa: E402
from repro.models import layers as jl, moe as jmoe, ssm as jssm  # noqa: E402
from repro_torch.models import layers as pl, moe as pmoe, ssm as pssm  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a tensor of ``dtype``."""
    j = jnp.asarray(a).astype(JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def _check(dtype):
    return close if dtype == "float32" else close_bf16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.RandomState(0)
    jx, tx = _pair(rng.randn(2, 5, 32) * 3, dtype)
    scale = rng.randn(32).astype(np.float32)
    want = jl.rms_norm({"scale": jnp.asarray(scale)}, jx, 1e-5)
    got = pl.rms_norm({"scale": torch.from_numpy(scale)}, tx, 1e-5)
    assert got.dtype == TDT[dtype]
    _check(dtype)(got, want)


@pytest.mark.parametrize("pos_2d", [False, True])
def test_apply_rope_split_halves(pos_2d):
    rng = np.random.RandomState(1)
    jx, tx = _pair(rng.randn(2, 7, 3, 16))
    pos = np.arange(7) + 11
    if pos_2d:
        pos = np.stack([pos, pos * 2])
    want = jl.apply_rope(jx, jnp.asarray(pos), 10000.0)
    got = pl.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    close(got, want)
    # position 0 is the identity; the rotation pairs d with d + D/2
    z = pl.apply_rope(tx[:, :1], torch.zeros(1, dtype=torch.int64), 1e4)
    assert torch.equal(z, tx[:, :1])


# (label, B, Sq, Sk, H, KV, D, kwargs)
ATTN_CASES = [
    ("gqa", 2, 24, 24, 4, 2, 16, dict(causal=True, kv_chunk=64)),
    ("mqa", 2, 24, 24, 4, 1, 16, dict(causal=True, kv_chunk=64)),
    ("chunks_padded", 2, 40, 40, 4, 2, 16, dict(causal=True, kv_chunk=16)),
    ("window", 2, 40, 40, 4, 2, 16,
     dict(causal=True, kv_chunk=8, window=5)),
    ("softcap", 2, 24, 24, 4, 4, 16,
     dict(causal=True, kv_chunk=16, softcap=2.0)),
    ("non_causal", 2, 24, 24, 4, 2, 16, dict(causal=False, kv_chunk=16)),
    ("decode", 2, 1, 48, 4, 2, 16,
     dict(causal=True, kv_chunk=16, q_offset=21, kv_len=22)),
    ("decode_window", 2, 1, 48, 4, 2, 16,
     dict(causal=True, kv_chunk=8, q_offset=30, kv_len=31, window=6)),
    ("prefill_into_cache", 2, 20, 48, 4, 2, 16,
     dict(causal=True, kv_chunk=16, q_offset=0, kv_len=20)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_blockwise_attention(case, dtype):
    _, b, sq, sk, h, kv, d, kw = case
    rng = np.random.RandomState(2)
    jq, tq = _pair(rng.randn(b, sq, h, d) * 2, dtype)
    jk, tk = _pair(rng.randn(b, sk, kv, d) * 2, dtype)
    jv, tv = _pair(rng.randn(b, sk, kv, d), dtype)
    want = jl.blockwise_attention(jq, jk, jv, **kw)
    got = pl.blockwise_attention(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype]
    _check(dtype)(got, want)


def test_blockwise_attention_against_plain_softmax():
    """A masked chunk ahead of the valid one (local window, -1e30 masks)
    still gives the plain softmax, finite everywhere."""
    rng = np.random.RandomState(3)
    b, s, h, d, win = 1, 32, 2, 8, 4
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
               for _ in range(3))
    got = pl.blockwise_attention(q, k, v, causal=True, kv_chunk=8,
                                 window=win)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    i = torch.arange(s)
    ok = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < win)
    p = torch.softmax(logits.masked_fill(~ok, -float("inf")), -1)
    close(got, torch.einsum("bhqk,bkhd->bqhd", p, v))


def _attn_spec(**kw):
    base = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                qkv_bias=True, kv_chunk=8)
    base.update(kw)
    return jl.AttnSpec(**base), pl.AttnSpec(**base)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_attention_with_and_without_cache(dtype):
    jspec, tspec = _attn_spec()
    jp = jl.init_attention(jax.random.PRNGKey(0), jspec)
    jp = {k: v + 0.1 * (k[0] == "b") for k, v in jp.items()}  # biases != 0
    tp = to_torch(jp)
    rng = np.random.RandomState(4)
    jx, tx = _pair(rng.randn(2, 12, 32), dtype)
    pos = np.arange(12)
    want, _ = jl.apply_attention(jp, jx, jspec, jnp.asarray(pos))
    got, none = pl.apply_attention(tp, tx, tspec, torch.from_numpy(pos))
    assert none is None
    _check(dtype)(got, want)
    # prefill 12 tokens into a cache of 20, then one decode step
    kc = np.zeros((2, 20, 2, 8), np.float32)
    jcache = (jnp.asarray(kc).astype(JDT[dtype]),) * 2 + (jnp.int32(0),)
    tcache = (torch.zeros(2, 20, 2, 8, dtype=TDT[dtype]),
              torch.zeros(2, 20, 2, 8, dtype=TDT[dtype]), 0)
    want, jcache = jl.apply_attention(jp, jx, jspec, jnp.asarray(pos),
                                      cache=jcache)
    got, tcache = pl.apply_attention(tp, tx, tspec, torch.from_numpy(pos),
                                     cache=tcache)
    _check(dtype)(got, want)
    assert tcache[2] == 12
    jx1, tx1 = _pair(rng.randn(2, 1, 32), dtype)
    want, jcache = jl.apply_attention(jp, jx1, jspec, jnp.asarray([12]),
                                      cache=jcache)
    got, tcache = pl.apply_attention(tp, tx1, tspec, torch.tensor([12]),
                                     cache=tcache)
    _check(dtype)(got, want)
    _check(dtype)(tcache[0], jcache[0])
    _check(dtype)(tcache[1], jcache[1])


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_apply_mlp(kind):
    jp = jl.init_mlp(jax.random.PRNGKey(1), 32, 48, kind)
    rng = np.random.RandomState(5)
    jx, tx = _pair(rng.randn(2, 6, 32))
    close(pl.apply_mlp(to_torch(jp), tx, kind), jl.apply_mlp(jp, jx, kind))
    with pytest.raises(ValueError):
        pl.apply_mlp(to_torch(jp), tx, "relu")


# (label, spec overrides): capacity 0.5 drops pairs; the fringe pass
# routes them back; the shared expert adds an always-on FFN
MOE_CASES = [
    ("no_drops", dict(capacity_factor=8.0)),
    ("drops", dict(capacity_factor=0.5)),
    ("fringe_overflow", dict(capacity_factor=0.5, fringe_overflow=True)),
    ("fringe_geglu", dict(capacity_factor=0.5, fringe_overflow=True,
                          mlp_kind="geglu")),
    ("fringe_gelu", dict(capacity_factor=0.5, fringe_overflow=True,
                         mlp_kind="gelu")),
    ("shared_top1", dict(top_k=1, shared_expert=True, d_shared=40)),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_apply_moe_dense(case):
    _, over = case
    base = dict(d_model=32, d_expert=24, num_experts=6, top_k=2)
    base.update(over)
    jspec, tspec = jmoe.MoESpec(**base), pmoe.MoESpec(**base)
    jp = jmoe.init_moe(jax.random.PRNGKey(2), jspec)
    rng = np.random.RandomState(6)
    jx, tx = _pair(rng.randn(4, 16, 32))
    want, jaux = jmoe.apply_moe_dense(jp, jx, jspec)
    got, taux = pmoe.apply_moe_dense(to_torch(jp), tx, tspec)
    close(got, want)
    close(taux, jaux)
    if jspec.capacity_factor < 1:
        # drops happened: the output differs from the no-drop one
        roomy = dataclasses.replace(tspec, capacity_factor=8.0,
                                    fringe_overflow=False)
        full, _ = pmoe.apply_moe_dense(to_torch(jp), tx, roomy)
        assert not torch.allclose(full, got) or tspec.fringe_overflow


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,chunk", [(32, 8), (29, 8), (5, 16)],
                         ids=["chunks", "padded_tail", "one_short_chunk"])
def test_apply_ssm(seq, chunk, dtype):
    spec = dict(d_model=32, state_dim=8, head_dim=8, expand=2, chunk=chunk)
    jspec, tspec = jssm.SSMSpec(**spec), pssm.SSMSpec(**spec)
    jp = jssm.init_ssm(jax.random.PRNGKey(3), jspec)
    tp = to_torch(jp)
    rng = np.random.RandomState(7)
    jx, tx = _pair(rng.randn(2, seq, 32), dtype)
    want, none = jssm.apply_ssm(jp, jx, jspec)
    got, tnone = pssm.apply_ssm(tp, tx, tspec)
    assert none is None and tnone is None
    _check(dtype)(got, want)


def test_apply_ssm_decode_from_a_state():
    """A prompt through the state path, then single-token steps (each a
    whole chunk of padding) from the carried state and conv tail."""
    spec = dict(d_model=32, state_dim=8, head_dim=8, chunk=8)
    jspec, tspec = jssm.SSMSpec(**spec), pssm.SSMSpec(**spec)
    jp = jssm.init_ssm(jax.random.PRNGKey(4), jspec)
    tp = to_torch(jp)
    rng = np.random.RandomState(8)
    jstate = jssm.init_ssm_state(2, jspec)
    tstate = pssm.init_ssm_state(2, tspec)
    for s in (11, 1, 1, 1):
        jx, tx = _pair(rng.randn(2, s, 32))
        want, jstate = jssm.apply_ssm(jp, jx, jspec, state=jstate)
        got, tstate = pssm.apply_ssm(tp, tx, tspec, state=tstate)
        close(got, want)
        close(tstate[0], jstate[0])
        close(tstate[1], jstate[1])
