"""The port's serving engine (``repro_torch.serve.engine``), the serve
launcher and the MoE serving example, on the CPU.

The reference's serving tests run on the port; ``generate`` gives the
reference's tokens for the same carried-over weights at fp32 compute; and
the KV-cache write clamps as ``jax.lax.dynamic_update_slice_in_dim`` does
(decode at ``cache_len = max_len - 1`` and ``max_len + 5`` on both
packages).  Tolerance: fp32 within 1e-4 * max(1, max |ref|).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import carry, close, port_cfg  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.examples import moe_serving  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

DENSE = ModelConfig(name="d", family="dense", num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                    kv_chunk=16, compute_dtype=torch.float32)
SSM = ModelConfig(name="s", family="ssm", num_layers=2, d_model=64,
                  num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=128,
                  ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                  compute_dtype=torch.float32, sub_quadratic=True)
JDENSE = JConfig(name="d", family="dense", num_layers=2, d_model=64,
                 num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                 kv_chunk=16, compute_dtype=jnp.float32)
JSSM = JConfig(name="s", family="ssm", num_layers=2, d_model=64,
               num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=128,
               ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
               compute_dtype=jnp.float32, sub_quadratic=True)


def _params(cfg, seed=0):
    return model_lib.init_params(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("cfg", [DENSE, SSM], ids=["dense", "ssm"])
def test_generate_matches_unbatched_forward(cfg):
    params = _params(cfg)
    eng = ServeEngine(cfg, params, ServeConfig(batch_size=2, max_len=48),
                      device="cpu")
    prompts = torch.randint(0, 128, (2, 8),
                            generator=torch.Generator().manual_seed(1))
    toks, _ = eng.generate(prompts, 6)
    assert toks.shape == (2, 6) and toks.dtype == torch.int32
    # greedy decode must equal greedy over the full forward pass
    seq = prompts
    for i in range(6):
        logits, _ = model_lib.forward(params, {"tokens": seq}, cfg)
        nxt = torch.argmax(logits[:, -1], -1)
        np.testing.assert_array_equal(nxt.numpy(), toks[:, i].numpy())
        seq = torch.cat([seq, nxt[:, None]], dim=1)


def test_ssm_decode_state_is_constant_size():
    cache = model_lib.init_cache(SSM, 2, 1_000_000, torch.float32,
                                 device="cpu")
    total = sum(t.numel() for _, t in _leaves(cache))
    # SSM state is O(1) in max_len: must be far below 1M x d
    assert total < 2 * 64 * 2 * 64 * 16 * 10


def test_long_context_decode_cheap_for_ssm():
    """The long_500k property: decode cost independent of context length."""
    params = _params(SSM)
    cache = model_lib.init_cache(SSM, 1, 8, torch.float32, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    logits, _ = model_lib.decode_step(params, tok, cache, 500_000, SSM)
    assert bool(torch.isfinite(logits).all())


GEN_CASES = [
    ("dense", JDENSE),
    ("ssm", JSSM),
    ("moe", dataclasses.replace(jget_arch("granite-moe-3b-a800m").smoke,
                                compute_dtype=jnp.float32)),
    ("hybrid", dataclasses.replace(jget_arch("zamba2-1.2b").smoke,
                                   compute_dtype=jnp.float32)),
]


@pytest.mark.parametrize("jcfg", [c[1] for c in GEN_CASES],
                         ids=[c[0] for c in GEN_CASES])
def test_generate_tokens_equal_reference(jcfg):
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    prompts = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, 8))
    want, meta = JServeEngine(jcfg, jp, JServeConfig(
        batch_size=2, max_len=24)).generate(
            jnp.asarray(prompts, jnp.int32), 8)
    eng = ServeEngine(port_cfg(jcfg), carry(jp, jcfg),
                      ServeConfig(batch_size=2, max_len=24), device="cpu")
    got, pmeta = eng.generate(torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pmeta == meta


@pytest.mark.parametrize("offset", [-1, 5], ids=["max_len-1", "max_len+5"])
def test_decode_at_and_past_the_cache_end_clamps_like_reference(offset):
    """A decode step at ``cache_len = max_len + offset``: the write lands
    where the reference's clamped ``dynamic_update_slice`` puts it, the
    position stays unclamped, and logits and caches match."""
    jcfg = JDENSE
    jp = jm.init_params(jax.random.PRNGKey(2), jcfg)
    cfg, pp = port_cfg(jcfg), carry(jp, jcfg)
    max_len = 20
    prompts = np.random.RandomState(3).randint(0, 128, (2, 12))
    jc = jm.init_cache(jcfg, 2, max_len, jnp.float32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompts)}, jcfg, jc)
    pc = model_lib.init_cache(cfg, 2, max_len, torch.float32, device="cpu")
    _, pc = model_lib.prefill(pp, {"tokens": torch.from_numpy(prompts)},
                              cfg, pc)
    tok = np.array([[5], [7]], np.int32)
    cache_len = max_len + offset
    jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(cache_len),
                            jcfg)
    before = pc["groups"]["slot0"]["k"].clone()
    pl, pc = model_lib.decode_step(pp, torch.from_numpy(tok), pc, cache_len,
                                   cfg)
    close(pl, jl)
    want = dict(_leaves(jax.tree.map(np.asarray, jc)))
    for path, t in _leaves(pc):
        close(t, want[path])
    # the write went to the last row, whatever the offset
    changed = (pc["groups"]["slot0"]["k"] != before).any(dim=(0, 1, 3, 4))
    assert changed.nonzero().flatten().tolist() == [max_len - 1]


def test_engine_checks_its_inputs():
    params = _params(DENSE)
    eng = ServeEngine(DENSE, params, ServeConfig(batch_size=2, max_len=16),
                      device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        eng.generate(torch.zeros((3, 4), dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(DENSE, params, ServeConfig(), device="meta")
    # the cache is the compute dtype; ServeConfig.cache_dtype is unread
    cache = ServeEngine(
        DENSE, params, ServeConfig(batch_size=2, max_len=16,
                                   cache_dtype=torch.int8),
        device="cpu").fresh_cache()
    assert cache["groups"]["slot0"]["k"].dtype == torch.float32


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_engine_and_launcher_need_a_card_unless_told_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(DENSE, _params(DENSE), ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "qwen1.5-4b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        moe_serving.main()


def test_launcher_and_example_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                              "--batch", "2", "--prompt-len", "8", "--gen",
                              "4", "--device", "cpu"]) > 0
    assert "served 2x4 tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="encoder-only"):
        launch_serve.main(["--arch", "hubert-xlarge", "--smoke",
                           "--device", "cpu"])
    load = moe_serving.main("cpu")
    assert load.sum() == 4 * 16
