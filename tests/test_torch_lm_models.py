"""The port's model zoo (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, on the CPU.

Weights carry over with ``interop.lm_params_from_arrays`` (torch's random
stream is not JAX's); batches come from the data pipeline's numpy seed.
Tolerances (``tests/_torch_lm.py``): fp32 compute within 1e-4 * max(1,
max |ref|), the configs' bf16 compute within 5e-2 * max(1, max |ref|).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import (  # noqa: E402
    carry, close, close_bf16, port_cfg, with_dtype,
)
from repro.configs import get_arch as jget_arch, list_archs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.interop import lm_params_from_arrays  # noqa: E402
from repro_torch.models import model as pm, moe as pmoe  # noqa: E402

ALL_ARCHS = list_archs()
DECODERS = [a for a in ALL_ARCHS if not jget_arch(a).full.encoder_only
            and jget_arch(a).full.frontend == "none"]


def _batch(cfg, batch=2, seq=32):
    dcfg = jpipeline.DataConfig(
        global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
        num_patches=cfg.num_patches,
    )
    return jpipeline.make_batch(dcfg, 0)


def _jbatch(batch):
    return jax.tree.map(jnp.asarray, batch)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _spec(tree):
    """Nested dict of (shape, dtype name) per leaf; empty dicts kept."""
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")
    return tuple(tree.shape), np.dtype(tree.dtype).name


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def test_all_ten_archs_registered():
    assert pconfigs.list_archs() == ALL_ARCHS
    assert len(ALL_ARCHS) == 10


@pytest.mark.parametrize("arch_name", ALL_ARCHS)
def test_configs_equal_field_for_field(arch_name):
    ref, port = jget_arch(arch_name), pconfigs.get_arch(arch_name)
    assert port.full == port_cfg(ref.full)
    assert port.smoke == port_cfg(ref.smoke)
    assert port.full.param_dtype is torch.float32
    assert port.full.compute_dtype is torch.bfloat16
    for f in ("name", "microbatches", "kv_cache_dtype", "notes"):
        assert getattr(port, f) == getattr(ref, f), f
    for shape in jbase.SHAPES:
        assert port.applicable(shape) == ref.applicable(shape)
    assert {k: dataclasses.astuple(v) for k, v in pconfigs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch_name", ALL_ARCHS)
def test_param_counts_equal(arch_name):
    ref, port = jget_arch(arch_name), pconfigs.get_arch(arch_name)
    for which in ("full", "smoke"):
        r, p = getattr(ref, which), getattr(port, which)
        assert p.param_count() == r.param_count()
        assert p.active_param_count() == r.active_param_count()
        assert p.layer_kinds() == r.layer_kinds()
        assert p.padded_vocab == r.padded_vocab


@pytest.mark.parametrize("arch_name", ALL_ARCHS)
def test_init_params_tree_matches_reference(arch_name):
    """Keys, shapes and dtypes equal the reference's; the deterministic
    leaves (norm scales, biases, SSM constants) equal its values; the
    random ones keep its scale; the meta tree is the same tree."""
    jcfg = jget_arch(arch_name).smoke
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    pp = pm.init_params(port_cfg(jcfg), torch.Generator().manual_seed(0),
                        device="cpu")
    assert _spec(pp) == _spec(jax.tree.map(np.asarray, jp))
    meta = pm.init_params(port_cfg(jcfg), None, device="meta")
    assert _spec(meta) == _spec(pp)
    assert all(t.device.type == "meta" for _, t in _leaves(meta))
    ref = dict(_leaves(jax.tree.map(np.asarray, jp)))
    for path, t in _leaves(pp):
        r = ref[path]
        if np.all(r == r.reshape(-1)[0]) or path.endswith("a_log"):
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-6, err_msg=path)
        elif r.size >= 1024:  # normal draws: the same scale
            assert abs(t.std().item() / r.std() - 1) < 0.15, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch_name", ALL_ARCHS)
def test_forward_and_loss_match_reference(arch_name, dtype):
    jcfg = with_dtype(jget_arch(arch_name).smoke, dtype)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    jl, jaux = jm.forward(jp, _jbatch(batch), jcfg)
    jloss, jparts = jm.loss_fn(jp, _jbatch(batch), jcfg)
    cfg, pp = port_cfg(jcfg), carry(jp, jcfg)
    pl, paux = pm.forward(pp, _tbatch(batch), cfg)
    ploss, pparts = pm.loss_fn(pp, _tbatch(batch), cfg)
    assert pl.dtype == torch.float32 and pl.shape[-1] == cfg.padded_vocab
    check = close if dtype == "float32" else close_bf16
    check(pl, jl)
    check(paux, jaux)
    check(ploss, jloss)
    for k in ("ce", "aux", "tokens"):
        check(pparts[k], jparts[k])
    # padded vocab columns are masked with -1e30, never -inf
    if cfg.padded_vocab != cfg.vocab_size:
        assert bool((pl[..., cfg.vocab_size:] == -1e30).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch_name", DECODERS)
def test_prefill_and_decode_match_reference(arch_name, dtype):
    """The reference's ``test_arch_smoke_decode`` setup (capacity factor 8,
    an fp32 cache of 64) on both packages: prefill's last logits, the
    cache it fills, and one decode step at position 32."""
    jcfg = with_dtype(jget_arch(arch_name).smoke, dtype)
    if jcfg.moe_num_experts:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=8.0)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    jc = jm.init_cache(jcfg, 2, 64, jnp.float32)
    jlp, jc = jm.prefill(jp, _jbatch(batch), jcfg, jc)
    tok = np.array(jnp.argmax(jlp, -1)[:, None].astype(jnp.int32))
    jld, jc2 = jm.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(32), jcfg)

    cfg, pp = port_cfg(jcfg), carry(jp, jcfg)
    pc = pm.init_cache(cfg, 2, 64, torch.float32, device="cpu")
    plp, pc = pm.prefill(pp, _tbatch(batch), cfg, pc)
    check = close if dtype == "float32" else close_bf16
    check(plp, jlp)
    pfl, _ = pm.forward(pp, _tbatch(batch), cfg)
    check(plp, pfl[:, -1])
    pld, pc2 = pm.decode_step(pp, torch.from_numpy(tok), pc, 32, cfg)
    check(pld, jld)
    want = dict(_leaves(jax.tree.map(np.asarray, jc2)))
    got = dict(_leaves(pc2))
    assert sorted(got) == sorted(want)
    for path in want:
        check(got[path], want[path])


def test_lm_params_from_arrays_refuses_a_wrong_tree():
    jcfg = jget_arch("granite-moe-3b-a800m").smoke
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    cfg = port_cfg(jcfg)
    pp = lm_params_from_arrays(tree, cfg, device="cpu")
    assert np.array_equal(pp["stack"]["groups"]["slot0"]["moe"]["w_in"],
                          tree["stack"]["groups"]["slot0"]["moe"]["w_in"])
    bad = jax.tree.map(lambda a: a, tree)
    bad["stack"]["groups"]["slot0"]["moe"]["w_in"] = \
        tree["stack"]["groups"]["slot0"]["moe"]["w_in"][:, :, :-1]
    with pytest.raises(ValueError, match="stack/groups/slot0/moe/w_in"):
        lm_params_from_arrays(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    del bad["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_arrays(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["embed"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_arrays(bad, cfg, device="cpu")
    # a config of another width refuses the tree
    with pytest.raises(ValueError, match="embed/table"):
        lm_params_from_arrays(
            tree, dataclasses.replace(cfg, d_model=2 * cfg.d_model),
            device="cpu")


def test_moe_shard_map_names_the_roadmap_item():
    """``moe_impl="shard_map"`` (A-queue 9b, ported): without installed
    rules and a mesh it raises, naming what it needs; with a 1 x 1 mesh
    the forward equals the dense dispatch's."""
    from repro_torch.distributed import make_mesh, sharding, use_mesh

    cfg = dataclasses.replace(pconfigs.get_arch(
        "granite-moe-3b-a800m").smoke, moe_impl="shard_map",
        compute_dtype=torch.float32)
    pp = pm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _tbatch(_batch(cfg))
    with pytest.raises(RuntimeError, match="AxisRules"):
        pm.forward(pp, batch, cfg)
    with use_mesh(make_mesh((1, 1), devices=["cpu"])), \
            sharding.use_rules(sharding.AxisRules()):
        got, aux = pm.forward(pp, batch, cfg)
    want, want_aux = pm.forward(
        pp, batch, dataclasses.replace(cfg, moe_impl="dense"))
    close(got, want)
    close(aux, want_aux)
    assert pmoe.MoESpec(8, 8, 4, 2).capacity(10) == 8


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_default_to_cuda_and_raise_without_it():
    cfg = pconfigs.get_arch("qwen1.5-4b").smoke
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_arrays({}, cfg)
