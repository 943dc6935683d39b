"""The LM half of the port's sharding rules (``repro_torch.distributed.
sharding``) and the ``shard_map`` MoE (``models.moe.apply_moe_shard_map``)
against the JAX package's, on the CPU.

The twelve tests of ``tests/test_sharding.py`` run on both packages (the
port's leaves are ``meta`` tensors: the rules read shapes only), and
``tuple(spec)`` is compared; ``constrain`` resolves logical names to the
reference's spec (read from the reference's ``with_sharding_constraint``
call) and returns its input.  The MoE: the port at a 1 x 1 mesh against
the reference's ``shard_map`` block in process, both ``moe_fsdp`` ways;
at 2 x 2 against the reference in a subprocess with 4 forced host devices
(``tests/_moe_shard_map_worker.py``); and each data shard of a 2 x 2 and a
2 x 1 port mesh against the port's own ``apply_moe_dense`` on that
shard's tokens.  Tolerance: fp32, 1e-4 * max(1, max |ref|) (the ff slices
are summed in another order than one GEMM sums them).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from _torch_lm import close  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.distributed import make_mesh, use_mesh  # noqa: E402
from repro_torch.distributed import sharding as pshd  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402

SIZES = {"pod": 2, "data": 16, "model": 16}
PACKAGES = ["repro", "repro_torch"]
WORKER = os.path.join(os.path.dirname(__file__), "_moe_shard_map_worker.py")


def _shd(pkg):
    return jshd if pkg == "repro" else pshd


def _rules(pkg, **kw):
    kw = kw or dict(batch_axes=("pod", "data"), fsdp_axes=("data",),
                    tp_axis="model")
    return _shd(pkg).AxisRules(**kw)


def _zeros(pkg, shape):
    if pkg == "repro":
        return jnp.zeros(shape)
    return torch.empty(shape, device="meta")


def _tree(pkg, tree):
    """A nested dict of shapes as the package's leaves."""
    if isinstance(tree, dict):
        return {k: _tree(pkg, v) for k, v in tree.items()}
    return _zeros(pkg, tree)


def _specs(pkg, tree):
    return _shd(pkg).param_specs(_tree(pkg, tree), _rules(pkg), SIZES)


def _is(spec, *want):
    assert tuple(spec) == tuple(JP(*want)), (spec, want)


# --- the twelve tests of tests/test_sharding.py, on both packages --------
@pytest.mark.parametrize("pkg", PACKAGES)
def test_col_parallel(pkg):
    s = _specs(pkg, {"attn": {"wq": (64, 32)}})
    _is(s["attn"]["wq"], "data", "model")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_row_parallel(pkg):
    s = _specs(pkg, {"attn": {"wo": (32, 64)}})
    _is(s["attn"]["wo"], "model", "data")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_stacked_leading_dims_ignored(pkg):
    s = _specs(pkg, {"mlp": {"w_in": (12, 64, 32)}})
    _is(s["mlp"]["w_in"], None, "data", "model")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_divisibility_fallback(pkg):
    # 17 is not divisible by 16 on either axis -> unsharded dims
    s = _specs(pkg, {"attn": {"wq": (17, 17)}})
    _is(s["attn"]["wq"], None, None)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_embed_table_padded_vocab_shards(pkg):
    s = _specs(pkg, {"embed": {"table": (49280, 1536)}})  # padded
    _is(s["embed"]["table"], "model", "data")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scalars_replicated(pkg):
    s = _specs(pkg, {"norm": {"scale": (64,)}})
    _is(s["norm"]["scale"], None)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cache_specs_kv(pkg):
    shd = _shd(pkg)
    c = _tree(pkg, {"groups": {"slot0": {"k": (4, 128, 1024, 16, 64),
                                         "v": (4, 128, 1024, 16, 64)}}})
    s = shd.cache_specs(c, _rules(pkg), SIZES)
    _is(s["groups"]["slot0"]["k"], None, ("pod", "data"), None, None,
        "model")
    # small batch falls back to the divisible prefix
    c8 = _tree(pkg, {"k": (8, 1024, 16, 64)})
    _is(shd.cache_specs(c8, _rules(pkg), SIZES)["k"], "pod", None, None,
        "model")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cache_specs_mqa_falls_to_head_dim(pkg):
    # kv=1 cannot shard over model=16; head_dim 128 can
    c = _tree(pkg, {"k": (128, 1024, 1, 128)})
    s = _shd(pkg).cache_specs(c, _rules(pkg), SIZES)
    _is(s["k"], ("pod", "data"), None, None, "model")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cache_specs_ssm(pkg):
    c = _tree(pkg, {"ssd": (4, 128, 64, 64, 128), "conv": (4, 128, 3, 4352)})
    s = _shd(pkg).cache_specs(c, _rules(pkg), SIZES)
    _is(s["ssd"], None, ("pod", "data"), "model", None, None)
    _is(s["conv"], None, ("pod", "data"), None, "model")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_batch_prefix_fit(pkg):
    shd, rules = _shd(pkg), _rules(pkg)
    # batch 1 cannot shard at all
    _is(shd.batch_spec(rules, 1, 1, SIZES), None, None)
    # batch 2 shards over pod only
    _is(shd.batch_spec(rules, 2, 1, SIZES), "pod", None)
    # batch 32 shards over pod x data
    _is(shd.batch_spec(rules, 32, 1, SIZES), ("pod", "data"), None)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_constrain_noop_without_rules(pkg):
    x = _zeros(pkg, (4, 4)) if pkg == "repro" else torch.zeros(4, 4)
    y = _shd(pkg).constrain(x, "batch", None)
    assert y is x


@pytest.mark.parametrize("pkg", PACKAGES)
def test_expert_axis_rules(pkg):
    rules = _shd(pkg).AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                                tp_axis="model", expert_axis="model")
    s = _shd(pkg).param_specs(_tree(pkg, {"moe": {"w_in": (16, 5120, 8192)}}),
                              rules, SIZES)
    _is(s["moe"]["w_in"], "model", "data", None)


# --- beyond the reference's tests ----------------------------------------
RULE_SETS = [
    dict(batch_axes=("pod", "data"), fsdp_axes=("data",), tp_axis="model"),
    dict(batch_axes=("data",), fsdp_axes=(), tp_axis="model",
         moe_fsdp=False),
    dict(batch_axes=("data",), fsdp_axes=("data",), tp_axis="model",
         expert_axis="model", seq_axis="data"),
    dict(batch_axes=("data",), fsdp_axes=("data",), tp_axis=None),
]


@pytest.mark.parametrize("kw", RULE_SETS, ids=["pod", "tp_only", "ep_sp",
                                               "no_tp"])
def test_param_and_cache_specs_of_whole_models(kw):
    """Every leaf of granite-moe's and zamba2's full params and decode
    caches gets the reference's spec (meta tensors on the port's side)."""
    from repro.configs import get_arch as jget_arch
    from repro.models import model as jm
    from repro_torch.configs import get_arch
    from repro_torch.models import model as pm

    sizes = {"pod": 2, "data": 8, "model": 4}
    for arch in ("granite-moe-3b-a800m", "zamba2-1.2b"):
        jcfg = jget_arch(arch).full
        jparams = jax.eval_shape(lambda: jm.init_params(
            jax.random.PRNGKey(0), jcfg))
        jcache = jax.eval_shape(lambda: jm.init_cache(jcfg, 16, 64))
        cfg = get_arch(arch).full
        with torch.device("meta"):
            pcache = pm.init_cache(cfg, 16, 64, device="meta")
        pparams = pm.init_params(cfg, None, device="meta")
        for jtree, ptree, fn in ((jparams, pparams, "param_specs"),
                                 (jcache, pcache, "cache_specs")):
            want = getattr(jshd, fn)(jtree, jshd.AxisRules(**kw), sizes)
            got = getattr(pshd, fn)(ptree, pshd.AxisRules(**kw), sizes)
            flat_w = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, JP))[0]
            for path, spec in flat_w:
                node = got
                for key in path:
                    node = node[key.key]
                assert tuple(node) == tuple(spec), (arch, fn, path)


@pytest.mark.parametrize("kw", RULE_SETS, ids=["pod", "tp_only", "ep_sp",
                                               "no_tp"])
def test_constrain_resolves_as_the_reference(kw, monkeypatch):
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    x = torch.zeros(2, 3)
    for logical in (("batch", "seq", None), ("batch", "seq", "vocab"),
                    ("batch", None, None, None, "heads"), ("expert", "ff"),
                    ("seq", "batch"), ("embed",)):
        with jshd.use_rules(jshd.AxisRules(**kw)):
            jshd.constrain(jnp.zeros(1), *logical)
        with pshd.use_rules(pshd.AxisRules(**kw)):
            assert pshd.constrain(x, *logical) is x
            got = pshd.logical_spec(*logical)
        assert tuple(got) == tuple(seen[-1]), logical
    assert pshd.logical_spec("batch") is None


# --- the shard_map MoE ---------------------------------------------------
def _jit_moe(params, x, spec):
    """The reference's block jitted (its eager shard_map takes seconds a
    call), traced afresh: the installed rules are read while it traces,
    and a jit cache keyed on shapes alone would not see them change."""
    return jax.jit(lambda p, v: jmoe.apply_moe(p, v, spec))(params, x)


def _moe(kind="swiglu", shared=False, e=4, k=2, d=16, f=32):
    spec = jmoe.MoESpec(d_model=d, d_expert=f, num_experts=e, top_k=k,
                        mlp_kind=kind, shared_expert=shared, d_shared=24,
                        impl="shard_map")
    params = jmoe.init_moe(jax.random.PRNGKey(0), spec)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, d))
    port = pmoe.MoESpec(**dataclasses.asdict(spec))
    tparams = {n: torch.from_numpy(np.array(v)) for n, v in params.items()}
    return spec, params, x, port, tparams, torch.from_numpy(np.array(x))


@pytest.mark.parametrize("fsdp", [True, False], ids=["moe_fsdp", "dp_rep"])
@pytest.mark.parametrize("kind,shared", [("swiglu", False), ("gelu", True),
                                         ("squared_relu", False)])
def test_shard_map_moe_matches_reference_at_1x1(kind, shared, fsdp):
    spec, params, x, port, tparams, tx = _moe(kind, shared)
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))), \
            jshd.use_rules(jshd.AxisRules(moe_fsdp=fsdp)):
        want, want_aux = _jit_moe(params, x, spec)
    with use_mesh(make_mesh((1, 1), devices=["cpu"])), \
            pshd.use_rules(pshd.AxisRules(moe_fsdp=fsdp)):
        got, aux = pmoe.apply_moe(tparams, tx, port)
    close(got, want)
    close(aux, want_aux)


@pytest.mark.parametrize("fsdp", [True, False], ids=["moe_fsdp", "dp_rep"])
@pytest.mark.parametrize("mesh", [(2, 2), (2, 1), (1, 2)],
                         ids=["2x2", "2x1", "1x2"])
def test_shard_map_moe_each_data_shard_is_its_dense_dispatch(mesh, fsdp):
    """Each data shard's rows are ``apply_moe_dense`` of that shard's
    tokens (capacity at the local count), the model shards' ff slices
    summed; ``aux`` is the data shards' mean."""
    _, _, _, port, tparams, tx = _moe()
    with use_mesh(make_mesh(mesh, devices=["cpu"] * (mesh[0] * mesh[1]))), \
            pshd.use_rules(pshd.AxisRules(moe_fsdp=fsdp)):
        got, aux = pmoe.apply_moe(tparams, tx, port)
    dense = dataclasses.replace(port, impl="dense")
    rows = tx.shape[0] // mesh[0]
    auxes = []
    for i in range(mesh[0]):
        want, a = pmoe.apply_moe_dense(tparams, tx[i * rows:(i + 1) * rows],
                                       dense)
        close(got[i * rows:(i + 1) * rows], want)
        auxes.append(a)
    close(aux, torch.stack(auxes).mean())


def test_shard_map_moe_differentiates():
    """Gradients flow through the shards to the weights and the input:
    the same as the dense dispatch's at a 1 x 2 mesh (one data shard)."""
    _, _, _, port, tparams, tx = _moe()
    grads = {}
    for impl in ("shard_map", "dense"):
        p = {n: v.clone().requires_grad_(True) for n, v in tparams.items()}
        x = tx.clone().requires_grad_(True)
        with use_mesh(make_mesh((1, 2), devices=["cpu"] * 2)), \
                pshd.use_rules(pshd.AxisRules(moe_fsdp=False)):
            out, aux = pmoe.apply_moe(p, x, dataclasses.replace(port,
                                                                impl=impl))
        (out.square().sum() + aux).backward()
        grads[impl] = [x.grad] + [p[n].grad for n in sorted(p)]
    for got, want in zip(grads["shard_map"], grads["dense"]):
        close(got, want)


def test_shard_map_moe_needs_rules_and_a_mesh():
    _, _, _, port, tparams, tx = _moe()
    with pytest.raises(RuntimeError, match="AxisRules"):
        pmoe.apply_moe(tparams, tx, port)
    with use_mesh(make_mesh((3, 1), devices=["cpu"] * 3)), \
            pshd.use_rules(pshd.AxisRules()):
        with pytest.raises(ValueError, match="divide"):
            pmoe.apply_moe(tparams, tx, port)


def test_shard_map_moe_matches_reference_at_2x2(forced_mesh_run):
    out = forced_mesh_run(WORKER, n_devices=4, timeout=600)
    assert "MOE SHARD_MAP OK" in out.stdout
