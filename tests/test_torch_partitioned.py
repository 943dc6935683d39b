"""The partitioned LM step against the unpartitioned one, numerically, on
the CPU: one train step, one prefill and one decode step of the tiny
dense, MoE (both implementations) and SSM cells as a 2 x 2 (data x model)
DTensor program over ``gloo``, in four spawned processes.

Every process builds the same seed-made numpy weights and batch, carries
them into the port (``interop.lm_params_from_arrays``) and runs the
unpartitioned step on its own, then the partitioned one: params,
optimizer state, batch and cache placed by their specs
(``distributed.sharding.place``) and the step run under the rules and
the device mesh (``use_dtensor_mesh``).  Loss, ``grad_norm``, every
updated param and moment (the dense cell's also with int8 gradient
compression, and its error feedback), the prefill's logits and cache, the decode
step's logits, the dense MoE cell's forward over a served prompt and
the dense MoE's fringe pass (called directly: no config turns it on)
must equal
the unpartitioned results within 1e-5 * max(1, max |ref|) in fp32 (AdamW
with eps = 1e-6, see ``EPS``).  The
unpartitioned step is held against the JAX package's in
``tests/test_torch_train_step.py`` and the prefill in
``tests/test_torch_lm_models.py``; this file needs no JAX.

The group meets through a ``FileStore`` under ``tmp_path``: no TCP port
is taken, so ``pytest -n`` workers cannot collide.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.models.config import ModelConfig

WORLD = 4
TOL = 1e-5
DENSE = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=250,
                    kv_chunk=32, compute_dtype=torch.float32)
MOE = dataclasses.replace(DENSE, family="moe", moe_num_experts=4,
                          moe_top_k=2, moe_d_expert=64, num_kv_heads=4)
SSM = dataclasses.replace(DENSE, family="ssm", ssm_state=16,
                          ssm_head_dim=16, ssm_chunk=16)
CELLS = {"dense": DENSE, "moe-dense": MOE,
         "moe-shard_map": dataclasses.replace(MOE, moe_impl="shard_map"),
         "ssm": SSM}
BATCH, SEQ, MICRO = 8, 32, 2
# AdamW's first step moves an entry by about lr * sign(g) whenever |g| is
# far above eps, so a gradient that is 0 but for fp32 rounding (1e-12)
# would move by lr either way; eps = 1e-6 keeps such entries still and the
# step a smooth function of the gradient, which is what is compared
EPS = 1e-6
# with int8 compression, a gradient within the two programs' fp32
# difference of a rounding boundary of the grid rounds to neighbouring
# steps, and its entry's update differs: at most 0.1 % of a leaf's
# entries may (as in tests/test_torch_train_step.py)
EXEMPT = 1e-3


def _arrays(cfg, seed):
    """Seed-made numpy weights for every leaf of ``cfg``'s params."""
    from repro_torch.models import model as model_lib

    rng = np.random.default_rng(seed)
    meta = model_lib.init_params(cfg, None, "meta")

    def make(t):
        if isinstance(t, dict):
            return {k: make(v) for k, v in t.items()}
        return (rng.standard_normal(tuple(t.shape)) * 0.1).astype(np.float32)
    return make(meta)


def _close(got, want, exempt=0.0):
    """(within tolerance, max |diff|); with ``exempt``, that share of the
    entries may lie outside it."""
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    got, want = got.detach().float(), want.detach().float()
    if not want.numel():
        return True, 0.0
    diff = (got - want).abs()
    bad = diff > TOL * max(1.0, float(want.abs().max()))
    return int(bad.sum()) <= exempt * want.numel(), float(diff.max())


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        for f in type(tree)._fields:
            yield from _leaves(getattr(tree, f), f"{path}/{f}")
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


def _run(name, cfg, mesh, rules):
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import make_mesh, use_mesh
    from repro_torch.interop import lm_params_from_arrays
    from repro_torch.models import model as model_lib
    from repro_torch.train import compression, optimizer as opt_lib
    from repro_torch.train import train_loop

    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    arrays = _arrays(cfg, 0)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                                           dtype=np.int32))
    tcfg = train_loop.TrainConfig(
        optimizer=opt_lib.OptimizerConfig(lr=1e-2, warmup_steps=1,
                                          eps=EPS),
        num_microbatches=MICRO)
    step = train_loop.make_train_step(cfg, tcfg)
    # the unpartitioned program (the one-process mesh for the shard_map
    # MoE: every shard on the CPU)
    one = make_mesh((sizes["data"], sizes["model"]),
                    devices=["cpu"] * WORLD)

    def state():
        params = lm_params_from_arrays(arrays, cfg, device="cpu")
        for p in opt_lib.tree_leaves(params):
            p.requires_grad_(True)
        return params, opt_lib.init_opt_state(params, tcfg.optimizer)

    params, opt = state()
    with shd.use_rules(rules), use_mesh(one):
        ref_p, ref_o, ref_m = step(params, opt, {"tokens": tokens})
    # the partitioned program
    params, opt = state()
    pspecs = shd.param_specs(params, rules, sizes)
    named = shd._map_specs(lambda s: shd.NamedSharding(one, s), pspecs)
    ospecs = opt_lib.OptState(step=shd.NamedSharding(one, shd.P()),
                              m=named, v=named)
    bspec = {"tokens": shd.NamedSharding(one, shd.batch_spec(
        rules, BATCH, 1, sizes))}
    d_params = shd.place(params, named, mesh)
    d_opt = shd.place(opt, ospecs, mesh)
    d_batch = shd.place({"tokens": tokens}, bspec, mesh)
    with shd.use_rules(rules), use_mesh(one), shd.use_dtensor_mesh(mesh):
        got_p, got_o, got_m = step(d_params, d_opt, d_batch)
    out = {}
    for k in ("loss", "grad_norm"):
        out[f"{name}/train/{k}"] = _close(got_m[k], ref_m[k])
    for (path, g), (_, w) in zip(_leaves((got_p, got_o)),
                                 _leaves((ref_p, ref_o))):
        out[f"{name}/train{path}"] = _close(g, w)
    if name == "dense":   # and with int8 compression and error feedback
        cstep = train_loop.make_train_step(cfg, dataclasses.replace(
            tcfg, grad_compression=True))
        params, opt = state()
        err = compression.init_error_feedback(params)
        with shd.use_rules(rules), use_mesh(one):
            ref_c = cstep(params, opt, {"tokens": tokens}, err)
        params, opt = state()
        d_params = shd.place(params, named, mesh)
        d_err = shd.place(compression.init_error_feedback(params), named,
                          mesh)
        with shd.use_rules(rules), use_mesh(one), \
                shd.use_dtensor_mesh(mesh):
            got_c = cstep(d_params, shd.place(opt, ospecs, mesh), d_batch,
                          d_err)
        for (path, g), (_, w) in zip(_leaves(got_c[:3]), _leaves(ref_c[:3])):
            out[f"{name}/train/compressed{path}"] = _close(g, w,
                                                           EXEMPT)
        out[f"{name}/train/compressed/loss"] = _close(got_c[3]["loss"],
                                                      ref_c[3]["loss"])

    # prefill into a cache
    params, _ = state()
    with torch.no_grad(), shd.use_rules(rules), use_mesh(one):
        cache = model_lib.init_cache(cfg, BATCH, SEQ + 8, torch.float32,
                                     "cpu")
        ref_logits, ref_cache = model_lib.prefill(
            params, {"tokens": tokens}, cfg, cache)
        cache = model_lib.init_cache(cfg, BATCH, SEQ + 8, torch.float32,
                                     "cpu")
        cspecs = shd._map_specs(lambda s: shd.NamedSharding(one, s),
                                shd.cache_specs(cache, rules, sizes))
        d_cache = shd.place(cache, cspecs, mesh)
        d_params = shd.place(params, named, mesh)
        with shd.use_dtensor_mesh(mesh):
            logits, got_cache = model_lib.prefill(d_params, d_batch, cfg,
                                                  d_cache)
        # and one decode step from the filled cache
        token = tokens[:, :1]
        with use_mesh(one):
            ref_next, _ = model_lib.decode_step(params, token, ref_cache,
                                                SEQ, cfg)
        d_token = shd.place({"tokens": token}, bspec, mesh)["tokens"]
        with shd.use_dtensor_mesh(mesh):
            got_next, _ = model_lib.decode_step(d_params, d_token,
                                                got_cache, SEQ, cfg)
    out[f"{name}/prefill/logits"] = _close(logits, ref_logits)
    for (path, g), (_, w) in zip(_leaves(got_cache), _leaves(ref_cache)):
        out[f"{name}/prefill/cache{path}"] = _close(g, w)
    out[f"{name}/prefill/decode_logits"] = _close(got_next, ref_next)
    if name == "moe-dense":
        # a served prompt's forward: every position's logits, so every
        # token's MoE output reaches the comparison
        with torch.no_grad(), shd.use_rules(rules), use_mesh(one):
            ref_all, ref_aux = model_lib.forward(params, {"tokens": tokens},
                                                 cfg)
            with shd.use_dtensor_mesh(mesh):
                got_all, got_aux = model_lib.forward(d_params, d_batch, cfg)
        out[f"{name}/serve/logits"] = _close(got_all, ref_all)
        out[f"{name}/serve/aux"] = _close(got_aux, ref_aux)
    return out


def _fringe_run(mesh):
    """The dense MoE with its fringe pass (capacity 0.5 drops pairs) on
    DTensors against the plain call: output and aux loss."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models import moe

    spec = moe.MoESpec(d_model=64, d_expert=64, num_experts=4, top_k=2,
                       capacity_factor=0.5, mlp_kind="swiglu",
                       fringe_overflow=True)
    rng = np.random.default_rng(2)
    one = make_mesh((2, 2), devices=["cpu"] * WORLD)
    layout = {"router": ((64, 4), shd.P("data", None)),
              "w_in": ((4, 64, 64), shd.P(None, "data", "model")),
              "w_gate": ((4, 64, 64), shd.P(None, "data", "model")),
              "w_out": ((4, 64, 64), shd.P(None, "model", "data"))}
    params = {k: torch.from_numpy(
        (rng.standard_normal(shape) * 0.1).astype(np.float32))
        for k, (shape, _) in layout.items()}
    x = torch.from_numpy(rng.standard_normal((BATCH, SEQ, 64))
                         .astype(np.float32))
    ref_out, ref_aux = moe.apply_moe_dense(params, x, spec)
    dropped, _ = moe.apply_moe_dense(
        params, x, dataclasses.replace(spec, fringe_overflow=False))
    rules = shd.AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                          tp_axis="model")
    d_params = shd.place(params, {k: shd.NamedSharding(one, p)
                                  for k, (_, p) in layout.items()}, mesh)
    d_x = shd.place(x, shd.NamedSharding(one, shd.P("data", None, None)),
                    mesh)
    with shd.use_rules(rules), shd.use_dtensor_mesh(mesh):
        out, aux = moe.apply_moe_dense(d_params, d_x, spec)
    has_work = not torch.allclose(dropped, ref_out)
    return {"fringe/moe/out": _close(out, ref_out),
            "fringe/moe/aux": _close(aux, ref_aux),
            "fringe/moe/has_work": (has_work, 0.0)}


def _worker(rank, store_path, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as shd

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = {}
        for name, cfg in CELLS.items():
            rules = shd.AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                                  tp_axis="model",
                                  moe_fsdp=cfg.moe_impl != "shard_map")
            out.update(_run(name, cfg, mesh, rules))
        out.update(_fringe_run(mesh))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("partitioned")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(d / "store"), str(d)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return [json.load(open(d / f"rank{r}.json")) for r in range(WORLD)]


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("what", ["train", "prefill"])
def test_partitioned_step_equals_unpartitioned(results, cell, what):
    """Every rank's view: each value within 1e-5 * max(1, max |ref|)."""
    for rank, res in enumerate(results):
        keys = [k for k in res if k.startswith(f"{cell}/{what}/")]
        assert keys
        bad = {k: res[k][1] for k in keys if not res[k][0]}
        assert not bad, (rank, bad)


def test_partitioned_moe_serve_forward_equals_unpartitioned(results):
    """The dense MoE cell's forward over a served prompt (every
    position's logits and the load-balancing loss), partitioned, within
    1e-5 * max(1, max |ref|) of the unpartitioned forward."""
    for rank, res in enumerate(results):
        keys = [k for k in res if k.startswith("moe-dense/serve/")]
        assert len(keys) == 2
        bad = {k: res[k][1] for k in keys if not res[k][0]}
        assert not bad, (rank, bad)


def test_partitioned_moe_fringe_pass_equals_unpartitioned(results):
    """The dense MoE's fringe pass for the pairs over capacity, on the
    2 x 2 mesh, within 1e-5 * max(1, max |ref|) of the plain call; the
    pass is checked to have work (pairs dropped at capacity 0.5)."""
    for rank, res in enumerate(results):
        keys = [k for k in res if k.startswith("fringe/")]
        assert len(keys) == 3
        bad = {k: res[k][1] for k in keys if not res[k][0]}
        assert not bad, (rank, bad)
