"""The shard_map MoE at a 2 x 2 mesh on both packages (run in a subprocess
with 4 forced host devices).

The reference's ``apply_moe_shard_map`` runs its ``shard_map`` block over a
real ``("data", "model")`` mesh of 4 host devices; the port runs the same
shards one after another on ``["cpu"] * 4``.  Outputs and ``aux`` must
agree within 1e-4 * max(1, max |ref|), for each MLP kind, a shared
expert, both ``moe_fsdp`` ways and a capacity that drops pairs.  Prints
``MOE SHARD_MAP OK``.

Launched by tests/test_torch_lm_sharding.py through the ``forced_mesh_run``
fixture, and runnable alone:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_moe_shard_map_worker.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.hostdevices import force_host_device_count  # noqa: E402 (jax-free)

force_host_device_count(os.environ, 4)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.distributed import make_mesh, use_mesh  # noqa: E402
from repro_torch.distributed import sharding as pshd  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402


def _close(got, want, tol=1e-4):
    got = got.detach().numpy()
    want = np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err
    return err


def main():
    assert len(jax.devices()) == 4, jax.devices()
    jmesh = jax.make_mesh((2, 2), ("data", "model"))
    pmesh = make_mesh((2, 2), devices=["cpu"] * 4)
    worst = 0.0
    for kind, shared, cap in (("swiglu", False, 1.25), ("gelu", True, 1.25),
                              ("squared_relu", False, 1.25),
                              ("swiglu", False, 0.5)):
        spec = jmoe.MoESpec(d_model=16, d_expert=32, num_experts=4, top_k=2,
                            mlp_kind=kind, shared_expert=shared, d_shared=24,
                            capacity_factor=cap, impl="shard_map")
        params = jmoe.init_moe(jax.random.PRNGKey(0), spec)
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 16))
        port = pmoe.MoESpec(**dataclasses.asdict(spec))
        tparams = {n: torch.from_numpy(np.array(v)) for n, v in params.items()}
        tx = torch.from_numpy(np.array(x))
        for fsdp in (True, False):
            with jax.set_mesh(jmesh), \
                    jshd.use_rules(jshd.AxisRules(moe_fsdp=fsdp)):
                # jitted, traced afresh under these rules
                want, want_aux = jax.jit(
                    lambda p, v: jmoe.apply_moe(p, v, spec))(params, x)
            with use_mesh(pmesh), \
                    pshd.use_rules(pshd.AxisRules(moe_fsdp=fsdp)):
                got, aux = pmoe.apply_moe(tparams, tx, port)
            worst = max(worst, _close(got, want), _close(aux, want_aux))
    print(f"MOE SHARD_MAP OK (max |diff| {worst:.3e})")


if __name__ == "__main__":
    main()
