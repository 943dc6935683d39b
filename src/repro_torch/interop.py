"""Carry state across from the JAX package.

- ``plan_from_arrays`` builds the port's :class:`NeutronPlan` from the
  leaves of a plan that ``repro.core.spmm.prepare`` built, given as numpy
  arrays, plus its metadata.  The port's executor then runs on exactly the
  plan the reference built, independently of the port's own ``prepare``.
- ``update_maps_from_arrays`` gives such a plan the reference's COO->slot
  maps, which ``sddmm`` and ``with_values`` need.
- ``graph_conv_from_arrays`` and ``graph_attention_from_arrays`` build the
  port's layers from the JAX layers' weights.
- ``lm_params_from_arrays`` carries an LM's params across: the nested dict
  that ``jax.tree.map(np.asarray, params)`` gives becomes the port's tree
  with the same keys, layout and dtypes.
- ``opt_state_from_arrays`` carries the reference's optimizer state
  (``repro.train.optimizer.OptState`` as numpy) beside those params, so
  that one train step can run in both packages from the same state.

This module imports nothing of the JAX package: the caller turns JAX state
into numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .core.plan_ir import (
    IMPL_DEVICE, NeutronPlan, SpmmConfig, UpdateMaps, plan_from_leaves,
)
from .models import model as lm_model
from .models.config import ModelConfig, resolve_device
from .models.layers import SparseGraphAttention, SparseGraphConv
from .train.optimizer import OptState, tree_leaves, tree_map


def plan_from_arrays(leaves: Dict[str, np.ndarray],
                     meta: Dict[str, Any]) -> NeutronPlan:
    """A port plan from the 19 named leaves and ``meta``.

    ``meta`` holds ``shape``, ``config`` (a :class:`SpmmConfig` or a dict of
    its fields; ``impl`` is the port's, "cuda" or "torch"), ``fringe_tier``
    and ``fringe_bk``, and optionally ``stats``, ``matrix_format``
    ("general", "nm" or "bitmap"), ``format_params``, ``update_maps`` and
    ``device`` (default: the device of ``config.impl``).  ``stats`` must
    carry ``core_nnz`` and ``fringe_nnz``: they decide which engine paths
    run.  A structured plan's packed leaves (``nm_values``/``nm_codes`` or
    ``bitmap_words``/``bitmap_values``) must have the shapes its
    ``format_params`` give, and the general leaves ride along as in the
    reference.
    """
    config = meta["config"]
    impl = config.impl if isinstance(config, SpmmConfig) else config.get(
        "impl", SpmmConfig.impl)
    device = meta.get("device", IMPL_DEVICE.get(impl, impl))
    return plan_from_leaves(leaves, meta, device)


def update_maps_from_arrays(arrays: Dict[str, Any]) -> UpdateMaps:
    """:class:`UpdateMaps` from the fields of the reference's maps.

    ``arrays`` holds every field of ``repro.core.plan_ir.UpdateMaps`` by
    name (``shape`` as a pair, the rest as numpy arrays); the arrays are
    copied, the values into a tensor (which :func:`plan_from_arrays` puts
    on the plan's device).  Pass the result as ``meta["update_maps"]`` to
    :func:`plan_from_arrays`.
    """
    names = [f.name for f in dataclasses.fields(UpdateMaps)]
    missing = [n for n in names if n not in arrays]
    if missing:
        raise ValueError(f"update maps lack fields {missing}")
    return UpdateMaps(
        shape=tuple(int(s) for s in arrays["shape"]),
        vals=torch.from_numpy(np.array(arrays["vals"])),
        **{n: np.array(arrays[n]) for n in names
           if n not in ("shape", "vals")})


def _weight(w) -> torch.Tensor:
    return torch.from_numpy(np.array(w, np.float32))


def graph_conv_from_arrays(a, w) -> SparseGraphConv:
    """The port's ``SparseGraphConv`` on graph ``a`` (a SparseMatrix or a
    plan) with the JAX layer's (d_in, d_out) weight as a numpy array."""
    return SparseGraphConv(a, _weight(w))


def graph_attention_from_arrays(a, wq, wk, wv) -> SparseGraphAttention:
    """The port's ``SparseGraphAttention`` on graph ``a`` with the JAX
    layer's three (d_in, d_head) projections as numpy arrays."""
    return SparseGraphAttention(a, _weight(wq), _weight(wk), _weight(wv))


def lm_params_from_arrays(tree: Dict[str, Any], cfg: ModelConfig,
                          device=None) -> Dict[str, Any]:
    """The port's LM params for ``cfg`` from the reference's, as numpy.

    ``tree`` is the nested dict of arrays that
    ``jax.tree.map(np.asarray, params)`` gives for
    ``repro.models.model.init_params``.  Every leaf's key path and shape is
    checked against ``init_params``' tree for ``cfg`` (``groups`` leaves
    keep their leading ``n_groups`` axis); a missing or extra key or a
    wrong shape raises ``ValueError`` naming the leaf's path.  Leaves are
    copied to ``device`` (``"cuda"`` unless named) in ``cfg.param_dtype``.
    """
    device = resolve_device(device)
    want = lm_model.init_params(cfg, None, device="meta")

    def carry(got, spec, path):
        if isinstance(spec, dict):
            if not isinstance(got, dict):
                raise ValueError(f"{path or '<root>'}: expected a dict")
            extra = sorted(set(got) - set(spec))
            missing = sorted(set(spec) - set(got))
            if extra or missing:
                raise ValueError(f"{path or '<root>'}: missing keys "
                                 f"{missing}, unexpected keys {extra}")
            return {k: carry(got[k], spec[k], f"{path}/{k}".lstrip("/"))
                    for k in spec}
        arr = np.asarray(got)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(spec.shape)}")
        return torch.from_numpy(np.array(arr)).to(device, spec.dtype)

    return carry(tree, want, "")


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``arr``; an ml_dtypes bfloat16 array keeps its
    bits as ``torch.bfloat16``."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def opt_state_from_arrays(state: Any, params: Dict[str, Any]) -> OptState:
    """The port's :class:`~repro_torch.train.optimizer.OptState` from the
    reference's, as numpy (``jax.tree.map(np.asarray, opt_state)``: a
    NamedTuple, or a tuple, of ``step``, ``m`` and ``v``).

    ``params`` is the port's tree the state belongs to (from
    :func:`lm_params_from_arrays`): each moment leaf must have its param's
    shape and lands on its param's device in the moment's own dtype (fp32,
    or bfloat16 for ``moment_dtype=bfloat16``); ``step`` becomes a 0-d
    int32 tensor there.
    """
    step, m, v = state

    def carry(arr, p):
        t = _tensor(arr)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"moment shape {tuple(t.shape)}, param shape "
                             f"{tuple(p.shape)}")
        return t.to(p.device)

    device = tree_leaves(params)[0].device
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        m=tree_map(carry, m, params),
        v=tree_map(carry, v, params),
    )

