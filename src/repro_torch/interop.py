"""Carry plans across from the JAX package.

``plan_from_arrays`` builds the port's :class:`NeutronPlan` from the leaves
of a plan that ``repro.core.spmm.prepare`` built, given as numpy arrays,
plus its metadata.  The port's executor then runs on exactly the plan the
reference built, independently of the port's own ``prepare``.  This module
imports nothing of the JAX package: the caller turns the JAX plan into
arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .core.plan_ir import IMPL_DEVICE, NeutronPlan, SpmmConfig, plan_from_leaves


def plan_from_arrays(leaves: Dict[str, np.ndarray],
                     meta: Dict[str, Any]) -> NeutronPlan:
    """A port plan from the 19 named leaves and ``meta``.

    ``meta`` holds ``shape``, ``config`` (a :class:`SpmmConfig` or a dict of
    its fields; ``impl`` is the port's, "cuda" or "torch"), ``fringe_tier``
    and ``fringe_bk``, and optionally ``stats``, ``matrix_format`` (only
    "general"), ``format_params``, ``update_maps`` and ``device`` (default:
    the device of ``config.impl``).  ``stats`` must carry ``core_nnz`` and
    ``fringe_nnz``: they decide which engine paths run.
    """
    config = meta["config"]
    impl = config.impl if isinstance(config, SpmmConfig) else config.get(
        "impl", SpmmConfig.impl)
    device = meta.get("device", IMPL_DEVICE.get(impl, impl))
    return plan_from_leaves(leaves, meta, device)
