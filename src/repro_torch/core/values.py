"""Value-only plan updates: the first layer of ``repro.dynamic.delta``.

:func:`update_values` writes new nonzero values straight into a prepared
plan's tensors (flat tile stream, packed fringe, k-bucketed stream) through
the COO->slot maps ``prepare`` builds (:class:`~repro_torch.core.plan_ir.
UpdateMaps`).  Every shape stays, so the plan keeps its signature and its
cached executor.  Touched tile cells are recomputed on the host from all
their contributors with the same sequential fp32 ``np.add.at`` that
``prepare`` used, then written to the device by a scatter to unique
indices, so the updated plan is bit-identical to a fresh ``prepare`` of the
new values.  (A scatter that adds value deltas on the device would not be:
``a + (b - a) != b`` in fp32.)

Where the core values change, the plan's ``a_unsplittable`` flag is
computed again from the new tile stream (it lives on the plan, not in the
shared ``derived``).

The update is functional: the touched tensors are copied first, and the
original plan is left as it was.  At Reddit scale that copy of
``flat_values`` is 5.85 GB of device memory for as long as both plans live.

A structured plan (``matrix_format`` "nm" or "bitmap") whose core values
change is demoted to the general payload, as in the reference: the packed
stream would go stale, and the general leaves are always kept current.
The demotion changes the signature once (to ``general_format_sig`` of the
old one); later updates keep it.

It lives in ``core`` because the executor's backward (``exec.api``) writes
values into the transpose structure with it, and ``exec`` sits below
``dynamic``; ``repro_torch.dynamic.update_values`` is the public name, as
in the reference.  On a ``ShardedPlan`` it writes through each shard's own
maps (:func:`_update_values_sharded`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..errors import PlanBuildError
from .arrays import sorted_unique
from .plan_ir import (
    LEAF_FLAT_VALUES, LEAF_FRINGE_VALS, LEAF_KB_VALS, PATH_FRINGE,
    NeutronPlan, PlanShard, ShardedPlan, UpdateMaps, unsplittable_flag,
)


def _as_1d(a, dtype) -> np.ndarray:
    out = np.asarray(a, dtype)
    if out.ndim != 1:
        raise PlanBuildError(f"expected a 1-D array, got shape {out.shape}")
    return out


def _recompute_core_slots(
    maps: UpdateMaps, touched_ids: np.ndarray, cur: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact new contents of every tile cell touched by the given nonzeros.

    Duplicates accumulate into one cell, so each touched flat slot is
    recomputed from all its contributors in input order, replaying the
    sequential fp32 ``np.add.at`` that first filled it.  ``touched_ids``
    are unique core nonzeros; when they are all of them (``with_values``),
    the slots and their contributors are read off the sorted maps in one
    pass instead of being searched for, with the same result.
    """
    if touched_ids.size == maps.core_members_sorted.size:
        lin = maps.core_lin_sorted
        first = np.ones(lin.size, bool)
        first[1:] = lin[1:] != lin[:-1]
        touched = lin[first]
        members = maps.core_members_sorted
        slot_of_member = np.cumsum(first) - 1
    else:
        touched = sorted_unique(maps.core_lin[touched_ids])
        lo = np.searchsorted(maps.core_lin_sorted, touched, "left")
        hi = np.searchsorted(maps.core_lin_sorted, touched, "right")
        counts = hi - lo
        total = int(counts.sum())
        starts = np.cumsum(counts) - counts
        flatpos = (np.arange(total) - np.repeat(starts, counts)
                   + np.repeat(lo, counts))
        members = maps.core_members_sorted[flatpos]
        slot_of_member = np.repeat(np.arange(touched.size), counts)
    sums = np.zeros(touched.size, np.float32)
    np.add.at(sums, slot_of_member, cur[members].astype(np.float32))
    return touched, sums


def _split_paths(
    maps: UpdateMaps, ids: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The unique ids on the core path and on the fringe path, sorted."""
    # ids already sorted and unique (with_values passes arange(nnz)) skip
    # the sort
    if ids.size > 1 and not bool(np.all(ids[1:] > ids[:-1])):
        ids = sorted_unique(ids)
    is_fringe = maps.path[ids] == PATH_FRINGE
    return ids[~is_fringe], ids[is_fringe]


def _validate_update(maps, indices, new_values) -> Tuple[np.ndarray, np.ndarray]:
    indices = _as_1d(indices, np.int64)
    new_values = np.asarray(new_values)
    if new_values.shape != indices.shape:
        raise PlanBuildError(
            f"indices and new_values disagree: {indices.shape} vs "
            f"{new_values.shape}")
    if indices.size and (
            int(indices.min()) < 0 or int(indices.max()) >= maps.nnz):
        raise PlanBuildError(
            f"nonzero indices out of range [0, {maps.nnz}): "
            f"[{int(indices.min())}, {int(indices.max())}]")
    return indices, new_values


def _set(leaf: torch.Tensor, slots: np.ndarray,
         values: np.ndarray) -> torch.Tensor:
    """A copy of ``leaf`` with the flat ``slots`` (unique) set to
    ``values``."""
    out = leaf.clone()
    flat = out.view(-1)
    flat[torch.from_numpy(slots).to(leaf.device)] = torch.from_numpy(
        values).to(leaf.device)
    return out


def update_values(plan: NeutronPlan, indices, new_values) -> NeutronPlan:
    """Set nonzeros ``indices`` (into the COO given to ``prepare``) to
    ``new_values``; returns the updated plan.

    The new plan has the same signature and shares ``derived`` (index
    arrays computed from the structure alone), so neither its executor nor
    those arrays are rebuilt; its tensors are bit-identical to
    re-preparing with the updated values.  ``new_values`` is a numpy array
    or a tensor on any device.

    One exception: a structured plan whose core values are touched comes
    back on the general payload, its signature demoted by
    ``plan_ir.general_format_sig``.
    """
    if isinstance(new_values, torch.Tensor):
        new_values = new_values.detach().cpu().numpy()
    if isinstance(plan, ShardedPlan):
        return _update_values_sharded(plan, indices, new_values)
    maps = plan.update_maps
    if maps is None:
        raise PlanBuildError(
            "plan carries no update maps (prepare builds them; a carried "
            "plan gets them from interop.update_maps_from_arrays)")
    indices, new_values = _validate_update(maps, indices, new_values)
    cur = maps.vals.copy()
    cur[indices] = new_values.astype(cur.dtype, copy=False)

    replacements: Dict[str, torch.Tensor] = {}
    core_ids, fringe_ids = _split_paths(maps, indices)
    if fringe_ids.size:
        v32 = cur[fringe_ids].astype(np.float32)
        replacements["fringe_vals"] = _set(
            plan.fringe_vals, maps.fringe_pos[fringe_ids], v32)
        if maps.kb_pos[fringe_ids[0]] >= 0:  # a real k-bucketed stream
            replacements["fringe_kb_vals"] = _set(
                plan.fringe_kb_vals, maps.kb_pos[fringe_ids], v32)
    if core_ids.size:
        touched, sums = _recompute_core_slots(maps, core_ids, cur)
        replacements["flat_values"] = _set(plan.flat_values, touched, sums)
        replacements["a_unsplittable"] = unsplittable_flag(
            replacements["flat_values"])
        if plan.matrix_format != "general":
            # the scatter stales the packed payload: demote to the (always
            # current) general leaves instead of re-packing per update
            dev = plan.device
            replacements.update(
                matrix_format="general", format_params=(0, 0),
                nm_values=torch.zeros((1, 1, 1), device=dev),
                nm_codes=torch.zeros((1, 1, 1), dtype=torch.int32,
                                     device=dev),
                bitmap_words=torch.zeros((1, 1, 1), dtype=torch.int32,
                                         device=dev),
                bitmap_values=torch.zeros((1, 1, 1), device=dev),
            )
    return dataclasses.replace(
        plan, update_maps=dataclasses.replace(maps, vals=cur), **replacements)


def _update_values_sharded(splan: ShardedPlan, indices,
                           new_values) -> ShardedPlan:
    """:func:`update_values` on a :class:`ShardedPlan`, as the reference's
    ``_update_values_sharded``: each touched shard's values are written
    through its own maps into a copy of its leaf (rows axis), or into a
    copy of each device's replica of the plan (rhs axis), so the old plan
    stays as it was.  A written leaf no longer views the stack the shards
    were uploaded in, so the new plan keeps none (``ShardedPlan.leaves``
    stacks on demand).  A shard whose tile values change gets its
    ``a_unsplittable`` again; shards keep their ``derived``."""
    maps = splan.update_maps
    if maps is None:
        raise PlanBuildError(
            "sharded plan carries no update maps; re-prepare_sharded to "
            "enable value updates")
    indices, new_values = _validate_update(maps, indices, new_values)
    cur = maps.vals.copy()
    cur[indices] = new_values.astype(cur.dtype, copy=False)

    leaves = [list(sh.leaves) for sh in splan.shards]
    copies: Dict[int, torch.Tensor] = {}   # id of a written leaf -> copy

    def write(s, li, slots, values):
        # rhs shards run one replicated plan: each device's replica (one
        # tensor, shared by the shards on that device) is written once
        owners = [s] if splan.shard_axis == "rows" else range(len(leaves))
        for t in owners:
            src = splan.shards[t].leaves[li]
            dest = copies.get(id(src))
            if dest is None:
                dest = copies[id(src)] = src.clone()
                dest.view(-1)[torch.from_numpy(slots).to(dest.device)] = (
                    torch.from_numpy(values).to(dest.device))
            leaves[t][li] = dest

    new_shard_maps = list(maps.shard_maps)
    for s in sorted_unique(maps.shard_of_nnz[indices]):
        s = int(s)
        sel = indices[maps.shard_of_nnz[indices] == s]
        um = maps.shard_maps[s]
        lcur = um.vals.copy()
        lcur[maps.local_of_nnz[sel]] = cur[sel].astype(lcur.dtype, copy=False)
        core_ids, fringe_ids = _split_paths(um, maps.local_of_nnz[sel])
        if fringe_ids.size:
            v32 = lcur[fringe_ids].astype(np.float32)
            write(s, LEAF_FRINGE_VALS, um.fringe_pos[fringe_ids], v32)
            kb = um.kb_pos[fringe_ids]
            if kb.size and kb[0] >= 0:
                write(s, LEAF_KB_VALS, kb, v32)
        if core_ids.size:
            touched, sums = _recompute_core_slots(um, core_ids, lcur)
            write(s, LEAF_FLAT_VALUES, touched, sums)
        new_shard_maps[s] = dataclasses.replace(um, vals=lcur)

    flags: Dict[int, torch.Tensor] = {}
    shards = []
    for sh, lv in zip(splan.shards, leaves):
        fv = lv[LEAF_FLAT_VALUES]
        flag = sh.a_unsplittable
        if fv is not sh.leaves[LEAF_FLAT_VALUES]:
            flag = flags.setdefault(id(fv), unsplittable_flag(fv))
        shards.append(PlanShard(tuple(lv), sh.derived, flag))
    return dataclasses.replace(
        splan, shards=tuple(shards),
        stacked=splan.stacked if not copies else None,
        update_maps=dataclasses.replace(
            maps, vals=cur, shard_maps=tuple(new_shard_maps)))
