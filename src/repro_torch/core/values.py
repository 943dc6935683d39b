"""Value-only plan updates: the first layer of ``repro.dynamic.delta``.

:func:`update_values` (some nonzeros) and :func:`set_values` (every
nonzero, what ``SparseMatrix.with_values`` calls) write new nonzero values
straight into a prepared plan's tensors (flat tile stream, packed fringe,
k-bucketed stream) with gathers and scatters on the plan's device, through
the COO->slot maps ``prepare`` builds (:class:`~repro_torch.core.plan_ir.
UpdateMaps`): :func:`set_values` through their layout on the device, built
once per structure (:func:`value_slots`, kept in ``plan.derived``);
:func:`update_values` through the slots of the touched nonzeros alone.
Every shape stays, so the plan keeps its signature and its cached
executor.

The written leaves are bit-identical to a fresh ``prepare`` of the new
values.  A fringe slot holds one nonzero's fp32 value.  A tile cell holds
the fp32 sum, from zero and in input order, of the nonzeros that land in
it, as ``prepare``'s sequential ``np.add.at`` left it: the cells are summed
by rank, the first contributor of every cell in one gather, then the
second of every cell that has one, and so on, each an add on distinct
cells, so the order of each cell's sum is kept and no atomics run.  (A
scatter that adds value deltas would not be exact: ``a + (b - a) != b`` in
fp32.)

Where the core values change, the plan's ``a_unsplittable`` flag is
computed again from the new tile stream (it lives on the plan, not in the
shared ``derived``).

The update is functional: the touched leaves are copied first, and the
original plan is left as it was.  At Reddit scale under the H100 split
the copies are 0.84 GB of tiles and 0.37 GB of fringe values for as long
as both plans live.  The maps' values (``update_maps.vals``, on the
plan's device) are copied and written there too.

A structured plan (``matrix_format`` "nm" or "bitmap") whose core values
change is demoted to the general payload, as in the reference: the packed
stream would go stale, and the general leaves are always kept current.
The demotion changes the signature once (to ``general_format_sig`` of the
old one); later updates keep it.

Each update of a single-device plan is a ``with_values`` span
(``obs.TRACES``): recorded when the plan's telemetry is on or a profiler
session is active, one call in ``TIME_EVERY`` timed on the card.

It lives in ``core`` because the executor's backward (``exec.api``) writes
values into the transpose structure with it, and ``exec`` sits below
``dynamic``; ``repro_torch.dynamic.update_values`` is the public name, as
in the reference.  On a ``ShardedPlan`` both write on the host through
each shard's own maps (:func:`_update_values_sharded`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..errors import PlanBuildError
from ..obs import TRACES
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


class CellSums(NamedTuple):
    """Tile cells and the nonzeros summed into them, on the plan's device
    (int64): ``slots``, the cells' flat slots in ``flat_values``, sorted;
    ``first``, each cell's first contributor in input order; ``later``,
    for the second contributor on, one ``(cell index, nonzero)`` pair of
    arrays per rank, each holding every cell that has that many
    contributors."""
    slots: torch.Tensor
    first: torch.Tensor
    later: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


class FringeSlots(NamedTuple):
    """Nonzeros on the fringe path, on the plan's device (int64): ``ids``,
    in input order; ``slots``, theirs in ``fringe_vals``; ``kb_slots``, in
    ``fringe_kb_vals``, where the plan has a real k-bucketed stream (None
    otherwise)."""
    ids: torch.Tensor
    slots: torch.Tensor
    kb_slots: Optional[torch.Tensor]


class ValueSlots(NamedTuple):
    """Where every nonzero's value lands in a plan's leaves."""
    fringe: FringeSlots
    core: CellSums


def _up(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _cell_sums(lin: torch.Tensor, members: torch.Tensor) -> CellSums:
    """:class:`CellSums` of contributors ``members`` to cells ``lin``,
    sorted by (cell, input order) as ``UpdateMaps.core_lin_sorted`` and
    ``core_members_sorted`` hold them (one host read: the largest number
    of contributors to one cell)."""
    first = torch.ones(lin.numel(), dtype=torch.bool, device=lin.device)
    first[1:] = lin[1:] != lin[:-1]
    cell = torch.cumsum(first, 0) - 1
    starts = torch.nonzero(first).squeeze(1)
    rank = torch.arange(lin.numel(), device=lin.device) - starts[cell]
    later = []
    for r in range(1, int(rank.max()) + 1 if rank.numel() else 1):
        at = rank == r
        later.append((cell[at], members[at]))
    return CellSums(lin[first], members[first], tuple(later))


def _fringe_slots(maps: UpdateMaps, ids: np.ndarray, dev) -> FringeSlots:
    """:class:`FringeSlots` of fringe nonzeros ``ids``, their slots read
    on the host."""
    kb = None
    if ids.size and maps.kb_pos[ids[0]] >= 0:  # a real k-bucketed stream
        kb = _up(maps.kb_pos[ids], dev)
    return FringeSlots(_up(ids, dev), _up(maps.fringe_pos[ids], dev), kb)


def value_slots(plan: NeutronPlan) -> ValueSlots:
    """:class:`ValueSlots` of the plan's structure, built on its device on
    first use and kept in ``plan.derived``."""
    cached = plan.derived.get("value_slots")
    if cached is not None:
        return cached
    maps = _maps_of(plan)
    dev = plan.device
    slots = ValueSlots(
        _fringe_slots(maps, np.flatnonzero(maps.path == PATH_FRINGE), dev),
        _cell_sums(_up(maps.core_lin_sorted, dev),
                   _up(maps.core_members_sorted, dev)))
    plan.derived["value_slots"] = slots
    return slots


def _maps_of(plan: NeutronPlan) -> UpdateMaps:
    maps = plan.update_maps
    if maps is None:
        raise PlanBuildError(
            "plan carries no update maps (prepare builds them; a carried "
            "plan gets them from interop.update_maps_from_arrays)")
    return maps


def _scatter(leaf: torch.Tensor, slots: torch.Tensor,
             values: torch.Tensor) -> torch.Tensor:
    """A copy of ``leaf`` with its flat ``slots`` (distinct) set to
    ``values``."""
    out = leaf.clone()
    out.view(-1)[slots] = values
    return out


def _write(plan: NeutronPlan, maps: UpdateMaps, cur: torch.Tensor,
           fringe: Optional[FringeSlots],
           core: Optional[CellSums]) -> NeutronPlan:
    """The plan with the ``fringe`` slots and ``core`` cells written from
    ``cur`` (every nonzero's value, on the plan's device), and ``cur`` as
    its maps' values."""
    v32 = cur.to(torch.float32)
    replacements: Dict[str, object] = {}
    if fringe is not None and fringe.ids.numel():
        fv = v32[fringe.ids]
        replacements["fringe_vals"] = _scatter(plan.fringe_vals,
                                               fringe.slots, fv)
        if fringe.kb_slots is not None:
            replacements["fringe_kb_vals"] = _scatter(plan.fringe_kb_vals,
                                                      fringe.kb_slots, fv)
    if core is not None and core.slots.numel():
        # prepare's np.add.at: each cell from zero, its nonzeros in order
        sums = torch.zeros(core.slots.numel(), dtype=torch.float32,
                           device=v32.device).add_(v32[core.first])
        for cell, ids in core.later:
            sums[cell] += v32[ids]
        flat = _scatter(plan.flat_values, core.slots, sums)
        replacements["flat_values"] = flat
        replacements["a_unsplittable"] = unsplittable_flag(flat)
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
        plan, update_maps=dataclasses.replace(maps, vals=cur),
        **replacements)


def set_values(plan, values):
    """Every nonzero's value at once: ``values`` (nnz,) in the input COO
    order, a tensor on any device or a numpy array; returns the updated
    plan, as :func:`update_values` of every index would, without a round
    trip through the host: the values are cast to the maps' dtype on the
    plan's device and stay there."""
    if isinstance(plan, ShardedPlan):
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        return _update_values_sharded(plan, np.arange(np.shape(values)[0]),
                                      values)
    maps = _maps_of(plan)
    with TRACES.call("with_values", plan.config.telemetry, plan.device):
        if not isinstance(values, torch.Tensor):
            values = torch.from_numpy(np.asarray(values))
        if tuple(values.shape) != (maps.nnz,):
            raise PlanBuildError(
                f"set_values needs one value per nonzero: got shape "
                f"{tuple(values.shape)} for nnz={maps.nnz}")
        cur = values.detach().to(plan.device, maps.vals.dtype, copy=True)
        slots = value_slots(plan)
        return _write(plan, maps, cur, slots.fringe, slots.core)


def _recompute_core_slots(
    maps: UpdateMaps, touched_ids: np.ndarray, cur: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact new contents of every tile cell touched by the given nonzeros,
    on the host (a ``ShardedPlan``'s shards; :func:`_touched_cells` is its
    form on the device).

    Duplicates accumulate into one cell, so each touched flat slot is
    recomputed from all its contributors in input order, replaying the
    sequential fp32 ``np.add.at`` that first filled it.  ``touched_ids``
    are unique core nonzeros; when they are all of them (``set_values``),
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
    # ids already sorted and unique (set_values passes arange(nnz)) skip
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


def _touched_cells(maps: UpdateMaps, core_ids: np.ndarray,
                   dev) -> CellSums:
    """:class:`CellSums` of the tile cells that unique core nonzeros
    ``core_ids`` land in, with every contributor of each (duplicates
    accumulate into one cell, so a touched cell is summed again whole)."""
    touched = sorted_unique(maps.core_lin[core_ids])
    lo = np.searchsorted(maps.core_lin_sorted, touched, "left")
    hi = np.searchsorted(maps.core_lin_sorted, touched, "right")
    counts = hi - lo
    starts = np.cumsum(counts) - counts
    flatpos = (np.arange(int(counts.sum())) - np.repeat(starts, counts)
               + np.repeat(lo, counts))
    return _cell_sums(_up(maps.core_lin_sorted[flatpos], dev),
                      _up(maps.core_members_sorted[flatpos], dev))


def update_values(plan: NeutronPlan, indices, new_values) -> NeutronPlan:
    """Set nonzeros ``indices`` (into the COO given to ``prepare``) to
    ``new_values``; returns the updated plan.

    The new plan has the same signature and shares ``derived`` (index
    arrays computed from the structure alone), so neither its executor nor
    those arrays are rebuilt; its tensors are bit-identical to
    re-preparing with the updated values.  ``new_values`` is a numpy array
    or a tensor on any device; where an index repeats, its last value
    holds.  Only the touched fringe slots and tile cells are written: the
    slots are found on the host, the values written on the plan's device.

    One exception: a structured plan whose core values are touched comes
    back on the general payload, its signature demoted by
    ``plan_ir.general_format_sig``.
    """
    if isinstance(new_values, torch.Tensor):
        new_values = new_values.detach().cpu().numpy()
    if isinstance(plan, ShardedPlan):
        return _update_values_sharded(plan, indices, new_values)
    maps = _maps_of(plan)
    with TRACES.call("with_values", plan.config.telemetry, plan.device):
        indices, new_values = _validate_update(maps, indices, new_values)
        # sorted and unique, the last value of a repeated index kept
        indices, last = np.unique(indices[::-1], return_index=True)
        new_values = new_values[::-1][last]
        dev = plan.device
        cur = maps.vals.clone()
        cur[_up(indices, dev)] = _up(new_values, dev).to(cur.dtype)
        core_ids, fringe_ids = _split_paths(maps, indices)
        return _write(
            plan, maps, cur,
            _fringe_slots(maps, fringe_ids, dev) if fringe_ids.size else None,
            _touched_cells(maps, core_ids, dev) if core_ids.size else None)


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
        lcur = um.host_values().copy()
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
        new_shard_maps[s] = dataclasses.replace(um,
                                                vals=torch.from_numpy(lcur))

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
