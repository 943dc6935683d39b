"""Incremental plan maintenance over evolving sparse matrices: the port of
``repro.dynamic.delta``, single-device.

A prepared plan amortizes heavy host preprocessing (cost-model split,
reorder, tile-stream packing) over many executions of a fixed matrix.
This module keeps it valid under mutation instead of re-``prepare``-ing
per change, in three layers:

1. **Value-only fast path**: ``core.values.update_values`` writes new
   values of existing nonzeros into the plan's tensors, bit-identical to a
   fresh ``prepare``, with no executor build.
2. **Structural delta sidecar**: :class:`DynamicPlan` accumulates inserts
   and deletes in a capacity-padded COO (``plan_ir.DeltaFringe``), run on
   the card through the fringe kernels (B2's walk, or B3's on the
   k-sharded tier) and added to the base plan's merge in the same call
   (``exec.api.execute_with_delta``).  Deletes are negations of the base
   values, so the base tensors never change shape.  Capacity grows in
   powers of two, so a mutation stream builds executors logarithmically
   in its size.
3. **Cost-model compaction**: once the sidecar crosses the
   ``cost_model.should_compact`` thresholds (delta fraction or predicted
   fringe-path slowdown), it folds into a fresh ``prepare`` and resets.
   ``snapshot_for_compaction``/``build_compacted``/``adopt_compacted``
   split the fold so that a server can build the new plan elsewhere and
   swap it in.

The host loops over the mutated keys are the reference's, key by key
(ROADMAP A-queue 5 vectorises them).

All three layers work over a ``NeutronPlan`` and a ``ShardedPlan``.  The
sharded fast path writes into each shard's leaves; a rows-sharded plan's
sidecar is routed (``plan_ir.build_sharded_delta_fringe``: each delta row
to the shard that owns its output row, merged inside that shard's body),
an rhs-sharded plan's is one plain sidecar, replicated; either way a call
is one ``exec.api.execute_sharded`` dispatch, and a fold re-shards through
``prepare_sharded`` on the same mesh and axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core import spmm, tuner
from ..core.cost_model import (
    CompactionDecision, EngineCostModel, should_compact,
)
# DeltaFringe and build_delta_fringe are re-exported: plan_ir owns the
# sidecar's layout
from ..core.plan_ir import (  # noqa: F401
    PATH_FRINGE, DeltaFringe, NeutronPlan, ShardedDeltaFringe, ShardedPlan,
    ShardedUpdateMaps, build_delta_fringe, build_sharded_delta_fringe,
)
from ..core.values import _as_1d, update_values
from ..errors import PlanBuildError
from ..exec import api as exec_api
from ..obs import REGISTRY

PlanLike = Union[NeutronPlan, ShardedPlan]

_UPDATES = REGISTRY.counter(
    "dynamic_updates_total",
    "mutation batches applied to dynamic plans",
    labelnames=("route",),
)
_COMPACTIONS = REGISTRY.counter(
    "dynamic_compactions_total",
    "compaction lifecycle events across all dynamic plans",
    labelnames=("event",),
)


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One batch of mutations against an evolving sparse matrix.

    ``ins_*`` add nonzeros (adding to an existing entry accumulates, like
    COO duplicates), ``del_*`` remove structural entries, ``upd_*`` set the
    value of existing entries.  All arrays are host numpy and may be empty.
    Within one batch, deletes apply first, then inserts, then updates (see
    ``DynamicPlan.update``).
    """

    ins_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    ins_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    ins_vals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float64))
    del_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    del_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    upd_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    upd_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    upd_vals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float64))

    def __post_init__(self):
        for name in ("ins_rows", "ins_cols", "del_rows", "del_cols",
                     "upd_rows", "upd_cols"):
            object.__setattr__(self, name, _as_1d(getattr(self, name),
                                                  np.int64))
        for name in ("ins_vals", "upd_vals"):
            object.__setattr__(
                self, name, np.asarray(getattr(self, name), np.float64))
        if self.ins_rows.shape != self.ins_cols.shape or (
                self.ins_rows.shape != self.ins_vals.shape):
            raise PlanBuildError("insert triplet lengths disagree")
        if self.del_rows.shape != self.del_cols.shape:
            raise PlanBuildError("delete pair lengths disagree")
        if self.upd_rows.shape != self.upd_cols.shape or (
                self.upd_rows.shape != self.upd_vals.shape):
            raise PlanBuildError("update triplet lengths disagree")

    @classmethod
    def inserts(cls, rows, cols, vals) -> "GraphDelta":
        return cls(ins_rows=rows, ins_cols=cols, ins_vals=vals)

    @classmethod
    def deletes(cls, rows, cols) -> "GraphDelta":
        return cls(del_rows=rows, del_cols=cols)

    @classmethod
    def updates(cls, rows, cols, vals) -> "GraphDelta":
        return cls(upd_rows=rows, upd_cols=cols, upd_vals=vals)

    @property
    def size(self) -> int:
        return int(self.ins_rows.size + self.del_rows.size
                   + self.upd_rows.size)


class DynamicPlan:
    """A prepared plan that stays valid while its matrix evolves.

    Wraps a :class:`NeutronPlan` or :class:`ShardedPlan` with update maps
    and routes mutations to the cheapest layer that keeps the result
    right: value updates of
    existing entries are written in place, structural inserts and deletes
    accumulate in the :class:`DeltaFringe` sidecar, and the cost model
    folds the sidecar into a fresh ``prepare`` once it would dominate.
    """

    def __init__(
        self,
        plan: PlanLike,
        cost_model: Optional[EngineCostModel] = None,
        max_delta_fraction: Optional[float] = None,
        max_slowdown: Optional[float] = None,
        auto_compact: bool = True,
    ):
        if not isinstance(plan, (NeutronPlan, ShardedPlan)):
            raise TypeError(
                "DynamicPlan wraps a NeutronPlan or ShardedPlan, got "
                f"{type(plan).__name__}")
        if plan.update_maps is None:
            raise PlanBuildError(
                "DynamicPlan needs a plan with update maps (built by "
                "prepare()/prepare_sharded())")
        if plan.config.reorder_cols:
            raise PlanBuildError(
                "DynamicPlan does not support reorder_cols=True: sidecar "
                "columns address the un-permuted operand")
        self.plan = plan
        # the tuner's model (the analytic one unless config.autotune); the
        # compaction thresholds resolve explicit argument > cost model
        self.cost_model = (
            cost_model if cost_model is not None
            else tuner.resolve_cost_model(
                "spmm", int(plan.shape[0]), int(plan.shape[1]),
                int(plan.update_maps.nnz), plan.config))
        cm_fraction, cm_slowdown = self.cost_model.compaction_thresholds()
        self.max_delta_fraction = float(
            max_delta_fraction if max_delta_fraction is not None
            else cm_fraction)
        self.max_slowdown = float(
            max_slowdown if max_slowdown is not None else cm_slowdown)
        self.auto_compact = bool(auto_compact)
        # logical overlay: key -> target value (None = deleted base entry);
        # the sidecar stream is derived from it against the base values
        self._overlay: Dict[int, Optional[float]] = {}
        self._delta: Optional[DeltaFringe] = None  # built lazily
        self._capacity = 0
        self.compactions = 0
        self.last_decision: Optional[CompactionDecision] = None
        # monotone mutation counter: every state change (update, compact,
        # adopt) bumps it, so a fold built from a snapshot can tell that it
        # went stale before the swap
        self.version = 0
        # the compaction decision's base terms are constant between folds
        self._refresh_base_costs()

    def _refresh_base_costs(self) -> None:
        maps = self.maps
        if isinstance(maps, ShardedUpdateMaps):
            self._base_fringe_nnz = int(sum(
                int((um.path == PATH_FRINGE).sum())
                for um in maps.shard_maps))
        else:
            self._base_fringe_nnz = int((maps.path == PATH_FRINGE).sum())
        if isinstance(self.plan, NeutronPlan):
            self._base_core_rows = self.plan.num_windows * self.plan.config.bm
        else:
            self._base_core_rows = self.plan.shape[0]  # a bound, as there

    def refresh_cost_model(self) -> bool:
        """Resolve the cost model again; True if it changed.  Thresholds
        passed explicitly are kept; those that came from the model follow
        it."""
        was_fraction, was_slowdown = self.cost_model.compaction_thresholds()
        cm = tuner.resolve_cost_model(
            "spmm", int(self.plan.shape[0]), int(self.plan.shape[1]),
            int(self.plan.update_maps.nnz), self.plan.config)
        changed = (
            type(cm) is not type(self.cost_model)
            or cm.compaction_thresholds() != (was_fraction, was_slowdown))
        self.cost_model = cm
        new_fraction, new_slowdown = cm.compaction_thresholds()
        if self.max_delta_fraction == float(was_fraction):
            self.max_delta_fraction = float(new_fraction)
        if self.max_slowdown == float(was_slowdown):
            self.max_slowdown = float(new_slowdown)
        return changed

    # -- introspection ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return self.plan.shape

    @property
    def config(self) -> spmm.SpmmConfig:
        return self.plan.config

    @property
    def device(self) -> torch.device:
        return self.plan.device

    @property
    def maps(self):
        return self.plan.update_maps

    @property
    def delta_nnz(self) -> int:
        return len(self._overlay)

    @property
    def is_sharded(self) -> bool:
        return isinstance(self.plan, ShardedPlan)

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Current logical matrix as (rows, cols, vals) host triplets."""
        maps = self.maps
        k = self.shape[1]
        keys = maps.rows * np.int64(k) + maps.cols
        if self._overlay:
            okeys = np.fromiter(self._overlay, np.int64,
                                count=len(self._overlay))
            keep = ~np.isin(keys, okeys)
        else:
            keep = np.ones(keys.size, bool)
        rows = [maps.rows[keep]]
        cols = [maps.cols[keep]]
        vals = [maps.host_values()[keep].astype(np.float64)]
        live = [(key, t) for key, t in self._overlay.items()
                if t is not None]
        if live:
            lk = np.array([key for key, _ in live], np.int64)
            rows.append(lk // k)
            cols.append(lk % k)
            vals.append(np.array([t for _, t in live], np.float64))
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals))

    # -- mutation -----------------------------------------------------------
    def _base_key_sums(self, keys: np.ndarray) -> np.ndarray:
        """Total base value per key (duplicates accumulate)."""
        maps = self.maps
        vals = maps.host_values()
        lo = np.searchsorted(maps.key_sorted, keys, "left")
        hi = np.searchsorted(maps.key_sorted, keys, "right")
        out = np.zeros(keys.size, np.float64)
        for i in range(keys.size):  # delta-sized, not matrix-sized
            out[i] = float(
                vals[maps.key_order[lo[i]:hi[i]]].astype(np.float64).sum())
        return out

    def _dup_ids(self, key: int) -> np.ndarray:
        """All base nnz ids of one (row, col) key, in input order."""
        maps = self.maps
        lo = np.searchsorted(maps.key_sorted, key, "left")
        hi = np.searchsorted(maps.key_sorted, key, "right")
        return maps.key_order[lo:hi]  # stable sort: already input order

    def update(self, delta: GraphDelta) -> Dict[str, int]:
        """Apply one mutation batch; returns routing stats.

        Atomic: the whole batch is staged against copies (the overlay dict
        and a pending fast-path value map), so a validation error (delete
        of an absent entry, update of a deleted one) raises before any
        state changes.  Within a batch deletes apply first, then inserts,
        then updates: a delete + insert of one key replaces it, and an
        insert + update of a new key lands on the update.  Duplicate base
        triplets are one logical entry: an update sets the duplicates'
        *sum* (the first occurrence carries it, the rest go to zero), and
        inserts hitting one entry twice in a batch accumulate.
        """
        maps = self.maps
        m, k = self.shape
        for name, (r, c) in (
            ("insert", (delta.ins_rows, delta.ins_cols)),
            ("delete", (delta.del_rows, delta.del_cols)),
            ("update", (delta.upd_rows, delta.upd_cols)),
        ):
            if r.size and (
                r.min() < 0 or r.max() >= m or c.min() < 0 or c.max() >= k
            ):
                raise PlanBuildError(
                    f"{name} indices out of range for shape {self.shape}")

        # --- stage: no self.* mutation until the whole batch validates ---
        overlay = dict(self._overlay)
        pending: Dict[int, float] = {}  # nnz id -> staged new value

        def set_logical(key: int, value: float) -> None:
            """Fast path: make the duplicate-sum of ``key`` equal value."""
            dups = self._dup_ids(key)
            pending[int(dups[0])] = value
            for d in dups[1:]:
                pending[int(d)] = 0.0

        base = []  # the base values on the host, read once if needed

        def logical_value(key: int) -> float:
            if not base:
                base.append(maps.host_values())
            dups = self._dup_ids(key)
            return float(sum(
                pending.get(int(d), float(base[0][d])) for d in dups))

        # deletes first: remove a logical entry
        ids = maps.lookup(delta.del_rows, delta.del_cols)
        for j in range(delta.del_rows.size):
            key = int(delta.del_rows[j]) * k + int(delta.del_cols[j])
            if key in overlay:
                if overlay[key] is None:
                    raise PlanBuildError(
                        f"entry ({delta.del_rows[j]}, {delta.del_cols[j]}) "
                        "already deleted")
                if ids[j] >= 0:   # reinstated base entry -> deleted again
                    overlay[key] = None
                else:             # sidecar-only insert evaporates
                    del overlay[key]
            elif ids[j] >= 0:
                overlay[key] = None
            else:
                raise PlanBuildError(
                    f"delete of absent entry "
                    f"({delta.del_rows[j]}, {delta.del_cols[j]})")

        # inserts: add a value (accumulates onto existing entries)
        ids = maps.lookup(delta.ins_rows, delta.ins_cols)
        for j in range(delta.ins_rows.size):
            key = int(delta.ins_rows[j]) * k + int(delta.ins_cols[j])
            v = float(delta.ins_vals[j])
            if key in overlay:
                t = overlay[key]
                overlay[key] = v if t is None else t + v
            elif ids[j] >= 0:
                set_logical(key, logical_value(key) + v)
            else:
                overlay[key] = v

        # updates last: set the value of an existing logical entry (which a
        # same-batch insert may just have created)
        ids = maps.lookup(delta.upd_rows, delta.upd_cols)
        for j in range(delta.upd_rows.size):
            key = int(delta.upd_rows[j]) * k + int(delta.upd_cols[j])
            v = float(delta.upd_vals[j])
            if key in overlay:
                if overlay[key] is None:
                    raise PlanBuildError(
                        f"update of deleted entry "
                        f"({delta.upd_rows[j]}, {delta.upd_cols[j]})")
                overlay[key] = v
            elif ids[j] >= 0:
                set_logical(key, v)
            else:
                raise PlanBuildError(
                    f"update of absent entry "
                    f"({delta.upd_rows[j]}, {delta.upd_cols[j]}); use an "
                    "insert")

        # --- commit: batch validated end to end ---
        if pending:
            self.plan = update_values(
                self.plan,
                np.fromiter(pending, np.int64, count=len(pending)),
                np.asarray(list(pending.values())))
        structural = overlay != self._overlay
        self._overlay = overlay
        self.version += 1
        if structural:
            self._delta = None  # rebuilt lazily at the next execute

        _UPDATES.inc(route="structural" if structural else "fast_path")
        stats = {
            "fast_path": len(pending),
            "delta_nnz": self.delta_nnz,
            "compacted": 0,
        }
        self.last_decision = should_compact(
            self.cost_model,
            base_nnz=self.maps.nnz,
            delta_nnz=self.delta_nnz,
            core_rows=self._base_core_rows,
            fringe_nnz=self._base_fringe_nnz,
            k=k,
            max_delta_fraction=self.max_delta_fraction,
            max_slowdown=self.max_slowdown,
        )
        if self.auto_compact and self.last_decision.compact:
            self.compact()
            stats["compacted"] = 1
            stats["delta_nnz"] = 0
        return stats

    def compact(self) -> None:
        """Fold the delta sidecar into a fresh prepared plan (blocking)."""
        rows, cols, vals = self.to_coo()
        self.adopt_compacted(self.build_compacted(rows, cols, vals))

    def build_compacted(self, rows, cols, vals) -> PlanLike:
        """Prepare the folded plan for a ``to_coo`` snapshot, on the plan's
        device (a sharded plan: on its mesh and axis).  Changes nothing
        here, so it may run while the current plan keeps serving; pair
        with :meth:`snapshot_for_compaction` and :meth:`adopt_compacted`."""
        old = self.plan
        if isinstance(old, ShardedPlan):
            return spmm.prepare_sharded(
                rows, cols, vals, self.shape, old.mesh, old.config,
                self.cost_model, shard_axis=old.shard_axis,
                axis_name=old.axis_name)
        return spmm.prepare(rows, cols, vals, self.shape, old.config,
                            self.cost_model, device=old.device)

    def snapshot_for_compaction(self):
        """(version, rows, cols, vals) of the current logical matrix."""
        _COMPACTIONS.inc(event="snapshot")
        rows, cols, vals = self.to_coo()
        return self.version, rows, cols, vals

    def adopt_compacted(self, plan: PlanLike,
                        expected_version: Optional[int] = None) -> bool:
        """Swap in a compacted plan built from a snapshot.

        Returns False (and changes nothing) when ``expected_version`` no
        longer matches: mutations landed after the snapshot, so the folded
        plan is stale and the caller should snapshot again.
        """
        if expected_version is not None and expected_version != self.version:
            _COMPACTIONS.inc(event="stale")
            return False
        _COMPACTIONS.inc(event="adopt")
        self.plan = plan
        self._overlay = {}
        self._delta = None
        # capacity resets with the fold: keeping the historical maximum
        # would pad every later sidecar to the pre-fold delta size
        self._capacity = 0
        self.compactions += 1
        self.version += 1
        self._refresh_base_costs()
        return True

    # -- execution ----------------------------------------------------------
    def _materialize(self):
        """Build (or reuse) the sidecar stream for the current overlay, on
        the plan's device, with a fresh ``derived`` of its own.  A
        rows-sharded plan's is routed to the owning shards
        (``ShardedDeltaFringe``, each on its shard's device); an
        rhs-sharded plan's is one plain sidecar, replicated at dispatch."""
        if self._delta is not None:
            return self._delta
        maps = self.maps
        k = self.shape[1]
        keys = np.fromiter(self._overlay, np.int64,
                           count=len(self._overlay))
        targets = [self._overlay[int(key)] for key in keys]
        base = self._base_key_sums(keys)
        in_base = maps.lookup(keys // k, keys % k) >= 0
        vals = np.array([
            (-base[i] if t is None
             else (t - base[i] if in_base[i] else t))
            for i, t in enumerate(targets)
        ], np.float64)
        plan = self.plan
        if isinstance(plan, ShardedPlan) and plan.shard_axis == "rows":
            self._delta = build_sharded_delta_fringe(
                keys // k, keys % k, vals, plan, capacity=self._capacity)
        else:
            self._delta = build_delta_fringe(
                keys // k, keys % k, vals, self.shape, self.config,
                capacity=self._capacity, device=plan.device)
        self._capacity = self._delta.capacity  # grow-only: bounded builds
        return self._delta

    def execute(self, b: torch.Tensor) -> torch.Tensor:
        """C = A_current @ B: the base plan and the sidecar in one call.
        Differentiable in ``b`` on a single-device plan; on a sharded plan
        one ``execute_sharded`` dispatch, with the sidecar merged inside
        the shards' bodies."""
        base = self.plan
        if isinstance(base, ShardedPlan):
            return exec_api.execute_sharded(
                base, b, delta=self._materialize() if self._overlay else None)
        if not self._overlay:
            return exec_api.execute(base, b)
        return exec_api.execute_with_delta(base, self._materialize(), b)
