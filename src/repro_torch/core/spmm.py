"""NeutronSparse plan construction: ``prepare`` and ``prepare_sharded``.

``prepare`` runs the preprocessing pipeline of the paper's workflow
(Fig. 7) on the host, in numpy, exactly as ``repro.core.spmm.prepare``
does: cost-model split -> two-stage extraction -> global-local reorder ->
reuse-ordered flat tile stream -> packed fringe COO -> fringe tier ->
inverse row maps.  The leaves come out of :func:`build_plan_arrays` as
host arrays and are then moved to the plan's device in one step.

Structured lane: where the core tile stream has an N:M pattern that pays
(or a ``structure_hint`` asks for one), the stream is also packed into the
N:M or bitmap payload the structured kernels read, as the reference does;
the general stream always rides along.

``prepare_sharded`` balances row windows across a mesh's shards (or
replicates the plan and shards B's columns) and builds one padded
sub-plan per shard, as the reference does; see its section below.

Every dispatch decision consults the cost model that ``core.tuner``
resolves for the config: the analytic model, or with ``autotune`` the
measured table, whose tuned ``(bm, bk)`` applies before partitioning, as
in the reference.

Execution names (``execute``, ``execute_with_delta``,
``execute_delta_contribution``, the per-path executors, ``neutron_spmm``,
``NeutronSpMM``, ...) are forwarded lazily to ``repro_torch.exec.api``, as
the reference's ``_EXEC_FORWARDS`` do, so ``core`` never imports ``exec``
at import time; each forwarded access warns once per process that the
``sparse`` facade (or ``exec``) is the place to import them from.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..errors import PlanBuildError
from ..kernels.ops import effective_chunk
from ..obs import REGISTRY
from . import formats, partition, plan_ir, reorder, reuse
from .coordinator import (
    balance_row_window_list, list_imbalance, window_costs_from_coo,
)
from .cost_model import EngineCostModel, select_shard_axis
from .tuner import resolve_cost_model
from .plan_ir import (  # noqa: F401  (public re-exports, as the reference's)
    IMPL_DEVICE, LEAF_FLAT_VALUES, LEAF_FRINGE_VALS, LEAF_KB_VALS, PATH_CORE,
    PATH_FRINGE, PLAN_FORMAT_VERSION, NeutronPlan, ShardedPlan,
    ShardedUpdateMaps, SpmmConfig, UpdateMaps,
)

_PREPARES = REGISTRY.counter(
    "core_prepares_total", "host-side prepare() preprocessing runs")

# the structured payload leaves are (1, 1, 1) dummies on general plans
_DUMMY_F32 = np.zeros((1, 1, 1), np.float32)
_DUMMY_I32 = np.zeros((1, 1, 1), np.int32)


# execution API lives in repro_torch.exec.api; forwarded lazily so that
# importing the core layer never pulls the executor in
_EXEC_FORWARDS = (
    "execute", "execute_with_delta", "execute_sharded",
    "execute_delta_contribution", "execute_matrix_path",
    "execute_vector_path", "neutron_spmm", "SpMMOperator", "NeutronSpMM",
    "fused_trace_count", "sharded_trace_count", "dispatch_count",
)

_WARNED_FORWARD = False  # one DeprecationWarning per process, not per access


def __getattr__(name: str):
    if name in _EXEC_FORWARDS:
        global _WARNED_FORWARD
        if not _WARNED_FORWARD:
            import warnings

            _WARNED_FORWARD = True
            warnings.warn(
                "importing execution names from repro_torch.core.spmm is "
                "deprecated; use the repro_torch.sparse facade (or "
                "repro_torch.exec) instead",
                DeprecationWarning,
                stacklevel=2,
            )
        from ..exec import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXEC_FORWARDS))


def prepare_call_count() -> int:
    """Number of ``prepare()`` calls since process start (test hook)."""
    return int(_PREPARES.total())


def _structured_payload(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: Tuple[int, int],
    config: SpmmConfig,
    cm: EngineCostModel,
    flat_values: np.ndarray,
    has_core: bool,
    tile_density: float,
):
    """Choose and build the structured matrix-path payload, as the
    reference's ``_structured_payload`` does.

    Returns ``(matrix_format, format_params, (nm_values, nm_codes),
    (bitmap_words, bitmap_values))``.  The general flat stream is always
    kept beside it, so a format demotion never needs a re-prepare.
    """
    hint = config.structure_hint
    general = (
        "general", (0, 0), (_DUMMY_F32, _DUMMY_I32), (_DUMMY_I32, _DUMMY_F32)
    )
    if hint == "general" or not has_core:
        return general
    explicit_nm = (
        isinstance(hint, tuple) and len(hint) == 3 and hint[0] == "nm"
    )
    if config.reorder_cols:
        # the column permutation moves nonzeros across m-groups
        if explicit_nm or hint in ("nm", "bitmap"):
            raise PlanBuildError(
                "structure_hint is incompatible with reorder_cols=True: "
                "the column permutation destroys group-local structure"
            )
        return general
    nm_pat = None
    if explicit_nm:
        nm_pat = (int(hint[1]), int(hint[2]))
        if nm_pat[1] <= 0 or config.bk % nm_pat[1]:
            raise PlanBuildError(
                f"structure_hint {hint!r} needs m dividing bk={config.bk}"
            )
    elif hint in (None, "nm"):
        nm_pat = formats.detect_nm_pattern(rows, cols, shape)
        # tiles chunk columns at bk boundaries; groups must not straddle
        if nm_pat is not None and config.bk % nm_pat[1]:
            nm_pat = None
    t_steps, bm, bk = flat_values.shape
    # the bitmap row capacity the packer would choose, priced before the pack
    per_row_max = int(np.count_nonzero(flat_values, axis=2).max())
    row_cap_est = max(8, ((per_row_max + 7) // 8) * 8)
    fmt = cm.select_matrix_format(
        nm_pattern=nm_pat,
        tile_zero_fraction=1.0 - float(tile_density),
        num_steps=int(t_steps), bm=int(bm), bk=int(bk),
        row_cap=row_cap_est, hint=hint,
    )
    if fmt == "nm" and nm_pat is not None:
        n_pat, m_pat = nm_pat
        try:
            nm_values, nm_codes = formats.pack_nm_tiles(
                flat_values, n_pat, m_pat
            )
        except ValueError as e:
            if explicit_nm:
                raise PlanBuildError(
                    f"core tile stream violates the hinted {n_pat}:{m_pat} "
                    f"pattern: {e}"
                ) from e
            return general
        return (
            "nm", (n_pat, m_pat), (nm_values, nm_codes),
            (_DUMMY_I32, _DUMMY_F32),
        )
    if fmt == "bitmap":
        words, packed, row_cap = formats.pack_bitmap_tiles(flat_values)
        return (
            "bitmap", (int(words.shape[2]), int(row_cap)),
            (_DUMMY_F32, _DUMMY_I32), (words, packed),
        )
    return general


def build_plan_arrays(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    config: SpmmConfig = SpmmConfig(),
    cost_model: Optional[EngineCostModel] = None,
    _tune_tile_shape: bool = True,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Host-side preprocessing: the 19 plan leaves as numpy arrays + meta.

    ``meta`` is what :func:`plan_ir.plan_from_leaves` takes besides the
    leaves.  Runs no kernel and touches no device.  ``prepare_sharded``
    passes ``_tune_tile_shape=False`` to its per-shard builds, whose tile
    shape it resolved once at the global shape.
    """
    m, k = shape
    rows, cols, vals = plan_ir.validate_coo(rows, cols, vals, shape)
    _PREPARES.inc()
    # the analytic model unless config.autotune enables the measured table
    cm = cost_model if cost_model is not None else resolve_cost_model(
        "spmm", int(m), int(k), int(rows.shape[0]), config)
    # a tuned (bm, bk) applies before partitioning: the tile shape drives
    # window costs, the core/fringe split and every static plan shape
    if _tune_tile_shape and config.autotune:
        ts = cm.tile_shape(int(m), int(k), config.bn, int(rows.shape[0]))
        if ts is not None:
            config = dataclasses.replace(config, bm=int(ts[0]),
                                         bk=int(ts[1]))
    t0 = time.perf_counter()

    # 1) heterogeneous workload partitioning (§5.2)
    part = partition.partition_rows_cols(
        rows, cols, vals, shape, cm, alpha=config.alpha,
        col_stage=config.enable_col_stage,
    )
    t_part = time.perf_counter() - t0

    # 2) global-local reordering of the dense core (§6.1): only the active
    # (window, k-block) structure; tile values are written once, directly
    # into the flat stream (step 3)
    t0 = time.perf_counter()
    n_core = int(part.core_row_ids.shape[0])
    nw = (n_core + config.bm - 1) // config.bm
    nkb = (k + config.bk - 1) // config.bk
    if n_core:
        local_of_row = np.full(m, -1, np.int64)
        local_of_row[part.core_row_ids] = np.arange(n_core)
        lrows = local_of_row[part.core_rows]
        ro = reorder.reorder(
            lrows, part.core_cols, (n_core, k), config.bm, config.bk,
            enable_global=config.enable_global_reorder,
            enable_local=config.enable_local_reorder,
            reorder_cols=config.reorder_cols,
            max_clusters=config.max_clusters,
            seed=config.seed,
        )
        inv_col = np.empty(k, np.int64)
        inv_col[ro.col_order] = np.arange(k)
        ccols = inv_col[part.core_cols]
        inv_row = np.empty(n_core, np.int64)
        inv_row[ro.row_order] = np.arange(n_core)
        prow = inv_row[lrows]
        st = formats.block_structure_from_coo(
            prow // config.bm, ccols // config.bk, nw, nkb
        )
        block_cols = np.zeros((nw, st.max_blocks), np.int32)
        block_cols[st.uw, st.slot] = st.ub.astype(np.int32)
        num_blocks = st.counts
        cluster_of_window = ro.cluster_of_row[:: config.bm][:nw]
        col_perm = ro.col_order
        tile_density = part.core_nnz / max(
            st.uw.size * config.bm * config.bk, 1
        )
    else:
        st = None
        block_cols = np.zeros((0, 1), np.int32)
        num_blocks = np.zeros(0, np.int64)
        cluster_of_window = np.zeros(0, np.int64)
        col_perm = np.arange(k, dtype=np.int64)
        tile_density = 0.0
    t_reorder = time.perf_counter() - t0

    # 3) reuse-ordered flat tile stream (§6.2): pair p of window w sits at
    # stream position start(w) + slot(p); nonzeros land in their tile cell
    # through one flat scatter-add
    t0 = time.perf_counter()
    if config.enable_reuse_order and nw:
        plan_r = reuse.plan_window_order(
            block_cols, num_blocks, np.asarray(cluster_of_window)
        )
        worder = plan_r.window_order
        reuse_factor = plan_r.reuse_factor
    else:
        worder = np.arange(nw, dtype=np.int64)
        reuse_factor = 1.0
    if st is not None and st.uw.size:
        cnt = num_blocks[worder]
        total = int(cnt.sum())
        starts_w = np.zeros(nw, np.int64)
        starts_w[worder] = np.cumsum(cnt) - cnt
        step_of_pair = starts_w[st.uw] + st.slot
        step_window = np.zeros(total, np.int32)
        step_window[step_of_pair] = st.uw.astype(np.int32)
        step_col = np.zeros(total, np.int32)
        step_col[step_of_pair] = st.ub.astype(np.int32)
        lin = (
            step_of_pair[st.inv_idx] * config.bm + prow % config.bm
        ) * config.bk + ccols % config.bk
        flat = np.zeros(total * config.bm * config.bk, np.float32)
        np.add.at(flat, lin, part.core_vals.astype(np.float32))
        flat_values = flat.reshape(total, config.bm, config.bk)
        core_lin = lin
    else:  # degenerate all-fringe matrix: one zero tile keeps shapes static
        step_window = np.zeros(1, np.int32)
        step_col = np.zeros(1, np.int32)
        flat_values = np.zeros((1, config.bm, config.bk), np.float32)
        core_lin = np.zeros(0, np.int64)

    # 3b) structured matrix-path payload: the N:M pattern found on the
    # deduped cells (or an explicit hint), packed where the cost model
    # prices it below the general stream
    matrix_format, format_params, nm_payload, bitmap_payload = (
        _structured_payload(
            rows, cols, shape, config, cm, flat_values,
            has_core=bool(part.core_nnz), tile_density=float(tile_density),
        )
    )

    # map packed core rows -> original ids
    core_row_map = np.full(nw * config.bm, -1, np.int64)
    if n_core:
        core_row_map[:n_core] = part.core_row_ids[ro.row_order]
    core_row_map = core_row_map.astype(np.int32)

    # 4) fringe packing: one stable sort (rows are the major key, so row
    # runs come out contiguous); packed ids by run scan
    f_rows, f_cols, f_vals = part.fringe_rows, part.fringe_cols, part.fringe_vals
    if f_rows.size:
        order = np.argsort(f_rows * np.int64(k) + f_cols, kind="stable")
        sr = f_rows[order]
        first = np.concatenate([[True], sr[1:] != sr[:-1]])
        fringe_row_ids = sr[first]
        pr = (np.cumsum(first) - 1).astype(np.int32)
        pc = f_cols[order].astype(np.int32)
        pv = f_vals[order].astype(np.float32)  # kernels accumulate in fp32
        fringe_pos = np.empty(order.size, np.int64)
        fringe_pos[order] = np.arange(order.size)  # fringe entry -> slot
    else:
        fringe_row_ids = np.zeros(1, np.int64)
        pr = np.zeros(1, np.int32)
        pc = np.zeros(1, np.int32)
        pv = np.zeros(1, np.float32)
        fringe_pos = np.zeros(0, np.int64)

    # 4b) vector-path tier (the reference's arithmetic plus the H100 rule);
    # the k-bucketed stream is read only by the "cuda" streaming kernel
    k_pad = ((k + config.bk - 1) // config.bk) * config.bk
    fringe_tier, fringe_bk = cm.select_fringe_tier(
        k_pad, int(fringe_row_ids.shape[0]), config.bn,
        vmem_budget=config.fringe_vmem_budget, impl=config.impl,
    )
    if fringe_tier == "ksharded" and f_rows.size and config.impl == "cuda":
        kb_chunk, kb_rows, kb_cols, kb_vals, kb_pos_of_packed = (
            plan_ir.bucket_fringe_kblocks(
                pr, pc, pv, k_pad, fringe_bk,
                effective_chunk(config.fringe_chunk))
        )
    else:
        kb_chunk = np.zeros(1, np.int32)
        kb_rows = np.zeros(1, np.int32)
        kb_cols = np.zeros(1, np.int32)
        kb_vals = np.zeros(1, np.float32)
        kb_pos_of_packed = None

    # inverse row maps for the scatter-free merge (-1 = no contribution)
    gather_src_matrix = np.full(m, -1, np.int32)
    valid_slots = np.flatnonzero(core_row_map >= 0)
    gather_src_matrix[core_row_map[valid_slots]] = valid_slots
    gather_src_vector = np.full(m, -1, np.int32)
    if f_rows.size:
        gather_src_vector[fringe_row_ids] = np.arange(
            fringe_row_ids.size, dtype=np.int32
        )
    update_maps = plan_ir.build_update_maps(
        rows, cols, vals, shape, part, core_lin, fringe_pos,
        kb_pos_of_packed,
    )
    t_pack = time.perf_counter() - t0
    stats = (
        ("alpha", float(part.alpha)),
        ("nnz", int(part.nnz)),
        ("fringe_nnz", int(part.fringe_nnz)),
        ("core_nnz", int(part.core_nnz)),
        ("fringe_fraction", float(part.fringe_fraction())),
        ("tile_density", float(tile_density)),
        ("reuse_factor", float(reuse_factor)),
        ("num_windows", int(nw)),
        ("num_steps", int(step_window.shape[0])),
        ("t_partition_s", t_part),
        ("t_reorder_s", t_reorder),
        ("t_pack_s", t_pack),
        ("k_pad", k_pad),
        ("fringe_tier", fringe_tier),
        ("fringe_bk", int(fringe_bk)),
        ("matrix_format", matrix_format),
        ("format_params", tuple(format_params)),
        ("padding_waste",
         float(1.0 - tile_density) if part.core_nnz else 0.0),
    )
    leaves = {
        "step_window": step_window,
        "step_col": step_col,
        "flat_values": flat_values,
        "core_row_map": core_row_map,
        "fringe_rows": pr,
        "fringe_cols": pc,
        "fringe_vals": pv,
        "fringe_row_ids": fringe_row_ids.astype(np.int32),
        "col_perm": col_perm.astype(np.int32),
        "gather_src_matrix": gather_src_matrix,
        "gather_src_vector": gather_src_vector,
        "fringe_kb_chunk": kb_chunk,
        "fringe_kb_rows": kb_rows,
        "fringe_kb_cols": kb_cols,
        "fringe_kb_vals": kb_vals,
        "nm_values": nm_payload[0],
        "nm_codes": nm_payload[1],
        "bitmap_words": bitmap_payload[0],
        "bitmap_values": bitmap_payload[1],
    }
    meta = {
        "shape": tuple(shape),
        "config": config,
        "stats": stats,
        "fringe_tier": fringe_tier,
        "fringe_bk": int(fringe_bk),
        "matrix_format": matrix_format,
        "format_params": tuple(format_params),
        "update_maps": update_maps,
    }
    return leaves, meta


def prepare(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    config: SpmmConfig = SpmmConfig(),
    cost_model: Optional[EngineCostModel] = None,
    *,
    device: Any = None,
) -> NeutronPlan:
    """Host preprocessing, then the leaves moved to ``device``.

    ``device`` defaults to the one ``config.impl`` runs on ("cuda" for the
    kernels, "cpu" for the plain versions); a mismatched pair raises before
    any work is done.
    """
    if device is None:
        device = IMPL_DEVICE.get(config.impl, config.impl)
    plan_ir.check_impl_device(config.impl, device)
    leaves, meta = build_plan_arrays(rows, cols, vals, shape, config,
                                     cost_model)
    return plan_ir.plan_from_leaves(leaves, meta, device)


# --- multi-device sharded plan build ----------------------------------------
# The window-cost model that balances the two engine paths also balances
# shards: row windows are LPT-assigned to the mesh's shards over the cost
# model's window costs, each shard gets its own sub-plan, padded to
# mesh-uniform shapes so that one per-shard body serves every shard, and
# since every shard owns a disjoint set of output rows the merge is one
# gather of the concatenated packed blocks (no scatter, no sum).


def prepare_sharded(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    mesh: Any,
    config: SpmmConfig = SpmmConfig(),
    cost_model: Optional[EngineCostModel] = None,
    shard_axis: str = "auto",
    axis_name: Optional[str] = None,
) -> plan_ir.ShardedPlan:
    """Partition the SpMM across ``mesh`` (``distributed.SpmmMesh``) and
    build the per-shard plans, as the reference's ``prepare_sharded`` does.

    ``shard_axis="auto"`` lets ``cost_model.select_shard_axis`` choose
    between sharding output rows (balanced window lists, plan state
    distributed) and replicating the plan while sharding B's columns.  The
    host work is the reference's, so with ``impl="torch"`` the stacked
    leaves, signature, ``assemble`` and stats equal the reference's; with
    ``"cuda"`` the mesh-uniform fringe tier follows the H100 rule
    (``cost_model.select_fringe_tier``).  Each shard's leaves go to its
    device (``mesh.devices[s]``), which must suit ``config.impl``.
    """
    m, k = shape
    rows, cols, vals = plan_ir.validate_coo(rows, cols, vals, shape)
    if config.reorder_cols:
        raise ValueError(
            "prepare_sharded does not support reorder_cols=True: per-shard "
            "column permutations cannot share one B operand")
    axis_name = axis_name or mesh.axis_names[0]
    n_shards = int(mesh.shape[axis_name])
    devices = tuple(mesh.devices)
    for d in devices:
        plan_ir.check_impl_device(config.impl, d)
    cm = cost_model if cost_model is not None else resolve_cost_model(
        "spmm", int(m), int(k), int(rows.shape[0]), config)
    # the tuned (bm, bk) resolves once, at the global shape, so that the
    # window balance, the sub-plans and the signature share one tile shape
    if config.autotune:
        ts = cm.tile_shape(int(m), int(k), config.bn, int(rows.shape[0]))
        if ts is not None:
            config = dataclasses.replace(config, bm=int(ts[0]), bk=int(ts[1]))
    # sub-plans always take the general payload (structured leaves would
    # need mesh-uniform packed shapes); the plan keeps the caller's config
    shard_config = dataclasses.replace(config, structure_hint="general")

    wc = window_costs_from_coo(rows, m, config.bm, k, cm, alpha=config.alpha)
    decision = select_shard_axis(
        wc, n_shards, imbalance_threshold=cm.imbalance_threshold())
    if shard_axis == "auto":
        shard_axis = decision.shard_axis
    if shard_axis not in ("rows", "rhs"):
        raise ValueError(f"shard_axis must be rows|rhs|auto, got {shard_axis!r}")

    base_stats = (
        ("n_shards", n_shards),
        ("shard_axis", shard_axis),
        ("auto_shard_axis", decision.shard_axis),
        ("rows_imbalance_est", decision.rows_imbalance),
        ("num_windows_global", int(wc.shape[0])),
    )

    if shard_axis == "rhs":
        leaves, meta = build_plan_arrays(rows, cols, vals, shape,
                                         shard_config, cm,
                                         _tune_tile_shape=False)
        by_device = {d: plan_ir.plan_from_leaves(leaves, meta, d)
                     for d in dict.fromkeys(devices)}
        plan = by_device[devices[0]]
        um = meta["update_maps"]
        smaps = plan_ir.ShardedUpdateMaps(
            shape=tuple(shape), rows=um.rows, cols=um.cols, vals=um.vals,
            shard_of_nnz=np.zeros(um.nnz, np.int64),
            local_of_nnz=np.arange(um.nnz, dtype=np.int64),
            shard_maps=(um,), key_sorted=um.key_sorted,
            key_order=um.key_order)
        return plan_ir.ShardedPlan(
            shards=plan_ir.replicate_shards(by_device, devices),
            sig=plan.signature(), mesh=mesh, axis_name=axis_name,
            shard_axis="rhs", n_shards=n_shards, assemble=None,
            shape=tuple(shape), config=config,
            stats=base_stats + (("nnz", int(rows.shape[0])),),
            update_maps=smaps)

    # --- rows axis: LPT-balanced window lists -> per-shard sub-problems ---
    # empty windows are spread by row load after the LPT pass (fed to LPT
    # they would all land on one shard and inflate every shard's padding)
    nw = int(wc.shape[0])
    costed = np.flatnonzero(wc > 0)
    empty = np.flatnonzero(wc == 0)
    assign_costed = balance_row_window_list(wc[costed], n_shards)
    lists = [list(costed[a]) for a in assign_costed]
    rows_w_all = np.minimum(
        (np.arange(nw, dtype=np.int64) + 1) * config.bm, m
    ) - np.arange(nw, dtype=np.int64) * config.bm
    row_loads = np.array([int(rows_w_all[li].sum()) for li in lists])
    for w in empty:
        s = int(np.argmin(row_loads))
        lists[s].append(int(w))
        row_loads[s] += int(rows_w_all[w])
    assignment = [np.asarray(li, np.int64) for li in lists]
    imbalance = list_imbalance(assignment, wc) if nw else 1.0
    shard_of_window = np.zeros(nw, np.int64)
    local_window_start = np.zeros(nw, np.int64)
    m_loc = np.zeros(n_shards, np.int64)
    for s, wins in enumerate(assignment):
        wins = np.sort(wins)  # ascending original order within the shard
        sizes = np.minimum((wins + 1) * config.bm, m) - wins * config.bm
        starts = np.cumsum(sizes) - sizes
        shard_of_window[wins] = s
        local_window_start[wins] = starts
        m_loc[s] = int(sizes.sum())
    m_loc_max = int(m_loc.max()) if n_shards else 0

    # per-shard builds: each a self-contained (m_loc_max, k) problem over
    # locally relabelled rows, its fringe tier forced off (budget 0): the
    # mesh-uniform tier is chosen below from the largest shard
    sub_cfg = dataclasses.replace(shard_config, fringe_vmem_budget=0)
    row_window = rows // config.bm if rows.size else rows
    built = []
    shard_idx = []  # global nnz ids per shard
    for s in range(n_shards):
        mask = (shard_of_window[row_window] == s if rows.size
                else np.zeros(0, bool))
        local_rows = (
            local_window_start[row_window[mask]] + rows[mask] % config.bm)
        shard_idx.append(np.flatnonzero(mask))
        built.append(build_plan_arrays(
            local_rows, cols[mask], vals[mask], (m_loc_max, k), sub_cfg, cm,
            _tune_tile_shape=False))

    # --- mesh-uniform static structure: pad every leaf to the max ---------
    cfg = config
    k_pad = ((k + cfg.bk - 1) // cfg.bk) * cfg.bk
    sub_stats = [dict(meta["stats"]) for _, meta in built]
    nw_max = max(lv["core_row_map"].shape[0] // cfg.bm for lv, _ in built)
    t_max = max(lv["step_window"].shape[0] for lv, _ in built)
    nnzf_max = max(lv["fringe_rows"].shape[0] for lv, _ in built)
    nfr_max = max(lv["fringe_row_ids"].shape[0] for lv, _ in built)
    has_core = any(bool(st["core_nnz"]) for st in sub_stats)
    has_fringe = any(bool(st["fringe_nnz"]) for st in sub_stats)
    u_tier, u_bk = cm.select_fringe_tier(
        k_pad, nfr_max, cfg.bn, vmem_budget=cfg.fringe_vmem_budget,
        impl=cfg.impl)
    chunk_eff = effective_chunk(cfg.fringe_chunk)

    kb_streams = []
    for (lv, _), st in zip(built, sub_stats):
        if u_tier == "ksharded" and st["fringe_nnz"] and cfg.impl == "cuda":
            kb_streams.append(plan_ir.bucket_fringe_kblocks(
                lv["fringe_rows"], lv["fringe_cols"], lv["fringe_vals"],
                k_pad, u_bk, chunk_eff))
        else:
            kb_streams.append((
                np.zeros(1, np.int32), np.zeros(1, np.int32),
                np.zeros(1, np.int32), np.zeros(1, np.float32), None))
    nch_max = max(kb[0].shape[0] for kb in kb_streams)
    nnzkb_max = max(kb[1].shape[0] for kb in kb_streams)

    # one more window for the kernels: padded tile steps address window
    # nw_max, never a real slot (see stack_shard_leaves)
    nw_kernel = nw_max + 1
    shard_leaves = [tuple(lv[name] for name in plan_ir.EXEC_LEAF_NAMES)
                    for lv, _ in built]
    stacked = plan_ir.stack_shard_leaves(
        shard_leaves, kb_streams, t_max, nw_max, nnzf_max, nch_max,
        nnzkb_max)
    real_counts = [(lv["step_window"].shape[0], lv["fringe_rows"].shape[0],
                    kb[1].shape[0]) for (lv, _), kb in zip(built, kb_streams)]
    del shard_leaves

    sig = (
        plan_ir.PLAN_FORMAT_VERSION,
        (m_loc_max, k), cfg.bm, cfg.bk, cfg.bn, cfg.impl, cfg.reorder_cols,
        cfg.fringe_chunk, nw_kernel, t_max, nnzf_max, nfr_max,
        has_core, has_fringe, u_tier, int(u_bk), nch_max, nnzkb_max,
        "general", (0, 0),
    )

    # COO->slot maps: the shards' own maps (padding appends, so their
    # slots stay valid in the stacked leaves), with kb_pos bucketed again
    # under the mesh-uniform tier
    shard_of_nnz = (shard_of_window[row_window] if rows.size
                    else np.zeros(0, np.int64))
    local_of_nnz = np.zeros(rows.shape[0], np.int64)
    shard_maps = []
    for s, ((_, meta), kb) in enumerate(zip(built, kb_streams)):
        local_of_nnz[shard_idx[s]] = np.arange(shard_idx[s].size)
        um = meta["update_maps"]
        if kb[4] is not None:
            kb_pos = np.where(um.fringe_pos >= 0,
                              kb[4][np.clip(um.fringe_pos, 0, None)], -1)
        else:
            kb_pos = np.full(um.nnz, -1, np.int64)
        shard_maps.append(dataclasses.replace(um, kb_pos=kb_pos))
    key_sorted, key_order = plan_ir.build_key_index(rows, cols, k)
    smaps = plan_ir.ShardedUpdateMaps(
        shape=tuple(shape), rows=rows, cols=cols, vals=vals.copy(),
        shard_of_nnz=shard_of_nnz, local_of_nnz=local_of_nnz,
        shard_maps=tuple(shard_maps), key_sorted=key_sorted,
        key_order=key_order)

    # original row r lives in shard shard_of_window[r // bm] at local slot
    # local_window_start[..] + r % bm; the concatenated blocks are
    # row-major in (shard, local), so one flat index gathers C
    if m:
        rw = np.arange(m, dtype=np.int64) // cfg.bm
        assemble = (
            shard_of_window[rw] * m_loc_max
            + local_window_start[rw] + np.arange(m, dtype=np.int64) % cfg.bm
        ).astype(np.int32)
    else:
        assemble = np.zeros(0, np.int32)

    stats = base_stats + (
        ("rows_imbalance", float(imbalance)),
        ("shard_rows", tuple(int(x) for x in m_loc)),
        ("shard_nnz", tuple(int(st["nnz"]) for st in sub_stats)),
        ("rows_per_shard_padded", m_loc_max),
        ("fringe_tier", u_tier),
        ("fringe_bk", int(u_bk)),
    )
    del built
    shards, stack_t = plan_ir.place_shards(stacked, devices, real_counts)
    return plan_ir.ShardedPlan(
        shards=shards, sig=sig, mesh=mesh, axis_name=axis_name,
        shard_axis="rows", n_shards=n_shards,
        assemble=torch.from_numpy(assemble).to(devices[0]),
        shape=tuple(shape), config=config, stats=stats, update_maps=smaps,
        rows_per_shard=m_loc_max, stacked=stack_t)
