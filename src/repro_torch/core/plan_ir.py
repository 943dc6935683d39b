"""Plan IR: the static representation the executor consumes.

A :class:`NeutronPlan` holds the 19 leaves of ``repro.core.plan_ir``'s plan,
as tensors on one device, in the same order and with the same contents:

- matrix path: the flat active-tile stream (``step_window``, ``step_col``,
  ``flat_values``) and the packed-row map;
- vector path: the packed row-sorted fringe COO, and the k-bucketed copy of
  it that the streaming tier reads (1-element dummies unless that tier and
  the ``"cuda"`` impl are selected);
- the scatter-free merge: inverse row maps from each original row to its
  packed slot on either path (-1 when the path does not touch the row);
- the four structured-lane payloads: the N:M or bitmap encoding of the
  flat tile stream where ``matrix_format`` selects one, (1, 1, 1) dummies
  otherwise.  The general stream is always kept beside them.

``plan_leaves`` gives the 17-leaf executor order of the reference, and
``signature()`` the same structure key.  Besides the leaves a plan carries
``derived``: index arrays the kernel wrappers derive from the structure on
the device (window segment offsets and their chunk table, CSR row offsets,
the row-major order of the k-bucketed stream, the SDDMM maps), built once
on first use, never part of the leaf set, and shared by the plans a value
update makes.  And it carries ``a_unsplittable``, a device flag computed
from the matrix-path values themselves (:func:`unsplittable_flag`), which
a value update recomputes.

A dynamic plan's structural delta rides beside a plan as a
:class:`DeltaFringe`: the reference's capacity-padded sidecar (eight
leaves and a signature, :func:`build_delta_fringe`), with a ``derived``
cache of its own.

A :class:`ShardedPlan` holds one :class:`PlanShard` per shard of a mesh
(``distributed.SpmmMesh``): on the rows axis each shard's sub-plan padded
to one mesh-uniform signature (:func:`stack_shard_leaves`, the
reference's stacked leaves), on the rhs axis the one plan replicated;
each shard has its own ``derived`` and ``a_unsplittable``.  Its COO maps
are :class:`ShardedUpdateMaps`, and a rows plan's sidecar is a
:class:`ShardedDeltaFringe` routed to the owning shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import PlanBuildError
from .cost_model import select_fringe_tier

PLAN_FORMAT_VERSION = 2

PATH_CORE = 0
PATH_FRINGE = 1

# SpmmConfig.impl values and the device type each one runs on
IMPL_DEVICE = {"cuda": "cuda", "torch": "cpu"}

# fixed positions inside ``NeutronPlan.signature()`` tuples, as in the
# reference
SIG_IMPL = 5
SIG_FRINGE_TIER = 14
SIG_MATRIX_FORMAT = 18
SIG_FORMAT_PARAMS = 19

# matrix-path payload encodings (core.formats pack/unpack pairs); the
# signature carries the format, so structured and general plans never share
# one cached executor
MATRIX_FORMATS = ("general", "nm", "bitmap")


@dataclasses.dataclass(frozen=True)
class SpmmConfig:
    bm: int = 128
    bk: int = 64
    bn: int = 256
    alpha: Optional[float] = None          # override Eq. 3 threshold
    enable_global_reorder: bool = True
    enable_local_reorder: bool = True
    reorder_cols: bool = False             # requires caller to pre-permute B
    enable_col_stage: bool = True          # stage-2 column extraction
    enable_reuse_order: bool = True
    max_clusters: int = 64
    # "cuda": the hand-written Hopper kernels, on CUDA tensors;
    # "torch": the plain versions, on CPU tensors
    impl: str = "cuda"
    fringe_chunk: Optional[int] = None     # nonzeros per fringe step
    fringe_vmem_budget: Optional[int] = None  # override dispatch-tier budget
    seed: int = 0
    # capacity of the process-wide executor cache (repro_torch.exec)
    executor_cache_capacity: Optional[int] = None
    # measured dispatch decisions are not ported yet (ROADMAP: "Tuner and
    # cost model, re-derived for the H100"): only False is accepted
    autotune: Any = False
    # structured-sparsity hint for the matrix-path payload format:
    #   None          — detect at prepare time, cost model decides
    #   "general"     — force the flat tile stream (skip detection)
    #   "nm"          — use the detected N:M packing; general if none
    #   ("nm", n, m)  — assert this exact N:M pattern; PlanBuildError if the
    #                   core stream does not satisfy it
    #   "bitmap"      — force the bitmap payload (unless it would grow)
    structure_hint: Optional[Any] = None
    # host-side telemetry (repro_torch.obs): per-dispatch roofline profiling
    # and facade traces.  Never part of signature() or the executor cache
    # key: toggling it changes no launch and no output bit.
    telemetry: bool = False


# --- operator tagging --------------------------------------------------------
# Operators other than SpMM on the same plan structure (SDDMM) reuse the plan
# signature with a trailing ("op", name, *extra) marker, so that (op,
# signature) pairs never alias each other's cached executors while
# ``sig[0]`` stays the plan format version.

OP_TAG = "op"


def _op_tag(sig: Tuple) -> Optional[Tuple]:
    if (isinstance(sig, tuple) and sig and isinstance(sig[-1], tuple)
            and sig[-1] and sig[-1][0] == OP_TAG):
        return sig[-1]
    return None


def sig_impl(sig: Tuple) -> Optional[str]:
    """The kernel impl of a plan-style signature; None for other tuples."""
    if isinstance(sig, tuple) and len(sig) > SIG_IMPL and \
            sig[0] == PLAN_FORMAT_VERSION:
        return sig[SIG_IMPL]
    return None


def sig_matrix_format(sig: Tuple) -> Optional[str]:
    """The matrix-path payload format of a plan-style signature; None for
    other tuples."""
    if sig_impl(sig) is not None and len(sig) > SIG_MATRIX_FORMAT:
        return sig[SIG_MATRIX_FORMAT]
    return None


def general_format_sig(sig: Tuple) -> Tuple:
    """The same plan signature demoted to the general (flat tile) payload.

    Structured plans keep their general leaves beside the packed ones, so a
    value update demotes the format fields rather than re-packing.
    """
    if sig_matrix_format(sig) in (None, "general"):
        return sig
    demoted = list(sig)
    demoted[SIG_MATRIX_FORMAT] = "general"
    demoted[SIG_FORMAT_PARAMS] = (0, 0)
    return tuple(demoted)


def tag_op(sig: Tuple, op: str, *extra) -> Tuple:
    """Suffix a plan signature with an operator tag (hashable extras only)."""
    if sig_impl(sig) is None:
        raise ValueError(f"not a plan-style signature: {sig!r}")
    return sig + ((OP_TAG, op) + tuple(extra),)


def sig_op(sig: Tuple) -> str:
    """Operator name of a signature ("spmm" when untagged)."""
    tag = _op_tag(sig)
    return "spmm" if tag is None else tag[1]


def op_extra(sig: Tuple) -> Tuple:
    """The tag's extra payload (empty for untagged signatures)."""
    tag = _op_tag(sig)
    return () if tag is None else tuple(tag[2:])


def untag_sig(sig: Tuple) -> Tuple:
    """The base plan signature with any operator tag stripped."""
    return sig if _op_tag(sig) is None else sig[:-1]


def check_impl_device(impl: str, device: Any) -> torch.device:
    """The device for ``impl``; raises for any other pairing.

    ``"cuda"`` runs only on CUDA tensors and ``"torch"`` only on CPU ones:
    neither falls back to the other.
    """
    if impl not in IMPL_DEVICE:
        raise PlanBuildError(
            f"impl must be one of {sorted(IMPL_DEVICE)}, got {impl!r}")
    device = torch.device(device)
    if device.type != IMPL_DEVICE[impl]:
        raise PlanBuildError(
            f'impl={impl!r} runs on {IMPL_DEVICE[impl]} tensors, not on '
            f'{device}; use impl="cuda" with a CUDA device or impl="torch" '
            'with device="cpu"'
        )
    if device.type == "cuda" and not torch.cuda.is_available():
        raise PlanBuildError(
            "impl='cuda' needs a CUDA device and none is available; pass "
            "device='cpu' (impl='torch') to run the plain versions")
    return device


@dataclasses.dataclass
class UpdateMaps:
    """Host-side COO->slot inverse maps, built once at ``prepare()`` time.

    For every input nonzero ``j`` the maps record which plan slot its value
    landed in; ``rows``/``cols``/``vals`` keep the validated input COO.
    """

    shape: Tuple[int, int]
    rows: np.ndarray             # (nnz,) int64 original COO rows
    cols: np.ndarray             # (nnz,) int64 original COO cols
    vals: np.ndarray             # (nnz,) current values (input dtype)
    path: np.ndarray             # (nnz,) int8 PATH_CORE | PATH_FRINGE
    core_lin: np.ndarray         # (nnz,) int64 flat slot in flat_values, -1
    fringe_pos: np.ndarray       # (nnz,) int64 packed fringe slot, -1
    kb_pos: np.ndarray           # (nnz,) int64 k-bucketed stream slot, -1
    core_lin_sorted: np.ndarray     # core slots sorted
    core_members_sorted: np.ndarray  # nnz ids sorted by (slot, input order)
    key_sorted: np.ndarray
    key_order: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def lookup(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """nnz ids of the given (row, col) pairs; -1 where absent (the
        first occurrence of a duplicated pair)."""
        keys = np.asarray(rows, np.int64) * self.shape[1] + np.asarray(
            cols, np.int64)
        if self.key_sorted.size == 0:
            return np.full(keys.shape, -1, np.int64)
        pos = np.minimum(np.searchsorted(self.key_sorted, keys),
                         self.key_sorted.size - 1)
        found = self.key_sorted[pos] == keys
        return np.where(found, self.key_order[pos], -1)


def build_key_index(
    rows: np.ndarray, cols: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    key = rows.astype(np.int64) * k + cols
    order = np.argsort(key, kind="stable")
    return key[order], order


# fp32 magnitudes (as bits, sign cleared) from which the kernels' 3xTF32
# split cannot carry a value: cvt.rna.tf32 rounds |x| >= 3.401993e38
# (0x7f7ff000, half way past the largest tf32) to Inf, and Inf and NaN
# (above 0x7f800000) have no finite low part either
TF32_SPLIT_LIMIT_BITS = 0x7F7FF000
# elements read per step by unsplittable_flag (bounds its temporaries)
_FLAG_CHUNK = 1 << 24


def unsplittable_flag(values: torch.Tensor) -> torch.Tensor:
    """(1,) int32 on ``values``' device: 1 where ``values`` (fp32) holds a
    value the 3xTF32 split cannot carry (an Inf, a NaN, or |x| >=
    3.401993e38), else 0.  The matrix-path kernels read it on the device
    and then multiply every tile entry in fp32, as the reference does.
    Device ops only, in chunks: no host synchronisation."""
    flat = values.detach().reshape(-1)
    if flat.dtype != torch.float32:
        raise PlanBuildError(f"values must be float32, got {flat.dtype}")
    top = torch.zeros(1, dtype=torch.int32, device=flat.device)
    for s in range(0, flat.numel(), _FLAG_CHUNK):
        bits = flat[s:s + _FLAG_CHUNK].view(torch.int32) & 0x7FFFFFFF
        top = torch.maximum(top, bits.max().reshape(1))
    return (top >= TF32_SPLIT_LIMIT_BITS).to(torch.int32)


# the 19 plan leaves, in NeutronPlan field order
LEAF_NAMES = (
    "step_window", "step_col", "flat_values", "core_row_map",
    "fringe_rows", "fringe_cols", "fringe_vals", "fringe_row_ids",
    "col_perm", "gather_src_matrix", "gather_src_vector",
    "fringe_kb_chunk", "fringe_kb_rows", "fringe_kb_cols", "fringe_kb_vals",
    "nm_values", "nm_codes", "bitmap_words", "bitmap_values",
)


@dataclasses.dataclass
class NeutronPlan:
    """Prepared execution plan: 19 tensor leaves on one device + metadata."""

    # matrix path: flat active-tile stream (window-major under reuse order)
    step_window: torch.Tensor   # (T,) int32
    step_col: torch.Tensor      # (T,) int32
    flat_values: torch.Tensor   # (T, bm, bk) float32
    core_row_map: torch.Tensor  # (num_windows*bm,) int32 -> original row (-1 pad)
    # vector path: packed row-sorted fringe COO
    fringe_rows: torch.Tensor   # (nnz_f,) int32 packed ids
    fringe_cols: torch.Tensor   # (nnz_f,) int32
    fringe_vals: torch.Tensor   # (nnz_f,) float32
    fringe_row_ids: torch.Tensor  # (n_fringe_rows,) int32 original ids
    col_perm: torch.Tensor      # (K,) int32 — B row perm (identity unless reorder_cols)
    # scatter-free merge: original row -> packed slot or -1
    gather_src_matrix: torch.Tensor  # (M,) int32
    gather_src_vector: torch.Tensor  # (M,) int32
    # K-sharded streaming tier: fringe COO re-bucketed by k-block (sorted by
    # (k-block, row, col), per-bucket chunk-padded with zero-value entries,
    # columns k-block-local); 1-element dummies unless it is in use
    fringe_kb_chunk: torch.Tensor  # (num_chunks,) int32, chunk -> k-block id
    fringe_kb_rows: torch.Tensor   # (num_chunks*chunk,) int32
    fringe_kb_cols: torch.Tensor   # (num_chunks*chunk,) int32
    fringe_kb_vals: torch.Tensor   # (num_chunks*chunk,) float32
    # structured-lane payloads: alternative encodings of flat_values,
    # (1, 1, 1) zero dummies unless matrix_format selects them
    nm_values: torch.Tensor      # (T, bm, n*gk) f32 slot-major values
    nm_codes: torch.Tensor       # (T, bm, gk) int32, 8-bit position per slot
    bitmap_words: torch.Tensor   # (T, bm, ceil(bk/32)) int32 occupancy bits
    bitmap_values: torch.Tensor  # (T, bm, row_cap) f32 packed row values

    shape: Tuple[int, int]
    config: SpmmConfig
    stats: Tuple  # immutable (key, value) pairs
    fringe_tier: str = "resident"  # "resident" | "ksharded" | "xla"
    fringe_bk: int = 0             # k-block size of the ksharded tier
    matrix_format: str = "general"
    format_params: Tuple[int, int] = (0, 0)
    update_maps: Optional[UpdateMaps] = None
    # kernel-side index arrays derived from leaves on first use (not leaves)
    derived: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # unsplittable_flag(flat_values): (1,) int32 on the plan's device, read
    # by the matrix-path kernels; not a leaf, and not in ``derived``, which
    # value updates share (update_values recomputes it)
    a_unsplittable: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.step_window.device

    @property
    def num_windows(self) -> int:
        return self.core_row_map.shape[0] // self.config.bm

    @property
    def stats_dict(self) -> Dict:
        return dict(self.stats)

    @property
    def has_core(self) -> bool:
        return bool(self.stats_dict["core_nnz"])

    @property
    def has_fringe(self) -> bool:
        return bool(self.stats_dict["fringe_nnz"])

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The 19 leaves by name."""
        return {name: getattr(self, name) for name in LEAF_NAMES}

    def signature(self) -> Tuple:
        """Static structure key: plans sharing it reuse one executor."""
        cfg = self.config
        return (
            PLAN_FORMAT_VERSION,
            self.shape, cfg.bm, cfg.bk, cfg.bn, cfg.impl, cfg.reorder_cols,
            cfg.fringe_chunk, self.num_windows,
            int(self.step_window.shape[0]), int(self.fringe_rows.shape[0]),
            int(self.fringe_row_ids.shape[0]), self.has_core, self.has_fringe,
            self.fringe_tier, self.fringe_bk,
            int(self.fringe_kb_chunk.shape[0]),
            int(self.fringe_kb_rows.shape[0]),
            self.matrix_format, tuple(self.format_params),
        )


# --- executor-body leaf ordering -------------------------------------------
N_PLAN_LEAVES = 17   # executor-body plan args (everything before b)
LEAF_RANKS = (1, 1, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 3, 3, 3, 3)
LEAF_COL_PERM = 6    # position of col_perm among the executor-body args
N_DELTA_LEAVES = 8   # d_rows, d_cols, d_vals, d_gsrc, kb_chunk/rows/cols/vals
# positions, among the executor-body args, of the values a value update
# rewrites
LEAF_FLAT_VALUES = 2
LEAF_FRINGE_VALS = 5
LEAF_KB_VALS = 12

# the executor-body args by name, in fused-body order
EXEC_LEAF_NAMES = (
    "step_window", "step_col", "flat_values",
    "fringe_rows", "fringe_cols", "fringe_vals",
    "col_perm", "gather_src_matrix", "gather_src_vector",
    "fringe_kb_chunk", "fringe_kb_rows", "fringe_kb_cols", "fringe_kb_vals",
    "nm_values", "nm_codes", "bitmap_words", "bitmap_values",
)


def plan_leaves(plan: NeutronPlan) -> Tuple[torch.Tensor, ...]:
    """Executor-body args in fused-body order (without b)."""
    return tuple(getattr(plan, name) for name in EXEC_LEAF_NAMES)


def plan_from_leaves(
    leaves: Dict[str, np.ndarray], meta: Dict[str, Any], device: Any,
) -> NeutronPlan:
    """A plan from its 19 leaves as host arrays plus metadata.

    ``meta`` holds ``shape``, ``config`` (a :class:`SpmmConfig` or a dict of
    its fields), ``stats``, ``fringe_tier``, ``fringe_bk``,
    ``matrix_format``, ``format_params`` and optionally ``update_maps``.
    Leaves are copied to ``device``, which must suit ``config.impl``.
    """
    missing = [n for n in LEAF_NAMES if n not in leaves]
    extra = sorted(set(leaves) - set(LEAF_NAMES))
    if missing or extra:
        raise PlanBuildError(
            f"plan leaves mismatch: missing {missing}, unexpected {extra}")
    config = meta["config"]
    if isinstance(config, dict):
        known = {f.name for f in dataclasses.fields(SpmmConfig)}
        unknown = sorted(set(config) - known)
        if unknown:
            raise PlanBuildError(f"unknown SpmmConfig fields: {unknown}")
        config = SpmmConfig(**config)
    _check_payload(leaves, config, meta.get("matrix_format", "general"),
                   tuple(meta.get("format_params", (0, 0))))
    if (config.impl == "cuda" and meta["fringe_tier"] == "ksharded"
            and dict(meta.get("stats", ())).get("fringe_nnz", 1)
            and leaves["fringe_kb_rows"].size < leaves["fringe_rows"].size):
        raise PlanBuildError(
            "a ksharded plan for impl='cuda' needs its k-bucketed fringe "
            "stream, and this one holds only placeholders (the reference "
            "builds it for impl='pallas')")
    dev = check_impl_device(config.impl, device)
    tensors = {}
    for name in LEAF_NAMES:
        arr = np.asarray(leaves[name])
        # CPU plans own a copy (no aliasing of the caller's arrays); CUDA
        # plans copy to the card anyway
        if dev.type == "cpu" or not arr.flags.writeable:
            arr = np.array(arr, order="C")
        tensors[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    return NeutronPlan(
        **tensors,
        shape=tuple(int(s) for s in meta["shape"]),
        config=config,
        stats=tuple(meta.get("stats", ())),
        fringe_tier=str(meta["fringe_tier"]),
        fringe_bk=int(meta["fringe_bk"]),
        matrix_format=str(meta.get("matrix_format", "general")),
        format_params=tuple(int(x) for x in meta.get("format_params",
                                                     (0, 0))),
        update_maps=meta.get("update_maps"),
        a_unsplittable=unsplittable_flag(tensors["flat_values"]),
    )


def _check_payload(leaves: Dict[str, np.ndarray], config: SpmmConfig,
                   fmt: str, params: Tuple) -> None:
    """Raise unless the structured payload leaves are the ones ``fmt`` and
    its ``format_params`` describe over the plan's tile stream."""
    if fmt not in MATRIX_FORMATS:
        raise PlanBuildError(
            f"matrix_format must be one of {MATRIX_FORMATS}, got {fmt!r}")
    if fmt == "general":
        return
    t = np.shape(leaves["step_window"])[0]
    bm, bk = config.bm, config.bk
    if len(params) != 2:
        raise PlanBuildError(f"format_params must be a pair, got {params}")
    if fmt == "nm":
        n_pat, m_pat = (int(x) for x in params)
        if m_pat <= 0 or bk % m_pat or not 1 <= n_pat <= 4:
            raise PlanBuildError(
                f"N:M params {params} need 1 <= n <= 4 and m dividing "
                f"bk={bk}")
        gk = bk // m_pat
        want = {"nm_values": (t, bm, n_pat * gk), "nm_codes": (t, bm, gk)}
    else:
        n_words, row_cap = (int(x) for x in params)
        want = {"bitmap_words": (t, bm, (bk + 31) // 32),
                "bitmap_values": (t, bm, row_cap)}
        if n_words != (bk + 31) // 32 or row_cap < 1:
            raise PlanBuildError(
                f"bitmap params {params} do not fit bk={bk}")
    for name, shape in want.items():
        if tuple(np.shape(leaves[name])) != shape:
            raise PlanBuildError(
                f"{fmt} plan: leaf {name} has shape "
                f"{tuple(np.shape(leaves[name]))}, expected {shape}")


# --- validation -------------------------------------------------------------


def validate_coo(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    shape: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reject malformed COO input with a descriptive error (negative
    indices would otherwise wrap around python-style)."""
    m, k = shape
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if not (rows.ndim == cols.ndim == vals.ndim == 1):
        raise ValueError(
            f"COO triplets must be 1-D; got rows.ndim={rows.ndim} "
            f"cols.ndim={cols.ndim} vals.ndim={vals.ndim}"
        )
    if not (rows.shape == cols.shape == vals.shape):
        raise ValueError(
            f"COO triplet lengths disagree: rows={rows.shape[0]} "
            f"cols={cols.shape[0]} vals={vals.shape[0]}"
        )
    for name, arr in (("rows", rows), ("cols", cols)):
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"{name} must be an integer array, got {arr.dtype}")
    if rows.size:
        if int(rows.min()) < 0 or int(rows.max()) >= m:
            raise ValueError(
                f"row indices out of range for shape {shape}: "
                f"[{int(rows.min())}, {int(rows.max())}]"
            )
        if int(cols.min()) < 0 or int(cols.max()) >= k:
            raise ValueError(
                f"col indices out of range for shape {shape}: "
                f"[{int(cols.min())}, {int(cols.max())}]"
            )
    return rows.astype(np.int64), cols.astype(np.int64), vals


def validate_rhs(b: torch.Tensor, shape: Tuple[int, int]) -> None:
    """Reject an operand whose K disagrees with the plan (a short b would
    otherwise zero-pad silently into a wrong output)."""
    if b.ndim not in (2, 3):
        raise ValueError(
            f"b must be (K, N) or (batch, K, N); got shape {tuple(b.shape)}"
        )
    if int(b.shape[-2]) != shape[1]:
        raise ValueError(
            f"operand K={int(b.shape[-2])} does not match the plan's "
            f"K={shape[1]} (plan shape {shape})"
        )


# --- padding + merge helpers ------------------------------------------------


def permute_pad_b(
    b: torch.Tensor, col_perm: torch.Tensor, reorder_cols: bool, bk: int,
) -> torch.Tensor:
    """Apply the column permutation to B rows, cast to fp32 and pad K to a
    multiple of ``bk`` (the tile stream addresses whole k-blocks).

    Unlike the reference, N is not padded to ``bn``: the kernels mask their
    ragged column edge, so padding would only add work.
    """
    k = b.shape[0]
    if reorder_cols:
        b = b[col_perm.long()]
    b = b.to(torch.float32)
    k_pad = ((k + bk - 1) // bk) * bk
    if k_pad != k:
        b = F.pad(b, (0, 0, 0, k_pad - k))
    return b.contiguous()


def gather_rows(packed: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Scatter-free merge: out[r] = packed[src[r]] where src[r] >= 0 else 0."""
    idx = src.long().clamp(0, packed.shape[0] - 1)
    return torch.where((src >= 0)[:, None], packed[idx], 0.0)


# --- k-bucketed fringe stream -----------------------------------------------


def bucket_fringe_kblocks(
    pr: np.ndarray, pc: np.ndarray, pv: np.ndarray,
    k_pad: int, fringe_bk: int, chunk_eff: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Relayout packed fringe COO for the K-sharded streaming kernel.

    Nonzeros sorted by (k-block, row, col), per-bucket padded to a chunk
    multiple with zero-value entries (row 0, col 0), columns made
    k-block-local; empty k-blocks get no chunks.  The trailing return is
    ``pos_of_packed``: the bucketed-stream slot of each packed fringe entry.
    """
    nkb_f = (k_pad + fringe_bk - 1) // fringe_bk
    kb = pc.astype(np.int64) // fringe_bk
    order_kb = np.argsort(kb, kind="stable")  # keeps (row, col) per kb
    kbs = kb[order_kb]
    counts = np.bincount(kbs, minlength=nkb_f)
    padded = ((counts + chunk_eff - 1) // chunk_eff) * chunk_eff
    src_start = np.cumsum(counts) - counts
    dst_start = np.cumsum(padded) - padded
    dest = dst_start[kbs] + np.arange(kbs.size) - src_start[kbs]
    total_kb = int(padded.sum())
    kb_rows = np.zeros(total_kb, np.int32)
    kb_rows[dest] = pr[order_kb]
    kb_cols = np.zeros(total_kb, np.int32)
    kb_cols[dest] = (pc[order_kb] % fringe_bk).astype(np.int32)
    kb_vals = np.zeros(total_kb, pv.dtype)
    kb_vals[dest] = pv[order_kb]
    kb_chunk = np.repeat(
        np.arange(nkb_f, dtype=np.int32), padded // chunk_eff
    )
    pos_of_packed = np.empty(kbs.size, np.int64)
    pos_of_packed[order_kb] = dest
    return kb_chunk, kb_rows, kb_cols, kb_vals, pos_of_packed


# --- update-map construction ------------------------------------------------


def build_update_maps(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    shape: Tuple[int, int], part, core_lin: np.ndarray,
    fringe_pos: np.ndarray, kb_pos_of_packed: Optional[np.ndarray],
) -> UpdateMaps:
    """Invert prepare()'s packing into per-nonzero COO->slot maps."""
    nnz = rows.shape[0]
    path = np.full(nnz, PATH_FRINGE, np.int8)
    core_lin_of = np.full(nnz, -1, np.int64)
    fringe_pos_of = np.full(nnz, -1, np.int64)
    kb_pos_of = np.full(nnz, -1, np.int64)
    core_idx = (
        part.core_idx if part.core_idx is not None
        else np.zeros(0, np.int64)
    )
    fringe_idx = (
        part.fringe_idx if part.fringe_idx is not None
        else np.zeros(0, np.int64)
    )
    if core_idx.size:
        path[core_idx] = PATH_CORE
        core_lin_of[core_idx] = core_lin
    if fringe_idx.size:
        fringe_pos_of[fringe_idx] = fringe_pos
        if kb_pos_of_packed is not None:
            kb_pos_of[fringe_idx] = kb_pos_of_packed[fringe_pos]
    # stable sort keeps input order within a slot
    cm_order = np.argsort(core_lin, kind="stable")
    key_sorted, key_order = build_key_index(rows, cols, shape[1])
    return UpdateMaps(
        shape=tuple(shape), rows=rows, cols=cols, vals=vals.copy(),
        path=path, core_lin=core_lin_of, fringe_pos=fringe_pos_of,
        kb_pos=kb_pos_of,
        core_lin_sorted=core_lin[cm_order],
        core_members_sorted=core_idx[cm_order],
        key_sorted=key_sorted, key_order=key_order,
    )


# --- SDDMM gather maps -------------------------------------------------------


class FringeRowOrder(NamedTuple):
    """The SDDMM fringe in row order, from the structure alone: the operand
    layout of ``kernels.sddmm.gather_sddmm``.

    ``indptr`` (M+1,) int32: the entries of X row ``r`` are ``[indptr[r],
    indptr[r+1])``; per entry (int32), ``cols``: the row of the Y^T panel
    the walk reads, and ``pos``: its position in the SDDMM output.  Each
    row's entries keep their input order (a stable sort).
    """
    indptr: torch.Tensor
    cols: torch.Tensor
    pos: torch.Tensor


def fringe_row_order(rows: torch.Tensor, cols: torch.Tensor,
                     pos: torch.Tensor, num_rows: int,
                     col_map: Optional[torch.Tensor] = None
                     ) -> FringeRowOrder:
    """:class:`FringeRowOrder` of entries ``(rows[i], cols[i])`` at output
    positions ``pos[i]``, on their device; ``col_map`` (if given) maps a
    column to its row of the Y^T panel."""
    if pos.numel() >= 2 ** 31:
        raise ValueError(f"{pos.numel()} positions do not fit int32")
    order = torch.argsort(rows, stable=True)
    r = rows[order].long()
    c = cols[order].long()
    if col_map is not None:
        c = col_map.long()[c]
    indptr = torch.searchsorted(
        r, torch.arange(num_rows + 1, device=r.device))

    def i32(x):
        return x.to(torch.int32).contiguous()

    return FringeRowOrder(i32(indptr), i32(c), i32(pos[order]))


@dataclasses.dataclass(frozen=True)
class SddmmMaps:
    """Index maps for SDDMM over a plan's pattern.

    The matrix path computes dense ``X_window @ Y_kblock`` tiles for exactly
    the (window, k-block) pairs of the plan's tile stream, and per-nonzero
    values are extracted from the flat tile stream at the slots ``prepare``
    scattered values into (``UpdateMaps.core_lin``).  Fringe nonzeros take
    one dot product each, walked in row order (``walk``), each written at
    its position in the output.  Output order is the plan's input COO
    order, the order :func:`repro_torch.dynamic.update_values` takes.
    Extraction is duplicate-safe: duplicate COO entries share a tile slot
    and read the same dot product.

    Both are on the plan's device.  ``core_lin`` is int64: a Reddit-scale
    tile stream has 1.46e9 slots, too close to the int32 limit to keep
    there.  ``nnz_f`` is the length of the reference's fringe subset
    (the fringe nonzeros, at least 1).
    """

    core_lin: torch.Tensor  # (nnz,) int64 flat tile slot, -1 on the fringe
    walk: FringeRowOrder    # the fringe subset in row order, Y^T rows of ypt
    nnz: int
    nnz_f: int              # padded fringe-subset length

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.core_lin,) + tuple(self.walk)


def sddmm_body_leaves(
    plan: NeutronPlan, maps: SddmmMaps
) -> Tuple[torch.Tensor, ...]:
    """SDDMM executor-body args in fused-body order (without x, y)."""
    return (
        plan.step_window, plan.step_col, plan.core_row_map, plan.col_perm,
    ) + maps.leaves()


def _inverse_col_perm(plan: NeutronPlan) -> Optional[torch.Tensor]:
    """Column ``c``'s row in the Y^T panel the SDDMM body builds
    (``permute_pad_b`` of Y^T, whose row ``j`` is Y's column
    ``col_perm[j]``), or None where the panel is not permuted."""
    if not plan.config.reorder_cols:
        return None
    perm = plan.col_perm.long()
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return inv


def build_sddmm_maps(plan: NeutronPlan) -> SddmmMaps:
    """Invert a plan's update maps into SDDMM extraction indices.

    Built once per pattern and kept in ``plan.derived``, which plans made
    by a value update share: the maps depend on the structure only.  The
    fringe walk is the fringe subset stable-sorted by row, its columns
    mapped to rows of the permuted, padded Y^T panel.
    """
    maps = plan.update_maps
    if maps is None:
        raise PlanBuildError(
            "sddmm needs the plan's COO->slot update maps; this plan has "
            "none (carry them with interop.update_maps_from_arrays, or "
            "prepare from COO)")
    cached = plan.derived.get("sddmm_maps")
    if cached is not None:
        return cached
    f_sel = np.flatnonzero(maps.core_lin < 0)

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            plan.device)

    walk = fringe_row_order(dev(maps.rows[f_sel], np.int64),
                            dev(maps.cols[f_sel], np.int64),
                            dev(f_sel, np.int64), plan.shape[0],
                            col_map=_inverse_col_perm(plan))
    built = SddmmMaps(core_lin=dev(maps.core_lin, np.int64), walk=walk,
                      nnz=maps.nnz, nnz_f=max(1, int(f_sel.size)))
    plan.derived["sddmm_maps"] = built
    return built


# --- structural-delta sidecar ---------------------------------------------


def _pad_clip(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] >= n:
        return a[:n]
    return np.concatenate(
        [a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)])


@dataclasses.dataclass(frozen=True)
class DeltaFringe:
    """Capacity-padded COO sidecar, shaped for the fringe tier dispatch.

    ``leaves`` are the reference's 8 arrays, as tensors on the plan's
    device: the packed rows, columns and values of the delta sorted by
    key, padded to ``capacity`` with (row 0, col 0, 0.0) entries; the
    inverse row map ``gsrc`` (original row -> packed row, -1); and the
    k-bucketed copy of the stream (1-element dummies unless the tier is
    "ksharded" and the impl "cuda").  ``sig`` keys the cached executor; it
    changes only when ``capacity`` grows (powers of two).

    Beyond the reference's fields: ``coo``, the delta's own (rows, cols,
    vals) host triplets, from which the backward builds the transposed
    sidecar; and ``derived``, the sidecar's own cache of index arrays the
    kernel wrappers derive from its structure (row offsets, row orders).
    It lives and dies with this sidecar: a plan's ``derived`` describes the
    plan's fringe, never this stream.
    """

    leaves: Tuple[torch.Tensor, ...]
    sig: Tuple
    capacity: int
    count: int
    tier: str
    bk: int
    coo: Tuple[np.ndarray, np.ndarray, np.ndarray] = dataclasses.field(
        default=(), compare=False, repr=False)
    derived: Dict[str, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)


def build_delta_fringe(
    d_rows: np.ndarray,
    d_cols: np.ndarray,
    d_vals: np.ndarray,
    shape: Tuple[int, int],
    config: SpmmConfig,
    capacity: Optional[int] = None,
    *,
    device: Any = None,
) -> DeltaFringe:
    """Materialize a delta COO into a capacity-padded sidecar stream, as
    the reference's ``build_delta_fringe`` does, on ``device`` (default:
    the one ``config.impl`` runs on).

    The tier comes from the port's ``select_fringe_tier`` with
    ``config.impl``: on ``"torch"`` the reference's arithmetic (so leaves
    and ``sig`` equal the reference's on ``"xla"``), on ``"cuda"`` with
    the H100 rule, which turns "xla" into "resident" so that no sidecar
    runs without a kernel on the card.
    """
    from ..kernels.ops import effective_chunk, pow2_at_least

    m, k = shape
    d_rows = np.asarray(d_rows, np.int64)
    d_cols = np.asarray(d_cols, np.int64)
    d_vals = np.asarray(d_vals)
    count = int(d_rows.size)
    cap = max(8, pow2_at_least(count), int(capacity or 0))

    if count:
        order = np.argsort(d_rows * np.int64(k) + d_cols, kind="stable")
        sr = d_rows[order]
        first = np.concatenate([[True], sr[1:] != sr[:-1]])
        row_ids = sr[first]
        pr = (np.cumsum(first) - 1).astype(np.int32)
        pc = d_cols[order].astype(np.int32)
        pv = d_vals[order].astype(np.float32)
    else:
        row_ids = np.zeros(0, np.int64)
        pr = np.zeros(0, np.int32)
        pc = np.zeros(0, np.int32)
        pv = np.zeros(0, np.float32)
    pr, pc, pv = _pad_clip(pr, cap), _pad_clip(pc, cap), _pad_clip(pv, cap)
    gsrc = np.full(m, -1, np.int32)
    if row_ids.size:
        gsrc[row_ids] = np.arange(row_ids.size, dtype=np.int32)

    # the sidecar goes through the plan fringe's tier selection; the
    # packed-row bound is the capacity (static per signature)
    k_pad = ((k + config.bk - 1) // config.bk) * config.bk
    tier, dbk = select_fringe_tier(
        k_pad, cap, config.bn, vmem_budget=config.fringe_vmem_budget,
        impl=config.impl)
    chunk_eff = effective_chunk(config.fringe_chunk)
    if tier == "ksharded" and config.impl == "cuda":
        kbc, kbr, kbcol, kbv, _pos = bucket_fringe_kblocks(
            pr, pc, pv, k_pad, dbk, chunk_eff)
        # shapes fixed per capacity: each nonempty bucket wastes < chunk
        # slots, so cap * chunk bounds the stream; pad chunks address
        # k-block 0 with zero values
        kb_cap = cap * chunk_eff
        kbc = _pad_clip(kbc, kb_cap // chunk_eff)
        kbr = _pad_clip(kbr, kb_cap)
        kbcol = _pad_clip(kbcol, kb_cap)
        kbv = _pad_clip(kbv, kb_cap)
    else:
        kbc = np.zeros(1, np.int32)
        kbr = np.zeros(1, np.int32)
        kbcol = np.zeros(1, np.int32)
        kbv = np.zeros(1, np.float32)

    if device is None:
        device = IMPL_DEVICE.get(config.impl, config.impl)
    leaves = tuple(
        torch.from_numpy(np.ascontiguousarray(x)).to(device)
        for x in (pr, pc, pv, gsrc, kbc, kbr, kbcol, kbv))
    sig = ("delta", cap, cap, tier, int(dbk),
           int(kbc.shape[0]), int(kbr.shape[0]))
    return DeltaFringe(leaves=leaves, sig=sig, capacity=cap, count=count,
                       tier=tier, bk=int(dbk), coo=(d_rows, d_cols, d_vals))


def delta_child_sig(dsig: Tuple) -> Tuple:
    """Per-shard ("delta", ...) signature of any sidecar signature."""
    if dsig[0] == "sharded_delta":
        return ("delta",) + tuple(dsig[2:])
    return dsig


# --- sharded plans -----------------------------------------------------------


@dataclasses.dataclass
class ShardedUpdateMaps:
    """COO->slot inverse maps of a sharded plan.

    Global nonzero ``j`` lives in shard ``shard_of_nnz[j]`` at position
    ``local_of_nnz[j]`` of that shard's input arrays; ``shard_maps[s]`` are
    the shard's own :class:`UpdateMaps`, whose slots stay valid in the
    padded stacked leaves (padding only appends).  The global
    ``rows/cols/vals`` mirror serves the dynamic layer and compaction.
    """

    shape: Tuple[int, int]
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shard_of_nnz: np.ndarray
    local_of_nnz: np.ndarray
    shard_maps: Tuple[UpdateMaps, ...]
    key_sorted: np.ndarray
    key_order: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    lookup = UpdateMaps.lookup


@dataclasses.dataclass
class PlanShard:
    """One shard of a :class:`ShardedPlan` on its device: the 17
    executor-body leaves, its own ``derived`` cache and its own
    ``a_unsplittable`` flag (so the C6 routing is decided per shard).

    On a rows-sharded plan the ``derived`` of each shard starts with
    ``stack_padding``: how many tile steps, packed fringe entries and
    k-bucketed entries of its padded leaves are its own (the rest pads the
    shard to the mesh-uniform shapes).  The kernel wrappers read it to
    leave the padded tiles unread and to cut the padded fringe entries
    from their row orders, with the walk's bits unchanged
    (``kernels.ops``)."""

    leaves: Tuple[torch.Tensor, ...]
    derived: Dict[str, Any]
    a_unsplittable: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.leaves[0].device


@dataclasses.dataclass
class ShardedPlan:
    """Prepared multi-device execution plan.

    ``shard_axis == "rows"``: every shard holds its own padded sub-plan,
    the reference's stacked leaves cut along their leading shard axis; it
    emits its packed ``(rows_per_shard, N)`` block, and ``assemble`` maps
    each original row into the concatenated blocks.  ``shard_axis ==
    "rhs"``: one plan, replicated on every device of the mesh (one copy
    per distinct device), with B's columns split across the shards.

    On a mesh whose shards share one device (``[cuda:0] * 4``, ``[cpu] *
    n``) the rows-axis leaves are uploaded once, stacked (``stacked``), and
    every shard's leaves are views of its slice.  ``leaves`` gives the
    reference's 17 executor-body leaves, stacked along a leading shard
    axis on the rows axis (on the mesh's first device), plain on the rhs
    axis.
    """

    shards: Tuple[PlanShard, ...]
    sig: Tuple                      # mesh-uniform per-shard signature
    mesh: Any                       # distributed.SpmmMesh
    axis_name: str
    shard_axis: str                 # "rows" | "rhs"
    n_shards: int
    assemble: Optional[torch.Tensor]  # (M,) int32 on mesh.first ("rows")
    shape: Tuple[int, int]
    config: SpmmConfig
    stats: Tuple
    update_maps: Optional[ShardedUpdateMaps] = None
    # padded per-shard row count ("rows"; 0 for "rhs"): assemble[r] ==
    # shard_of(r) * rows_per_shard + local_of(r)
    rows_per_shard: int = 0
    stacked: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def device(self) -> torch.device:
        """The device that takes B and holds the result."""
        return self.mesh.first

    @property
    def leaves(self) -> Tuple[torch.Tensor, ...]:
        if self.shard_axis == "rhs":
            return self.shards[0].leaves
        if self.stacked is not None:
            return self.stacked
        dev = self.device
        return tuple(torch.stack([sh.leaves[i].to(dev) for sh in self.shards])
                     for i in range(N_PLAN_LEAVES))

    @property
    def stats_dict(self) -> Dict:
        return dict(self.stats)

    def signature(self) -> Tuple:
        """Static structure key; never equal to a ``NeutronPlan``'s (a
        distinct leading tag and length), as in the reference."""
        return ("sharded", self.shard_axis, self.n_shards, self.axis_name,
                (self.mesh.size,), self.sig)


def stack_shard_leaves(
    shard_leaves, kb_streams, t_max: int, nw_max: int, nnzf_max: int,
    nch_max: int, nnzkb_max: int,
) -> Tuple[np.ndarray, ...]:
    """Pad every shard's 17 leaves (host arrays, fused-body order) to
    mesh-uniform shapes and stack them, as the reference does.

    Padding is inert: padded tile steps carry zero values into the extra
    window ``nw_max``, padded fringe entries add 0.0 to packed row 0,
    padded k-bucketed chunks address k-block 0 with zero values, and the
    gather maps are already at the padded row count.  (0 · Inf is NaN: an
    Inf or NaN in B's row 0 reaches packed row 0 of every shard through
    the padding, as in the reference.)
    """
    n = len(shard_leaves)
    # (padded length, fill) per leaf; None: the leaf is already uniform
    pads = ((t_max, nw_max), (t_max, 0), (t_max, 0.0),
            (nnzf_max, 0), (nnzf_max, 0), (nnzf_max, 0.0),
            None, None, None,
            (nch_max, 0), (nnzkb_max, 0), (nnzkb_max, 0), (nnzkb_max, 0.0),
            None, None, None, None)
    out = []
    for i, pad in enumerate(pads):
        cols = [(leaves[i] if i < 9 or i >= 13 else kb[i - 9])
                for leaves, kb in zip(shard_leaves, kb_streams)]
        if pad is None:
            out.append(np.stack(cols))
            continue
        length, fill = pad
        first = cols[0]
        # written in place, one copy per leaf (the tile stream is the
        # largest array a plan holds)
        arr = np.empty((n, length) + first.shape[1:], first.dtype)
        for s, col in enumerate(cols):
            arr[s, :col.shape[0]] = col
            arr[s, col.shape[0]:] = fill
        out.append(arr)
    return tuple(out)


def place_shards(
    stacked: Tuple[np.ndarray, ...], devices, real_counts=None,
) -> Tuple[Tuple[PlanShard, ...], Optional[Tuple[torch.Tensor, ...]]]:
    """Rows-axis shards on their devices from the stacked host leaves.

    ``real_counts[s]`` (tile steps, fringe entries, k-bucketed entries of
    shard ``s``'s own) seeds each shard's ``stack_padding``.  Where every
    shard runs on one device the stack is uploaded once and the shards'
    leaves are views of it (returned second); otherwise each shard's
    slice is copied to its device and the second value is None."""
    devices = tuple(torch.device(d) for d in devices)
    uniform = len(set(devices)) == 1
    stack_t = None
    if uniform:
        stack_t = tuple(
            torch.from_numpy(np.ascontiguousarray(x)).to(devices[0])
            for x in stacked)
    shards = []
    for s, dev in enumerate(devices):
        if uniform:
            leaves = tuple(x[s] for x in stack_t)
        else:
            leaves = tuple(torch.from_numpy(np.ascontiguousarray(x[s])).to(dev)
                           for x in stacked)
        derived: Dict[str, Any] = {}
        if real_counts is not None:
            steps, fringe, kb = real_counts[s]
            derived["stack_padding"] = {"steps": int(steps),
                                        "fringe": int(fringe), "kb": int(kb)}
        shards.append(PlanShard(
            leaves, derived,
            unsplittable_flag(leaves[LEAF_FLAT_VALUES])))
    return tuple(shards), stack_t


def replicate_shards(plans_by_device: Dict[torch.device, NeutronPlan],
                     devices) -> Tuple[PlanShard, ...]:
    """Rhs-axis shards: shard ``s`` runs the plan on its device, whose
    leaves, ``derived`` and flag the shards on one device share."""
    out = []
    for d in devices:
        p = plans_by_device[torch.device(d)]
        out.append(PlanShard(plan_leaves(p), p.derived, p.a_unsplittable))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardedDeltaFringe:
    """Per-shard delta sidecars of a rows-sharded plan.

    Every delta row is routed to the shard that owns its output row (by
    the plan's ``assemble``) and relabelled to that shard's local rows;
    each shard's :class:`DeltaFringe` is built at the shard-local shape
    with one capacity for the whole mesh, on the shard's device, with its
    own ``derived`` (so the cut row orders of its padding are its own).
    ``leaves`` stacks the eight leaves along a leading shard axis, as the
    reference's do.
    """

    shards: Tuple[DeltaFringe, ...]
    sig: Tuple
    capacity: int
    count: int
    tier: str
    bk: int
    n_shards: int

    @property
    def leaves(self) -> Tuple[torch.Tensor, ...]:
        dev = self.shards[0].leaves[0].device
        return tuple(torch.stack([df.leaves[i].to(dev) for df in self.shards])
                     for i in range(N_DELTA_LEAVES))


def build_sharded_delta_fringe(
    d_rows: np.ndarray,
    d_cols: np.ndarray,
    d_vals: np.ndarray,
    splan: ShardedPlan,
    capacity: Optional[int] = None,
) -> ShardedDeltaFringe:
    """Route a delta COO to its owning shards and build their sidecars, as
    the reference's ``build_sharded_delta_fringe`` does: each shard merges
    its own rows inside its body, and the assemble gather picks them up."""
    from ..kernels.ops import pow2_at_least

    if splan.shard_axis != "rows":
        raise ValueError(
            "build_sharded_delta_fringe routes by row ownership and needs a "
            f"rows-sharded plan; got shard_axis={splan.shard_axis!r} "
            "(rhs-sharded plans replicate a plain DeltaFringe instead)")
    m_loc = splan.rows_per_shard
    n_shards = splan.n_shards
    k = splan.shape[1]
    d_rows = np.asarray(d_rows, np.int64)
    d_cols = np.asarray(d_cols, np.int64)
    d_vals = np.asarray(d_vals)
    assemble = splan.assemble.cpu().numpy().astype(np.int64)
    slot = assemble[d_rows] if d_rows.size else np.zeros(0, np.int64)
    shard_of = slot // max(m_loc, 1)
    local_row = slot % max(m_loc, 1)
    counts = (np.bincount(shard_of, minlength=n_shards) if d_rows.size
              else np.zeros(n_shards, np.int64))
    cap = max(8, pow2_at_least(int(counts.max()) if d_rows.size else 0),
              int(capacity or 0))
    per_shard = []
    for s in range(n_shards):
        sel = np.flatnonzero(shard_of == s)
        per_shard.append(build_delta_fringe(
            local_row[sel], d_cols[sel], d_vals[sel], (m_loc, k),
            splan.config, capacity=cap, device=splan.mesh.devices[s]))
    child_sig = per_shard[0].sig
    if any(df.sig != child_sig for df in per_shard):
        raise PlanBuildError(
            "per-shard delta signatures diverged despite one capacity")
    return ShardedDeltaFringe(
        shards=tuple(per_shard),
        sig=("sharded_delta", n_shards) + child_sig[1:],
        capacity=cap, count=int(d_rows.size), tier=per_shard[0].tier,
        bk=per_shard[0].bk, n_shards=n_shards)


def delta_on(delta: DeltaFringe, device: torch.device) -> DeltaFringe:
    """``delta`` on ``device``: itself where it lives there, else a copy
    with a ``derived`` of its own, made once and kept in ``delta.derived``
    (the rhs axis replicates one plain sidecar on every device)."""
    device = torch.device(device)
    if delta.leaves[0].device == device:
        return delta
    key = ("replica", str(device))
    rep = delta.derived.get(key)
    if rep is None:
        rep = dataclasses.replace(
            delta, leaves=tuple(x.to(device) for x in delta.leaves),
            derived={})
        delta.derived[key] = rep
    return rep
