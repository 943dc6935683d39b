"""Persistent per-device autotuner for the dispatch cost model: the port of
``repro.core.tuner``.

Every dispatch decision the analytic cost model makes (the matrix/vector
split rates, the fringe tier, the SDDMM tier, the matrix path's tile
shape, the shard-axis imbalance tolerance, the delta-compaction budget)
started as a hand-set constant.  The paper (§5.2.1) calibrates its cost
model with microbenchmark "dry runs" instead; this module is that dry run,
made persistent, as in the reference:

- On first sight of a ``(device fingerprint, op, plan shape class)`` key
  (``autotune=True``), the tuner times the candidate decisions with the
  synchronised best-of-N timer below and records a JSON-serializable
  entry.
- The table persists through an installed *store* (:func:`install_store`),
  in practice ``repro_torch.dynamic.tuning.RegistryTuningStore`` over
  ``PlanRegistry``'s generations, so a warm process makes **zero**
  microbenchmarks (:func:`tune_call_count`).
- ``autotune="offline"`` never measures inline: a record comes from the
  table, or the resolve falls back to the analytic model, counted in
  ``cold_misses``.  The serving process runs in this mode, and adopts
  records that a background tune measured (``serve.SpmmService``).

What a record times.  For a ``"torch"`` config every measurement is the
reference's proxy on the plain version (the CPU tests).  For a ``"cuda"``
config the card's kernels are timed: the vector rate and the resident
fringe candidate on B2 (``gather_spmm``), each k-sharded candidate on B3
(``gather_spmm_ksharded``) over a k-bucketed representative stream built
(and its row order cached) before the timed call, and each ``(bm, bk)``
candidate of the tile-shape sweep on B1 (``dense_tile_spmm``) over a
short tile stream; a candidate that B1 refuses is left out and named in
the record's ``refused``.  No ``"xla"`` candidate is timed for ``"cuda"``
and no plain version runs.  The dense proxies (the matrix rate's
``a_tile @ b``, the densify slots, the merge's ``index_select``) are
``torch`` calls on either impl: the reference measures them with XLA too,
outside any Pallas kernel.  A record built for ``"cuda"`` runs on a CUDA
stream of its own, synchronised before the record is returned, so that a
background tune never queues work behind the serving thread's.

H100 tier rule (``core.cost_model``).  For a ``"cuda"`` plan,
:meth:`TunedCostModel.select_fringe_tier` and
:meth:`TunedCostModel.select_sddmm_tier` never return ``"xla"``: a stored
``"xla"`` decision is ignored on the card and counted
(``Tuner.xla_ignored``).  Everywhere else the decisions and their
demote-only validation (the ``bk`` clamp, ``tile_shape``) are the
reference's, TPU constants included, until the cost model is re-derived
for the H100 (ROADMAP A-queue 4).  The tuned ``densify_occupancy`` stays
in the record and its key, but no executor of the port reads it: B1 has
no densify crossover.

Keys.  :func:`shape_class` equals the reference's string in every field
but the last, the impl (``"torch"`` or ``"cuda"``); the key's device
fingerprint is the impl's device (``"cpu:cpu"`` for ``"torch"``, the
reference's on the CPU; ``"cuda:<device name>"`` for ``"cuda"``).

Layering: this module sits in ``core`` and imports only downward (kernels,
sibling core modules).  Persistence is dependency-inverted: the registry
lives in the *dynamic* layer, so the store is built there and handed down
through :func:`install_store`; ``tools/check_layers_torch.py`` checks that
nothing in ``core`` installs a store or fires a fault seam.

Also here: :func:`timed_best_of`, the one synchronised timer, which
``EngineCostModel.measure`` and the per-path timing use too.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import REGISTRY, instance_label
from .cost_model import (
    DELTA_MAX_FRACTION,
    DELTA_MAX_SLOWDOWN,
    FRINGE_VMEM_BUDGET,
    MXU_DIM,
    ROWS_IMBALANCE_THRESHOLD,
    SUBLANES,
    VMEM_BYTES,
    EngineCostModel,
    default_cost_model,
    fringe_resident_bytes,
    ksharded_bk_cap,
    select_fringe_tier,
)
from .plan_ir import IMPL_DEVICE

# bump when the record layout below changes; stored per record and checked
# on load so that stale tables degrade to the analytic model
TABLE_FORMAT_VERSION = 1

# a measured candidate must beat the analytic choice by this factor before
# it overrides it: absorbs timer noise and keeps ties on the default
MEASURED_HYSTERESIS = 0.92


# --- synchronised timing (the one shared timer) ------------------------------


def _cuda_devices(out: Any, found: List[torch.device]) -> List[torch.device]:
    """The CUDA devices of every tensor in ``out`` (nested tuples, lists
    and dict values are walked; a ``torch.device`` stands for itself),
    each once."""
    if isinstance(out, torch.device):
        if out.type == "cuda" and out not in found:
            found.append(out)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    else:
        dev = getattr(out, "device", None)
        if (isinstance(dev, torch.device) and dev.type == "cuda"
                and dev not in found):
            found.append(dev)
    return found


def synchronize(out: Any) -> Any:
    """Wait until the card has finished the work behind ``out``: a
    ``torch.cuda.synchronize`` of each CUDA device that a tensor in
    ``out`` lies on (or that ``out`` names).  CPU tensors need nothing.
    Returns ``out``."""
    for dev in _cuda_devices(out, []):
        torch.cuda.synchronize(dev)
    return out


def timed_best_of(
    fn: Callable[[], Any], repeats: int = 3, warmup: int = 1
) -> float:
    """Best-of-``repeats`` synchronised wall time of ``fn()`` in seconds.

    A CUDA call returns once its kernels are queued; timing it without a
    synchronisation measures the enqueue, not the work.  So every call,
    warm-ups included, is followed by :func:`synchronize` on what it
    returned before the clock is read.
    """
    for _ in range(max(int(warmup), 0)):
        synchronize(fn())
    best = float("inf")
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        synchronize(fn())
        best = min(best, time.perf_counter() - t0)
    return max(best, 1e-9)


# --- test hooks: microbenchmark counter + injectable timer -------------------

# the per-``instance`` label keeps each Tuner's counts independent
# (reset_for_tests swaps the tuner, and the fresh one starts at zero)
_TUNER_EVENTS = REGISTRY.counter(
    "tuner_events_total",
    "cost-model tuner events (table_hit/cold_miss/measured/store_error/"
    "xla_ignored)",
    labelnames=("event", "instance"),
    max_series=8192,
)
_MICROBENCH = REGISTRY.counter(
    "tuner_microbench_total", "inline microbenchmark invocations")

_TIMER: Callable[[Callable[[], Any]], float] = timed_best_of


def tune_call_count() -> int:
    """Microbenchmark invocations since process start (or the last reset):
    0 in a process that resolves every decision from a persisted table."""
    return int(_MICROBENCH.total())


def reset_tune_call_count() -> None:
    _MICROBENCH.reset()


def set_timer(timer: Callable[[Callable[[], Any]], float]) -> None:
    """Replace the timer (tests inject deterministic ones)."""
    global _TIMER
    _TIMER = timer


def reset_timer() -> None:
    global _TIMER
    _TIMER = timed_best_of


# --- persistence seam (store installed by the dynamic layer) -----------------

_STORE: Optional[Any] = None  # save(table: dict) -> None; load() -> dict|None


def install_store(store: Optional[Any]) -> None:
    """Install the table's persistence backend (``None`` uninstalls).

    Called from *above* core (``repro_torch.dynamic.tuning`` builds the
    registry-backed store); core only talks to the protocol.  A newly
    installed store is read at the next resolve.
    """
    global _STORE
    _STORE = store
    _TUNER._loaded = False


def installed_store() -> Optional[Any]:
    return _STORE


# --- keys --------------------------------------------------------------------


def device_fingerprint(device: Any = None) -> str:
    """Stable id of the device the measurements are valid for:
    ``"cuda:<device name>"`` (spaces as ``_``) on a card, ``"cpu:cpu"`` on
    the CPU (the reference's string there), ``"cuda:unknown"`` for the
    card where there is none.  ``device`` defaults to the card where there
    is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"{dev.type}:{dev.type}"
    if not torch.cuda.is_available():
        return "cuda:unknown"
    return f"cuda:{torch.cuda.get_device_name(dev)}".replace(" ", "_")


def _impl_fingerprint(impl: str) -> str:
    """The fingerprint of the device ``impl`` runs on."""
    device = IMPL_DEVICE.get(impl)
    return device_fingerprint(device)


def _log2_bucket(x: int) -> int:
    return int(math.ceil(math.log2(max(int(x), 1)))) if x > 1 else 0


def shape_class(op: str, m: int, k: int, nnz: int, config: Any) -> str:
    """Coarse problem-class key: two plans in one class share decisions.

    Dims bucket by power of two and density by decade, as in the
    reference; the last field is the impl.
    """
    density = nnz / max(int(m) * int(k), 1)
    dec = int(np.clip(np.floor(np.log10(max(density, 1e-12))), -12, 0))
    return (
        f"{op}|m{_log2_bucket(m)}|k{_log2_bucket(k)}|d{dec}"
        f"|bn{int(config.bn)}|{config.impl}"
    )


def table_key(op: str, m: int, k: int, nnz: int, config: Any) -> str:
    return (f"{_impl_fingerprint(config.impl)}|"
            f"{shape_class(op, m, k, nnz, config)}")


# --- the tuned model ---------------------------------------------------------


def _count_xla_ignored() -> None:
    with _TUNER._lock:
        _TUNER._count("xla_ignored")


@dataclasses.dataclass
class TunedCostModel(EngineCostModel):
    """EngineCostModel whose dispatch decisions come from measurements.

    ``decisions`` holds the per-shape-class measured overrides (absent key
    -> analytic behaviour).  Tier preferences are validated against the
    exact plan shape and budget at decision time: the table can demote
    but never promote past a budget.  On a ``"cuda"`` plan a stored
    ``"xla"`` tier is ignored (the H100 rule) and counted.
    """

    decisions: Dict[str, Any] = dataclasses.field(default_factory=dict)
    key: str = ""
    source: str = "measured"  # "measured" (fresh) | "table" (persisted)

    def select_fringe_tier(
        self, k: int, num_rows: int, bn: int,
        vmem_budget: Optional[int] = None, impl: str = "torch",
    ) -> tuple:
        budget = (
            FRINGE_VMEM_BUDGET if vmem_budget is None else int(vmem_budget)
        )
        choice = self.decisions.get("fringe_tier")
        if choice:
            tier, bk = str(choice[0]), int(choice[1])
            if tier == "xla":
                if impl != "cuda":
                    return "xla", 0
                _count_xla_ignored()
            if tier == "resident" and (
                fringe_resident_bytes(k, num_rows, bn) <= budget
            ):
                return "resident", 0
            if tier == "ksharded":
                cap = ksharded_bk_cap(k, num_rows, bn, budget)
                if cap:
                    bk = min(bk, cap) if bk >= SUBLANES else cap
                    return "ksharded", (bk // SUBLANES) * SUBLANES
        return select_fringe_tier(k, num_rows, bn, vmem_budget=vmem_budget,
                                  impl=impl)

    def select_sddmm_tier(
        self, d: int, n_src_rows: int, n_dst_rows: int,
        vmem_budget: Optional[int] = None, impl: str = "torch",
    ) -> str:
        # demote-only: a measured "xla" preference wins (safe) except on
        # the card, where "xla" has no kernel; a measured "resident" still
        # has to fit the budget (analytic check)
        if self.decisions.get("sddmm_tier") == "xla":
            if impl != "cuda":
                return "xla"
            _count_xla_ignored()
        return EngineCostModel.select_sddmm_tier(
            self, d, n_src_rows, n_dst_rows, vmem_budget=vmem_budget,
            impl=impl)

    def imbalance_threshold(self) -> float:
        v = self.decisions.get("shard_imbalance_threshold")
        return float(v) if v is not None else ROWS_IMBALANCE_THRESHOLD

    def compaction_thresholds(self) -> Tuple[float, float]:
        return (
            float(self.decisions.get(
                "delta_max_fraction", DELTA_MAX_FRACTION)),
            float(self.decisions.get(
                "delta_max_slowdown", DELTA_MAX_SLOWDOWN)),
        )

    def densify_occupancy(self) -> Optional[float]:
        v = self.decisions.get("densify_occupancy")
        return float(v) if v is not None else None

    def tile_shape(self, m: int, k: int, n: int, nnz: int) -> Optional[tuple]:
        # demote-only: the measured (bm, bk) is re-validated against the
        # exact plan shape before adoption, with the reference's checks
        # (MXU and sublane alignment, no tile taller or wider than the
        # padded operand, the fp32 tile set within half the TPU's VMEM).
        # Anything invalid keeps the config's shape.
        choice = self.decisions.get("tile_shape")
        if not choice:
            return None
        bm, bk = int(choice[0]), int(choice[1])
        if bm <= 0 or bk <= 0 or bm % MXU_DIM or bk % SUBLANES:
            return None
        if bm > max(MXU_DIM, -(-int(m) // MXU_DIM) * MXU_DIM):
            return None
        if bk > max(SUBLANES, -(-int(k) // SUBLANES) * SUBLANES):
            return None
        if (bm * bk + bk * int(n) + bm * int(n)) * 4 > VMEM_BYTES // 2:
            return None
        return (bm, bk)


# --- the tuner ---------------------------------------------------------------


class Tuner:
    """Process-wide table of measured records, keyed by :func:`table_key`."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._table: Dict[str, dict] = {}
        self._loaded = False
        self._label = instance_label("tuner")

    def _count(self, event: str) -> None:
        _TUNER_EVENTS.inc(event=event, instance=self._label)

    def _value(self, event: str) -> int:
        return int(_TUNER_EVENTS.value(event=event, instance=self._label))

    @property
    def table_hits(self) -> int:    # resolves served from a (loaded) record
        return self._value("table_hit")

    @property
    def cold_misses(self) -> int:   # offline resolves with no record
        return self._value("cold_miss")

    @property
    def measured(self) -> int:      # records produced by measurement
        return self._value("measured")

    @property
    def store_errors(self) -> int:  # load/save failures (corrupt table, IO)
        return self._value("store_error")

    @property
    def xla_ignored(self) -> int:   # stored "xla" tiers a "cuda" plan ignored
        return self._value("xla_ignored")

    # -- store interaction ----------------------------------------------------

    def _maybe_load(self) -> None:
        with self._lock:
            if self._loaded:
                return
            self._loaded = True
        if _STORE is None:
            return
        try:
            table = _STORE.load()
        except Exception:
            # a corrupt or unreadable table: analytic fallback, counted,
            # never an error on the resolve path
            with self._lock:
                self._count("store_error")
            return
        if not isinstance(table, dict):
            return
        with self._lock:
            for key, rec in table.items():
                if (
                    isinstance(rec, dict)
                    and rec.get("table_format_version") == TABLE_FORMAT_VERSION
                ):
                    # in-memory records win: they are at least as fresh
                    self._table.setdefault(key, rec)

    def _persist(self) -> None:
        if _STORE is None:
            return
        with self._lock:
            snap = dict(self._table)
        try:
            _STORE.save(snap)
        except Exception:
            with self._lock:
                self._count("store_error")

    # -- resolution -----------------------------------------------------------

    def resolve(
        self, op: str, m: int, k: int, nnz: int, config: Any
    ) -> EngineCostModel:
        """The one entry point: the analytic model unless autotune says
        otherwise; for ``impl="cuda"`` the card's (``analytic_h100``),
        else the reference's."""
        mode = getattr(config, "autotune", False)
        if not mode:
            if getattr(config, "impl", None) == "cuda":
                return EngineCostModel.analytic_h100()
            return default_cost_model(n_cols=config.bn)
        self._maybe_load()
        key = table_key(op, m, k, nnz, config)
        with self._lock:
            rec = self._table.get(key)
        if rec is not None:
            with self._lock:
                self._count("table_hit")
            return self._model_from(rec, source="table")
        if mode == "offline":
            with self._lock:
                self._count("cold_miss")
            return default_cost_model(n_cols=config.bn)
        key, rec = self.build_record(op, m, k, nnz, config)
        self.adopt(key, rec)
        return self._model_from(rec, source="measured")

    def peek(self, op: str, m: int, k: int, nnz: int, config: Any):
        """The record for this problem, or None; never measures."""
        self._maybe_load()
        with self._lock:
            return self._table.get(table_key(op, m, k, nnz, config))

    def adopt(self, key: str, rec: dict) -> None:
        """Publish a record atomically (and persist the table).

        Thread-safe: the service builds records on a worker thread and
        adopts them between drains, as it does compaction folds.
        """
        with self._lock:
            self._table[key] = rec
            self._count("measured")
        self._persist()

    def _model_from(self, rec: dict, source: str) -> TunedCostModel:
        return TunedCostModel(
            p_matrix=float(rec["p_matrix"]),
            p_vector=float(rec["p_vector"]),
            r=float(rec.get("r", 1.0)),
            n_cols=int(rec.get("n_cols", 256)),
            decisions=dict(rec.get("decisions", {})),
            key=str(rec.get("key", "")),
            source=source,
        )

    # -- measurement ----------------------------------------------------------

    def _timed(self, label: str, fn: Callable[[], Any], rec: dict) -> float:
        _MICROBENCH.inc()
        t = float(_TIMER(fn))
        rec["bench_us"][label] = t * 1e6
        return max(t, 1e-9)

    def build_record(
        self, op: str, m: int, k: int, nnz: int, config: Any
    ) -> Tuple[str, dict]:
        """Microbenchmark one shape class; returns ``(key, record)``.

        Pure with respect to the table (no adopt or persist), so the
        service can run it on a worker thread and adopt the result between
        drains.  Representative shapes are clamped small, as in the
        reference: a cold tune takes milliseconds of device time.  A
        ``"cuda"`` record runs on a CUDA stream of its own, synchronised
        before it returns.
        """
        key = table_key(op, m, k, nnz, config)
        rec: dict = {
            "key": key,
            "device": _impl_fingerprint(config.impl),
            "op": op,
            "table_format_version": TABLE_FORMAT_VERSION,
            "bench_us": {},
            "decisions": {},
        }
        device = torch.device(IMPL_DEVICE.get(config.impl, "cpu"))
        if device.type != "cuda":
            self._measure(rec, op, m, k, nnz, config, device)
            return key, rec
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            self._measure(rec, op, m, k, nnz, config, device)
        stream.synchronize()
        return key, rec

    def _measure(self, rec: dict, op: str, m: int, k: int, nnz: int,
                 config: Any, device: torch.device) -> None:
        from ..kernels import ops as kops  # kernels sit below core

        impl = config.impl
        bn = int(config.bn)
        analytic = default_cost_model(n_cols=bn)

        def _r8(x: int) -> int:
            return max(8, (int(x) // 8) * 8)

        m_rep = _r8(min(max(m, 8), 256))
        k_rep = _r8(min(max(k, 8), 256))
        density = float(np.clip(nnz / max(m * k, 1), 1e-4, 0.5))
        nnz_rep = int(np.clip(int(density * m_rep * k_rep), 32, 2048))
        rec["rep"] = {"m": m_rep, "k": k_rep, "nnz": nnz_rep}

        # the reference's draws, in its order
        rng = np.random.default_rng(0)
        rows_np = np.sort(rng.integers(0, m_rep, nnz_rep)).astype(np.int32)
        cols_np = rng.integers(0, k_rep, nnz_rep).astype(np.int32)
        b_np = rng.standard_normal((k_rep, bn)).astype(np.float32)
        a_tile_np = rng.standard_normal((128, k_rep)).astype(np.float32)

        def dev(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        rows, cols = dev(rows_np), dev(cols_np)
        vals = torch.ones(nnz_rep, dtype=torch.float32, device=device)
        b, a_tile = dev(b_np), dev(a_tile_np)
        vec_derived: Dict[str, Any] = {}
        if impl == "cuda":
            from ..kernels.gather_spmm import csr_indptr
            vec_derived["csr_indptr"] = csr_indptr(rows, m_rep)

        # engine rates: a dense GEMM proxies the matrix path, the fringe
        # gather (B2 on the card, the plain gather on the CPU) the vector
        # path; alpha needs their ratio
        def matrix_fn():
            return a_tile @ b

        t_matrix = self._timed("matrix", matrix_fn, rec)

        def vector_fn():
            return kops.fringe_spmm(rows, cols, vals, b, num_rows=m_rep,
                                    impl=impl, derived=vec_derived)

        t_vector = self._timed("vector", vector_fn, rec)
        rec["p_matrix"] = float(128 * k_rep) / t_matrix
        rec["p_vector"] = float(nnz_rep) / t_vector
        rec["r"] = 1.0
        rec["n_cols"] = bn

        # densify-occupancy crossover (kept for the record and its key; no
        # executor of the port reads it)
        a_slots = dev(rng.standard_normal((8 * 128, k_rep)).astype(
            np.float32))
        t_slots = self._timed("densify_slots", lambda: a_slots @ b, rec)
        t_step = self._timed("stream_step", matrix_fn, rec)
        occ = 0.25 * (t_slots / 8.0) / t_step
        rec["decisions"]["densify_occupancy"] = float(np.clip(occ, 0.05, 0.9))

        # shard-axis tolerance: rows-sharding pays imbalance, rhs the
        # replicated plan's merge (a row gather)
        out_panel = dev(rng.standard_normal((m_rep, bn)).astype(np.float32))
        perm = dev(rng.permutation(m_rep).astype(np.int64))
        t_merge = self._timed(
            "merge", lambda: torch.index_select(out_panel, 0, perm), rec)
        thr = 1.0 + t_merge / max(t_matrix, 1e-9)
        rec["decisions"]["shard_imbalance_threshold"] = float(
            np.clip(thr, 1.05, 2.0))

        # delta-compaction budget: a vector engine faster than the
        # analytic roofline tolerates a proportionally larger sidecar
        frac = DELTA_MAX_FRACTION * (rec["p_vector"] / analytic.p_vector)
        rec["decisions"]["delta_max_fraction"] = float(
            np.clip(frac, 0.05, 0.5))
        rec["decisions"]["delta_max_slowdown"] = float(DELTA_MAX_SLOWDOWN)

        if op == "sddmm":
            self._measure_sddmm(rec, config)
        else:
            self._measure_fringe(rec, rows, cols, vals, b, rows_np, cols_np,
                                 m_rep, k_rep, bn, config, vec_derived)
            self._measure_tile_shape(rec, rng, m, k, nnz, bn, config,
                                     device)

    def _measure_tile_shape(self, rec, rng, m, k, nnz, bn, config,
                            device) -> None:
        """Sweep matrix-path ``(bm, bk)`` tile-shape candidates.

        Each candidate is timed over a short stack of tiles against one B
        block (on the card one call of B1 over a four-window tile stream,
        its window segments, chunk table and value flag built first; on
        the CPU the reference's stacked product) and priced per *expected
        active tile* at this shape class's density.  The config's own
        shape is the baseline; a candidate must beat it past the
        hysteresis to be recorded (re-validated demote-only at plan-build
        time by :meth:`TunedCostModel.tile_shape`).  A candidate that B1
        refuses (raises on its first call) is left out and named in
        ``rec["refused"]``.
        """
        density = float(np.clip(nnz / max(int(m) * int(k), 1), 1e-8, 1.0))
        base = (int(config.bm), int(config.bk))
        cands = {base}
        for bm in (128, 256):
            for bk in (32, 64, 128, 256):
                cands.add((bm, bk))
        t_tiles = 4
        bk_max = max(bk for _, bk in cands)
        b_wide = torch.from_numpy(
            rng.standard_normal((bk_max, bn)).astype(np.float32)).to(device)
        costs = {}
        refused = []
        for bm, bk in sorted(cands):
            a = torch.from_numpy(rng.standard_normal(
                (t_tiles, bm, bk)).astype(np.float32)).to(device)
            b_blk = b_wide[:bk].contiguous()
            if config.impl == "cuda":
                fn = self._tile_stream_call(a, b_blk, t_tiles, bm, bk)
                if fn is None:
                    refused.append(f"{bm}x{bk}")
                    continue
            else:
                def fn(a=a, b_blk=b_blk):
                    return torch.einsum("tmk,kn->tmn", a, b_blk)
            t_tile = self._timed(f"tile:{bm}x{bk}", fn, rec) / t_tiles
            # expected active tiles under random placement at this density
            tiles = (-(-int(m) // bm)) * (-(-int(k) // bk))
            p_active = 1.0 - (1.0 - density) ** (bm * bk)
            costs[(bm, bk)] = t_tile * tiles * max(p_active, 1e-12)
        if refused:
            rec["refused"] = refused
        if base not in costs:
            return
        best = min(costs, key=costs.get)
        if best != base and costs[best] < MEASURED_HYSTERESIS * costs[base]:
            rec["decisions"]["tile_shape"] = [int(best[0]), int(best[1])]

    @staticmethod
    def _tile_stream_call(a, b_blk, t_tiles, bm, bk):
        """B1 over ``t_tiles`` tiles, one window each, all against k-block
        0 of ``b_blk``: a zero-argument call with its window segments,
        chunk table and value flag built here, or None where B1 refuses
        the shape."""
        from ..kernels.dense_tile_spmm import (
            dense_tile_spmm, window_chunks, window_segments,
        )
        from .plan_ir import unsplittable_flag

        dev = a.device
        step_window = torch.arange(t_tiles, dtype=torch.int32, device=dev)
        step_col = torch.zeros(t_tiles, dtype=torch.int32, device=dev)
        try:
            segments = window_segments(step_window, t_tiles)
            chunks = window_chunks(segments[1])
            a_flag = unsplittable_flag(a)

            def fn():
                return dense_tile_spmm(
                    step_window, step_col, a, b_blk, num_windows=t_tiles,
                    bm=bm, bk=bk, segments=segments, chunks=chunks,
                    a_flag=a_flag)

            synchronize(fn())
        except Exception:  # noqa: BLE001 — a refused shape is left out
            return None
        return fn

    def _measure_fringe(self, rec, rows, cols, vals, b, rows_np, cols_np,
                        m_rep, k_rep, bn, config, vec_derived) -> None:
        """Sweep the fringe-tier candidates for this shape class.

        On the CPU the reference's proxies on the plain gather: every tier
        as the chunked gather (``chunk`` = the candidate's ``bk``).  On
        the card the kernels: "resident" on B2, each "ksharded" ``bk`` on
        B3 over the representative stream bucketed by that ``bk``, its
        row order cached before the timed call (bucketing inside it would
        time plan construction, not execution); no "xla" candidate (the
        H100 rule).  The analytic choice only loses to a candidate faster
        past the hysteresis.
        """
        from ..kernels import ops as kops
        from ..kernels.gather_spmm import kbucket_row_order
        from ..kernels.ops import effective_chunk
        from .plan_ir import bucket_fringe_kblocks

        impl = config.impl
        budget = (
            FRINGE_VMEM_BUDGET if config.fringe_vmem_budget is None
            else int(config.fringe_vmem_budget)
        )
        rows_f = max(m_rep // 4, 8)
        analytic_choice = select_fringe_tier(
            k_rep, rows_f, bn, vmem_budget=budget, impl=impl)
        cands = []
        if fringe_resident_bytes(k_rep, rows_f, bn) <= budget:
            cands.append(("resident", 0))
        cap = ksharded_bk_cap(k_rep, rows_f, bn, budget)
        bks = sorted({cap, max(SUBLANES, (cap // 2 // SUBLANES) * SUBLANES)})
        for bk in bks:
            if bk:
                cands.append(("ksharded", int(bk)))
        if impl != "cuda":
            cands.append(("xla", 0))

        times = {}
        for tier, bk in cands:
            if impl != "cuda" or tier == "resident":
                def fn(chunk=bk or None):
                    return kops.fringe_spmm(rows, cols, vals, b,
                                            num_rows=m_rep, impl=impl,
                                            chunk=chunk, derived=vec_derived)
            else:
                kbc, kbr, kbcol, kbv, _ = bucket_fringe_kblocks(
                    rows_np, cols_np, np.ones(rows_np.size, np.float32),
                    k_rep, bk, effective_chunk(config.fringe_chunk))
                kb = [torch.from_numpy(x).to(b.device)
                      for x in (kbc, kbr, kbcol, kbv)]
                derived = {"kbucket_row_order": kbucket_row_order(
                    kb[0], kb[1], kb[2], m_rep, bk)}

                def fn(bk=bk, kb=kb, derived=derived):
                    return kops.fringe_spmm(
                        rows, cols, vals, b, num_rows=m_rep, impl=impl,
                        tier="ksharded", bk=bk, kb_chunk=kb[0],
                        kb_rows=kb[1], kb_cols=kb[2], kb_vals=kb[3],
                        derived=derived)
            times[(tier, bk)] = self._timed(f"fringe:{tier}:{bk}", fn, rec)
        if not times:
            return
        base = times.get(analytic_choice)
        if base is None:
            base = min(times.values())
        best = min(times, key=times.get)
        if times[best] < MEASURED_HYSTERESIS * base:
            rec["decisions"]["fringe_tier"] = [best[0], int(best[1])]
        # else: the analytic choice stands; no decision recorded

    def _measure_sddmm(self, rec: dict, config: Any) -> None:
        """The SDDMM tier: no measurement and no decision on either impl.

        The reference measures only for its Pallas impls and returns at
        once for ``"xla"``, which never reads the tier; the port's
        ``"torch"`` is that impl.  On ``"cuda"`` the H100 rule leaves no
        choice: the only tier is the resident gather kernel (B5), so
        nothing is timed and no ``sddmm_tier`` is recorded.
        """
        return None

    # -- observability --------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "tune_calls": tune_call_count(),
                "table_hits": self.table_hits,
                "cold_misses": self.cold_misses,
                "measured": self.measured,
                "store_errors": self.store_errors,
                "records": len(self._table),
            }

    def report(self) -> dict:
        with self._lock:
            records = {
                key: {
                    "op": rec.get("op"),
                    "p_matrix": rec.get("p_matrix"),
                    "p_vector": rec.get("p_vector"),
                    "decisions": dict(rec.get("decisions", {})),
                    "bench_us": dict(rec.get("bench_us", {})),
                    "rep": dict(rec.get("rep", {})),
                }
                for key, rec in self._table.items()
            }
        return {
            "device": device_fingerprint(),
            "store_installed": _STORE is not None,
            "table_format_version": TABLE_FORMAT_VERSION,
            "counters": self.counters(),
            "xla_ignored": self.xla_ignored,
            "records": records,
        }


_TUNER = Tuner()


def get_tuner() -> Tuner:
    return _TUNER


def resolve_cost_model(
    op: str, m: int, k: int, nnz: int, config: Any
) -> EngineCostModel:
    """Module-level convenience over the process-wide tuner."""
    return _TUNER.resolve(op, m, k, nnz, config)


def tuning_report() -> dict:
    """Observability hook: device, counters, and every record's decisions."""
    return _TUNER.report()


def tuning_fallback_count() -> int:
    """Resolves that fell back to the analytic model (cold + corrupt)."""
    with _TUNER._lock:
        return _TUNER.cold_misses + _TUNER.store_errors


def reset_for_tests(keep_store: bool = False) -> None:
    """Fresh tuner state (table, counters, timer, optionally the store)."""
    global _TUNER, _STORE
    _TUNER = Tuner()
    reset_tune_call_count()
    reset_timer()
    if not keep_store:
        _STORE = None
