"""Batched SpMM serving front: group per-matrix requests into one dispatch.
The port of ``repro.serve.spmm_service``.

Serving-style SpMM traffic is many small right-hand sides against a few
long-lived sparse matrices (GNN inference over a graph, repeated feature
panels).  :class:`SpmmService` keeps one prepared plan per registered
matrix and drains queued requests through the batched ``execute`` path:
each flush stacks up to ``max_batch`` panels into one ``(batch, K, N)``
operand, padded with zero panels to a power-of-two bucket, so that one
executor is built per ``(plan signature, bucket)`` instead of per ragged
batch size.  On the card one dispatch of a bucket is one launch of B1
(``dense_tile_spmm``) and one of the fringe kernel, whatever the bucket.

Dynamic graphs: every registered matrix is a ``dynamic.DynamicPlan``, so
``update_matrix(name, delta)`` applies edge inserts, deletes and value
changes between flushes: value changes are written into the plan's
tensors, structural changes ride the delta sidecar until the cost model
folds them in.  ``update_matrix`` drains that matrix's queue first, so
requests always run against the matrix they were submitted under.

Async compaction: when the cost model says a sidecar should fold
(``should_compact``), the fold runs on a worker thread against a
versioned COO snapshot while the serving path keeps executing the old
plan and its sidecar; the new plan is swapped in between drains
(``DynamicPlan.adopt_compacted``), and a fold that went stale (more
mutations landed meanwhile) is discarded and rescheduled.  The fold's
``prepare`` uploads its leaves on the worker thread's current stream and
the worker waits for the device before it hands the plan back
(:func:`_compact_build`), so no flush ever reads a plan whose uploads are
still in flight.  ``async_compaction=False`` folds inline instead.

Background tune: ``autotune=True`` is rewritten to ``"offline"`` (plans
read the tuned table or fall back to the analytic model, never measuring
inline), and the measurements run on the same worker; their records are
adopted between drains.  A ``"cuda"`` record runs on a CUDA stream of its
own (``core.tuner.Tuner.build_record``).

Persistence: with a ``dynamic.PlanRegistry``, ``register`` warm-starts
from disk when the stored entry matches the COO (no ``prepare`` runs),
``warm_start`` restores by name alone, updates re-persist the plan, and
an ``autotune`` service keeps the tuner's table there too.

No degrade tier.  The reference's matrix states are ``serving``,
``degraded`` and ``quarantined``; the port keeps the three names and the
``health()`` schema.  ``"degraded"`` means that ``exec.health`` is
retrying or refusing that matrix's signature: a ``"cuda"`` dispatch that
fails, or that the gate refuses, raises ``KernelLoweringError`` from
``flush`` with every undispatched request still queued, and nothing runs
on a plain version in its place.  ``"quarantined"`` is the reference's:
``quarantine_after`` consecutive fold failures stop the folds of one
matrix, which keeps serving through its sidecar.

Sharded plans are not ported (ROADMAP A-queue 6): ``register_sharded``
and ``warm_start(mesh=...)`` raise.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import spmm
from ..core import tuner as core_tuner
from ..core.plan_ir import general_format_sig
from ..dynamic import DynamicPlan, GraphDelta, PlanRegistry
from ..dynamic.tuning import install_registry_store
from ..errors import (
    AdmissionError, CompactionError, DeadlineExceeded, DispatchError,
    PlanBuildError, RegistryError, ReproError,
)
from ..exec import api as exec_api
from ..exec.health import HEALTH
from ..kernels.ops import pow2_at_least
from ..obs import REGISTRY, TRACES, instance_label
from ..robust.faults import HARNESS

#: Admission policies for a full per-matrix queue (``max_queue`` set).
ADMISSION_POLICIES = ("reject", "shed-oldest")

_SHARDING = ("sharded plans are not ported yet (ROADMAP A-queue 6: "
             "sharding)")


def _compact_build(name: str, dplan: DynamicPlan, rows, cols, vals):
    """Build the folded plan for a snapshot (the worker thread's seam).

    Module-level so that tests can patch in a slow build and show that the
    serving path keeps draining against the old plan until the swap; the
    ``fold_build`` fault seam fires here, so an injected failure travels
    the real future-exception path.  The device is synchronised before the
    plan is handed back: its uploads are complete by the swap.
    """
    HARNESS.fire("fold_build", context=name)
    plan = dplan.build_compacted(rows, cols, vals)
    core_tuner.synchronize(plan.device)
    return plan


def _bucket(batch: int, max_batch: int) -> int:
    """Smallest power of two >= batch, capped at max_batch (itself pow2)."""
    return min(pow2_at_least(batch), max_batch)


def _plan_nnz(plan) -> int:
    """Structural nnz of a plan (the tuner's shape-class input)."""
    stats = plan.stats_dict
    if "nnz" in stats:
        return int(stats["nnz"])
    um = getattr(plan, "update_maps", None)
    return int(um.nnz) if um is not None else 0


#: Every service's lifecycle counters in one registry metric; the per-
#: ``instance`` label keeps each ``SpmmService``'s counts independent.
_SERVICE_EVENTS = REGISTRY.counter(
    "service_events_total", "SpmmService lifecycle counters",
    labelnames=("event", "instance"), max_series=65536)


class ServiceStats:
    """Monotone serving counters, stored on the ``repro_torch.obs``
    registry.

    Named attributes read and ``+=`` as plain ints; they are views over
    ``service_events_total{event,instance}`` series, so ``health()`` and
    the Prometheus export see the same numbers.  Counters only go up:
    assigning a smaller value raises.
    """

    _FIELDS = (
        "requests",
        "flushes",
        "dispatches",
        "padded_slots",            # zero panels added to reach a bucket size
        "updates",                 # update_matrix calls applied
        "warm_starts",             # registrations served from the registry
        "compactions_scheduled",   # background folds submitted
        "compactions_applied",     # background folds swapped in
        "compactions_stale",       # folds discarded (snapshot went stale)
        "compactions_failed",      # folds whose build raised (fold_errors)
        "admission_rejected",      # submits refused (queue full, "reject")
        "admission_shed",          # oldest requests dropped ("shed-oldest")
        "deadline_expired",        # requests expired before their drain
        "quarantines",             # matrices quarantined (fold failures)
        "tunings_scheduled",       # background microbenchmark runs started
        "tunings_applied",         # tuned records adopted into the table
        "tunings_failed",          # background tunes whose build raised
    )

    def __init__(self) -> None:
        object.__setattr__(self, "_label", instance_label("svc"))

    def __getattr__(self, name: str) -> int:
        # only reached when normal lookup fails, i.e. for counter fields
        if name in self._FIELDS:
            return int(_SERVICE_EVENTS.value(event=name,
                                             instance=self._label))
        raise AttributeError(
            f"ServiceStats has no counter {name!r}; known: {self._FIELDS}")

    def __setattr__(self, name: str, value: int) -> None:
        if name not in self._FIELDS:
            raise AttributeError(
                f"ServiceStats has no counter {name!r}; known: "
                f"{self._FIELDS}")
        delta = int(value) - getattr(self, name)
        if delta < 0:
            raise ValueError(
                f"ServiceStats.{name} is monotone; cannot go from "
                f"{getattr(self, name)} to {value}")
        if delta:
            _SERVICE_EVENTS.inc(delta, event=name, instance=self._label)

    def as_dict(self) -> Dict[str, int]:
        return {f: getattr(self, f) for f in self._FIELDS}


class SpmmService:
    """Plan-cached, request-batching SpMM front end."""

    def __init__(self, config: spmm.SpmmConfig = spmm.SpmmConfig(),
                 max_batch: int = 8,
                 registry: Optional[PlanRegistry] = None,
                 persist_updates: bool = True,
                 async_compaction: bool = True,
                 max_queue: Optional[int] = None,
                 admission_policy: str = "reject",
                 quarantine_after: int = 3):
        if max_batch < 1:
            raise PlanBuildError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue is not None and max_queue < 1:
            raise PlanBuildError(f"max_queue must be >= 1, got {max_queue}")
        if admission_policy not in ADMISSION_POLICIES:
            raise PlanBuildError(
                f"admission_policy must be one of {ADMISSION_POLICIES}, "
                f"got {admission_policy!r}")
        if quarantine_after < 1:
            raise PlanBuildError(
                f"quarantine_after must be >= 1, got {quarantine_after}")
        # the serving thread never measures inline: autotune=True becomes
        # "offline" and the measurements run on the background worker
        self._background_tune = config.autotune is True
        if self._background_tune:
            config = dataclasses.replace(config, autotune="offline")
        if registry is not None and config.autotune:
            install_registry_store(registry)
        self.config = config
        # registry.save writes the whole plan (blocking disk I/O): heavy
        # mutation streams can persist only on registration and folds
        self.persist_updates = persist_updates
        # a power of two: a non-pow2 cap would add itself as a bucket size
        self.max_batch = pow2_at_least(int(max_batch))
        self.registry = registry
        self.async_compaction = bool(async_compaction)
        self.max_queue = max_queue  # None = unbounded
        self.admission_policy = admission_policy
        # consecutive fold failures before a matrix stops scheduling folds
        self.quarantine_after = quarantine_after
        self._plans: Dict[str, Any] = {}  # DynamicPlan | NeutronPlan
        # queue items: (ticket, panel, absolute monotonic deadline | None)
        self._queues: Dict[str, List[Tuple[int, torch.Tensor,
                                           Optional[float]]]] = {}
        self._results: Dict[int, torch.Tensor] = {}
        # tickets that completed with a typed error (shed, expired)
        self._failed: Dict[int, ReproError] = {}
        self._next_ticket = 0
        # background folds: name -> (snapshot version, Future[plan]); the
        # workers only build, the swap runs on the serving thread
        self._folds: Dict[str, Tuple[int, Future]] = {}
        # background tunes: name -> (table key, Future[(key, record)])
        self._tunes: Dict[str, Tuple[str, Future]] = {}
        self._fold_errors: Dict[str, BaseException] = {}
        self._fold_failures: Dict[str, int] = {}  # consecutive, per matrix
        self._fold_lock = threading.Lock()
        self._fold_pool: Optional[ThreadPoolExecutor] = None
        self._closed = False
        # injectable monotonic clock (deadline and span tests pin time)
        self._clock = time.monotonic
        self.stats = ServiceStats()
        # per-request tracing (SpmmConfig.telemetry): open traces keyed by
        # ticket, published to the repro_torch.obs ring when the request
        # completes; timestamps come from self._clock
        self._trace_enabled = bool(getattr(config, "telemetry", False))
        self._traces: Dict[int, Any] = {}

    @property
    def _dynamic_kwargs(self) -> Dict[str, bool]:
        # with async compaction the service owns the fold; the plan must
        # not also fold inline inside update()
        return {"auto_compact": not self.async_compaction}

    # -- matrix registration ------------------------------------------------
    def register(
        self,
        name: str,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: Tuple[int, int],
    ) -> None:
        """Prepare (or restore from the registry) a plan for a matrix."""
        self._check_reregister(name)
        if self.config.reorder_cols:
            # DynamicPlan rejects reorder_cols (sidecar columns address the
            # un-permuted operand): such matrices serve as static plans
            dplan: Any = spmm.prepare(rows, cols, vals, shape, self.config)
        elif self.registry is not None:
            before = spmm.prepare_call_count()
            dplan = self.registry.load_or_prepare(
                name, rows, cols, vals, shape, self.config,
                **self._dynamic_kwargs)
            if spmm.prepare_call_count() == before:
                self.stats.warm_starts += 1
        else:
            dplan = DynamicPlan(
                spmm.prepare(rows, cols, vals, shape, self.config),
                **self._dynamic_kwargs)
        self._plans[name] = dplan
        self._queues.setdefault(name, [])
        self._maybe_schedule_tune(name)

    def warm_start(self, name: str, mesh=None) -> None:
        """Restore a matrix from the registry by name alone (no COO, no
        ``prepare``), on this service's impl.  ``mesh`` (a sharded entry's
        re-shard target in the reference) raises: sharding is not
        ported."""
        if mesh is not None:
            raise PlanBuildError(f"warm_start(mesh=...): {_SHARDING}")
        if self.registry is None:
            raise RegistryError("warm_start needs a service registry")
        self._check_reregister(name)
        self._plans[name] = self.registry.load(
            name, impl=self.config.impl, **self._dynamic_kwargs)
        self.stats.warm_starts += 1
        self._queues.setdefault(name, [])
        self._maybe_schedule_tune(name)

    def register_sharded(self, name: str, splan) -> None:
        """Serve a matrix through a multi-device plan: not ported."""
        raise PlanBuildError(f"register_sharded({name!r}): {_SHARDING}")

    def _check_reregister(self, name: str) -> None:
        if self._closed:
            raise AdmissionError("service is closed")
        # panels queued against the old plan's K would dispatch against the
        # new one: the caller drains first
        if self._queues.get(name):
            raise AdmissionError(
                f"cannot re-register {name!r} with "
                f"{len(self._queues[name])} pending request(s); flush first")
        # a fold built from the old plan must never be adopted by the new
        # one (version counters restart): discard it, with any recorded
        # fold error and failure streak
        with self._fold_lock:
            stale = self._folds.pop(name, None)
            if stale is not None:
                stale[1].cancel()  # a running fold finishes, orphaned
            stale_tune = self._tunes.pop(name, None)
            if stale_tune is not None:
                stale_tune[1].cancel()
            self._fold_errors.pop(name, None)
            self._fold_failures.pop(name, None)

    def plan(self, name: str):
        return self._plans[name]

    def _inner_plan(self, name: str):
        p = self._plans[name]
        return p.plan if isinstance(p, DynamicPlan) else p

    # -- dynamic updates ----------------------------------------------------
    def update_matrix(self, name: str, delta: GraphDelta) -> Dict[str, int]:
        """Apply a mutation batch to a registered matrix.

        That matrix's pending requests are flushed first (they were
        submitted against the matrix before the update), other queues are
        left alone, and with a registry the updated plan is persisted so
        that a restart resumes from the mutated matrix.
        """
        if self._closed:
            raise AdmissionError("service is closed")
        if name not in self._plans:
            raise KeyError(f"no matrix registered under {name!r}")
        dplan = self._plans[name]
        if not isinstance(dplan, DynamicPlan):
            raise PlanBuildError(
                f"{name!r} was registered without update maps "
                "(reorder_cols); re-register it without reorder_cols to "
                "enable updates")
        self.flush(name=name)
        stats = dplan.update(delta)
        self.stats.updates += 1
        if self.async_compaction:
            self._maybe_schedule_fold(name, dplan)
        if self.registry is not None and (
                self.persist_updates or stats["compacted"]):
            self.registry.save(name, dplan)
        return stats

    # -- background compaction ----------------------------------------------
    def _pool(self) -> ThreadPoolExecutor:
        """The one worker (called under ``_fold_lock``)."""
        if self._fold_pool is None:
            self._fold_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="spmm-compact")
        return self._fold_pool

    def _maybe_schedule_fold(self, name: str, dplan: DynamicPlan) -> None:
        decision = dplan.last_decision
        if decision is None or not decision.compact:
            return
        with self._fold_lock:
            if self._closed:
                return  # shutdown: never recreate the pool
            if self._fold_failures.get(name, 0) >= self.quarantine_after:
                return  # quarantined: serve through the sidecar
            if name in self._folds:
                return  # one fold in flight per matrix
            version, rows, cols, vals = dplan.snapshot_for_compaction()
            fut = self._pool().submit(
                _compact_build, name, dplan, rows, cols, vals)
            self._folds[name] = (version, fut)
            self.stats.compactions_scheduled += 1

    def poll_compactions(self) -> int:
        """Swap in finished background folds; returns the swaps applied.

        Runs on the serving thread (also at every ``flush``), so a plan
        changes only between drains.  A fold whose snapshot went stale is
        discarded and rescheduled.  A fold whose build failed never aborts
        the poll: its error is recorded per matrix (``drain_compactions``,
        ``fold_errors``), and the next ``update_matrix`` schedules a fresh
        fold.
        """
        applied = 0
        with self._fold_lock:
            ready = [(n, v, f) for n, (v, f) in self._folds.items()
                     if f.done()]
            for n, _, _ in ready:
                del self._folds[n]
        for name, version, fut in ready:
            err = fut.exception()
            if err is not None:
                self._fold_errors[name] = err
                self.stats.compactions_failed += 1
                streak = self._fold_failures.get(name, 0) + 1
                self._fold_failures[name] = streak
                if streak == self.quarantine_after:
                    self.stats.quarantines += 1
                continue
            dplan = self._plans.get(name)
            if not isinstance(dplan, DynamicPlan):
                continue  # re-registered while folding: drop the result
            if dplan.adopt_compacted(fut.result(), expected_version=version):
                applied += 1
                self.stats.compactions_applied += 1
                self._fold_failures.pop(name, None)  # streak broken
                if self.registry is not None:
                    self.registry.save(name, dplan)
            else:
                self.stats.compactions_stale += 1
                self._maybe_schedule_fold(name, dplan)
        return applied

    def fold_errors(self) -> Dict[str, BaseException]:
        """Background-fold build failures per matrix (cleared on read)."""
        errors, self._fold_errors = self._fold_errors, {}
        return errors

    # -- background autotuning ----------------------------------------------
    def _maybe_schedule_tune(self, name: str) -> None:
        """Queue a microbenchmark pass for a cold shape class (with
        ``autotune=True`` only), on the compaction worker; the record is
        adopted between drains by :meth:`poll_tunings`.  Warm shape
        classes schedule nothing."""
        if not self._background_tune:
            return
        plan = self._inner_plan(name)
        m, k = plan.shape
        tun = core_tuner.get_tuner()
        nnz = _plan_nnz(plan)
        if tun.peek("spmm", int(m), int(k), nnz, plan.config) is not None:
            return
        with self._fold_lock:
            if self._closed:
                return
            if name in self._tunes:
                return  # one tune in flight per matrix
            key = core_tuner.table_key(
                "spmm", int(m), int(k), nnz, plan.config)
            fut = self._pool().submit(
                tun.build_record, "spmm", int(m), int(k), nnz, plan.config)
            self._tunes[name] = (key, fut)
            self.stats.tunings_scheduled += 1

    def poll_tunings(self) -> int:
        """Adopt finished background tunes; returns the records adopted.

        Runs on the serving thread (also at every ``flush``), like
        :meth:`poll_compactions`: the table and each affected matrix's
        compaction policy change only between drains.  A failed
        measurement is counted and dropped: serving goes on with the
        analytic model."""
        with self._fold_lock:
            ready = [(n, k, f) for n, (k, f) in self._tunes.items()
                     if f.done()]
            for n, _, _ in ready:
                del self._tunes[n]
        adopted = 0
        tun = core_tuner.get_tuner()
        for name, _, fut in ready:
            if fut.exception() is not None:
                self.stats.tunings_failed += 1
                continue
            key, rec = fut.result()
            tun.adopt(key, rec)
            adopted += 1
            self.stats.tunings_applied += 1
            dplan = self._plans.get(name)
            if isinstance(dplan, DynamicPlan):
                dplan.refresh_cost_model()
        return adopted

    def drain_tunings(self, timeout: Optional[float] = None) -> int:
        """Block until every tune in flight has finished and been adopted
        (or counted as failed); returns the records adopted.  ``timeout``
        bounds each wait (seconds); expiry raises
        :class:`DeadlineExceeded`."""
        adopted = 0
        while True:
            with self._fold_lock:
                futs = [f for _, f in self._tunes.values()]
            if not futs:
                return adopted
            for f in futs:
                try:
                    f.exception(timeout=timeout)  # failures: poll counters
                except _FutureTimeout:
                    raise DeadlineExceeded(
                        f"drain_tunings waited {timeout}s for a tune in "
                        "flight") from None
            adopted += self.poll_tunings()

    def tuning_report(self) -> dict:
        """The process-wide tuner's report (device, counters, records)."""
        return core_tuner.tuning_report()

    def drain_compactions(self, timeout: Optional[float] = None) -> int:
        """Block until every fold in flight has finished and been swapped
        in (or discarded as stale, rescheduled and finished); returns the
        swaps applied.

        ``timeout`` is a *total* deadline across every wait, on the
        service's clock; expiry raises :class:`DeadlineExceeded`.  Build
        failures aggregate into one :class:`CompactionError` carrying
        every recorded error in ``.errors``."""
        deadline = None if timeout is None else self._clock() + timeout
        applied = 0
        while True:
            with self._fold_lock:
                futs = [f for _, f in self._folds.values()]
            if not futs:
                errors = self.fold_errors()
                if errors:
                    summary = "; ".join(
                        f"{n}: {e}" for n, e in sorted(errors.items()))
                    raise CompactionError(
                        f"{len(errors)} background fold(s) failed: "
                        f"{summary}", errors=errors)
                return applied
            for f in futs:
                remaining = None
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        raise DeadlineExceeded(
                            f"drain_compactions exceeded its {timeout}s "
                            f"total deadline with folds still in flight")
                try:
                    f.exception(timeout=remaining)  # wait for completion
                except _FutureTimeout:
                    raise DeadlineExceeded(
                        f"drain_compactions exceeded its {timeout}s "
                        f"total deadline with folds still in flight"
                    ) from None
            applied += self.poll_compactions()

    def close(self) -> None:
        """Shut down: drain the folds and tunes in flight, stop the worker.

        Idempotent, and safe against a concurrent ``update_matrix``: the
        closed flag is checked under ``_fold_lock`` where folds are
        scheduled, so nothing recreates the pool after shutdown.  Fold
        errors recorded by then surface as a :class:`CompactionError`
        after the pool is torn down."""
        with self._fold_lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.drain_tunings()
            self.drain_compactions()
        finally:
            with self._fold_lock:
                pool, self._fold_pool = self._fold_pool, None
            if pool is not None:
                pool.shutdown(wait=True)

    def __enter__(self) -> "SpmmService":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            self.close()
        except ReproError:
            # never mask an exception already propagating
            if exc_type is None:
                raise
        return False

    # -- per-request tracing ------------------------------------------------
    def _now_us(self) -> float:
        return self._clock() * 1e6

    def _trace_fail(self, ticket: int, outcome: str) -> None:
        """Close a traced request that completed with a typed failure."""
        tr = self._traces.pop(ticket, None)
        if tr is None:
            return
        tr.attrs["outcome"] = outcome
        TRACES.end(tr, self._now_us())

    # -- request queue ------------------------------------------------------
    def submit(self, name: str, b, deadline: Optional[float] = None,
               timeout: Optional[float] = None) -> int:
        """Queue one (K, N) request panel (a tensor or an array, moved to
        the plan's device as fp32); returns a result ticket.

        Everything a dispatch could reject is checked here, while the
        request is still the caller's problem.  ``deadline`` (absolute, on
        the service's monotonic clock) or ``timeout`` (seconds from now)
        bounds the wait: a request still queued past its deadline at the
        next drain completes with :class:`DeadlineExceeded` (raised by
        ``fetch``).  With ``max_queue`` set, a full queue raises
        :class:`AdmissionError` (``"reject"``) or sheds the oldest queued
        request (``"shed-oldest"``: the shed ticket completes with
        :class:`AdmissionError`)."""
        t_admit = self._now_us() if self._trace_enabled else 0.0
        if self._closed:
            raise AdmissionError("service is closed")
        if name not in self._plans:
            raise KeyError(f"no matrix registered under {name!r}")
        plan = self._inner_plan(name)
        k = plan.shape[1]
        if b.ndim != 2 or b.shape[0] != k:
            raise DispatchError(
                f"request for {name!r} must be (K={k}, N), got "
                f"{tuple(b.shape)}")
        panel = torch.as_tensor(b).to(device=plan.device,
                                      dtype=torch.float32)
        queue = self._queues[name]
        if self.max_queue is not None and len(queue) >= self.max_queue:
            if self.admission_policy == "reject":
                self.stats.admission_rejected += 1
                raise AdmissionError(
                    f"queue for {name!r} is full "
                    f"({len(queue)}/{self.max_queue}); flush or raise "
                    f"max_queue")
            shed_ticket, _, _ = queue.pop(0)  # shed-oldest
            self._failed[shed_ticket] = AdmissionError(
                f"request {shed_ticket} for {name!r} was shed to admit a "
                f"newer request (queue full at {self.max_queue})")
            self.stats.admission_shed += 1
            self._trace_fail(shed_ticket, "shed")
        if timeout is not None:
            deadline = self._clock() + timeout if deadline is None else min(
                deadline, self._clock() + timeout)
        ticket = self._next_ticket
        self._next_ticket += 1
        queue.append((ticket, panel, deadline))
        self.stats.requests += 1
        if self._trace_enabled:
            now = self._now_us()
            tr = TRACES.begin(
                f"spmm:{name}", start_us=t_admit,
                ticket=ticket, matrix=name, n=int(b.shape[1]))
            TRACES.add_span(tr, "admit", t_admit, now, deadline=deadline)
            # queue_wait opens here and closes when flush takes the panel
            tr.attrs["queued_us"] = now
            self._traces[ticket] = tr
        return ticket

    def pending(self, name: Optional[str] = None) -> int:
        if name is not None:
            return len(self._queues.get(name, ()))
        return sum(len(q) for q in self._queues.values())

    # -- batched execution --------------------------------------------------
    def _execute(self, name: str, plan, stacked: torch.Tensor
                 ) -> torch.Tensor:
        HARNESS.fire("dispatch", context=name)
        if isinstance(plan, DynamicPlan):
            return plan.execute(stacked)
        return exec_api.execute(plan, stacked)

    def _expire_queue(self, name: str) -> None:
        """Complete overdue tickets with DeadlineExceeded, keep the rest."""
        queue = self._queues[name]
        if not any(d is not None for _, _, d in queue):
            return
        now = self._clock()
        keep: List[Tuple[int, torch.Tensor, Optional[float]]] = []
        for ticket, panel, d in queue:
            if d is not None and now >= d:
                self._failed[ticket] = DeadlineExceeded(
                    f"request {ticket} for {name!r} expired "
                    f"{now - d:.3f}s past its deadline before a drain")
                self.stats.deadline_expired += 1
                self._trace_fail(ticket, "expired")
            else:
                keep.append((ticket, panel, d))
        queue[:] = keep

    def flush(self, name: Optional[str] = None) -> int:
        """Drain queues through batched dispatches; returns the number of
        requests completed (their results then wait in ``fetch``).
        ``name`` drains one matrix's queue only.

        Panels of one matrix may differ in N: they are grouped by shape
        before stacking.  Requests leave the queue only after their
        dispatch succeeded, so a failed dispatch (a refused or failing
        ``"cuda"`` signature, an injected fault) propagates with every
        undispatched request still queued."""
        if name is not None and name not in self._queues:
            raise KeyError(f"no matrix registered under {name!r}")
        if self.async_compaction:
            self.poll_compactions()  # swap finished folds in between drains
        if self._background_tune:
            self.poll_tunings()  # adopt finished tunes between drains
        selected = (
            self._queues.items() if name is None
            else [(name, self._queues[name])]
        )
        done = 0
        for qname, queue in selected:
            plan = self._plans[qname]
            # expired requests complete with DeadlineExceeded up front
            self._expire_queue(qname)
            while queue:
                t_asm0 = self._now_us() if self._trace_enabled else 0.0
                # the FIFO head's shape defines this round's group
                shape = tuple(queue[0][1].shape)
                group = [item for item in queue
                         if tuple(item[1].shape) == shape][: self.max_batch]
                bucket = _bucket(len(group), self.max_batch)
                panels = [b for _, b, _ in group]
                if bucket > len(panels):  # zero panels up to the bucket
                    pad = torch.zeros_like(panels[0])
                    panels += [pad] * (bucket - len(panels))
                stacked = torch.stack(panels)
                t_disp0 = self._now_us() if self._trace_enabled else 0.0
                out = self._execute(qname, plan, stacked)
                if self._trace_enabled:
                    t_disp1 = self._now_us()
                    # the one telemetry-visible sync, on the same dispatch
                    core_tuner.synchronize(out)
                    t_block = self._now_us()
                # dispatch succeeded: now dequeue and record
                dispatched = {ticket for ticket, _, _ in group}
                queue[:] = [it for it in queue if it[0] not in dispatched]
                self.stats.dispatches += 1
                self.stats.padded_slots += bucket - len(group)
                for i, (ticket, _, _) in enumerate(group):
                    self._results[ticket] = out[i]
                    if not self._trace_enabled:
                        continue
                    tr = self._traces.get(ticket)
                    if tr is None:
                        continue
                    TRACES.add_span(tr, "queue_wait",
                                    tr.attrs.get("queued_us", t_asm0),
                                    t_asm0)
                    TRACES.add_span(tr, "batch_assembly", t_asm0, t_disp0,
                                    batch=len(group), bucket=bucket)
                    TRACES.add_span(tr, "dispatch", t_disp0, t_disp1)
                    TRACES.add_span(tr, "block_until_ready", t_disp1,
                                    t_block)
                done += len(group)
        self.stats.flushes += 1
        return done

    def fetch(self, ticket: int) -> torch.Tensor:
        """Pop a completed result (each ticket once).

        A ticket that completed with a typed failure (shed by admission,
        or expired past its deadline) raises that error here, once.
        Otherwise a KeyError says why the ticket has no result: never
        issued, still queued (flush first), or already fetched."""
        if ticket in self._results:
            t0 = self._now_us() if self._trace_enabled else 0.0
            out = self._results.pop(ticket)
            tr = self._traces.pop(ticket, None)
            if tr is not None:
                t1 = self._now_us()
                TRACES.add_span(tr, "fetch", t0, t1)
                tr.attrs["outcome"] = "ok"
                TRACES.end(tr, t1)
            return out
        if ticket in self._failed:
            raise self._failed.pop(ticket)
        if any(t == ticket for q in self._queues.values() for t, _, _ in q):
            raise KeyError(
                f"ticket {ticket} is still queued; call flush() first")
        if 0 <= ticket < self._next_ticket:
            raise KeyError(
                f"ticket {ticket} was already fetched (results pop once)")
        raise KeyError(f"unknown ticket {ticket} (never issued)")

    # -- observability ------------------------------------------------------
    def _degraded(self, name: str) -> bool:
        """Whether ``exec.health`` retries or refuses this matrix's
        signature: the plan's own, or the general payload's that a
        dispatch with a sidecar runs on."""
        sig = self._inner_plan(name).signature()
        return (HEALTH.is_degraded(sig)
                or HEALTH.is_degraded(general_format_sig(sig)))

    def health(self) -> Dict[str, Any]:
        """Structured serving-health report, in the reference's schema.

        Per-matrix state: ``serving``; ``degraded`` (``exec.health`` is
        retrying or refusing its signature: its dispatches raise until
        the signature recovers, nothing runs on a plain version);
        ``quarantined`` (``quarantine_after`` consecutive fold failures:
        it keeps serving through its sidecar and schedules no more
        folds; re-register to clear).  Plus queue depths, folds in
        flight, the service counters with the executor health table, the
        fault seams and the tuner folded in, and the registry's
        generation-fallback count when one is attached."""
        matrices: Dict[str, Dict[str, Any]] = {}
        with self._fold_lock:
            in_flight = set(self._folds)
            failures = dict(self._fold_failures)
        for name in sorted(self._plans):
            streak = failures.get(name, 0)
            if streak >= self.quarantine_after:
                state = "quarantined"
            elif self._degraded(name):
                state = "degraded"
            else:
                state = "serving"
            matrices[name] = {
                "state": state,
                "queue_depth": len(self._queues.get(name, ())),
                "fold_failures": streak,
                "fold_in_flight": name in in_flight,
            }
        stats = self.stats.as_dict()
        stats.update(
            {f"executor_{k}": v for k, v in HEALTH.snapshot().items()})
        stats["faults_fired"] = sum(HARNESS.counters()["fired"].values())
        stats.update(
            {f"tuner_{k}": v
             for k, v in core_tuner.get_tuner().counters().items()})
        if self.registry is not None:
            stats["registry_generation_fallbacks"] = (
                self.registry.generation_fallbacks)
        return {
            "closed": self._closed,
            "matrices": matrices,
            "stats": stats,
        }
