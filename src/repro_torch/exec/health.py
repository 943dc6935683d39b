"""Per-signature executor health: bounded retry, then sticky demotion.

The port of ``repro.exec.health``, with no degrade tier.  When a
``"cuda"`` dispatch fails (its executor build, the kernel library's
resolution or a launch), ``exec.api._guarded_call`` records the failure
here and raises :class:`~repro_torch.errors.KernelLoweringError`: a
``"cuda"`` plan launches its kernels or raises, and no plain version ever
runs in place of a kernel on the card.  The signature is retried on an
exponential *call-count* backoff — after failure ``n`` the kernels are
next attempted ``backoff_base**n`` dispatches later, and every dispatch
before that raises without building or launching anything — and after
``max_retries`` consecutive failures the demotion sticks: every later
dispatch of that signature raises at once.  A success anywhere in the
retry window fully recovers the signature.

Counting dispatches instead of wall-clock keeps the schedule deterministic
(same workload -> same retry calls), which is what the fault-injection
tests pin down.  State is process-wide (one table next to the executor
cache) and keyed by the exact plan signature, so one broken kernel shape
never poisons its neighbours.

Aggregate counts publish to ``exec_health_events_total{event,table}`` on
the ``repro_torch.obs`` registry; the per-``table`` instance label keeps
one table's ``reset()`` from zeroing another's history.  Registry
increments happen inside the table lock, so :meth:`HealthTable.snapshot`
— which reads the per-signature dicts *and* the counters under that same
lock — is an atomic point-in-time view even while dispatch threads are
calling ``record_*``.  The snapshot keeps the reference's ``fallbacks``
key so that the two packages report one schema; in the port it is always
0, because no dispatch is ever served by another tier.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..obs import REGISTRY, instance_label

_EVENTS = REGISTRY.counter(
    "exec_health_events_total",
    "executor health events (failure/demotion/recovery)",
    labelnames=("event", "table"),
    max_series=8192,
)


@dataclass
class _SigHealth:
    calls_seen: int = 0              # dispatches of this sig routed via gate
    consecutive_failures: int = 0
    failures: int = 0                # lifetime accel failures
    next_retry_call: int = 0         # calls_seen threshold to retry accel
    demoted: bool = False            # sticky: accel never re-attempted
    last_error: str = ""

    @property
    def state(self) -> str:
        if self.demoted:
            return "demoted"
        if self.consecutive_failures:
            return "retrying"
        return "healthy"


class HealthTable:
    """Thread-safe per-signature health records + registry-backed counters."""

    def __init__(self, max_retries: int = 3, backoff_base: int = 2) -> None:
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self._lock = threading.Lock()
        self._sigs: Dict[Tuple, _SigHealth] = {}
        self._label = instance_label("health")

    def _count(self, event: str) -> None:
        # lock ordering is always table lock -> registry lock; the registry
        # never calls back into the table, so this cannot deadlock
        _EVENTS.inc(event=event, table=self._label)

    def _value(self, event: str) -> int:
        return int(_EVENTS.value(event=event, table=self._label))

    def _rec(self, sig: Tuple) -> _SigHealth:
        rec = self._sigs.get(sig)
        if rec is None:
            rec = self._sigs[sig] = _SigHealth()
        return rec

    def should_try_accel(self, sig: Tuple) -> bool:
        """Gate an accelerated dispatch; call once per dispatch of ``sig``."""
        with self._lock:
            rec = self._rec(sig)
            rec.calls_seen += 1
            if rec.demoted:
                return False
            if rec.consecutive_failures == 0:
                return True
            return rec.calls_seen >= rec.next_retry_call

    def record_failure(self, sig: Tuple, err: BaseException) -> None:
        with self._lock:
            rec = self._rec(sig)
            rec.failures += 1
            rec.consecutive_failures += 1
            rec.last_error = f"{type(err).__name__}: {err}"
            self._count("failure")
            if rec.consecutive_failures > self.max_retries:
                if not rec.demoted:
                    rec.demoted = True
                    self._count("demotion")
            else:
                rec.next_retry_call = rec.calls_seen + (
                    self.backoff_base ** rec.consecutive_failures)

    def record_success(self, sig: Tuple) -> None:
        with self._lock:
            rec = self._rec(sig)
            if rec.consecutive_failures and not rec.demoted:
                self._count("recovery")
            if not rec.demoted:
                rec.consecutive_failures = 0
                rec.next_retry_call = 0

    def refusal(self, sig: Tuple) -> str:
        """Why the gate refused the last dispatch of ``sig``: its state,
        with the dispatch number of the next attempt while it retries."""
        with self._lock:
            rec = self._rec(sig)
            if rec.demoted:
                return (f"demoted after {rec.consecutive_failures} "
                        f"consecutive failures")
            return (f"retrying: dispatch {rec.calls_seen} of this signature "
                    f"is inside its backoff, next attempt at dispatch "
                    f"{rec.next_retry_call}")

    def is_degraded(self, sig: Tuple) -> bool:
        """True while ``sig`` is retrying or demoted: its dispatches raise
        inside the backoff, or always once demoted."""
        with self._lock:
            rec = self._sigs.get(sig)
            return bool(rec and rec.state != "healthy")

    def state(self, sig: Tuple) -> str:
        with self._lock:
            rec = self._sigs.get(sig)
            return rec.state if rec else "healthy"

    def last_error(self, sig: Tuple) -> Optional[str]:
        with self._lock:
            rec = self._sigs.get(sig)
            return rec.last_error or None if rec else None

    def snapshot(self) -> Dict[str, object]:
        """Aggregate view (the reference folds it into
        ``SpmmService.health()``).

        Atomic: signature states and counters are read under the same lock
        the ``record_*`` mutators take.
        """
        with self._lock:
            states = [r.state for r in self._sigs.values()]
            return {
                "signatures": len(self._sigs),
                "demoted": states.count("demoted"),
                "retrying": states.count("retrying"),
                "failures": self._value("failure"),
                "fallbacks": 0,   # no degrade tier: see the module docstring
                "demotions": self._value("demotion"),
                "recoveries": self._value("recovery"),
            }

    def reset(self) -> None:
        with self._lock:
            self._sigs.clear()
            # fresh instance label: this table's series restart at zero
            # without disturbing any other table's history
            self._label = instance_label("health")


#: Process-wide table used by ``exec.api``'s guarded dispatch.
HEALTH = HealthTable()
