"""Deterministic fault-injection harness for the port: the copy of
``repro.robust.faults``.

The execution stack has a handful of places where real deployments fail:
executor builds, kernel lowering, background compaction folds, registry
reads/writes, and the dispatch itself.  Each of those is a *named seam* —
a ``HARNESS.fire(seam, context=...)`` call in the production code path.
When the seam is disarmed (the default, and the only state outside
tests/chaos runs) ``fire`` is a counter bump plus a dict lookup; when a
test arms it, ``fire`` raises a chosen exception according to a
deterministic policy (fail-once, fail-N-times, fail-after-K, fail only on
matching context).

Determinism rules:

- Policies trigger on per-seam *call counts*, never wall-clock time or
  ambient randomness; a given arm schedule against a given workload fails
  at exactly the same calls every run.
- ``chaos_schedule(seed)`` derives per-seam offsets from an explicit
  ``numpy.random.RandomState`` seed, over the reference's six seam names
  in the same order, so one seed draws the same offsets in both packages.

Seam catalogue (where each fires in the port):

==================  ======================================================
seam                fire site
==================  ======================================================
``executor_build``  top of ``exec.pipeline._build`` — once per executor
                    *build* (cache hits do not fire); context = signature
``pallas_lowering`` the port has no Pallas: ``exec.pipeline._build``, for
                    a ``"cuda"`` signature only, after ``executor_build``
                    — where the reference lowers its Pallas tiers;
                    context = signature
``fold_build``      ``serve.spmm_service._compact_build``, on the worker
                    thread before the folded plan is built; context =
                    matrix name
``registry_write``  ``dynamic.registry.PlanRegistry._write_entry``, before
                    the checkpoint save; context = entry name
``registry_read``   ``dynamic.registry.PlanRegistry._read_step``, before
                    each generation's manifest is read; context = name
``dispatch``        ``serve.spmm_service.SpmmService._execute``, before
                    each batched dispatch; context = matrix name
==================  ======================================================
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional, Type

from ..errors import FaultInjected
from ..obs import REGISTRY, instance_label

# seam activity publishes to the shared metrics registry; the per-
# ``harness`` instance label keeps ``reset()`` (fresh label) from erasing
# another harness's history, and gives health()/Prometheus one view of
# seam traffic
_SEAM_CALLS = REGISTRY.counter(
    "fault_seam_calls_total", "fire-site traversals per fault seam",
    labelnames=("seam", "harness"), max_series=8192)
_SEAM_FIRED = REGISTRY.counter(
    "fault_seam_fired_total", "injected faults raised per seam",
    labelnames=("seam", "harness"), max_series=8192)

SEAMS = frozenset({
    "executor_build",
    "pallas_lowering",
    "fold_build",
    "registry_write",
    "registry_read",
    "dispatch",
})


def _check_seam(seam: str) -> str:
    if seam not in SEAMS:
        raise ValueError(
            f"unknown fault seam {seam!r}; valid seams: {sorted(SEAMS)}")
    return seam


@dataclass
class FaultPolicy:
    """When and how an armed seam fails.

    ``after`` matching calls pass through, then the next ``times`` matching
    calls raise ``exc`` (``times=None`` -> fail forever).  ``match``
    filters by the ``context`` the fire site passes (e.g. only fail builds
    of pallas-impl signatures); non-matching calls neither fail nor
    consume the policy's budget.
    """

    exc: Type[BaseException] = FaultInjected
    times: Optional[int] = 1
    after: int = 0
    match: Optional[Callable[[Any], bool]] = None
    message: str = ""
    # bookkeeping (mutated under the harness lock)
    matched: int = field(default=0, init=False)
    fired: int = field(default=0, init=False)

    def should_fire(self, context: Any) -> bool:
        if self.match is not None and not self.match(context):
            return False
        self.matched += 1
        if self.matched <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True

    def build_exc(self, seam: str, context: Any) -> BaseException:
        msg = self.message or (
            f"injected fault at seam {seam!r}"
            + (f" (context={context!r})" if context is not None else ""))
        return self.exc(msg)


class FaultHarness:
    """Registry of armed seams + per-seam call counters. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._policies: Dict[str, FaultPolicy] = {}
        self._label = instance_label("harness")

    def _series(self, counter) -> Dict[str, int]:
        """{seam: count} for this harness's series of ``counter``."""
        return {
            seam: int(v)
            for (seam, label), v in counter.series().items()
            if label == self._label
        }

    # -- arming -----------------------------------------------------------
    def arm(self, seam: str, *, exc: Type[BaseException] = FaultInjected,
            times: Optional[int] = 1, after: int = 0,
            match: Optional[Callable[[Any], bool]] = None,
            message: str = "") -> FaultPolicy:
        policy = FaultPolicy(exc=exc, times=times, after=after, match=match,
                             message=message)
        with self._lock:
            self._policies[_check_seam(seam)] = policy
        return policy

    def disarm(self, seam: str) -> None:
        with self._lock:
            self._policies.pop(_check_seam(seam), None)

    def reset(self) -> None:
        """Disarm every seam and zero all counters."""
        with self._lock:
            self._policies.clear()
            # fresh instance label: this harness's series restart at zero
            self._label = instance_label("harness")

    # -- the production hook ---------------------------------------------
    def fire(self, seam: str, context: Any = None) -> None:
        """Called from production code at each named seam.

        Disarmed (the default): bumps the seam's call counter and returns.
        Armed: raises the policy's exception when the policy says so.
        """
        with self._lock:
            _SEAM_CALLS.inc(seam=seam, harness=self._label)
            policy = self._policies.get(seam)
            if policy is None or not policy.should_fire(context):
                return
            _SEAM_FIRED.inc(seam=seam, harness=self._label)
            raise policy.build_exc(seam, context)

    # -- introspection ----------------------------------------------------
    def calls(self, seam: str) -> int:
        with self._lock:
            return int(_SEAM_CALLS.value(seam=_check_seam(seam),
                                         harness=self._label))

    def fired(self, seam: Optional[str] = None) -> int:
        with self._lock:
            if seam is None:
                return sum(self._series(_SEAM_FIRED).values())
            return int(_SEAM_FIRED.value(seam=_check_seam(seam),
                                         harness=self._label))

    def armed_seams(self) -> Dict[str, FaultPolicy]:
        with self._lock:
            return dict(self._policies)

    def counters(self) -> Dict[str, Dict[str, int]]:
        """Snapshot for ``SpmmService.health()``: calls + fires per seam.

        Same shape as the pre-registry dicts: only seams actually seen
        appear (a registry series exists only after its first increment).
        """
        with self._lock:
            return {
                "calls": self._series(_SEAM_CALLS),
                "fired": self._series(_SEAM_FIRED),
            }


#: Module-level singleton every fire site uses.  Tests arm/disarm this
#: instance (or use the ``armed`` context manager, which restores state).
HARNESS = FaultHarness()


@contextmanager
def armed(seam: str, **kwargs: Any) -> Iterator[FaultPolicy]:
    """``with armed("fold_build", times=2): ...`` — disarms on exit."""
    policy = HARNESS.arm(seam, **kwargs)
    try:
        yield policy
    finally:
        HARNESS.disarm(seam)


def chaos_schedule(seed: int, *, seams: Optional[Iterator[str]] = None,
                   max_offset: int = 8,
                   exc: Type[BaseException] = FaultInjected) -> Dict[str, int]:
    """Arm each seam fail-once at a seeded random call offset.

    Returns {seam: offset} so the chaos run can log its schedule.  Uses an
    explicit ``RandomState`` so the same seed always produces the same
    schedule (the CI chaos leg seeds from the run id and prints it).
    """
    import numpy as np

    rng = np.random.RandomState(seed)
    schedule: Dict[str, int] = {}
    for seam in sorted(seams if seams is not None else SEAMS):
        offset = int(rng.randint(0, max_offset))
        HARNESS.arm(seam, exc=exc, times=1, after=offset)
        schedule[seam] = offset
    return schedule
