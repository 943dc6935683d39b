"""Structured error taxonomy for the NeutronSparse serving stack.

Every failure the execution stack can surface to a caller belongs to one
of the categories below, all rooted at :class:`ReproError`, so a serving
front can catch by *category* (``except ReproError``, ``except
RegistryError``) instead of pattern-matching bare ``ValueError`` /
``RuntimeError`` messages.  The classes dual-inherit the builtin type each
raise site historically used (``ValueError`` for validation-shaped
failures, ``RuntimeError`` for runtime ones, ``TimeoutError`` for
deadlines), so pre-taxonomy ``except ValueError`` call sites keep working —
the same pattern the stdlib ``OSError`` hierarchy uses.

Category map (who raises what):

- :class:`PlanBuildError`      — building or maintaining a plan: invalid
  config, malformed COO/``GraphDelta`` input, mutation of absent entries
  (``core`` plan builders keep raising ``ValueError`` directly; the layers
  above — ``exec``/``dynamic``/``serve`` — raise this).
- :class:`KernelLoweringError` — a pallas kernel failed to lower/compile;
  raised only when degradation to the XLA tier is disabled
  (``SpmmConfig.degrade_to_xla=False``), otherwise recorded in the
  ``exec.health`` table while the dispatch falls back.
- :class:`DispatchError`       — an executor dispatch was rejected
  (operand/plan mismatch) or failed on *every* tier, fallback included.
- :class:`NotPortedError`      — a :class:`DispatchError` for a call the
  port does not carry yet: ``SparseMatrix @ SparseMatrix`` (``spspmm``).
  It names the missing piece.
- :class:`CompactionError`     — background sidecar folds failed; carries
  every per-matrix failure in ``.errors`` (ExceptionGroup-style).
- :class:`RegistryError`       — a persistent-registry entry is missing,
  corrupt, format-incompatible, or could not be written.
- :class:`AdmissionError`      — a request (or lifecycle operation) was
  refused by the serving front: bounded queue full under the ``reject``
  policy, shed under ``shed-oldest``, service closed, re-register with
  pending requests.
- :class:`DeadlineExceeded`    — a per-request deadline expired before its
  drain, or a total-deadline wait (``drain_compactions``) ran out.
"""
from __future__ import annotations

from typing import Dict, Optional


class ReproError(Exception):
    """Root of every structured error the repro stack raises."""


class PlanBuildError(ReproError, ValueError):
    """A plan (or plan-adjacent state) could not be built or updated."""


class KernelLoweringError(ReproError, RuntimeError):
    """A pallas kernel failed to lower or compile for this plan."""


class DispatchError(ReproError, ValueError):
    """An executor dispatch was rejected or failed on every tier."""


class NotPortedError(DispatchError):
    """The call needs a part of the reference the port does not carry
    yet; the message names it."""


class CompactionError(ReproError, RuntimeError):
    """One or more background compaction folds failed.

    ``errors`` maps matrix name -> the exception its fold raised, so a
    multi-failure drain surfaces every failure instead of the first one
    (the rest used to be silently discarded by the ``fold_errors()``
    clear-on-read).
    """

    def __init__(self, message: str,
                 errors: Optional[Dict[str, BaseException]] = None):
        super().__init__(message)
        self.errors: Dict[str, BaseException] = dict(errors or {})


class RegistryError(ReproError, RuntimeError):
    """A registry entry is missing, corrupt, format-incompatible, or
    could not be persisted."""


class AdmissionError(ReproError, RuntimeError):
    """The serving front refused to admit a request or operation."""


class DeadlineExceeded(ReproError, TimeoutError):
    """A request deadline (or a total-deadline wait) expired."""


class FaultInjected(ReproError, RuntimeError):
    """Default exception raised by an armed fault-injection seam
    (``repro.robust.faults``) — never raised outside tests/chaos runs."""
