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
- :class:`KernelLoweringError` — a ``"cuda"`` dispatch failed (a kernel
  did not build, its library did not resolve, or a launch failed) and was
  recorded in the ``exec.health`` table, or the table refused the
  dispatch: the signature waits out its retry backoff or is demoted
  (quarantined).  The port has no degrade tier, so it always raises.
- :class:`DispatchError`       — an executor dispatch was rejected
  (operand/plan mismatch, operands on different devices).  A launch that
  returns an error status raises one too, which reaches the caller as
  the cause of a :class:`KernelLoweringError`.
- :class:`CompactionError`     — background sidecar folds failed; carries
  every per-matrix failure in ``.errors`` (ExceptionGroup-style).
- :class:`RegistryError`       — a persistent-registry entry is missing,
  corrupt, format-incompatible, or could not be written.
- :class:`AdmissionError`      — a request (or lifecycle operation) was
  refused by the serving front: bounded queue full under the ``reject``
  policy, shed under ``shed-oldest``, service closed, re-register with
  pending requests.
- :class:`DeadlineExceeded`    — a facade call (``deadline=``) or a
  per-request deadline finished too late, or a total-deadline wait
  (``drain_compactions``) ran out.
"""
from __future__ import annotations

from typing import Dict, Optional


class ReproError(Exception):
    """Root of every structured error the repro stack raises."""


class PlanBuildError(ReproError, ValueError):
    """A plan (or plan-adjacent state) could not be built or updated."""


class KernelLoweringError(ReproError, RuntimeError):
    """A ``"cuda"`` dispatch failed or was refused by the health gate."""


class DispatchError(ReproError, ValueError):
    """An executor dispatch was rejected, or a launch returned an error."""


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
    (``repro_torch.robust.faults``) — never raised outside tests/chaos
    runs."""
