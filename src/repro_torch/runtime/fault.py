"""Failure injection, detection, and elastic re-mesh planning (counterpart
of ``repro.runtime.fault``).

Real clusters lose hosts; the contract here is:
  * any step may raise (SimulatedFailure stands in for a dead host / link
    timeout / preemption);
  * the trainer catches, consults ``plan_remesh`` for a degraded-but-valid
    mesh (shrink the data axis — TP degree is fixed by the model's layout),
  * rebuilds its steps on the new topology and restores the latest
    checkpoint with the NEW shardings, then continues.

A re-mesh also invalidates everything the offload subsystem derived from the
old topology: cached collective plans key on axis sizes, and the tuning
table's (p, payload) grid no longer matches the surviving mesh. Interested
parties (an engine plus a budgeted re-tune) subscribe with :func:`register_remesh_listener`; whoever *adopts* a new
topology (the trainer's recovery path) fires :func:`notify_remesh` with the
applied axis sizes — ``plan_remesh`` itself is a pure feasibility query.
Listeners must never block recovery — exceptions are swallowed into
:data:`remesh_listener_errors`.

Straggler mitigation lives in runtime/straggler.py; here we only decide
membership.

The error family differs from the reference's on purpose: a dead host or a
torn collective surfaces through PyTorch as ``torch.distributed.DistError``
(``DistBackendError``, ``DistNetworkError`` and ``DistStoreError`` are its
subclasses), not as a JAX/XLA runtime error, and ``torch.OutOfMemoryError``
is never recoverable.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.core.packet import IntegrityError
from repro_torch.obs import events as obs_events
from repro_torch.runtime.chaos import TransportError

RemeshListener = Callable[[Tuple[int, ...], Tuple[int, ...]], None]

_REMESH_LISTENERS: List[RemeshListener] = []

#: (listener, exception) pairs from listeners that raised during notify
remesh_listener_errors: List[Tuple[RemeshListener, Exception]] = []


def register_remesh_listener(fn: RemeshListener) -> RemeshListener:
    """Subscribe ``fn(old_axes, new_axes)`` to re-mesh plans; returns ``fn``
    so it can be handed back to :func:`unregister_remesh_listener`."""
    _REMESH_LISTENERS.append(fn)
    return fn


def unregister_remesh_listener(fn: RemeshListener) -> None:
    try:
        _REMESH_LISTENERS.remove(fn)
    except ValueError:
        pass


def notify_remesh(
    old_axes: Tuple[int, ...], new_axes: Tuple[int, ...]
) -> None:
    """Fire every registered listener; a failing listener is recorded in
    ``remesh_listener_errors`` and never interrupts recovery.

    The event lands in the flight recorder, and — since a re-mesh means a
    recovery is in progress — the recorder auto-dumps its ring to
    ``$REPRO_FLIGHT_RECORD`` (if set) *before* listeners run, so even a
    listener wedging the process leaves a post-mortem on disk."""
    obs_events.record(
        "remesh", old_axes=tuple(old_axes), new_axes=tuple(new_axes)
    )
    obs_events.auto_dump("remesh")
    for fn in list(_REMESH_LISTENERS):
        try:
            fn(old_axes, new_axes)
        except Exception as e:  # pragma: no cover - defensive
            remesh_listener_errors.append((fn, e))


class SimulatedFailure(RuntimeError):
    """Stands in for a lost host / hung collective.

    ``lost_hosts`` is the failure-detector's estimate of how many hosts the
    event took out — the recovery path feeds it to :func:`plan_remesh` so the
    feasibility query is about the *actual* surviving capacity.
    """

    lost_hosts: int = 1


def _collective_error_types() -> Tuple[type, ...]:
    """The runtime-error family a dead host surfaces as through PyTorch.

    A hung or torn collective does not raise SimulatedFailure — it comes
    back as ``torch.distributed.DistError`` (backend, network and store
    errors are its subclasses), present when the build has the distributed
    package.
    """
    errs: List[type] = [SimulatedFailure]
    if torch.distributed.is_available():
        errs.append(torch.distributed.DistError)
    return tuple(errs)


#: exception types the trainer's recovery loop treats as a host failure
RECOVERABLE_ERRORS: Tuple[type, ...] = _collective_error_types()

#: status words that signal a caller bug or resource problem, not a dead
#: host — a runtime error carrying one must propagate, never remesh
_NON_FAILURE_CODES = (
    "RESOURCE_EXHAUSTED",
    "INVALID_ARGUMENT",
    "NOT_FOUND",
    "ALREADY_EXISTS",
    "UNIMPLEMENTED",
    "PERMISSION_DENIED",
    "OUT_OF_RANGE",
)

#: reliability-layer faults are *transport/data* problems the dispatch
#: layer owns (retry, degrade, quarantine) — never host failures. A remesh
#: would roll back a checkpoint to "fix" a corrupt payload. These are
#: checked both as types and as message markers (for wrapped runtime
#: errors that only carry the upstream error's text).
_NON_RECOVERABLE_TYPES: Tuple[type, ...] = (
    IntegrityError, TransportError, torch.OutOfMemoryError,
)

_NON_RECOVERABLE_MARKERS = (
    "IntegrityError",
    "TransportError",
    "RetryExhausted",
    "CircuitOpen",
    "checksum mismatch",
)

_REL_ERRORS: Optional[Tuple[type, ...]] = None


def _reliability_error_types() -> Tuple[type, ...]:
    """RetryExhaustedError/CircuitOpenError, imported lazily: fault.py
    loads at ``repro_torch.runtime`` init, before ``repro_torch.offload``
    may exist."""
    global _REL_ERRORS
    if _REL_ERRORS is None:
        try:
            from repro_torch.offload.reliability import (
                CircuitOpenError,
                RetryExhaustedError,
            )

            _REL_ERRORS = (RetryExhaustedError, CircuitOpenError)
        except Exception:  # pragma: no cover - partial-import window
            return ()
    return _REL_ERRORS


def is_recoverable(err: BaseException) -> bool:
    """Whether the recovery loop should treat ``err`` as a host failure.

    SimulatedFailure always is. Reliability-layer faults — IntegrityError,
    TransportError, retry exhaustion, open circuits — never are: they are
    per-request dispatch problems with their own handling (retry /
    degrade / quarantine), and swallowing them as remesh triggers would
    shrink the mesh over a corrupt payload; nor is running out of device
    memory (``torch.OutOfMemoryError``). A ``torch.distributed`` error is
    recoverable *unless* its message marks a non-transient caller problem
    or a wrapped reliability fault.
    """
    if isinstance(err, SimulatedFailure):
        return True
    if isinstance(err, _NON_RECOVERABLE_TYPES):
        return False
    if isinstance(err, _reliability_error_types()):
        return False
    if not isinstance(err, RECOVERABLE_ERRORS):
        return False
    msg = str(err)
    if any(marker in msg for marker in _NON_RECOVERABLE_MARKERS):
        return False
    return not any(code in msg for code in _NON_FAILURE_CODES)


@dataclasses.dataclass
class FailureInjector:
    """Raises at configured step numbers (once each) and, optionally,
    probabilistically per dispatch.

    ``lost_hosts`` stamps the raised SimulatedFailure; ``exc_factory``
    substitutes an arbitrary exception (e.g. a DistBackendError, or a
    TransportError to exercise the dispatch layer's retry path) to
    exercise the matching recovery path.

    ``rate``/``seed`` enable the sub-step-granular mode: the reliable
    dispatcher calls :meth:`check_dispatch` before every dispatch attempt,
    and each call draws a deterministic seeded verdict keyed by ``(seed,
    dispatch_index)`` — the same injector config always fails the same
    dispatches, so chaos runs are reproducible.
    """

    fail_at: Tuple[int, ...] = ()
    lost_hosts: int = 1
    exc_factory: Optional[Callable[[int], BaseException]] = None
    rate: float = 0.0
    seed: int = 0
    _fired: set = dataclasses.field(default_factory=set)
    _dispatches: int = 0

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            if self.exc_factory is not None:
                raise self.exc_factory(step)
            err = SimulatedFailure(f"injected failure at step {step}")
            err.lost_hosts = self.lost_hosts
            raise err

    def check_dispatch(self) -> None:
        """Probabilistic per-dispatch injection (seeded, deterministic).

        Advances the dispatch counter on every call — retried attempts
        draw fresh verdicts, exactly like real transient faults.
        """
        if self.rate <= 0.0:
            return
        n = self._dispatches
        self._dispatches += 1
        u = np.random.default_rng((int(self.seed), n)).random()
        if u < self.rate:
            obs_events.record("chaos_fault", fault="dispatch", msg=n)
            if self.exc_factory is not None:
                raise self.exc_factory(n)
            err = SimulatedFailure(f"injected dispatch failure (#{n})")
            err.lost_hosts = self.lost_hosts
            raise err


def plan_remesh(
    data_axis: int, model_axis: int, lost_hosts: int, hosts_per_slice: int = 1
) -> Optional[Tuple[int, int]]:
    """New (data, model) axis sizes after losing hosts.

    The model axis is load-bearing (parameter layout); we only shrink the
    data axis, to the largest power-of-two that the surviving hosts support.
    Returns None when no valid mesh remains. Pure: planning is a feasibility
    query — whoever *adopts* a plan calls :func:`notify_remesh` with the
    applied topology (the trainer's recovery path does).
    """
    surviving = data_axis - lost_hosts * hosts_per_slice
    if surviving < 1:
        return None
    new_data = 1 << (surviving.bit_length() - 1)  # floor pow2
    return (new_data, model_axis)


def rescale_batch(global_batch: int, old_data: int, new_data: int) -> int:
    """Keep per-replica batch fixed; the global batch shrinks with the mesh.

    (Alternative — fixed global batch with more grad accumulation — is a
    config flag in the trainer.)
    """
    per = global_batch // old_data
    return per * new_data
