"""The self-healing data plane: per-collective deadlines, the leg guard's
retry, degraded routing with re-promotion, and wire integrity.

Counterpart of ``horovod_tpu.common.resilience``:

* **Deadlines.**  Each collective the engine executes carries a deadline
  (``collective_deadline``, scaled by its bytes); the engine's watchdog
  error-completes an expired one and poisons the engine
  (``CollectiveDeadlineExceeded``, ``ops/engine.py``), whose message never
  holds the stall inspector's abort text.
* **Leg retry.**  The hierarchical legs run through ``run_hier_leg``,
  which retries transient faults (``is_transient_leg``) with exponential
  backoff and full jitter under the group deadline; a leg that spends its
  budget raises ``LegDegraded`` and its caller runs that call flat.
* **Degraded routing.**  ``HOROVOD_LEG_DEMOTE_THRESHOLD`` consecutive
  exhaustions of one (op, size class) make rank 0 demote it to the flat
  path; ``HOROVOD_LEG_REPROBE_SECS`` later it promotes it again.  The
  reference publishes rank 0's verdicts through the rendezvous KV; here
  ``check_degraded_routes`` rides the engine's cycle as a request, like
  ``join``: rank 0 decides (``decide_routes``) in the cycle where every
  rank has asked, and every rank applies the verdicts of that cycle's
  response (``apply_routes``) before it executes anything else in it.
  A one-rank world decides locally.
* **Wire integrity.**  A quant-coded leg checksums (CRC32) its CPU
  payload before and after the exchange; a mismatch (or the injected
  ``mh.leg.corrupt``) re-runs the leg once, then raises
  ``WireIntegrityError``.  CUDA tensors are never checksummed: reading
  them back would stall the device, as the reference leaves device arrays
  out.

**Retry boundary.**  Only failures that surface synchronously on the host
are retried: gloo errors and every injected site.  An NCCL fault surfaces
later, at completion, and fails through the engine.  ``run`` must be safe
to call again after such a failure: the legs start each attempt from the
caller's payload and commit their error-feedback residuals only once the
exchange succeeded (``ops/multihost.py``).

Deliberate differences from the reference: ``torch.distributed``'s
``DistNetworkError`` counts as transient, like ``ConnectionError``; the
verdict rides the controller, not a KV; the plan cache's pin of a
demoted route waits for the plan cache; ``maybe_check_at_commit`` waits
for elastic state.
"""

from __future__ import annotations

import binascii
import logging
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import faultline, metrics
from .config import env_float, env_int

LOG = logging.getLogger("horovod_tpu_torch")

# Per-sleep cap on the leg retry backoff (the group deadline bounds the
# total anyway).
_BACKOFF_CAP_S = 5.0

_GIB = float(1 << 30)


class LegTransportError(RuntimeError):
    """A cross-node leg transport fault (injected or classified)."""


class WireIntegrityError(RuntimeError):
    """Checksum mismatch over a cross-node wire payload."""


class LegDegraded(RuntimeError):
    """A hierarchical leg spent its retry budget and degraded routing is
    on: the caller runs this call flat.  Never crosses the engine."""

    def __init__(self, op: str, size_class: str, cause: BaseException):
        super().__init__(
            "hier %s[%s] leg exhausted its transient-retry budget: %s"
            % (op, size_class, cause))
        self.op = op
        self.size_class = size_class
        self.cause = cause


# -- knobs (one read point each) ----------------------------------------------

def collective_timeout_secs() -> float:
    """Base per-collective deadline in seconds
    (``HOROVOD_COLLECTIVE_TIMEOUT_SECS``, default 0: no deadline)."""
    return env_float("HOROVOD_COLLECTIVE_TIMEOUT_SECS", 0.0, minimum=0.0)


def collective_timeout_per_gib() -> float:
    """Extra deadline seconds per GiB of a collective's payload
    (``HOROVOD_COLLECTIVE_TIMEOUT_PER_GIB``, default 30)."""
    return env_float("HOROVOD_COLLECTIVE_TIMEOUT_PER_GIB", 30.0,
                     minimum=0.0)


def collective_deadline(nbytes: int) -> float:
    """The deadline (seconds) of one collective of ``nbytes``; 0.0 when
    deadlines are off."""
    base = collective_timeout_secs()
    if base <= 0:
        return 0.0
    return base + collective_timeout_per_gib() * (
        max(int(nbytes), 0) / _GIB)


def leg_retry_config() -> Tuple[int, float]:
    """(retries after the first attempt, first backoff in seconds) of
    one leg: ``HOROVOD_LEG_MAX_RETRIES`` (2) and
    ``HOROVOD_LEG_RETRY_BACKOFF`` (0.05, doubled per failure with full
    jitter, at most 5 s a sleep)."""
    return (env_int("HOROVOD_LEG_MAX_RETRIES", 2, minimum=0),
            env_float("HOROVOD_LEG_RETRY_BACKOFF", 0.05, minimum=0.0))


def leg_demote_threshold() -> int:
    """Consecutive retry exhaustions of one (op, size class) before rank 0
    demotes it (``HOROVOD_LEG_DEMOTE_THRESHOLD``, 3)."""
    return env_int("HOROVOD_LEG_DEMOTE_THRESHOLD", 3, minimum=1)


def leg_reprobe_secs() -> float:
    """Seconds a demoted class stays flat before rank 0 promotes it
    again (``HOROVOD_LEG_REPROBE_SECS``, 30; 0: never)."""
    return env_float("HOROVOD_LEG_REPROBE_SECS", 30.0, minimum=0.0)


def _env_on(name: str) -> bool:
    raw = os.environ.get(name) or "1"
    return raw.strip().lower() not in ("0", "false", "no", "off")


def degrade_enabled() -> bool:
    """Whether an exhausted leg runs its call flat and feeds demotion
    (``HOROVOD_DATA_PLANE_DEGRADE``, on); off, the transport error
    fails the call."""
    return _env_on("HOROVOD_DATA_PLANE_DEGRADE")


def wire_integrity_enabled() -> bool:
    """Whether quant-coded legs checksum their CPU payload
    (``HOROVOD_WIRE_INTEGRITY``, on)."""
    return _env_on("HOROVOD_WIRE_INTEGRITY")


def check_every_commits() -> int:
    """Cadence in elastic commits of the degraded-route check
    (``HOROVOD_DATA_PLANE_CHECK_EVERY``, 0).  The commit hook that reads
    it waits for elastic state, so a value above 0 changes nothing yet:
    ``hvd.init()`` warns about it."""
    return env_int("HOROVOD_DATA_PLANE_CHECK_EVERY", 0, minimum=0)


# -- the group deadline (engine -> leg guard) ---------------------------------

_tls = threading.local()


def set_group_deadline(deadline_at: Optional[float]):
    """The absolute (monotonic) deadline of the collective this thread
    executes; the leg guard bounds its retries by it."""
    _tls.deadline_at = deadline_at


def group_deadline() -> Optional[float]:
    return getattr(_tls, "deadline_at", None)


# -- classification -----------------------------------------------------------

_TRANSIENT_PATTERNS = (
    "deadline exceeded", "deadline_exceeded",
    "unavailable", "connection reset", "connection refused",
    "connection aborted", "failed to connect", "socket closed",
    "broken pipe", "transient",
)


def _transient_types() -> tuple:
    types = [LegTransportError, ConnectionError, TimeoutError]
    if hasattr(dist, "DistNetworkError"):
        types.append(dist.DistNetworkError)
    return tuple(types)


def is_transient_leg(exc: BaseException) -> bool:
    """Whether a leg failure is worth retrying: the injected
    ``LegTransportError``, connection errors and timeouts,
    ``DistNetworkError``, and errors whose text names a transport fault.
    A checksum mismatch (its own one-retry rule), a type or value error
    and anything else are not."""
    if isinstance(exc, WireIntegrityError):
        return False
    if isinstance(exc, _transient_types()):
        return True
    if isinstance(exc, (TypeError, ValueError)):
        return False
    msg = str(exc).lower()
    return any(p in msg for p in _TRANSIENT_PATTERNS)


def failure_reason(exc: BaseException) -> str:
    """``mh_collective_failures_total``'s reason: deadline, corrupt,
    transport or error."""
    if ("deadline" in type(exc).__name__.lower()
            or "collective deadline exceeded" in str(exc).lower()):
        return "deadline"
    if isinstance(exc, WireIntegrityError):
        return "corrupt"
    if is_transient_leg(exc):
        return "transport"
    return "error"


def _jittered(seconds: float) -> float:
    """Full jitter over [0.5x, 1.5x): ranks retrying one flake must not
    meet on the wire in lockstep."""
    return seconds * (0.5 + random.random())


# -- wire integrity -----------------------------------------------------------

def _host_bytes(a) -> np.ndarray:
    """A CPU tensor's or numpy array's bytes as a uint8 numpy view."""
    if isinstance(a, np.ndarray):
        return np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    return a.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def wire_checksum(*arrays) -> int:
    """CRC32 over the bytes of CPU tensors (any dtype, bf16 included,
    through a uint8 view) or numpy arrays, in order."""
    crc = 0
    for a in arrays:
        crc = binascii.crc32(_host_bytes(a), crc)
    return crc & 0xFFFFFFFF


def _checkable(payloads) -> bool:
    """Only host memory is checksummed: a CUDA tensor is skipped."""
    return len(payloads) > 0 and all(
        getattr(p, "device", None) is None or p.device.type == "cpu"
        for p in payloads)


# -- leg health and the demoted routes ----------------------------------------

class _DataPlaneState:
    def __init__(self):
        self.lock = threading.Lock()
        # (op, size_class) -> consecutive retry exhaustions; a success
        # clears it.
        self.streak: Dict[Tuple[str, str], int] = {}
        # (op, size_class) -> monotonic time of the demotion; read
        # without the lock by routing (dict membership), written only
        # where a verdict is applied.
        self.demoted: Dict[Tuple[str, str], float] = {}
        self.seq = 0  # checks decided (rank 0)


_state = _DataPlaneState()


def reset():
    """Drop all resilience state (tests, and a new world)."""
    global _state
    _state = _DataPlaneState()


def note_leg_success(op: str, cls: str):
    with _state.lock:
        _state.streak.pop((op, cls), None)


def note_leg_failure(op: str, cls: str) -> int:
    """One retry exhaustion; the new streak."""
    with _state.lock:
        n = _state.streak.get((op, cls), 0) + 1
        _state.streak[(op, cls)] = n
    return n


def demoted(op: str, cls: str) -> bool:
    """Whether (op, cls) is demoted to the flat path now."""
    return (op, cls) in _state.demoted


def demoted_routes() -> List[Tuple[str, str]]:
    with _state.lock:
        return sorted(_state.demoted)


# -- the leg guard ------------------------------------------------------------

def run_hier_leg(op: str, size_class: str, run: Callable,
                 payloads: Sequence = (), quantized: bool = False):
    """Run one hierarchical leg (``run``, safe to call again after a
    synchronous failure) under the guard: the fault sites, the wire
    checksum of ``payloads`` under a quant codec, transient retry with
    backoff under the group deadline, and the demotion streaks.  An
    exhausted budget raises ``LegDegraded`` (degrading on) or the last
    transport error; other failures pass through."""
    retries, backoff = leg_retry_config()
    deadline_at = group_deadline()
    check = quantized and wire_integrity_enabled() and _checkable(payloads)
    transport_failures = 0
    integrity_retried = False
    while True:
        try:
            faultline.site("mh.leg.delay")
            if faultline.site("mh.leg.drop"):
                raise LegTransportError(
                    "injected cross-host leg transport fault "
                    "(faultline mh.leg.drop) in %s[%s]" % (op, size_class))
            pre = wire_checksum(*payloads) if check else None
            out = run()
            if check:
                post = wire_checksum(*payloads)
                if faultline.site("mh.leg.corrupt"):
                    post ^= 0x1  # a simulated bit flip in flight
                if post != pre:
                    raise WireIntegrityError(
                        "wire checksum mismatch on hier %s[%s] leg (staged "
                        "crc32 %08x, observed %08x): the payload changed "
                        "across the exchange" % (op, size_class, pre, post))
            note_leg_success(op, size_class)
            return out
        except WireIntegrityError as exc:
            if integrity_retried:
                note_leg_failure(op, size_class)
                LOG.error("%s", exc)
                raise
            integrity_retried = True
            metrics.counter("mh_leg_retries_total", op=op,
                            size_class=size_class).inc()
            metrics.event("mh_leg_retry", op=op, size_class=size_class,
                          cause="integrity", error=str(exc))
            LOG.warning("hier %s[%s] wire integrity failure; running the "
                        "leg once more: %s", op, size_class, exc)
        except LegDegraded:
            raise
        except Exception as exc:  # noqa: BLE001 - classified below
            if not is_transient_leg(exc):
                raise
            transport_failures += 1
            now = time.monotonic()
            out_of_time = deadline_at is not None and now >= deadline_at
            if transport_failures > retries or out_of_time:
                streak = note_leg_failure(op, size_class)
                metrics.event("mh_leg_exhausted", op=op,
                              size_class=size_class,
                              failures=transport_failures, streak=streak,
                              error=str(exc))
                LOG.warning("hier %s[%s] leg failed %d time(s), budget spent "
                            "(retries=%d, deadline%s): %s", op, size_class,
                            transport_failures, retries,
                            " exceeded" if out_of_time else " ok", exc)
                if degrade_enabled():
                    raise LegDegraded(op, size_class, exc) from exc
                raise
            metrics.counter("mh_leg_retries_total", op=op,
                            size_class=size_class).inc()
            sleep = _jittered(min(backoff * (2 ** (transport_failures - 1)),
                                  _BACKOFF_CAP_S))
            if deadline_at is not None:
                sleep = min(sleep, max(0.0, deadline_at - now))
            LOG.warning("hier %s[%s] transient leg failure %d/%d (%s); "
                        "retrying in %.3fs", op, size_class,
                        transport_failures, retries, exc, sleep)
            time.sleep(sleep)


# -- demotion and re-promotion ------------------------------------------------

def _apply_route(entry: dict):
    """Apply one of rank 0's route verdicts on this rank: a frozen
    fast-path schedule built over the old route thaws first (reason
    ``route``), then the demoted map changes."""
    from ..ops import fastpath
    op, cls = entry["op"], entry["size_class"]
    key = (op, cls)
    fastpath.thaw_all("route", "route %s for (%s, %s)"
                      % (entry.get("action", "promote"), op, cls))
    if entry.get("action") == "demote":
        with _state.lock:
            _state.demoted[key] = time.monotonic()
            _state.streak.pop(key, None)
        metrics.gauge("mh_degraded_routes", op=op, size_class=cls).set(1)
        metrics.event("mh_route_demoted", scope="member", **entry)
        LOG.warning(
            "hier route (%s, %s) DEMOTED to the flat path after %s "
            "consecutive leg exhaustions; the re-probe tries the hierarchy "
            "again after %.0fs", op, cls, entry.get("streak", "?"),
            leg_reprobe_secs())
    else:
        with _state.lock:
            _state.demoted.pop(key, None)
            _state.streak.pop(key, None)
        metrics.gauge("mh_degraded_routes", op=op, size_class=cls).set(0)
        metrics.event("mh_route_promoted", scope="member", **entry)
        LOG.warning(
            "hier route (%s, %s) RE-PROMOTED: the demotion window elapsed, "
            "the next call probes the hierarchical leg again", op, cls)


def decide_routes() -> List[dict]:
    """Rank 0's verdicts of one check: ``demote`` for each class whose
    streak reached the threshold, ``promote`` for each demoted class
    whose re-probe time has come."""
    st = _state
    st.seq += 1
    now = time.monotonic()
    thresh, reprobe = leg_demote_threshold(), leg_reprobe_secs()
    with st.lock:
        trips = [(k, n) for k, n in sorted(st.streak.items())
                 if n >= thresh and k not in st.demoted]
        promos = [k for k, at in sorted(st.demoted.items())
                  if reprobe > 0 and now - at >= reprobe]
    out = [{"action": "demote", "op": op, "size_class": cls, "streak": n,
            "apply_at": st.seq} for (op, cls), n in trips]
    out += [{"action": "promote", "op": op, "size_class": cls,
             "apply_at": st.seq} for op, cls in promos]
    return out


def apply_routes(entries: Sequence[dict]) -> Optional[dict]:
    """Apply rank 0's verdicts in order; the last one, or None."""
    for entry in entries:
        _apply_route(entry)
    return dict(entries[-1]) if entries else None


def check_degraded_routes() -> Optional[dict]:
    """Demote sick hierarchical routes and promote healed ones
    (``hvd.check_degraded_routes``): every rank calls it at the same
    point.  In a world of more than one rank the check is a request in
    this rank's next cycle; rank 0 decides once every rank has asked,
    and every rank applies the verdicts of that cycle before anything
    else in it.  A one-rank world decides here.  Returns the last
    verdict applied, or None (also when degrading is off)."""
    if not degrade_enabled():
        return None
    from . import basics
    if basics.is_initialized() and basics.size() > 1:
        return basics.engine().check_routes()
    return apply_routes(decide_routes())


# -- attribution --------------------------------------------------------------

def _series_total(model: dict, name: str, label: Optional[str] = None
                  ) -> Dict[str, float]:
    fam = model.get(name) or {}
    out: Dict[str, float] = {}
    for row in fam.get("series", []):
        group = (row.get("labels", {}).get(label, "?") if label
                 else "total")
        out[group] = out.get(group, 0.0) + float(row.get("value", 0.0))
    return out


def describe() -> dict:
    """The knobs in force and the retry, demotion and failure counts."""
    snap = metrics.snapshot()
    retries = _series_total(snap, "mh_leg_retries_total")
    failures = _series_total(snap, "mh_collective_failures_total", "reason")
    expired = _series_total(snap, "collective_deadline_expired_total")
    max_retries, backoff = leg_retry_config()
    return {
        "deadline_secs": collective_timeout_secs(),
        "deadline_per_gib": collective_timeout_per_gib(),
        "leg_max_retries": max_retries,
        "leg_retry_backoff": backoff,
        "demote_threshold": leg_demote_threshold(),
        "reprobe_secs": leg_reprobe_secs(),
        "degrade_enabled": degrade_enabled(),
        "wire_integrity": wire_integrity_enabled(),
        "demoted_routes": [{"op": op, "size_class": cls}
                           for op, cls in demoted_routes()],
        "leg_retries_total": retries.get("total", 0.0),
        "deadline_expired_total": expired.get("total", 0.0),
        "failures_by_reason": failures,
    }
