"""The engine's steady-state fast path: a schedule that repeats is frozen,
and its allreduces go out in overlap buckets without being negotiated.

Counterpart of ``horovod_tpu.ops.fastpath`` (``ScheduleFreezer``,
``:93``; ``schedule_sig``, ``:79``; ``thaw_all``, ``:319``; ``describe``,
``:337``; ``bucket_ends``, ``:372``), with the unit it freezes and the
way the ranks agree changed for a process per rank:

* **The round.**  The reference freezes after
  ``HOROVOD_FAST_PATH_WARM_CYCLES`` identical negotiated cycles.  Here
  a ``DistributedOptimizer`` step enqueues one allreduce per gradient
  from autograd hooks, spread over cycles whose contents depend on
  timing, so the unit that repeats is the round: what a rank enqueues
  between two waits that leave it nothing in flight (``wait_all``).  A
  round's profile is the ordered tuple of its entries' slot signatures
  (``slot_sig``: names left out, as in the reference's
  ``_fp_slot_sig``); each rank reports ``schedule_sig`` of it, or None
  when the round cannot freeze (anything but non-Adasum allreduces, an
  error, a join, entries produced on more than one stream).
* **The verdict.**  Rank 0's controller freezes when every rank
  reported the same signature for ``warm`` rounds in a row, and names
  the round from which every rank stages: two after the round whose
  report completed the streak.  No rank can be inside that round when
  the verdict reaches it: a round ends only once every rank's requests
  for it were negotiated, the slowest rank sends its requests of the
  next round no earlier than the report that completed the streak, and
  every rank applies the verdict before it completes the entries of the
  cycle that carried it.  This replaces the reference's rendezvous-KV
  agreement (``_agree_freeze``).
* **Buckets.**  ``plan_buckets`` cuts the frozen slots with
  ``bucket_ends`` (balanced by bytes, ``HOROVOD_OVERLAP_BUCKETS``,
  capped at the fusion threshold) and wherever the fusion key or the
  group changes, so a grouped call's members fuse only with each other.
  The caller's thread stages each entry against its slot and records one
  CUDA event when a bucket fills; the cycle thread dispatches it.
* **Go.**  Before a bucket is dispatched, the ranks exchange its token
  (``bucket_token``: round, bucket, schedule signature and a digest of
  its entries' names) through the controller: rank 0 answers go when
  every rank presented it, not yet when some rank has not filled it,
  and thaw on anything else.  A one-rank world skips the exchange.
* **Thaws** are world-wide and loud (a warning, ``fastpath_thaws_total
  {reason}``, a ``fastpath_thaw`` event with the frozen group id).  A
  rank asks for one (``ScheduleFreezer.request``, ``thaw_all``); rank 0
  answers every request with a thaw, which every rank applies in the
  same cycle, sending its staged entries back to negotiation.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..common import metrics
from ..common.message import ADASUM, ALLREDUCE

LOG = logging.getLogger("horovod_tpu_torch")

# The closed set of thaw reasons (the reference's label enum).
THAW_REASONS = ("shape", "membership", "staleness", "route", "deadline")


def schedule_sig(profile) -> str:
    """Stable signature of one round's profile (ranks compare these,
    never full profiles)."""
    return hashlib.sha1(repr(profile).encode()).hexdigest()[:16]


def slot_sig(q, member: int = 0) -> tuple:
    """One entry's slot signature: op, process set, dtype, reduce op,
    scales, shape, bytes, and its group's size with its place in the
    group (``member``; 0 and 0 for an entry of no group).  Names are
    left out: a loop may name its tensors by step."""
    return (q.op_type, q.process_set_id, q.dtype, q.red_op, q.prescale,
            q.postscale, q.shape, q.nbytes, q.group_size, member)


def freezable(profile: Sequence[tuple]) -> bool:
    """Only rounds of allreduces other than Adasum freeze (Adasum shares
    no buffer)."""
    return bool(profile) and all(s[0] == ALLREDUCE and s[3] != ADASUM
                                 for s in profile)


def _fusion_key(slot: tuple) -> tuple:
    return slot[1:6] + (slot[8] > 0,)


def plan_buckets(slots: Sequence[tuple], buckets: int,
                 cap_bytes: int) -> List[int]:
    """The exclusive end of each bucket of a frozen round:
    ``bucket_ends`` over the slots' bytes, also cut wherever the fusion
    key changes or a group begins."""
    ends = set(bucket_ends([s[7] for s in slots], buckets, cap_bytes))
    for i in range(1, len(slots)):
        if _fusion_key(slots[i]) != _fusion_key(slots[i - 1]) or (
                slots[i][8] and slots[i][9] == 0):
            ends.add(i)
    return sorted(ends)


def bucket_token(round_index: int, bucket: int, sig: str,
                 names: Sequence[str]) -> tuple:
    """What a rank presents before a frozen bucket is dispatched; the
    names' digest makes ranks that staged other tensors in the same
    slots (same shapes, another order) thaw instead of reducing the
    wrong tensors together."""
    return (round_index, bucket, sig,
            zlib.crc32("\0".join(names).encode()))


class ScheduleFreezer:
    """Warm-streak counter and frozen latch of one engine.

    Rank 0's controller feeds ``observe`` one world profile signature
    per round and freezes when it trips; every engine sets the latch
    (``freeze``) when the verdict reaches it and drops it (``thaw``,
    loud, then ``on_thaw``) when a thaw verdict does.  ``request`` asks
    for a world-wide thaw through ``on_request`` (the engine's next
    cycle carries it to rank 0); without one it thaws at once."""

    def __init__(self, warm_cycles: int, enabled: bool = True,
                 plane_name: str = "engine",
                 on_thaw: Optional[Callable[[Dict[str, Any], str], None]]
                 = None,
                 on_request: Optional[Callable[[str, str], bool]] = None):
        self.warm_cycles = max(1, int(warm_cycles))
        self.enabled = bool(enabled)
        self.plane_name = plane_name
        self._on_thaw = on_thaw
        self._on_request = on_request
        self._lock = threading.Lock()
        self._last_profile = None
        self._streak = 0
        self._frozen: Optional[Dict[str, Any]] = None
        self._group_id: Optional[int] = None

    def frozen(self) -> Optional[Dict[str, Any]]:
        """The frozen schedule (None while negotiating)."""
        return self._frozen

    def frozen_group_id(self) -> Optional[int]:
        return self._group_id if self._frozen is not None else None

    @property
    def streak(self) -> int:
        with self._lock:
            return self._streak

    def observe(self, profile) -> bool:
        """Feed one round's profile (None: not freezable); True when the
        warm streak has tripped."""
        if not self.enabled:
            return False
        with self._lock:
            if self._frozen is not None:
                return False
            if profile is None or profile != self._last_profile:
                self._last_profile = profile
                self._streak = 1 if profile is not None else 0
                return False
            self._streak += 1
            return self._streak >= self.warm_cycles

    def reset_streak(self):
        with self._lock:
            self._streak = 0
            self._last_profile = None

    def freeze(self, payload: Dict[str, Any], group_id: int,
               ok: bool = True) -> bool:
        """Freeze ``payload`` as of collective group ``group_id``; a
        refused freeze (``ok`` False) restarts warm counting."""
        if not self.enabled:
            return False
        if not ok:
            self.reset_streak()
            return False
        with self._lock:
            if self._frozen is not None:
                return True
            self._frozen, self._group_id = dict(payload), int(group_id)
        LOG.info("fast path FROZEN (%s): %d-slot schedule in %d bucket(s) "
                 "as of group %d after %d identical rounds; dispatch skips "
                 "negotiation until a thaw", self.plane_name,
                 len(payload.get("slots", ())),
                 len(payload.get("ends", ())), group_id, self.warm_cycles)
        metrics.event("fastpath_freeze", plane=self.plane_name,
                      group=int(group_id), sig=payload.get("sig"),
                      slots=len(payload.get("slots", ())))
        return True

    def thaw(self, reason: str, detail: str = "") -> bool:
        """Drop the frozen schedule, loudly; False when nothing is
        frozen."""
        if reason not in THAW_REASONS:
            raise ValueError("unknown thaw reason %r (one of %s)"
                             % (reason, ", ".join(THAW_REASONS)))
        with self._lock:
            fz, self._frozen = self._frozen, None
            if fz is None:
                return False
            group = self._group_id
            self._streak, self._last_profile = 0, None
        metrics.counter("fastpath_thaws_total", reason=reason).inc()
        metrics.event("fastpath_thaw", plane=self.plane_name, reason=reason,
                      group=group, sig=fz.get("sig"), detail=detail)
        LOG.warning("fast path THAWED (%s, reason=%s%s): the frozen "
                    "schedule of group %d (%d slot(s)) falls back to "
                    "negotiation", self.plane_name, reason,
                    ", " + detail if detail else "", group,
                    len(fz.get("slots", ())))
        if self._on_thaw is not None:
            self._on_thaw(fz, reason)
        return True

    def request(self, reason: str, detail: str = "") -> bool:
        """Ask for a thaw; True when one is now on its way."""
        if reason not in THAW_REASONS:
            raise ValueError("unknown thaw reason %r (one of %s)"
                             % (reason, ", ".join(THAW_REASONS)))
        if self._on_request is not None:
            return self._on_request(reason, detail)
        return self.thaw(reason, detail)


# -- registry: the planes that thaw engines reach them here --------------------

_REG_LOCK = threading.Lock()
_FREEZERS: List[ScheduleFreezer] = []


def register(freezer: ScheduleFreezer):
    with _REG_LOCK:
        if freezer not in _FREEZERS:
            _FREEZERS.append(freezer)


def unregister(freezer: ScheduleFreezer):
    with _REG_LOCK:
        if freezer in _FREEZERS:
            _FREEZERS.remove(freezer)


def thaw_all(reason: str, detail: str = "") -> int:
    """Ask every registered engine for a thaw (a no-op where nothing is
    frozen); the number that will thaw."""
    with _REG_LOCK:
        freezers = list(_FREEZERS)
    return sum(1 for fz in freezers if fz.request(reason, detail))


def reset():
    """Forget every registered freezer (tests)."""
    with _REG_LOCK:
        del _FREEZERS[:]


def describe() -> Dict[str, Any]:
    """The ``levers.fastpath`` block: frozen rounds and thaws from the
    metrics, and each registered engine's state (its frozen schedule's
    slots and buckets besides the reference's keys)."""
    thaws: Dict[str, float] = {}
    fam = metrics.snapshot().get("fastpath_thaws_total") or {}
    for row in fam.get("series", ()):
        r = row["labels"].get("reason", "?")
        thaws[r] = thaws.get(r, 0.0) + float(row.get("value", 0.0))
    with _REG_LOCK:
        freezers = list(_FREEZERS)
    planes = {}
    for fz in freezers:
        sched = fz.frozen() or {}
        planes[fz.plane_name] = {
            "enabled": fz.enabled,
            "frozen": fz.frozen() is not None,
            "warm_streak": fz.streak,
            "warm_cycles": fz.warm_cycles,
            "slots": len(sched.get("slots", ())),
            "buckets": len(sched.get("ends", ())),
        }
    return {"frozen_cycles_total": metrics.series_sum(
                "fastpath_frozen_cycles_total"),
            "thaws_total": sum(thaws.values()),
            "thaws_by_reason": thaws,
            "planes": planes}


def bucket_ends(sizes: List[int], buckets: int, cap_bytes: int
                ) -> List[int]:
    """Partition a frozen round's per-slot byte sizes into up to
    ``buckets`` contiguous buckets (balanced by bytes, each also closed
    once it passes ``cap_bytes``); the exclusive end index of each."""
    n = len(sizes)
    if n == 0:
        return []
    buckets = max(1, min(int(buckets), n))
    total = sum(sizes) or 1
    target = total / float(buckets)
    ends: List[int] = []
    acc = 0
    for i, s in enumerate(sizes):
        acc += int(s)
        if i == n - 1 or acc >= target or acc > cap_bytes:
            ends.append(i + 1)
            acc = 0
    return ends
