"""The negotiating background engine: enqueue by name, negotiate across
ranks, fuse, execute in one order on every rank.

Counterpart of ``horovod_tpu/core/src/operations.cc`` (``Enqueue``,
``:211``; ``EnqueueJoin``, ``:280``; ``BackgroundLoop``, ``:357``;
``PerformOperation``, ``:536``) with the handle and checks of
``horovod_tpu.ops.engine`` (``HorovodInternalError``, ``:51``;
``CollectiveHandle``, ``:66``; ``_enqueue``, ``:289``; ``shutdown``,
``:713``).

A caller enqueues named requests and gets a ``Handle``.  One cycle
thread per rank drains what was enqueued since its last cycle, sends it
to the controller (a cache bit for a tensor the response cache knows,
the full request otherwise), and executes the coordinator's response
list, in order, through ``ops/multihost.py``: its hierarchical legs
when the set has them and the payload passes the gate, the flat
collectives of ``ops/collectives.py`` otherwise.  No other thread issues
collectives on the data group while the engine runs, so every rank
issues them in the broadcast order.  The cycle thread sleeps on a
condition variable.  New work goes out in the first cycle that starts
``HOROVOD_CYCLE_TIME`` ms after the last one began (an enqueue wakes an
idle thread, never a pacing one); ``join``, ``shutdown`` and a
``Handle.wait()`` start a cycle at once.  With nothing new, a rank of a
multi-rank world cycles at that pace while it has work outstanding, and
otherwise every half second, so the coordinator's stall checks go on.  If the
negotiation fails, the loop dies, a rank finds a negotiated tensor it
never enqueued, or the stall inspector aborts, every outstanding handle
fails with ``HorovodInternalError`` on every rank and the engine stops.

The fast path (``ops/fastpath.py``, on unless ``HOROVOD_FAST_PATH=0``):
a round ends when ``wait_all`` leaves this rank nothing in flight; its
profile goes to rank 0 in the next cycle.  Once rank 0 freezes the
schedule, every rank stages the entries of each round from the named
one on, on the caller's thread (``_fp_stage``: matched against the
next slot, no event per entry; one event, and an immediate wake, when a
bucket fills), and the cycle thread dispatches the filled buckets on
rank 0's go, each as one fused allreduce.  A rank asks for a thaw when
an entry does not match its slot, a wait touches an entry of an
unfilled bucket, or on ``join``, a process set change or ``shutdown``;
rank 0's thaw sends every rank's staged entries back to negotiation in
program order (``_fp_flush``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Sequence

import torch

from ..common import metrics, process_sets
from ..common.config import Config
from ..common.controller import Controller, GlooTransport
from ..common.message import (ADASUM, ALLGATHER, ALLREDUCE, ALLTOALL,
                              BARRIER, BROADCAST, JOIN, REDUCESCATTER,
                              CycleRequest, Request, Response)
from ..common.response_cache import CACHEABLE, ResponseCache
from ..utils.stall_inspector import StallInspector
from ..utils.timeline import Timeline
from . import collectives as C
from . import fastpath
from . import multihost as mh
from .op_manager import OpManager

LOG = logging.getLogger("horovod_tpu_torch")

# Cycle pause of a multi-rank world with nothing outstanding on this rank.
IDLE_SECS = 0.5

# The fast path's states on one rank: negotiating; a freeze verdict
# adopted, staging from its round on; staging frozen rounds; a thaw
# asked for, not yet answered (nothing is staged meanwhile).
NEGOTIATING, ARMED, STAGING, THAWING = range(4)


class HorovodInternalError(RuntimeError):
    """A collective failed: a negotiation error (ranks disagree, a joined
    rank cannot take part), a stall past the shutdown threshold, or the
    engine stopped."""


class _Entry:
    __slots__ = ("request", "tensor", "backend", "token", "done", "result",
                 "error", "out_token", "bucket")

    def __init__(self, request: Request, tensor, backend, token):
        self.request = request
        self.tensor = tensor
        self.backend = backend
        self.token = token
        self.done = False
        self.result = None
        self.error: Optional[str] = None
        self.out_token = None
        self.bucket: Optional[_Bucket] = None  # staged in (frozen rounds)

    def complete(self, result=None, error: Optional[str] = None,
                 out_token=None):
        """Set the outcome; the engine then wakes the waiters
        (``Engine._notify_done``)."""
        self.result, self.error, self.out_token = result, error, out_token
        self.done = True


class _Bucket:
    """Entries staged for one bucket of a frozen round; ``token`` is the
    event recorded on ``stream`` when it filled."""

    __slots__ = ("round", "index", "last", "entries", "stream", "token",
                 "filled")

    def __init__(self, round_index: int, index: int, last: bool, stream):
        self.round, self.index, self.last = round_index, index, last
        self.entries: List[_Entry] = []
        self.stream = stream
        self.token = None
        self.filled = False


class _Schedule:
    """The frozen schedule this rank stages against."""

    __slots__ = ("sig", "slots", "ends", "start")

    def __init__(self, sig: str, slots, ends, start: int):
        self.sig, self.slots, self.ends, self.start = sig, slots, ends, start


class Handle:
    """An outstanding collective (one entry, or a grouped call's
    entries).  ``poll()`` is True once the cycle thread has issued it;
    ``wait()`` returns ``finish`` of the entries' results, and on CUDA
    makes the caller's current stream wait for them, never synchronising
    the host with the device."""

    __slots__ = ("_engine", "_entries", "_finish", "_done", "_result")

    def __init__(self, engine, entries: Sequence[_Entry],
                 finish: Callable[[list], object]):
        self._engine = engine
        self._entries = list(entries)
        self._finish = finish
        self._done = False
        self._result = None

    def poll(self) -> bool:
        return all(e.done for e in self._entries)

    def wait(self):
        return wait_all([self])[0]


def wait_all(handles: Sequence[Handle]) -> list:
    """``[h.wait() for h in handles]``, with one wake of the cycle thread
    and one stream wait per distinct result event for all of them (a
    ``DistributedOptimizer`` step waits on a handle per gradient)."""
    todo = [h for h in handles if not h._done]
    entries = [e for h in todo for e in h._entries]
    if not todo:
        return [h._result for h in handles]
    engine = todo[0]._engine
    if not all(e.done for e in entries):
        if engine._fp_state == STAGING:
            engine._fp_check_wait(entries)
        engine.wake()
        with engine._done_cv:
            while not all(e.done for e in entries):
                engine._done_cv.wait()
    engine._round_end()
    for e in entries:
        if e.error is not None:
            raise HorovodInternalError(e.error)
    backend = next((e.backend for e in entries if e.backend is not None),
                   None)
    if backend is not None:
        backend.finish({e.out_token: None for e in entries},
                       [e.result for e in entries])
    for h in todo:
        h._result = h._finish([e.result for e in h._entries])
        h._done = True
    return [h._result for h in handles]


class Engine:
    def __init__(self, config: Config, rank: int, size: int,
                 device: torch.device, control_group=None):
        self.config = config
        self.rank, self.size, self.device = rank, size, device
        self.op_manager = OpManager(device)
        self.cache = ResponseCache(config.cache_capacity)
        self.timeline = Timeline()
        if rank == 0:
            self.timeline.initialize(config.timeline,
                                     config.timeline_mark_cycles)
        # A one-rank world has no rank to miss a tensor.
        stall = StallInspector(config.stall_warning_secs,
                               config.stall_shutdown_secs,
                               not config.stall_check_disable and size > 1)
        self._fp = fastpath.ScheduleFreezer(
            config.fast_path_warm_cycles, config.fast_path,
            on_thaw=self._fp_flush, on_request=self._fp_request)
        self.controller = Controller(
            rank, size, self.cache, stall, config.fusion_threshold_bytes,
            lambda psid: process_sets.members(psid, size),
            GlooTransport(rank, size, control_group) if size > 1 else None,
            self._fp)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # Handles wait on this one; the cycle thread notifies it once a
        # collective's entries are complete.
        self._done_cv = threading.Condition(threading.Lock())
        self._new: List[_Entry] = []
        self._inflight = {}
        self._join_entry: Optional[_Entry] = None
        self._shutdown_requested = False
        self._stopped: Optional[str] = None
        self._seq = 0
        self._urgent = False
        self._idle = False
        self._last_start = 0.0
        self._cycles = 0
        self._group_seq = 0
        # -- fast path (under _cv) --
        self._fp_state = NEGOTIATING
        self._fp_sched: Optional[_Schedule] = None
        self._fp_slot = 0  # next slot of the staged round
        self._fp_open: Optional[_Bucket] = None  # the bucket being filled
        self._fp_ready: List[_Bucket] = []  # filled, not yet dispatched
        self._fp_thaw_req: Optional[tuple] = None  # (reason, detail)
        self._round = 0  # rounds this rank has ended
        self._round_n = 0  # entries enqueued in the round
        self._round_sigs: List[tuple] = []  # its negotiated slots' sigs
        self._round_ok = True  # the round can freeze
        self._round_stream = None
        self._fp_report: Optional[tuple] = None  # (round, sig) to send
        self._fp_profiles = {}  # round -> (sig, slots), the last few
        self._m_cycles = metrics.counter("engine_cycles_total")
        self._m_cycle_seconds = metrics.histogram("engine_cycle_seconds")
        self._m_queue_depth = metrics.gauge("engine_queue_depth")
        self._m_submitted = metrics.counter("engine_bytes_submitted_total")
        self._m_fused_bytes = metrics.counter("engine_bytes_fused_total")
        self._m_fused_tensors = metrics.counter("engine_tensors_fused_total")
        self._m_last_group = metrics.gauge("engine_last_group_id")
        self._m_last_group.set(0)  # this engine's group ids start at 1
        self._m_fp_frozen = metrics.counter("fastpath_frozen_cycles_total")
        self._m_fp_bucket = metrics.histogram("engine_overlap_bucket_seconds")
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd-torch-cycle", daemon=True)

    def start(self):
        """Start the cycle thread."""
        fastpath.register(self._fp)
        self._thread.start()

    # -- caller side ----------------------------------------------------------

    def wake(self):
        """Start a cycle now: a caller waits on a result."""
        with self._cv:
            self._seq += 1
            self._urgent = True
            self._cv.notify()

    def enqueue(self, requests: Sequence[Request],
                tensors: Sequence[Optional[torch.Tensor]],
                finish: Callable[[list], object]) -> Handle:
        """Enqueue one request per tensor (None for a barrier); a grouped
        call passes all its members at once."""
        present = [t for t in tensors if t is not None]
        backend = self.op_manager.backend_for(present) if present else None
        # Staged entries need no event of their own: one is recorded when
        # their bucket fills.
        staging = self._fp_state == STAGING
        token = (backend.producer() if backend is not None and not staging
                 else None)
        stream = (backend.current_stream()
                  if backend is not None and self.config.fast_path else None)
        entries = [_Entry(q, t, backend, token)
                   for q, t in zip(requests, tensors)]
        grouped = bool(requests) and requests[0].group is not None
        with self._cv:
            if self._stopped is not None:
                raise HorovodInternalError(
                    "the engine is stopped (%s)" % self._stopped)
            inflight = self._inflight
            for k, e in enumerate(entries):
                name = e.request.name
                if name in inflight:
                    for d in entries[:k]:
                        del inflight[d.request.name]
                    raise ValueError(
                        "a collective named %r is already in flight; names "
                        "must be unique among in-flight collectives" % name)
                inflight[name] = e
                self.timeline.negotiate_start(name, e.request.op_type)
            self._round_n += len(entries)
            staged = (self._fp_stage(entries, grouped, backend, stream)
                      if self._fp_state == STAGING else 0)
            rest = entries[staged:]
            if rest:
                if rest[0].token is None and backend is not None:
                    token = backend.producer()
                    for e in rest:
                        e.token = token
                if self.config.fast_path:
                    self._fp_record(rest, staged if grouped else None,
                                    stream)
                self._new.extend(rest)
                self._seq += 1
                if self._idle:
                    # A pacing cycle thread wakes on its own timeout;
                    # waking it here would only trade the GIL with this
                    # thread.
                    self._cv.notify()
        self._m_submitted.inc(sum(q.nbytes for q in requests))
        return Handle(self, entries, finish)

    def join(self) -> Handle:
        """This rank is out of data until every rank has joined; the
        handle's result is the last rank to join."""
        e = _Entry(Request("__join__", JOIN), None, None, None)
        with self._cv:
            if self._stopped is not None:
                raise HorovodInternalError(
                    "the engine is stopped (%s)" % self._stopped)
            if self._join_entry is not None:
                raise ValueError("join() is already in progress")
            self._fp_request_locked("membership", "join()")
            self._round_ok = False
            self._join_entry = e
            self._seq += 1
            self._urgent = True
            self._cv.notify()
        return Handle(self, [e], lambda results: results[0])

    def shutdown(self):
        """Ask the coordinator to stop (every rank must), then wait for
        the cycle thread; outstanding handles fail."""
        fastpath.unregister(self._fp)
        with self._cv:
            self._fp_request_locked("membership", "shutdown()")
            self._shutdown_requested = True
            self._seq += 1
            self._urgent = True
            self._cv.notify()
        self._thread.join()
        self.timeline.shutdown()
        # Handles outlive the engine: drop its hold on the world's groups.
        self.controller = None

    # -- fast path, caller side (under _cv) -----------------------------------

    def _fp_record(self, entries: Sequence[_Entry], member0: Optional[int],
                   stream):
        """Add negotiated entries to the round's profile; ``member0`` is
        the first one's place in its grouped call (None: no group)."""
        for k, e in enumerate(entries):
            self._round_sigs.append(fastpath.slot_sig(
                e.request, 0 if member0 is None else member0 + k))
        if self._round_stream is None:
            self._round_stream = stream
        elif stream != self._round_stream:
            self._round_ok = False  # one event per bucket needs one stream

    def _fp_stage(self, entries: Sequence[_Entry], grouped: bool, backend,
                  stream) -> int:
        """Stage ``entries`` against the next slots of the frozen round;
        the number staged (fewer than all after a mismatch, which asks
        for a thaw).  A bucket that fills gets one event on the caller's
        stream and wakes the cycle thread."""
        sched = self._fp_sched
        for k, e in enumerate(entries):
            i = self._fp_slot
            q = e.request
            if i >= len(sched.slots) or fastpath.slot_sig(
                    q, k if grouped else 0) != sched.slots[i]:
                self._fp_request_locked(
                    "shape", "%r does not match slot %d of the frozen "
                    "round" % (q.name, i))
                return k
            b = self._fp_open
            if b is None:
                index = sum(1 for end in sched.ends if end <= i)
                b = self._fp_open = _Bucket(
                    self._round, index, index == len(sched.ends) - 1, stream)
            elif stream != b.stream:
                self._fp_request_locked(
                    "shape", "%r was produced on another stream than its "
                    "bucket" % q.name)
                return k
            b.entries.append(e)
            e.bucket = b
            self.timeline.negotiate_end(q.name)
            self._fp_slot = i + 1
            if self._fp_slot == sched.ends[b.index]:
                b.token = backend.producer() if backend is not None else None
                b.filled = True
                self._fp_ready.append(b)
                self._fp_open = None
                self._seq += 1
                self._urgent = True
                self._cv.notify()
        return len(entries)

    def _fp_request(self, reason: str, detail: str = "") -> bool:
        with self._cv:
            return self._fp_request_locked(reason, detail)

    def _fp_request_locked(self, reason: str, detail: str) -> bool:
        """Ask rank 0 for a thaw in the next cycle; nothing is staged
        until it answers.  False when this rank is not frozen."""
        if self._fp_state == NEGOTIATING:
            return False
        if self._fp_state != THAWING:
            self._fp_state = THAWING
            self._fp_thaw_req = (reason, detail)
        self._seq += 1
        self._urgent = True
        self._cv.notify()
        return True

    def _fp_check_wait(self, entries: Sequence[_Entry]):
        """A wait on an entry of an unfilled bucket would never end: the
        round staged fewer entries than its schedule, so thaw."""
        with self._cv:
            if any(e.bucket is not None and not e.bucket.filled
                   for e in entries):
                self._fp_request_locked(
                    "shape", "a wait touches an entry of an unfilled "
                    "bucket (slot %d of %d staged)"
                    % (self._fp_slot, len(self._fp_sched.slots)))

    def _round_end(self):
        """After a wait: the round ends if this rank has nothing in
        flight.  Every rank counts its rounds alike (a round is anything
        enqueued between two such ends), so the indices agree; a
        negotiated round is reported to rank 0, and an adopted schedule
        starts staging at its round."""
        if not self.config.fast_path:
            return
        with self._cv:
            if self._round_n == 0 or self._inflight or self._new or \
                    self._join_entry is not None:
                return
            sigs, ok = tuple(self._round_sigs), self._round_ok
            self._round_n, self._round_sigs, self._round_ok = 0, [], True
            self._round_stream = None
            index = self._round
            self._round += 1
            if self._fp_state == STAGING:
                self._fp_slot = 0
            elif self._fp_state == NEGOTIATING:
                sig = (fastpath.schedule_sig(sigs)
                       if ok and fastpath.freezable(sigs) else None)
                self._fp_report = (index, sig)
                if sig is not None:
                    self._fp_profiles[index] = (sig, sigs)
                    for old in [i for i in self._fp_profiles
                                if i < index - 4]:
                        del self._fp_profiles[old]
            elif self._fp_state == ARMED and \
                    self._round == self._fp_sched.start:
                self._fp_state = STAGING
                self._fp_slot = 0

    # -- cycle thread ---------------------------------------------------------

    def _loop(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            # The executor builds no autograd graph (a thread-local mode).
            torch.set_grad_enabled(False)
            seen = 0
            while True:
                with self._cv:
                    self._wait_for_cycle(seen)
                    seen = self._seq
                    self._urgent = False
                    self._last_start = time.monotonic()
                    new, self._new = self._new, []
                    msg = CycleRequest(self.rank, self._shutdown_requested,
                                       self._join_entry is not None)
                    msg.round_report, self._fp_report = self._fp_report, None
                    msg.thaw, self._fp_thaw_req = self._fp_thaw_req, None
                    msg.staging = self._fp_state == STAGING
                    ready = (list(self._fp_ready)
                             if self._fp_state == STAGING else [])
                if not self._cycle(new, msg, ready):
                    return
        except Exception as exc:  # the loop's boundary: fail, never hang
            LOG.exception("horovod_tpu_torch engine: the cycle failed")
            self._stop("negotiation failed: %s: %s"
                       % (type(exc).__name__, exc))

    def _wait_for_cycle(self, seen: int):
        """Under the lock: return when the next cycle should start.  New
        work starts one a cycle time after the last began, so the hooks
        of a backward pass batch into few cycles; a waiting caller, a
        join, a shutdown, a filled frozen bucket or a thaw request starts
        one at once.  With nothing new, a rank of a multi-rank world
        cycles every cycle time while it has work outstanding and every
        ``IDLE_SECS`` otherwise (the coordinator's stall checks need the
        cycles); a one-rank world sleeps."""
        cycle_s = self.config.cycle_time_ms / 1e3
        while True:
            if self._seq != seen:
                delay = self._last_start + cycle_s - time.monotonic()
                if self._urgent or delay <= 0:
                    return
                self._cv.wait(delay)
                continue
            busy = (self._inflight or self._join_entry is not None
                    or self._shutdown_requested)
            timeout = (cycle_s if busy
                       else None if self.size == 1 else IDLE_SECS)
            self._idle = True
            try:
                if not self._cv.wait(timeout):
                    return
            finally:
                self._idle = False

    def _cycle(self, new: List[_Entry], msg: CycleRequest,
               ready: List[_Bucket]) -> bool:
        backend = self.op_manager.backend
        if self.size == 1 and ready and not new and not msg.shutdown and \
                not msg.joined and msg.round_report is None and \
                msg.thaw is None:
            # A frozen one-rank world has no one to exchange tokens with.
            with backend.stream():
                self._fp_dispatch(ready)
            return True
        msg.buckets = [fastpath.bucket_token(
            b.round, b.index, self._fp_sched.sig,
            [e.request.name for e in b.entries]) for b in ready]
        self._cycles += 1
        self.timeline.mark_cycle(self._cycles)
        for e in new:
            q = e.request
            cid = None if q.group is not None else self.cache.lookup(q)
            if cid is None:
                msg.requests.append(q)
            else:
                msg.cache_bits |= 1 << cid
        self._m_queue_depth.set(len(new))
        t0 = time.monotonic()
        resp = self.controller.run_cycle(msg)
        finished = []
        with backend.stream():
            # The fast path's verdicts come first: a freeze is adopted
            # before this cycle's entries complete (so before a round
            # that ends with them does).
            if resp.thaw is not None:
                if not self._fp.thaw(*resp.thaw):
                    self._fp_flush(None, resp.thaw[0])
            elif resp.go:
                self._fp_dispatch(ready[:resp.go])
            elif ready:
                with self._cv:  # not yet: present them again at once
                    self._seq += 1
                    self._urgent = True
            if resp.freeze is not None:
                self._fp_adopt(*resp.freeze)
            # Entries drained in an earlier cycle were covered then: the
            # executor stream runs in order.
            backend.consume({e.token: None for e in new
                             if e.token is not None})
            try:
                for r in resp.responses:
                    if r.error is None and not r.join_rewrite and \
                            r.op_type in CACHEABLE:
                        for q in r.requests:
                            if q.group is None:
                                cid, evicted = self.cache.put(q)
                                if evicted is not None:
                                    self.controller.evicted(cid, evicted)
                    self._perform(r, finished)
            finally:
                # Counted before any result is visible, so a waiter that
                # reads the counters after its results sees this cycle.
                if resp.responses:
                    self._m_cycles.inc()
                    self._m_cycle_seconds.observe(time.monotonic() - t0)
                # One event after the cycle's collectives, for every
                # result of the cycle.
                if finished:
                    token = backend.produce()
                    for e, out in finished:
                        e.complete(out, out_token=token)
        if resp.responses:
            self._notify_done()
        if resp.abort is not None:
            LOG.error("horovod_tpu_torch engine: %s", resp.abort)
            self._stop(resp.abort)
            return False
        if resp.shutdown:
            self._stop("shutdown")
            return False
        return True

    # -- fast path, cycle thread ----------------------------------------------

    def _fp_adopt(self, start: int, sig: str):
        """Rank 0's freeze verdict: stage from round ``start`` on, against
        this rank's profile of the round two before it."""
        with self._cv:
            prof = self._fp_profiles.get(start - 2)
            if self._fp_state != NEGOTIATING or prof is None or \
                    prof[0] != sig or self._round >= start:
                # Cannot happen when the ranks agree; thaw the world.
                self._fp_state = THAWING
                self._fp_thaw_req = ("shape", "rank %d cannot stage "
                                     "schedule %s from round %d"
                                     % (self.rank, sig, start))
                self._seq += 1
                self._urgent = True
                return
            slots = prof[1]
            ends = fastpath.plan_buckets(slots, self.config.overlap_buckets,
                                         self.config.fusion_threshold_bytes)
            self._fp_sched = _Schedule(sig, slots, ends, start)
            self._fp_state = ARMED
            self._fp_profiles.clear()
        self._fp.freeze({"sig": sig, "slots": slots, "ends": ends,
                         "start": start}, self._group_seq + 1)

    def _fp_flush(self, _payload, _reason: str):
        """A thaw: every staged entry, dispatched or not, goes back to
        negotiation in program order, ahead of what came after it; the
        round in progress cannot freeze."""
        backend = self.op_manager.backend
        with self._cv:
            buckets = self._fp_ready + ([self._fp_open]
                                        if self._fp_open is not None else [])
            staged = []
            for b in buckets:
                token = b.token
                if token is None and b.entries and \
                        b.entries[0].backend is not None:
                    token = backend.producer(b.stream)
                for e in b.entries:
                    e.bucket, e.token = None, token
                    self.timeline.negotiate_start(e.request.name,
                                                  e.request.op_type)
                    staged.append(e)
            self._new[:0] = staged
            self._fp_ready, self._fp_open = [], None
            self._fp_sched, self._fp_slot = None, 0
            self._fp_state = NEGOTIATING
            self._fp_thaw_req = None
            self._round_sigs, self._round_ok = [], False
            self._fp_profiles.clear()
            self._seq += 1
            self._urgent = True

    def _fp_dispatch(self, buckets: List[_Bucket]):
        """Execute frozen buckets, in order, each as a negotiated fused
        allreduce would be (inside the backend's stream)."""
        backend = self.op_manager.backend
        for b in buckets:
            t0 = time.monotonic()
            entries = b.entries
            with self._cv:
                self._fp_ready.remove(b)
                for e in entries:
                    self._inflight.pop(e.request.name, None)
            q = entries[0].request
            names = [e.request.name for e in entries]
            self._group_seq += 1
            self._m_last_group.set(self._group_seq)
            fused = len(entries) > 1
            if fused:
                self._m_fused_bytes.inc(sum(e.request.nbytes
                                            for e in entries))
                self._m_fused_tensors.inc(len(entries))
            self.timeline.activity_start_all(
                names, "EXEC_FUSED_ALLREDUCE" if fused else "EXEC_ALLREDUCE",
                args={"group": self._group_seq})
            ps = process_sets.process_set_by_id(q.process_set_id)
            try:
                if ps is None:
                    raise HorovodInternalError(
                        "process set %d is not registered" % q.process_set_id)
                if b.token is not None:
                    backend.consume({b.token: None})
                tensors = [e.tensor for e in entries]
                backend.in_use(tensors)
                outs = mh.allreduce(tensors, q.red_op, q.prescale,
                                    q.postscale, ps,
                                    None if fused else names[0])
                token = backend.produce()
            except Exception as exc:  # noqa: BLE001 - reported on the handles
                LOG.error("frozen allreduce %s failed: %s", names, exc)
                for e in entries:
                    e.complete(error="allreduce %s failed: %s: %s" % (
                        names, type(exc).__name__, exc))
                self._notify_done()
                continue
            self.timeline.activity_end_all(names)
            self._m_fp_bucket.observe(time.monotonic() - t0)
            if b.last:
                self._m_fp_frozen.inc()
            for e, out in zip(entries, outs):
                e.complete(out, out_token=token)
            self._notify_done()

    def _notify_done(self):
        with self._done_cv:
            self._done_cv.notify_all()

    def _stop(self, reason: str):
        with self._cv:
            if self._stopped is None:
                self._stopped = reason
            entries = list(self._inflight.values())
            if self._join_entry is not None:
                entries.append(self._join_entry)
            self._inflight.clear()
            self._new.clear()
            self._join_entry = None
            self._fp_ready, self._fp_open = [], None
            self._fp_state = NEGOTIATING
        for e in entries:
            e.complete(error=reason)
        self._notify_done()

    def _perform(self, r: Response, finished: list):
        """Execute ``r``: errors complete their entries at once, results
        go to ``finished`` as (entry, output)."""
        if r.op_type == JOIN:
            with self._cv:
                e, self._join_entry = self._join_entry, None
            if e is not None:
                e.complete(r.last_joined)
            return
        with self._cv:
            entries = [self._inflight.pop(n, None) for n in r.names]
            joined = self._join_entry is not None
            if r.error is not None:
                self._round_ok = False
        for e in entries:
            if e is not None:
                self.timeline.negotiate_end(e.request.name)
        if r.error is not None:
            for e in entries:
                if e is not None:
                    e.complete(error=r.error)
            return
        ps = process_sets.process_set_by_id(r.process_set_id)
        if ps is None or not ps.included():
            return
        if not joined and any(e is None for e in entries):
            raise HorovodInternalError(
                "tensor %r was negotiated but rank %d never enqueued it "
                "and has not joined" % (r.names[entries.index(None)],
                                        self.rank))
        if r.op_type == BARRIER:
            for e in entries:
                e.complete()
            return
        self._group_seq += 1
        self._m_last_group.set(self._group_seq)
        # Adasum shares no buffer: its multi-tensor responses are not
        # fused.
        fused = len(r.requests) > 1 and r.red_op != ADASUM
        if fused:
            self._m_fused_bytes.inc(sum(q.nbytes for q in r.requests))
            self._m_fused_tensors.inc(len(r.requests))
        mine = [e for e in entries if e is not None]
        self.timeline.activity_start_all(
            [e.request.name for e in mine],
            "EXEC_FUSED_ALLREDUCE" if fused else "EXEC_" + r.op_type.upper(),
            args={"group": self._group_seq})
        backend = self.op_manager.backend
        try:
            backend.in_use([e.tensor for e in mine])
            tensors = [e.tensor if e is not None else
                       torch.zeros(q.shape, dtype=q.dtype, device=self.device)
                       for e, q in zip(entries, r.requests)]
            outs = self._execute(r, tensors, ps)
        except Exception as exc:  # noqa: BLE001 - reported on the handles
            LOG.error("%s %s failed: %s", r.op_type, r.names, exc)
            for e in mine:
                e.complete(error="%s %s failed: %s: %s" % (
                    r.op_type, r.names, type(exc).__name__, exc))
            return
        self.timeline.activity_end_all([e.request.name for e in mine])
        finished.extend((e, out) for e, out in zip(entries, outs)
                        if e is not None)

    def _execute(self, r: Response, tensors, ps) -> list:
        """Run ``r`` through ``ops/multihost.py``, which takes the
        hierarchical legs when the set has them and the payload passes
        the gate, and the flat collectives of ``ops/collectives.py``
        otherwise; Adasum is always flat.  A one-entry group's name keys
        its error-feedback residuals."""
        q = r.requests[0]
        name = r.names[0] if len(r.names) == 1 else None
        if r.op_type == ALLREDUCE:
            if r.red_op == ADASUM:
                mh.count_flat("allreduce", sum(t.numel() * t.element_size()
                                               for t in tensors))
                return [C.adasum_allreduce(t, q.prescale, r.postscale, ps)
                        for t in tensors]
            return mh.allreduce(tensors, r.red_op, q.prescale, r.postscale,
                                ps, name)
        if r.op_type == ALLGATHER:
            return [mh.allgather(tensors[0], r.aux, ps)]
        if r.op_type == BROADCAST:
            return [mh.broadcast_(tensors[0], q.root_rank, ps)]
        if r.op_type == REDUCESCATTER:
            return [mh.reducescatter(tensors[0], r.red_op, ps, name)]
        if r.op_type == ALLTOALL:
            n, me = ps.size(), ps.rank()
            return [(mh.alltoall(tensors[0], r.aux, ps), r.aux[me::n])]
        raise HorovodInternalError("unknown op %r" % r.op_type)
