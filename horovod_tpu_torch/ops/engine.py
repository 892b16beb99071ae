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
list, in order, through ``ops/collectives.py``.  No other thread issues
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
from .op_manager import OpManager

LOG = logging.getLogger("horovod_tpu_torch")

# Cycle pause of a multi-rank world with nothing outstanding on this rank.
IDLE_SECS = 0.5


class HorovodInternalError(RuntimeError):
    """A collective failed: a negotiation error (ranks disagree, a joined
    rank cannot take part), a stall past the shutdown threshold, or the
    engine stopped."""


class _Entry:
    __slots__ = ("request", "tensor", "backend", "token", "done", "result",
                 "error", "out_token")

    def __init__(self, request: Request, tensor, backend, token):
        self.request = request
        self.tensor = tensor
        self.backend = backend
        self.token = token
        self.done = False
        self.result = None
        self.error: Optional[str] = None
        self.out_token = None

    def complete(self, result=None, error: Optional[str] = None,
                 out_token=None):
        """Set the outcome; the engine then wakes the waiters
        (``Engine._notify_done``)."""
        self.result, self.error, self.out_token = result, error, out_token
        self.done = True


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
    if not all(e.done for e in entries):
        engine = todo[0]._engine
        engine.wake()
        with engine._done_cv:
            while not all(e.done for e in entries):
                engine._done_cv.wait()
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
        self.controller = Controller(
            rank, size, self.cache, stall, config.fusion_threshold_bytes,
            lambda psid: process_sets.members(psid, size),
            GlooTransport(rank, size, control_group) if size > 1 else None)
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
        self._m_cycles = metrics.counter("engine_cycles_total")
        self._m_cycle_seconds = metrics.histogram("engine_cycle_seconds")
        self._m_queue_depth = metrics.gauge("engine_queue_depth")
        self._m_submitted = metrics.counter("engine_bytes_submitted_total")
        self._m_fused_bytes = metrics.counter("engine_bytes_fused_total")
        self._m_fused_tensors = metrics.counter("engine_tensors_fused_total")
        self._m_last_group = metrics.gauge("engine_last_group_id")
        self._m_last_group.set(0)  # this engine's group ids start at 1
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd-torch-cycle", daemon=True)

    def start(self):
        """Start the cycle thread."""
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
        token = backend.producer() if backend is not None else None
        entries = [_Entry(q, t, backend, token)
                   for q, t in zip(requests, tensors)]
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
            self._new.extend(entries)
            self._seq += 1
            if self._idle:
                # A pacing cycle thread wakes on its own timeout; waking
                # it here would only trade the GIL with this thread.
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
            self._join_entry = e
            self._seq += 1
            self._urgent = True
            self._cv.notify()
        return Handle(self, [e], lambda results: results[0])

    def shutdown(self):
        """Ask the coordinator to stop (every rank must), then wait for
        the cycle thread; outstanding handles fail."""
        with self._cv:
            self._shutdown_requested = True
            self._seq += 1
            self._urgent = True
            self._cv.notify()
        self._thread.join()
        self.timeline.shutdown()
        # Handles outlive the engine: drop its hold on the world's groups.
        self.controller = None

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
                    shutdown = self._shutdown_requested
                    joined = self._join_entry is not None
                if not self._cycle(new, shutdown, joined):
                    return
        except Exception as exc:  # the loop's boundary: fail, never hang
            LOG.exception("horovod_tpu_torch engine: the cycle failed")
            self._stop("negotiation failed: %s: %s"
                       % (type(exc).__name__, exc))

    def _wait_for_cycle(self, seen: int):
        """Under the lock: return when the next cycle should start.  New
        work starts one a cycle time after the last began, so the hooks
        of a backward pass batch into few cycles; a waiting caller, a
        join or a shutdown starts one at once.  With nothing new, a rank
        of a multi-rank world cycles every cycle time while it has work
        outstanding and every ``IDLE_SECS`` otherwise (the coordinator's
        stall checks need the cycles); a one-rank world sleeps."""
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

    def _cycle(self, new: List[_Entry], shutdown: bool, joined: bool) -> bool:
        self._cycles += 1
        self.timeline.mark_cycle(self._cycles)
        msg = CycleRequest(self.rank, shutdown, joined)
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
        backend = self.op_manager.backend
        finished = []
        with backend.stream():
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
                # One event after the cycle's collectives, for every
                # result of the cycle.
                if finished:
                    token = backend.produce()
                    for e, out in finished:
                        e.complete(out, out_token=token)
        if resp.responses:
            self._notify_done()
            self._m_cycles.inc()
            self._m_cycle_seconds.observe(time.monotonic() - t0)
        if resp.abort is not None:
            LOG.error("horovod_tpu_torch engine: %s", resp.abort)
            self._stop(resp.abort)
            return False
        if resp.shutdown:
            self._stop("shutdown")
            return False
        return True

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
        q = r.requests[0]
        group, n = ps.group, ps.size()
        if r.op_type == ALLREDUCE:
            if r.red_op == ADASUM:
                return [C.adasum_allreduce(t, q.prescale, r.postscale, ps)
                        for t in tensors]
            return C.allreduce(tensors, r.red_op, q.prescale, r.postscale, n,
                               group)
        if r.op_type == ALLGATHER:
            return [C.allgather(tensors[0], r.aux, group)]
        if r.op_type == BROADCAST:
            return [C.broadcast_(tensors[0], q.root_rank, group)]
        if r.op_type == REDUCESCATTER:
            return [C.reducescatter(tensors[0], r.red_op, n, ps.rank(),
                                    group)]
        if r.op_type == ALLTOALL:
            me = ps.rank()
            send = r.aux[me * n:(me + 1) * n]
            recv = r.aux[me::n]
            return [(C.alltoall(tensors[0], send, recv, group), recv)]
        raise HorovodInternalError("unknown op %r" % r.op_type)
