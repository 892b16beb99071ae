"""The engine's backend: the data plane that takes a world's tensors,
and how their device work is ordered around the cycle thread.

Counterpart of ``horovod_tpu.ops.op_manager`` (``OpManager``, ``:70``,
the reference's ``operation_manager.cc`` priority walk).  A world's
device decides its one backend, so the port has no walk and no order to
configure:

* ``nccl`` takes the CUDA tensors of a world on CUDA.  An enqueue
  records an event on the caller's current stream, right after the
  kernels that wrote its tensors (a frozen round's entries record one
  per bucket, when the bucket fills: ``ops/fastpath.py``); before a collective reads them, the
  engine's executor stream waits on that event (and on nothing queued
  later on the caller's stream), and each tensor is marked in use on the
  executor stream, so the caching allocator does not hand its memory out
  early; after a collective the executor stream records an event, which
  the caller's stream waits on in ``Handle.wait()``.  The host never
  synchronises with the device.
* ``gloo`` takes the CPU tensors of a world on the CPU.

A tensor on another device than the world's raises.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch


class Backend:
    name = "backend"
    device_type = ""

    def producer(self, stream=None):
        """At enqueue, on the caller's thread: a token for what produced
        the call's tensors (the work queued so far on ``stream``, the
        caller's current one if None), which ``consume`` waits on before
        it reads them."""
        return None

    def current_stream(self):
        """The caller's current stream (None where there is none); a
        frozen bucket's entries must share one, since one token covers
        them."""
        return None

    def stream(self):
        """On the cycle thread, around a cycle's collectives."""
        return contextlib.nullcontext()

    def consume(self, tokens):
        """At the start of a cycle, before its collectives read tensors
        enqueued under ``tokens``."""

    def in_use(self, tensors):
        """Before a collective reads ``tensors``."""

    def produce(self):
        """After a collective: the token ``finish`` takes."""
        return None

    def finish(self, tokens, outputs):
        """In ``Handle.wait()``, on the caller's thread, before the
        outputs are used."""


class NcclBackend(Backend):
    name = "nccl"
    device_type = "cuda"

    def __init__(self):
        self._stream = None

    def producer(self, stream=None):
        # The caller's stream at this point: the kernels that wrote the
        # tensors, and none that it queues after the enqueue.
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def current_stream(self):
        return torch.cuda.current_stream()

    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return torch.cuda.stream(self._stream)

    def consume(self, tokens):
        for ev in tokens:
            self._stream.wait_event(ev)

    def in_use(self, tensors):
        for t in tensors:
            t.record_stream(self._stream)

    def produce(self):
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    def finish(self, tokens, outputs):
        cur = torch.cuda.current_stream()
        for ev in tokens:
            cur.wait_event(ev)
        # Once per storage: a fused allreduce's outputs are views of one
        # buffer.
        seen = set()
        for t in _tensors(outputs):
            base = t if t._base is None else t._base
            if base.is_cuda and id(base) not in seen:
                seen.add(id(base))
                base.record_stream(cur)


class GlooBackend(Backend):
    name = "gloo"
    device_type = "cpu"


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


class OpManager:
    """The backend of a world on ``device``: NCCL for CUDA, gloo for the
    CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        if device.type == "cuda":
            self.backend: Backend = NcclBackend()
        elif device.type == "cpu":
            self.backend = GlooBackend()
        else:
            raise ValueError("no backend runs collectives on %s; a world "
                             "runs on CUDA (NCCL) or the CPU (gloo)"
                             % device)

    def backend_for(self, tensors: Sequence[torch.Tensor]) -> Backend:
        """The world's backend, when every tensor lies on its device
        type."""
        if all(t.device.type == self.backend.device_type for t in tensors):
            return self.backend
        raise ValueError(
            "no backend takes tensors on %s: this rank's collectives run "
            "on %s (%s)" % (sorted({str(t.device) for t in tensors}),
                            self.device, self.backend.name))
