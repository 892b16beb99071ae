"""Chrome-trace timeline of each tensor's way through the engine.

Counterpart of ``horovod_tpu.utils.timeline.Timeline`` (the reference's
``timeline.cc``): with ``HOROVOD_TIMELINE=/path.json`` rank 0 writes a
``chrome://tracing`` JSON array.  Each tensor is one row (``tid``, its
name): ``NEGOTIATE_<OP>`` from its enqueue to its negotiated response,
then ``EXEC_<OP>`` (``EXEC_FUSED_ALLREDUCE`` for a multi-tensor fused
allreduce) while the cycle thread issues its collective, with
``args.group``, the ``engine_last_group_id`` of that execution.  A
frozen round's tensor (``ops/fastpath.py``) ends its ``NEGOTIATE`` row
when it is staged, and its bucket's ``EXEC`` row carries the bucket's
group id as a negotiated execution does.
``HOROVOD_TIMELINE_MARK_CYCLES`` adds an instant event per cycle.  The
array is closed by ``shutdown()``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Iterable, Optional


class Timeline:
    """Thread-safe incremental chrome-trace writer; inactive (every
    record a no-op) until ``initialize`` opens a file."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fh = None
        self._first = True
        self._start = time.monotonic()
        self.mark_cycles = False

    def initialize(self, path: Optional[str], mark_cycles: bool = False):
        if not path:
            return
        with self._lock:
            if self._fh is not None:
                return
            self._fh = open(path, "w")
            self._fh.write("[\n")
            self._first = True
            self._start = time.monotonic()
            self.mark_cycles = mark_cycles

    def shutdown(self):
        with self._lock:
            if self._fh is None:
                return
            self._fh.write("\n]\n")
            self._fh.close()
            self._fh = None

    def _emit(self, record: dict):
        if self._fh is None:
            return
        with self._lock:
            if self._fh is None:
                return
            record["ts"] = int((time.monotonic() - self._start) * 1e6)
            if not self._first:
                self._fh.write(",\n")
            self._first = False
            self._fh.write(json.dumps(record))

    def activity_start(self, tensor_name: str, activity: str,
                       args: Optional[dict] = None):
        if self._fh is None:
            return
        record = {"name": activity, "ph": "B", "pid": 0, "tid": tensor_name}
        if args:
            record["args"] = args
        self._emit(record)

    def activity_end(self, tensor_name: str):
        if self._fh is not None:
            self._emit({"ph": "E", "pid": 0, "tid": tensor_name})

    def activity_start_all(self, names: Iterable[str], activity: str,
                           args: Optional[dict] = None):
        if self._fh is not None:
            for n in names:
                self.activity_start(n, activity, args)

    def activity_end_all(self, names: Iterable[str]):
        if self._fh is not None:
            for n in names:
                self.activity_end(n)

    def negotiate_start(self, tensor_name: str, op_name: str):
        if self._fh is not None:
            self.activity_start(tensor_name, "NEGOTIATE_" + op_name.upper())

    def negotiate_end(self, tensor_name: str):
        self.activity_end(tensor_name)

    def mark_cycle(self, cycle: int):
        if self.mark_cycles:
            self._emit({"name": "CYCLE_START", "ph": "i", "pid": 0,
                        "tid": "cycle", "s": "g", "args": {"cycle": cycle}})
