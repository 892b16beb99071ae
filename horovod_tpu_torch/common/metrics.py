"""The process-local metrics registry: counters, gauges and log2-bucket
histograms over one canonical table of series names.

Counterpart of the registry of ``horovod_tpu.common.metrics`` (``NAMES``,
``counter``, ``gauge``, ``histogram``, ``snapshot``, ``metrics_snapshot``)
with the rows the engine writes.  A name missing from ``NAMES``, or used
as another kind, raises, so a typo cannot fork a series.  Thread-safe:
the caller's thread and the engine's cycle thread both write.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

NAMES: Dict[str, Tuple[str, str]] = {
    "engine_cycles_total": (
        "counter", "negotiation cycles that executed at least one "
                   "collective"),
    "engine_cycle_seconds": (
        "histogram", "wall time of one such cycle, negotiation and the "
                     "host side of its collectives"),
    "engine_queue_depth": (
        "gauge", "entries this rank sent for negotiation at the start of "
                 "the latest cycle"),
    "engine_bytes_submitted_total": (
        "counter", "payload bytes enqueued into the engine"),
    "engine_bytes_fused_total": (
        "counter", "payload bytes that rode a multi-tensor fused "
                   "allreduce (vs executed alone)"),
    "engine_tensors_fused_total": (
        "counter", "tensors that rode multi-tensor fused allreduces"),
    "engine_last_group_id": (
        "gauge", "monotonic id of the newest executed collective group; "
                 "the same id tags the group's timeline EXEC records "
                 "(args.group)"),
}

# Histogram buckets: powers of two from 2^-20 to 2^10 (seconds).
_HIST_EXP_MIN, _HIST_EXP_MAX = -20, 10


class _Series:
    __slots__ = ("kind", "value", "buckets", "sum", "count")

    def __init__(self, kind: str):
        self.kind = kind
        self.value = 0.0
        self.buckets: Dict[int, int] = {}
        self.sum = 0.0
        self.count = 0


class _Handle:
    """One series; every update goes through the registry's lock."""

    __slots__ = ("_lock", "_series")

    def __init__(self, lock, series: _Series):
        self._lock = lock
        self._series = series

    def inc(self, n: float = 1.0):
        if self._series.kind != "counter":
            raise ValueError("inc() on a %s" % self._series.kind)
        with self._lock:
            self._series.value += n

    def set(self, v: float):
        if self._series.kind != "gauge":
            raise ValueError("set() on a %s" % self._series.kind)
        with self._lock:
            self._series.value = float(v)

    def observe(self, v: float):
        if self._series.kind != "histogram":
            raise ValueError("observe() on a %s" % self._series.kind)
        v = float(v)
        e = _HIST_EXP_MIN
        while e < _HIST_EXP_MAX and v > 2.0 ** e:
            e += 1
        with self._lock:
            s = self._series
            s.buckets[e] = s.buckets.get(e, 0) + 1
            s.sum += v
            s.count += 1


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}

    def _get(self, kind: str, name: str) -> _Handle:
        decl = NAMES.get(name)
        if decl is None:
            raise KeyError("metric %r is not declared in metrics.NAMES"
                           % name)
        if decl[0] != kind:
            raise ValueError("metric %r is declared as a %s but used as a %s"
                             % (name, decl[0], kind))
        with self._lock:
            series = self._series.setdefault(name, _Series(kind))
        return _Handle(self._lock, series)

    def snapshot(self) -> Dict[str, Any]:
        """``{name: {kind, help, value}}``; a histogram has ``buckets``
        (upper bound exponent -> count), ``sum`` and ``count``."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, s in self._series.items():
                row: Dict[str, Any] = {"kind": s.kind, "help": NAMES[name][1]}
                if s.kind == "histogram":
                    row.update(buckets={str(e): n for e, n in
                                        sorted(s.buckets.items())},
                               sum=s.sum, count=s.count)
                else:
                    row["value"] = s.value
                out[name] = row
        return out


_registry = Registry()


def counter(name: str) -> _Handle:
    return _registry._get("counter", name)


def gauge(name: str) -> _Handle:
    return _registry._get("gauge", name)


def histogram(name: str) -> _Handle:
    return _registry._get("histogram", name)


def snapshot() -> Dict[str, Any]:
    return _registry.snapshot()


def metrics_snapshot() -> Dict[str, Any]:
    """The process's metrics as a dict (``hvd.metrics_snapshot``); works
    before and without ``hvd.init()``."""
    return snapshot()
