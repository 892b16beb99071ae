"""The process-local metrics registry: counters, gauges and log2-bucket
histograms over one canonical table of series names, with labels, and
structured events.

Counterpart of the registry of ``horovod_tpu.common.metrics`` (``NAMES``,
``counter``, ``gauge``, ``histogram``, ``snapshot``, ``series_sum``,
``event``, ``metrics_snapshot``) with the rows the engine, its fast
path and the hierarchical legs (``mh_*``) write.  A name missing from
``NAMES``, or used as another kind, raises, so a typo cannot fork a
series.  ``event`` counts ``events_total{kind}`` and keeps the newest
``EVENTS_KEPT`` events in memory (``events()``); the reference's on-disk
journal is not ported.
Thread-safe: the caller's thread and the engine's cycle thread both
write.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Tuple

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
    "fastpath_frozen_cycles_total": (
        "counter", "rounds dispatched off a frozen schedule, their "
                   "negotiation skipped; disjoint from "
                   "engine_cycles_total"),
    "fastpath_thaws_total": (
        "counter", "frozen schedules thawed back to negotiation, "
                   "labelled reason (shape|membership|staleness|route|"
                   "deadline); the paired fastpath_thaw event carries "
                   "the frozen schedule's group id"),
    "engine_overlap_bucket_seconds": (
        "histogram", "host time of one frozen bucket's dispatch on the "
                     "cycle thread (HOROVOD_OVERLAP_BUCKETS buckets a "
                     "round)"),
    "mh_collective_path_total": (
        "counter", "executed collectives by the path that moved them, "
                   "labelled op and path (hier: local reduce-scatter, "
                   "cross-node leg, local all-gather; flat: one "
                   "collective over the set)"),
    "mh_bus_bytes_total": (
        "counter", "bytes a collective put on the wire, labelled op and "
                   "path: the payload's, or with a cross-node codec its "
                   "elements at the wire width plus the scales"),
    "mh_compressed_collectives_total": (
        "counter", "hierarchical collectives whose cross-node leg ran a "
                   "wire codec, labelled op and codec"),
    "mh_compression_ratio": (
        "gauge", "payload bytes over wire bytes of the latest compressed "
                 "collective, labelled op and codec"),
    "events_total": (
        "counter", "structured events recorded (metrics.event), labelled "
                   "kind"),
}

EVENTS_KEPT = 256

# Histogram buckets: powers of two from 2^-20 to 2^10 (seconds).
_HIST_EXP_MIN, _HIST_EXP_MAX = -20, 10


class _Series:
    __slots__ = ("kind", "labels", "value", "buckets", "sum", "count")

    def __init__(self, kind: str, labels: Tuple[Tuple[str, str], ...]):
        self.kind = kind
        self.labels = labels
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
        self._series: Dict[Tuple[str, tuple], _Series] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, Any]) -> _Handle:
        decl = NAMES.get(name)
        if decl is None:
            raise KeyError("metric %r is not declared in metrics.NAMES"
                           % name)
        if decl[0] != kind:
            raise ValueError("metric %r is declared as a %s but used as a %s"
                             % (name, decl[0], kind))
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            series = self._series.get((name, key))
            if series is None:
                series = self._series[(name, key)] = _Series(kind, key)
        return _Handle(self._lock, series)

    def snapshot(self) -> Dict[str, Any]:
        """``{name: {kind, help, value, series}}``: ``value`` sums the
        family's series (a histogram has ``buckets``, upper bound
        exponent -> count, ``sum`` and ``count`` instead), ``series``
        lists each label set's ``{labels, value}`` (or its histogram
        fields)."""
        out: Dict[str, Any] = {}
        with self._lock:
            for (name, _), s in sorted(self._series.items()):
                fam = out.setdefault(name, {"kind": s.kind,
                                            "help": NAMES[name][1],
                                            "series": []})
                row: Dict[str, Any] = {"labels": dict(s.labels)}
                if s.kind == "histogram":
                    row.update(buckets={str(e): n for e, n in
                                        sorted(s.buckets.items())},
                               sum=s.sum, count=s.count)
                    merged = fam.setdefault("buckets", {})
                    for e, n in row["buckets"].items():
                        merged[e] = merged.get(e, 0) + n
                    fam["sum"] = fam.get("sum", 0.0) + s.sum
                    fam["count"] = fam.get("count", 0) + s.count
                else:
                    row["value"] = s.value
                    fam["value"] = fam.get("value", 0.0) + s.value
                fam["series"].append(row)
        return out


_registry = Registry()


_events_lock = threading.Lock()
_events: collections.deque = collections.deque(maxlen=EVENTS_KEPT)


def counter(name: str, **labels) -> _Handle:
    return _registry._get("counter", name, labels)


def gauge(name: str, **labels) -> _Handle:
    return _registry._get("gauge", name, labels)


def histogram(name: str, **labels) -> _Handle:
    return _registry._get("histogram", name, labels)


def snapshot() -> Dict[str, Any]:
    return _registry.snapshot()


def series_sum(name: str, **labels) -> float:
    """The sum of one family's series whose labels include ``labels``."""
    fam = snapshot().get(name)
    if not fam:
        return 0.0
    want = {k: str(v) for k, v in labels.items()}
    return sum(row.get("value", 0.0) for row in fam["series"]
               if all(row["labels"].get(k) == v for k, v in want.items()))


def event(kind: str, **fields):
    """Record one structured event: ``events_total{kind}`` and the
    event itself, ``{"ts", "kind", **fields}``, among the newest
    ``EVENTS_KEPT``."""
    counter("events_total", kind=kind).inc()
    record = {"ts": time.time(), "kind": kind}
    record.update(fields)
    with _events_lock:
        _events.append(record)


def events(kind: str = None) -> List[Dict[str, Any]]:
    """The events kept, oldest first (of one ``kind`` if given)."""
    with _events_lock:
        return [e for e in _events if kind is None or e["kind"] == kind]


def metrics_snapshot() -> Dict[str, Any]:
    """The process's metrics as a dict (``hvd.metrics_snapshot``); works
    before and without ``hvd.init()``."""
    return snapshot()
