"""The port's self-healing data plane (``horovod_tpu_torch.common.
resilience``) against the JAX package's (``horovod_tpu.common.
resilience``), case for case after ``tests/test_resilience.py``: the
same environment, the same injected faults (``HVD_TPU_FAULT``) and the
same inputs go to both, and the outcomes, retry counts, streaks,
checksums and verdicts must agree.  The port's payloads are torch
tensors where the reference's are numpy arrays of the same bytes.

Deliberate differences, each held here: ``DistNetworkError`` counts as
transient in the port; a payload not in host memory is never
checksummed; the degraded-route check of a one-rank world decides
locally in both, and the multi-rank form (a request in the engine's
cycle, not a KV record) is held in ``test_torch_port_resilience_world.py``.
"""

import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from horovod_tpu.common import faultline as ref_faultline
from horovod_tpu.common import metrics as ref_metrics
from horovod_tpu.common import resilience as ref_res
from horovod_tpu.utils import plancache
from horovod_tpu_torch.common import faultline, metrics, resilience

KNOBS = ("HVD_TPU_FAULT", "HOROVOD_COLLECTIVE_TIMEOUT_SECS",
         "HOROVOD_COLLECTIVE_TIMEOUT_PER_GIB", "HOROVOD_LEG_MAX_RETRIES",
         "HOROVOD_LEG_RETRY_BACKOFF", "HOROVOD_LEG_DEMOTE_THRESHOLD",
         "HOROVOD_LEG_REPROBE_SECS", "HOROVOD_DATA_PLANE_DEGRADE",
         "HOROVOD_WIRE_INTEGRITY", "HOROVOD_DATA_PLANE_CHECK_EVERY")


class _Side:
    """One package's resilience, fault plane and metrics."""

    def __init__(self, res, fault, mets, payload):
        self.res, self.fault, self.metrics = res, fault, mets
        self.payload = payload  # numpy int8 array -> this side's payload

    def reset(self):
        self.fault.reset()
        self.metrics.reset()
        self.res.reset()

    def retries(self, **labels):
        return self.metrics.series_sum("mh_leg_retries_total", **labels)


REF = _Side(ref_res, ref_faultline, ref_metrics, lambda a: a)
PORT = _Side(resilience, faultline, metrics, torch.from_numpy)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOROVOD_LEG_RETRY_BACKOFF", "0")
    plancache.reset()
    for side in SIDES:
        side.reset()
    yield
    plancache.reset()
    for side in SIDES:
        side.reset()


def _both(fn):
    """``fn(side)`` for the reference, then the port, each from a clean
    fault plane and registry."""
    out = []
    for side in SIDES:
        side.fault.reset()
        out.append(fn(side))
    return out


# -- knobs ------------------------------------------------------------------

@pytest.mark.parametrize("env", [
    {},
    {"HOROVOD_COLLECTIVE_TIMEOUT_SECS": "12",
     "HOROVOD_COLLECTIVE_TIMEOUT_PER_GIB": "4", "HOROVOD_LEG_MAX_RETRIES": "5",
     "HOROVOD_LEG_RETRY_BACKOFF": "0.2", "HOROVOD_LEG_DEMOTE_THRESHOLD": "2",
     "HOROVOD_LEG_REPROBE_SECS": "0", "HOROVOD_DATA_PLANE_DEGRADE": "off",
     "HOROVOD_WIRE_INTEGRITY": "false",
     "HOROVOD_DATA_PLANE_CHECK_EVERY": "3"},
    {"HOROVOD_COLLECTIVE_TIMEOUT_SECS": "soon", "HOROVOD_LEG_MAX_RETRIES": "-4",
     "HOROVOD_LEG_DEMOTE_THRESHOLD": "0", "HOROVOD_LEG_REPROBE_SECS": "x",
     "HOROVOD_DATA_PLANE_DEGRADE": "1", "HOROVOD_WIRE_INTEGRITY": "no"},
])
def test_knobs_match_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def knobs(side):
        r = side.res
        return (r.collective_timeout_secs(), r.collective_timeout_per_gib(),
                r.leg_retry_config(), r.leg_demote_threshold(),
                r.leg_reprobe_secs(), r.degrade_enabled(),
                r.wire_integrity_enabled(), r.check_every_commits())

    got, want = _both(knobs)
    assert got == want


@pytest.mark.parametrize("nbytes", [0, 1, 4096, 1 << 29, 1 << 30, 5 << 30])
@pytest.mark.parametrize("base", ["0", "10"])
def test_collective_deadline_matches_the_reference(monkeypatch, nbytes, base):
    monkeypatch.setenv("HOROVOD_COLLECTIVE_TIMEOUT_SECS", base)
    monkeypatch.setenv("HOROVOD_COLLECTIVE_TIMEOUT_PER_GIB", "30")
    want, got = _both(lambda side: side.res.collective_deadline(nbytes))
    assert got == want
    assert got == (0.0 if base == "0" else 10.0 + 30.0 * nbytes / (1 << 30))


def test_group_deadline_is_thread_local():
    for side in SIDES:
        side.res.set_group_deadline(123.0)
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            side.res.group_deadline()))
        t.start()
        t.join()
        assert seen == [None]
        assert side.res.group_deadline() == 123.0
        side.res.set_group_deadline(None)


# -- classification ---------------------------------------------------------

CASES = [
    (lambda r: r.LegTransportError("x"), True),
    (lambda r: ConnectionResetError("peer reset"), True),
    (lambda r: TimeoutError("t"), True),
    (lambda r: RuntimeError("UNAVAILABLE: connection reset by peer"), True),
    (lambda r: RuntimeError("DEADLINE_EXCEEDED while awaiting DCN send"),
     True),
    (lambda r: r.WireIntegrityError("crc"), False),
    (lambda r: ValueError("bad shape"), False),
    (lambda r: TypeError("bad dtype"), False),
    (lambda r: RuntimeError("INVALID_ARGUMENT: dimension mismatch"), False),
    (lambda r: RuntimeError("Connection closed by peer"), False),
]


@pytest.mark.parametrize("make,transient", CASES)
def test_is_transient_leg_matches_the_reference(make, transient):
    want, got = _both(lambda side: side.res.is_transient_leg(make(side.res)))
    assert got == want == transient


def test_torch_errors_classify():
    """The port's addition: ``DistNetworkError`` is transient whatever
    its text; gloo's other failures go by their text as in the
    reference."""
    assert resilience.is_transient_leg(dist.DistNetworkError("store gone"))
    assert not ref_res.is_transient_leg(dist.DistNetworkError("store gone"))
    assert resilience.is_transient_leg(
        dist.DistError("gloo: Connection reset by peer"))
    assert not resilience.is_transient_leg(dist.DistError("shape mismatch"))
    assert resilience.failure_reason(
        dist.DistNetworkError("store gone")) == "transport"


def test_failure_reason_matches_the_reference():
    from horovod_tpu.ops.engine import CollectiveDeadlineExceeded as RefCDE
    from horovod_tpu_torch.ops.engine import CollectiveDeadlineExceeded
    cases = [
        (RefCDE, CollectiveDeadlineExceeded, "collective deadline exceeded: g"),
        ("WireIntegrityError", "WireIntegrityError", "crc"),
        ("LegTransportError", "LegTransportError", "drop"),
        (RuntimeError, RuntimeError, "connection refused"),
        (ValueError, ValueError, "shape"),
    ]
    for ref_cls, port_cls, text in cases:
        r = getattr(ref_res, ref_cls) if isinstance(ref_cls, str) else ref_cls
        p = (getattr(resilience, port_cls) if isinstance(port_cls, str)
             else port_cls)
        assert resilience.failure_reason(p(text)) == \
            ref_res.failure_reason(r(text))
    assert resilience.failure_reason(CollectiveDeadlineExceeded("x")) == \
        "deadline"


# -- the leg guard ----------------------------------------------------------

def _payload():
    return np.arange(16, dtype=np.int8)


def _leg(side, run=None, payload=None, quantized=False, op="allreduce",
         cls="20"):
    """Run the guard; -> (outcome, calls of run, retries counted, streak)."""
    calls = []

    def go():
        calls.append(1)
        return run() if run is not None else "ok"

    payloads = () if payload is None else (side.payload(payload),)
    try:
        outcome = side.res.run_hier_leg(op, cls, go, payloads=payloads,
                                        quantized=quantized)
    except Exception as exc:  # noqa: BLE001 - compared by type name
        outcome = type(exc).__name__
    return (outcome, len(calls), side.retries(op=op),
            dict(side.res._state.streak))


@pytest.mark.parametrize("spec,env,quantized,expect", [
    # two injected drops, two retries: absorbed, the streak clean
    ("mh.leg.drop:drop@times=2", {}, False, ("ok", 1, 2.0, {})),
    # unbounded: 1 attempt + 2 retries fail, one exhaustion
    ("mh.leg.drop:drop", {}, False,
     ("LegDegraded", 0, 2.0, {("allreduce", "20"): 1})),
    ("mh.leg.drop:drop", {"HOROVOD_DATA_PLANE_DEGRADE": "0"}, False,
     ("LegTransportError", 0, 2.0, {("allreduce", "20"): 1})),
    ("mh.leg.drop:drop@times=3", {}, False,
     ("LegDegraded", 0, 2.0, {("allreduce", "20"): 1})),
    ("mh.leg.drop:drop@after=1@times=1", {}, False, ("ok", 1, 0.0, {})),
    # a delay is latency, not a retry
    ("mh.leg.delay:delay:0", {}, False, ("ok", 1, 0.0, {})),
    # one corrupted checksum: the leg runs once more
    ("mh.leg.corrupt:drop@times=1", {}, True, ("ok", 2, 1.0, {})),
    # persistent corruption: one re-run, then raise
    ("mh.leg.corrupt:drop", {}, True,
     ("WireIntegrityError", 2, 1.0, {("allreduce", "20"): 1})),
    ("mh.leg.corrupt:drop", {"HOROVOD_WIRE_INTEGRITY": "0"}, True,
     ("ok", 1, 0.0, {})),
    # only quantized legs are checksummed
    ("mh.leg.corrupt:drop", {}, False, ("ok", 1, 0.0, {})),
])
def test_run_hier_leg_matches_the_reference(monkeypatch, spec, env, quantized,
                                            expect):
    monkeypatch.setenv("HVD_TPU_FAULT", spec)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want, got = _both(lambda side: _leg(side, payload=_payload(),
                                        quantized=quantized))
    assert got == want == expect


def test_fatal_error_never_retries():
    def boom():
        raise ValueError("dimension mismatch")

    want, got = _both(lambda side: _leg(side, run=boom))
    assert got == want == ("ValueError", 1, 0.0, {})


def test_group_deadline_bounds_retries(monkeypatch):
    monkeypatch.setenv("HOROVOD_LEG_MAX_RETRIES", "50")
    monkeypatch.setenv("HVD_TPU_FAULT", "mh.leg.drop:drop")

    def past_deadline(side):
        side.res.set_group_deadline(time.monotonic() - 1.0)
        try:
            t0 = time.monotonic()
            out = _leg(side)
            return out, time.monotonic() - t0 < 1.0
        finally:
            side.res.set_group_deadline(None)

    want, got = _both(past_deadline)
    assert got == want
    assert got[0][0] == "LegDegraded" and got[1]


def test_success_resets_streak(monkeypatch):
    def seq(side):
        monkeypatch.setenv("HVD_TPU_FAULT", "mh.leg.drop:drop@times=3")
        side.fault.reset()
        first = _leg(side)
        monkeypatch.delenv("HVD_TPU_FAULT")
        side.fault.reset()
        return first, _leg(side)

    want, got = _both(seq)
    assert got == want
    assert got[0][3] == {("allreduce", "20"): 1} and got[1][3] == {}


def test_crc_detects_real_payload_mutation():
    """No injection: the payload changing during the exchange."""
    def mutate_run(side):
        payload = side.payload(_payload())

        def mutate():
            payload[0] += 1
            return "ok"

        try:
            side.res.run_hier_leg("allreduce", "20", mutate,
                                  payloads=(payload,), quantized=True)
        except Exception as exc:  # noqa: BLE001
            return type(exc).__name__
        return "ok"

    assert _both(mutate_run) == ["WireIntegrityError"] * 2


def test_device_payloads_are_not_checksummed(monkeypatch):
    """A payload not in host memory (here on the meta device) is never
    read back: the leg runs once, unchecked, under persistent
    corruption."""
    monkeypatch.setenv("HVD_TPU_FAULT", "mh.leg.corrupt:drop")
    t = torch.empty(16, device="meta")
    assert resilience.run_hier_leg("allreduce", "20", lambda: "ok",
                                   payloads=(t,), quantized=True) == "ok"


# -- wire checksums ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "int8", "uint8",
                                   "int32", "bfloat16"])
def test_wire_checksum_matches_the_reference(dtype):
    rng = np.random.RandomState(3)
    t = torch.from_numpy(rng.randn(4, 33).astype(np.float32)).to(
        getattr(torch, dtype) if dtype != "uint8" else torch.uint8)
    raw = t.view(torch.uint8) if t.element_size() == 1 else t.view(
        {2: torch.int16, 4: torch.int32}[t.element_size()])
    want = ref_res.wire_checksum(raw.numpy())
    assert resilience.wire_checksum(t) == want
    # non-contiguous: its elements in order
    assert resilience.wire_checksum(t.t()) == ref_res.wire_checksum(
        raw.t().contiguous().numpy())


def test_wire_checksum_is_order_and_content_sensitive():
    a = np.arange(8, dtype=np.float32)
    b = a * 2
    for side in SIDES:
        wa, wb = side.payload(a), side.payload(b)
        assert side.res.wire_checksum(wa, wb) != side.res.wire_checksum(wb, wa)
        assert side.res.wire_checksum(wa, wb) == ref_res.wire_checksum(a, b)
    c = torch.from_numpy(a.copy())
    c[3] = -1
    assert resilience.wire_checksum(c) != ref_res.wire_checksum(a)


# -- demotion and re-promotion in a one-rank world --------------------------

def _exhaust(side, monkeypatch, n, op="allreduce", cls="20"):
    monkeypatch.setenv("HVD_TPU_FAULT", "mh.leg.drop:drop")
    side.fault.reset()
    for _ in range(n):
        _leg(side, op=op, cls=cls)
    monkeypatch.delenv("HVD_TPU_FAULT")
    side.fault.reset()


def _check(side):
    return side.res.check_degraded_routes()


@pytest.fixture
def clock(monkeypatch):
    """A monotonic clock the test moves (both packages read
    ``time.monotonic``)."""
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    return now


def test_demote_reprobe_promote_matches_the_reference(monkeypatch, clock):
    monkeypatch.setenv("HOROVOD_LEG_DEMOTE_THRESHOLD", "3")
    monkeypatch.setenv("HOROVOD_LEG_REPROBE_SECS", "30")

    def sequence(side):
        clock[0] = 1000.0
        out = []
        _exhaust(side, monkeypatch, 2)
        out.append(_check(side))  # below the threshold
        _exhaust(side, monkeypatch, 1)
        out.append(_check(side))  # demote
        out.append(side.res.demoted("allreduce", "20"))
        out.append(side.metrics.series_sum("mh_degraded_routes",
                                           op="allreduce"))
        out.append(_check(side))  # nothing new
        clock[0] += 29.0
        out.append(_check(side))  # not yet
        clock[0] += 2.0
        out.append(_check(side))  # promote
        out.append(side.res.demoted("allreduce", "20"))
        out.append(side.metrics.series_sum("mh_degraded_routes",
                                           op="allreduce"))
        out.append(side.res.demoted_routes())
        return out

    want, got = _both(sequence)
    assert got == want
    assert got[1] == {"action": "demote", "op": "allreduce",
                      "size_class": "20", "streak": 3, "apply_at": 2}
    assert got[0] is None and got[5] is None
    assert got[6]["action"] == "promote"


def test_reprobe_zero_means_permanent_demotion(monkeypatch, clock):
    monkeypatch.setenv("HOROVOD_LEG_DEMOTE_THRESHOLD", "1")
    monkeypatch.setenv("HOROVOD_LEG_REPROBE_SECS", "0")

    def sequence(side):
        clock[0] = 1000.0
        _exhaust(side, monkeypatch, 1)
        first = _check(side)
        clock[0] += 3600.0
        return first, _check(side), side.res.demoted("allreduce", "20")

    want, got = _both(sequence)
    assert got == want
    assert got[0]["action"] == "demote" and got[1] is None and got[2]


def test_degrade_disabled_skips_check(monkeypatch):
    monkeypatch.setenv("HOROVOD_DATA_PLANE_DEGRADE", "off")
    monkeypatch.setenv("HOROVOD_LEG_DEMOTE_THRESHOLD", "1")
    assert _both(lambda side: (_exhaust(side, monkeypatch, 1),
                               _check(side))[1]) == [None, None]


def test_route_verdicts_thaw_the_fast_path(monkeypatch):
    """A verdict thaws a frozen schedule first (reason route), in the
    port as in the reference."""
    from horovod_tpu_torch.ops import fastpath
    monkeypatch.setenv("HOROVOD_LEG_DEMOTE_THRESHOLD", "1")
    fastpath.reset()
    fz = fastpath.ScheduleFreezer(1)
    fz.freeze({"sig": "s", "slots": [], "ends": []}, 1)
    fastpath.register(fz)
    try:
        _exhaust(PORT, monkeypatch, 1)
        assert _check(PORT)["action"] == "demote"
        assert fz.frozen() is None
        assert metrics.series_sum("fastpath_thaws_total",
                                  reason="route") == 1
    finally:
        fastpath.reset()


# -- attribution ------------------------------------------------------------

def test_describe_matches_the_reference(monkeypatch):
    monkeypatch.setenv("HOROVOD_COLLECTIVE_TIMEOUT_SECS", "12")
    monkeypatch.setenv("HOROVOD_LEG_DEMOTE_THRESHOLD", "1")

    def describe(side):
        _exhaust(side, monkeypatch, 1)
        _check(side)
        side.metrics.counter("mh_collective_failures_total", op="allreduce",
                             reason="transport").inc()
        return side.res.describe()

    want, got = _both(describe)
    assert got == want
    assert got["deadline_secs"] == 12.0
    assert got["demoted_routes"] == [{"op": "allreduce", "size_class": "20"}]
    assert got["leg_retries_total"] == 2.0
    assert got["failures_by_reason"] == {"transport": 1.0}


# -- the execution watchdog's records ---------------------------------------

class _PendingEvent:
    """A result event that has not reported done yet."""

    def query(self):
        return False


def test_watch_record_lets_its_entries_go_once_executed():
    """A collective that ran stays watched until its result event reports
    done, but its record no longer holds its entries: their tensors are
    freed as soon as the caller drops them, not at the next tick."""
    import gc
    import weakref
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.common.message import ALLREDUCE, Request
    from horovod_tpu_torch.ops.engine import Engine, _Entry
    eng = Engine(Config.from_env(), 0, 1, torch.device("cpu"))
    assert eng._watchdog is not None  # the stall warning is on by default
    grad = torch.ones(1 << 10)
    gone = weakref.ref(grad)
    entry = _Entry(Request("g", ALLREDUCE, torch.float32, (1 << 10,)),
                   grad, None, None)
    wid = eng._watch_register(ALLREDUCE, ["g"], [entry], 0.0)
    assert eng._watched[wid]["entries"] == [entry]
    entry.complete(grad * 2)
    eng._watch_until([wid], _PendingEvent())
    rec = eng._watched[wid]
    assert rec["entries"] == [] and isinstance(rec["event"], _PendingEvent)
    del grad, entry
    gc.collect()
    assert gone() is None


def test_inert_check_cadence_warns_at_init(monkeypatch, caplog):
    """``HOROVOD_DATA_PLANE_CHECK_EVERY`` has no commit hook to drive in
    the port yet: setting it is said out loud, not ignored."""
    import logging
    import horovod_tpu_torch as hvd
    monkeypatch.setenv("HOROVOD_DATA_PLANE_CHECK_EVERY", "3")
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        hvd.init(device="cpu")
        hvd.shutdown()
    assert "HOROVOD_DATA_PLANE_CHECK_EVERY has no effect" in caplog.text
