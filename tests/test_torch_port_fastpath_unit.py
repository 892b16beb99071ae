"""The port's fast-path pieces in one process (no world, no spawn): its
``bucket_ends``, ``schedule_sig`` and ``ScheduleFreezer`` held against
``horovod_tpu.ops.fastpath`` on seeded inputs; the controller's freeze
verdict and bucket exchange driven with hand-built cycle messages
(agreement, a laggard's report, "not yet" without a thaw, a thaw on each
source, Adasum and join rounds never frozen); the bucket plan's cuts;
the knobs; and a cache bit meeting a full request of the same name.
Everything compared here is exact (integers, strings, verdicts).
"""

import logging

import numpy as np
import pytest
import torch

from horovod_tpu.common import metrics as jax_metrics
from horovod_tpu.ops import fastpath as ref

from horovod_tpu_torch.common import metrics
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.controller import Controller
from horovod_tpu_torch.common.message import (ALLREDUCE, BROADCAST,
                                              CycleRequest, Request)
from horovod_tpu_torch.common.response_cache import ResponseCache
from horovod_tpu_torch.ops import fastpath
from horovod_tpu_torch.utils.stall_inspector import StallInspector

WORLD = 3
WARM = 3
F32, F16 = torch.float32, torch.float16


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("buckets", [1, 2, 4, 7, 200])
def test_bucket_ends_match_the_reference(seed, buckets):
    rng = np.random.RandomState(seed)
    sizes = [int(s) for s in rng.randint(1, 1 << 20, rng.randint(0, 60))]
    for cap in (1 << 18, 1 << 22, 64 << 20):
        assert fastpath.bucket_ends(sizes, buckets, cap) == \
            ref.bucket_ends(sizes, buckets, cap)


def test_schedule_sig_matches_the_reference():
    rng = np.random.RandomState(0)
    for _ in range(20):
        profile = tuple(("allreduce", 0, "float32", "Average", 1.0, 1.0,
                         tuple(int(d) for d in rng.randint(1, 9, 2)),
                         int(rng.randint(1, 1000)), 0, 0)
                        for _ in range(rng.randint(1, 12)))
        assert fastpath.schedule_sig(profile) == ref.schedule_sig(profile)


def _observe_both(profiles, warm):
    ours = fastpath.ScheduleFreezer(warm)
    theirs = ref.ScheduleFreezer(warm)
    out = []
    for p in profiles:
        out.append(((ours.observe(p), ours.streak),
                    (theirs.observe(p), theirs.streak)))
    return out


def test_warm_streak_matches_the_reference():
    rng = np.random.RandomState(3)
    profiles = [None if x == 3 else "sig%d" % x
                for x in rng.choice([0, 0, 0, 0, 1, 3], 60)]
    for warm in (1, 2, 3, 10):
        for a, b in _observe_both(profiles, warm):
            assert a == b


def test_refused_freeze_rewarms_like_the_reference():
    for cls in (fastpath.ScheduleFreezer, ref.ScheduleFreezer):
        fz = cls(2)
        assert not fz.observe("s") and fz.observe("s")
        assert fz.freeze({"sig": "s", "slots": []}, 5, ok=False) is False
        assert fz.streak == 0 and fz.frozen() is None


def _thaws(snapshot_sum, reason):
    return snapshot_sum("fastpath_thaws_total", reason=reason)


def test_thaw_is_loud_and_idempotent_like_the_reference(caplog):
    flushed = []
    ours = fastpath.ScheduleFreezer(
        2, on_thaw=lambda payload, reason: flushed.append(("port", reason)))
    theirs = ref.ScheduleFreezer(
        2, on_thaw=lambda payload, reason: flushed.append(("ref", reason)))
    before = (_thaws(metrics.series_sum, "route"),
              _thaws(jax_metrics.series_sum, "route"))
    with caplog.at_level(logging.WARNING):
        for fz in (ours, theirs):
            assert fz.thaw("route") is False  # nothing frozen: quiet
            assert fz.freeze({"sig": "s", "slots": [1, 2]}, 7)
            assert fz.frozen_group_id() == 7
            assert fz.thaw("route", detail="test") is True
            assert fz.thaw("route") is False
            with pytest.raises(ValueError, match="unknown thaw reason"):
                fz.thaw("because")
    assert flushed == [("port", "route"), ("ref", "route")]
    assert _thaws(metrics.series_sum, "route") == before[0] + 1
    assert _thaws(jax_metrics.series_sum, "route") == before[1] + 1
    assert sum("THAWED" in r.getMessage() for r in caplog.records) == 2
    event = metrics.events("fastpath_thaw")[-1]
    assert (event["reason"], event["group"], event["detail"]) == \
        ("route", 7, "test")


def test_disabled_freezer_never_freezes_like_the_reference():
    for cls in (fastpath.ScheduleFreezer, ref.ScheduleFreezer):
        fz = cls(1, enabled=False)
        assert not fz.observe("s") and not fz.observe("s")
        assert fz.freeze({"sig": "s"}, 1) is False and fz.frozen() is None


def test_describe_has_the_reference_keys():
    fastpath.reset()
    ref.reset()
    ours = fastpath.ScheduleFreezer(2)
    fastpath.register(ours)
    ref.register(ref.ScheduleFreezer(2, plane_name="engine"))
    try:
        mine, theirs = fastpath.describe(), ref.describe()
        assert set(mine) == set(theirs)
        assert set(theirs["planes"]["engine"]) <= set(
            mine["planes"]["engine"])
        # thaw_all reaches the registered freezer; request() without an
        # on_request hook thaws at once.
        ours.freeze({"sig": "s", "slots": [1], "ends": [1]}, 3)
        assert fastpath.describe()["planes"]["engine"]["buckets"] == 1
        assert fastpath.thaw_all("staleness") == 1
        assert fastpath.thaw_all("staleness") == 0
    finally:
        fastpath.reset()
        ref.reset()


# -- the controller's verdicts -------------------------------------------------

def _controller(world=WORLD, warm=WARM, enabled=True):
    return Controller(0, world, ResponseCache(64), StallInspector(
        enabled=False), 64 << 20, lambda psid: list(range(world)),
        freezer=fastpath.ScheduleFreezer(warm, enabled))


def _cycle(ctl, **by_rank):
    """One cycle: rank r's message fields from ``by_rank["r<r>"]``."""
    for r in range(ctl.size):
        ctl.absorb(CycleRequest(r, **by_rank.get("r%d" % r, {})))
    return ctl.compute_response_list()


def _report_all(ctl, index, sig="S"):
    return _cycle(ctl, **{"r%d" % r: {"round_report": (index, sig)}
                          for r in range(ctl.size)})


def _frozen_controller():
    ctl = _controller()
    for i in range(WARM):
        resp = _report_all(ctl, i)
    assert resp.freeze == (WARM + 1, "S")
    return ctl


def test_freeze_after_warm_identical_rounds_from_the_round_after_next():
    ctl = _controller()
    for i in range(WARM - 1):
        assert _report_all(ctl, i).freeze is None
    # The laggard's report completes the round: the verdict waits for it.
    resp = _cycle(ctl, r0={"round_report": (WARM - 1, "S")},
                  r1={"round_report": (WARM - 1, "S")})
    assert resp.freeze is None
    resp = _cycle(ctl, r2={"round_report": (WARM - 1, "S")})
    assert resp.freeze == (WARM + 1, "S") and resp.thaw is None


@pytest.mark.parametrize("odd", ["other", None])
def test_a_rank_with_another_or_unfreezable_round_restarts_warming(odd):
    ctl = _controller()
    for i in range(WARM - 1):
        _report_all(ctl, i)
    resp = _cycle(ctl, r0={"round_report": (WARM - 1, "S")},
                  r1={"round_report": (WARM - 1, odd)},
                  r2={"round_report": (WARM - 1, "S")})
    assert resp.freeze is None and ctl._fp.streak == 0
    for i in range(WARM, 2 * WARM - 1):
        assert _report_all(ctl, i).freeze is None
    assert _report_all(ctl, 2 * WARM - 1).freeze == (2 * WARM + 1, "S")


def test_adasum_and_non_allreduce_rounds_are_not_freezable():
    ar = Request("a", ALLREDUCE, F32, (4,), red_op="Average")
    ada = Request("a", ALLREDUCE, F32, (4,), red_op="Adasum")
    bc = Request("b", BROADCAST, F32, (4,))
    assert fastpath.freezable([fastpath.slot_sig(ar)])
    assert not fastpath.freezable([fastpath.slot_sig(ar),
                                   fastpath.slot_sig(ada)])
    assert not fastpath.freezable([fastpath.slot_sig(bc)])
    assert not fastpath.freezable([])


def test_a_join_in_progress_refuses_the_freeze():
    ctl = _controller()
    for i in range(WARM - 1):
        _report_all(ctl, i)
    resp = _cycle(ctl, r0={"round_report": (WARM - 1, "S"), "joined": True},
                  r1={"round_report": (WARM - 1, "S")},
                  r2={"round_report": (WARM - 1, "S")})
    assert resp.freeze is None and ctl._fp.streak == 0


def test_disabled_fast_path_never_freezes():
    ctl = _controller(enabled=False)
    for i in range(3 * WARM):
        assert _report_all(ctl, i).freeze is None


TOKEN = (5, 0, "S", 123)


def test_go_when_every_rank_presents_the_bucket():
    ctl = _frozen_controller()
    resp = _cycle(ctl, **{"r%d" % r: {"staging": True,
                                      "buckets": [TOKEN, TOKEN[:1] + (1,)
                                                  + TOKEN[2:]]}
                          for r in range(WORLD)})
    assert (resp.go, resp.thaw) == (2, None)


def test_not_yet_is_never_a_thaw():
    ctl = _frozen_controller()
    for _ in range(3):
        resp = _cycle(ctl, r0={"staging": True, "buckets": [TOKEN]},
                      r1={"staging": True, "buckets": [TOKEN]},
                      r2={"staging": True})
        assert (resp.go, resp.thaw) == (0, None)
    resp = _cycle(ctl, **{"r%d" % r: {"staging": True, "buckets": [TOKEN]}
                          for r in range(WORLD)})
    assert resp.go == 1


def test_a_bucket_some_ranks_never_fill_is_a_stall():
    """Not yet is never a thaw, but a bucket one rank never fills is
    named by the stall inspector and, past its shutdown threshold,
    aborts the world, as a tensor one rank never submits does."""
    lines = []
    ctl = Controller(0, WORLD, ResponseCache(64), StallInspector(
        warning_secs=1.0, shutdown_secs=3.0, reporter=lines.append),
        64 << 20, lambda psid: list(range(WORLD)),
        freezer=fastpath.ScheduleFreezer(WARM))
    for i in range(WARM):
        _report_all(ctl, i)
    late = {"r0": {"staging": True, "buckets": [TOKEN]},
            "r1": {"staging": True, "buckets": [TOKEN]},
            "r2": {"staging": True}}
    resp = _cycle(ctl, **late)
    assert (resp.go, resp.thaw, resp.abort) == (0, None, None)
    t0 = ctl.stall._pending["fastpath.round5.bucket0"].first_seen
    assert ctl.stall.check(t0 + 1.5) is None
    assert "fastpath.round5.bucket0" in lines[0] and "[2]" in lines[0]
    assert "stall shutdown threshold" in ctl.stall.check(t0 + 3.5)
    # Once every rank presents it, it goes and is no longer watched.
    resp = _cycle(ctl, **{"r%d" % r: {"staging": True, "buckets": [TOKEN]}
                          for r in range(WORLD)})
    assert resp.go == 1 and ctl.stall.check(t0 + 10) is None


@pytest.mark.parametrize("source, reason", [
    ({"thaw": ("shape", "slot 3")}, "shape"),
    ({"joined": True}, "membership"),
    ({"shutdown": True}, "membership"),
    ({"requests": [Request("x", ALLREDUCE, F32, (2,), red_op="Sum")]},
     "membership"),
    ({"cache_bits": 1}, "membership"),
    ({"buckets": [TOKEN[:3] + (999,)]}, "shape"),
])
def test_every_thaw_source_thaws_the_world(source, reason):
    ctl = _frozen_controller()
    ctl.cache.put(Request("c", ALLREDUCE, F32, (2,), red_op="Sum"))
    msgs = {"r0": {"staging": True, "buckets": [TOKEN]},
            "r1": {"staging": True, "buckets": [TOKEN]},
            "r2": dict(source, staging="buckets" in source)}
    resp = _cycle(ctl, **msgs)
    assert resp.thaw is not None and resp.thaw[0] == reason
    assert resp.go == 0 and ctl._fp_world is None
    if "joined" in source:  # the join completes, then warming can
        resp = _cycle(ctl, r0={"joined": True}, r1={"joined": True})
        assert resp.responses[-1].op_type == "join"
    # Thawed: a later streak freezes again.
    for i in range(10, 10 + WARM):
        resp = _report_all(ctl, i)
    assert resp.freeze == (10 + WARM + 1, "S")


def test_negotiated_requests_before_any_rank_stages_are_the_last_rounds():
    """Between the verdict and the first staged round, the slowest rank
    may still send the requests of the round before: no thaw."""
    ctl = _frozen_controller()
    q = Request("x", ALLREDUCE, F32, (2,), red_op="Sum")
    resp = _cycle(ctl, r0={"requests": [q]}, r1={"requests": [q]})
    assert resp.thaw is None and resp.responses == []
    resp = _cycle(ctl, r2={"requests": [q]})
    assert resp.thaw is None and [r.names for r in resp.responses] == [["x"]]


def test_a_thaw_request_is_answered_even_when_not_frozen():
    ctl = _controller()
    resp = _cycle(ctl, r1={"thaw": ("membership", "join()")})
    assert resp.thaw == ("membership", "rank 1: join()")
    resp = _cycle(ctl, r0={"buckets": [TOKEN]})
    assert resp.thaw is not None and resp.thaw[0] == "shape"


def test_plan_cuts_at_keys_and_groups():
    def slot(dtype=F32, nbytes=400, group_size=0, member=0):
        q = Request("t", ALLREDUCE, dtype, (nbytes // dtype.itemsize,),
                    red_op="Average", group="g" if group_size else None,
                    group_size=group_size)
        return fastpath.slot_sig(q, member)
    slots = [slot(), slot(), slot(F16), slot(group_size=2),
             slot(group_size=2, member=1), slot(group_size=1), slot()]
    # One bucket by bytes; cut at the dtype change, at each group's
    # first member and where the groups end.
    assert fastpath.plan_buckets(slots, 1, 1 << 30) == [2, 3, 5, 6, 7]
    # By bytes alone: four buckets of about 700 bytes.
    even = [slot() for _ in range(8)]
    assert fastpath.plan_buckets(even, 4, 1 << 30) == \
        fastpath.bucket_ends([400] * 8, 4, 1 << 30) == [2, 4, 6, 8]


def test_fast_path_knobs(monkeypatch):
    cfg = Config.from_env()
    assert (cfg.fast_path, cfg.fast_path_warm_cycles,
            cfg.overlap_buckets) == (True, 10, 4)
    monkeypatch.setenv("HOROVOD_FAST_PATH", "0")
    monkeypatch.setenv("HOROVOD_FAST_PATH_WARM_CYCLES", "0")
    monkeypatch.setenv("HVD_TPU_OVERLAP_BUCKETS", "8")
    cfg = Config.from_env()
    assert (cfg.fast_path, cfg.fast_path_warm_cycles,
            cfg.overlap_buckets) == (False, 1, 8)


def test_a_cache_bit_meets_a_full_request_of_its_name():
    """A rank that changed a cached tensor's shape sends it in full while
    the others send its cache bit: one negotiation, an error for all."""
    ctl = _controller()
    q = Request("c", ALLREDUCE, F32, (4,), red_op="Sum")
    cid, _ = ctl.cache.put(q)
    resp = _cycle(ctl, r0={"cache_bits": 1 << cid},
                  r1={"requests": [Request("c", ALLREDUCE, F32, (8,),
                                           red_op="Sum")]},
                  r2={"cache_bits": 1 << cid})
    (r,) = resp.responses
    assert r.names == ["c"] and "Mismatched shape" in r.error
