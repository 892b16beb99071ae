"""The port's negotiation, held to the rules of the JAX package's
``horovod_tpu/core/src/controller.cc`` and ``response_cache.cc`` with
hand-built cycle messages, in one process (no world, no spawn):
readiness only once every member is in, shape and dtype disagreement,
fusion by threshold, groups ready only as a whole, the join policy
(``ApplyJoinPolicy``), the response cache's ids across ranks under
eviction, the stall inspector, the config, the metrics registry, the
timeline and the backend a world's device picks.
"""

import json

import pytest
import torch

from horovod_tpu_torch.common import metrics
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.controller import Controller
from horovod_tpu_torch.common.message import (ALLGATHER, ALLREDUCE, ALLTOALL,
                                              BROADCAST, JOIN, CycleRequest,
                                              Request)
from horovod_tpu_torch.common.response_cache import ResponseCache
from horovod_tpu_torch.ops.op_manager import OpManager
from horovod_tpu_torch.utils.stall_inspector import StallInspector
from horovod_tpu_torch.utils.timeline import Timeline

WORLD = 3
F32, BF16 = torch.float32, torch.bfloat16


def _controller(threshold=64 << 20, capacity=1024, world=WORLD, stall=None):
    return Controller(0, world, ResponseCache(capacity),
                      stall or StallInspector(enabled=False), threshold,
                      lambda psid: {0: list(range(world)),
                                    1: [0, 2]}.get(psid))


def _ar(name, shape=(4,), dtype=F32, op="Sum", **kw):
    return Request(name, ALLREDUCE, dtype, shape, red_op=op, **kw)


def _cycle(ctl, by_rank, joined=()):
    """One cycle in which rank r sends ``by_rank[r]`` (a list of
    requests); the names of each response, and the responses."""
    for r in range(ctl.size):
        ctl.absorb(CycleRequest(r, joined=r in joined,
                                requests=list(by_rank.get(r, []))))
    resp = ctl.compute_response_list()
    return [r.names for r in resp.responses], resp.responses


def test_ready_only_when_every_member_is_in():
    ctl = _controller()
    for r in range(WORLD - 1):
        names, _ = _cycle(ctl, {r: [_ar("a")]})
        assert names == []
    names, (resp,) = _cycle(ctl, {WORLD - 1: [_ar("a")]})
    assert names == [["a"]] and resp.error is None
    # A set of ranks 0 and 2 needs only those two; rank 1 sends nothing.
    names, _ = _cycle(ctl, {0: [_ar("s", process_set_id=1)]})
    assert names == []
    names, _ = _cycle(ctl, {2: [_ar("s", process_set_id=1)]})
    assert names == [["s"]]
    # An unknown set waits (the stall inspector names it), never errors.
    names, _ = _cycle(ctl, {r: [_ar("u", process_set_id=7)]
                            for r in range(WORLD)})
    assert names == []


@pytest.mark.parametrize("bad, match", [
    (_ar("x", shape=(5,)), "Mismatched shape"),
    (_ar("x", dtype=BF16), "Mismatched collective"),
    (_ar("x", op="Max"), "Mismatched collective"),
    (_ar("x", prescale=2.0), "Mismatched collective"),
    (Request("x", BROADCAST, F32, (4,), root_rank=1), "Mismatched collective"),
])
def test_disagreement_is_an_error_for_every_rank(bad, match):
    ctl = _controller()
    names, (resp,) = _cycle(ctl, {0: [_ar("x")], 1: [_ar("x")], 2: [bad]})
    assert names == [["x"]] and match in resp.error


def test_allgather_and_alltoall_carry_the_members_sizes():
    ctl = _controller()
    ag = {r: [Request("g", ALLGATHER, F32, (r + 1, 3))] for r in range(WORLD)}
    splits = [[0, 1, 2], [3, 0, 0], [1, 1, 1]]
    a2a = {r: [Request("t", ALLTOALL, F32, (sum(splits[r]), 2),
                       splits=splits[r])] for r in range(WORLD)}
    _, (g,) = _cycle(ctl, ag)
    _, (t,) = _cycle(ctl, a2a)
    assert g.aux == [1, 2, 3] and t.aux == sum(splits, [])
    # Trailing dims must agree.
    bad = dict(ag)
    bad[2] = [Request("g2", ALLGATHER, F32, (1, 4))]
    for r in (0, 1):
        bad[r] = [Request("g2", ALLGATHER, F32, (1, 3))]
    _, (g2,) = _cycle(ctl, bad)
    assert "trailing dims" in g2.error


def test_fusion_by_threshold_and_key():
    """Ready allreduces fuse in order within 100 bytes per (dtype, op,
    scales, set); a tensor above the threshold goes alone; Adasum
    allreduces of one key go out as one response past the threshold
    (they share no buffer); errors never fuse."""
    ctl = _controller(threshold=100)
    reqs = ([_ar("f%d" % i, shape=(10,)) for i in range(5)]        # 40 B
            + [_ar("big", shape=(30,))]                              # 120 B
            + [_ar("h%d" % i, shape=(10,), dtype=BF16) for i in range(3)]
            + [_ar("p", shape=(10,), prescale=0.5)]
            + [_ar("ad%d" % i, shape=(20,), op="Adasum")           # 80 B
               for i in range(2)])
    names, _ = _cycle(ctl, {r: reqs for r in range(WORLD)})
    # A bucket goes out when the next tensor would overflow it; the
    # buckets still open go last, in the order their keys first came.
    assert names == [["f0", "f1"], ["f2", "f3"], ["f4"], ["big"],
                     ["h0", "h1", "h2"], ["p"], ["ad0", "ad1"]]


def test_groups_are_ready_only_as_a_whole():
    ctl = _controller()
    g = [_ar("g.%d" % i, group="g", group_size=3) for i in range(3)]
    names, _ = _cycle(ctl, {r: g[:2] for r in range(WORLD)})
    assert names == []
    names, _ = _cycle(ctl, {0: [g[2]], 1: [g[2]]})
    assert names == []
    names, _ = _cycle(ctl, {2: [g[2]]})
    assert names == [["g.0", "g.1", "g.2"]]
    # The same group name again with fewer members and a new shape; a
    # group fuses with itself, never with other tensors or groups.
    g2 = [_ar("g.0", shape=(7,), group="g", group_size=2),
          _ar("g.1", shape=(2,), group="g", group_size=2)]
    h = [_ar("h.0", group="h", group_size=1)]
    names, _ = _cycle(ctl, {r: [_ar("solo")] + g2 + h for r in range(WORLD)})
    assert names == [["solo"], ["g.0", "g.1"], ["h.0"]]


@pytest.mark.parametrize("op, want", [
    ("Sum", ("Sum", 3.0, False, None)),
    ("Average", ("Sum", 1.5, True, None)),
    ("Min", (None, None, None, "Sum/Average")),
    ("Product", (None, None, None, "Sum/Average")),
    ("Adasum", (None, None, None, "Sum/Average")),
])
def test_join_policy(op, want):
    """Rank 2 joined without submitting: Sum takes its zeros; Average
    becomes a Sum over the 2 live contributors (postscale 3 / 2); every
    other op is an error naming Sum/Average."""
    ctl = _controller()
    names, resp = _cycle(ctl, {0: [_ar("j", op=op, postscale=3.0)],
                               1: [_ar("j", op=op, postscale=3.0)]},
                         joined=(2,))
    assert names == [["j"]]
    red_op, post, rewrite, err = want
    if err:
        assert err in resp[0].error
    else:
        assert (resp[0].red_op, resp[0].postscale,
                resp[0].join_rewrite) == (red_op, post, rewrite)


def test_join_refuses_other_ops_and_completes_with_the_last_rank():
    ctl = _controller()
    names, (g,) = _cycle(ctl, {0: [Request("g", ALLGATHER, F32, (1,))],
                               1: [Request("g", ALLGATHER, F32, (1,))]},
                         joined=(2,))
    assert "allreduce only" in g.error
    names, resp = _cycle(ctl, {}, joined=(0, 1, 2))
    assert names == [[]] and resp[0].op_type == JOIN
    assert resp[0].last_joined == 1  # 2 joined first, then 0 and 1
    # Submit-then-join: ranks 1 and 2 sent their data before joining, so
    # nothing is zero-filled and a Min goes through.
    ctl.absorb(CycleRequest(1, requests=[_ar("m", op="Min")]))
    ctl.absorb(CycleRequest(2, requests=[_ar("m", op="Min")]))
    names, (m,) = _cycle(ctl, {0: [_ar("m", op="Min")]}, joined=(1, 2))
    assert m.error is None and names == [["m"]]
    # Ranks 1 and 2 stay joined until every rank has: a Sum from rank 0
    # alone is ready (their zeros), and rank 0's join ends the round.
    names, (after,) = _cycle(ctl, {0: [_ar("after")]})
    assert names == [["after"]] and after.error is None
    # A tensor the last join makes ready executes before the join ends.
    ctl.absorb(CycleRequest(1, requests=[_ar("late")]))
    names, (late, j) = _cycle(ctl, {}, joined=(0,))
    assert names == [["late"], []] and late.error is None
    assert j.op_type == JOIN and j.last_joined == 0
    names, _ = _cycle(ctl, {0: [_ar("later")]})
    assert names == []


def test_cache_ids_agree_across_ranks_under_eviction():
    """Three ranks' caches of capacity 4 put the same responses in the
    same order (10 rotating names and a hot one, as ``tcp_worker.py``'s
    ``run_cache_evict``): the ids and the evictions agree, the hot name
    stays cached, and a changed shape misses."""
    caches = [ResponseCache(4) for _ in range(WORLD)]
    trace = [[] for _ in range(WORLD)]
    for round_ in range(6):
        for name in ["hot"] + ["rot.%d" % i for i in range(10)] + ["hot"]:
            for c, t in zip(caches, trace):
                cid, evicted = c.put(_ar(name))
                t.append((cid, evicted and evicted.name))
    assert trace[0] == trace[1] == trace[2]
    assert all(len(c) == 4 for c in caches)
    assert caches[0].lookup(_ar("hot")) is not None
    assert caches[0].lookup(_ar("hot", shape=(2, 2))) is None
    assert caches[0].lookup(Request("hot", ALLGATHER, F32, (4,))) is None


def test_cache_bits_negotiate_and_survive_eviction():
    """A cached tensor is negotiated from one bit per rank; bits absorbed
    for an id that a later put evicts become full requests."""
    ctl = _controller(capacity=2)
    cid, _ = ctl.cache.put(_ar("a"))
    for r in range(WORLD):
        ctl.absorb(CycleRequest(r, cache_bits=1 << cid))
    resp = ctl.compute_response_list()
    assert [r.names for r in resp.responses] == [["a"]]
    assert (ctl.cache.hits, ctl.cache.misses) == (1, 0)
    ctl.absorb(CycleRequest(0, cache_bits=1 << cid))  # rank 0 only
    ctl.cache.put(_ar("b"))
    new_id, evicted = ctl.cache.put(_ar("c"))
    assert (new_id, evicted.name) == (cid, "a")
    ctl.evicted(new_id, evicted)
    names, _ = _cycle(ctl, {1: [_ar("a")], 2: [_ar("a")]})
    assert names == [["a"]]


def test_stall_inspector_names_the_missing_ranks():
    lines = []
    stall = StallInspector(warning_secs=1.0, shutdown_secs=3.0,
                           reporter=lines.append)
    ctl = _controller(stall=stall)
    ctl.absorb(CycleRequest(0, requests=[_ar("w")]))
    ctl.absorb(CycleRequest(2, requests=[_ar("w")]))
    t0 = stall._pending["w"].first_seen
    assert stall.check(t0 + 0.5) is None and not lines
    assert stall.check(t0 + 1.5) is None
    assert "'w'" in lines[0] and "[1]" in lines[0]
    fatal = stall.check(t0 + 3.5)
    assert "stall shutdown threshold exceeded" in fatal and "[1]" in fatal
    ctl.absorb(CycleRequest(1, requests=[_ar("w")]))
    ctl.compute_response_list()
    assert stall.check(t0 + 10) is None


def test_config_reads_hvd_tpu_before_horovod(monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1024")
    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "2.5")
    monkeypatch.setenv("HVD_TPU_CYCLE_TIME", "1.5")
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    monkeypatch.delenv("HVD_TPU_FUSION_THRESHOLD", raising=False)
    cfg = Config.from_env()
    assert (cfg.fusion_threshold_bytes, cfg.cycle_time_ms,
            cfg.stall_check_disable, cfg.cache_capacity) == (1024, 1.5,
                                                             True, 1024)
    monkeypatch.setenv("HVD_TPU_FUSION_THRESHOLD", "lots")
    with pytest.raises(ValueError, match="FUSION_THRESHOLD"):
        Config.from_env()


def test_metrics_registry_holds_its_names_and_kinds():
    before = metrics.metrics_snapshot().get(
        "engine_tensors_fused_total", {}).get("value", 0.0)
    metrics.counter("engine_tensors_fused_total").inc(3)
    metrics.histogram("engine_cycle_seconds").observe(0.004)
    snap = metrics.metrics_snapshot()
    assert snap["engine_tensors_fused_total"]["value"] == before + 3
    assert snap["engine_cycle_seconds"]["count"] >= 1
    with pytest.raises(KeyError):
        metrics.counter("engine_cycle_total")
    with pytest.raises(ValueError, match="declared as a gauge"):
        metrics.counter("engine_last_group_id")


def test_timeline_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "t.json"
    tl = Timeline()
    tl.activity_start("x", "IGNORED")  # inactive: no file yet
    tl.initialize(str(path), mark_cycles=True)
    tl.negotiate_start("x", "allreduce")
    tl.mark_cycle(1)
    tl.negotiate_end("x")
    tl.activity_start_all(["x", "y"], "EXEC_FUSED_ALLREDUCE",
                          args={"group": 4})
    tl.activity_end_all(["x", "y"])
    tl.shutdown()
    tl.shutdown()
    records = json.loads(path.read_text())
    assert [r.get("name") for r in records] == [
        "NEGOTIATE_ALLREDUCE", "CYCLE_START", None,
        "EXEC_FUSED_ALLREDUCE", "EXEC_FUSED_ALLREDUCE", None, None]
    assert records[3]["args"] == {"group": 4} and records[4]["tid"] == "y"


@pytest.mark.parametrize("world, tensor, want", [
    ("cpu", "cpu", "gloo"), ("cpu", "meta", ValueError),
    ("cuda", "cpu", ValueError), ("meta", None, ValueError)])
def test_backend_follows_the_world_device(world, tensor, want):
    """NCCL for a world on CUDA, gloo for one on the CPU; a tensor on
    another device type than the world's, or a world on another device,
    raises."""
    if tensor is None:
        with pytest.raises(ValueError, match="no backend runs"):
            OpManager(torch.device(world))
        return
    ops = OpManager(torch.device(world))
    assert ops.backend.name == {"cpu": "gloo", "cuda": "nccl"}[world]
    x = [torch.zeros(1, device=tensor)]
    if want is ValueError:
        with pytest.raises(ValueError, match="no backend takes"):
            ops.backend_for(x)
    else:
        assert ops.backend_for(x).name == want
