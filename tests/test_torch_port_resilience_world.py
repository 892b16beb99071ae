"""The port's self-healing data plane in gloo worlds of spawned processes
on the CPU.

* **A 2 x 2 world** (4 ranks, ``LOCAL_WORLD_SIZE=2``, int8 on the cross
  leg, so that every allreduce of 128 KiB takes the hierarchical legs),
  every fault armed on every rank through ``HVD_TPU_FAULT`` at the same
  point of each rank's program, each case against the same calls
  unarmed or against the flat path, bit for bit:
  - one dropped leg attempt (``mh.leg.drop:drop@times=1``), and one
    transport fault raised after the encode (a patched ``_exchange``),
    over two error-feedback steps: outputs and residuals equal the
    unarmed run's;
  - an unbounded drop: the flat result (exact on integer-valued inputs),
    counted flat;
  - ``HOROVOD_LEG_DEMOTE_THRESHOLD`` (2) exhaustions, then
    ``hvd.check_degraded_routes()``: every rank gets rank 0's demote
    verdict, and the next call goes flat with no leg attempt; with
    ``HOROVOD_LEG_REPROBE_SECS`` small, the next check promotes it and
    the call after takes the legs again;
  - ``mh.leg.corrupt`` once: absorbed (outputs and residuals as
    unarmed); twice: the call fails with ``WireIntegrityError`` on every
    rank.
* **A 2-rank world** under ``HOROVOD_COLLECTIVE_TIMEOUT_SECS=1`` and
  ``mh.deadline.wedge:drop@rank=1`` (rank 1 withholds its allreduce; its
  ``@rank`` reads the launcher's ``RANK``): both ranks' handles raise
  ``CollectiveDeadlineExceeded`` within 10 s, the next enqueue raises,
  ``shutdown()`` returns and the processes exit.
* **A one-rank world**: a frozen fast-path round whose dispatch the
  ``engine.fastpath.stale_dispatch`` site drops thaws (reason staleness)
  and its values stay right; ``engine.cycle.pre``,
  ``mh.enqueue.pre_register`` and ``hvd.shutdown.pre_barrier`` /
  ``post_barrier`` fire.

The three worlds are spawned at once; every wait is bounded.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 90
N = 32768  # 128 KiB of f32: past the 64 KiB hierarchical threshold
CLASS = "131072"  # its power-of-two size class
DEADLINE_BOUND_S = 10.0


def _input(rank, step=0):
    """Integer-valued f32, different on every position, rank and step:
    the flat sum is exact."""
    i = np.arange(N)
    return ((((i * 7 + rank * 13 + step * 5) % 61) - 30)
            * (rank + 1)).astype(np.float32)


# -- worker side ---------------------------------------------------------------

def _env(rank, size, port, **extra):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      **{k: str(v) for k, v in extra.items()})


def _arm(spec=None):
    if spec is None:
        os.environ.pop("HVD_TPU_FAULT", None)
    else:
        os.environ["HVD_TPU_FAULT"] = spec


def _world_2x2(rank, port, out):
    _env(rank, 4, port, LOCAL_RANK=rank % 2, LOCAL_WORLD_SIZE=2,
         HOROVOD_CROSS_HOST_COMPRESSION="int8", HOROVOD_FAST_PATH=0,
         HOROVOD_LEG_RETRY_BACKOFF=0, HOROVOD_LEG_DEMOTE_THRESHOLD=2,
         HOROVOD_LEG_REPROBE_SECS=1000)
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import metrics
    from horovod_tpu_torch.common.process_sets import global_process_set

    hvd.init(device="cpu")
    h = global_process_set.hierarchy
    res = {}

    def counts():
        s = metrics.series_sum
        return np.array([
            s("mh_collective_path_total", op="allreduce", path="hier"),
            s("mh_collective_path_total", op="allreduce", path="flat"),
            s("fault_injections_total"), s("mh_leg_retries_total")])

    def residuals():
        return np.concatenate([v.reshape(-1).numpy()
                               for lru in (h._res2, h.ef._residuals)
                               for v in lru.values()])

    def steps(tag, n=2):
        """``n`` error-feedback steps of one named allreduce, from no
        residual."""
        h.ef.reset()
        h._res2.clear()
        before = counts()
        res[tag + ".out"] = np.stack([hvd.allreduce(
            torch.from_numpy(_input(rank, k)), op=hvd.Sum,
            name="ef").numpy() for k in range(n)])
        res[tag + ".res"] = residuals()
        res[tag + ".counts"] = counts() - before

    def call(tag, name):
        before = counts()
        res[tag + ".out"] = hvd.allreduce(torch.from_numpy(_input(rank)),
                                          op=hvd.Sum, name=name).numpy()
        res[tag + ".counts"] = counts() - before

    steps("clean")
    _arm("mh.leg.drop:drop@times=1")
    steps("drop1")
    _arm()
    exchange, calls = h._exchange, []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 1:
            raise ConnectionResetError("injected reset after the encode")
        return exchange(*args)

    h._exchange = flaky
    steps("reset1")
    del h._exchange
    _arm("mh.leg.corrupt:drop@times=1")
    steps("corrupt1")
    # An unbounded drop: each call spends its budget and runs flat; two
    # make the demotion threshold.
    _arm("mh.leg.drop:drop")
    call("degraded1", "d1")
    call("degraded2", "d2")
    res["demote.verdict"] = np.array(json.dumps(hvd.check_degraded_routes()))
    call("demoted", "d3")  # still armed: no leg attempt may fire it
    _arm()
    os.environ["HOROVOD_LEG_REPROBE_SECS"] = "0.3"
    time.sleep(0.5)
    res["promote.verdict"] = np.array(json.dumps(hvd.check_degraded_routes()))
    call("promoted", "d4")
    # Last: an escalated corruption counts as an exhaustion too.
    _arm("mh.leg.corrupt:drop@times=2")
    try:
        hvd.allreduce(torch.from_numpy(_input(rank)), op=hvd.Sum, name="c2")
        res["corrupt2.error"] = np.array("")
    except hvd.HorovodInternalError as exc:
        res["corrupt2.error"] = np.array(str(exc))
    _arm()
    hvd.shutdown()
    np.savez(os.path.join(out, "2x2.rank%d.npz" % rank), **res)


def _world_deadline(rank, port, out):
    _env(rank, 2, port, LOCAL_RANK=0, LOCAL_WORLD_SIZE=1,
         HOROVOD_COLLECTIVE_TIMEOUT_SECS=1,
         HVD_TPU_FAULT="mh.deadline.wedge:drop@rank=1")
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import metrics

    hvd.init(device="cpu")
    res = {}
    for tag in ("first", "next"):
        t0 = time.monotonic()
        try:
            hvd.allreduce(torch.ones(8), name=tag)
            res[tag] = "returned"
        except Exception as exc:  # noqa: BLE001 - reported to the test
            res[tag], res[tag + ".msg"] = type(exc).__name__, str(exc)
            res[tag + ".base"] = isinstance(exc, hvd.HorovodInternalError)
        res[tag + ".s"] = time.monotonic() - t0
    t0 = time.monotonic()
    hvd.shutdown()
    res["shutdown.s"] = time.monotonic() - t0
    res["expired"] = metrics.series_sum("collective_deadline_expired_total")
    res["failures"] = metrics.series_sum("mh_collective_failures_total",
                                         reason="deadline")
    with open(os.path.join(out, "deadline.rank%d.json" % rank), "w") as f:
        json.dump(res, f)


def _world_one(rank, port, out):
    _env(0, 1, port, HOROVOD_FAST_PATH_WARM_CYCLES=2,
         HVD_TPU_FAULT="engine.cycle.pre:delay:0@times=1,"
                       "mh.enqueue.pre_register:delay:0@times=1,"
                       "hvd.shutdown.pre_barrier:delay:0,"
                       "hvd.shutdown.post_barrier:delay:0")
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import metrics
    from horovod_tpu_torch.ops import fastpath

    hvd.init(device="cpu")
    xs = [torch.arange(6, dtype=torch.float32) * (j + 1) for j in range(2)]

    def round_():
        hs = [hvd.allreduce_async(x, op=hvd.Sum, name="g%d" % j)
              for j, x in enumerate(xs)]
        return [hvd.synchronize(hd) for hd in hs]

    ok = True
    for _ in range(6):
        ok &= all(torch.equal(o, x) for o, x in zip(round_(), xs))
    frozen = fastpath.describe()["planes"]["engine"]["frozen"]
    os.environ["HVD_TPU_FAULT"] += ",engine.fastpath.stale_dispatch:drop@times=1"
    ok &= all(torch.equal(o, x) for o, x in zip(round_(), xs))
    for _ in range(2):
        ok &= all(torch.equal(o, x) for o, x in zip(round_(), xs))
    hvd.shutdown()
    fires = {s: metrics.series_sum("fault_injections_total", site=s)
             for s in ("engine.cycle.pre", "mh.enqueue.pre_register",
                       "engine.fastpath.stale_dispatch",
                       "hvd.shutdown.pre_barrier",
                       "hvd.shutdown.post_barrier")}
    with open(os.path.join(out, "one.json"), "w") as f:
        json.dump({"ok": bool(ok), "frozen": frozen, "fires": fires,
                   "staleness": metrics.series_sum("fastpath_thaws_total",
                                                   reason="staleness")}, f)


WORLDS = {"2x2": (_world_2x2, 4), "deadline": (_world_deadline, 2),
          "one": (_world_one, 1)}


# -- test side -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Spawn the three worlds at once -> ({world: [return codes]}, {world:
    seconds to exit}, their logs, the output directory)."""
    out = tmp_path_factory.mktemp("torch_port_resilience_world")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    for k in list(env):
        if k.startswith(("HOROVOD_", "HVD_TPU_")) or k in (
                "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
            del env[k]
    t0 = time.monotonic()
    procs = {}
    for name, (_, size) in WORLDS.items():
        port = _free_port()
        procs[name] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), name, str(r),
             str(port), str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(size)]
    rcs, secs, logs = {}, {}, {}
    try:
        deadline = t0 + SPAWN_TIMEOUT
        for name, ps in procs.items():
            logs[name] = [p.communicate(
                timeout=max(1, deadline - time.monotonic()))[0].decode(
                    errors="replace") for p in ps]
            rcs[name] = [p.returncode for p in ps]
            secs[name] = time.monotonic() - t0
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return rcs, secs, logs, out


def _ok(worlds, name):
    rcs, _, logs, out = worlds
    for rc, log in zip(rcs[name], logs[name]):
        assert rc == 0, log[-4000:]
    return out


@pytest.fixture(scope="module")
def grid(worlds):
    out = _ok(worlds, "2x2")
    return [dict(np.load(out / ("2x2.rank%d.npz" % r))) for r in range(4)]


def _bits_equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("case", ["drop1", "reset1", "corrupt1"])
def test_absorbed_faults_leave_outputs_and_residuals_as_unarmed(grid, case):
    """Every rank: the two steps' outputs and the error-feedback residuals
    after them equal the unarmed run's, bit for bit; the fault cost one
    retry, and every call took the legs."""
    for res in grid:
        _bits_equal(res[case + ".out"], res["clean.out"])
        _bits_equal(res[case + ".res"], res["clean.res"])
        hier, flat, _, retries = res[case + ".counts"]
        assert (hier, flat, retries) == (2, 0, 1)
        assert res["clean.counts"][3] == 0
    # int8 moved the values: the comparison is not of exact sums
    want = sum(_input(r, 1) for r in range(4))
    assert not np.array_equal(grid[0]["clean.out"][1], want)


def test_unbounded_drop_gives_the_flat_result(grid):
    want = sum(_input(r) for r in range(4))
    for res in grid:
        for tag in ("degraded1", "degraded2"):
            _bits_equal(res[tag + ".out"], want)
            hier, flat, fires, retries = res[tag + ".counts"]
            # 1 attempt + 2 retries, all dropped, then the flat call
            assert (hier, flat, fires, retries) == (0, 1, 3, 2)


def test_demotion_reaches_every_rank_and_re_probe_promotes(grid):
    verdicts = [json.loads(str(res["demote.verdict"])) for res in grid]
    assert verdicts == [{"action": "demote", "op": "allreduce",
                         "size_class": CLASS, "streak": 2,
                         "apply_at": 1}] * 4
    want = sum(_input(r) for r in range(4))
    for res in grid:
        # demoted: flat, exact, and no leg attempt fired the armed drop
        _bits_equal(res["demoted.out"], want)
        np.testing.assert_array_equal(res["demoted.counts"], [0, 1, 0, 0])
        promo = json.loads(str(res["promote.verdict"]))
        assert promo == {"action": "promote", "op": "allreduce",
                         "size_class": CLASS, "apply_at": 2}
        np.testing.assert_array_equal(res["promoted.counts"], [1, 0, 0, 0])
        _bits_equal(res["promoted.out"], grid[0]["promoted.out"])


def test_persistent_corruption_fails_every_rank(grid):
    for res in grid:
        err = str(res["corrupt2.error"])
        assert "WireIntegrityError" in err and "checksum mismatch" in err


@pytest.fixture(scope="module")
def deadline(worlds):
    out = _ok(worlds, "deadline")
    return [json.load(open(out / ("deadline.rank%d.json" % r)))
            for r in range(2)]


def test_deadline_fails_every_rank_loudly(deadline):
    for res in deadline:
        assert res["first"] == "CollectiveDeadlineExceeded", res
        assert res["first.base"]  # a HorovodInternalError
        assert "collective deadline exceeded" in res["first.msg"]
        assert "stall shutdown threshold" not in res["first.msg"]
        assert res["first.s"] < DEADLINE_BOUND_S
        assert res["expired"] == 1 and res["failures"] >= 1


def test_poisoned_engine_rejects_work_and_shuts_down(worlds, deadline):
    for res in deadline:
        assert res["next"] == "CollectiveDeadlineExceeded"
        assert res["next.s"] < 1.0
        assert res["shutdown.s"] < DEADLINE_BOUND_S
    rcs, secs, _, _ = worlds
    assert rcs["deadline"] == [0, 0] and secs["deadline"] < SPAWN_TIMEOUT


def test_one_rank_sites(worlds):
    out = _ok(worlds, "one")
    res = json.load(open(out / "one.json"))
    assert res["ok"] and res["frozen"]
    assert res["staleness"] == 1
    # @times=1 fires once per arming: adding the stale-dispatch spec
    # re-armed the value, which restarts every site's count.
    assert res["fires"] == {"engine.cycle.pre": 2,
                            "mh.enqueue.pre_register": 2,
                            "engine.fastpath.stale_dispatch": 1,
                            "hvd.shutdown.pre_barrier": 1,
                            "hvd.shutdown.post_barrier": 1}


if __name__ == "__main__":
    WORLDS[sys.argv[1]][0](int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
