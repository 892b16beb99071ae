"""The port's fast path in a 3-process gloo world on the CPU, under
``HOROVOD_FAST_PATH_WARM_CYCLES=3``, against the negotiated path
(``HOROVOD_FAST_PATH=0``, a second world in the same processes) and the
JAX package's ``DistributedOptimizer`` on the same stacked gradients.

One spawn for the whole file: each rank runs every scenario and writes
its results.  Covered: ``DistributedOptimizer`` steps, per parameter
and with ``num_groups=2``, freeze after three identical rounds and then
run no negotiated cycle; their parameters match the JAX optimizer's;
rounds of named allreduces freeze, thaw world-wide when every rank
changes a shape or shrinks its round (reason ``shape``), and stay
right; a shape change on one rank alone fails that tensor's handle
with ``HorovodInternalError`` on every rank, without a hang; ``join()``
thaws (reason ``membership``); the negotiated world's results.
Tolerances: f32 1e-6 relative (sums in another order: a frozen bucket
is another buffer than a negotiated fusion), Adam's parameters 1e-6,
as ``test_torch_port_engine.py`` holds them.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    # The reference side; the spawned ranks need only torch.
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.jax.optimizer import DistributedOptimizer as JaxDistOpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 3
WARM = 3
STEPS = 10
ROUNDS = 13
RTOL = 1e-6
SPAWN_TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt_inputs():
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32),
              "v": rng.randn(5).astype(np.float32)}
    grads = {k: rng.randn(WORLD, *v.shape).astype(np.float32)
             for k, v in params.items()}
    return params, grads


def _round_inputs():
    """Six stacked tensors a round, for each round."""
    rng = np.random.RandomState(2)
    shapes = [(16,), (4, 8), (3,), (32,), (5, 5), (7,)]
    return [[rng.randn(WORLD, *s).astype(np.float32) for s in shapes]
            for _ in range(ROUNDS)]


# -- worker side ---------------------------------------------------------------

def _counts():
    from horovod_tpu_torch.common import metrics
    return {"cycles": metrics.series_sum("engine_cycles_total"),
            "frozen": metrics.series_sum("fastpath_frozen_cycles_total"),
            "shape": metrics.series_sum("fastpath_thaws_total",
                                        reason="shape"),
            "membership": metrics.series_sum("fastpath_thaws_total",
                                             reason="membership")}


def _optimizer_steps(hvd, rank, groups):
    """STEPS steps of Adam on constant gradients; per step the counts
    after it and the reduced gradients."""
    params, grads = _opt_inputs()
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = hvd.DistributedOptimizer(torch.optim.Adam(ps.values(), lr=1e-2),
                                   named_parameters=ps.items(),
                                   num_groups=groups)
    counts, reduced = [], []
    for _ in range(STEPS):
        opt.zero_grad()
        sum((p * torch.from_numpy(grads[k][rank])).sum()
            for k, p in ps.items()).backward()
        opt.synchronize()
        reduced.append(np.concatenate([ps[k].grad.numpy().ravel()
                                       for k in sorted(ps)]))
        with opt.skip_synchronize():
            opt.step()
        counts.append(_counts())
    return ({k: p.detach().numpy() for k, p in ps.items()}, counts,
            np.stack(reduced))


def _tensors(i, rank):
    """Round ``i``'s six tensors on ``rank``: every third in float64, so
    a round has two fusion keys."""
    return [torch.from_numpy(x[rank]).to(torch.float64 if k % 3 == 2
                                         else torch.float32)
            for k, x in enumerate(_round_inputs()[i])]


def _rounds(hvd, rank, res, tag, rounds, change=None):
    """Rounds of six named allreduces (Sum), each enqueued then waited
    for at once (``change(i, tensors)`` may alter a round's); per round
    the results and the counts."""
    from horovod_tpu_torch.ops.engine import wait_all
    for i in range(rounds):
        tensors = _tensors(i, rank)
        if change is not None:
            tensors = change(i, tensors)
        hs = [hvd.allreduce_async(t, name="%s.%d" % (tag, k), op=hvd.Sum)
              for k, t in enumerate(tensors)]
        outs = wait_all(hs)
        res["%s.%d" % (tag, i)] = np.concatenate(
            [o.double().numpy().ravel() for o in outs])
        res["%s.%d.counts" % (tag, i)] = np.array(
            [_counts()[k] for k in ("cycles", "frozen", "shape",
                                    "membership")])


def _worker(rank: int, port: int, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      HOROVOD_FAST_PATH_WARM_CYCLES=str(WARM))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fastpath
    hvd.init(device="cpu")
    res = {}
    for groups in (0, 2):
        final, counts, reduced = _optimizer_steps(hvd, rank, groups)
        for k, v in final.items():
            res["opt%d.%s" % (groups, k)] = v
        res["opt%d.reduced" % groups] = reduced
        res["opt%d.counts" % groups] = np.array(
            [[c[k] for k in ("cycles", "frozen", "shape", "membership")]
             for c in counts])
    res["describe.frozen"] = np.array(
        fastpath.describe()["planes"]["engine"]["frozen"])

    # Named rounds: round 0 thaws the optimizer's schedule, 1-3 warm, 4
    # adopts the verdict, 5 is frozen; 6 changes a shape on every rank
    # (a thaw), 7-9 warm again, 10 adopts, 11 is frozen; 12 enqueues
    # one tensor of six, and its wait touches an unfilled bucket (a
    # thaw).
    def change(i, tensors):
        if i == 6:
            tensors[1] = tensors[1].reshape(8, 4)
        return tensors[:1] if i == ROUNDS - 1 else tensors
    _rounds(hvd, rank, res, "every", ROUNDS, change)

    # Refreeze, then rank 1 alone changes the shape of tensor 3.
    _rounds(hvd, rank, res, "refreeze", WARM + 2)
    from horovod_tpu_torch.ops.engine import HorovodInternalError
    tensors = _tensors(0, rank)
    if rank == 1:
        tensors[3] = tensors[3][:8]
    hs = [hvd.allreduce_async(t, name="refreeze.%d" % k, op=hvd.Sum)
          for k, t in enumerate(tensors)]
    errors = []
    for h in hs:
        try:
            h.wait()
            errors.append("")
        except HorovodInternalError as e:
            errors.append(str(e))
    res["diverge.errors"] = np.array(errors)
    res["diverge.counts"] = np.array([_counts()[k] for k in (
        "cycles", "frozen", "shape", "membership")])

    # Refreeze once more; join() thaws with reason membership.
    _rounds(hvd, rank, res, "join", WARM + 2)
    res["join.frozen"] = np.array(
        fastpath.describe()["planes"]["engine"]["frozen"])
    res["join.last"] = np.array(hvd.join())
    res["join.counts"] = np.array([_counts()[k] for k in (
        "cycles", "frozen", "shape", "membership")])
    hvd.shutdown()

    # The negotiated path: the same steps with the fast path off.
    os.environ["HOROVOD_FAST_PATH"] = "0"
    hvd.init(device="cpu")
    final, counts, reduced = _optimizer_steps(hvd, rank, 0)
    res["off.reduced"] = reduced
    res["off.frozen"] = np.array([c["frozen"] for c in counts])
    for k, v in final.items():
        res["off.%s" % k] = v
    hvd.shutdown()
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)


# -- test side -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_port_fastpath")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    for k in list(env):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            del env[k]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs = []
    try:
        deadline = time.monotonic() + SPAWN_TIMEOUT
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1, deadline - time.monotonic()))[0].decode(
                    errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(out / ("rank%d.npz" % r))) for r in range(WORLD)], \
        logs


def _jax_optimizer_steps(n):
    params, grads = _opt_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))
    opt = JaxDistOpt(optax.adam(1e-2), axis_name="hvd")

    def local(p, state, g):
        upd, state = opt.update({k: v[0] for k, v in g.items()}, state, p)
        return optax.apply_updates(p, upd), state

    p = jax.tree.map(jnp.asarray, params)
    state = opt.init(p)
    fn = jax.jit(jax.shard_map(local, mesh=mesh,
                               in_specs=(P(), P(), P("hvd")),
                               out_specs=(P(), P()), check_vma=False))
    for _ in range(n):
        p, state = fn(p, state, grads)
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("groups", [0, 2])
def test_optimizer_steps_freeze_and_stop_negotiating(world, groups):
    """The report of round WARM-1 completes the streak during round WARM,
    so rounds from WARM+1 on are frozen: one frozen round a step and no
    negotiated cycle.  The grouped optimizer's first step thaws the
    per-parameter schedule (its slots differ) and cannot freeze, so its
    rounds 1-3 warm and 5 is the first frozen."""
    ranks, _ = world
    first = WARM + 1 if groups == 0 else WARM + 2
    for res in ranks:
        c = res["opt%d.counts" % groups]
        cycles, frozen = c[:, 0], c[:, 1]
        assert np.all(np.diff(frozen[first - 1:]) == 1), frozen
        assert np.all(np.diff(cycles[first - 1:]) == 0), cycles
        assert np.all(frozen[:first] == frozen[0]), frozen
        if groups:
            assert c[0, 2] == res["opt0.counts"][-1, 2] + 1
    assert all(bool(res["describe.frozen"]) for res in ranks)


@pytest.mark.parametrize("groups", [0, 2])
def test_optimizer_matches_jax_and_the_negotiated_path(world, groups):
    ranks, _ = world
    params, grads = _opt_inputs()
    want = _jax_optimizer_steps(STEPS)
    mean = np.concatenate([grads[k].mean(0).ravel() for k in sorted(grads)])
    for res in ranks:
        for key in ("w", "b", "v"):
            np.testing.assert_allclose(res["opt%d.%s" % (groups, key)],
                                       want[key], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(res["off.%s" % key], want[key],
                                       rtol=1e-6, atol=1e-6)
        for step in range(STEPS):
            np.testing.assert_allclose(res["opt%d.reduced" % groups][step],
                                       mean, rtol=RTOL, atol=1e-7)
            np.testing.assert_allclose(res["opt%d.reduced" % groups][step],
                                       res["off.reduced"][step], rtol=RTOL,
                                       atol=1e-7)


def test_fast_path_off_never_freezes(world):
    ranks, _ = world
    for res in ranks:
        assert np.all(res["off.frozen"] == res["off.frozen"][0])


def _want_round(i, take=6):
    return np.concatenate([x.astype(np.float64 if k % 3 == 2
                                    else np.float32).sum(0).ravel()
                           for k, x in enumerate(_round_inputs()[i][:take])])


def _counts_at(res, tag, i):
    return dict(zip(("cycles", "frozen", "shape", "membership"),
                    res["%s.%d.counts" % (tag, i)]))


def test_every_rank_changing_its_round_thaws_and_stays_right(world):
    """Rounds 5 and 11 frozen; 0 (another schedule), 6 (a shape) and 12
    (a wait on an unfilled bucket) thaw with reason shape; every round's
    sums right."""
    ranks, _ = world
    for res in ranks:
        for i in range(ROUNDS):
            np.testing.assert_allclose(
                res["every.%d" % i], _want_round(i, 1 if i == ROUNDS - 1
                                                 else 6),
                rtol=RTOL, atol=1e-6)
        c = [_counts_at(res, "every", i) for i in range(ROUNDS)]
        frozen = [x["frozen"] for x in c]
        shape = [x["shape"] for x in c]
        assert np.diff(frozen).tolist() == [0, 0, 0, 0, 1, 0, 0, 0, 0, 0,
                                            1, 0], frozen
        assert np.diff(shape).tolist() == [0, 0, 0, 0, 0, 1, 0, 0, 0, 0,
                                           0, 1], shape
        assert shape[0] == res["opt2.counts"][-1, 2] + 1


def test_one_rank_diverging_fails_every_rank_loudly(world):
    """After a refreeze, rank 1 alone changes tensor 3's shape: its own
    staging asks for the thaw, the negotiation finds the mismatch, and
    every rank's handle of tensor 3 fails; the rest are right."""
    ranks, logs = world
    for res in ranks:
        c = [_counts_at(res, "refreeze", i) for i in range(WARM + 2)]
        assert c[-1]["frozen"] == c[WARM]["frozen"] + 1
        errors = list(res["diverge.errors"])
        assert "Mismatched shape" in errors[3], errors
        assert [e for k, e in enumerate(errors) if k != 3] == [""] * 5
        assert res["diverge.counts"][2] == c[-1]["shape"] + 1
    assert any("fast path THAWED" in log and "reason=shape" in log
               for log in logs)


def test_join_thaws_for_membership(world):
    ranks, _ = world
    lasts = {int(res["join.last"]) for res in ranks}
    assert len(lasts) == 1
    for res in ranks:
        assert bool(res["join.frozen"])
        before = _counts_at(res, "join", WARM + 1)
        assert res["join.counts"][3] == before["membership"] + 1
        for i in range(WARM + 2):
            np.testing.assert_allclose(res["join.%d" % i], _want_round(i),
                                       rtol=RTOL, atol=1e-6)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
