"""The port's negotiating engine in a 3-process gloo world on the CPU,
against ``horovod_tpu.ops.xla_ops.MeshCollectives``, the JAX package's
in-process engine (``CollectiveEngine.mark_joined``) and its
``DistributedOptimizer`` on the same stacked inputs.

One spawn for the whole file: each rank runs every scenario and writes
its results.  Covered: 40 named allreduces (f32, bf16, f16, i32; every
op, pre- and post-scaled) enqueued in a different order on each rank,
with one execution order on every rank; the uneven-data join of
``tests/utils/tcp_worker.py``'s ``run_join``; a shape mismatch; grouped
name reuse with changed membership (``run_regroup``);
``DistributedOptimizer`` per parameter and with ``num_groups=2``; the
timeline; ``shutdown()`` then ``init()``; and a stall past
``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` that fails every rank's handle.
Tolerances: f32 1e-6 relative (sums in another order), i32 exact, bf16
and f16 two ulps of the dtype (the JAX Average divides in the dtype, the
port in f32, and the order of a sum's roundings may differ).
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    # The reference side.  The spawned ranks run this file as a script
    # and need only torch, so they skip importing JAX.
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.common.config import Config as JaxConfig
    from horovod_tpu.jax.optimizer import DistributedOptimizer as JaxDistOpt
    from horovod_tpu.ops.engine import CollectiveEngine
    from horovod_tpu.ops.engine import HorovodInternalError as JaxError
    from horovod_tpu.ops.xla_ops import MeshCollectives
    from horovod_tpu.utils.timeline import Timeline as JaxTimeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 3
DTYPES = ("float32", "bfloat16", "float16", "int32")
OPS = ("Sum", "Average", "Min", "Max", "Product")
N_NAMED = 40
RTOL = {"float32": 1e-6, "bfloat16": 2 ** -6, "float16": 2 ** -9,
        "int32": 0}
STALL_WARN, STALL_SHUTDOWN = 1, 3
SPAWN_TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _named():
    """The 40 named tensors: (name, dtype, op, pre, post, stacked f32 or
    i32 values [WORLD, ...]).  Floats sit near 1, so Product neither
    overflows nor vanishes; integers take integer scales."""
    rng = np.random.RandomState(0)
    out = []
    for i in range(N_NAMED):
        dtype, op = DTYPES[i % 4], OPS[i % 5]
        shape = (WORLD, 4, 3)
        if dtype == "int32":
            x, pre, post = rng.randint(-5, 6, shape).astype(np.int32), 2, 3
        else:
            x, pre, post = rng.uniform(0.5, 1.5, shape).astype(np.float32), \
                0.5, 3.0
        out.append(("t%02d" % i, dtype, op, pre, post, x))
    return out


def _opt_inputs():
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32),
              "v": rng.randn(5).astype(np.float32)}
    grads = {k: rng.randn(WORLD, *v.shape).astype(np.float32)
             for k, v in params.items()}
    return params, grads


# -- worker side (runs in the spawned processes) -------------------------------

def _err(fn):
    """The HorovodInternalError message of ``fn()``, or "" if it passed."""
    from horovod_tpu_torch import HorovodInternalError
    try:
        fn()
    except HorovodInternalError as e:
        return str(e)
    return ""


def _worker(rank: int, port: int, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      HOROVOD_TIMELINE=os.path.join(out, "timeline.json"))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import engine as eng_mod

    executed = []
    execute = eng_mod.Engine._execute

    def record(self, r, tensors, ps):
        executed.append(r.names)
        return execute(self, r, tensors, ps)

    eng_mod.Engine._execute = record
    hvd.init(device="cpu")
    res = {}

    # 40 named tensors, in a different order on each rank, some cycles
    # apart.
    named = _named()
    handles = {}
    for k, i in enumerate(np.random.RandomState(10 + rank).permutation(
            N_NAMED)):
        name, dtype, op, pre, post, x = named[i]
        t = torch.from_numpy(x[rank]).to(getattr(torch, dtype))
        handles[name] = hvd.allreduce_async(t, name=name, op=op,
                                            prescale_factor=pre,
                                            postscale_factor=post)
        if k % (rank + 3) == 0:
            time.sleep(0.002)
    for name, h in handles.items():
        got = hvd.synchronize(h)
        res["named." + name] = (got.numpy() if got.dtype == torch.int32
                                else got.float().numpy())
        res["dtype." + name] = np.array(str(got.dtype))
    res["order"] = np.array([",".join(n) for n in executed])

    # Uneven data (run_join): rank r has r + 1 batches.
    ones = torch.ones(4)
    mine = [hvd.allreduce_async(ones, name="j.%d.%d" % (rank, s), op=hvd.Sum)
            for s in range(rank + 1)]
    res["join.minok"] = hvd.allreduce(torch.full((4,), float(rank + 1)),
                                      name="jminok", op=hvd.Min).numpy()
    if rank > 0:
        # Rank 0 joins without submitting these.
        res["join.min_error"] = np.array(_err(lambda: hvd.allreduce(
            torch.full((4,), 5.0), name="jmin", op=hvd.Min)))
        res["join.avg"] = hvd.allreduce(torch.full((4,), float(rank)),
                                        name="javg", op=hvd.Average).numpy()
    res["join.last"] = np.array(hvd.join())
    res["join.mine"] = np.stack([h.wait().numpy() for h in mine])

    # A shape mismatch fails on every rank.
    res["mismatch"] = np.array(_err(lambda: hvd.allreduce(
        torch.zeros(rank + 1), name="bad")))

    # Grouped name reuse with changed membership and shapes (run_regroup).
    layouts = [[(8,), (8, 4), (3, 8)], [(8,), (2,)], [(8,), (2,)],
               [(8,), (2,)], [(8,), (2,)]]
    for k, shapes in enumerate(layouts):
        outs = hvd.grouped_allreduce(
            [torch.full(s, float(rank + k)) for s in shapes], name="g",
            op=hvd.Sum)
        for i, o in enumerate(outs):
            res["regroup.%d.%d" % (k, i)] = o.numpy()

    # DistributedOptimizer: one named allreduce per parameter, and two
    # groups.
    params, grads = _opt_inputs()
    for groups in (0, 2):
        ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in params.items()}
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(ps.values(), lr=1e-2),
            named_parameters=ps.items(), num_groups=groups)
        del executed[:]
        sum((p * torch.from_numpy(grads[k][rank])).sum()
            for k, p in ps.items()).backward()
        opt.step()
        res["opt%d.names" % groups] = np.array(
            sorted(n for names in executed for n in names))
        for k, p in ps.items():
            res["opt%d.%s" % (groups, k)] = p.detach().numpy()
    hvd.shutdown()

    # A second world in this process, with a stall detector that aborts.
    os.environ.update(HOROVOD_STALL_CHECK_TIME_SECONDS=str(STALL_WARN),
                      HOROVOD_STALL_SHUTDOWN_TIME_SECONDS=str(STALL_SHUTDOWN))
    del os.environ["HOROVOD_TIMELINE"]
    hvd.init(device="cpu")
    res["reinit"] = hvd.allreduce(torch.ones(2), op=hvd.Sum).numpy()
    # Ranks 0 and 1 submit one tensor, rank 2 another: both stall.
    t0 = time.monotonic()
    withheld = hvd.allreduce_async(torch.ones(2), name="stall.%s" % (
        "x" if rank < 2 else "y"))
    res["stall.error"] = np.array(_err(withheld.wait))
    res["stall.secs"] = np.array(time.monotonic() - t0)
    res["stall.after"] = np.array(_err(lambda: hvd.allreduce(torch.ones(1))))
    hvd.shutdown()
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)


# -- test side -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_port_engine")
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
    ranks = [dict(np.load(out / ("rank%d.npz" % r))) for r in range(WORLD)]
    return ranks, out


@pytest.fixture(scope="module")
def mesh():
    return MeshCollectives(jax.devices()[:WORLD])


def _stacked(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_named_tensors_in_any_order_match_mesh_collectives(world, mesh,
                                                           dtype):
    ranks, _ = world
    for name, dt, op, pre, post, x in _named():
        if dt != dtype:
            continue
        want = np.asarray(mesh.allreduce(_stacked(x, dt), op, pre, post)
                          .astype(jnp.float32 if dt != "int32"
                                  else jnp.int32))
        for res in ranks:
            assert str(res["dtype." + name]) == "torch." + dt
            np.testing.assert_allclose(res["named." + name], want,
                                       rtol=RTOL[dt], atol=0,
                                       err_msg="%s %s %s" % (name, dt, op))


def test_one_execution_order_on_every_rank(world):
    ranks, _ = world
    orders = [list(res["order"]) for res in ranks]
    assert orders[0] == orders[1] == orders[2]
    flat = [n for names in orders[0] for n in names.split(",")]
    assert sorted(flat) == sorted(n for n, *_ in _named())
    # The ranks' enqueue orders differ.
    perms = [list(np.random.RandomState(10 + r).permutation(N_NAMED))
             for r in range(WORLD)]
    assert perms[0] != perms[1] != perms[2]


def _jax_engine_join(stacked, joined, op):
    """The JAX in-process engine's result for ``stacked`` with world ranks
    ``joined`` out of data (their rows zeroed; Average over the live)."""
    eng = CollectiveEngine(jax.devices()[:WORLD], JaxConfig(), JaxTimeline(),
                           lambda psid: None)
    try:
        eng.mark_joined(joined)
        try:
            return np.asarray(eng.enqueue_allreduce(
                "x", stacked, op, 1.0, 1.0, 0).wait())
        except JaxError as e:
            return str(e)
    finally:
        eng.finalize_join()
        eng.shutdown()


def test_uneven_data_join_matches_the_jax_engine(world):
    ranks, _ = world
    lasts = {int(res["join.last"]) for res in ranks}
    assert len(lasts) == 1 and lasts.pop() in range(WORLD)
    minok = np.asarray(MeshCollectives(jax.devices()[:WORLD]).allreduce(
        np.stack([np.full(4, r + 1.0, np.float32) for r in range(WORLD)]),
        "Min"))
    avg = _jax_engine_join(np.stack([np.full(4, float(r), np.float32)
                                     for r in range(WORLD)]), [0], "Average")
    min_error = _jax_engine_join(np.full((WORLD, 4), 5.0, np.float32), [0],
                                 "Min")
    assert "Sum/Average" in min_error
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["join.minok"], minok)
        # Rank r's own batches: every other rank joined without them.
        stacked = np.zeros((WORLD, 4), np.float32)
        stacked[r] = 1.0
        own = _jax_engine_join(stacked, [q for q in range(WORLD) if q != r],
                               "Sum")
        np.testing.assert_array_equal(res["join.mine"],
                                      np.stack([own] * (r + 1)))
        if r > 0:
            assert "Sum/Average" in str(res["join.min_error"])
            np.testing.assert_array_equal(res["join.avg"], avg)


def test_shape_mismatch_fails_on_every_rank(world):
    ranks, _ = world
    for res in ranks:
        assert "Mismatched shape" in str(res["mismatch"])


def test_regroup_with_changed_membership(world, mesh):
    ranks, _ = world
    layouts = [[(8,), (8, 4), (3, 8)], [(8,), (2,)], [(8,), (2,)],
               [(8,), (2,)], [(8,), (2,)]]
    for k, shapes in enumerate(layouts):
        for i, s in enumerate(shapes):
            want = np.asarray(mesh.allreduce(np.stack(
                [np.full(s, float(r + k), np.float32)
                 for r in range(WORLD)]), "Sum"))
            for res in ranks:
                np.testing.assert_array_equal(res["regroup.%d.%d" % (k, i)],
                                              want)


def _jax_optimizer_step():
    params, grads = _opt_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))

    def local(g):
        opt = JaxDistOpt(optax.adam(1e-2), axis_name="hvd")
        p = jax.tree.map(jnp.asarray, params)
        upd, _ = opt.update({k: v[0] for k, v in g.items()}, opt.init(p), p)
        return optax.apply_updates(p, upd)

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("hvd"),),
                               out_specs=P(), check_vma=False))
    return jax.tree.map(np.asarray, fn(grads))


@pytest.mark.parametrize("groups", [0, 2])
def test_distributed_optimizer_matches_jax(world, groups):
    """Per parameter, one named allreduce each; with two groups, two
    grouped allreduces; the step matches the JAX DistributedOptimizer's
    Average then Adam (f32, 1e-6)."""
    ranks, _ = world
    want = _jax_optimizer_step()
    names = {0: ["allreduce.b", "allreduce.v", "allreduce.w"],
             2: ["DistributedOptimizer.o1.group0.0",
                 "DistributedOptimizer.o1.group0.1",
                 "DistributedOptimizer.o1.group1.0"]}[groups]
    for res in ranks:
        assert sorted(res["opt%d.names" % groups]) == names
        for key in ("w", "b", "v"):
            np.testing.assert_allclose(res["opt%d.%s" % (groups, key)],
                                       want[key], rtol=1e-6, atol=1e-6)


def test_timeline_names_every_tensor(world):
    _, out = world
    records = json.loads((out / "timeline.json").read_text())
    by_tensor = {}
    for rec in records:
        if "name" in rec:
            by_tensor.setdefault(rec["tid"], set()).add(rec["name"])
    for name, *_ in _named():
        phases = by_tensor[name]
        assert "NEGOTIATE_ALLREDUCE" in phases
        assert phases & {"EXEC_ALLREDUCE", "EXEC_FUSED_ALLREDUCE"}


def test_shutdown_then_init_and_a_stall_fails_every_rank(world):
    ranks, _ = world
    for res in ranks:
        np.testing.assert_array_equal(res["reinit"], [WORLD, WORLD])
        assert "stall shutdown threshold exceeded" in str(res["stall.error"])
        assert STALL_SHUTDOWN <= float(res["stall.secs"]) < 60
        assert "stopped" in str(res["stall.after"])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
