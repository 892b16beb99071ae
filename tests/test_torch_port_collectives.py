"""The port's collectives and DistributedOptimizer in a 2-process gloo
world on the CPU, against the JAX package on the same stacked inputs.

One spawn for the whole file: the module fixture starts two worker
processes (this file run as a script), each rank runs every scenario and
writes its results; the tests compare them with
``horovod_tpu.ops.xla_ops.MeshCollectives`` and
``horovod_tpu.jax.optimizer.DistributedOptimizer`` on a 2-device mesh.
"""

import os
import socket
import subprocess
import sys

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

    from horovod_tpu.common.topology import multiprocess_topology
    from horovod_tpu.jax.optimizer import DistributedOptimizer as JaxDistOpt
    from horovod_tpu.ops.xla_ops import MeshCollectives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
OPS = ("Sum", "Average", "Min", "Max", "Product")
PRE, POST = 0.5, 3.0
# (backward_passes_per_step, gradient_predivide_factor)
OPT_CASES = ((1, 1.0), (2, 2.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payloads():
    """Rank-major stacked inputs [WORLD, ...]."""
    rng = np.random.RandomState(0)
    return {"a": rng.randn(WORLD, 3, 5).astype(np.float32),
            "b": rng.randn(WORLD, 7).astype(np.float32),
            "i": rng.randint(-50, 50, (WORLD, 6)).astype(np.int32)}


def _opt_inputs():
    """Parameters, and per-rank gradients [WORLD, pass, ...]."""
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    grads = {k: rng.randn(WORLD, 2, *v.shape).astype(np.float32)
             for k, v in params.items()}
    return params, grads


# -- worker side (runs in the spawned processes) -----------------------------

def _worker(rank: int, port: int, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    res = {"topology": np.array([hvd.rank(), hvd.size(), hvd.local_rank(),
                                 hvd.local_size(), hvd.cross_rank(),
                                 hvd.cross_size()])}
    x = {k: torch.from_numpy(v[rank]) for k, v in _payloads().items()}
    for op in OPS:
        a, b = hvd.grouped_allreduce([x["a"], x["b"]], op=op,
                                     prescale_factor=PRE,
                                     postscale_factor=POST)
        res["fused_%s_a" % op], res["fused_%s_b" % op] = a.numpy(), b.numpy()
    res["int_average"] = hvd.allreduce(x["i"], op=hvd.Average).numpy()
    h = hvd.grouped_allreduce_async([x["i"], x["a"]], op=hvd.Sum)
    mixed = hvd.synchronize(h)
    res["mixed_i"], res["mixed_a"] = mixed[0].numpy(), mixed[1].numpy()
    res["mixed_poll"] = np.array(hvd.poll(h))

    params, grads = _opt_inputs()
    for n, factor in OPT_CASES:
        w, b = (torch.nn.Parameter(torch.from_numpy(params[k].copy()))
                for k in ("w", "b"))
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam([w, b], lr=1e-2), backward_passes_per_step=n,
            gradient_predivide_factor=factor)
        for i in range(n):
            loss = ((w * torch.from_numpy(grads["w"][rank, i])).sum()
                    + (b * torch.from_numpy(grads["b"][rank, i])).sum())
            loss.backward()
        opt.step()
        res["opt_%d_w" % n], res["opt_%d_b" % n] = (
            w.detach().numpy(), b.detach().numpy())

    t = torch.full((4,), float(rank))
    res["broadcast_"] = hvd.broadcast_(t, 1).numpy()
    torch.manual_seed(rank)
    model = torch.nn.Linear(3, 2)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    res["bcast_weight"] = model.weight.detach().numpy().copy()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    if rank == 0:  # only the root has state and a changed lr
        model(torch.ones(1, 3)).sum().backward()
        opt.step()
        opt.param_groups[0]["lr"] = 0.5
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    st = opt.state_dict()
    res["ostate_exp_avg"] = st["state"][0]["exp_avg"].numpy()
    res["ostate_step"] = np.array(float(st["state"][0]["step"]))
    res["ostate_lr"] = np.array(st["param_groups"][0]["lr"])
    hvd.shutdown()
    np.savez(out, **res)


# -- test side -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_port_gloo")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         str(out / ("rank%d.npz" % r))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(out / ("rank%d.npz" % r))) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh_collectives():
    return MeshCollectives(jax.devices()[:WORLD])


@pytest.mark.parametrize("op", OPS)
def test_fused_allreduce_matches_mesh_collectives(ranks, mesh_collectives,
                                                  op):
    """Pre-scale, reduce, post-scale over one fused buffer: f32 sums of
    two values in the same order, so 1e-6 relative."""
    x = _payloads()
    want = mesh_collectives.fused_allreduce(
        [x["a"], x["b"]], op, PRE, POST, joined_idx=((), ()),
        bucket=x["a"][0].size + x["b"][0].size)
    for res in ranks:
        for key, w in zip("ab", want):
            np.testing.assert_allclose(res["fused_%s_%s" % (op, key)],
                                       np.asarray(w), rtol=1e-6, atol=1e-6)


def test_integer_average_floor_divides(ranks, mesh_collectives):
    x = _payloads()["i"]
    want = np.asarray(mesh_collectives.allreduce(x, "Average"))
    np.testing.assert_array_equal(want, x.sum(0) // WORLD)
    for res in ranks:
        assert res["int_average"].dtype == np.int32
        np.testing.assert_array_equal(res["int_average"], want)


def test_mixed_dtypes_reduce_in_one_buffer_each(ranks):
    x = _payloads()
    for res in ranks:
        assert res["mixed_i"].dtype == np.int32
        np.testing.assert_array_equal(res["mixed_i"], x["i"].sum(0))
        np.testing.assert_allclose(res["mixed_a"], x["a"].sum(0), rtol=1e-6)
        assert bool(res["mixed_poll"])


def _jax_optimizer_step(n, factor):
    params, grads = _opt_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))

    def local(g):
        opt = JaxDistOpt(optax.adam(1e-2), backward_passes_per_step=n,
                         gradient_predivide_factor=factor, axis_name="hvd")
        p = jax.tree.map(jnp.asarray, params)
        state = opt.init(p)
        for i in range(n):
            upd, state = opt.update({k: v[0, i] for k, v in g.items()},
                                    state, p)
            p = optax.apply_updates(p, upd)
        return p

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("hvd"),),
                               out_specs=P(), check_vma=False))
    return jax.tree.map(np.asarray, fn(grads))


@pytest.mark.parametrize("n,factor", OPT_CASES)
def test_distributed_optimizer_matches_jax(ranks, n, factor):
    """Average (or pre 1/f, Sum, post f/size) of the locally accumulated
    gradients, then Adam: f32, 1e-6."""
    want = _jax_optimizer_step(n, factor)
    for res in ranks:
        for key in ("w", "b"):
            np.testing.assert_allclose(res["opt_%d_%s" % (n, key)],
                                       want[key], rtol=1e-6, atol=1e-6)


def test_broadcasts(ranks):
    root = ranks[0]
    for res in ranks:
        np.testing.assert_array_equal(res["broadcast_"], np.ones(4))
        np.testing.assert_array_equal(res["bcast_weight"],
                                      root["bcast_weight"])
        np.testing.assert_array_equal(res["ostate_exp_avg"],
                                      root["ostate_exp_avg"])
        assert float(res["ostate_step"]) == 1.0
        assert float(res["ostate_lr"]) == 0.5


@pytest.mark.parametrize("env", [
    {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
     "LOCAL_WORLD_SIZE": "2"},
    {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
     "LOCAL_WORLD_SIZE": "4"},
    {"RANK": "3", "WORLD_SIZE": "4"},
    {},
])
def test_topology_matches_jax_package(env):
    from horovod_tpu_torch.common.topology import topology_from_env
    got = topology_from_env(env)
    opt = lambda k: int(env[k]) if k in env else None
    want = multiprocess_topology(int(env.get("RANK", 0)),
                                 int(env.get("WORLD_SIZE", 1)),
                                 local_rank=opt("LOCAL_RANK"),
                                 local_size=opt("LOCAL_WORLD_SIZE"))
    for field in ("rank", "size", "local_rank", "local_size", "cross_rank",
                  "cross_size"):
        assert getattr(got, field) == getattr(want, field), field


def test_worker_topology(ranks):
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["topology"],
                                      [r, WORLD, r, WORLD, 0, 1])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
