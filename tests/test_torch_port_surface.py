"""The port's collective surface in a 4-process gloo world on the CPU,
against ``horovod_tpu.ops.xla_ops.MeshCollectives`` on a 4-device mesh
with the same stacked inputs.

One spawn for the whole file: each rank runs every scenario and writes
its results.  Covered: allgather (even and uneven first dimensions),
reducescatter (every op, rows that divide and rows that do not, Adasum
rejected), alltoall (uniform, and ragged with the received splits),
barrier, the grouped and async forms, ``allgather_object``, process sets
of a subset of ranks (an allreduce and an allgather over three ranks, an
Adasum allreduce over ranks 0 and 2, whose partners are found through
the set's world ranks), and each autograd function's gradient.  Sums of
f32 values in another order: 1e-6 relative; everything else is exact.
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

    from horovod_tpu.ops.xla_ops import MeshCollectives, uneven_chunks
    from horovod_tpu.utils.adasum import adasum_reduce_stacked

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
OPS = ("Sum", "Average", "Min", "Max", "Product")
SUBSET, PAIR = [1, 2, 3], [0, 2]
RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    """Rank-major inputs [WORLD, ...] and the ragged alltoall splits
    (splits[r][j]: rows rank r sends to rank j)."""
    rng = np.random.RandomState(0)
    return {"even": rng.randn(WORLD, 3, 4).astype(np.float32),
            "ragged": [rng.randn(r + 1, 2).astype(np.float32)
                       for r in range(WORLD)],
            "ints": rng.randint(-9, 9, (WORLD, 2, 3)).astype(np.int32),
            # values near 1, so that Product neither overflows nor vanishes
            "rs8": rng.uniform(0.5, 1.5, (WORLD, 8, 3)).astype(np.float32),
            "rs10": rng.uniform(0.5, 1.5, (WORLD, 10, 3)).astype(np.float32),
            "a2a": rng.randn(WORLD, 12, 2).astype(np.float32),
            "splits": rng.randint(0, 4, (WORLD, WORLD)),
            "up10": rng.randn(WORLD, 10, 2).astype(np.float32),
            "up2": rng.randn(WORLD, 2, 3).astype(np.float32),
            "w": rng.randn(WORLD, 8, 3).astype(np.float32),
            "c": rng.randn(WORLD, 8, 3).astype(np.float32)}


def _ragged_rows(x, splits, r):
    return x["a2a"][r][:int(splits[r].sum())]


# -- worker side (runs in the spawned processes) -------------------------------

def _worker(rank: int, port: int, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    x = _inputs()
    t = {k: torch.from_numpy(v[rank]) for k, v in x.items()
         if k not in ("ragged", "splits")}
    res = {}

    # allgather, reducescatter, alltoall, barrier
    res["ag.even"] = hvd.allgather(t["even"]).numpy()
    res["ag.ragged"] = hvd.allgather(torch.from_numpy(x["ragged"][rank])).numpy()
    res["ag.ints"] = hvd.allgather(t["ints"]).numpy()
    res["ag.scalar"] = hvd.allgather(torch.tensor(float(rank))).numpy()
    for op in OPS:
        for rows in ("rs8", "rs10"):
            res["rs.%s.%s" % (rows, op)] = hvd.reducescatter(
                t[rows], op=op).numpy()
    try:
        hvd.reducescatter(t["rs8"], op=hvd.Adasum)
        res["rs.adasum_rejected"] = np.array(False)
    except ValueError as e:
        res["rs.adasum_rejected"] = np.array("allreduce-only" in str(e))
    res["a2a.uniform"] = hvd.alltoall(t["a2a"]).numpy()
    splits = x["splits"]
    got, recv = hvd.alltoall(torch.from_numpy(_ragged_rows(x, splits, rank)),
                             splits=splits[rank].tolist())
    res["a2a.ragged"], res["a2a.recv"] = got.numpy(), recv.numpy()
    hvd.barrier()
    res["barrier"] = np.array(True)

    # grouped and async forms
    h = hvd.grouped_allgather_async([t["even"], t["ints"]])
    res["gag.even"], res["gag.ints"] = (v.numpy() for v in
                                        hvd.synchronize(h))
    res["grs.rs8"], res["grs.rs10"] = (v.numpy() for v in
                                       hvd.grouped_reducescatter(
                                           [t["rs8"], t["rs10"]], op=hvd.Max))
    res["rs_async"] = hvd.synchronize(hvd.reducescatter_async(
        t["rs10"], op=hvd.Sum)).numpy()
    out_async, recv_async = hvd.synchronize(hvd.alltoall_async(t["a2a"]))
    res["a2a_async"], res["a2a_async.recv"] = (out_async.numpy(),
                                               np.array(recv_async))
    res["objects"] = np.array(repr(hvd.allgather_object(
        {"rank": rank, "data": [rank] * rank})))

    # process sets (every rank registers, in the same order)
    subset = hvd.add_process_set(SUBSET)
    pair = hvd.add_process_set(hvd.ProcessSet(PAIR))
    errors = []
    for bad in (SUBSET, [0, WORLD]):
        try:
            hvd.add_process_set(bad)
        except ValueError as e:
            errors.append(str(e))
    res["ps.errors"] = np.array(errors)
    res["ps.ids"] = np.array([subset.process_set_id, pair.process_set_id])
    if rank in SUBSET:
        res["ps.sum"] = hvd.allreduce(t["even"], op=hvd.Sum,
                                      process_set=subset).numpy()
        res["ps.ag"] = hvd.allgather(torch.from_numpy(x["ragged"][rank]),
                                     process_set=subset).numpy()
        res["ps.rank"] = np.array(subset.rank())
    else:
        try:
            hvd.allreduce(t["even"], process_set=subset)
            res["ps.outsider"] = np.array("")
        except ValueError as e:
            res["ps.outsider"] = np.array(str(e))
    if rank in PAIR:
        res["ps.adasum"] = hvd.allreduce(t["even"], op=hvd.Adasum,
                                         process_set=pair).numpy()
        hvd.barrier(process_set=pair)
    res["ps.removed"] = np.array([hvd.remove_process_set(subset),
                                  hvd.remove_process_set(subset),
                                  hvd.remove_process_set(hvd.global_process_set)])

    # autograd
    def grad_of(fn, w, c):
        w = w.clone().requires_grad_()
        y = fn(w)
        (y * c).sum().backward()
        return w.grad.numpy()

    for op in ("Sum", "Average"):
        res["grad.allreduce.%s" % op] = grad_of(
            lambda w: hvd.allreduce(w, op=op), t["w"], t["c"])
        res["grad.reducescatter.%s" % op] = grad_of(
            lambda w: hvd.reducescatter(w, op=op), t["w"], t["c"][:2])
    res["grad.allgather"] = grad_of(
        hvd.allgather, torch.from_numpy(x["ragged"][rank]),
        t["up10"])
    res["grad.broadcast"] = grad_of(lambda w: hvd.broadcast(w, 1), t["w"],
                                    t["c"])
    a2a_in = torch.from_numpy(_ragged_rows(x, splits, rank))
    recv_rows = int(splits[:, rank].sum())
    res["grad.alltoall"] = grad_of(
        lambda w: hvd.alltoall(w, splits=splits[rank].tolist())[0], a2a_in,
        t["w"].reshape(-1, 2)[:recv_rows])
    w1, w2 = (v.clone().requires_grad_() for v in (t["w"], t["up2"]))
    y1, y2 = hvd.grouped_allreduce([w1, w2], op=hvd.Sum)
    ((y1 * t["c"]).sum() + (y2 * 2).sum()).backward()
    res["grad.grouped_allreduce"] = w1.grad.numpy()
    w1, w2 = (v.clone().requires_grad_() for v in (t["w"], t["up2"]))
    g1, g2 = hvd.grouped_allgather([w1, w2])
    r1, r2 = hvd.grouped_reducescatter([w1, w2.repeat(4, 1)], op=hvd.Average)
    ((g1 * 3).sum() + (g2 * 5).sum() + (r1 * 7).sum()
     + (r2 * 11).sum()).backward()
    res["grad.grouped_ag_rs.w"], res["grad.grouped_ag_rs.up2"] = (
        w1.grad.numpy(), w2.grad.numpy())
    hvd.shutdown()
    np.savez(out, **res)


# -- test side ------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_port_surface")
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
            logs.append(p.communicate(timeout=180)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(out / ("rank%d.npz" % r))) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh():
    return MeshCollectives(jax.devices()[:WORLD])


def _close(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_allgather_even_and_uneven(ranks, mesh):
    x = _inputs()
    want = {"even": mesh.allgather(list(x["even"])),
            "ragged": mesh.allgather(x["ragged"]),
            "ints": mesh.allgather(list(x["ints"])),
            "scalar": np.arange(WORLD, dtype=np.float32)}
    for res in ranks:
        for key, w in want.items():
            np.testing.assert_array_equal(res["ag." + key], np.asarray(w))
        assert res["ag.ints"].dtype == np.int32
        np.testing.assert_array_equal(res["gag.even"], res["ag.even"])
        np.testing.assert_array_equal(res["gag.ints"], res["ag.ints"])


@pytest.mark.parametrize("op", OPS)
def test_reducescatter_every_op(ranks, mesh, op):
    """Rows that divide: MeshCollectives.reducescatter's row r.  Rows
    that do not (10 over 4): the full reduction cut by the reference's
    ``uneven_chunks`` (earlier ranks take the larger shards)."""
    x = _inputs()
    even = np.asarray(mesh.reducescatter(x["rs8"], op))
    full = np.asarray(mesh.allreduce(x["rs10"], op))
    rows, offs = uneven_chunks(10, WORLD)
    for r, res in enumerate(ranks):
        _close(res["rs.rs8.%s" % op], even[r])
        _close(res["rs.rs10.%s" % op], full[offs[r]:offs[r] + rows[r]])
        assert bool(res["rs.adasum_rejected"])
        if op == "Max":
            np.testing.assert_array_equal(res["grs.rs8"], res["rs.rs8.Max"])
            np.testing.assert_array_equal(res["grs.rs10"],
                                          res["rs.rs10.Max"])
        if op == "Sum":
            np.testing.assert_array_equal(res["rs_async"],
                                          res["rs.rs10.Sum"])


def test_alltoall_uniform_and_ragged(ranks, mesh):
    x = _inputs()
    uniform, _ = mesh.alltoall(x["a2a"])
    splits = x["splits"]
    ragged, recv = mesh.alltoall(x["a2a"], splits)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["a2a.uniform"],
                                      np.asarray(uniform)[r])
        np.testing.assert_array_equal(res["a2a.ragged"], np.asarray(ragged[r]))
        np.testing.assert_array_equal(res["a2a.recv"], recv[r])
        np.testing.assert_array_equal(res["a2a_async"], res["a2a.uniform"])
        np.testing.assert_array_equal(res["a2a_async.recv"], [3] * WORLD)
    assert splits.sum(0).min() < splits.sum(0).max()  # really ragged


def test_barrier_and_allgather_object(ranks):
    want = repr([{"rank": r, "data": [r] * r} for r in range(WORLD)])
    for res in ranks:
        assert bool(res["barrier"])
        assert str(res["objects"]) == want


def test_process_sets_of_a_subset(ranks, mesh):
    """Sets over ``new_group``: collectives over their members only, with
    the set's own ranks; registration errors as the reference raises
    them; an outsider's call raises; removal once."""
    x = _inputs()
    sub = MeshCollectives([jax.devices()[r] for r in SUBSET])
    want_sum = np.asarray(sub.allreduce(x["even"][SUBSET], "Sum"))
    want_ag = np.asarray(sub.allgather([x["ragged"][r] for r in SUBSET]))
    want_adasum = np.asarray(adasum_reduce_stacked(x["even"][PAIR]))
    for r, res in enumerate(ranks):
        errors = list(res["ps.errors"])
        assert "same ranks already exists" in errors[0]
        assert "out of range" in errors[1]
        np.testing.assert_array_equal(res["ps.ids"], [1, 2])
        if r in SUBSET:
            _close(res["ps.sum"], want_sum)
            np.testing.assert_array_equal(res["ps.ag"], want_ag)
            assert int(res["ps.rank"]) == SUBSET.index(r)
        else:
            assert "not part of" in str(res["ps.outsider"])
        if r in PAIR:
            np.testing.assert_allclose(res["ps.adasum"], want_adasum,
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(res["ps.adasum"],
                                          ranks[PAIR[0]]["ps.adasum"])
        np.testing.assert_array_equal(res["ps.removed"],
                                      [True, False, False])


def test_autograd_allreduce_and_broadcast(ranks, mesh):
    """allreduce: the gradient allreduced with the same op; broadcast:
    the gradients summed on the root, zeros elsewhere."""
    c = _inputs()["c"]
    summed = np.asarray(mesh.allreduce(c, "Sum"))
    for r, res in enumerate(ranks):
        for op in ("Sum", "Average"):
            _close(res["grad.allreduce.%s" % op],
                   mesh.allreduce(c, op))
        _close(res["grad.broadcast"],
               summed if r == 1 else np.zeros_like(summed))
        _close(res["grad.grouped_allreduce"], summed)


def test_autograd_allgather_reducescatter_alltoall(ranks, mesh):
    """allgather: this rank's rows of the summed gradient; reducescatter:
    the shards' gradients allgathered (over the size for Average);
    alltoall: the gradient sent back along the received splits."""
    x = _inputs()
    up = np.asarray(mesh.allreduce(x["up10"], "Sum"))
    shard_grads = mesh.allgather([c[:2] for c in x["c"]])
    splits = x["splits"]
    recv_rows = splits.sum(0)
    back = np.stack([np.pad(x["w"][j].reshape(-1, 2)[:recv_rows[j]],
                            ((0, 16 - recv_rows[j]), (0, 0)))
                     for j in range(WORLD)])
    sent_back, _ = mesh.alltoall(back, splits.T)
    for r, res in enumerate(ranks):
        off = sum(range(1, r + 1))
        _close(res["grad.allgather"], up[off:off + r + 1])
        _close(res["grad.reducescatter.Sum"], shard_grads)
        _close(res["grad.reducescatter.Average"],
               np.asarray(shard_grads) / WORLD)
        _close(res["grad.alltoall"], sent_back[r])
        # grouped allgather: 3 summed over 4 ranks; grouped reducescatter
        # (Average): 7 (or 11) over the size, gathered.
        _close(res["grad.grouped_ag_rs.w"],
               np.full((8, 3), 12 + 7 / WORLD, np.float32))
        _close(res["grad.grouped_ag_rs.up2"],
               np.full((2, 3), 20 + 4 * 11 / WORLD, np.float32))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
