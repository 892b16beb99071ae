"""The rest of the port's adapter against the JAX package: the four
training callbacks, ``metric_average``, ``allreduce_gradients`` and
``shard_batch`` (``horovod_tpu.jax.callbacks``, ``horovod_tpu.jax.
data_parallel``, ``horovod_tpu.jax.optimizer.allreduce_gradients``).

The learning-rate callbacks are held in this process at the same epoch
and batch points (exact: the same float arithmetic).  One 2-rank gloo
world (spawned once, 120 s timeout) runs the rest on each rank's own
values; the test side holds them to the JAX functions on the stacked
values: ``metric_average`` to the in-process engine's Average over the
ranks (f32, 1e-6 relative), ``allreduce_gradients`` to the JAX one in a
2-device ``shard_map`` (f32 1e-6 relative; fp16 wire two f16 ulps, 2^-9
relative, since the JAX Average divides in f16), ``shard_batch``'s rows
to the shards ``jax.device_put`` gives each device under the JAX
``shard_batch``'s ``P("hvd")`` sharding (exact), and the broadcast and
metric callbacks to rank 0's state and the ranks' mean.
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
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from horovod_tpu.jax import callbacks as jcb
    from horovod_tpu.jax.compression import Compression as JaxCompression
    from horovod_tpu.jax.optimizer import allreduce_gradients as jax_arg
    from horovod_tpu.ops.xla_ops import MeshCollectives

    from horovod_tpu_torch import callbacks as tcb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SPAWN_TIMEOUT = 120


def _grads(rank=None):
    rng = np.random.RandomState(5)
    g = {"w": rng.randn(WORLD, 4, 3).astype(np.float32),
         "b": rng.randn(WORLD, 3).astype(np.float32)}
    return g if rank is None else {k: v[rank] for k, v in g.items()}


def _batch(rows=6):
    rng = np.random.RandomState(6)
    return {"x": rng.randn(rows, 3).astype(np.float32),
            "y": rng.randint(0, 9, rows).astype(np.int64)}


def _metric(rank):
    return 0.25 + 1.5 * rank


# -- the learning-rate callbacks, in this process ------------------------------

EPOCHS = (0, 0.5, 1, 2.25, 3, 4.99, 5, 7)


@pytest.mark.parametrize("warmup, multiplier", [(5, 4.0), (3, 2.0),
                                                (1, 8.0)])
def test_warmup_lr_matches_jax(warmup, multiplier):
    kw = dict(initial_lr=0.1, warmup_epochs=warmup, steps_per_epoch=10,
              multiplier=multiplier)
    mine, theirs = tcb.LearningRateWarmupCallback(**kw), \
        jcb.LearningRateWarmupCallback(**kw)
    for e in EPOCHS:
        assert mine.lr_at(e) == theirs.lr_at(e)
    for epoch in range(warmup + 2):
        for cb in (mine, theirs):
            cb.on_epoch_begin(epoch)
        assert mine.current_lr == theirs.current_lr
        for batch in (0, 3, 9):
            logs_m, logs_t = {}, {}
            mine.on_batch_end(batch, logs_m)
            theirs.on_batch_end(batch, logs_t)
            assert mine.current_lr == theirs.current_lr == logs_m["lr"] \
                == logs_t["lr"]
    schedule, factor = theirs.as_optax_schedule(), mine.as_lr_lambda()
    for step in (0, 1, 7, 10 * warmup - 1, 10 * warmup, 10 * warmup + 5):
        np.testing.assert_allclose(0.1 * factor(step),
                                   float(schedule(step)), rtol=1e-6)


def test_warmup_lr_drives_lambda_lr():
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=0.1)
    cb = tcb.LearningRateWarmupCallback(0.1, warmup_epochs=2,
                                        steps_per_epoch=4, multiplier=4.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cb.as_lr_lambda())
    theirs = jcb.LearningRateWarmupCallback(0.1, 2, 4, 4.0).as_optax_schedule()
    for step in range(12):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(theirs(step)), rtol=1e-6)
        opt.step()
        sched.step()


def test_warmup_needs_steps_per_epoch_per_batch():
    for cls in (tcb.LearningRateWarmupCallback,
                jcb.LearningRateWarmupCallback):
        cb = cls(0.1, warmup_epochs=2, multiplier=2.0)
        cb.on_epoch_begin(0)  # epoch-granular use works without
        with pytest.raises(ValueError, match="steps_per_epoch"):
            cb.on_batch_end(1)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        tcb.LearningRateWarmupCallback(0.1, 2, multiplier=2.0).as_lr_lambda()


@pytest.mark.parametrize("multiplier", [0.5, lambda e: 0.9 ** e])
@pytest.mark.parametrize("staircase", [True, False])
def test_schedule_lr_matches_jax(multiplier, staircase):
    kw = dict(initial_lr=0.2, multiplier=multiplier, start_epoch=1,
              end_epoch=4, staircase=staircase)
    mine, theirs = tcb.LearningRateScheduleCallback(**kw), \
        jcb.LearningRateScheduleCallback(**kw)
    for e in EPOCHS:
        assert mine.lr_at(e) == theirs.lr_at(e)
    for epoch in range(7):
        mine.on_epoch_begin(epoch)
        theirs.on_epoch_begin(epoch)
        assert mine.current_lr == theirs.current_lr


def test_callbacks_without_a_world_pass_through():
    """Before ``init`` (a world of one), the JAX and port callbacks leave
    metrics and the state alone."""
    logs = {"loss": 1.5}
    assert tcb.MetricAverageCallback().on_epoch_end(0, dict(logs)) == logs
    assert jcb.MetricAverageCallback().on_epoch_end(0, dict(logs)) == logs
    for cls in (tcb.BroadcastGlobalVariablesCallback,
                jcb.BroadcastGlobalVariablesCallback):
        assert cls().on_train_begin(None) is None
    assert issubclass(tcb.MetricAverageCallback, tcb.Callback)


def test_adapter_names_are_exported():
    import horovod_tpu_torch as hvd
    for name in ("allreduce_gradients", "shard_batch", "metric_average",
                 "Callback", "BroadcastGlobalVariablesCallback",
                 "MetricAverageCallback", "LearningRateWarmupCallback",
                 "LearningRateScheduleCallback"):
        assert name in hvd.__all__ and getattr(hvd, name) is not None


# -- worker side ---------------------------------------------------------------

def _worker(rank: int, port: int, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    res = {}
    mine = hvd.shard_batch(_batch())
    res["shard.x"], res["shard.y"] = mine["x"].numpy(), mine["y"].numpy()
    res["shard.dtypes"] = np.array([str(mine["x"].dtype),
                                    str(mine["y"].dtype)])
    res["shard.list"] = hvd.shard_batch([_batch()["x"]])[0].numpy()
    try:
        hvd.shard_batch(_batch(5))
        res["shard.error"] = np.array("")
    except ValueError as e:
        res["shard.error"] = np.array(str(e))
    res["metric"] = np.array(hvd.metric_average(_metric(rank), "m"))
    g = {k: torch.from_numpy(v) for k, v in _grads(rank).items()}
    for tag, kw in (("avg", {}), ("sum", {"op": hvd.Sum}),
                    ("fp16", {"compression": hvd.Compression.fp16})):
        outs = hvd.allreduce_gradients(g, **kw)
        for k, v in outs.items():
            res["grads.%s.%s" % (tag, k)] = v.numpy()
            res["grads.%s.%s.dtype" % (tag, k)] = np.array(str(v.dtype))
    as_list = hvd.allreduce_gradients([g["b"], g["w"]])
    res["grads.list.b"], res["grads.list.w"] = (t.numpy() for t in as_list)
    res["grads.tensor"] = hvd.allreduce_gradients(g["b"]).numpy()
    # Callbacks: rank-dependent weights broadcast from rank 0; metrics
    # averaged.
    torch.manual_seed(rank)
    model = torch.nn.Linear(3, 2)
    hvd.BroadcastGlobalVariablesCallback(0).on_train_begin(model)
    res["bcast.weight"] = model.weight.detach().numpy()
    logs = hvd.MetricAverageCallback().on_epoch_end(
        0, {"loss": _metric(rank), "acc": 2.0 * rank})
    res["logs"] = np.array([logs["loss"], logs["acc"]])
    res["warmup.multiplier"] = np.array(
        hvd.LearningRateWarmupCallback(0.1).multiplier)
    hvd.shutdown()
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)


# -- test side -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_port_adapter")
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
    return [dict(np.load(out / ("rank%d.npz" % r))) for r in range(WORLD)]


def test_shard_batch_rows_match_the_jax_sharding(world):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))
    batch = _batch()
    want = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("hvd")))
            for k, v in batch.items()}
    for r, res in enumerate(world):
        for k in ("x", "y"):
            shard = next(s for s in want[k].addressable_shards
                         if s.device == jax.devices()[r])
            np.testing.assert_array_equal(res["shard.%s" % k],
                                          np.asarray(shard.data))
        assert list(res["shard.dtypes"]) == ["torch.float32", "torch.int64"]
        np.testing.assert_array_equal(res["shard.list"], res["shard.x"])
        assert "does not split over 2 ranks" in str(res["shard.error"])


def test_metric_average_matches_the_jax_average(world):
    stacked = np.array([[_metric(r)] for r in range(WORLD)], np.float32)
    want = np.asarray(MeshCollectives(jax.devices()[:WORLD]).allreduce(
        stacked, "Average"))[0]
    for res in world:
        np.testing.assert_allclose(float(res["metric"]), want, rtol=1e-6)


def _jax_allreduce_gradients(op, compression):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))

    def local(g):
        return jax_arg({k: v[0] for k, v in g.items()}, op=op,
                       axis_name="hvd", compression=compression)

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("hvd"),),
                               out_specs=P(), check_vma=False))
    return jax.tree.map(np.asarray, fn(_grads()))


@pytest.mark.parametrize("tag, op, compression, rtol", [
    ("avg", "Average", "none", 1e-6),
    ("sum", "Sum", "none", 1e-6),
    ("fp16", "Average", "fp16", 2 ** -9)])
def test_allreduce_gradients_matches_jax(world, tag, op, compression, rtol):
    want = _jax_allreduce_gradients(op, getattr(JaxCompression, compression))
    for res in world:
        for k in ("w", "b"):
            assert str(res["grads.%s.%s.dtype" % (tag, k)]) == "torch.float32"
            np.testing.assert_allclose(res["grads.%s.%s" % (tag, k)],
                                       want[k], rtol=rtol, atol=1e-6)
        if tag == "avg":
            np.testing.assert_allclose(res["grads.list.b"], want["b"],
                                       rtol=rtol)
            np.testing.assert_allclose(res["grads.list.w"], want["w"],
                                       rtol=rtol)
            np.testing.assert_allclose(res["grads.tensor"], want["b"],
                                       rtol=rtol)


def test_broadcast_and_metric_callbacks_in_a_world(world):
    for res in world:
        np.testing.assert_array_equal(res["bcast.weight"],
                                      world[0]["bcast.weight"])
        np.testing.assert_allclose(
            res["logs"], [np.mean([_metric(r) for r in range(WORLD)]),
                          np.mean([2.0 * r for r in range(WORLD)])],
            rtol=1e-12)
        assert float(res["warmup.multiplier"]) == WORLD
    torch.manual_seed(1)
    assert not np.array_equal(world[0]["bcast.weight"],
                              torch.nn.Linear(3, 2).weight.detach().numpy())


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
