"""The port's hierarchical collectives in one 4-rank gloo world on the
CPU, laid out as 2 nodes of 2 ranks (``LOCAL_RANK``,
``LOCAL_WORLD_SIZE=2``), against the flat path of the same world.

One spawn for the whole file: each rank starts a world per cross-node
codec (none, fp16, bf16, int8, fp8) and one with
``HOROVOD_HIERARCHICAL_ALLREDUCE=off`` (the flat reference), runs every
case in it and writes its results.  Covered: all five ops (allreduce
under every reduce op, and prescaled under Sum, Product and Max,
reducescatter, allgather, broadcast from either node, alltoall) on the
hierarchical path under every codec; with no
codec bit for bit against the flat path on integer-valued f32 inputs
(so Average divides once, by all four ranks); the cast codecs within
their dtype's rounding and the quant codecs within the bounds of the
reference's own worker (``tests/utils/multihost_compression_worker.py``:
two quantizations of at most absmax/254 each for int8, ``2^-4`` of the
absmax for e4m3); error feedback's mean over 8 steps under half the
one-step bound; a sub-threshold payload flat, uncompressed and exact;
Product never quantized; ``mh_bus_bytes_total`` at least 3.5x under the
payload under int8; a frozen fast-path round on the hierarchical path; a
small decoder step under int8 within the codec's bound of the flat
world's gradients; one node's two ranks as a set (hierarchical), one
rank of each node (flat); and the non-homogeneous set [0, 1, 2] flat,
with one warning.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, LOCAL = 4, 2
WARM = 3
SPAWN_TIMEOUT = 120
CODECS = ("none", "fp16", "bf16", "int8", "fp8")
N = 32768  # 128 KiB of f32: past the 64 KiB threshold
REDUCE_OPS = ("Sum", "Average", "Min", "Max", "Product")
# Scaled allreduces: label -> (op, prescale, postscale).  A prescale on
# Product or Max is each rank's, not each node's: 0.5^4 on every product,
# and Max of the negated payloads.
SCALED = {"scaled": ("Sum", 0.5, 4.0), "Product.pre": ("Product", 0.5, 1.0),
          "Max.neg": ("Max", -1.0, 1.0)}
RS_ROWS = WORLD * 1025 + 3  # uneven shards
AG_ROWS = 8192  # 96 KiB of rows a rank
A2A_ROWS = 1500
EF_STEPS = 8
# Error of one pass through a codec, as a share of the absmax it sees.
UNIT = {"none": 0.0, "fp16": 2.0 ** -11, "bf16": 2.0 ** -8,
        "int8": 1.0 / 254, "fp8": 2.0 ** -4}
DECODER = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=2,
               n_kv_heads=2, d_ff=128, max_seq=32)
DECODER_BATCH = 8


# -- the inputs (both sides make them) -----------------------------------------

def _ar_input(rank, op):
    """Integer-valued f32, different on every position and rank; Product
    takes +-1, 2 and 0.5 so that every product is exact."""
    i = np.arange(N)
    if op == "Product":
        return np.array([1.0, -1.0, 2.0, 0.5], np.float32)[(i + rank) % 4]
    return (((i * 7 + rank * 13) % 61) - 30).astype(np.float32) * (rank + 1)


def _rs_input(rank):
    rows = np.arange(RS_ROWS)[:, None] * 3 + np.arange(5)[None, :]
    return ((rows % 41) - 20).astype(np.float32) * (rank + 1)


def _ag_input(rank):
    rows = AG_ROWS + 37 * rank
    return ((np.arange(rows * 3).reshape(rows, 3) % 29) - 14).astype(
        np.float32) * (rank + 1)


def _bc_input():
    return ((np.arange(N) % 23) - 11).astype(np.float32) * 3


def _a2a_splits(rank):
    return [A2A_ROWS + 11 * ((rank + d) % WORLD) for d in range(WORLD)]


def _a2a_input(rank):
    rows = sum(_a2a_splits(rank))
    return ((np.arange(rows * 4).reshape(rows, 4) % 31) - 15).astype(
        np.float32) * (rank + 1)


def _ef_input(rank):
    return np.linspace(-1.0, 1.0, N).astype(np.float32) * (rank + 1)


# -- worker side ---------------------------------------------------------------

def _series(name, **labels):
    from horovod_tpu_torch.common import metrics
    return metrics.series_sum(name, **labels)


def _counts(op):
    return np.array([_series("mh_collective_path_total", op=op, path="hier"),
                     _series("mh_collective_path_total", op=op, path="flat"),
                     _series("mh_compressed_collectives_total", op=op),
                     _series("mh_bus_bytes_total", op=op, path="hier"),
                     _series("mh_bus_bytes_total", op=op, path="flat")])


def _run(res, tag, op, fn):
    """``fn()``'s result and the ``mh_*`` counts it moved for ``op``:
    [hier, flat, compressed, hier bytes, flat bytes]."""
    before = _counts(op)
    out = fn()
    res[tag] = out.numpy() if hasattr(out, "numpy") else np.asarray(out)
    res[tag + ".counts"] = _counts(op) - before


def _ops(hvd, rank, res, tag):
    import torch
    t = torch.from_numpy
    for op in REDUCE_OPS:
        _run(res, "%s.ar.%s" % (tag, op), "allreduce",
             lambda: hvd.allreduce(t(_ar_input(rank, op)), op=op,
                                   name="ar.%s" % op))
    _run(res, "%s.ar.int32" % tag, "allreduce",
         lambda: hvd.allreduce(t(_ar_input(rank, "Sum").astype(np.int32)),
                               op="Sum", name="ar.int32"))
    for label, (op, pre, post) in SCALED.items():
        _run(res, "%s.ar.%s" % (tag, label), "allreduce",
             lambda: hvd.allreduce(t(_ar_input(rank, op)), op=op,
                                   prescale_factor=pre,
                                   postscale_factor=post,
                                   name="ar.%s" % label))
    for op in ("Sum", "Average", "Max"):
        _run(res, "%s.rs.%s" % (tag, op), "reducescatter",
             lambda: hvd.reducescatter(t(_rs_input(rank)), op=op,
                                       name="rs.%s" % op))
    _run(res, "%s.ag" % tag, "allgather",
         lambda: hvd.allgather(t(_ag_input(rank)), name="ag"))
    for root in (1, 2):
        _run(res, "%s.bc.%d" % (tag, root), "broadcast",
             lambda: hvd.broadcast(
                 t(_bc_input()) * (root + 1) if rank == root
                 else torch.zeros(N), root_rank=root, name="bc.%d" % root))
    _run(res, "%s.a2a" % tag, "alltoall",
         lambda: hvd.alltoall(t(_a2a_input(rank)), splits=_a2a_splits(rank),
                              name="a2a")[0])


def _sets(hvd, rank, res, tag):
    """One node's two ranks as a set (hierarchical), one rank of each
    node (flat), and [0, 1, 2], whose nodes hold 2 and 1 (flat, one
    warning)."""
    import logging
    import torch
    caught = []

    class Catch(logging.Handler):
        def emit(self, record):
            caught.append(record.getMessage())

    handler = Catch(level=logging.WARNING)
    logging.getLogger("horovod_tpu_torch").addHandler(handler)
    try:
        for ranks in ([2, 3], [0, 2], [0, 1, 2]):
            ps = hvd.add_process_set(ranks)
            label = "%s.set%s" % (tag, "".join(map(str, ranks)))
            res[label + ".hier"] = np.array(ps.hierarchy is not None)
            if rank in ranks:
                _run(res, label, "allreduce", lambda: hvd.allreduce(
                    torch.from_numpy(_ar_input(rank, "Sum")), op="Sum",
                    name="set", process_set=ps))
            # Adding a set is collective, and creating its groups blocks
            # the process: no rank may still need another's cycle thread.
            hvd.barrier()
            hvd.remove_process_set(ps)
    finally:
        logging.getLogger("horovod_tpu_torch").removeHandler(handler)
    res[tag + ".warnings"] = np.array(caught + [""])


def _int8_extras(hvd, rank, res):
    import torch
    from horovod_tpu_torch.ops.engine import wait_all
    # Error feedback over repeated steps of one named tensor.
    acc = np.zeros(N)
    for _ in range(EF_STEPS):
        acc += hvd.allreduce(torch.from_numpy(_ef_input(rank)), op="Sum",
                             name="ef").double().numpy()
    res["ef.mean"] = acc / EF_STEPS
    # A sub-threshold payload.
    _run(res, "small", "allreduce", lambda: hvd.allreduce(
        torch.full((64,), float(rank + 1)), op="Sum", name="small"))
    # Rounds of two named allreduces, enqueued and then waited for: the
    # round after WARM + 1 runs frozen.
    frozen = []
    for i in range(WARM + 3):
        before = (_series("fastpath_frozen_cycles_total"),
                  _counts("allreduce"))
        hs = [hvd.allreduce_async(torch.from_numpy(_ar_input(rank, "Sum")),
                                  op="Sum", name="round.%d" % k)
              for k in range(2)]
        outs = wait_all(hs)
        frozen.append(np.concatenate(
            [[_series("fastpath_frozen_cycles_total") - before[0]],
             _counts("allreduce") - before[1]]))
        res["round.%d" % i] = np.stack([o.numpy() for o in outs])
    res["round.counts"] = np.stack(frozen)


def _decoder(hvd, rank, res, tag):
    """One step of a small decoder through ``make_train_step`` (SGD):
    the loss, the reduced gradients, this rank's largest local gradient,
    then the next step's loss."""
    import torch
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      loss_fn)
    from horovod_tpu_torch.train import make_train_step, synthetic_batch
    cfg = TransformerConfig(**DECODER)
    build, shard_batch = make_train_step(
        cfg, lambda params: torch.optim.SGD(params, lr=0.1), device="cpu")
    before = _counts("broadcast")
    step, model, opt = build(init_params(cfg, seed=0))
    res[tag + ".dec.bcast"] = _counts("broadcast") - before
    data = shard_batch(synthetic_batch(cfg, DECODER_BATCH, seed=1))
    local = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p: local.__setitem__(p, p.grad.clone()))
        for p in model.parameters()]
    before = _counts("allreduce")
    opt.zero_grad()
    loss = loss_fn(model, data)
    loss.backward()
    opt.synchronize()
    res[tag + ".dec.counts"] = _counts("allreduce") - before
    for h in hooks:
        h.remove()
    res[tag + ".dec.loss0"] = np.array(loss.item())
    res[tag + ".dec.grads"] = np.concatenate(
        [p.grad.numpy().ravel() for p in model.parameters()])
    res[tag + ".dec.local"] = np.concatenate(
        [local[p].numpy().ravel() for p in model.parameters()])
    res[tag + ".dec.sizes"] = np.array([p.numel()
                                        for p in model.parameters()])
    res[tag + ".dec.wmax"] = np.array([p.detach().abs().max().item()
                                       for p in model.parameters()])
    with opt.skip_synchronize():
        opt.step()
    res[tag + ".dec.loss1"] = np.array(step(data).item())


def _worker(rank: int, port: int, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank % LOCAL),
                      LOCAL_WORLD_SIZE=str(LOCAL), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port),
                      HOROVOD_FAST_PATH_WARM_CYCLES=str(WARM))
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.process_sets import global_process_set
    res = {}
    for tag in CODECS + ("flat",):
        if tag == "flat":
            os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "off"
            os.environ.pop("HOROVOD_CROSS_HOST_COMPRESSION", None)
        else:
            os.environ["HOROVOD_CROSS_HOST_COMPRESSION"] = tag
        hvd.init(device="cpu")
        h = global_process_set.hierarchy
        res[tag + ".layout"] = np.array(
            [h.local_size, h.cross_size, h.local_rank, h.cross_rank]
            if h is not None else [])
        _ops(hvd, rank, res, tag)
        if tag == "int8":
            # Before the sets: a set's collective is a round on its
            # members only, which shifts their round count against the
            # others', and the fast path freezes only rounds that match.
            _int8_extras(hvd, rank, res)
        if tag in ("none", "int8"):
            _sets(hvd, rank, res, tag)
        if tag in ("int8", "flat"):
            _decoder(hvd, rank, res, tag)
        hvd.shutdown()
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)


# -- test side -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_port_hierarchy")
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


def _amax_sum(inputs, op):
    """What the codec's error scales with: the ranks' absmax summed for
    Sum (divided by the ranks for Average), the largest for the rest."""
    amax = [float(np.abs(x).max()) for x in inputs]
    if op == "Sum":
        return sum(amax)
    return sum(amax) / WORLD if op == "Average" else max(amax)


def _tol(codec, scale, legs):
    return legs * UNIT[codec] * scale * 1.05 + 1e-6


def _check(got, want, codec, scale, legs):
    assert got.shape == want.shape
    if codec == "none":
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_tol(codec, scale, legs))


def test_the_layout_is_two_nodes_of_two(world):
    for rank, res in enumerate(world):
        for codec in CODECS:
            assert res[codec + ".layout"].tolist() == [
                LOCAL, WORLD // LOCAL, rank % LOCAL, rank // LOCAL]
        assert res["flat.layout"].size == 0


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("op", REDUCE_OPS + ("int32",) + tuple(SCALED))
def test_allreduce_hier_against_flat(world, codec, op):
    """Every reduce op on the hierarchical path; Product and int32 never
    quantized; Average divided once, by all four ranks; a prescale on
    each rank's payload, also under Product and Max."""
    red, pre, post = SCALED.get(op, ("Sum" if op == "int32" else op, 1.0,
                                     1.0))
    inputs = [_ar_input(r, red) for r in range(WORLD)]
    scale = _amax_sum(inputs, red) * abs(pre * post)
    quant = codec in ("int8", "fp8")
    exact = codec == "none" or red == "Product" or op == "int32"
    for res in world:
        flat = res["flat.ar.%s" % op]
        _check(res["%s.ar.%s" % (codec, op)], flat,
               "none" if exact else codec, scale, 2)
        hier, flat_n, compressed = res["%s.ar.%s.counts" % (codec, op)][:3]
        assert (hier, flat_n) == (1, 0)
        assert compressed == (0 if codec == "none" or op == "int32" or
                              (quant and red == "Product") else 1)
        assert res["flat.ar.%s.counts" % op][:3].tolist() == [0, 1, 0]
    if op in ("Product.pre", "Max.neg"):
        scaled = np.stack([x * np.float32(pre) for x in inputs])
        want = scaled.prod(0) if red == "Product" else scaled.max(0)
        np.testing.assert_array_equal(world[0]["flat.ar.%s" % op], want)
    if op == "Average":
        want = sum(x.astype(np.float64) for x in inputs) / WORLD
        np.testing.assert_array_equal(world[0]["none.ar.Average"],
                                      want.astype(np.float32))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("op", ["Sum", "Average", "Max"])
def test_reducescatter_hier_against_flat(world, codec, op):
    scale = _amax_sum([_rs_input(r) for r in range(WORLD)], op)
    for rank, res in enumerate(world):
        got = res["%s.rs.%s" % (codec, op)]
        assert got.shape == ((RS_ROWS // WORLD + (rank < RS_ROWS % WORLD)),
                             5)
        _check(got, res["flat.rs.%s" % op], codec, scale, 1)
        assert res["%s.rs.%s.counts" % (codec, op)][:2].tolist() == [1, 0]


@pytest.mark.parametrize("codec", CODECS)
def test_allgather_hier_against_flat(world, codec):
    scale = _amax_sum([_ag_input(r) for r in range(WORLD)], "Max")
    for res in world:
        _check(res["%s.ag" % codec], res["flat.ag"], codec, scale, 1)
        assert res["%s.ag.counts" % codec][:2].tolist() == [1, 0]
    np.testing.assert_array_equal(
        world[0]["flat.ag"], np.concatenate([_ag_input(r)
                                             for r in range(WORLD)]))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("root", [1, 2])
def test_broadcast_hier_against_flat(world, codec, root):
    want = _bc_input() * (root + 1)
    for res in world:
        np.testing.assert_array_equal(res["flat.bc.%d" % root], want)
        _check(res["%s.bc.%d" % (codec, root)], want, codec,
               float(np.abs(want).max()), 1)
        assert res["%s.bc.%d.counts" % (codec, root)][:2].tolist() == [1, 0]
    # Every rank, the root too, holds the same (dequantized) values.
    for res in world[1:]:
        np.testing.assert_array_equal(res["%s.bc.%d" % (codec, root)],
                                      world[0]["%s.bc.%d" % (codec, root)])


@pytest.mark.parametrize("codec", CODECS)
def test_alltoall_hier_against_flat(world, codec):
    scale = _amax_sum([_a2a_input(r) for r in range(WORLD)], "Max")
    for rank, res in enumerate(world):
        want = np.concatenate([
            _a2a_input(s)[sum(_a2a_splits(s)[:rank]):
                          sum(_a2a_splits(s)[:rank + 1])]
            for s in range(WORLD)])
        np.testing.assert_array_equal(res["flat.a2a"], want)
        _check(res["%s.a2a" % codec], want, codec, scale, 1)
        assert res["%s.a2a.counts" % codec][:2].tolist() == [1, 0]


def test_wire_bytes_under_int8(world):
    """``mh_bus_bytes_total`` records wire bytes: the payload over at
    least 3.5 (the reference worker's assertion)."""
    for res in world:
        wire = res["int8.ar.Sum.counts"][3]
        assert 0 < wire <= N * 4 / 3.5
        assert res["none.ar.Sum.counts"][3] == N * 4
        assert res["fp16.ar.Sum.counts"][3] == N * 2


def test_error_feedback_mean_beats_half_the_one_step_bound(world):
    expected = sum(_ef_input(r).astype(np.float64) for r in range(WORLD))
    tol = _tol("int8", sum(r + 1.0 for r in range(WORLD)), 2)
    for res in world:
        err = np.max(np.abs(res["ef.mean"] - expected))
        assert err < tol / 2, (err, tol)


def test_sub_threshold_payload_is_flat_and_exact(world):
    for res in world:
        np.testing.assert_array_equal(res["small"], float(
            sum(r + 1 for r in range(WORLD))))
        hier, flat, compressed, _, flat_bytes = res["small.counts"]
        assert (hier, flat, compressed, flat_bytes) == (0, 1, 0, 64 * 4)


def test_frozen_round_takes_the_hierarchical_path(world):
    """The last rounds run frozen (one frozen round each, no negotiated
    allreduce), and each of their buckets went hierarchical, int8."""
    want = sum(_ar_input(r, "Sum") for r in range(WORLD))
    tol = _tol("int8", 2 * _amax_sum([_ar_input(r, "Sum")
                                      for r in range(WORLD)], "Sum"), 2)
    for res in world:
        c = res["round.counts"]  # frozen, hier, flat, compressed, ...
        assert c[-1, 0] == 1 and c[0, 0] == 0
        frozen = c[c[:, 0] == 1]
        assert np.all(frozen[:, 1] >= 1) and np.all(frozen[:, 2] == 0)
        assert np.all(frozen[:, 3] == frozen[:, 1])
        for i in range(WARM + 3):
            np.testing.assert_allclose(res["round.%d" % i],
                                       np.stack([want, want]), rtol=0,
                                       atol=tol)


def _loss_bounds(res, largest):
    """Bounds on a rank's loss moving from the flat world to the int8
    one.  ``broadcast_parameters`` rides the int8 wire as well (one plain
    pass a tensor, as the reference's data-movement ops), so before the
    step each weight of tensor t moved by at most ``amax(w_t) / 254``;
    after one SGD step at lr 0.1 by 0.1 times two int8 passes of the
    largest local gradient besides, with the step's gradient proxied by
    the first.  The roundings are independent across elements, so the
    first-order change has a standard deviation of at most
    ``sqrt(sum_i (g_i * moved_i)^2) / sqrt(3)``: the bounds are three
    times that root sum, past five deviations."""
    g = res["flat.dec.local"].astype(np.float64)
    cuts = np.cumsum(res["flat.dec.sizes"])[:-1]
    l2 = np.array([np.sum(x * x) for x in np.split(g, cuts)])
    moved = res["flat.dec.wmax"] * UNIT["int8"]
    stepped = moved + 0.1 * 2 * UNIT["int8"] * largest
    return (3 * float(np.sqrt((l2 * moved ** 2).sum())),
            3 * float(np.sqrt((l2 * stepped ** 2).sum())))


def test_decoder_step_under_int8_within_bound_of_flat(world):
    """In each world the reduced gradients against the mean of its ranks'
    local ones: flat within f32 rounding, int8 within two int8 passes of
    the largest local gradient; each rank's loss before and after the
    step within ``_loss_bounds`` of the flat world's."""
    largest = {}
    for tag in ("int8", "flat"):
        mean = sum(res[tag + ".dec.local"].astype(np.float64)
                   for res in world) / WORLD
        largest[tag] = max(float(np.abs(res[tag + ".dec.local"]).max())
                           for res in world)
        for res in world:
            if tag == "flat":
                np.testing.assert_allclose(res["flat.dec.grads"], mean,
                                           rtol=1e-5, atol=1e-7)
            else:
                np.testing.assert_allclose(
                    res["int8.dec.grads"], mean, rtol=0,
                    atol=_tol("int8", largest[tag], 2))
    for res in world:
        before, after = _loss_bounds(res, largest["int8"])
        assert abs(float(res["int8.dec.loss0"] - res["flat.dec.loss0"])) \
            <= before
        assert abs(float(res["int8.dec.loss1"] - res["flat.dec.loss1"])) \
            <= after
        hier, _, compressed = res["int8.dec.counts"][:3]
        assert hier >= 1 and compressed == hier
        assert res["flat.dec.counts"][0] == 0
        assert res["int8.dec.bcast"][2] >= 1
        assert res["flat.dec.bcast"][0] == 0


def test_process_sets(world):
    for rank, res in enumerate(world):
        for tag in ("none", "int8"):
            assert bool(res["%s.set23.hier" % tag]) == (rank in (2, 3))
            assert not bool(res["%s.set02.hier" % tag])
            assert not bool(res["%s.set012.hier" % tag])
        if rank in (2, 3):
            np.testing.assert_array_equal(
                res["none.set23"], _ar_input(2, "Sum") + _ar_input(3, "Sum"))
            assert res["none.set23.counts"][:2].tolist() == [1, 0]
        if rank in (0, 2):
            np.testing.assert_array_equal(
                res["none.set02"], _ar_input(0, "Sum") + _ar_input(2, "Sum"))
            assert res["none.set02.counts"][:2].tolist() == [0, 1]
        if rank in (0, 1, 2):
            np.testing.assert_array_equal(
                res["int8.set012"],
                sum(_ar_input(r, "Sum") for r in (0, 1, 2)))
            assert res["int8.set012.counts"][:3].tolist() == [0, 1, 0]
        # One warning for the non-homogeneous set on its members, naming
        # the codec when one is set; none for the other sets without one.
        for tag in ("none", "int8"):
            warned = [w for w in res[tag + ".warnings"] if "[0, 1, 2]" in w]
            assert len(warned) == (rank in (0, 1, 2)), warned
            assert all("stays flat" in w and "[2, 1]" in w and
                       ("int8" in w) == (tag == "int8") for w in warned)
        assert [w for w in res["none.warnings"] if w] == [
            w for w in res["none.warnings"] if "[0, 1, 2]" in w]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
