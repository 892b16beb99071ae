"""The port's Adasum against the JAX package's, on the CPU.

* ``scale_sum_plain`` (the scale-sum kernel's plain version) against the
  JAX ``fused_scale_sum`` in Pallas interpret mode;
* ``adasum_pair`` and ``adasum_reduce_stacked`` against
  ``horovod_tpu.utils.adasum`` on numpy inputs from a seed, with the
  traps: all-zero inputs stay finite, identical inputs collapse to one
  copy, the pair is symmetric bit for bit, a bf16 or f16 payload is
  rounded back every round, and a count that is not a power of two is
  rejected;
* one 4-rank gloo world (this file run as a script, spawned once), which
  covers strides 2 and 1: the process-per-rank Adasum allreduce of f32,
  bf16 and f16 payloads, pre- and post-scaled, grouped and async,
  ``DistributedOptimizer(op=Adasum)`` with and without groups and with
  the fp16 wire, and one step of a small BERT through
  ``make_bert_train_step(op=Adasum)`` held against the JAX BERT's
  per-shard gradients reduced by the JAX ``adasum_reduce_stacked``.

Tolerances: f32 results within rtol 1e-5, atol 1e-6 (the limit of the
JAX package's own Adasum test, ``test_collectives.py``): the dot products
are summed in another order.  bf16 and f16 within one unit in the last
place of the dtype per round of the tree, the rounding of the cast back
that a coefficient moved by an f32 ulp may flip.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import scale_sum as ss
from horovod_tpu_torch.utils import adasum as pa

if __name__ != "__main__":
    # The reference side.  The spawned ranks run this file as a script
    # and need only torch, so they skip importing JAX.
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.models import bert as jb
    from horovod_tpu.ops.pallas_kernels import fused_scale_sum
    from horovod_tpu.utils import adasum as ja

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DTYPES = ("float32", "bfloat16", "float16")
MANTISSA = {"float32": 23, "bfloat16": 7, "float16": 10}
MIN_EXP = {"float32": -126, "bfloat16": -126, "float16": -14}
F32_RTOL, F32_ATOL = 1e-5, 1e-6
PRE, POST = 0.5, 3.0
# The small BERT of the card's model check, 8 rows of seq 128, 2 a rank.
BERT_SIZES = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                  d_ff=1024, max_seq=128)
BERT_BATCH, BERT_SEQ = 8, 128
# Each reduced gradient leaf's relative norm error, stated before the first
# run: the per-shard gradients agree to about 1e-6 relative in f32 (the
# readings of test_torch_port_bert.py, whose limit is 1e-4) and Adasum is
# smooth in them, so about 1e-5 is expected; the limit is that file's
# 1e-4.  bk's gradient is zero in exact arithmetic: its reduced norm is
# held to this share of bq's.
BERT_LEAF, BK_NOISE = 1e-4, 1e-4
OPT_GROUPS = (0, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _jax(t: torch.Tensor):
    """The same values in JAX (bf16 and f16 widen to f32 exactly)."""
    return jnp.asarray(t.float().numpy()).astype(str(t.dtype).split(".")[1])


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(got, want, dtype: str, scale=None) -> np.ndarray:
    """|got - want| in units of the dtype's last place at the larger of
    the two magnitudes (and of ``scale``'s)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    if scale is not None:
        mag = np.maximum(mag, np.abs(scale))
    exp = np.floor(np.log2(np.maximum(mag, 2.0 ** MIN_EXP[dtype])))
    ulp = 2.0 ** (np.maximum(exp, MIN_EXP[dtype]) - MANTISSA[dtype])
    return np.abs(got - want) / ulp


def _assert_close(got, want, dtype: str, rounds: int = 1):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        assert _ulps(got, want, dtype).max() <= rounds


# -- the scale-sum kernel's plain version ------------------------------------

@pytest.mark.parametrize("shape", [(3, 50), (1,), (4097,), (4096 * 128 + 1,)],
                         ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_scale_sum_plain_matches_pallas_interpret(dtype, shape):
    """Within one ulp of the output dtype at the scale of the larger
    product, and mostly bit for bit: both widen to f32 and round alpha
    and beta to f32, but XLA on the CPU contracts the interpreted
    kernel's alpha * a + beta * b into a fused multiply-add (one rounding
    of a product fewer), which the port's two rounded multiplies and one
    rounded add do not.  Where the sum cancels, that rounding is many
    ulps of the small result, hence the products' scale.  (The reading:
    f32 one ulp off in 6-9% of the elements, bf16 and f16 in at most
    0.7%; never more than one ulp at that scale.)"""
    rng = np.random.RandomState(sum(shape))
    a = _torch(rng.randn(*shape), dtype)
    b = _torch(3 * rng.randn(*shape), dtype)
    alpha, beta = 0.3, -1.7  # neither exact in f32
    got = ss.scale_sum_plain(a, b, alpha, beta)
    want = fused_scale_sum(_jax(a), _jax(b), alpha=alpha, beta=beta)
    assert got.dtype == a.dtype and tuple(got.shape) == shape
    assert str(want.dtype) == dtype
    terms = np.maximum(np.abs(np.float32(alpha) * a.float().numpy()),
                       np.abs(np.float32(beta) * b.float().numpy()))
    off = _ulps(got.float().numpy(), _np(want), dtype, terms)
    assert off.max() <= 1, off.max()
    assert np.mean(off > 0) < 0.2


def test_scale_sum_takes_device_coefficients():
    """Coefficients as one-element f32 tensors give the same bits as the
    same values as floats; a Python float is rounded to f32 first."""
    rng = np.random.RandomState(1)
    a, b = (torch.from_numpy(rng.randn(257).astype(np.float32))
            for _ in range(2))
    coef = torch.tensor([0.1, 0.7])
    got = ss.scale_sum_plain(a, b, coef[0], coef[1])
    want = ss.scale_sum_plain(a, b, 0.1, 0.7)
    assert torch.equal(got, want)
    exact = (a.double() * 0.1 + b.double() * 0.7).float()
    assert not torch.equal(got, exact)
    with pytest.raises(ValueError, match="both as floats or both"):
        ss.scale_sum_plain(a, b, coef[0], 0.7)
    with pytest.raises(ValueError, match="one dtype"):
        ss.scale_sum_plain(a, b.double())


def test_scale_sum_kernel_raises_on_cpu_tensors():
    """The CUDA wrapper raises on a CPU tensor instead of computing, and
    counts no launch; the dispatcher takes the plain version for CPU
    tensors only."""
    ss.reset_launch_counts()
    a = torch.ones(9)
    for call in (lambda: ss.scale_sum_kernel(a, a, 0.5, 2.0),
                 lambda: ss.scale_sum_kernel(a.half(), a.half())):
        with pytest.raises(ValueError, match="CUDA kernel"):
            call()
    assert ss.launch_counts() == {"scale_sum_kernel": 0}
    assert torch.equal(ss.fused_scale_sum(a, 2 * a, 0.5, 2.0),
                       ss.scale_sum_plain(a, 2 * a, 0.5, 2.0))
    assert ss.launch_counts() == {"scale_sum_kernel": 0}


# -- adasum_pair and the stacked tree ------------------------------------------

def _pair_inputs(case: str, n: int = 1000):
    rng = np.random.RandomState(7)
    a = rng.randn(n).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    return {"random": (a, b),
            "zeros": (np.zeros(n, np.float32), np.zeros(n, np.float32)),
            "identical": (a, a.copy()),
            "opposite": (a, -a),
            "scaled": (a, 1000 * b),
            "one_zero": (a, np.zeros(n, np.float32))}[case]


@pytest.mark.parametrize("case", ["random", "zeros", "identical", "opposite",
                                  "scaled", "one_zero"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_adasum_pair_matches_jax(dtype, case):
    a, b = (_torch(x, dtype) for x in _pair_inputs(case))
    got = pa.adasum_pair(a, b)
    want = ja.adasum_pair(_jax(a), _jax(b))
    assert got.dtype == a.dtype
    _assert_close(got.float().numpy(), _np(want), dtype)
    if case == "zeros":
        # The 1e-30 floor: ca = cb = 1 and a zero result, not NaN.
        assert torch.equal(got, torch.zeros_like(a))
    if case == "identical":
        # ca = cb = 1/2: one copy.
        assert torch.equal(got, a)


@pytest.mark.parametrize("dtype", DTYPES)
def test_adasum_pair_is_symmetric_bit_for_bit(dtype):
    """Partners of the process-per-rank tree merge the same two vectors
    in either order; they must end with the same bits."""
    rng = np.random.RandomState(3)
    for n in (1, 7, 1000, 65537):
        a = _torch(rng.randn(n), dtype)
        b = _torch(0.3 * rng.randn(n), dtype)
        assert torch.equal(pa.adasum_pair(a, b), pa.adasum_pair(b, a)), n


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_adasum_reduce_stacked_matches_jax(dtype, n):
    stacked = _torch(np.random.RandomState(n).randn(n, 3, 41), dtype)
    got = pa.adasum_reduce_stacked(stacked)
    want = ja.adasum_reduce_stacked(_jax(stacked))
    assert got.dtype == stacked.dtype and got.shape == (3, 41)
    _assert_close(got.float().numpy(), _np(want), dtype,
                  rounds=max(1, n.bit_length() - 1))


def test_low_precision_payload_is_rounded_back_every_round():
    """The tree casts each round's merge back to bf16: the same tree in
    f32 with one cast at the end is another result, and the port equals
    the per-round form bit for bit."""
    stacked = _torch(np.random.RandomState(11).randn(4, 513), "bfloat16")
    got = pa.adasum_reduce_stacked(stacked)
    rows = list(stacked)
    while len(rows) > 1:  # per round, cast back
        rows = [pa.adasum_pair(rows[i], rows[i + len(rows) // 2])
                for i in range(len(rows) // 2)]
    once = pa.adasum_reduce_stacked(stacked.float()).bfloat16()
    assert torch.equal(got, rows[0])
    assert not torch.equal(got, once)
    want = ja.adasum_reduce_stacked(_jax(stacked))
    assert _ulps(got.float().numpy(), _np(want), "bfloat16").max() <= 2


def test_power_of_two_is_required():
    from horovod_tpu_torch.common.process_sets import ProcessSet
    from horovod_tpu_torch.ops.collectives import adasum_allreduce
    for n in (3, 6):
        with pytest.raises(ValueError, match="power-of-two"):
            pa.adasum_reduce_stacked(torch.ones(n, 4))
        with pytest.raises(ValueError, match="power-of-two"):
            ja.adasum_reduce_stacked(np.ones((n, 4), np.float32))
    # The process-per-rank form checks the set's size before any exchange.
    with pytest.raises(ValueError, match="power-of-two"):
        adasum_allreduce(torch.ones(4), process_set=ProcessSet([0, 1, 2]))
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        adasum_allreduce(torch.ones(4, dtype=torch.int32))


# -- the 4-rank gloo world ---------------------------------------------------------

def _payloads():
    """Rank-major stacked inputs [WORLD, ...]: two payloads of one shape
    (back to back, so that a receive buffer left unwritten would hold the
    first one's bytes), a ragged length and a scale spread."""
    rng = np.random.RandomState(0)
    return {"x": rng.randn(WORLD, 5, 7).astype(np.float32),
            "y": rng.randn(WORLD, 5, 7).astype(np.float32),
            "z": (rng.randn(WORLD, 33) *
                  np.array([[0.1], [1.0], [10.0], [3.0]])).astype(np.float32)}


def _opt_inputs():
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32),
              "v": rng.randn(5).astype(np.float32)}
    grads = {k: rng.randn(WORLD, *v.shape).astype(np.float32)
             for k, v in params.items()}
    return params, grads


def _opt_step(params, grads, rank, groups, compression=None):
    """SGD(0.1) through DistributedOptimizer(op=Adasum) -> the updated
    parameters and the reduced gradients."""
    import horovod_tpu_torch as hvd
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(list(ps.values()), lr=0.1), op=hvd.Adasum,
        num_groups=groups,
        compression=compression or hvd.Compression.none)
    loss = sum((p * torch.from_numpy(grads[k][rank])).sum()
               for k, p in ps.items())
    loss.backward()
    opt.step()
    out = {}
    for k, p in ps.items():
        out["param." + k] = p.detach().numpy().copy()
        out["grad." + k] = p.grad.numpy().copy()
    return out


def _worker(rank: int, port: int, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.bert import BertConfig
    from horovod_tpu_torch.models.convert_bert import (init_params,
                                                       tree_from_module)
    from horovod_tpu_torch.train import (make_bert_train_step,
                                         synthetic_bert_batch)
    hvd.init(device="cpu")
    res = {}
    x = _payloads()
    for dtype in DTYPES:
        for key in ("x", "y", "z"):
            t = _torch(x[key][rank], dtype)
            res["%s.%s" % (key, dtype)] = hvd.allreduce(
                t, op=hvd.Adasum).float().numpy()
        res["scaled.%s" % dtype] = hvd.allreduce(
            _torch(x["z"][rank], dtype), op=hvd.Adasum, prescale_factor=PRE,
            postscale_factor=POST).float().numpy()
    group = [_torch(x["x"][rank], "float32"), _torch(x["z"][rank], "bfloat16")]
    h = hvd.grouped_allreduce_async(group, op=hvd.Adasum)
    for key, t in zip(("group.x", "group.z"), hvd.synchronize(h)):
        res[key] = t.float().numpy()
    res["group.z_dtype"] = np.array(str(t.dtype))
    res["async.y"] = hvd.synchronize(hvd.allreduce_async(
        _torch(x["y"][rank], "float32"), op=hvd.Adasum)).numpy()

    params, grads = _opt_inputs()
    for groups in OPT_GROUPS:
        for k, v in _opt_step(params, grads, rank, groups).items():
            res["opt%d.%s" % (groups, k)] = v
    for k, v in _opt_step(params, grads, rank, 0,
                          hvd.Compression.fp16).items():
        res["fp16.%s" % k] = v

    cfg = BertConfig(**BERT_SIZES, dtype="float32")
    build, shard = make_bert_train_step(
        cfg, lambda ps: torch.optim.AdamW(ps, lr=5e-5, weight_decay=0.01),
        op=hvd.Adasum, device="cpu")
    step, model, opt = build(init_params(cfg, seed=2))
    batch = synthetic_bert_batch(cfg, BERT_BATCH, BERT_SEQ, seed=2)
    res["bert.loss"] = step(shard(batch)).numpy()
    tree = tree_from_module(model, grads=True)
    for k, v in tree.items():
        if k != "layers":
            res["bert.grad." + k] = v
    for k, v in tree["layers"].items():
        res["bert.grad.layers." + k] = v
    res["bert.with_grad"] = np.array(sorted(
        n for n, p in model.named_parameters() if p.grad is not None))
    hvd.shutdown()
    np.savez(out, **res)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_port_adasum")
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


def _same_on_every_rank(ranks, key):
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[key], ranks[0][key], err_msg=key)
    return ranks[0][key]


@pytest.mark.parametrize("key", ["x", "y", "z"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_adasum_allreduce_matches_the_stacked_tree(ranks, dtype, key):
    """Every rank ends with the same bits, those of the port's stacked
    tree on the same inputs, within the stated tolerance of the JAX
    tree."""
    got = _same_on_every_rank(ranks, "%s.%s" % (key, dtype))
    stacked = _torch(_payloads()[key], dtype)
    np.testing.assert_array_equal(
        got, pa.adasum_reduce_stacked(stacked).float().numpy())
    _assert_close(got, _np(ja.adasum_reduce_stacked(_jax(stacked))), dtype,
                  rounds=2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_adasum_allreduce_pre_and_post_scale(ranks, dtype):
    """x * pre (the factor in the payload dtype), the tree, then * post."""
    got = _same_on_every_rank(ranks, "scaled.%s" % dtype)
    stacked = _torch(_payloads()["z"], dtype)
    pre = torch.tensor(PRE).to(stacked.dtype)
    post = torch.tensor(POST).to(stacked.dtype)
    want = _np(ja.adasum_reduce_stacked(_jax(stacked * pre)))
    want = (torch.from_numpy(want.copy()).to(stacked.dtype)
            * post).float().numpy()
    _assert_close(got, want, dtype, rounds=3)


def test_grouped_and_async_adasum_reduce_each_tensor_alone(ranks):
    """A grouped Adasum allreduce merges each entry with its own dot
    products, in its own dtype; the async form gives the sync result."""
    x = _payloads()
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "group.x"),
                                  ranks[0]["x.float32"])
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "group.z"),
                                  ranks[0]["z.bfloat16"])
    assert str(ranks[0]["group.z_dtype"]) == "torch.bfloat16"
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "async.y"),
                                  ranks[0]["y.float32"])
    # Merged as one packed vector, the entries would be another result.
    packed = np.concatenate([x["x"].reshape(WORLD, -1),
                             x["z"].reshape(WORLD, -1)], 1)
    merged = _np(ja.adasum_reduce_stacked(packed))[:35].reshape(5, 7)
    assert np.abs(merged - ranks[0]["group.x"]).max() > 1e-3


@pytest.mark.parametrize("groups", OPT_GROUPS)
def test_distributed_optimizer_adasum_matches_jax(ranks, groups):
    """Hooks and groups as for Average, each gradient reduced alone by
    Adasum; against the JAX tree on the same gradients followed by the
    same SGD step."""
    params, grads = _opt_inputs()
    for k in params:
        want_g = _np(ja.adasum_reduce_stacked(grads[k]))
        got_g = _same_on_every_rank(ranks, "opt%d.grad.%s" % (groups, k))
        _assert_close(got_g, want_g, "float32")
        got_p = _same_on_every_rank(ranks, "opt%d.param.%s" % (groups, k))
        np.testing.assert_allclose(got_p, params[k] - 0.1 * want_g,
                                   rtol=F32_RTOL, atol=F32_ATOL)


def test_distributed_optimizer_adasum_fp16_wire(ranks):
    """With Compression.fp16 each gradient is merged in f16 (dots in f32,
    each round cast back to f16) and widened after: the port's stacked
    tree on the f16 gradients bit for bit, the JAX tree within an f16
    ulp per round."""
    _, grads = _opt_inputs()
    for k, g in grads.items():
        got = _same_on_every_rank(ranks, "fp16.grad.%s" % k)
        half = _torch(g, "float16")
        np.testing.assert_array_equal(
            got, pa.adasum_reduce_stacked(half).float().numpy())
        _assert_close(got, _np(ja.adasum_reduce_stacked(_jax(half))),
                      "float16", rounds=2)


def _jax_shard_grads(batch):
    """The JAX BERT's classification gradients of each rank's rows (its
    plain attention), as numpy trees."""
    from horovod_tpu_torch.models.convert_bert import init_params
    from horovod_tpu_torch.models.bert import BertConfig
    cfg = jb.BertConfig(**BERT_SIZES, dtype="float32")
    tree = init_params(BertConfig(**BERT_SIZES, dtype="float32"), seed=2)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    specs = jb.param_specs(cfg)
    bspec = {"tokens": P("dp", None), "labels": P("dp")}
    grad = jax.jit(jax.shard_map(
        lambda p, b: jax.grad(lambda p_: jb.classification_loss(p_, b, cfg))(p),
        mesh=mesh, in_specs=(specs, bspec), out_specs=specs, check_vma=True))
    per = BERT_BATCH // WORLD
    return [jax.tree.map(np.asarray, grad(tree, {
        "tokens": batch["tokens"][r * per:(r + 1) * per].astype(np.int32),
        "labels": batch["labels"][r * per:(r + 1) * per].astype(np.int32)}))
        for r in range(WORLD)]


def _tree64(stacked: np.ndarray) -> np.ndarray:
    """The Adasum halving tree in float64: the exact result to within
    f64 rounding, against which both f32 trees are read."""
    rows = [r.astype(np.float64).ravel() for r in stacked]
    while len(rows) > 1:
        half = len(rows) // 2
        merged = []
        for a, b in zip(rows[:half], rows[half:]):
            dot = a @ b
            merged.append((1 - dot / max(2 * (a @ a), 1e-30)) * a
                          + (1 - dot / max(2 * (b @ b), 1e-30)) * b)
        rows = merged
    return rows[0].reshape(stacked.shape[1:])


def test_bert_adasum_step_matches_jax(ranks, monkeypatch):
    """The slice as a whole: ``make_bert_train_step(op=Adasum)`` on four
    gloo ranks, one step of the small BERT (f32; 2 rows a rank).  Each
    parameter's reduced gradient, on every rank, against the JAX BERT's
    per-shard gradients of the same rows reduced one parameter (one
    layer's slice of a stacked leaf) at a time, as the port's
    per-parameter hooks reduce them: by the Adasum tree in float64 within
    BERT_LEAF relative norm error, and by the JAX ``adasum_reduce_stacked``
    within BERT_LEAF beyond that function's own distance from the float64
    tree.  (XLA on the CPU sums an f32 ``vdot`` of 262,144 terms to about
    2e-4 of its value, so the JAX f32 tree reads up to 2.3e-4 from the f64
    tree on the FFN weights, where the port's reads 8e-8.)  bk's reduced
    gradient, noise on both sides, within BK_NOISE of bq's norm.  The MLM
    head, which the loss does not reach, has no gradient and is not
    reduced."""
    from horovod_tpu_torch.models import bert as pb
    from horovod_tpu_torch.models.bert import BertConfig
    from horovod_tpu_torch.train import synthetic_bert_batch
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "0")
    batch = synthetic_bert_batch(BertConfig(**BERT_SIZES), BERT_BATCH,
                                 BERT_SEQ, seed=2)
    shards = _jax_shard_grads(batch)
    with_grad = set(ranks[0]["bert.with_grad"])
    assert not any(n.startswith("mlm") for n in with_grad)
    assert len(with_grad) == len(pb.TOP_KEYS) - 5 + 16 * 2
    errors = {}

    def hold(name, got, stacked):
        exact = _tree64(stacked)
        jax_tree = _np(ja.adasum_reduce_stacked(stacked))
        norm = np.linalg.norm(exact)
        err = np.linalg.norm(got - exact) / norm
        jax_own = np.linalg.norm(jax_tree - exact) / norm
        beyond = np.linalg.norm(got - jax_tree) / norm - jax_own
        errors[name] = (err, beyond)

    for k in pb.TOP_KEYS:
        got = _same_on_every_rank(ranks, "bert.grad." + k)
        if k in with_grad:
            hold(k, got, np.stack([g[k] for g in shards]))
        else:
            assert not got.any(), k
    for k in pb.LAYER_KEYS:
        got = _same_on_every_rank(ranks, "bert.grad.layers." + k)
        for i in range(BERT_SIZES["n_layers"]):
            if k == "bk":
                bq = np.linalg.norm(ranks[0]["bert.grad.layers.bq"][i])
                assert np.linalg.norm(got[i]) <= BK_NOISE * bq
                continue
            hold("layers.%d.%s" % (i, k), got[i],
                 np.stack([g["layers"][k][i] for g in shards]))
    for which in (0, 1):
        worst = max(errors, key=lambda n: errors[n][which])
        assert errors[worst][which] <= BERT_LEAF, (which, worst,
                                                   errors[worst])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
