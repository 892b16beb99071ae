"""The port's wire codecs and its hierarchical allreduce against the JAX
package's, on the CPU.

* ``Int8Quantizer``, ``ScaledFP8Quantizer`` and the plain-cast
  ``FP8Compressor`` of ``horovod_tpu_torch.compression`` against
  ``horovod_tpu.jax.compression`` on the same numpy inputs from a seed,
  bit for bit: wire bytes, scales and the decompressed values, per row
  and whole, in f32, bf16 and f16, with the e4m3 overflow edge (464 ->
  448; 464.01, 465, +-inf and NaN -> NaN, which torch's own CPU cast
  saturates at 448);
* ``ErrorFeedback`` over 3 steps: wire, scales and residuals bit for bit;
  its LRU, its telescoping mean, the EF-SGD toy where plain int8 stalls
  (the counterpart of ``test_compression.py``'s);
* integer pass-through, the all-zero chunk, ``check_reduce_safe`` and
  ``DistributedOptimizer(compression=Compression.int8)``;
* the parsers of the four settings, codec resolution and the wire-codec
  choice against ``horovod_tpu.common.config`` and
  ``horovod_tpu.ops.multihost``;
* the hierarchical allreduce of one node of two ranks (a gloo world,
  this file run as a script) under int8 and fp8, over 2 steps so that
  both residuals count, against the reference's
  ``GlobalMeshCollectives().fused_allreduce`` at one process over two CPU
  devices (a subprocess: its device count is set before JAX loads).
  Rank 0 holds the reference host's payload and rank 1 zeros, so the
  local reduce-scatter hands local rank j exactly the reference's chunk
  j.  The port's Average divides by its two ranks, the one-process
  reference's by one, so Average is held to the reference's Sum
  postscaled by 0.5 (x / 2 and x * 0.5 round alike).  Outputs and the
  leg-1 residuals bit for bit; the leg-2 residual within one f32 ulp of
  its operands a step for each multiply-add that XLA on the CPU may
  contract into a fused one (the dequantize ``q * s`` into the reduction
  and the residual's add, ``r * postscale + residual`` when postscaled,
  ``rc - q2 * s2``; as ``test_torch_port_adasum.py`` allows for the
  scale-sum), summed over the steps, since a step's residual enters the
  next.  The reference's leg-2 scale is ``absmax * (1 / top)`` (XLA folds
  the division by a constant into its compiled leg), and the port's is
  computed so, which keeps the outputs bit for bit;
* the reducescatter (Sum and Average through error feedback over 2
  steps, Min and Max), allgather, broadcast and alltoall legs of the
  same node under int8 and fp8 against the reference's, outputs and the
  reducescatter's residuals bit for bit (``LEG_ROWS`` x ``LEG_COLS`` is
  its own power-of-two size class in the reference, so its local chunks
  are the halves the port's ranks hold);
* the same cases at two nodes (slow: the reference's two processes
  joined by ``jax.distributed`` against a 2 x 2 gloo world), where the
  cross leg's per-sender scales and slices are no longer identities.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch import compression as pc
from horovod_tpu_torch.common import config as pconf
from horovod_tpu_torch.ops import multihost as pmh

if __name__ != "__main__":
    # The reference side; the spawned ranks need only torch.
    import jax.numpy as jnp

    from horovod_tpu.common import config as jconf
    from horovod_tpu.jax import compression as jc
    from horovod_tpu.ops import multihost as jmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 120
CODECS = ("int8", "fp8")
STEPS = 2
N_AR = 1001  # two local chunks of 501, the last padded
# (label, port op, pre, post, reference op, pre, post)
AR_CASES = (("sum", "Sum", 1.0, 1.0, "Sum", 1.0, 1.0),
            ("average", "Average", 1.0, 1.0, "Sum", 1.0, 0.5),
            ("scaled", "Sum", 0.5, 3.0, "Sum", 0.5, 3.0))
OPS = ("Sum", "Average", "Min", "Max", "Product")
# The other four legs at one node: LEG_ROWS x LEG_COLS f32 is its own
# power-of-two size class in the reference, so its two local chunks are
# the halves that the port's two ranks hold.
LEG_ROWS, LEG_COLS = 256, 4
HALF = LEG_ROWS // 2
# (label, leg, port op, reference op, steps); Average is held to the
# reference's Sum times 0.5, as for the allreduce.
LEG_CASES = (("rs.sum", "reducescatter", "Sum", "Sum", 2),
             ("rs.average", "reducescatter", "Average", "Sum", 2),
             ("rs.min", "reducescatter", "Min", "Min", 1),
             ("rs.max", "reducescatter", "Max", "Max", 1),
             ("ag", "allgather", None, None, 1),
             ("bc", "broadcast", None, None, 1),
             ("a2a", "alltoall", None, None, 1))
FP8_EDGE = np.array([464.0, 464.01, 465.0, 1e6, -464.0, -464.01, -465.0,
                     -1e6, np.inf, -np.inf, np.nan, 448.0, -448.0, 0.0,
                     -0.0, 1e-10, 2.0 ** -10, 240.0, 1.0 / 3],
                    np.float32)
# What the reference's cast gives them (the test reads it too).
FP8_EDGE_BYTES = [0x7E, 0x7F, 0x7F, 0x7F, 0xFE, 0xFF, 0xFF, 0xFF, 0x7F,
                  0xFF, 0x7F, 0x7E, 0xFE, 0x00, 0x80, 0x00, 0x00, 0x77,
                  0x2B]
DTYPES = {"float32": (torch.float32, "float32"),
          "bfloat16": (torch.bfloat16, "bfloat16"),
          "float16": (torch.float16, "float16")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=0):
    """Normal values over many binades, a row of zeros when 2-D."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0 ** rng.randint(-12, 12, shape)).astype(
        np.float32)
    if len(shape) > 1:
        x[1] = 0.0
    return x


def _pair(x: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array of ``dtype``
    (rounded once, by torch, so both hold the same bits)."""
    t = torch.from_numpy(x).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][1])


def _bytes_of(wire) -> np.ndarray:
    """A wire tensor or array as its raw bytes."""
    if isinstance(wire, torch.Tensor):
        return wire.contiguous().view(torch.uint8).numpy().ravel()
    return np.asarray(wire).view(np.uint8).ravel()


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _same(got, want):
    """Bit for bit, but a NaN matches any NaN (the decoders' NaN payload
    bits differ; the wire bytes are held exactly)."""
    g, w = _f32(got), _f32(want)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(g)
    np.testing.assert_array_equal(g[ok].view(np.uint32),
                                  w[ok].view(np.uint32))


# -- the codecs ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4097,), (4, 1025), (3, 7, 11)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("codec", ["Int8Quantizer", "ScaledFP8Quantizer"])
def test_quantizers_match_jax_bit_for_bit(codec, dtype, shape):
    t, j = _pair(_inputs(shape), dtype)
    wire, (scale, back_dtype) = getattr(pc, codec).compress(t)
    jwire, (jscale, _) = getattr(jc, codec).compress(j)
    assert wire.dtype == {"Int8Quantizer": torch.int8,
                          "ScaledFP8Quantizer": torch.float8_e4m3fn}[codec]
    assert back_dtype == t.dtype and wire.shape == t.shape
    np.testing.assert_array_equal(_bytes_of(wire), _bytes_of(jwire))
    assert tuple(scale.shape) == tuple(np.shape(jscale))
    _same(scale, jscale)
    back = getattr(pc, codec).decompress(wire, (scale, back_dtype))
    assert back.dtype == t.dtype
    _same(back, getattr(jc, codec).decompress(jwire, (jscale, j.dtype)))


def test_plain_fp8_cast_matches_jax_at_the_overflow_edge():
    """torch's CPU cast gives 448 past +-464 and for infinities; the port
    gives NaN with the value's sign, as the reference's ``astype`` does."""
    t = torch.from_numpy(FP8_EDGE)
    wire, ctx = pc.FP8Compressor.compress(t)
    jwire, _ = jc.FP8Compressor.compress(jnp.asarray(FP8_EDGE))
    assert _bytes_of(wire).tolist() == FP8_EDGE_BYTES
    np.testing.assert_array_equal(_bytes_of(wire), _bytes_of(jwire))
    assert ctx == torch.float32
    # torch's own CPU cast saturates where the reference's gives NaN.
    assert t.to(torch.float8_e4m3fn).view(torch.uint8)[1].item() == 0x7E
    back = pc.FP8Compressor.decompress(wire, ctx)
    _same(back, np.asarray(jc.FP8Compressor.decompress(
        jwire, jnp.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_fp8_cast_matches_jax_over_many_binades(dtype):
    t, j = _pair(_inputs((8192,), seed=3) * 64.0, dtype)
    wire, _ = pc.FP8Compressor.compress(t)
    jwire, _ = jc.FP8Compressor.compress(j)
    np.testing.assert_array_equal(_bytes_of(wire), _bytes_of(jwire))


def test_scaled_fp8_is_in_range_where_the_plain_cast_is_nan():
    x = np.linspace(-5000.0, 5000.0, 513, dtype=np.float32)
    assert torch.isnan(pc.FP8Compressor.compress(
        torch.from_numpy(x))[0].float()).any()
    q, ctx = pc.ScaledFP8Quantizer.compress(torch.from_numpy(x))
    d = pc.ScaledFP8Quantizer.decompress(q, ctx).numpy()
    assert np.all(np.isfinite(d))
    assert np.all(np.abs(d - x) <= np.abs(x) * 0.07 + 2.0)


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_all_zero_chunk_roundtrips(codec):
    quant = pc.Int8Quantizer if codec == "int8" else pc.ScaledFP8Quantizer
    x = torch.zeros(3, 64)
    q, ctx = quant.compress(x)
    assert torch.equal(ctx[0], torch.full((3, 1), 1.0 / {
        "int8": 127.0, "fp8": pc.E4M3_MAX}[codec]))
    assert torch.equal(quant.decompress(q, ctx), x)


@pytest.mark.parametrize("codec", ["Int8Quantizer", "FP8Compressor",
                                   "ScaledFP8Quantizer"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.bool])
def test_integer_payloads_ride_untouched(codec, dtype):
    x = torch.arange(16).to(dtype)
    q, ctx = getattr(pc, codec).compress(x)
    assert q is x and ctx is None
    assert getattr(pc, codec).decompress(q, ctx) is x
    ef = pc.ErrorFeedback(getattr(pc, codec))
    q, ctx = ef.compress(x, bucket="i")
    assert q is x and ctx is None and not ef._residuals


# -- error feedback ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec", ["Int8Quantizer", "ScaledFP8Quantizer"])
def test_error_feedback_matches_jax_over_three_steps(codec, dtype):
    ef = pc.ErrorFeedback(getattr(pc, codec))
    jef = jc.ErrorFeedback(getattr(jc, codec))
    for step in range(3):
        t, j = _pair(_inputs((4, 513), seed=10 + step), dtype)
        wire, (scale, back) = ef.compress(t, bucket="b")
        jwire, (jscale, _) = jef.compress(j, bucket="b")
        assert back == t.dtype
        np.testing.assert_array_equal(_bytes_of(wire), _bytes_of(jwire))
        _same(scale, jscale)
        _same(ef._residuals["b"], jef._residuals["b"])
        assert ef._residuals["b"].dtype == torch.float32
        assert ef.decompress(wire, (scale, back)).dtype == t.dtype


def test_error_feedback_residual_telescopes():
    x = torch.linspace(-1.0, 1.0, 512)
    ef = pc.ErrorFeedback(pc.Int8Quantizer)
    acc = torch.zeros(512, dtype=torch.float64)
    steps = 32
    for _ in range(steps):
        q, ctx = ef.compress(x, bucket="t")
        acc += ef.decompress(q, ctx).double()
    assert (acc / steps - x.double()).abs().max() < 2 * (1.0 / 254) / steps \
        + 1e-7


def test_error_feedback_lru_cap():
    ef = pc.ErrorFeedback(pc.Int8Quantizer, max_buckets=3)
    for i in range(8):
        ef.compress(torch.ones(4) * (i + 1), bucket=("b", i))
    assert list(ef._residuals) == [("b", 5), ("b", 6), ("b", 7)]
    ef.reset()
    assert not ef._residuals


def test_error_feedback_recovers_quadratic_optimum_plain_int8_stalls():
    """``test_compression.py:165``'s toy: two workers' gradients are
    +-b + (w - c)/2 beside a pin that fixes the int8 scale at 0.1, so the
    useful half-gradient rounds away on every plain step and w never
    moves; error feedback accumulates it until it fires."""
    d = 16
    c = np.linspace(0.02, 0.08, d).astype(np.float32)
    pin, b, lr, steps = np.float32(12.7), np.full(d, 6.0, np.float32), \
        0.02, 400

    def run(use_ef):
        efs = [pc.ErrorFeedback(pc.Int8Quantizer) for _ in range(2)]
        w = np.zeros(d, np.float32)
        for _ in range(steps):
            g = (w - c) / 2.0
            total = np.zeros(d, np.float32)
            for i, sign in enumerate((1.0, -1.0)):
                vec = torch.from_numpy(np.concatenate(
                    [[pin], sign * b + g]).astype(np.float32))
                q, ctx = (efs[i].compress(vec, bucket="g") if use_ef
                          else pc.Int8Quantizer.compress(vec))
                total += pc.Int8Quantizer.decompress(q, ctx).numpy()[1:]
            w = w - lr * total
        return w

    w_plain, w_ef = run(False), run(True)
    np.testing.assert_array_equal(w_plain, np.zeros(d, np.float32))
    assert np.max(np.abs(w_ef - c)) < 0.01
    assert np.max(np.abs(w_ef - c)) < 0.2 * np.max(np.abs(w_plain - c))


# -- the reduce-safe check -----------------------------------------------------

def test_quantizers_are_refused_by_summing_brackets():
    import horovod_tpu_torch as hvd
    p = torch.nn.Parameter(torch.zeros(3))
    assert pc.Compression.int8 is pc.Int8Quantizer
    assert pc.Compression.fp8 is pc.FP8Compressor
    for codec in (pc.Compression.int8, pc.Compression.fp8,
                  pc.ErrorFeedback(pc.Int8Quantizer)):
        assert codec.reduce_safe is False
        with pytest.raises(ValueError,
                           match="HOROVOD_CROSS_HOST_COMPRESSION"):
            pc.check_reduce_safe(codec, "allreduce_gradients")
        with pytest.raises(ValueError,
                           match="HOROVOD_CROSS_HOST_COMPRESSION"):
            hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                     compression=codec)
    for codec in (pc.Compression.none, pc.Compression.fp16,
                  pc.Compression.bf16, pc.ErrorFeedback(pc.FP16Compressor)):
        pc.check_reduce_safe(codec, "test")
    assert jc.Compression.int8.reduce_safe is pc.Compression.int8.reduce_safe


# -- settings, codec resolution, the wire codec --------------------------------

@pytest.mark.parametrize("value", [None, "", "none", "OFF", "0", "fp16",
                                   "float16", "bf16", "BFloat16", "INT8",
                                   "fp8", "int4", "zfp"])
def test_parse_compression_matches_the_reference(value):
    try:
        want = jconf._parse_compression(value)
    except ValueError:
        with pytest.raises(ValueError, match="CROSS_HOST_COMPRESSION"):
            pconf._parse_compression(value)
        return
    assert pconf._parse_compression(value) == want


@pytest.mark.parametrize("value", [None, "", "auto", "1", "on", "YES",
                                   "0", "off", "false", "sometimes"])
def test_parse_hier_mode_matches_the_reference(value):
    try:
        want = jconf._parse_hier_mode(value)
    except ValueError:
        with pytest.raises(ValueError, match="HIERARCHICAL_ALLREDUCE"):
            pconf._parse_hier_mode(value)
        return
    assert pconf._parse_hier_mode(value) == want


def test_config_reads_the_four_settings(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            monkeypatch.delenv(k)
    cfg = pconf.Config.from_env()
    want = jconf.Config()
    assert (cfg.hierarchical_allreduce, cfg.hierarchical_allreduce_threshold,
            cfg.cross_host_compression, cfg.compression_residual_buckets) \
        == (want.hierarchical_allreduce,
            want.hierarchical_allreduce_threshold,
            want.cross_host_compression, want.compression_residual_buckets)
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "on")
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD", "4096")
    monkeypatch.setenv("HVD_TPU_CROSS_HOST_COMPRESSION", "INT8")
    monkeypatch.setenv("HOROVOD_CROSS_HOST_COMPRESSION", "bf16")
    monkeypatch.setenv("HOROVOD_COMPRESSION_RESIDUAL_BUCKETS", "0")
    cfg = pconf.Config.from_env()
    assert (cfg.hierarchical_allreduce, cfg.hierarchical_allreduce_threshold,
            cfg.cross_host_compression, cfg.compression_residual_buckets) \
        == ("on", 4096, "int8", 1)
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD", "64K")
    with pytest.raises(ValueError, match="HIERARCHICAL_ALLREDUCE_THRESHOLD"):
        pconf.Config.from_env()


@pytest.mark.parametrize("name", ["none", "fp16", "bf16", "int8", "fp8"])
def test_codec_resolution_matches_the_reference(name):
    got, want = pmh._resolve_codec(name), jmh._resolve_codec(name)
    if want is None:
        assert got is None
        return
    assert (got.name, got.kind, got.wire.itemsize) == (
        want.name, want.kind, want.wire.itemsize)
    with pytest.raises(ValueError):
        pmh._resolve_codec("zfp")


def _hier(codec):
    return pmh.Hierarchy(None, None, [[0, 1]], 0, 0,
                         codec=pmh._resolve_codec(codec))


@pytest.mark.parametrize("codec", ["fp16", "bf16", "int8", "fp8"])
def test_wire_codec_choice_matches_the_reference(codec):
    import types
    ref = types.SimpleNamespace(_codec=jmh._resolve_codec(codec))
    h = _hier(codec)
    for tdt, ndt in ((torch.float32, np.float32), (torch.float16, np.float16),
                     (torch.int32, np.int32), (torch.int8, np.int8)):
        for op in OPS + (None,):
            got = h.wire_codec(tdt, op)
            want = jmh.GlobalMeshCollectives._wire_codec(ref, ndt, op)
            assert (got is None) == (want is None), (tdt, op)
            assert got is None or got is h.codec


def test_gate_and_wire_bytes():
    h = _hier("int8")
    assert not h.eligible(0) and not h.eligible(65535) and h.eligible(65536)
    h.mode = "on"
    assert h.eligible(4) and not h.eligible(0)
    assert h.wire_nbytes(h.codec, 1000) == 1000 + 8
    assert _hier("bf16").wire_nbytes(pmh._resolve_codec("bf16"), 1000) \
        == 2000


def test_layouts():
    nodes = [0, 0, 2, 2, 4, 4, 4]
    assert pmh.layout([0, 1, 2, 3], nodes) == ([[0, 1], [2, 3]], "")
    assert pmh.layout([0, 2], nodes) == (None, "")
    grid, why = pmh.layout([0, 1, 2], nodes)
    assert grid is None and "[2, 1]" in why
    grid, why = pmh.layout([4, 5, 6], nodes)
    assert grid == [[4, 5, 6]] and why == ""
    grid, why = pmh.layout([0, 1, 2, 3], [0, 1, 0, 1])
    assert grid is None and "node by node" in why


# -- p nodes of two ranks against the reference's GlobalMeshCollectives -------
#
# The reference runs p processes of two CPU devices (one process, or two
# joined by jax.distributed), the port p nodes of two ranks.  Host c's
# payload sits on the port's rank (c, 0), with what leaves a reduction
# unchanged on (c, 1), or, for the allgather, split between the two as
# the reference's local chunks.

def _payload(codec, label, step, host, shape, p):
    """Host ``host``'s payload.  At two nodes the reference's compiled
    cross leg contracts the dequantize ``q * s`` into the sum of the
    senders' contributions (XLA on the CPU), which a step of rounding
    apart could flip in a requantize.  So there each block of ``_block``
    elements, and so each quantized row, gets an absmax of 127 * 448 /
    1024 times a power of two that differs by host and block: every
    scale is then a short binary fraction, every dequantized value and
    every sum of two exact, and a sender's scale applied to another's
    values is off by a power of two."""
    labels = [c[0] for c in AR_CASES + LEG_CASES]
    rng = np.random.RandomState(
        [CODECS.index(codec), labels.index(label), step, host])
    n = int(np.prod(shape))
    x = (rng.randn(n) * np.exp(rng.uniform(-3, 3, n))).astype(np.float32)
    if p > 1:
        blk = _block(label, p)
        for i, lo in enumerate(range(0, n, blk)):
            b = x[lo:lo + blk]
            top = np.float32(127 * 448 / 1024 * 2.0 ** -((3 * host + i) % 4))
            m = int(np.abs(b).argmax())
            b *= top / np.abs(b[m])
            np.clip(b, -top, top, out=b)
            b[m] = np.copysign(top, b[m])
    return x.reshape(shape)


def _block(label, p):
    """Elements of one quantized row's part: a local chunk of the
    allreduce, half of a block of rows for the other legs."""
    if label in [c[0] for c in AR_CASES]:
        return -(-(-(-N_AR // 2)) // p) * p
    return HALF * LEG_COLS


def _steps(steps, p):
    """Two steps carry the residuals at one node; at two, an error-fed
    second step's scales are no longer short fractions (``_payload``)."""
    return steps if p == 1 else 1


def _leg_shape(leg, p):
    """Rows a host holds: one 1024-element segment a member for the
    reducescatter, a block a destination for the alltoall."""
    rows = LEG_ROWS * (p if leg in ("reducescatter", "alltoall") else 1)
    return rows, LEG_COLS


def _local_rows(arr) -> np.ndarray:
    """This process's rows of a reference array sharded over (proc,
    local) as [size, k, n]: [k, n]."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[1].start)
    return np.concatenate([np.asarray(s.data).reshape(1, -1)
                           for s in shards])


def _reference(out: str, p: int, proc: int, port: int):
    """The JAX side, process ``proc`` of ``p``, two CPU devices each; run
    as ``python this_file.py ref OUT P PROC PORT``."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    if p > 1:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(coordinator_address="127.0.0.1:%d" % port,
                                   num_processes=p, process_id=proc)
    from horovod_tpu.ops.multihost import GlobalMeshCollectives
    res = {}
    for codec in CODECS:
        os.environ["HOROVOD_CROSS_HOST_COMPRESSION"] = codec
        mc = GlobalMeshCollectives()
        assert (mc.size, mc.local_size, mc.my_idx, mc._codec.name) == (
            p, 2, proc, codec)
        for label, _, _, _, op, pre, post in AR_CASES:
            if label == "average":
                post = 1.0 / (2 * p)
            for step in range(_steps(STEPS, p)):
                x = _payload(codec, label, step, proc, (N_AR,), p)
                o = mc.fused_allreduce([x], [N_AR], np.float32, op, pre,
                                       post, names=[label])[0]
                res["%s.%s.%d" % (codec, label, step)] = np.asarray(o)
            (key,) = [kk for kk in mc._ef._residuals if kk[-1] == label]
            res["%s.%s.res1" % (codec, label)] = np.asarray(
                mc._ef._residuals[key])
            res["%s.%s.res2" % (codec, label)] = _local_rows(mc._res2[key])
        for label, leg, _, op, steps in LEG_CASES:
            for step in range(_steps(steps, p)):
                x = _payload(codec, label, step, proc, _leg_shape(leg, p), p)
                if leg == "reducescatter":
                    o = mc.reducescatter(x, op, name=label)
                elif leg == "allgather":
                    o = mc.allgather(x, [LEG_ROWS] * p)
                elif leg == "broadcast":
                    o = mc.broadcast(x if proc == p - 1 else np.zeros_like(x),
                                     p - 1)
                else:
                    o = mc.alltoall(x, np.full((p, p), LEG_ROWS))[0]
                res["%s.%s.%d" % (codec, label, step)] = np.asarray(o)
            if op in ("Sum", "Average"):
                (key,) = [kk for kk in mc._ef._residuals
                          if kk[0] == "reducescatter" and kk[-1] == label]
                res["%s.%s.res1" % (codec, label)] = np.asarray(
                    mc._ef._residuals[key])
    np.savez(os.path.join(out, "reference%d.npz" % proc), **res)
    if p > 1:
        jax.distributed.shutdown()


def _port_rank(rank: int, p: int, port: int, out: str):
    """The port side, rank ``rank`` of p nodes of two; run as
    ``python this_file.py port RANK P PORT OUT``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(2 * p),
                      LOCAL_RANK=str(rank % 2), LOCAL_WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      HOROVOD_HIERARCHICAL_ALLREDUCE="on")
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.process_sets import global_process_set
    host, j = divmod(rank, 2)
    res = {}
    for codec in CODECS:
        os.environ["HOROVOD_CROSS_HOST_COMPRESSION"] = codec
        hvd.init(device="cpu")
        h = global_process_set.hierarchy
        assert (h.local_size, h.cross_size, h.codec.name) == (2, p, codec)
        for label, op, pre, post, _, _, _ in AR_CASES:
            for step in range(_steps(STEPS, p)):
                x = torch.from_numpy(
                    _payload(codec, label, step, host, (N_AR,), p))
                res["%s.%s.%d" % (codec, label, step)] = hvd.allreduce(
                    torch.zeros_like(x) if j else x, name=label, op=op,
                    prescale_factor=pre, postscale_factor=post).numpy()
            (key,) = [k for k in h.ef._residuals if k[-1] == label]
            res["%s.%s.res1" % (codec, label)] = h.ef._residuals[key].numpy()
            res["%s.%s.res2" % (codec, label)] = h._res2[key].numpy()
        for label, leg, op, _, steps in LEG_CASES:
            for step in range(_steps(steps, p)):
                x = torch.from_numpy(_payload(codec, label, step, host,
                                              _leg_shape(leg, p), p))
                if leg == "reducescatter":
                    if j:
                        x = torch.full_like(x, {"Min": np.inf,
                                                "Max": -np.inf}.get(op, 0.0))
                    o = hvd.reducescatter(x, op=op, name=label)
                elif leg == "allgather":
                    o = hvd.allgather(x[j * HALF:(j + 1) * HALF], name=label)
                elif leg == "broadcast":
                    root = 2 * (p - 1)
                    o = hvd.broadcast(x if rank == root
                                      else torch.zeros_like(x), root,
                                      name=label)
                else:
                    # (c, 0) sends host c's block for node d as its two
                    # halves, one to each of d's ranks; (c, 1) sends none.
                    o = hvd.alltoall(x[:0] if j else x,
                                     splits=[0 if j else HALF] * (2 * p),
                                     name=label)[0]
                res["%s.%s.%d" % (codec, label, step)] = o.numpy()
            if op in ("Sum", "Average"):
                (key,) = [k for k in h.ef._residuals
                          if k[0] == "reducescatter" and k[-1] == label]
                res["%s.%s.res1" % (codec, label)] = \
                    h.ef._residuals[key].numpy()
        hvd.shutdown()
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    for k in list(env):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            del env[k]
    env.update(extra)
    return env


def _worlds(out, p: int):
    """Run the reference's p processes and the port's 2p ranks at once:
    ([reference results by process], [port results by rank]).

    The port's ranks meet at a store this process hosts on a port the OS
    picks while binding it, which every rank joins as a client (torch's
    agent-store convention, ``TORCHELASTIC_USE_AGENT_STORE``): a port
    found free and bound later by rank 0 could be taken in between by
    another world on the machine, and a rank would then meet the wrong
    store or none.  The reference's coordinator (two nodes only) still
    binds a port found free."""
    me = os.path.abspath(__file__)
    store = torch.distributed.TCPStore("127.0.0.1", 0, is_master=True,
                                       wait_for_workers=False)
    port = store.port
    ref_port = _free_port() if p > 1 else 0
    xla = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split()
                   if "device_count" not in f)
    ref_env = _clean_env(
        JAX_PLATFORMS="cpu", HOROVOD_HIERARCHICAL_ALLREDUCE="on",
        XLA_FLAGS=(xla + " --xla_force_host_platform_device_count=2")
        .strip())
    procs = [subprocess.Popen([sys.executable, me, "ref", str(out), str(p),
                               str(c), str(ref_port)], env=ref_env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in range(p)]
    procs += [subprocess.Popen([sys.executable, me, "port", str(r), str(p),
                                str(port), str(out)],
                               env=_clean_env(
                                   TORCHELASTIC_USE_AGENT_STORE="True"),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT)
              for r in range(2 * p)]
    logs = []
    try:
        deadline = time.monotonic() + SPAWN_TIMEOUT * p
        for proc in procs:
            logs.append(proc.communicate(
                timeout=max(1, deadline - time.monotonic()))[0].decode(
                    errors="replace"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        del store
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-4000:]
    return ([dict(np.load(out / ("reference%d.npz" % c))) for c in range(p)],
            [dict(np.load(out / ("rank%d.npz" % r))) for r in range(2 * p)])


@pytest.fixture(scope="module")
def one_node(tmp_path_factory):
    return _worlds(tmp_path_factory.mktemp("torch_port_codecs"), 1)


def _check_allreduce(worlds, codec, label):
    """Every rank's outputs and leg-1 residuals bit for bit; the leg-2
    residual within one f32 ulp of its operands a step for each
    multiply-add that XLA contracts."""
    refs, ranks = worlds
    p = len(refs)
    steps = _steps(STEPS, p)
    for step in range(steps):
        key = "%s.%s.%d" % (codec, label, step)
        for rank, res in enumerate(ranks):
            assert res[key].shape == (N_AR,)
            _same(res[key], refs[rank // 2][key])
    chunk = _block(label, p)
    outs = np.zeros((steps, 2 * chunk), np.float32)
    for step in range(steps):
        outs[step, :N_AR] = refs[0]["%s.%s.%d" % (codec, label, step)]
    for rank, res in enumerate(ranks):
        host, j = divmod(rank, 2)
        ref = refs[host]
        # Local rank j holds row j of the reference's [k, chunk] residual.
        _same(res["%s.%s.res1" % (codec, label)][0],
              ref["%s.%s.res1" % (codec, label)][j])
        got = res["%s.%s.res2" % (codec, label)]
        want = ref["%s.%s.res2" % (codec, label)][j]
        assert got.shape == want.shape == (chunk // p,)
        # XLA may contract up to three multiply-adds a step, each within
        # one ulp of its operands: the dequantize q * s into the sum and
        # the residual's add, rc = r * postscale + residual when
        # postscaled by other than a power of two, and rc - q2 * s2 (q2 *
        # s2 is that step's output, rc it plus the residual); a step's
        # residual enters the next step's rc.  Cross rank c's slice of
        # the chunk is its leg-2 slice.
        lo = j * chunk + host * (chunk // p)
        operands = np.abs(outs[:, lo:lo + chunk // p]) + np.abs(got)
        contracted = 3 if label == "scaled" else 2
        ulps = contracted * (np.float32(2.0) ** (np.floor(np.log2(
            np.maximum(operands, np.float32(2.0 ** -126)))) - 23)).sum(0)
        assert np.all(np.abs(got - want) <= ulps)


def _check_legs(worlds, codec, label):
    """The reducescatter, allgather, broadcast and alltoall legs: outputs
    (a host's two ranks' rows together where each holds a part) and the
    reducescatter's leg-1 residuals, rank (c, j) holding process c's
    local chunk j, bit for bit."""
    refs, ranks = worlds
    p = len(refs)
    _, leg, op, _, steps = [c for c in LEG_CASES if c[0] == label][0]
    for step in range(_steps(steps, p)):
        key = "%s.%s.%d" % (codec, label, step)
        for host, ref in enumerate(refs):
            want = ref[key] * np.float32(1.0 / (2 * p) if op == "Average"
                                         else 1.0)
            mine = ranks[2 * host:2 * host + 2]
            if leg == "reducescatter":
                assert want.shape == (LEG_ROWS, LEG_COLS)
                _same(np.concatenate([res[key] for res in mine]), want)
            elif leg == "alltoall":
                # Rank (d, j) holds half j of every host's block for d.
                halves = want.reshape(p, 2, HALF, LEG_COLS)
                for j, res in enumerate(mine):
                    _same(res[key], halves[:, j].reshape(-1, LEG_COLS))
            else:
                assert want.shape == (
                    (p if leg == "allgather" else 1) * LEG_ROWS, LEG_COLS)
                for res in mine:
                    _same(res[key], want)
    if op in ("Sum", "Average"):
        for rank, res in enumerate(ranks):
            host, j = divmod(rank, 2)
            got = res["%s.%s.res1" % (codec, label)]
            assert got.shape == (1, p * HALF * LEG_COLS)
            _same(got[0], refs[host]["%s.%s.res1" % (codec, label)][j])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("label", [c[0] for c in AR_CASES])
def test_one_node_hier_allreduce_matches_the_reference(one_node, codec,
                                                       label):
    _check_allreduce(one_node, codec, label)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("label", [c[0] for c in LEG_CASES])
def test_one_node_hier_legs_match_the_reference(one_node, codec, label):
    _check_legs(one_node, codec, label)


@pytest.mark.slow
def test_two_nodes_hier_collectives_match_the_reference(tmp_path):
    """Two nodes: the reference's two processes joined by
    jax.distributed against the port's 2 x 2 gloo world, every case of
    the one-node tests for one step, on ``_payload``'s exact inputs
    (slow: JAX's distributed runtime; run it by node id)."""
    worlds = _worlds(tmp_path, 2)
    for codec in CODECS:
        for label in [c[0] for c in AR_CASES]:
            _check_allreduce(worlds, codec, label)
        for label in [c[0] for c in LEG_CASES]:
            _check_legs(worlds, codec, label)


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _reference(sys.argv[2], *map(int, sys.argv[3:6]))
    else:
        _port_rank(*map(int, sys.argv[2:5]), sys.argv[5])
