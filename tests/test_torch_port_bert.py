"""The port's BERT against the JAX package's ``horovod_tpu.models.bert``,
at a tiny configuration (vocab 64, d 32, 2 layers, 4 heads of 8, d_ff 64,
seq 64, batch 2, 3 classes).

The JAX side runs inside a one-device (dp 1, tp 1) ``shard_map``, as
``make_finetune_step`` builds it; with ``HOROVOD_FLASH_ATTENTION=1`` its
unmasked attention is the Pallas non-causal flash kernel in interpret
mode, with ``=0`` its plain path.  The port runs its flash autograd
function on the plain kernel versions (the two-pass or the one-pass
backward, by ``HVD_TPU_FLASH_BWD``, which the JAX side reads too).  Both
get the same numpy tree, whose gains and biases are perturbed from their
initial ones and zeros so that every affine term counts.

One 2-rank gloo world (spawned once) holds the MLM loss's global
normalisation over uneven masked counts and a
``DistributedOptimizer(compression=fp16, num_groups=3)`` step.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch.models import bert as pb
from horovod_tpu_torch.models.convert_bert import (init_params,
                                                   params_from_jax,
                                                   tree_from_module)

if __name__ != "__main__":
    # The reference side.  The spawned ranks run this file as a script
    # and need only torch, so they skip importing JAX.
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.models import bert as jb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_seq=128, n_classes=3)
BATCH, SEQ = 2, 64
# f32 on both sides: summation order only.  Readings (four cases): hidden
# at most 5.7e-7 of its largest value, losses 1.8e-7, leaves 9.4e-7.
F32_HIDDEN, F32_LOSS, F32_LEAF = 1e-5, 1e-5, 1e-4
# bf16 on both sides: the frameworks round in different places (XLA's
# bf16 GELU rounds op by op, torch's once; the port's flash casts P to
# bf16 before P @ V where JAX's plain path keeps f32).  Readings: hidden
# at most 1.2% of its largest value, losses 1.3e-3, leaves 1.7%.
BF16_HIDDEN, BF16_LOSS, BF16_LEAF = 3e-2, 1e-2, 5e-2
# The gradient of bk is zero in exact arithmetic (a per-query constant
# added to every score leaves the softmax as it is): both sides hold
# rounding noise, held to this share of bq's gradient norm (readings
# 8.1e-7 in f32, 7.7e-3 in bf16).
BK_NOISE = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    """The port's init_params tree with gains near 1 and biases near 0."""
    tree = init_params(pb.BertConfig(**SIZES), seed=seed)
    rng = np.random.RandomState(seed + 100)

    def perturb(a, gain):
        noise = 0.3 * rng.randn(*a.shape).astype(np.float32)
        return (1 + noise) if gain else noise

    for key in pb.TOP_KEYS:
        if key.endswith(("_g", "_b", "bias")):
            tree[key] = perturb(tree[key], key.endswith("_g"))
    for key in pb.LAYER_KEYS:
        if key.startswith("b") or key.endswith(("_g", "_b")):
            tree["layers"][key] = perturb(tree["layers"][key],
                                          key.endswith("_g"))
    return tree


def _batch(seed=0, mask=False, rows=BATCH):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, SIZES["vocab_size"], (rows, SEQ)).astype(np.int32)
    mlm_mask = (rng.rand(rows, SEQ) < 0.15).astype(np.int32)
    mlm_mask[:, 0] = 1
    out = {"tokens": tokens, "targets": tokens.copy(), "mlm_mask": mlm_mask,
           "labels": rng.randint(0, SIZES["n_classes"], (rows,))
           .astype(np.int32)}
    if mask:
        pad = np.ones((rows, SEQ), np.int32)
        pad[:, SEQ * 3 // 4:] = 0  # right padding
        out["mask"] = pad
    return out


def _torch_batch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _jax_reference(dtype, tree, batch):
    """(hidden, cls loss, cls grads, mlm loss, mlm grads) of the JAX
    model on a one-device (dp, tp) mesh."""
    cfg = jb.BertConfig(**SIZES, dtype=dtype)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    bspec = {k: P("dp") if k == "labels" else P("dp", None) for k in batch}
    specs = jb.param_specs(cfg)

    def run(p, b):
        hidden = jb.encode(p, b["tokens"], cfg, None, b.get("mask"))
        lc, gc = jax.value_and_grad(
            lambda p_: jb.classification_loss(p_, b, cfg))(p)
        lm, gm = jax.value_and_grad(lambda p_: jb.mlm_loss(p_, b, cfg))(p)
        return hidden, lc, gc, lm, gm

    f = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=(specs, bspec),
        out_specs=(P("dp", None, None), P(), specs, P(), specs),
        check_vma=True))
    return _np(f(tree, batch))


def _port(dtype, tree, batch):
    """The same five outputs from the port on the CPU."""
    cfg = pb.BertConfig(**SIZES, dtype=dtype)
    tb = _torch_batch(batch)
    out = [params_from_jax(tree, cfg, "cpu").encode(
        tb["tokens"], None, tb.get("mask")).detach().float().numpy()]
    for loss_fn in (pb.classification_loss, pb.mlm_loss):
        model = params_from_jax(tree, cfg, "cpu")
        loss = loss_fn(model, tb)
        loss.backward()
        out += [loss.item(), tree_from_module(model, grads=True)]
    return out


def _leaves(tree):
    out = {k: np.asarray(tree[k]) for k in pb.TOP_KEYS}
    out.update({"layers." + k: np.asarray(tree["layers"][k])
                for k in pb.LAYER_KEYS})
    return out


def _errors(got, want):
    """hidden error (max |err| over max |want|), the two losses' relative
    errors, and each objective's per-leaf relative gradient norm errors
    (bk apart: its noise norms over bq's gradient norm)."""
    h_err = np.abs(got[0] - want[0]).max() / np.abs(want[0]).max()
    loss_err = [abs(got[i] - want[i]) / abs(want[i]) for i in (1, 3)]
    leaf_err, bk_noise = [], []
    for g, w in ((got[2], want[2]), (got[4], want[4])):
        g, w = _leaves(g), _leaves(w)
        leaf_err.append({k: np.linalg.norm(g[k] - w[k]) / np.linalg.norm(w[k])
                         for k in w if k != "layers.bk"
                         and np.linalg.norm(w[k]) > 0})
        # Leaves the objective does not reach are zero on both sides.
        for k in w:
            if not np.linalg.norm(w[k]) > 0:
                assert not np.any(g[k]), k
        ref = np.linalg.norm(w["layers.bq"])
        bk_noise.append(max(np.linalg.norm(g["layers.bk"]),
                            np.linalg.norm(w["layers.bk"])) / ref)
    return h_err, loss_err, leaf_err, bk_noise


@pytest.fixture(scope="module")
def tree():
    return _tree()


def _set_attention(monkeypatch, case):
    """case: "plain" (JAX plain attention), "flash" and "flash_onepass"
    (JAX Pallas flash; two-pass or one-pass backward on both sides) or
    "mask" (a padding mask: the additive-bias path on both sides)."""
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION",
                       "1" if case.startswith("flash") else "0")
    monkeypatch.setenv("HVD_TPU_FLASH_BWD",
                       "pallas_onepass" if case == "flash_onepass"
                       else "pallas")
    return _batch(mask=case == "mask")


@pytest.mark.parametrize("case", ["plain", "flash", "flash_onepass", "mask"])
def test_f32_encode_losses_and_grads_match_jax(monkeypatch, tree, case):
    batch = _set_attention(monkeypatch, case)
    h_err, loss_err, leaf_err, bk_noise = _errors(
        _port("float32", tree, batch), _jax_reference("float32", tree, batch))
    assert h_err <= F32_HIDDEN, h_err
    assert max(loss_err) <= F32_LOSS, loss_err
    for errs in leaf_err:
        worst = max(errs, key=errs.get)
        assert errs[worst] <= F32_LEAF, (worst, errs[worst])
    assert max(bk_noise) <= BK_NOISE["float32"], bk_noise


@pytest.mark.parametrize("case", ["flash", "flash_onepass", "mask"])
def test_bf16_losses_and_grads_match_jax(monkeypatch, tree, case):
    batch = _set_attention(monkeypatch, case)
    h_err, loss_err, leaf_err, bk_noise = _errors(
        _port("bfloat16", tree, batch),
        _jax_reference("bfloat16", tree, batch))
    assert h_err <= BF16_HIDDEN, h_err
    assert max(loss_err) <= BF16_LOSS, loss_err
    for errs in leaf_err:
        worst = max(errs, key=errs.get)
        assert errs[worst] <= BF16_LEAF, (worst, errs[worst])
    assert max(bk_noise) <= BK_NOISE["bfloat16"], bk_noise


# -- the traps: each wrong choice fails the bound its test holds ------------

def _bf16_layer_norm_mismatch(layer_norm):
    """Share of elements where ``layer_norm`` on bf16 activations differs
    from the JAX ``layer_norm``, and the largest difference in bf16 ulps
    of the JAX value."""
    rng = np.random.RandomState(3)
    x = (2 * rng.randn(512, 64) + 0.5).astype(np.float32)
    g = (1 + 0.3 * rng.randn(64)).astype(np.float32)
    b = (0.3 * rng.randn(64)).astype(np.float32)
    want = np.asarray(jb.layer_norm(jnp.asarray(x, jnp.bfloat16), g, b,
                                    1e-12), np.float32)
    got = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(g),
                     torch.from_numpy(b), 1e-12).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return (got != want).mean(), (np.abs(got - want) / ulp).max()


# The bf16 layer_norm bound: at most 0.1% of elements off, by at most one
# ulp (reading: none of 32,768 off).
LN_MISMATCH, LN_ULPS = 1e-3, 1.0


def _f32_layer_norm(x, g, b, eps):
    """torch's own: the affine in f32, one rounding."""
    return F.layer_norm(x.float(), x.shape[-1:], g.float(), b.float(),
                        eps).to(x.dtype)


def test_layer_norm_rounds_as_jax_in_bf16():
    share, ulps = _bf16_layer_norm_mismatch(pb.layer_norm)
    assert share <= LN_MISMATCH and ulps <= LN_ULPS, (share, ulps)


def test_f32_affine_layer_norm_fails_the_bf16_bound():
    share, ulps = _bf16_layer_norm_mismatch(_f32_layer_norm)
    assert share > 100 * LN_MISMATCH, share  # reading: 46%


def test_gelu_is_jax_tanh_gelu():
    """In f32 the port's GELU is ``jax.nn.gelu`` to 2e-6 (reading 1e-6);
    torch's default erf GELU is 4.7e-4 away."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = pb.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 2e-6
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_erf_gelu_fails_the_model_bound(monkeypatch, tree):
    """bf16 cannot see erf against tanh: their difference (at most 4.7e-4)
    is below bf16's resolution, and the JAX bf16 GELU, which rounds op by
    op, already differs from torch's tanh GELU on about 40% of elements.
    The whole model in f32 sees it: the hidden error reads 2.1e-4 under
    erf, 20x F32_HIDDEN (5.7e-7 under tanh)."""
    batch = _set_attention(monkeypatch, "plain")
    want = _jax_reference("float32", tree, batch)
    monkeypatch.setattr(pb, "gelu", F.gelu)
    h_err, _, _, _ = _errors(_port("float32", tree, batch), want)
    assert h_err > 10 * F32_HIDDEN, h_err


# -- conversion, data and the training step ---------------------------------

def test_init_params_has_the_jax_layout_and_distributions():
    cfg = pb.BertConfig(**SIZES)
    ref = _np(jb.init_params(jax.random.PRNGKey(0),
                             jb.BertConfig(**SIZES)))
    got = init_params(cfg, seed=0)
    assert jax.tree.structure(ref) == jax.tree.structure(got)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(got)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if not a.std():  # gains at one, biases at zero, on both sides
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:  # normal / sqrt(fan_in): same scale within sampling error
            assert abs(b.std() / a.std() - 1) < 0.2, path


def test_params_from_jax_round_trips(tree):
    model = params_from_jax(tree, pb.BertConfig(**SIZES), "cpu")
    back = tree_from_module(model)
    for k, v in _leaves(tree).items():
        np.testing.assert_array_equal(_leaves(back)[k], v, err_msg=k)
    assert model.layers[1].w_in.shape == tree["layers"]["w_in"].shape[1:]
    # The MLM decoder is the word embedding: no parameter of its own.
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for v in _leaves(tree).values())


def test_synthetic_bert_batch():
    from horovod_tpu_torch.train import synthetic_bert_batch
    cfg = pb.BertConfig(**SIZES)
    cls = synthetic_bert_batch(cfg, 8, 96, seed=1)
    assert set(cls) == {"tokens", "labels"}
    assert cls["tokens"].shape == (8, 96) and cls["labels"].shape == (8,)
    assert cls["labels"].max() < cfg.n_classes
    mlm = synthetic_bert_batch(cfg, 8, 96, seed=1, objective="mlm")
    assert (mlm["mlm_mask"].sum(1) >= 1).all()
    assert 0.08 < mlm["mlm_mask"].mean() < 0.25
    np.testing.assert_array_equal(mlm["targets"], mlm["tokens"])
    with pytest.raises(ValueError, match="objective"):
        synthetic_bert_batch(cfg, 2, 8, objective="nsp")


@pytest.fixture
def cpu_world():
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_one_adamw_step_matches_jax(tree, cpu_world, monkeypatch):
    """``make_bert_train_step`` (1-rank gloo world) against
    ``make_finetune_step`` with ``optax.adamw`` at the same hyper-
    parameters, f32, one classification step.  AdamW's first step moves a
    weight by about lr * sign(g) (5e-5), and where g is within a few
    orders of eps the f32 summation order moves that, hence 2e-6
    absolute (4% of the step).  bk's gradient is rounding noise on both
    sides (zero in exact arithmetic), so its step is left out.  torch
    leaves a parameter without a gradient (the MLM head here) alone,
    where optax decays it by lr * wd (5e-7 of its value): inside 2e-6."""
    from horovod_tpu_torch.train import make_bert_train_step
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "0")
    lr, wd = 5e-5, 0.01
    batch = {k: v for k, v in _batch(seed=4).items()
             if k in ("tokens", "labels")}
    jcfg = jb.BertConfig(**SIZES, dtype="float32")
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    build, shard = jb.make_finetune_step(
        jcfg, mesh, optax.adamw(lr, weight_decay=wd), donate=False)
    step, params, opt_state = build(tree)
    params, _, loss_jax = step(params, opt_state, shard(batch))

    cfg = pb.BertConfig(**SIZES, dtype="float32")
    build, shard = make_bert_train_step(
        cfg, lambda ps: torch.optim.AdamW(ps, lr, weight_decay=wd),
        num_groups=3, device="cpu")
    step, model, opt = build(tree)
    assert len(opt._groups) == 3
    loss = step(shard(batch))
    np.testing.assert_allclose(loss.item(), float(loss_jax), rtol=1e-5)
    got, want = _leaves(tree_from_module(model)), _leaves(_np(params))
    for k in want:
        if k != "layers.bk":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-6,
                                       err_msg=k)


# -- two gloo ranks: global MLM normalisation and the fp16 wire --------------

# Rank 0 takes rows 0-1 with every position masked, rank 1 rows 2-3 with
# one masked position a row: 128 against 2 masked.
MLM_ROWS = 4


def _uneven_mlm_batch():
    batch = _batch(seed=7, rows=MLM_ROWS)
    mlm_mask = np.zeros((MLM_ROWS, SEQ), np.int32)
    mlm_mask[:2] = 1
    mlm_mask[2:, 5] = 1
    batch["mlm_mask"] = mlm_mask
    return batch


def _worker(rank: int, port: int, tree_path: str, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    with np.load(tree_path) as f:
        flat = dict(f)
    tree = {k: flat[k] for k in pb.TOP_KEYS}
    tree["layers"] = {k: flat["layers." + k] for k in pb.LAYER_KEYS}
    cfg = pb.BertConfig(**SIZES, dtype="float32")
    rows = slice(2 * rank, 2 * rank + 2)
    results = {}

    # 1. mlm_loss on this rank's rows, gradients averaged by the optimizer.
    batch = _torch_batch({k: v[rows] for k, v in _uneven_mlm_batch().items()})
    model = params_from_jax(tree, cfg, "cpu")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0),
                                   named_parameters=model.named_parameters())
    loss = pb.mlm_loss(model, batch)
    loss.backward()
    opt.synchronize()
    results["mlm_loss"] = loss.detach().numpy()
    for k, v in _leaves(tree_from_module(model, grads=True)).items():
        results["mlm_grad." + k] = v

    # 2. One SGD step with fp16 compression over 3 groups, and the same
    # step by hand: compress, Sum over the ranks, Average in f32,
    # decompress.
    batch = _torch_batch({k: v[rows] for k, v in _batch(seed=8, rows=4)
                          .items() if k in ("tokens", "labels")})
    local = params_from_jax(tree, cfg, "cpu")
    pb.classification_loss(local, batch).backward()
    wires = {}
    for name, p in local.named_parameters():
        if p.grad is None:
            continue
        wire = p.grad.half()
        both = [torch.empty_like(wire) for _ in range(2)]
        dist.all_gather(both, wire)
        total = (both[0].float() + both[1].float()).half()
        wires[name] = (total.float() / 2).half().float()
        with torch.no_grad():
            p.add_(wires[name], alpha=-0.1)
    model = params_from_jax(tree, cfg, "cpu")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1),
                                   named_parameters=model.named_parameters(),
                                   compression=hvd.Compression.fp16,
                                   num_groups=3)
    seen, all_reduce = [], dist.all_reduce

    def record(tensor, *args, **kwargs):
        seen.append(str(tensor.dtype))
        return all_reduce(tensor, *args, **kwargs)

    dist.all_reduce = record
    try:
        pb.classification_loss(model, batch).backward()
        opt.step()
    finally:
        dist.all_reduce = all_reduce
    results["wire_dtypes"] = np.array(seen)
    results["step_max_diff"] = np.array(max(
        (p - q).abs().max().item() for p, q in zip(model.parameters(),
                                                   local.parameters())))

    # 3. Integer tensors ride the fp16 wire untouched.
    ints = torch.arange(5, dtype=torch.int64) * (rank + 1)
    wire, ctx = hvd.Compression.fp16.compress(ints)
    reduced = hvd.Compression.fp16.decompress(
        hvd.allreduce(wire, op=hvd.Sum), ctx)
    results["ints"] = reduced.numpy()
    results["ints_ctx_none"] = np.array(wire is ints and ctx is None)
    hvd.shutdown()
    np.savez(out, **results)


@pytest.fixture(scope="module")
def two_ranks(tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bert2")
    flat = {k: tree[k] for k in pb.TOP_KEYS}
    flat.update({"layers." + k: tree["layers"][k] for k in pb.LAYER_KEYS})
    np.savez(tmp / "tree.npz", **flat)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]), HVD_TPU_FLASH_BWD="pallas")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         str(tmp / "tree.npz"), str(tmp / ("rank%d.npz" % r))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
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
    out = []
    for r in range(2):
        with np.load(tmp / ("rank%d.npz" % r)) as f:
            out.append(dict(f))
    return out


def test_two_rank_mlm_gradient_is_the_global_batch_gradient(
        two_ranks, tree, monkeypatch):
    """Ranks masking 128 and 2 positions: each rank's loss is size *
    num_rank / den_global, so the Average of their gradients is the JAX
    gradient of the global batch (numerator and denominator summed
    before the division) and the mean of their losses its loss.  f32."""
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "0")
    batch = _uneven_mlm_batch()
    _, _, _, loss_jax, grads_jax = _jax_reference("float32", tree, batch)
    np.testing.assert_allclose(np.mean([r["mlm_loss"] for r in two_ranks]),
                               loss_jax, rtol=F32_LOSS)
    want = _leaves(grads_jax)
    for r in two_ranks:
        for k, w in want.items():
            g = r["mlm_grad." + k]
            if k == "layers.bk":
                assert np.linalg.norm(g) <= BK_NOISE["float32"] * \
                    np.linalg.norm(want["layers.bq"])
                continue
            assert np.linalg.norm(g - w) <= F32_LEAF * np.linalg.norm(w), k
    # Per-rank means, averaged, are another gradient: the test can see it.
    counts = batch["mlm_mask"].reshape(2, -1).sum(1)
    assert counts.max() / counts.min() > 10


def test_two_rank_fp16_step_is_compress_average_decompress(two_ranks):
    """DistributedOptimizer(compression=fp16, num_groups=3): three fused
    allreduces, each on an fp16 wire buffer, and the step equals the one
    done by hand (fp16 gradients summed over the ranks, divided by 2 in
    f32, rounded to fp16, widened, SGD at 0.1) bit for bit.  Integer
    tensors pass the fp16 wire untouched."""
    for r in two_ranks:
        assert list(r["wire_dtypes"]) == ["torch.float16"] * 3
        assert float(r["step_max_diff"]) == 0.0
        np.testing.assert_array_equal(r["ints"], np.arange(5) * 3)
        assert r["ints"].dtype == np.int64 and bool(r["ints_ctx_none"])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
