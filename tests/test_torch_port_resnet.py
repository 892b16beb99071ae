"""The port's BatchNorm kernels (plain versions), NormAct, ResNet-50 and its
training step against the JAX package, on the CPU.

The BN plain versions are held to ``horovod_tpu.ops.pallas_bn``'s kernels
run through the Pallas interpreter (their own off-TPU path), the port's
``batch_norm_act`` to the reference's (forward and backward), ``NormAct``
to the flax module, and the whole ResNet-50 (f32, image 64, batch 2, 10
classes; see ``IMAGE``) to the flax model: logits, loss, every
gradient leaf, the new batch statistics and one SGD-momentum step.
Inputs and weights come from numpy seeds; the blocks' last-norm scales
are random and non-zero, so the residual branches pass gradient.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from horovod_tpu.models import resnet as jr
from horovod_tpu.ops import pallas_bn as jbn
from horovod_tpu_torch.models import resnet as pr
from horovod_tpu_torch.models.convert_resnet import (init_params,
                                                     params_from_flax,
                                                     tree_from_module)
from horovod_tpu_torch.ops import batch_norm as pbn
from horovod_tpu_torch.train import make_resnet_train_step, synthetic_images

EPS = 1e-5
CASES = {  # name: (M, C, JAX dtype, torch dtype), as tests/test_pallas_bn.py
    "f32": (256, 64, jnp.float32, torch.float32),
    "bf16": (512, 128, jnp.bfloat16, torch.bfloat16),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(
        got.detach().float().numpy() if torch.is_tensor(got) else got,
        _np(want), rtol=rtol, atol=atol, err_msg=what)


def _bn_inputs(m, c, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, c) * 1.5 + 0.3, rng.randn(m, c), rng.randn(m, c),
            rng.randn(c), rng.randn(c))


# -- (a) the four plain versions against the Pallas kernels ------------------

# f32: the two sides differ in summation order and rinv (rsqrt against
# 1/sqrt, an ulp), so sums of 256 terms of order 1 agree to 1e-4 absolute
# and the elementwise outputs to 1e-5.  bf16: the same f32 arithmetic
# rounded to bf16 at the end, so outputs are one bf16 ulp (2^-7 relative)
# apart at most.
TOL = {"f32": {"sum": (1e-5, 1e-4), "elem": (1e-5, 1e-5)},
       "bf16": {"sum": (1e-5, 1e-4), "elem": (2 ** -7, 1e-6)}}


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernels_match_pallas_interpret(case, relu, residual):
    m, c, jdt, tdt = CASES[case]
    x, dy, res, g, b = _bn_inputs(m, c, 1)
    tol = TOL[case]
    jx, jdy, jres = (jnp.asarray(a, jdt) for a in (x, dy, res))
    tx, tdy, tres = (_t(_np(a), tdt) for a in (jx, jdy, jres))
    jres, tres = (jres, tres) if residual else (None, None)

    sums, sqs = jbn._stats(jx, c, True)
    s, q = pbn.bn_stats_reference(tx)
    _close(s, sums[0], *tol["sum"], what="sum")
    _close(q, sqs[0], *tol["sum"], what="sum of squares")

    # Both sides get the reference's statistics from here on.
    mean = sums / m
    var = jnp.maximum(sqs / m - jnp.square(sums / m), 0.0)
    vec = [jnp.asarray(a, jnp.float32)[None] for a in (g, b)]
    tm, tv, tg, tb = (_t(_np(a)[0]) for a in [mean, var] + vec)

    y = jbn._apply(jx, mean, var, *vec, jres, c, EPS, relu, True)
    assert y.dtype == jdt
    got = pbn.bn_apply_reference(tx, tm, tv, tg, tb, tres, EPS, relu)
    assert got.dtype == tdt
    _close(got, y, *tol["elem"], what="y")

    db, dg = jbn._bwd_reductions(jx, jdy, mean, var, *vec, jres, c, EPS,
                                 relu, True)
    tdb, tdg = pbn.bn_bwd_reductions_reference(tx, tdy, tm, tv, tg, tb, tres,
                                               EPS, relu)
    _close(tdb, db[0], *tol["sum"], what="dbeta")
    _close(tdg, dg[0], *tol["sum"], what="dgamma")

    dx, dres = jbn._bwd_dx(jx, jdy, mean, var, *vec, db, dg, jres, c, EPS,
                           relu, m, True)
    tdx, tdres = pbn.bn_bwd_dx_reference(tx, tdy, tm, tv, tg, tb, _t(_np(db[0])),
                                         _t(_np(dg[0])), tres, EPS, relu)
    _close(tdx, dx, *tol["elem"], what="dx")
    assert (tdres is None) == (dres is None)
    if residual:
        _close(tdres, dres, *tol["elem"], what="dres")


# batch_norm_act through autograd against the reference's custom_vjp: the
# statistics and the backward formula as above, plus the cast of y (and
# of the cotangent) in bf16.  bf16 dx: the reference's test holds its bf16
# kernels at 0.1 relative to an f32 oracle; the two implementations here
# round at the same points, so 2^-6 (two ulps) with a small floor.
AUTOGRAD_TOL = {"f32": {"y": (1e-5, 1e-5), "stat": (1e-5, 1e-6),
                        "grad": (1e-4, 1e-4)},
                "bf16": {"y": (2 ** -7, 1e-6), "stat": (1e-5, 1e-6),
                         "grad": (2 ** -6, 2 ** -6)}}


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_norm_act_matches_reference(case, relu, residual):
    m, c, jdt, tdt = CASES[case]
    x, w, res, g, b = _bn_inputs(m, c, 2)
    tol = AUTOGRAD_TOL[case]
    shape = (m // 16, 4, 4, c)  # NHWC
    jx, jw, jres = (jnp.asarray(a.reshape(shape), jdt) for a in (x, w, res))
    jg, jb = jnp.asarray(g, jnp.float32), jnp.asarray(b, jnp.float32)

    def f(x, g, b, r):
        y, mean, var = jbn.batch_norm_act(x, g, b, r, eps=EPS, relu=relu)
        return y, mean, var

    args = (jx, jg, jb, jres if residual else None)
    (y, mean, var), vjp = jax.vjp(f, *args)
    grads = vjp((jw, jnp.zeros_like(mean), jnp.zeros_like(var)))

    def nchw(a):
        return _t(_np(a), tdt).permute(0, 3, 1, 2)

    tx = nchw(jx).requires_grad_()
    tres = nchw(jres).requires_grad_() if residual else None
    tg, tb = _t(g).requires_grad_(), _t(b).requires_grad_()
    ty, tmean, tvar = pbn.batch_norm_act(tx, tg, tb, tres, eps=EPS,
                                         relu=relu)
    assert ty.dtype == tdt
    assert ty.is_contiguous(memory_format=torch.channels_last)
    assert not tmean.requires_grad and not tvar.requires_grad
    ty.backward(nchw(jw))
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    _close(nhwc(ty), y, *tol["y"], what="y")
    _close(tmean, mean, *tol["stat"], what="mean")
    _close(tvar, var, *tol["stat"], what="var")
    _close(nhwc(tx.grad), grads[0], *tol["grad"], what="dx")
    _close(tg.grad, grads[1], 1e-4, 1e-3, what="dgamma")
    _close(tb.grad, grads[2], 1e-4, 1e-3, what="dbeta")
    if residual:
        _close(nhwc(tres.grad), grads[3], *tol["grad"], what="dres")


def test_wrappers_check_layout_before_launching():
    """The autograd function takes channels-last activations only: a
    plain NCHW tensor would need a hidden copy, so it raises."""
    x = torch.zeros(2, 8, 4, 4)
    with pytest.raises(ValueError, match="channels_last"):
        pbn.batch_norm_act(x, torch.ones(8), torch.zeros(8))
    rows, chunks = pbn.plan(997, 100, 2)
    assert rows * chunks >= 997 > rows * (chunks - 1)
    assert pbn.plan(1605632, 64, 2)[1] <= 1024


# -- (b) NormAct against flax's ----------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_normact_matches_flax(relu, residual, train):
    """y and the running statistics after one call: ra = 0.9 ra + 0.1
    batch with the biased batch variance in train mode, untouched in
    eval mode (use_running_average), f32 throughout."""
    rng = np.random.RandomState(3)
    c = 32
    x = (rng.randn(8, 4, 4, c) * 2 + 0.5).astype(np.float32)
    res = rng.randn(8, 4, 4, c).astype(np.float32)
    variables = {"params": {"scale": rng.randn(c).astype(np.float32),
                            "bias": rng.randn(c).astype(np.float32)},
                 "batch_stats": {"mean": rng.randn(c).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, c)
                                 .astype(np.float32)}}
    mod = jr.NormAct(relu=relu, use_running_average=not train,
                     dtype=jnp.float32)
    y, state = mod.apply(variables, x, res if residual else None,
                         mutable=["batch_stats"])

    port = pr.NormAct(c, relu=relu, device="cpu")
    with torch.no_grad():
        for name in ("scale", "bias"):
            getattr(port, name).copy_(_t(variables["params"][name]))
        for name in ("mean", "var"):
            getattr(port, name).copy_(_t(variables["batch_stats"][name]))
    port.train(train)
    cl = lambda a: _t(a).permute(0, 3, 1, 2)
    ty = port(cl(x), cl(res) if residual else None)
    _close(ty.permute(0, 2, 3, 1), y, 1e-5, 1e-5, what="y")
    _close(port.mean, state["batch_stats"]["mean"], 1e-6, 1e-6, what="mean")
    _close(port.var, state["batch_stats"]["var"], 1e-6, 1e-6, what="var")


# -- (d) flax SAME padding at stride 2 ---------------------------------------

@pytest.mark.parametrize("n", [8, 9])
def test_stride2_same_padding_matches_flax(n):
    """A 3x3 stride-2 conv and the stem's max-pool pad (0, 1) at an even
    size and (1, 1) at an odd one; torch's symmetric padding=1 gives
    other numbers at the even size, so a port using it fails here."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, n, n, 4).astype(np.float32)
    k = rng.randn(3, 3, 4, 5).astype(np.float32)
    want = nn.Conv(5, (3, 3), (2, 2), use_bias=False).apply(
        {"params": {"kernel": k}}, x)
    conv = pr.Conv(4, 5, 3, 2, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(_t(k.transpose(3, 2, 0, 1)))
    tx = _t(x).permute(0, 3, 1, 2)
    _close(conv(tx).permute(0, 2, 3, 1), want, 1e-5, 1e-5, what="conv")
    pool = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    _close(pr.max_pool_same(tx).permute(0, 2, 3, 1), pool, 0, 0,
           what="max_pool")
    assert pr.same_pads(n, 3, 2) == ((0, 1) if n % 2 == 0 else (1, 1))
    symmetric = F.conv2d(tx, conv.weight, stride=2, padding=1)
    same = np.allclose(symmetric.permute(0, 2, 3, 1).detach().numpy(),
                       _np(want), atol=1e-4)
    assert same == (n % 2 == 1)


# -- (c) the whole ResNet-50 ---------------------------------------------------

# Image 64, batch 2: the last stage normalises over M = 2 x 2 x 2 = 8
# values.  At image 32 it would be M = 2, where BatchNorm's dx is an exact
# cancellation (two normalised values are +-1 whatever x is), so every
# gradient upstream of a non-zero last-norm scale is rounding noise: f32
# against f64 of the port itself differs by more than 100% there.
DEPTH, CLASSES, IMAGE, BATCH = 50, 10, 64, 2


def _variables():
    """init_params with the blocks' last-norm scales (zero at init) set
    to random values in [0.2, 0.5], so that the residual branches pass
    gradient, and random running statistics, so that the update shows."""
    v = init_params(DEPTH, CLASSES, seed=0)
    rng = np.random.RandomState(5)
    for path, arr in jax.tree_util.tree_leaves_with_path(v["params"]):
        if path[-1].key == "scale" and not arr.any():
            arr[...] = rng.uniform(0.2, 0.5, arr.shape)
    for path, arr in jax.tree_util.tree_leaves_with_path(v["batch_stats"]):
        arr[...] = (rng.randn(*arr.shape) if path[-1].key == "mean"
                    else rng.uniform(0.5, 2, arr.shape))
    return v


@pytest.fixture(scope="module")
def reference():
    """The JAX model on the CPU: logits, loss, gradients and new
    batch_stats of one train-mode forward, and the parameters after one
    optax.sgd(0.1, momentum=0.9) step."""
    variables = _variables()
    batch = synthetic_images(BATCH, IMAGE, CLASSES, seed=0)
    model = jr.ResNet(depth=DEPTH, num_classes=CLASSES, dtype=jnp.float32)

    def loss(params, stats, x, y):
        logits, new = model.apply({"params": params, "batch_stats": stats},
                                  x, train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1).mean()
        return nll, (logits, new["batch_stats"])

    (nll, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(
        variables["params"], variables["batch_stats"], batch["x"], batch["y"])
    tx = optax.sgd(0.1, momentum=0.9)
    updates, _ = tx.update(grads, tx.init(variables["params"]),
                           variables["params"])
    stepped = optax.apply_updates(variables["params"], updates)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return {"variables": variables, "batch": batch, "loss": float(nll),
            "logits": np.asarray(logits), "grads": np_tree(grads),
            "stats": np_tree(stats), "stepped": np_tree(stepped)}


def _leaf_errors(got, want):
    """{path: ||got - want|| / ||want||} over the leaves of two trees."""
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    out = {}
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = np.asarray(flat_w[path], np.float64)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        out[jax.tree_util.keystr(path)] = (np.linalg.norm(g - w)
                                           / max(np.linalg.norm(w), 1e-30))
    assert len(out) == len(flat_w)
    return out


def test_init_params_has_the_flax_structure():
    """Names, nesting and shapes of init_params equal flax's own init
    (161 parameter leaves and 106 batch-stat leaves at depth 50), and
    the tree crosses params_from_flax / tree_from_module unchanged."""
    variables = init_params(DEPTH, CLASSES, seed=0)
    model = jr.ResNet(depth=DEPTH, num_classes=CLASSES, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), train=True))
    assert (jax.tree.map(lambda a: a.shape, variables)
            == jax.tree.map(lambda a: a.shape, dict(shapes)))
    assert len(jax.tree.leaves(variables["params"])) == 161
    assert len(jax.tree.leaves(variables["batch_stats"])) == 106
    block = variables["params"]["BottleneckBlock_0"]
    assert set(block) == {"Conv_%d" % i for i in range(4)} | {
        "NormAct_%d" % i for i in range(4)}
    assert not block["NormAct_3"]["scale"].any()  # the last norm
    assert block["NormAct_2"]["scale"].all()      # the projection's
    back = tree_from_module(params_from_flax(
        variables, pr.ResNetConfig(DEPTH, CLASSES, "float32"), "cpu"))
    assert max(_leaf_errors(back, variables).values()) == 0.0


# Both sides in f32; they differ in summation order only.  Logits and
# loss within 1e-4 (reading 4e-5 absolute on logits of about 3); the new
# batch statistics within 1e-4 relative norm error per leaf (reading
# 2e-6).  The gradients are ill-conditioned: BatchNorm over few values
# and sums that cancel (a bias feeding a conv and another BatchNorm) turn
# f32 rounding into per-leaf errors of up to 2.8% between the port in
# f32 and the port in f64, and the same 2.8% between the port and JAX;
# each leaf is held at 0.1, which a wiring fault (an O(1) error) fails.
MODEL_TOL, STATS_TOL, GRAD_TOL = 1e-4, 1e-4, 0.1


def test_resnet50_matches_jax(reference):
    variables = reference["variables"]
    batch = reference["batch"]
    model = params_from_flax(variables,
                             pr.ResNetConfig(DEPTH, CLASSES, "float32"),
                             "cpu")
    x = torch.from_numpy(batch["x"]).permute(0, 3, 1, 2)
    logits = model(x)
    assert logits.dtype == torch.float32
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, torch.from_numpy(batch["y"])[:, None]).mean()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), reference["logits"],
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_allclose(loss.item(), reference["loss"], rtol=MODEL_TOL)
    errs = _leaf_errors(tree_from_module(model, grads=True),
                        reference["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    stats = tree_from_module(model)["batch_stats"]
    errs = _leaf_errors(stats, reference["stats"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STATS_TOL, (worst, errs[worst])


@pytest.fixture
def cpu_world():
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_one_sgd_step_matches_optax(reference, cpu_world):
    """make_resnet_train_step in a one-rank gloo world: hooks, fused
    allreduce, torch SGD(0.1, momentum 0.9); the parameters after the
    step against optax's."""
    cfg = pr.ResNetConfig(DEPTH, CLASSES, "float32")
    build, shard_batch = make_resnet_train_step(
        cfg, lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
        device="cpu")
    step, model, _ = build(reference["variables"])
    data = shard_batch(reference["batch"])
    assert data["x"].is_contiguous(memory_format=torch.channels_last)
    loss = step(data)
    np.testing.assert_allclose(loss.item(), reference["loss"], rtol=MODEL_TOL)
    # Each weight moves by optax's update, -0.1 g on the first step of
    # momentum: the port's move against optax's, per leaf, holds the
    # update rule at the gradients' tolerance.
    start = reference["variables"]["params"]
    moved = jax.tree.map(np.subtract, tree_from_module(model)["params"], start)
    want = jax.tree.map(np.subtract, reference["stepped"], start)
    errs = _leaf_errors(moved, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
