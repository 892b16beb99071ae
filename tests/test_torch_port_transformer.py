"""The port's decoder and training step against the JAX package's, at a
tiny configuration (vocab 256, d 64, 2 layers, 2 heads of 32, seq 128,
batch 2).

The JAX side runs ``horovod_tpu.models.transformer`` on a 1-device mesh,
where attention is its plain ``local_attention``; the port runs its
flash autograd function on the plain kernel versions.  Weights come from
the JAX ``init_params`` and cross through ``params_from_jax``.
"""

import inspect
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.models.convert import (LAYER_KEYS, params_from_jax,
                                              tree_from_module)

if __name__ != "__main__":
    # The reference side.  The spawned ranks run this file as a script
    # and need only torch, so they skip importing JAX.
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.models import transformer as jt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=2,
             n_kv_heads=2, d_ff=128, max_seq=128)
BATCH, LR = 2, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**kw):
    """The configuration both packages get; f32 by default."""
    return {**SIZES, "dtype": "float32", "logits_dtype": "f32", **kw}


def _cfgs(**kw):
    return jt.TransformerConfig(**_kw(**kw)), pt.TransformerConfig(**_kw(**kw))


def _batch():
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, SIZES["vocab_size"],
                         (BATCH, SIZES["max_seq"])).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _mesh1():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))


def _torch_batch(batch, rows=slice(None)):
    return {k: torch.as_tensor(v[rows], dtype=torch.long)
            for k, v in batch.items()}


def _jax_loss_and_grads(jcfg, params, batch):
    """(loss, grads, logits) of the JAX model, in one program: its
    ``loss_fn`` (transformer.py:444-450) with the logits kept as aux."""
    def loss_and_logits(p, b):
        logits, aux = jt.forward(p, b["tokens"], jcfg)
        nll = jt.vocab_parallel_cross_entropy(logits, b["targets"],
                                              jcfg.tp_axis)
        loss = nll.mean() + jcfg.aux_loss_weight * aux
        return jax.lax.pmean(loss, (jcfg.dp_axis, jcfg.sp_axis)), logits

    f = jax.jit(jax.shard_map(
        jax.value_and_grad(loss_and_logits, has_aux=True),
        mesh=_mesh1(),
        in_specs=(jt.param_specs(jcfg),
                  {"tokens": P("dp", "sp"), "targets": P("dp", "sp")}),
        out_specs=((P(), P("dp", "sp", "tp")), jt.param_specs(jcfg)),
        check_vma=True))
    (loss, logits), grads = f(params, batch)
    return float(loss), _np_tree(grads), np.asarray(logits)


def _assert_trees_close(got, want, rtol, atol):
    for key in ("embed", "ln_f"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=key)
    for key in LAYER_KEYS:
        np.testing.assert_allclose(got["layers"][key], want["layers"][key],
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    return _np_tree(jt.init_params(jax.random.PRNGKey(0), jcfg))


def test_params_from_jax_carries_init_params(jax_params):
    _, pcfg = _cfgs()
    model = params_from_jax(jax_params, pcfg, device="cpu")
    back = tree_from_module(model)
    _assert_trees_close(back, jax_params, rtol=0, atol=0)
    assert model.layers[1].wq.shape == jax_params["layers"]["wq"].shape[1:]


def test_logits_loss_and_grads_match_jax(jax_params):
    """f32 activations on both sides: the implementations differ in
    summation order only.  Logits and loss at 1e-5; gradients at 1e-4
    relative (with 1e-6 absolute for entries near zero), since they sum
    over every token and layer."""
    jcfg, pcfg = _cfgs()
    batch = _batch()
    loss_jax, grads_jax, logits_jax = _jax_loss_and_grads(jcfg, jax_params,
                                                          batch)

    model = params_from_jax(jax_params, pcfg, device="cpu")
    tb = _torch_batch(batch)
    logits = model(tb["tokens"])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), logits_jax,
                               rtol=1e-5, atol=1e-5)
    loss = pt.loss_fn(model, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_jax, rtol=1e-5)
    _assert_trees_close(tree_from_module(model, grads=True), grads_jax,
                        rtol=1e-4, atol=1e-6)


def test_bf16_activations_match_jax(jax_params):
    """bf16 activations with bf16-operand, f32-result logits on both
    sides.  bf16 keeps 8 significant bits (2^-8 = 4e-3 per rounding) and
    the two frameworks round in different places (JAX's plain attention
    softmax stays f32, the port's P is cast to bf16 before P @ V), so the
    loss is held at 1e-2 and each gradient leaf's norm error at 5e-2."""
    jcfg, pcfg = _cfgs(dtype="bfloat16", logits_dtype="bf16")
    batch = _batch()
    loss_jax, grads_jax, _ = _jax_loss_and_grads(jcfg, jax_params, batch)
    model = params_from_jax(jax_params, pcfg, device="cpu")
    loss = pt.loss_fn(model, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_jax, rtol=1e-2)
    got = tree_from_module(model, grads=True)
    pairs = [(got[k], grads_jax[k]) for k in ("embed", "ln_f")]
    pairs += [(got["layers"][k], grads_jax["layers"][k]) for k in LAYER_KEYS]
    for g, w in pairs:
        w = np.asarray(w, np.float32)
        assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)


def test_fused_projections_match_unfused(jax_params):
    """fused_qkv and fused_gate only concatenate the weights per forward
    (as in the JAX model, whose own test holds the two forms equal):
    same loss and gradients as the three-matmul form, to f32 rounding."""
    batch = _torch_batch(_batch())
    out = []
    for fused in (False, True):
        cfg = pt.TransformerConfig(**_kw(fused_qkv=fused, fused_gate=fused))
        model = params_from_jax(jax_params, cfg, device="cpu")
        loss = pt.loss_fn(model, batch)
        loss.backward()
        out.append((loss.item(), tree_from_module(model, grads=True)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    _assert_trees_close(out[1][1], out[0][1], rtol=1e-5, atol=1e-7)


def test_rope_splits_halves_and_rms_norm_order():
    """RoPE rotates the two halves (as the JAX code does, whatever its
    docstring says), and rms_norm rounds to the activation dtype before
    the scale multiply; both bit-equal to the JAX functions in bf16."""
    rng = np.random.RandomState(2)
    x = rng.randn(1, 16, 2, 32).astype(np.float32)
    cos_j, sin_j = jt.rope_tables(jnp.arange(16), 32, 10000.0, jnp.bfloat16)
    want = np.asarray(jt._rope(cos_j, sin_j, jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    cos_t, sin_t = pt.rope_tables(16, 32, 10000.0, torch.bfloat16, "cpu")
    np.testing.assert_array_equal(cos_t.float().numpy(),
                                  np.asarray(cos_j, np.float32))
    got = pt.rope(cos_t, sin_t, torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(), want)

    h = rng.randn(4, 64).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    want = np.asarray(jt.rms_norm(jnp.asarray(h, jnp.bfloat16),
                                  jnp.asarray(scale), 1e-5), np.float32)
    got = pt.rms_norm(torch.from_numpy(h).bfloat16(),
                      torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8)


def test_adam_defaults_match_optax():
    """torch.optim.Adam and optax.adam: b1 0.9, b2 0.999, eps 1e-8, eps
    outside the square root of the bias-corrected second moment."""
    sig = inspect.signature(optax.adam).parameters
    d = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))]).defaults
    assert d["betas"] == (sig["b1"].default, sig["b2"].default)
    assert d["eps"] == sig["eps"].default
    assert sig["eps_root"].default == 0.0


@pytest.fixture(scope="module")
def jax_step(jax_params):
    """One Adam step of the JAX package on the full batch."""
    jcfg, _ = _cfgs()
    build, shard_batch = jt.make_train_step(jcfg, _mesh1(), optax.adam(LR),
                                            donate=False)
    step, params, opt_state = build(jax_params)
    params, _, loss = step(params, opt_state, shard_batch(_batch()))
    return float(loss), _np_tree(params)


# Adam's first step moves each weight by lr * g / (|g| + eps), about
# lr * sign(g).  The f32 gradients differ by summation order, and where a
# gradient is within a few orders of eps that difference is amplified by
# up to lr / eps; 1% of the 1e-3 step covers it.
STEP_ATOL = 1e-5


@pytest.fixture
def cpu_world():
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_one_adam_step_matches_jax(jax_params, jax_step, cpu_world):
    from horovod_tpu_torch.train import make_train_step
    _, pcfg = _cfgs()
    build, shard_batch = make_train_step(
        pcfg, lambda ps: torch.optim.Adam(ps, LR), device="cpu")
    step, model, _ = build(jax_params)
    loss = step(shard_batch(_batch()))
    np.testing.assert_allclose(loss.item(), jax_step[0], rtol=1e-5)
    _assert_trees_close(tree_from_module(model), jax_step[1], rtol=0,
                        atol=STEP_ATOL)


# -- two gloo ranks, half the batch each, against the full-batch step -------

def _worker(rank: int, port: int, params_path: str, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.train import make_train_step
    hvd.init(device="cpu")
    pcfg = pt.TransformerConfig(**_kw())
    with np.load(params_path) as f:
        flat = dict(f)
    tree = {"embed": flat["embed"], "ln_f": flat["ln_f"],
            "layers": {k: flat["layers." + k] for k in LAYER_KEYS}}
    if rank == 1:  # rank 0's weights must win the broadcast
        tree["embed"] = tree["embed"] + 1.0
    build, shard_batch = make_train_step(
        pcfg, lambda ps: torch.optim.Adam(ps, LR), device="cpu")
    step, model, _ = build(tree)
    loss = step(shard_batch(_batch()))
    got = tree_from_module(model)
    hvd.shutdown()
    np.savez(out, loss=loss.numpy(), embed=got["embed"], ln_f=got["ln_f"],
             **{"layers." + k: got["layers"][k] for k in LAYER_KEYS})


def test_two_rank_step_matches_full_batch_jax(jax_params, jax_step,
                                              tmp_path):
    flat = {"embed": jax_params["embed"], "ln_f": jax_params["ln_f"]}
    flat.update({"layers." + k: jax_params["layers"][k] for k in LAYER_KEYS})
    np.savez(tmp_path / "params.npz", **flat)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         str(tmp_path / "params.npz"), str(tmp_path / ("rank%d.npz" % r))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
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
    losses = []
    for r in range(2):
        with np.load(tmp_path / ("rank%d.npz" % r)) as f:
            res = dict(f)
        losses.append(float(res["loss"]))
        got = {"embed": res["embed"], "ln_f": res["ln_f"],
               "layers": {k: res["layers." + k] for k in LAYER_KEYS}}
        _assert_trees_close(got, jax_step[1], rtol=0, atol=STEP_ATOL)
    # Each rank's loss is its half's mean; their mean is the JAX loss.
    np.testing.assert_allclose(np.mean(losses), jax_step[0], rtol=1e-5)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
