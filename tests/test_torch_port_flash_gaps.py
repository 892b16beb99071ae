"""Where the port's flash wrapper and its callers once refused what the
JAX package computes: head dims the kernels do not take, and
``HOROVOD_FLASH_ATTENTION=0``.

* ``flash_attention`` zero-pads the head dim to the next width the
  kernels take (16 -> 32, 48 -> 64, 96 -> 128, 160 -> 256) on every
  device, scales
  by the true head dim and slices the outputs back; the JAX package pads
  to 128 lanes.  Held against the JAX ``flash_attention`` (Pallas in
  interpret mode) at D 16 and 96.
* The port's decoder and BERT read ``HOROVOD_FLASH_ATTENTION`` as the
  JAX models do: 0 takes the plain softmax attention on both sides.
  Held against the JAX models under the same switch, and the port's
  flash path pinned against the JAX plain path, which is what
  ``test_torch_port_bert.py`` held before the switch existed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.models.convert import params_from_jax, tree_from_module
from horovod_tpu_torch.ops import flash_attention as fa
from tests import test_torch_port_bert as tb
from tests import test_torch_port_transformer as tt

# f32 on both sides, as tests/test_torch_port_flash.py holds the
# unpadded widths: the implementations differ in summation order only.
TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def flash_widths(monkeypatch):
    """The head dims the flash plain versions see, one per forward."""
    seen = []
    fwd = fa.flash_fwd

    def spy(q, k, v, causal):
        seen.append(q.shape[-1])
        return fwd(q, k, v, causal)

    monkeypatch.setattr(fa, "flash_fwd", spy)
    return seen


# -- head dims outside 32/64/128 ---------------------------------------------

@pytest.mark.parametrize("d,causal", [(16, True), (16, False),
                                      (96, True), (96, False)])
def test_padded_head_dims_match_jax(d, causal, flash_widths):
    """Forward and gradients at S 128, one head, against the JAX package,
    whose Pallas kernels run lane-padded to 128 in interpret mode."""
    rng = np.random.RandomState(d + causal)
    q, k, v, g = (rng.randn(1, 128, 1, d).astype(np.float32)
                  for _ in range(4))

    @jax.jit
    def jax_fwd_bwd(q_, k_, v_):
        o_, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal), q_, k_, v_)
        return o_, vjp(jnp.asarray(g))

    o_jax, grads_jax = jax_fwd_bwd(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal)
    o.backward(torch.from_numpy(g))
    assert flash_widths == [fa.padded_head_dim(d)]
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_jax),
                               atol=TOL, rtol=TOL)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_jax):
        assert got.shape == (1, 128, 1, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


def test_head_dim_pads_to_the_kernels_widths(flash_widths):
    """16 -> 32, 48 -> 64, 96 -> 128, 128 stays, 160 -> 256; a head dim
    past 256 stays as it is (the plain versions take it, on the card the
    route raises).  The padded call equals the unpadded plain attention,
    scaled by the true head dim, outputs and gradients sliced back."""
    assert [fa.padded_head_dim(d) for d in (16, 32, 48, 64, 96, 128, 160)] \
        == [32, 32, 64, 64, 128, 128, 256]
    for d in (48, 160):
        rng = np.random.RandomState(d)
        q, k, v = (torch.from_numpy(rng.randn(2, 64, 2, d).astype(np.float32))
                   .requires_grad_() for _ in range(3))
        o = fa.flash_attention(q, k, v, causal=True)
        o.square().sum().backward()
        got = [o.detach()] + [t.grad.clone() for t in (q, k, v)]
        for t in (q, k, v):
            t.grad = None
        ref = pt.local_attention(q, k, v, causal=True)
        ref.square().sum().backward()
        want = [ref.detach()] + [t.grad for t in (q, k, v)]
        for a, b in zip(got, want):
            assert a.shape == b.shape == (2, 64, 2, d)
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL,
                                       rtol=TOL)
    assert flash_widths == [64, 256]


# -- HOROVOD_FLASH_ATTENTION -----------------------------------------------

def test_flash_switch_reads_like_the_jax_models(monkeypatch):
    from horovod_tpu.models import transformer as jt
    for flag, on in (("0", False), ("false", False), ("False", False),
                     ("1", True), ("true", True), ("", True)):
        monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", flag)
        assert pt.use_flash_attention() is on is jt._use_flash_attention()
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION")
    assert pt.use_flash_attention()


@pytest.fixture(scope="module")
def decoder_params():
    jcfg, _ = tt._cfgs()
    return tt._np_tree(tt.jt.init_params(jax.random.PRNGKey(0), jcfg))


def test_decoder_without_flash_matches_jax(monkeypatch, decoder_params,
                                           flash_widths):
    """``HOROVOD_FLASH_ATTENTION=0`` on both sides: the JAX decoder's
    ``local_attention`` and f32 logits ("auto"), the port's
    ``local_attention`` and f32 logits; no flash call.  f32, at
    ``test_logits_loss_and_grads_match_jax``'s tolerances."""
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "0")
    jcfg, pcfg = tt._cfgs(logits_dtype="auto")
    batch = tt._batch()
    loss_jax, grads_jax, logits_jax = tt._jax_loss_and_grads(
        jcfg, decoder_params, batch)
    model = params_from_jax(decoder_params, pcfg, device="cpu")
    tbatch = tt._torch_batch(batch)
    logits = model(tbatch["tokens"])
    np.testing.assert_allclose(logits.detach().numpy(), logits_jax,
                               rtol=1e-5, atol=1e-5)
    loss = pt.loss_fn(model, tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_jax, rtol=1e-5)
    tt._assert_trees_close(tree_from_module(model, grads=True), grads_jax,
                           rtol=1e-4, atol=1e-6)
    assert flash_widths == []


def test_decoder_auto_logits_follow_the_switch(monkeypatch, decoder_params):
    """"auto" logits are the bf16-operand product with flash on and the
    f32 product with it off, as the JAX model picks them (bf16
    activations, where the two differ)."""
    tokens = tt._torch_batch(tt._batch())["tokens"][:1, :32]
    _, auto = tt._cfgs(dtype="bfloat16", logits_dtype="auto")
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", flag)
        for kind in ("auto", "bf16", "f32"):
            cfg = pt.TransformerConfig(**{**auto.__dict__,
                                          "logits_dtype": kind})
            with torch.no_grad():
                out[flag, kind] = params_from_jax(decoder_params, cfg,
                                                  device="cpu")(tokens)
    assert torch.equal(out["1", "auto"], out["1", "bf16"])
    assert torch.equal(out["0", "auto"], out["0", "f32"])
    assert not torch.equal(out["0", "auto"], out["0", "bf16"])


@pytest.fixture(scope="module")
def bert_tree():
    return tb._tree()


def _bert_errors(monkeypatch, dtype, tree, port_flag, jax_flag):
    batch = tb._batch()
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", jax_flag)
    want = tb._jax_reference(dtype, tree, batch)
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", port_flag)
    return tb._errors(tb._port(dtype, tree, batch), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_without_flash_matches_jax(monkeypatch, bert_tree, dtype,
                                        flash_widths):
    """``HOROVOD_FLASH_ATTENTION=0`` on both sides: the plain f32 softmax
    attention in both BERTs, no flash call.  Encoder output, both
    objectives' losses and gradients at ``test_torch_port_bert.py``'s
    tolerances for the dtype."""
    h_err, loss_err, leaf_err, bk_noise = _bert_errors(
        monkeypatch, dtype, bert_tree, "0", "0")
    tol = ((tb.F32_HIDDEN, tb.F32_LOSS, tb.F32_LEAF) if dtype == "float32"
           else (tb.BF16_HIDDEN, tb.BF16_LOSS, tb.BF16_LEAF))
    assert h_err <= tol[0], h_err
    assert max(loss_err) <= tol[1], loss_err
    for errs in leaf_err:
        worst = max(errs, key=errs.get)
        assert errs[worst] <= tol[2], (worst, errs[worst])
    assert max(bk_noise) <= tb.BK_NOISE[dtype], bk_noise
    assert flash_widths == []


def test_bert_flash_path_matches_jax_plain_attention(monkeypatch, bert_tree,
                                                     flash_widths):
    """The port's flash path (its plain kernel versions) against the JAX
    BERT's plain attention, f32: what ``test_torch_port_bert.py``'s
    ``HOROVOD_FLASH_ATTENTION=0`` cases held of the port before the port
    read the switch."""
    h_err, loss_err, leaf_err, bk_noise = _bert_errors(
        monkeypatch, "float32", bert_tree, "1", "0")
    assert flash_widths, "the port's flash path did not run"
    assert h_err <= tb.F32_HIDDEN, h_err
    assert max(loss_err) <= tb.F32_LOSS, loss_err
    for errs in leaf_err:
        worst = max(errs, key=errs.get)
        assert errs[worst] <= tb.F32_LEAF, (worst, errs[worst])
    assert max(bk_noise) <= tb.BK_NOISE["float32"], bk_noise
