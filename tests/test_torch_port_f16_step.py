"""``make_bert_train_step(grad_scaler=...)``: the loss-scaled step that f16
activations need (Horovod's GradScaler recipe through
``DistributedOptimizer``: ``synchronize()``, ``unscale_``, the step under
``skip_synchronize()``, ``update()``).

At random weights BERT's gradients sit in f16's subnormal range or below
it, in the backward and on an fp16 wire, unless the loss is scaled first;
the f16 BERT-Large step of ``chip_smoke.py`` runs this option on the card.
Here, in f32 on the CPU on a one-rank world, a power-of-two scale must
leave the step exactly as it was, and a scale that overflows must skip
the optimizer step and back off.
"""

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.bert import BertConfig
from horovod_tpu_torch.models.convert_bert import init_params
from horovod_tpu_torch.train import make_bert_train_step, synthetic_bert_batch

SIZES = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
             max_seq=32, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world():
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def _steps(scaler, n=2, compression=hvd.Compression.none):
    """``n`` steps from the same weights and data (AdamW, 2 groups) ->
    (losses, parameters after them)."""
    cfg = BertConfig(**SIZES)
    build, shard_batch = make_bert_train_step(
        cfg, lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=0.01),
        compression=compression, num_groups=2, device="cpu",
        grad_scaler=scaler)
    step, model, _ = build(init_params(cfg, seed=0))
    data = shard_batch(synthetic_bert_batch(cfg, 4, 32, seed=0))
    losses = [step(data).item() for _ in range(n)]
    return losses, {k: p.detach().clone()
                    for k, p in model.named_parameters()}


def test_scaled_step_is_the_plain_step(world):
    """A power-of-two scale multiplies every gradient exactly and
    ``unscale_`` divides it back exactly, so two scaled steps take the
    plain steps bit for bit (with no wire codec: an fp16 wire rounds
    scaled gradients otherwise below f16's normal range, which is what
    the scale is for); the scale grows only after its growth interval,
    so it stays."""
    want_losses, want = _steps(None)
    scaler = torch.amp.GradScaler("cpu", init_scale=2.0 ** 10)
    losses, got = _steps(scaler)
    assert losses == want_losses
    for name, p in want.items():
        assert torch.equal(got[name], p), name
    assert scaler.get_scale() == 2.0 ** 10


def test_overflowing_scale_skips_the_step(world):
    """Scaled gradients past f16's range overflow on the fp16 wire; the
    scaler sees them after ``synchronize()``, skips each optimizer step
    (the weights stay the initial ones) and backs the scale off by half
    each time."""
    scaler = torch.amp.GradScaler("cpu", init_scale=2.0 ** 40)
    _, got = _steps(scaler, compression=hvd.Compression.fp16)
    assert scaler.get_scale() == 2.0 ** 38
    _, start = _steps(None, n=0)
    for name, p in start.items():
        assert torch.equal(got[name], p), name
