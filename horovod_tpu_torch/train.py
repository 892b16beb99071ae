"""The data-parallel training steps of the flagship models.

Counterparts of ``horovod_tpu.models.transformer.make_train_step``, of
the ResNet step ``bench.py`` times (``train_step``, bench.py:323-333) and
of ``horovod_tpu.models.bert.make_finetune_step``.  Where the JAX step
averages the loss over the mesh (``pmean``) and differentiates that, each
rank here takes its slice of the global batch, differentiates its own
mean loss and lets ``DistributedOptimizer`` average the gradients; with
equal slices the two are the same gradient (BERT's MLM loss is
normalised over the world, ``models.bert.mlm_loss``).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from .common import basics
from .compression import Compression
from .data_parallel import shard_batch as _shard
from .functions import broadcast_optimizer_state, broadcast_parameters
from .models import bert
from .models.convert import params_from_jax
from .models.convert_bert import params_from_jax as bert_from_jax
from .models.convert_resnet import params_from_flax
from .models.resnet import ResNetConfig, resnet_loss_fn
from .models.transformer import TransformerConfig, loss_fn
from .ops.collectives import AVERAGE
from .optimizer import DistributedOptimizer


def synthetic_batch(cfg: TransformerConfig, batch: int,
                    seed: int = 0) -> dict:
    """Random tokens (targets = tokens) of ``cfg.max_seq`` positions,
    from numpy, as ``bench.py`` makes them."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size,
                         (batch, cfg.max_seq)).astype(np.int64)
    return {"tokens": tokens, "targets": tokens.copy()}


def _backward_and_step(opt, loss, grad_scaler):
    """``loss.backward()`` and ``opt.step()``; with ``grad_scaler`` (a
    ``torch.amp.GradScaler``) the scaled loss's backward, so that small
    gradients stay in f16's normal range in the backward and on an fp16
    wire, then Horovod's recipe: ``synchronize()``, ``unscale_``, the
    optimizer step under ``skip_synchronize()`` (skipped by the scaler
    when a gradient is not finite), ``update()``."""
    if grad_scaler is None:
        loss.backward()
        opt.step()
        return
    grad_scaler.scale(loss).backward()
    opt.synchronize()
    grad_scaler.unscale_(opt)
    with opt.skip_synchronize():
        grad_scaler.step(opt)
    grad_scaler.update()


def make_train_step(cfg: TransformerConfig,
                    optimizer: Callable[[Iterable[torch.nn.Parameter]],
                                        torch.optim.Optimizer],
                    device=None, grad_scaler=None):
    """Returns ``(build, shard_batch)``.

    ``build(np_params)`` puts the JAX-layout tree on ``device`` (CUDA
    unless "cpu"), wraps ``optimizer(model.parameters())`` in
    ``DistributedOptimizer``, broadcasts rank 0's parameters and returns
    ``(step, model, opt)``, with ``step(batch) -> loss`` (this rank's
    mean loss, detached).  ``shard_batch(global_batch)`` gives this
    rank's rows on ``device``.  Needs ``hvd.init()`` first.

    ``grad_scaler`` (a ``torch.amp.GradScaler``), for f16 activations:
    the step backpropagates the scaled loss and follows Horovod's recipe
    (``synchronize()``, ``unscale_``, the optimizer step under
    ``skip_synchronize()``, ``update()``), as ``make_bert_train_step``
    does.  With None the step is the plain one."""
    dev = basics.resolve_device(device)

    def build(np_params):
        basics.topology()  # raises unless hvd.init() ran
        model = params_from_jax(np_params, cfg, dev)
        opt = DistributedOptimizer(optimizer(model.parameters()),
                                   named_parameters=model.named_parameters())
        broadcast_parameters(model.state_dict(), root_rank=0)

        def step(batch):
            opt.zero_grad()
            loss = loss_fn(model, batch)
            _backward_and_step(opt, loss, grad_scaler)
            return loss.detach()

        return step, model, opt

    def shard_batch(batch):
        return _shard(batch, dev, torch.long)

    return build, shard_batch


def synthetic_images(batch: int, image: int, num_classes: int = 1000,
                     seed: int = 0) -> dict:
    """NHWC normal images and uniform labels from numpy, as
    ``bench.py:310-312`` makes them: ``randn(batch, image, image, 3)``
    (rounded to the activation dtype on the device), then
    ``randint(0, num_classes, batch)``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, image, image, 3).astype(np.float32)
    y = rng.randint(0, num_classes, size=(batch,)).astype(np.int64)
    return {"x": x, "y": y}


def make_resnet_train_step(cfg: ResNetConfig,
                           optimizer: Callable[[Iterable[torch.nn.Parameter]],
                                               torch.optim.Optimizer],
                           device=None):
    """Returns ``(build, shard_batch)``, as ``make_train_step`` does.

    ``build(variables)`` puts the flax ``{"params", "batch_stats"}`` tree
    on ``device`` (CUDA unless "cpu") in train mode, wraps
    ``optimizer(model.parameters())`` (``torch.optim.SGD(lr=0.1,
    momentum=0.9)`` is ``optax.sgd(0.1, momentum=0.9)``) in
    ``DistributedOptimizer``, broadcasts rank 0's parameters and running
    statistics, and returns ``(step, model, opt)``; ``step(batch)`` takes
    one step, moves the running statistics and returns this rank's mean
    loss, detached.  ``shard_batch`` gives this rank's rows on
    ``device``: images as NCHW channels_last (the NHWC array permuted,
    no copy) in the activation dtype.  Needs ``hvd.init()`` first."""
    dev = basics.resolve_device(device)

    def build(variables):
        basics.topology()  # raises unless hvd.init() ran
        model = params_from_flax(variables, cfg, dev)
        model.train()
        opt = DistributedOptimizer(optimizer(model.parameters()),
                                   named_parameters=model.named_parameters())
        broadcast_parameters(model.state_dict(), root_rank=0)

        def step(batch):
            opt.zero_grad()
            loss = resnet_loss_fn(model, batch)
            loss.backward()
            opt.step()
            return loss.detach()

        return step, model, opt

    def shard_batch(batch):
        mine = _shard(batch, dev)
        return {"x": mine["x"].to(cfg.act_dtype).permute(0, 3, 1, 2),
                "y": mine["y"].long()}

    return build, shard_batch


def synthetic_bert_batch(cfg: bert.BertConfig, batch: int, seq: int,
                         seed: int = 0,
                         objective: str = "classification") -> dict:
    """Random tokens and [CLS] labels from numpy; for ``objective="mlm"``
    also ``targets`` (the tokens) and a ~15% ``mlm_mask`` with at least
    one target per row, as the JAX package's BERT tests make them."""
    if objective not in ("classification", "mlm"):
        raise ValueError("objective must be 'classification' or 'mlm', got "
                         "%r" % (objective,))
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    out = {"tokens": tokens,
           "labels": rng.randint(0, cfg.n_classes, (batch,)).astype(np.int64)}
    if objective == "mlm":
        mlm_mask = (rng.rand(batch, seq) < 0.15).astype(np.int64)
        mlm_mask[:, 0] = 1
        out.update(targets=tokens.copy(), mlm_mask=mlm_mask)
    return out


def make_bert_train_step(cfg: bert.BertConfig,
                         optimizer: Callable[[Iterable[torch.nn.Parameter]],
                                             torch.optim.Optimizer],
                         objective: str = "classification",
                         compression=Compression.none, num_groups: int = 0,
                         op: str = AVERAGE, device=None, grad_scaler=None):
    """Returns ``(build, shard_batch)``, as ``make_train_step`` does, for
    BERT fine-tuning with the ``classification_loss`` or ``mlm_loss``
    objective.

    ``build(np_params)`` puts the JAX-layout tree on ``device`` (CUDA
    unless "cpu"), broadcasts rank 0's parameters and optimizer state,
    wraps ``optimizer(model.parameters())`` in ``DistributedOptimizer``
    with ``compression``, ``num_groups`` and the reduce ``op`` (the recipe
    of ``examples/pytorch_bert_finetune.py``: AdamW, 8 groups, fp16 wire;
    ``op=hvd.Adasum`` for Adasum) and returns ``(step, model, opt)``; ``step(batch) -> loss`` (this
    rank's loss, detached).  ``shard_batch(global_batch)`` gives this
    rank's rows on ``device``.  Needs ``hvd.init()`` first.

    ``grad_scaler`` (a ``torch.amp.GradScaler``), for f16 activations:
    the step backpropagates the scaled loss, so that small gradients stay
    in f16's normal range in the backward and on an fp16 wire, and then
    follows Horovod's recipe (``_backward_and_step``)."""
    loss_fn = {"classification": bert.classification_loss,
               "mlm": bert.mlm_loss}[objective]
    dev = basics.resolve_device(device)

    def build(np_params):
        basics.topology()  # raises unless hvd.init() ran
        model = bert_from_jax(np_params, cfg, dev)
        opt = optimizer(model.parameters())
        broadcast_parameters(model.state_dict(), root_rank=0)
        broadcast_optimizer_state(opt, root_rank=0)
        opt = DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters(),
                                   num_groups=num_groups,
                                   compression=compression, op=op)

        def step(batch):
            opt.zero_grad()
            loss = loss_fn(model, batch)
            _backward_and_step(opt, loss, grad_scaler)
            return loss.detach()

        return step, model, opt

    def shard_batch(batch):
        return _shard(batch, dev, torch.long)

    return build, shard_batch
