"""The data-parallel training step of the flagship decoder.

Counterpart of ``horovod_tpu.models.transformer.make_train_step`` and of
the batch ``bench.py`` times.  Where the JAX step averages the loss over
the mesh (``pmean``) and differentiates that, each rank here takes its
slice of the global batch, differentiates its own mean loss and lets
``DistributedOptimizer`` average the gradients; with equal slices the
two are the same gradient.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from .common import basics
from .functions import broadcast_parameters
from .models.convert import params_from_jax
from .models.transformer import TransformerConfig, loss_fn
from .optimizer import DistributedOptimizer


def synthetic_batch(cfg: TransformerConfig, batch: int,
                    seed: int = 0) -> dict:
    """Random tokens (targets = tokens) of ``cfg.max_seq`` positions,
    from numpy, as ``bench.py`` makes them."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size,
                         (batch, cfg.max_seq)).astype(np.int64)
    return {"tokens": tokens, "targets": tokens.copy()}


def make_train_step(cfg: TransformerConfig,
                    optimizer: Callable[[Iterable[torch.nn.Parameter]],
                                        torch.optim.Optimizer],
                    device=None):
    """Returns ``(build, shard_batch)``.

    ``build(np_params)`` puts the JAX-layout tree on ``device`` (CUDA
    unless "cpu"), wraps ``optimizer(model.parameters())`` in
    ``DistributedOptimizer``, broadcasts rank 0's parameters and returns
    ``(step, model, opt)``, with ``step(batch) -> loss`` (this rank's
    mean loss, detached).  ``shard_batch(global_batch)`` gives this
    rank's rows on ``device``.  Needs ``hvd.init()`` first."""
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
            loss.backward()
            opt.step()
            return loss.detach()

        return step, model, opt

    def shard_batch(batch):
        rank, size = basics.rank(), basics.size()
        rows = batch["tokens"].shape[0]
        if rows % size:
            raise ValueError("global batch %d does not split over %d ranks"
                             % (rows, size))
        per = rows // size
        return {k: torch.as_tensor(np.asarray(v)[rank * per:(rank + 1) * per],
                                   dtype=torch.long, device=dev)
                for k, v in batch.items()}

    return build, shard_batch
