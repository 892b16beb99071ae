"""Data-parallel helpers: this rank's rows of a global batch, and the
average of a host-side metric.

Counterpart of ``horovod_tpu/jax/data_parallel.py``'s ``shard_batch``
(``:82``) and ``metric_average`` (``:190``).  Where the JAX
``shard_batch`` places the whole batch across an in-process mesh (or
assembles each process's rows into a global array), a rank here is a
process, and takes its own rows of the global batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .common import basics
from .ops.api import AVERAGE, allreduce


def shard_batch(batch, device=None, dtype: Optional[torch.dtype] = None):
    """This rank's rows of ``batch`` (an array or tensor, or a dict,
    list or tuple of them) as tensors on ``device`` (the world's device
    if None), cast to ``dtype`` if given: rows ``rank * n / size`` up to
    ``(rank + 1) * n / size`` of the first dimension.  Raises when the
    rows do not divide by the world's size."""
    rank, size = basics.rank(), basics.size()
    dev = basics.device() if device is None else torch.device(device)

    def rows(x):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        if x.ndim == 0 or x.shape[0] % size:
            raise ValueError("a global batch of %s rows does not split "
                             "over %d ranks" % (x.shape[:1] or "no", size))
        per = x.shape[0] // size
        return torch.as_tensor(x[rank * per:(rank + 1) * per], dtype=dtype,
                               device=dev)

    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(rows(v) for v in batch)
    return rows(batch)


def metric_average(value, name: Optional[str] = None) -> float:
    """The average of a host-side scalar across the world (upstream
    Horovod's ``metric_average`` of ``examples/pytorch/pytorch_mnist.py``),
    reduced in float32 as the JAX package reduces it."""
    t = torch.tensor([float(value)], dtype=torch.float32,
                     device=basics.device())
    return float(allreduce(t, op=AVERAGE, name=name or "metric").item())
