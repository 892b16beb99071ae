"""Broadcast of model parameters, optimizer state and Python objects, and
the allgather of Python objects.

Counterpart of ``horovod_tpu/torch/functions.py``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from .common import basics
from .common.process_sets import ProcessSet, global_process_set
from .ops.collectives import broadcast_async_


def broadcast_parameters(params, root_rank: int = 0):
    """In-place broadcast of model parameters from ``root_rank``:
    ``hvd.broadcast_parameters(model.state_dict(), root_rank=0)``, or a
    ``named_parameters()`` iterable."""
    if isinstance(params, dict):
        items = sorted(params.items())
    else:
        items = list(params)
    handles = [broadcast_async_(p.data, root_rank) for _, p in items
               if isinstance(p, torch.Tensor)]
    for h in handles:
        h.wait()


def broadcast_object(obj: Any, root_rank: int = 0, name=None) -> Any:
    """Rank ``root_rank``'s picklable ``obj`` on every rank."""
    basics.topology()
    box = [obj if basics.rank() == root_rank else None]
    dist.broadcast_object_list(box, src=root_rank)
    return box[0]


def allgather_object(obj: Any, name=None,
                     process_set: ProcessSet = global_process_set) -> list:
    """Every member's picklable ``obj``, in rank order."""
    basics.topology()
    if not process_set.included():
        raise ValueError("rank %d is not part of %r"
                         % (basics.rank(), process_set))
    out = [None] * process_set.size()
    dist.all_gather_object(out, obj, group=process_set.group)
    return out


class _TensorSlot:
    """Stands for one tensor of a state dict while its structure is
    broadcast as an object."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype
        self.on_cpu = t.device.type == "cpu"


def broadcast_optimizer_state(optimizer, root_rank: int = 0):
    """Make every rank's optimizer state equal to ``root_rank``'s: the
    structure and scalars go as one object, every tensor by an in-place
    broadcast on the collective device."""
    root = basics.rank() == root_rank
    mine: list = []

    def strip(obj):
        if isinstance(obj, torch.Tensor):
            mine.append(obj)
            return _TensorSlot(obj)
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(strip(v) for v in obj)
        return obj

    skeleton = broadcast_object(strip(optimizer.state_dict())
                                if root else None, root_rank)
    dev = basics.device()
    mine.reverse()

    def fill(obj):
        if isinstance(obj, _TensorSlot):
            t = (mine.pop() if root else
                 torch.empty(obj.shape, dtype=obj.dtype, device=dev))
            wire = t.to(dev)
            broadcast_async_(wire, root_rank).wait()
            return wire.cpu() if obj.on_cpu else wire
        if isinstance(obj, dict):
            return {k: fill(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(fill(v) for v in obj)
        return obj

    optimizer.load_state_dict(fill(skeleton))
