"""Broadcast of model parameters, optimizer state and Python objects, and
the allgather of Python objects, all through the engine.

Counterpart of ``horovod_tpu/torch/functions.py``.  An object is pickled
into a uint8 tensor on the collective device, as upstream Horovod does:
``broadcast_object`` broadcasts its length, then its bytes;
``allgather_object`` gathers every member's length and bytes in one
grouped allgather.
"""

from __future__ import annotations

import pickle
from typing import Any

import torch

from .common import basics
from .common.process_sets import ProcessSet, global_process_set
from .ops.api import (_auto_name, broadcast_, broadcast_async_,
                      grouped_allgather)


def broadcast_parameters(params, root_rank: int = 0):
    """In-place broadcast of model parameters from ``root_rank``:
    ``hvd.broadcast_parameters(model.state_dict(), root_rank=0)``, or a
    ``named_parameters()`` iterable.  Each tensor is named by its key."""
    if isinstance(params, dict):
        items = sorted(params.items())
    else:
        items = list(params)
    handles = [broadcast_async_(p.data, root_rank,
                                name="broadcast_parameters.%s" % k)
               for k, p in items if isinstance(p, torch.Tensor)]
    for h in handles:
        h.wait()


def _to_bytes(obj) -> torch.Tensor:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
        basics.device())


def _from_bytes(t: torch.Tensor):
    return pickle.loads(t.cpu().numpy().tobytes())


def broadcast_object(obj: Any, root_rank: int = 0, name=None) -> Any:
    """Rank ``root_rank``'s picklable ``obj`` on every rank."""
    name = _auto_name("broadcast_object", name)
    dev = basics.device()
    payload = _to_bytes(obj) if basics.rank() == root_rank else None
    length = torch.tensor([0 if payload is None else payload.numel()],
                          dtype=torch.int64, device=dev)
    broadcast_(length, root_rank, name=name + ".len")
    if payload is None:
        payload = torch.empty(int(length.item()), dtype=torch.uint8,
                              device=dev)
    broadcast_(payload, root_rank, name=name + ".bytes")
    return obj if basics.rank() == root_rank else _from_bytes(payload)


def allgather_object(obj: Any, name=None,
                     process_set: ProcessSet = global_process_set) -> list:
    """Every member's picklable ``obj``, in rank order."""
    payload = _to_bytes(obj)
    length = torch.tensor([payload.numel()], dtype=torch.int64,
                          device=payload.device)
    lengths, data = grouped_allgather(
        [length, payload],
        name=_auto_name("allgather_object", name, process_set),
        process_set=process_set)
    return [_from_bytes(part) for part in
            data.split(lengths.tolist())]


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
