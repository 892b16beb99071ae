"""The public collective API: allreduce (Adasum included), allgather,
reducescatter, alltoall, broadcast, barrier, their async and grouped
forms, ``synchronize`` and ``poll``.

Counterpart of ``horovod_tpu.ops.api`` and of the reference's torch
surface (``horovod_tpu/torch/mpi_ops.py``).  Each call goes straight to
``torch.distributed`` work handles; the negotiation engine, which orders
and fuses named requests across ranks, comes with a later slice, so
callers issue collectives in the same order on every rank.  ``name`` is
accepted for Horovod's signature.  The synchronous forms are
differentiable (``ops/autograd.py``) when a tensor requires a gradient;
the async forms are not.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..common.process_sets import ProcessSet, global_process_set
from . import autograd as _ag
from . import collectives as _c
from .collectives import (ADASUM, AVERAGE, MAX, MIN, PRODUCT, SUM, Handle,
                          handle_average_backwards_compatibility)

__all__ = ["SUM", "AVERAGE", "MIN", "MAX", "PRODUCT", "ADASUM", "Handle",
           "allreduce", "allreduce_async", "grouped_allreduce",
           "grouped_allreduce_async", "allgather", "allgather_async",
           "grouped_allgather", "grouped_allgather_async", "reducescatter",
           "reducescatter_async", "grouped_reducescatter",
           "grouped_reducescatter_async", "alltoall", "alltoall_async",
           "broadcast", "broadcast_async", "broadcast_", "broadcast_async_",
           "barrier", "synchronize", "poll"]


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# -- allreduce -----------------------------------------------------------------

def allreduce_async(tensor: torch.Tensor, average=None,
                    name: Optional[str] = None, op=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: ProcessSet = global_process_set) -> Handle:
    return grouped_allreduce_async([tensor], average, name, op,
                                   prescale_factor, postscale_factor,
                                   process_set).then(lambda out: out[0])


def allreduce(tensor: torch.Tensor, average=None, name=None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """Reduce across ranks; returns a new tensor."""
    return grouped_allreduce([tensor], average, name, op, prescale_factor,
                             postscale_factor, process_set)[0]


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], average=None,
                            name: Optional[str] = None, op=None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set: ProcessSet = global_process_set
                            ) -> Handle:
    """One fused collective per dtype over the whole group (Adasum: one
    reduction per tensor); the handle's ``wait()`` returns the list of
    reduced tensors."""
    red_op = handle_average_backwards_compatibility(op, average)
    return _c.fused_allreduce_async(tensors, red_op, prescale_factor,
                                    postscale_factor, process_set)


def grouped_allreduce(tensors: Sequence[torch.Tensor], average=None,
                      name=None, op=None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: ProcessSet = global_process_set
                      ) -> List[torch.Tensor]:
    if _wants_grad(tensors):
        red_op = handle_average_backwards_compatibility(op, average)
        return list(_ag.GroupedAllreduceFn.apply(
            red_op, prescale_factor, postscale_factor, process_set,
            *tensors))
    return grouped_allreduce_async(tensors, average, name, op,
                                   prescale_factor, postscale_factor,
                                   process_set).wait()


# -- allgather -----------------------------------------------------------------

def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    process_set: ProcessSet = global_process_set) -> Handle:
    return _c.allgather_async([tensor], process_set).then(lambda out: out[0])


def allgather(tensor: torch.Tensor, name=None,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """Every rank's rows, concatenated in rank order; the first dimension
    may differ across ranks."""
    return grouped_allgather([tensor], name, process_set)[0]


def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None,
                            process_set: ProcessSet = global_process_set
                            ) -> Handle:
    return _c.allgather_async(tensors, process_set)


def grouped_allgather(tensors: Sequence[torch.Tensor], name=None,
                      process_set: ProcessSet = global_process_set
                      ) -> List[torch.Tensor]:
    if _wants_grad(tensors):
        return list(_ag.GroupedAllgatherFn.apply(process_set, *tensors))
    return _c.allgather_async(tensors, process_set).wait()


# -- reducescatter -------------------------------------------------------------

def reducescatter_async(tensor: torch.Tensor, op=SUM,
                        name: Optional[str] = None,
                        process_set: ProcessSet = global_process_set
                        ) -> Handle:
    return _c.reducescatter_async([tensor], op, process_set).then(
        lambda out: out[0])


def reducescatter(tensor: torch.Tensor, op=SUM, name=None,
                  process_set: ProcessSet = global_process_set
                  ) -> torch.Tensor:
    """The reduction's rows for this rank: earlier ranks take the larger
    shards when the rows do not divide."""
    return grouped_reducescatter([tensor], op, name, process_set)[0]


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor], op=SUM,
                                name: Optional[str] = None,
                                process_set: ProcessSet = global_process_set
                                ) -> Handle:
    return _c.reducescatter_async(tensors, op, process_set)


def grouped_reducescatter(tensors: Sequence[torch.Tensor], op=SUM,
                          name=None,
                          process_set: ProcessSet = global_process_set
                          ) -> List[torch.Tensor]:
    if _wants_grad(tensors):
        return list(_ag.GroupedReducescatterFn.apply(op, process_set,
                                                     *tensors))
    return _c.reducescatter_async(tensors, op, process_set).wait()


# -- alltoall ------------------------------------------------------------------

def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: Optional[str] = None,
                   process_set: ProcessSet = global_process_set) -> Handle:
    """``wait()`` returns (received rows, list of the counts received)."""
    return _c.alltoall_async(tensor, splits, process_set)


def alltoall(tensor: torch.Tensor, splits=None, name=None,
             process_set: ProcessSet = global_process_set):
    """Send ``splits[j]`` rows to rank j (an equal share when None).
    Returns the received rows, and with ``splits`` also the counts
    received from each rank (an int64 tensor)."""
    if _wants_grad([tensor]):
        out, recv = _ag.AlltoallFn.apply(tensor, splits, process_set)
    else:
        out, recv = _c.alltoall_async(tensor, splits, process_set).wait()
        recv = torch.tensor(recv, dtype=torch.int64)
    return out if splits is None else (out, recv)


# -- broadcast, barrier --------------------------------------------------------

def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None,
                    process_set: ProcessSet = global_process_set) -> Handle:
    """Every rank receives rank ``root_rank``'s tensor, as a new tensor."""
    return _c.broadcast_async_(tensor.detach().clone(), root_rank,
                               process_set)


def broadcast(tensor: torch.Tensor, root_rank: int, name=None,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    if _wants_grad([tensor]):
        return _ag.BroadcastFn.apply(tensor, root_rank, process_set)
    return broadcast_async(tensor, root_rank, name, process_set).wait()


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None,
                     process_set: ProcessSet = global_process_set) -> Handle:
    return _c.broadcast_async_(tensor, root_rank, process_set)


def broadcast_(tensor: torch.Tensor, root_rank: int, name=None,
               process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """In-place broadcast; returns ``tensor``."""
    return _c.broadcast_async_(tensor, root_rank, process_set).wait()


def barrier(process_set: ProcessSet = global_process_set):
    """Return when every rank of the set has called it."""
    _c.barrier(process_set)


def synchronize(handle: Handle):
    """Wait on an async handle and return its output."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True if the async op has completed."""
    return handle.poll()
