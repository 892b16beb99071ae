"""The public collective API: sync and async allreduce, grouped
allreduce, broadcast, ``synchronize`` and ``poll``.

Counterpart of ``horovod_tpu.ops.api``.  Each call goes straight to
``torch.distributed`` work handles; the negotiation engine, which orders
and fuses named requests across ranks, comes with a later slice, so
callers issue collectives in the same order on every rank.  ``name`` is
accepted for Horovod's signature.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..common.process_sets import ProcessSet, global_process_set
from .collectives import (ADASUM, AVERAGE, MAX, MIN, PRODUCT, SUM, Handle,
                          broadcast_async_, fused_allreduce_async,
                          handle_average_backwards_compatibility)

__all__ = ["SUM", "AVERAGE", "MIN", "MAX", "PRODUCT", "ADASUM", "Handle",
           "allreduce", "allreduce_async", "grouped_allreduce",
           "grouped_allreduce_async", "broadcast", "broadcast_async",
           "broadcast_", "broadcast_async_", "synchronize", "poll"]


def allreduce_async(tensor: torch.Tensor, average=None,
                    name: Optional[str] = None, op=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: ProcessSet = global_process_set) -> Handle:
    red_op = handle_average_backwards_compatibility(op, average)
    return fused_allreduce_async([tensor], red_op, prescale_factor,
                                 postscale_factor, process_set
                                 ).then(lambda out: out[0])


def allreduce(tensor: torch.Tensor, average=None, name=None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """Reduce across ranks; returns a new tensor."""
    return allreduce_async(tensor, average, name, op, prescale_factor,
                           postscale_factor, process_set).wait()


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], average=None,
                            name: Optional[str] = None, op=None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set: ProcessSet = global_process_set
                            ) -> Handle:
    """One fused collective per dtype over the whole group; the handle's
    ``wait()`` returns the list of reduced tensors."""
    red_op = handle_average_backwards_compatibility(op, average)
    return fused_allreduce_async(tensors, red_op, prescale_factor,
                                 postscale_factor, process_set)


def grouped_allreduce(tensors: Sequence[torch.Tensor], average=None,
                      name=None, op=None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: ProcessSet = global_process_set
                      ) -> List[torch.Tensor]:
    return grouped_allreduce_async(tensors, average, name, op,
                                   prescale_factor, postscale_factor,
                                   process_set).wait()


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None,
                    process_set: ProcessSet = global_process_set) -> Handle:
    """Every rank receives rank ``root_rank``'s tensor, as a new tensor."""
    return broadcast_async_(tensor.detach().clone(), root_rank, process_set)


def broadcast(tensor: torch.Tensor, root_rank: int, name=None,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    return broadcast_async(tensor, root_rank, name, process_set).wait()


def broadcast_(tensor: torch.Tensor, root_rank: int, name=None,
               process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """In-place broadcast; returns ``tensor``."""
    return broadcast_async_(tensor, root_rank, process_set).wait()


def synchronize(handle: Handle):
    """Wait on an async handle and return its output."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True if the async op has completed."""
    return handle.poll()
