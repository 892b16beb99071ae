"""The public collective API: allreduce (Adasum included), allgather,
reducescatter, alltoall, broadcast, barrier, join, their async and
grouped forms, ``synchronize`` and ``poll``.

Counterpart of ``horovod_tpu.ops.api`` and of the reference's torch
surface (``horovod_tpu/torch/mpi_ops.py``).  Every call enqueues named
requests into the engine (``ops/engine.py``), which negotiates them
across ranks, fuses allreduces by threshold and executes them in one
order on every rank; so ranks may issue collectives in different
orders, as long as the names match.  An unnamed call gets a name from a
per-op sequence (``_auto_name``), which matches across ranks when they
issue unnamed calls of an op in the same order.  A grouped call's
members, ``<name>.<i>``, are negotiated as a whole.  The async forms
return a ``Handle``; the synchronous forms are differentiable
(``ops/autograd.py``) when a tensor requires a gradient.
"""

from __future__ import annotations

import collections
import itertools
from typing import List, Optional, Sequence

import torch

from ..common import basics
from ..common.message import (ALLGATHER, ALLREDUCE, ALLTOALL, BARRIER,
                              BROADCAST, REDUCESCATTER, Request)
from ..common.process_sets import ProcessSet, global_process_set
from ..utils.adasum import check_power_of_two
from . import autograd as _ag
from . import collectives as _c
from .collectives import (ADASUM, AVERAGE, MAX, MIN, PRODUCT, SUM,
                          handle_average_backwards_compatibility)
from .engine import Handle, HorovodInternalError

__all__ = ["SUM", "AVERAGE", "MIN", "MAX", "PRODUCT", "ADASUM", "Handle",
           "HorovodInternalError",
           "allreduce", "allreduce_async", "grouped_allreduce",
           "grouped_allreduce_async", "allgather", "allgather_async",
           "grouped_allgather", "grouped_allgather_async", "reducescatter",
           "reducescatter_async", "grouped_reducescatter",
           "grouped_reducescatter_async", "alltoall", "alltoall_async",
           "broadcast", "broadcast_async", "broadcast_", "broadcast_async_",
           "barrier", "join", "synchronize", "poll"]

_name_counters = collections.defaultdict(itertools.count)


def _auto_name(prefix: str, name: Optional[str],
               process_set: Optional[ProcessSet] = None) -> str:
    """``name``, or the next of a per-op sequence of the process set:
    the members of a set issue its unnamed calls of an op in one order,
    whatever other sets they belong to."""
    if name:
        return name
    psid = (process_set or global_process_set).process_set_id or 0
    if psid:
        prefix = "%s.ps%d" % (prefix, psid)
    return "%s.noname.%d" % (prefix, next(_name_counters[prefix]))


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _requests(op_type: str, tensors: Sequence[Optional[torch.Tensor]],
              prefix: str, name: Optional[str], process_set: ProcessSet,
              grouped: bool, **fields) -> List[Request]:
    """One request per tensor, named ``name`` or by
    ``_auto_name(prefix)``; a grouped call's members are named
    ``<name>.<i>`` and negotiated as a whole."""
    ps = process_set or global_process_set
    if ps.process_set_id is None:
        raise ValueError("%r is not registered; call hvd.add_process_set "
                         "first" % ps)
    if not ps.included():
        raise ValueError("rank %d is not part of %r" % (basics.rank(), ps))
    name = _auto_name(prefix, name, ps)
    names = (["%s.%d" % (name, i) for i in range(len(tensors))]
             if grouped else [name])
    return [Request(n, op_type,
                    None if t is None else t.dtype,
                    () if t is None else t.shape,
                    process_set_id=ps.process_set_id,
                    group=name if grouped else None,
                    group_size=len(tensors) if grouped else 0, **fields)
            for n, t in zip(names, tensors)]


def _enqueue(op_type: str, tensors: Sequence[Optional[torch.Tensor]],
             prefix: str, name: Optional[str], process_set: ProcessSet,
             grouped: bool, finish, **fields) -> Handle:
    engine = basics.engine()
    return engine.enqueue(_requests(op_type, tensors, prefix, name,
                                    process_set, grouped, **fields),
                          tensors, finish)


def _first(results):
    return results[0]


# -- allreduce -----------------------------------------------------------------

def allreduce_requests(tensors, average=None, name=None, op=None,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       process_set: ProcessSet = global_process_set,
                       grouped: bool = False) -> List[Request]:
    """The requests ``allreduce_async`` (``grouped_allreduce_async`` when
    ``grouped``) enqueues for ``tensors``; a caller that reduces tensors
    of one name, dtype and shape again and again builds them once and
    passes them to the engine's ``enqueue`` with the tensors."""
    red_op = handle_average_backwards_compatibility(op, average)
    if red_op == ADASUM:
        bad = [t.dtype for t in tensors if t.dtype not in _c.ADASUM_DTYPES]
        if bad:
            raise ValueError("Adasum reduces f32, bf16 or f16 tensors, got "
                             "%s" % bad[0])
        check_power_of_two((process_set or global_process_set).size())
    else:
        _c.reduce_op(red_op)
    prefix = "grouped_allreduce" if grouped else "allreduce"
    return _requests(ALLREDUCE, tensors, prefix, name, process_set, grouped,
                     red_op=red_op, prescale=prescale_factor,
                     postscale=postscale_factor)


def _allreduce(tensors, average, name, op, prescale, postscale, process_set,
               grouped) -> Handle:
    tensors = [t.detach() for t in tensors]
    return basics.engine().enqueue(
        allreduce_requests(tensors, average, name, op, prescale, postscale,
                           process_set, grouped),
        tensors, list if grouped else _first)


def allreduce_async(tensor: torch.Tensor, average=None,
                    name: Optional[str] = None, op=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: ProcessSet = global_process_set) -> Handle:
    return _allreduce([tensor], average, name, op, prescale_factor,
                      postscale_factor, process_set, False)


def allreduce(tensor: torch.Tensor, average=None, name=None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """Reduce across ranks; returns a new tensor."""
    if _wants_grad([tensor]):
        return grouped_allreduce([tensor], average, name, op,
                                 prescale_factor, postscale_factor,
                                 process_set)[0]
    return allreduce_async(tensor, average, name, op, prescale_factor,
                           postscale_factor, process_set).wait()


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], average=None,
                            name: Optional[str] = None, op=None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set: ProcessSet = global_process_set
                            ) -> Handle:
    """The group negotiated as a whole, then fused by threshold like any
    allreduce (Adasum: one reduction per tensor); ``wait()`` returns the
    list of reduced tensors."""
    return _allreduce(list(tensors), average, name, op, prescale_factor,
                      postscale_factor, process_set, True)


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

def _allgather(tensors, name, process_set, grouped) -> Handle:
    tensors = [t.detach().reshape(1) if t.dim() == 0 else t.detach()
               for t in tensors]
    prefix = "grouped_allgather" if grouped else "allgather"
    return _enqueue(ALLGATHER, tensors, prefix, name, process_set, grouped,
                    list if grouped else _first)


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    process_set: ProcessSet = global_process_set) -> Handle:
    return _allgather([tensor], name, process_set, False)


def allgather(tensor: torch.Tensor, name=None,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """Every rank's rows, concatenated in rank order; the first dimension
    may differ across ranks."""
    if _wants_grad([tensor]):
        return grouped_allgather([tensor], name, process_set)[0]
    return allgather_async(tensor, name, process_set).wait()


def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None,
                            process_set: ProcessSet = global_process_set
                            ) -> Handle:
    return _allgather(list(tensors), name, process_set, True)


def grouped_allgather(tensors: Sequence[torch.Tensor], name=None,
                      process_set: ProcessSet = global_process_set
                      ) -> List[torch.Tensor]:
    if _wants_grad(tensors):
        return list(_ag.GroupedAllgatherFn.apply(process_set, *tensors))
    return grouped_allgather_async(tensors, name, process_set).wait()


# -- reducescatter -------------------------------------------------------------

def _reducescatter(tensors, op, name, process_set, grouped) -> Handle:
    if op == ADASUM:
        raise ValueError("reducescatter supports Sum/Average/Min/Max/Product; "
                         "Adasum is allreduce-only")
    _c.reduce_op(op)
    if any(t.dim() == 0 for t in tensors):
        raise ValueError("reducescatter takes tensors of at least one "
                         "dimension")
    prefix = "grouped_reducescatter" if grouped else "reducescatter"
    return _enqueue(REDUCESCATTER, [t.detach() for t in tensors], prefix,
                    name, process_set, grouped, list if grouped else _first,
                    red_op=op)


def reducescatter_async(tensor: torch.Tensor, op=SUM,
                        name: Optional[str] = None,
                        process_set: ProcessSet = global_process_set
                        ) -> Handle:
    return _reducescatter([tensor], op, name, process_set, False)


def reducescatter(tensor: torch.Tensor, op=SUM, name=None,
                  process_set: ProcessSet = global_process_set
                  ) -> torch.Tensor:
    """The reduction's rows for this rank: earlier ranks take the larger
    shards when the rows do not divide."""
    if _wants_grad([tensor]):
        return grouped_reducescatter([tensor], op, name, process_set)[0]
    return reducescatter_async(tensor, op, name, process_set).wait()


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor], op=SUM,
                                name: Optional[str] = None,
                                process_set: ProcessSet = global_process_set
                                ) -> Handle:
    return _reducescatter(list(tensors), op, name, process_set, True)


def grouped_reducescatter(tensors: Sequence[torch.Tensor], op=SUM,
                          name=None,
                          process_set: ProcessSet = global_process_set
                          ) -> List[torch.Tensor]:
    if _wants_grad(tensors):
        return list(_ag.GroupedReducescatterFn.apply(op, process_set,
                                                     *tensors))
    return grouped_reducescatter_async(tensors, op, name, process_set).wait()


# -- alltoall ------------------------------------------------------------------

def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: Optional[str] = None,
                   process_set: ProcessSet = global_process_set) -> Handle:
    """``wait()`` returns (received rows, list of the counts received)."""
    ps = process_set or global_process_set
    t = tensor.detach()
    n = ps.size()
    if splits is None:
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError("alltoall without splits needs a first "
                             "dimension divisible by %d" % n)
        send = [t.shape[0] // n] * n
    else:
        send = [int(s) for s in (splits.tolist()
                                 if isinstance(splits, torch.Tensor)
                                 else splits)]
        if len(send) != n or min(send) < 0 or sum(send) != t.shape[0]:
            raise ValueError("alltoall splits %s do not split %d rows over "
                             "%d ranks" % (send, t.shape[0], n))
    return _enqueue(ALLTOALL, [t], "alltoall", name, ps, False, _first,
                    splits=send)


def alltoall(tensor: torch.Tensor, splits=None, name=None,
             process_set: ProcessSet = global_process_set):
    """Send ``splits[j]`` rows to rank j (an equal share when None).
    Returns the received rows, and with ``splits`` also the counts
    received from each rank (an int64 tensor)."""
    if _wants_grad([tensor]):
        out, recv = _ag.AlltoallFn.apply(tensor, splits, process_set)
    else:
        out, recv = alltoall_async(tensor, splits, name, process_set).wait()
        recv = torch.tensor(recv, dtype=torch.int64)
    return out if splits is None else (out, recv)


# -- broadcast, barrier, join --------------------------------------------------

def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None,
                     process_set: ProcessSet = global_process_set) -> Handle:
    """Overwrite ``tensor`` in place with rank ``root_rank``'s (a world
    rank, as ``torch.distributed`` takes it)."""
    return _enqueue(BROADCAST, [tensor], "broadcast", name, process_set,
                    False, _first, root_rank=root_rank)


def broadcast_(tensor: torch.Tensor, root_rank: int, name=None,
               process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """In-place broadcast; returns ``tensor``."""
    return broadcast_async_(tensor, root_rank, name, process_set).wait()


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None,
                    process_set: ProcessSet = global_process_set) -> Handle:
    """Every rank receives rank ``root_rank``'s tensor, as a new tensor."""
    return broadcast_async_(tensor.detach().clone(), root_rank, name,
                            process_set)


def broadcast(tensor: torch.Tensor, root_rank: int, name=None,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    if _wants_grad([tensor]):
        return _ag.BroadcastFn.apply(tensor, root_rank, process_set)
    return broadcast_async(tensor, root_rank, name, process_set).wait()


def barrier(process_set: ProcessSet = global_process_set):
    """Return when every rank of the set has called it: the negotiation
    is the barrier (a joined rank need not call it)."""
    _enqueue(BARRIER, [None], "barrier", None, process_set, False,
             _first).wait()


def join(device=None, ranks=None) -> int:
    """This rank is out of data (``hvd.join``): until every rank has
    joined, it contributes zeros to the Sum and Average allreduces the
    others submit (Average then divides by the live contributors), and
    any other collective they submit fails.  Returns the last rank to
    join.  ``ranks=`` is the JAX package's in-process form, where one
    process drives every rank; here each rank calls ``join()``."""
    if ranks is not None:
        raise ValueError("ranks= is the in-process (single-controller) "
                         "form; with one process per rank each rank calls "
                         "join() itself")
    return basics.engine().join().wait()


def synchronize(handle: Handle):
    """Wait on an async handle and return its output."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True if the async op has completed."""
    return handle.poll()
