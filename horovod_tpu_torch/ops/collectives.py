"""The engine's executor: each negotiated collective over
``torch.distributed`` (NCCL on CUDA, gloo on the CPU).

These functions run on the engine's cycle thread (``ops/engine.py``), in
the order the coordinator broadcast, with the negotiated sizes and, on a
joined rank, zeros in place of the tensors it did not submit.
Counterpart of ``horovod_tpu.ops.xla_ops`` (``_allreduce_shard_fn``,
``fused_allreduce``, ``MeshCollectives``) and, for Adasum,
``horovod_tpu.ops.multihost`` (``adasum_combine``, ``_reduce_block``):

* ``x * pre`` with the factor cast to ``x``'s dtype, then the reduction,
  then ``r * post`` likewise;
* Average sums, then divides in f32 for floating types and
  floor-divides for integer types;
* a fused allreduce flattens its tensors (one dtype), concatenates them
  into one buffer, runs one collective and splits the result back;
* Adasum never fuses: each tensor goes alone through log2(N) rounds in
  which rank r swaps its vector with rank r ^ stride (strides N/2, ..., 1;
  ``batch_isend_irecv``) and both merge the pair with ``adasum_pair``,
  the lower rank's vector first, so both hold the same bits and the
  rounds repeat ``adasum_reduce_stacked``'s halving tree; the result is
  cast back to the payload dtype every round;
* allgather takes the members' first dimensions from the negotiation and
  pads each rank's rows to the largest; reducescatter gives earlier
  members the larger shards of rows that do not divide
  (``uneven_chunks``); alltoall sends ``send[j]`` rows to member j and
  receives ``recv[j]`` from it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..common.message import (ADASUM, AVERAGE, MAX, MIN, PRODUCT,  # noqa: F401
                              SUM)
from ..common.process_sets import ProcessSet, global_process_set
from ..utils.adasum import adasum_pair, check_power_of_two

ADASUM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_DIST_OPS = {
    SUM: dist.ReduceOp.SUM,
    AVERAGE: dist.ReduceOp.SUM,
    MIN: dist.ReduceOp.MIN,
    MAX: dist.ReduceOp.MAX,
    PRODUCT: dist.ReduceOp.PRODUCT,
}


def handle_average_backwards_compatibility(op, average):
    """Reconcile Horovod's legacy ``average=`` argument with ``op=``."""
    if op is not None and average is not None:
        raise ValueError("`average` and `op` are mutually exclusive")
    if op is None:
        return AVERAGE if average is None or average else SUM
    return op


def reduce_op(op: str):
    try:
        return _DIST_OPS[op]
    except KeyError:
        raise ValueError("unknown reduce op %r" % (op,)) from None


def scale_(buf: torch.Tensor, factor: float):
    """``buf *= factor`` with the factor cast to the buffer's dtype first,
    as x * pre.astype(x.dtype) does: bf16 data sees a bf16-rounded factor,
    integers a truncated one.  The cast is made on the host, so scaling
    makes no host synchronisation."""
    if factor != 1.0:
        cast = torch.tensor(factor, dtype=torch.float32).to(buf.dtype).item()
        buf.mul_(cast)


def average(buf: torch.Tensor, n: int) -> torch.Tensor:
    """The flat Average of a sum over ``n`` ranks.  A floating sum is
    multiplied by the reciprocal of ``n`` in f32 (f64 stays f64) and cast
    back: what XLA compiles the reference's ``r / size`` to, and what the
    hierarchical legs compute (``multihost._axis0_reduce``), so the result
    is the same on every device.  A division would round otherwise on the
    CPU.  Integers floor-divide, as the reference's ``r // size``."""
    if buf.is_floating_point():
        wide = torch.promote_types(buf.dtype, torch.float32)
        return (buf.to(wide) * (1.0 / n)).to(buf.dtype)
    return torch.div(buf, n, rounding_mode="floor")


def uneven_chunks(total_rows: int, n: int):
    """Rows and first row of each member's shard: earlier members take
    the larger shards (``xla_ops.uneven_chunks``)."""
    base, rem = divmod(total_rows, n)
    rows = [base + (1 if i < rem else 0) for i in range(n)]
    offs = [sum(rows[:i]) for i in range(n)]
    return rows, offs


def allreduce(tensors: Sequence[torch.Tensor], op: str, prescale: float,
              postscale: float, n: int, group) -> List[torch.Tensor]:
    """One collective over the concatenation of ``tensors`` (one dtype,
    an ``n``-member set); returns each tensor's reduction, in its shape,
    as a view of the fused buffer."""
    # The flattening and the split back run in C++ (the helpers DDP
    # uses), not per tensor in Python; one tensor is copied, since the
    # collective works in place.
    buf = (tensors[0].reshape(-1).clone() if len(tensors) == 1
           else _flatten_dense_tensors(tensors))
    scale_(buf, prescale)
    dist.all_reduce(buf, op=reduce_op(op), group=group)
    if op == AVERAGE and n > 1:  # x / 1 is x, bit for bit
        buf = average(buf, n)
    scale_(buf, postscale)
    return list(_unflatten_dense_tensors(buf, tensors))


def adasum_allreduce(tensor: torch.Tensor, prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set: ProcessSet = global_process_set
                     ) -> torch.Tensor:
    """Adasum of ``tensor`` over the set, on every member: pre-scale, the
    XOR-partner rounds, post-scale.  Needs a power-of-two set and an
    f32, bf16 or f16 tensor."""
    if tensor.dtype not in ADASUM_DTYPES:
        raise ValueError("Adasum reduces f32, bf16 or f16 tensors, got %s"
                         % tensor.dtype)
    n = process_set.size()
    check_power_of_two(n)
    me, group = process_set.rank(), process_set.group
    v = tensor.detach().contiguous().clone()
    scale_(v, prescale_factor)
    stride = n // 2
    while stride >= 1:
        peer = process_set.global_rank(me ^ stride)
        # Every element is received: torch.empty's stale bytes never stay.
        recv = torch.empty_like(v)
        for work in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, v, peer, group),
                 dist.P2POp(dist.irecv, recv, peer, group)]):
            work.wait()
        v = adasum_pair(v, recv) if me & stride == 0 else adasum_pair(recv, v)
        stride //= 2
    scale_(v, postscale_factor)
    return v


def broadcast_(tensor: torch.Tensor, root_rank: int, group) -> torch.Tensor:
    """Overwrite ``tensor`` with world rank ``root_rank``'s."""
    dist.broadcast(tensor, src=root_rank, group=group)
    return tensor


def allgather(tensor: torch.Tensor, counts: Sequence[int],
              group) -> torch.Tensor:
    """Every member's rows in member order; member r has ``counts[r]``."""
    n, m = len(counts), max(counts)
    send = tensor.detach().contiguous()
    if send.shape[0] < m:
        send = torch.cat([send, send.new_zeros(m - send.shape[0],
                                               *send.shape[1:])])
    out = send.new_empty(n * m, *send.shape[1:])
    dist.all_gather_into_tensor(out, send, group=group)
    if min(counts) == m:
        return out
    return torch.cat([out[r * m:r * m + c] for r, c in enumerate(counts)])


def reducescatter(tensor: torch.Tensor, op: str, n: int, me: int,
                  group) -> torch.Tensor:
    """The reduction's rows of member ``me``."""
    t = tensor.detach()
    counts, offs = uneven_chunks(t.shape[0], n)
    m = counts[0]
    send = t.contiguous()
    if m * n != t.shape[0]:
        # Pad each shard to the largest; the padded rows reduce among
        # themselves and are cut off after.
        send = t.new_zeros(n * m, *t.shape[1:])
        for r in range(n):
            send[r * m:r * m + counts[r]] = t[offs[r]:offs[r] + counts[r]]
    out = t.new_empty(m, *t.shape[1:])
    dist.reduce_scatter_tensor(out, send, op=reduce_op(op), group=group)
    out = out[:counts[me]]
    return average(out, n) if op == AVERAGE and n > 1 else out


def alltoall(tensor: torch.Tensor, send: Sequence[int],
             recv: Sequence[int], group) -> torch.Tensor:
    """Rows ``send[j]`` (in order) to member j; returns the rows received,
    in sender order."""
    t = tensor.detach().contiguous()
    out = t.new_empty(sum(recv), *t.shape[1:])
    dist.all_to_all_single(out, t, list(recv), list(send), group=group)
    return out
