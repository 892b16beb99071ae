"""Collectives over ``torch.distributed``: allreduce (reduce ops, scaling,
fusion and Adasum), allgather, reducescatter, alltoall, broadcast and
barrier, each over a process set.

Counterpart of ``horovod_tpu.ops.xla_ops`` (``_allreduce_shard_fn``,
``fused_allreduce``, ``MeshCollectives``), ``horovod_tpu.jax.spmd`` and,
for Adasum, ``horovod_tpu.ops.multihost`` (``adasum_combine``,
``_reduce_block``):

* ``x * pre`` with the factor cast to ``x``'s dtype, then the reduction,
  then ``r * post`` likewise;
* Average sums, then divides in f32 for floating types and
  floor-divides for integer types;
* the fused form flattens its tensors, concatenates them into one buffer
  per dtype, runs one collective per buffer and splits the result back;
* Adasum never fuses: each tensor goes alone through log2(N) rounds in
  which rank r swaps its vector with rank r ^ stride (strides N/2, ..., 1;
  ``batch_isend_irecv``) and both merge the pair with ``adasum_pair``,
  the lower rank's vector first, so both hold the same bits and the
  rounds repeat ``adasum_reduce_stacked``'s halving tree; the result is
  cast back to the payload dtype every round;
* allgather takes a first dimension that differs across ranks (the sizes
  are gathered first, the rows padded to the largest); reducescatter
  gives earlier ranks the larger shards of rows that do not divide
  (``uneven_chunks``); alltoall sends ``splits[j]`` rows to rank j and
  returns the rows and the counts it received.

Each call goes straight to ``torch.distributed``; callers issue
collectives in the same order on every rank.  Joined ranks, power-of-two
buckets and callbacks come with the negotiating engine.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from ..common import basics
from ..common.process_sets import ProcessSet, global_process_set
from ..utils.adasum import adasum_pair, check_power_of_two

# Reduction ops (Horovod's ReduceOp names).
SUM = "Sum"
AVERAGE = "Average"
MIN = "Min"
MAX = "Max"
PRODUCT = "Product"
ADASUM = "Adasum"

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


class Handle:
    """An outstanding collective: ``torch.distributed`` work objects and
    the step that turns their buffers into the result."""

    def __init__(self, works: Sequence, finish: Callable[[], object]):
        self._works = [w for w in works if w is not None]
        self._finish = finish
        self._done = False
        self._result = None

    def poll(self) -> bool:
        return self._done or all(w.is_completed() for w in self._works)

    def wait(self):
        if not self._done:
            for w in self._works:
                w.wait()
            self._result = self._finish()
            self._done = True
        return self._result

    def then(self, fn: Callable) -> "Handle":
        """A handle on the same work whose result is ``fn(result)``."""
        return Handle(self._works, lambda: fn(self._finish()))


def _scale_(buf: torch.Tensor, factor: float):
    # The factor is cast to the buffer's dtype first, as x * pre.astype(
    # x.dtype) does: bf16 data sees a bf16-rounded factor, integers a
    # truncated one.
    if factor != 1.0:
        buf.mul_(torch.tensor(factor, dtype=torch.float32)
                 .to(buf.dtype).to(buf.device))


def _check(tensors: Sequence[torch.Tensor],
           process_set: ProcessSet = global_process_set):
    dev = basics.device()
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(
                "this rank's collectives run on %s; got a tensor on %s"
                % (dev, t.device))
    if not process_set.included():
        raise ValueError("rank %d is not part of %r"
                         % (basics.rank(), process_set))


def _reduce_op(op: str):
    try:
        return _DIST_OPS[op]
    except KeyError:
        raise ValueError("unknown reduce op %r" % (op,)) from None


def _average(buf: torch.Tensor, n: int) -> torch.Tensor:
    if buf.is_floating_point():
        return (buf.float() / n).to(buf.dtype)
    return torch.div(buf, n, rounding_mode="floor")


def uneven_chunks(total_rows: int, n: int):
    """Rows and first row of each member's shard: earlier members take
    the larger shards (``xla_ops.uneven_chunks``)."""
    base, rem = divmod(total_rows, n)
    rows = [base + (1 if i < rem else 0) for i in range(n)]
    offs = [sum(rows[:i]) for i in range(n)]
    return rows, offs


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
    _scale_(v, prescale_factor)
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
    _scale_(v, postscale_factor)
    return v


def fused_allreduce_async(tensors: Sequence[torch.Tensor], op: str = AVERAGE,
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          process_set: ProcessSet = global_process_set
                          ) -> Handle:
    """Reduce ``tensors`` across ranks with one collective per dtype
    (Adasum: one reduction per tensor).  ``wait()`` returns the reduced
    tensors, in order, with their shapes."""
    tensors = list(tensors)
    _check(tensors, process_set)
    if op == ADASUM:
        out = [adasum_allreduce(t, prescale_factor, postscale_factor,
                                process_set) for t in tensors]
        return Handle([], lambda: out)
    red = _reduce_op(op)
    n = process_set.size()
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    buffers, works = [], []
    for dtype, idx in by_dtype.items():
        buf = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        _scale_(buf, prescale_factor)
        works.append(dist.all_reduce(buf, op=red, group=process_set.group,
                                     async_op=True))
        buffers.append((idx, buf))

    def finish() -> List[torch.Tensor]:
        out: List[torch.Tensor] = [None] * len(tensors)
        for idx, buf in buffers:
            if op == AVERAGE:
                buf = _average(buf, n)
            _scale_(buf, postscale_factor)
            parts = buf.split([tensors[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                out[i] = part.view(tensors[i].shape)
        return out

    return Handle(works, finish)


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     process_set: ProcessSet = global_process_set
                     ) -> Handle:
    """Overwrite ``tensor`` in place with rank ``root_rank``'s (a world
    rank, as ``torch.distributed`` takes it)."""
    _check([tensor], process_set)
    work = dist.broadcast(tensor, src=root_rank, group=process_set.group,
                          async_op=True)
    return Handle([work], lambda: tensor)


def allgather_async(tensors: Sequence[torch.Tensor],
                    process_set: ProcessSet = global_process_set) -> Handle:
    """Concatenate each tensor's rows from every member, in rank order;
    first dimensions may differ across ranks, the others must not.  One
    exchange of the sizes for the whole group, then one gather per tensor
    of rows padded to the largest count.  ``wait()`` returns the list."""
    tensors = [t.detach().reshape(1) if t.dim() == 0 else t.detach()
               for t in tensors]
    _check(tensors, process_set)
    n, group = process_set.size(), process_set.group
    dev = basics.device()
    rows = torch.tensor([t.shape[0] for t in tensors], dtype=torch.int64,
                        device=dev)
    every = torch.empty(n * len(tensors), dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(every, rows, group=group)
    counts = every.view(n, len(tensors)).t().tolist()
    works, gathered = [], []
    for t, count in zip(tensors, counts):
        m = max(count)
        send = t.contiguous()
        if t.shape[0] < m:
            send = torch.cat([send, send.new_zeros(m - t.shape[0],
                                                   *t.shape[1:])])
        out = send.new_empty(n * m, *t.shape[1:])
        works.append(dist.all_gather_into_tensor(out, send, group=group,
                                                 async_op=True))
        gathered.append((out, count, m))

    def finish() -> List[torch.Tensor]:
        return [out if min(count) == m else
                torch.cat([out[r * m:r * m + c] for r, c in enumerate(count)])
                for out, count, m in gathered]

    return Handle(works, finish)


def reducescatter_async(tensors: Sequence[torch.Tensor], op: str = SUM,
                        process_set: ProcessSet = global_process_set
                        ) -> Handle:
    """Reduce each tensor over the members and give member r its shard of
    rows (``uneven_chunks``: earlier members take the larger shards).
    ``wait()`` returns the list of this rank's shards."""
    if op == ADASUM:
        raise ValueError("reducescatter supports Sum/Average/Min/Max/Product; "
                         "Adasum is allreduce-only")
    red = _reduce_op(op)
    tensors = [t.detach() for t in tensors]
    _check(tensors, process_set)
    n, me, group = process_set.size(), process_set.rank(), process_set.group
    works, shards = [], []
    for t in tensors:
        if t.dim() == 0:
            raise ValueError("reducescatter takes tensors of at least one "
                             "dimension")
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
        works.append(dist.reduce_scatter_tensor(out, send, op=red, group=group,
                                                async_op=True))
        shards.append(out[:counts[me]])

    def finish() -> List[torch.Tensor]:
        return [_average(s, n) if op == AVERAGE else s for s in shards]

    return Handle(works, finish)


def alltoall_async(tensor: torch.Tensor, splits=None,
                   process_set: ProcessSet = global_process_set) -> Handle:
    """Send ``splits[j]`` rows (in order) to member j, or an equal share
    of the rows to each when ``splits`` is None.  ``wait()`` returns the
    received rows, in sender order, and the list of counts received."""
    t = tensor.detach().contiguous()
    _check([t], process_set)
    n, group = process_set.size(), process_set.group
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
    counts = torch.tensor(send, dtype=torch.int64, device=t.device)
    got = torch.empty_like(counts)
    dist.all_to_all_single(got, counts, group=group)
    recv = got.tolist()
    out = t.new_empty(sum(recv), *t.shape[1:])
    work = dist.all_to_all_single(out, t, recv, send, group=group,
                                  async_op=True)
    return Handle([work], lambda: (out, recv))


def barrier(process_set: ProcessSet = global_process_set):
    """Return when every member has called it."""
    _check([], process_set)
    dist.barrier(group=process_set.group)
