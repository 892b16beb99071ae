"""Allreduce over ``torch.distributed``: reduce ops, scaling and fusion.

Counterpart of ``horovod_tpu.ops.xla_ops`` (``_allreduce_shard_fn``,
``fused_allreduce``) and ``horovod_tpu.jax.spmd.allreduce``:

* ``x * pre`` with the factor cast to ``x``'s dtype, then the reduction,
  then ``r * post`` likewise;
* Average sums, then divides in f32 for floating types and
  floor-divides for integer types;
* the fused form flattens its tensors, concatenates them into one buffer
  per dtype, runs one collective per buffer and splits the result back.

Adasum, joined ranks and power-of-two buckets come with a later slice.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from ..common import basics
from ..common.process_sets import ProcessSet, global_process_set

# Reduction ops (Horovod's ReduceOp names).
SUM = "Sum"
AVERAGE = "Average"
MIN = "Min"
MAX = "Max"
PRODUCT = "Product"
ADASUM = "Adasum"

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


def _check(tensors: Sequence[torch.Tensor]):
    dev = basics.device()
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(
                "this rank's collectives run on %s; got a tensor on %s"
                % (dev, t.device))


def _reduce_op(op: str):
    if op == ADASUM:
        raise NotImplementedError("Adasum is not ported yet")
    try:
        return _DIST_OPS[op]
    except KeyError:
        raise ValueError("unknown reduce op %r" % (op,)) from None


def fused_allreduce_async(tensors: Sequence[torch.Tensor], op: str = AVERAGE,
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          process_set: ProcessSet = global_process_set
                          ) -> Handle:
    """Reduce ``tensors`` across ranks with one collective per dtype.
    ``wait()`` returns the reduced tensors, in order, with their shapes."""
    red = _reduce_op(op)
    tensors = list(tensors)
    _check(tensors)
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
                if buf.is_floating_point():
                    buf = (buf.float() / n).to(buf.dtype)
                else:
                    buf = torch.div(buf, n, rounding_mode="floor")
            _scale_(buf, postscale_factor)
            parts = buf.split([tensors[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                out[i] = part.view(tensors[i].shape)
        return out

    return Handle(works, finish)


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     process_set: ProcessSet = global_process_set
                     ) -> Handle:
    """Overwrite ``tensor`` in place with rank ``root_rank``'s."""
    _check([tensor])
    work = dist.broadcast(tensor, src=root_rank, group=process_set.group,
                          async_op=True)
    return Handle([work], lambda: tensor)
