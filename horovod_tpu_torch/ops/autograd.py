"""Autograd for the collectives: the backward rules of the reference's
differentiable collectives (``horovod_tpu/torch/mpi_ops.py``, after
upstream Horovod's):

* allreduce: the upstream gradient allreduced with the same op and
  scales;
* allgather: the gradients summed over the ranks, and this rank's rows
  of the sum;
* broadcast: the gradients summed over the ranks, on the root; zeros
  elsewhere;
* reducescatter: the shards' gradients allgathered (over the set's size
  for Average);
* alltoall: the gradient sent back along the forward's received splits;
* the grouped forms: the same per tensor.
"""

from __future__ import annotations

import torch

from ..common import basics
from . import collectives as C


class GroupedAllreduceFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, prescale, postscale, process_set, *tensors):
        ctx.args = (op, prescale, postscale, process_set)
        return tuple(C.fused_allreduce_async(tensors, op, prescale, postscale,
                                             process_set).wait())

    @staticmethod
    def backward(ctx, *grads):
        op, prescale, postscale, ps = ctx.args
        gs = C.fused_allreduce_async([g.contiguous() for g in grads], op,
                                     prescale, postscale, ps).wait()
        return (None,) * 4 + tuple(gs)


class GroupedAllgatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, process_set, *tensors):
        ctx.process_set = process_set
        ctx.n_locals = [int(t.shape[0]) if t.dim() else 1 for t in tensors]
        ctx.shapes = [t.shape for t in tensors]
        return tuple(C.allgather_async(tensors, process_set).wait())

    @staticmethod
    def backward(ctx, *grads):
        ps, me = ctx.process_set, ctx.process_set.rank()
        summed = C.fused_allreduce_async([g.contiguous() for g in grads],
                                         C.SUM, process_set=ps).wait()
        # Every member's row counts, to find this rank's rows of each sum.
        rows = torch.tensor(ctx.n_locals, dtype=torch.int64,
                            device=basics.device())
        counts = C.allgather_async([rows.view(1, -1)], ps).wait()[0].t()
        own = [s[sum(c[:me]):sum(c[:me + 1])]
               for s, c in zip(summed, counts.tolist())]
        return (None,) + tuple(g.reshape(s) for g, s in zip(own, ctx.shapes))


class BroadcastFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, process_set):
        ctx.root_rank, ctx.process_set = root_rank, process_set
        return C.broadcast_async_(tensor.detach().clone(), root_rank,
                                  process_set).wait()

    @staticmethod
    def backward(ctx, grad):
        g = C.fused_allreduce_async([grad.contiguous()], C.SUM,
                                    process_set=ctx.process_set).wait()[0]
        if basics.rank() != ctx.root_rank:
            g = torch.zeros_like(g)
        return g, None, None


class GroupedReducescatterFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, process_set, *tensors):
        ctx.op, ctx.process_set = op, process_set
        return tuple(C.reducescatter_async(tensors, op, process_set).wait())

    @staticmethod
    def backward(ctx, *grads):
        gs = C.allgather_async([g.contiguous() for g in grads],
                               ctx.process_set).wait()
        if ctx.op == C.AVERAGE:
            gs = [g / ctx.process_set.size() for g in gs]
        return (None, None) + tuple(gs)


class AlltoallFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, splits, process_set):
        ctx.process_set = process_set
        out, recv = C.alltoall_async(tensor, splits, process_set).wait()
        ctx.recv = recv
        recv_t = torch.tensor(recv, dtype=torch.int64)
        ctx.mark_non_differentiable(recv_t)
        return out, recv_t

    @staticmethod
    def backward(ctx, grad, _grad_recv):
        g, _ = C.alltoall_async(grad.contiguous(), ctx.recv,
                                ctx.process_set).wait()
        return g, None, None
