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
from ..common.message import AVERAGE, SUM


def _api():
    # ops.api imports this module for its synchronous forms.
    from . import api
    return api


class GroupedAllreduceFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, prescale, postscale, process_set, *tensors):
        ctx.args = (op, prescale, postscale, process_set)
        return tuple(_api().grouped_allreduce_async(
            tensors, op=op, prescale_factor=prescale,
            postscale_factor=postscale, process_set=process_set).wait())

    @staticmethod
    def backward(ctx, *grads):
        op, prescale, postscale, ps = ctx.args
        gs = _api().grouped_allreduce_async(
            [g.contiguous() for g in grads], op=op, prescale_factor=prescale,
            postscale_factor=postscale, process_set=ps).wait()
        return (None,) * 4 + tuple(gs)


class GroupedAllgatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, process_set, *tensors):
        ctx.process_set = process_set
        ctx.n_locals = [int(t.shape[0]) if t.dim() else 1 for t in tensors]
        ctx.shapes = [t.shape for t in tensors]
        return tuple(_api().grouped_allgather_async(
            tensors, process_set=process_set).wait())

    @staticmethod
    def backward(ctx, *grads):
        ps, me = ctx.process_set, ctx.process_set.rank()
        summed = _api().grouped_allreduce_async(
            [g.contiguous() for g in grads], op=SUM, process_set=ps).wait()
        # Every member's row counts, to find this rank's rows of each sum.
        rows = torch.tensor(ctx.n_locals, dtype=torch.int64,
                            device=basics.device())
        counts = _api().allgather_async(rows.view(1, -1),
                                        process_set=ps).wait().t()
        own = [s[sum(c[:me]):sum(c[:me + 1])]
               for s, c in zip(summed, counts.tolist())]
        return (None,) + tuple(g.reshape(s) for g, s in zip(own, ctx.shapes))


class BroadcastFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, process_set):
        ctx.root_rank, ctx.process_set = root_rank, process_set
        return _api().broadcast_async(tensor, root_rank,
                                      process_set=process_set).wait()

    @staticmethod
    def backward(ctx, grad):
        g = _api().allreduce_async(grad.contiguous(), op=SUM,
                                   process_set=ctx.process_set).wait()
        if basics.rank() != ctx.root_rank:
            g = torch.zeros_like(g)
        return g, None, None


class GroupedReducescatterFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, process_set, *tensors):
        ctx.op, ctx.process_set = op, process_set
        return tuple(_api().grouped_reducescatter_async(
            tensors, op, process_set=process_set).wait())

    @staticmethod
    def backward(ctx, *grads):
        gs = _api().grouped_allgather_async(
            [g.contiguous() for g in grads],
            process_set=ctx.process_set).wait()
        if ctx.op == AVERAGE:
            gs = [g / ctx.process_set.size() for g in gs]
        return (None, None) + tuple(gs)


class AlltoallFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, splits, process_set):
        ctx.process_set = process_set
        out, recv = _api().alltoall_async(tensor, splits,
                                          process_set=process_set).wait()
        ctx.recv = recv
        recv_t = torch.tensor(recv, dtype=torch.int64)
        ctx.mark_non_differentiable(recv_t)
        return out, recv_t

    @staticmethod
    def backward(ctx, grad, _grad_recv):
        g, _ = _api().alltoall_async(grad.contiguous(), ctx.recv,
                                     process_set=ctx.process_set).wait()
        return g, None, None
