"""DistributedOptimizer: gradient hooks that enqueue named allreduces.

Horovod's torch surface (``horovod_tpu/torch/optimizer.py``,
``_allreduce_grad_async``, ``:200``, and the grouped form, ``:233``) with
the numerics of ``horovod_tpu/jax/optimizer.py``:

* every parameter gets a ``register_post_accumulate_grad_hook``;
* with neither ``num_groups`` nor ``groups``, each hook enqueues its
  parameter's gradient as its own allreduce, named
  ``allreduce.<parameter name>`` (from ``named_parameters``, or
  ``param.<index>`` in hook order), while backward goes on; the engine
  fuses what is ready by ``HOROVOD_FUSION_THRESHOLD``;
* groups: ``num_groups`` splits the parameters into that many groups in
  order, ``groups`` lists them (parameters in no group go alone); when
  the last member of a group has its gradient, the group goes out as one
  ``grouped_allreduce``, negotiated as a whole;
* ``gradient_predivide_factor`` f: pre-scale 1/f, Sum, post-scale
  f/size, instead of Average;
* ``backward_passes_per_step`` n: gradients accumulate locally over n
  backward passes, and the sum divided by n is reduced;
* ``compression`` (``Compression.fp16``/``bf16``): each gradient is
  compressed before it is enqueued, so the engine fuses the wire dtype;
  the reduction (with its pre- and post-scale) runs on the wire, and
  each result is decompressed after ``wait()``, the order of the JAX and
  torch surfaces of the JAX package;
* ``op=Adasum`` keeps the hooks and groups; the engine reduces each
  gradient alone (``collectives.adasum_allreduce``), never fused;
* ``step()`` waits for the reductions, writes the results into ``.grad``
  and runs the wrapped optimizer.

``allreduce_gradients`` is the functional form
(``horovod_tpu/jax/optimizer.py:41 allreduce_gradients``, its eager
path): one named allreduce per tensor, then one wait.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, List

import torch

from .common import basics
from .common.process_sets import ProcessSet, global_process_set
from .compression import Compression, check_reduce_safe
from .ops.api import allreduce_async, allreduce_requests
from .ops.engine import wait_all
from .ops.collectives import AVERAGE, SUM

_instances = itertools.count()


def allreduce_gradients(grads, op: str = AVERAGE,
                        compression=Compression.none,
                        process_set: ProcessSet = global_process_set):
    """Reduce gradients across the process set: a tensor, a list or
    tuple of tensors, or a dict of them (taken in sorted key order, as a
    JAX tree flattens one), each enqueued as the named async allreduce
    ``DistributedOptimizer.gradient/<i>`` after ``compression``, then
    all waited for at once and decompressed; returns the same
    structure."""
    check_reduce_safe(compression, "allreduce_gradients")
    if isinstance(grads, torch.Tensor):
        return allreduce_gradients([grads], op, compression, process_set)[0]
    keys = sorted(grads) if isinstance(grads, dict) else None
    leaves = [grads[k] for k in keys] if keys is not None else list(grads)
    handles, ctxs = [], []
    for i, g in enumerate(leaves):
        wire, ctx = compression.compress(g)
        handles.append(allreduce_async(
            wire, op=op, name="DistributedOptimizer.gradient/%d" % i,
            process_set=process_set))
        ctxs.append(ctx)
    outs = [compression.decompress(out, ctx)
            for out, ctx in zip(wait_all(handles), ctxs)]
    if keys is not None:
        return dict(zip(keys, outs))
    return type(grads)(outs) if isinstance(grads, tuple) else outs


class _DistributedOptimizer:
    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None,
                 backward_passes_per_step: int = 1,
                 op: str = AVERAGE,
                 gradient_predivide_factor: float = 1.0,
                 num_groups: int = 0,
                 groups=None,
                 process_set: ProcessSet = global_process_set,
                 compression=Compression.none):
        check_reduce_safe(compression, "DistributedOptimizer")
        if gradient_predivide_factor != 1.0 and op != AVERAGE:
            raise ValueError("gradient_predivide_factor only applies to "
                             "the Average op")
        if int(backward_passes_per_step) < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._opt = optimizer
        self._compression = compression
        self._process_set = process_set
        self.backward_passes_per_step = int(backward_passes_per_step)
        if gradient_predivide_factor != 1.0:
            self._op = SUM
            self._prescale = 1.0 / gradient_predivide_factor
            self._postscale = gradient_predivide_factor / process_set.size()
        else:
            self._op, self._prescale, self._postscale = op, 1.0, 1.0
        self._require_sync = True

        hooked = [p for group in optimizer.param_groups
                  for p in group["params"] if p.requires_grad]
        self._names: Dict[int, str] = {
            id(p): "param.%d" % i for i, p in enumerate(hooked)}
        if named_parameters is not None:
            named = list(named_parameters)
            names = [n for n, _ in named]
            if len(set(names)) < len(names):
                raise ValueError("named_parameters contains duplicate names")
            covered = {id(p) for _, p in named}
            if any(id(p) not in covered for p in hooked):
                raise ValueError(
                    "named_parameters must name every parameter in "
                    "optimizer.param_groups")
            self._names.update((id(p), n) for n, p in named)
        self._instance = next(_instances)
        self._groups = self._make_groups(hooked, num_groups, groups)
        self._group_of: Dict[int, int] = {
            id(p): gid for gid, members in enumerate(self._groups)
            for p in members}
        self._hooked = hooked
        self._passes: Dict[int, int] = {id(p): 0 for p in hooked}
        self._ready: Dict[int, List[torch.Tensor]] = {}
        self._sent = set()
        self._requests: Dict[tuple, list] = {}
        self._handles: List[tuple] = []
        self._hook_handles = [p.register_post_accumulate_grad_hook(
            self._hook) for p in hooked]

    @staticmethod
    def _make_groups(hooked, num_groups, groups):
        """The explicit groups; a parameter in none is reduced alone."""
        if isinstance(groups, int):
            num_groups, groups = groups, None
        if groups is not None:
            hooked_ids = {id(p) for p in hooked}
            out, seen = [], set()
            for members in groups:
                members = [p for p in members if p.requires_grad]
                for p in members:
                    if id(p) in seen:
                        raise ValueError(
                            "parameter appears in more than one group")
                    if id(p) not in hooked_ids:
                        raise ValueError(
                            "groups names a parameter that is not in this "
                            "optimizer's param_groups")
                    seen.add(id(p))
                out.append(members)
            return [g for g in out if g]
        if num_groups <= 0 or not hooked:
            return []
        n = min(num_groups, len(hooked))
        size, rem = divmod(len(hooked), n)
        out, start = [], 0
        for gid in range(n):
            stop = start + size + (1 if gid < rem else 0)
            out.append(hooked[start:stop])
            start = stop
        return out

    # -- Horovod surface ----------------------------------------------------

    def __getattr__(self, item):
        return getattr(self._opt, item)

    @property
    def param_groups(self):
        return self._opt.param_groups

    @property
    def state(self):
        return self._opt.state

    def _hook(self, p: torch.Tensor):
        key = id(p)
        self._passes[key] += 1
        if self._passes[key] < self.backward_passes_per_step:
            return
        if key in self._sent or any(
                q is p for q in self._ready.get(self._group_of.get(key), ())):
            raise AssertionError(
                "gradient of a parameter produced more than "
                "backward_passes_per_step times before step()")
        gid = self._group_of.get(key)
        if gid is None:
            self._send([p])
            return
        ready = self._ready.setdefault(gid, [])
        ready.append(p)
        if len(ready) == len(self._groups[gid]):
            self._fire(gid)

    def _fire(self, gid: int):
        ready = {id(p) for p in self._ready.pop(gid, [])}
        # Group order is construction order, identical on every rank.
        params = [p for p in self._groups[gid] if id(p) in ready]
        if params:
            self._send(params, gid)

    def _send(self, params, gid=None):
        """Enqueue the gradients of ``params``: one allreduce, or the
        group ``gid`` as one grouped allreduce."""
        n = self.backward_passes_per_step
        wires, ctxs = zip(*(self._compression.compress(
            p.grad if n == 1 else p.grad / n) for p in params))
        for p in params:
            self._passes[id(p)] = 0
            self._sent.add(id(p))
        # A parameter's (or group's) requests repeat every step: built
        # once per wire dtype and shape, since the hooks are on the
        # backward pass's critical path.
        key = (gid, tuple(id(p) for p in params),
               tuple((w.dtype, w.shape) for w in wires))
        reqs = self._requests.get(key)
        if reqs is None:
            reqs = self._requests[key] = allreduce_requests(
                wires, op=self._op, prescale_factor=self._prescale,
                postscale_factor=self._postscale,
                process_set=self._process_set, grouped=gid is not None,
                name="allreduce." + self._names[id(params[0])]
                if gid is None else "DistributedOptimizer.o%d.group%d"
                % (self._instance, gid))
        self._handles.append((params, ctxs, basics.engine().enqueue(
            reqs, list(wires), list)))

    def synchronize(self):
        """Wait for every outstanding reduction and install the results
        in ``.grad``.  A gradient not yet sent (a frozen branch, fewer
        backward passes than ``backward_passes_per_step``, an incomplete
        group) goes out now; a group over the members that have one."""
        for p in self._hooked:
            key = id(p)
            gid = self._group_of.get(key)
            if (self._passes[key] > 0 and p.grad is not None
                    and key not in self._sent
                    and not any(q is p for q in self._ready.get(gid, ()))):
                if gid is None:
                    self._send([p])
                else:
                    self._ready.setdefault(gid, []).append(p)
        for gid in list(self._ready):
            self._fire(gid)
        results = wait_all([h for _, _, h in self._handles])
        for (params, ctxs, _), outs in zip(self._handles, results):
            for p, ctx, out in zip(params, ctxs, outs):
                p.grad.copy_(self._compression.decompress(out, ctx))
        self._handles.clear()
        self._sent.clear()

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Inside this context ``step()`` does not call ``synchronize()``
        (for use after a manual call)."""
        self._require_sync = False
        try:
            yield
        finally:
            self._require_sync = True

    def step(self, closure=None):
        if self._require_sync:
            self.synchronize()
        return self._opt.step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles or any(self._ready.values()):
            raise AssertionError(
                "zero_grad called with outstanding gradient reductions; "
                "call step() or synchronize() first")
        return self._opt.zero_grad(*args, **kwargs)

    def state_dict(self):
        return self._opt.state_dict()

    def load_state_dict(self, *args, **kwargs):
        return self._opt.load_state_dict(*args, **kwargs)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         backward_passes_per_step: int = 1,
                         op: str = AVERAGE,
                         gradient_predivide_factor: float = 1.0,
                         num_groups: int = 0,
                         groups=None,
                         process_set: ProcessSet = global_process_set,
                         compression=Compression.none
                         ) -> _DistributedOptimizer:
    """Wrap a torch optimizer for synchronous data-parallel training."""
    return _DistributedOptimizer(
        optimizer, named_parameters, backward_passes_per_step, op,
        gradient_predivide_factor, num_groups, groups, process_set,
        compression)
