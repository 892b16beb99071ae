"""DistributedOptimizer: gradient hooks, then one fused allreduce.

Horovod's torch surface (``horovod_tpu/torch/optimizer.py``) with the
numerics of ``horovod_tpu/jax/optimizer.py``:

* every parameter gets a ``register_post_accumulate_grad_hook``; when the
  last member of a group has its gradient, the group's gradients go out
  as one fused allreduce (one buffer per dtype), asynchronously, while
  backward goes on;
* groups: ``num_groups`` splits the parameters into that many groups in
  order, ``groups`` lists them; with neither, all parameters form one
  group (the fusion that the negotiation engine will size in a later
  slice);
* ``gradient_predivide_factor`` f: pre-scale 1/f, Sum, post-scale
  f/size, instead of Average;
* ``backward_passes_per_step`` n: gradients accumulate locally over n
  backward passes, and the sum divided by n is reduced;
* ``compression`` (``Compression.fp16``/``bf16``): each gradient is
  compressed before it joins its group's buffer, so the group's
  gradients fuse into one buffer of the wire dtype; the reduction (with
  its pre- and post-scale) runs on the wire, and each result is
  decompressed after ``wait()``, the order of the JAX and torch
  surfaces of the JAX package;
* ``step()`` waits for the reductions, writes the results into ``.grad``
  and runs the wrapped optimizer.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from .common.process_sets import ProcessSet, global_process_set
from .compression import Compression, check_reduce_safe
from .ops.collectives import AVERAGE, SUM, fused_allreduce_async


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
        self._groups = self._make_groups(hooked, num_groups, groups)
        self._group_of: Dict[int, int] = {
            id(p): gid for gid, members in enumerate(self._groups)
            for p in members}
        self._passes: Dict[int, int] = {id(p): 0 for p in hooked}
        self._ready: Dict[int, List[torch.Tensor]] = {}
        self._handles: List[tuple] = []
        self._hook_handles = [p.register_post_accumulate_grad_hook(
            self._hook) for p in hooked]

    @staticmethod
    def _make_groups(hooked, num_groups, groups):
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
            # Parameters left out of every group reduce one by one.
            out.extend([p] for p in hooked if id(p) not in seen)
            return [g for g in out if g]
        n = min(num_groups, len(hooked)) if num_groups > 0 else 1
        if not hooked:
            return []
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
        gid = self._group_of[key]
        ready = self._ready.setdefault(gid, [])
        if any(q is p for q in ready):
            raise AssertionError(
                "gradient of a parameter produced more than "
                "backward_passes_per_step times before step()")
        ready.append(p)
        if len(ready) == len(self._groups[gid]):
            self._fire(gid)

    def _fire(self, gid: int):
        ready = {id(p) for p in self._ready.pop(gid, [])}
        # Group order is construction order, identical on every rank.
        params = [p for p in self._groups[gid] if id(p) in ready]
        if not params:
            return
        n = self.backward_passes_per_step
        wires, ctxs = zip(*(self._compression.compress(
            p.grad if n == 1 else p.grad / n) for p in params))
        for p in params:
            self._passes[id(p)] = 0
        self._handles.append((params, ctxs, fused_allreduce_async(
            wires, self._op, self._prescale, self._postscale,
            self._process_set)))

    def synchronize(self):
        """Wait for every outstanding reduction and install the results
        in ``.grad``.  A group that is not complete (a frozen branch, or
        fewer backward passes than ``backward_passes_per_step``) goes out
        now over the members that have a gradient."""
        for gid, members in enumerate(self._groups):
            for p in members:
                if (self._passes[id(p)] > 0 and p.grad is not None
                        and not any(q is p
                                    for q in self._ready.get(gid, []))):
                    self._ready.setdefault(gid, []).append(p)
        for gid in list(self._ready):
            self._fire(gid)
        for params, ctxs, handle in self._handles:
            for p, ctx, out in zip(params, ctxs, handle.wait()):
                p.grad.copy_(self._compression.decompress(out, ctx))
        self._handles.clear()

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
