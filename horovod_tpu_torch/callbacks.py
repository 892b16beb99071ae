"""Training-loop callbacks: Horovod's Keras callback set for a torch loop.

Counterpart of ``horovod_tpu/jax/callbacks.py``:
``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback``,
``LearningRateWarmupCallback`` and ``LearningRateScheduleCallback``, small
objects a loop calls at the same hook points.  The learning-rate
callbacks compute ``current_lr`` as the JAX ones do; the loop sets it.
The JAX warmup's ``as_optax_schedule`` becomes ``as_lr_lambda``: the
multiplier of ``initial_lr`` at each step, which
``torch.optim.lr_scheduler.LambdaLR`` takes (it scales the optimizer's
lr, ``initial_lr``, by it).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from .common import basics
from .functions import broadcast_optimizer_state, broadcast_parameters
from .ops.api import AVERAGE, allreduce


class Callback:
    """Hook points of the Keras callback protocol."""

    def on_train_begin(self, state=None):
        pass

    def on_epoch_begin(self, epoch: int, state=None):
        pass

    def on_batch_end(self, batch: int, logs: Optional[Dict] = None):
        pass

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None):
        pass


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the initial state from ``root_rank`` at train begin, so
    every rank starts from the same one: a module's ``state_dict()``, an
    optimizer's state, or a dict or ``named_parameters()`` of tensors."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_train_begin(self, state=None):
        if state is None or self.broadcast_done:
            return state
        if isinstance(state, torch.nn.Module):
            broadcast_parameters(state.state_dict(), self.root_rank)
        elif isinstance(state, torch.optim.Optimizer):
            broadcast_optimizer_state(state, self.root_rank)
        else:
            broadcast_parameters(state, self.root_rank)
        self.broadcast_done = True
        return state


class MetricAverageCallback(Callback):
    """Average the epoch's metrics over every rank before they are
    logged."""

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None):
        if not logs or not basics.is_initialized() or basics.size() <= 1:
            return logs
        for k in list(logs):
            t = torch.tensor([float(logs[k])], dtype=torch.float64,
                             device=basics.device())
            logs[k] = float(allreduce(t, op=AVERAGE,
                                      name="metric.%s" % k).item())
        return logs


class LearningRateWarmupCallback(Callback):
    """Ramp the lr from ``initial_lr`` to ``initial_lr * multiplier``
    (the world's size by default, the linear scaling rule) over the first
    ``warmup_epochs``, exponentially as the reference does."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 steps_per_epoch: Optional[int] = None,
                 multiplier: Optional[float] = None,
                 verbose: bool = False):
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.multiplier = (multiplier if multiplier is not None
                           else float(basics.size()
                                      if basics.is_initialized() else 1))
        self.verbose = verbose
        self.current_lr = initial_lr
        self._epoch = 0

    def lr_at(self, epoch: float) -> float:
        if epoch >= self.warmup_epochs:
            return self.initial_lr * self.multiplier
        frac = epoch / max(self.warmup_epochs, 1e-9)
        return self.initial_lr * self.multiplier ** frac

    def on_batch_end(self, batch: int, logs: Optional[Dict] = None):
        if self.steps_per_epoch is None:
            raise ValueError(
                "LearningRateWarmupCallback needs steps_per_epoch for "
                "per-batch warmup (epoch-granular use is fine without)")
        self.current_lr = self.lr_at(
            self._epoch + batch / float(self.steps_per_epoch))
        if logs is not None:
            logs["lr"] = self.current_lr

    def on_epoch_begin(self, epoch: int, state=None):
        self._epoch = epoch
        self.current_lr = self.lr_at(epoch)
        if self.verbose and (not basics.is_initialized()
                             or basics.rank() == 0):
            print("Epoch %d: warmup lr = %g" % (epoch, self.current_lr))

    def as_lr_lambda(self) -> Callable[[int], float]:
        """step -> the lr's multiple of ``initial_lr``, for ``LambdaLR``
        over an optimizer whose lr is ``initial_lr``."""
        if self.steps_per_epoch is None:
            raise ValueError(
                "as_lr_lambda needs steps_per_epoch to convert the "
                "epoch-based warmup into a per-step schedule")
        warmup_steps = self.warmup_epochs * self.steps_per_epoch

        def factor(step: int) -> float:
            return self.multiplier ** min(step / max(warmup_steps, 1), 1.0)
        return factor


class LearningRateScheduleCallback(Callback):
    """Between ``start_epoch`` and ``end_epoch`` the lr is ``initial_lr *
    multiplier`` (a constant or a function of the epoch), at integer
    epochs when ``staircase``; outside them it stays as it was."""

    def __init__(self, initial_lr: float, multiplier,
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True):
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self._mult = (multiplier if callable(multiplier)
                      else lambda epoch: multiplier)
        self.current_lr = initial_lr

    def _active(self, epoch: float) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def lr_at(self, epoch: float) -> float:
        e = math.floor(epoch) if self.staircase else epoch
        if self._active(e):
            return self.initial_lr * self._mult(e)
        return self.current_lr

    def on_epoch_begin(self, epoch: int, state=None):
        self.current_lr = self.lr_at(epoch)
