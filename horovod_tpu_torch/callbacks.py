"""Training-loop callbacks of the port — its copy of
``horovod_tpu/callbacks.py`` (Horovod's Keras callback suite) for
PyTorch.

Callbacks drive a host-side *trainer*, duck-typed:

    trainer.model       the ``nn.Module`` being trained
    trainer.optimizer   its optimizer (a ``DistributedOptimizer``)
    trainer.lr          the learning rate; :class:`Trainer`'s setter
                        writes every parameter group's ``"lr"``

The elastic callbacks take a state with ``commit()``, ``batch`` and
``epoch``: an ``elastic.TorchState`` (or ``ObjectState``) holding those
attributes.
"""

from __future__ import annotations

import math
import numbers
from typing import Callable, Dict, List, Optional, Union

import torch

from .common import basics


class Trainer:
    """The trainer protocol over a model and its optimizer: ``lr`` reads
    the first parameter group's rate and, when set, writes every
    group's."""

    def __init__(self, model: torch.nn.Module, optimizer=None,
                 lr: Optional[float] = None):
        self.model = model
        self.optimizer = optimizer
        if lr is not None:
            self.lr = lr

    @property
    def lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = float(value)


class Callback:
    """The hook surface (the Keras contract Horovod plugs into)."""

    trainer = None

    def set_trainer(self, trainer) -> None:
        self.trainer = trainer

    def on_train_begin(self, logs: Optional[Dict] = None) -> None: ...

    def on_train_end(self, logs: Optional[Dict] = None) -> None: ...

    def on_epoch_begin(self, epoch: int,
                       logs: Optional[Dict] = None) -> None: ...

    def on_epoch_end(self, epoch: int,
                     logs: Optional[Dict] = None) -> None: ...

    def on_batch_begin(self, batch: int,
                       logs: Optional[Dict] = None) -> None: ...

    def on_batch_end(self, batch: int,
                     logs: Optional[Dict] = None) -> None: ...


class CallbackList:
    """Dispatches each hook to a list of callbacks bound to one
    trainer."""

    def __init__(self, callbacks: List[Callback], trainer) -> None:
        self.callbacks = list(callbacks)
        for c in self.callbacks:
            c.set_trainer(trainer)

    def __getattr__(self, hook: str):
        if not hook.startswith("on_"):
            raise AttributeError(hook)

        def fire(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, hook)(*args, **kwargs)

        return fire


class BroadcastVariablesCallback(Callback):
    """At train start, broadcast the model's parameters and buffers and
    the optimizer's state from ``root_rank``, so every rank starts
    identical."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, logs=None):
        from .optim import broadcast_optimizer_state, broadcast_parameters

        t = self.trainer
        broadcast_parameters(t.model.state_dict(), root_rank=self.root_rank)
        if getattr(t, "optimizer", None) is not None:
            broadcast_optimizer_state(t.optimizer, root_rank=self.root_rank)


class MetricAverageCallback(Callback):
    """Average the numeric epoch-end metrics over the ranks before they
    are logged."""

    def on_epoch_end(self, epoch, logs=None):
        if not logs:
            return
        from .ops import collectives as C

        for k, v in list(logs.items()):
            if isinstance(v, numbers.Number):
                x = torch.tensor([float(v)], dtype=torch.float32,
                                 device=basics.device())
                logs[k] = float(C.allreduce(x, C.Average)[0])


class LearningRateScheduleCallback(Callback):
    """An epoch-driven LR multiplier: within [start_epoch, end_epoch]
    set ``trainer.lr = initial_lr * multiplier(epoch)``;
    ``staircase=False`` interpolates per batch over ``steps_per_epoch``
    (without it, per epoch)."""

    def __init__(self, initial_lr: float,
                 multiplier: Union[float, Callable[[float], float]],
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True,
                 steps_per_epoch: Optional[int] = None):
        self.initial_lr = initial_lr
        self.multiplier = (multiplier if callable(multiplier)
                           else (lambda _e: multiplier))
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self._epoch: float = 0.0

    def _in_range(self) -> bool:
        # end_epoch is inclusive at the boundary, so a warmup lands on
        # exactly initial_lr there before going inert.
        return (self._epoch >= self.start_epoch
                and (self.end_epoch is None
                     or self._epoch <= self.end_epoch))

    def _apply(self):
        if self._in_range():
            self.trainer.lr = self.initial_lr * self.multiplier(self._epoch)

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = float(epoch)
        if self.staircase or not self.steps_per_epoch:
            self._apply()

    def on_batch_begin(self, batch, logs=None):
        if not self.staircase and self.steps_per_epoch:
            self._epoch = math.floor(self._epoch) + batch / \
                self.steps_per_epoch
            self._apply()


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual warmup from ``initial_lr / size`` to ``initial_lr`` over
    ``warmup_epochs`` (Goyal et al.: ``lr = initial_lr * (1 + progress *
    (size - 1)) / size``), inert afterwards so that a schedule callback
    listed after it owns the rate."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0):
        size = basics.size()

        def multiplier(epoch: float) -> float:
            progress = min(epoch / warmup_epochs, 1.0)
            return (1.0 + progress * (size - 1)) / size

        super().__init__(initial_lr, multiplier, start_epoch=0,
                         end_epoch=warmup_epochs, staircase=False,
                         steps_per_epoch=steps_per_epoch)
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose and epoch + 1 == self.warmup_epochs:
            print(f"Epoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {self.trainer.lr}.")


class BestModelCheckpoint(Callback):
    """Save the model (and with ``save_optimizer`` the optimizer's state)
    when the monitored epoch-end metric improves, through a
    :class:`~horovod_tpu_torch.checkpoint.CheckpointManager` (rank 0
    writes). In a multi-rank world rank 0's metric decides, so every rank
    takes the same decision."""

    def __init__(self, directory: str, monitor: str = "val_loss",
                 mode: str = "min", save_optimizer: bool = False,
                 max_to_keep: int = 1):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        self.directory = directory
        self.monitor = monitor
        self.mode = mode
        self.save_optimizer = save_optimizer
        self.max_to_keep = max_to_keep
        self.best: Optional[float] = None
        self._mgr = None

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        return value < self.best if self.mode == "min" else value > self.best

    def on_train_begin(self, logs=None):
        from .checkpoint import CheckpointManager

        self._mgr = CheckpointManager(self.directory,
                                      max_to_keep=self.max_to_keep)

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if basics.is_initialized() and basics.size() > 1:
            from .functions import broadcast_object

            value = broadcast_object(
                None if value is None else float(value), root_rank=0,
                name=f"best_ckpt.{self.monitor}")
        if value is None or not self._improved(float(value)):
            return
        self.best = float(value)
        if self._mgr is not None:
            tree = {"model": self.trainer.model.state_dict()}
            if self.save_optimizer:
                tree["optimizer"] = self.trainer.optimizer.state_dict()
            self._mgr.save(epoch, tree, force=True)

    def on_train_end(self, logs=None):
        if self._mgr is not None:
            self._mgr.close()
            self._mgr = None


# -- elastic-state callbacks (duck-typed on commit(), .batch, .epoch) ------

class CommitStateCallback(Callback):
    """``state.commit()`` every ``batches_per_commit`` batches."""

    def __init__(self, state, batches_per_commit: int = 1):
        self.state = state
        self.batches_per_commit = batches_per_commit

    def on_batch_end(self, batch, logs=None):
        if (batch + 1) % self.batches_per_commit == 0:
            self.state.commit()


class UpdateBatchStateCallback(Callback):
    """Track the current batch in the state, so a restored worker
    resumes mid-epoch."""

    def __init__(self, state):
        self.state = state

    def on_batch_end(self, batch, logs=None):
        self.state.batch = batch + 1

    def on_epoch_end(self, epoch, logs=None):
        self.state.batch = 0


class UpdateEpochStateCallback(Callback):
    """Track the current epoch in the state."""

    def __init__(self, state):
        self.state = state

    def on_epoch_begin(self, epoch, logs=None):
        self.state.epoch = epoch
