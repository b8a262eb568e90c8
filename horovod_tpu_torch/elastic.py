"""``hvd.elastic`` of the port: ``State``/``ObjectState`` and the ``run``
decorator (``common/elastic.py``), the preemption hooks, and
:class:`TorchState` with its model, optimizer and sampler handlers — the
counterpart of ``horovod_tpu/elastic.py`` and
``horovod_tpu/torch/elastic.py``::

    state = hvd.elastic.TorchState(model, optimizer, step=0)

    @hvd.elastic.run
    def train(state):
        while state.step < steps:
            ...
            state.step += 1
            state.commit()

A model's and an optimizer's snapshot is a clone of their state dicts on
their own device (``commit()`` copies on the card; ``checkpoint.
save_state`` copies the committed snapshot to the host). An optimizer's
``state_dict()`` carries this rank's own state beside the replicated
one: a ``DistributedOptimizer``'s ``"ef_state"`` (the int8_ef residuals
and rounding step) and a ``ZeroOptimizer``'s shards. ``sync()``
broadcasts rank 0's replicated state and leaves each rank's own where it
is (``broadcast_optimizer_state`` leaves ``"ef_state"`` out; a
``ZeroOptimizer``'s state is per rank throughout, so it is not
broadcast), so a restored rank keeps the residual it persisted.

``restore`` (after a failure) first makes a wrapped optimizer drop the
step in progress (``abort_step``: its issued buckets, counters, guard
round and overlap worker); ``on_reset`` (after an in-process reset)
rebinds it to the new world's axes: its old process groups were
destroyed.
"""

from __future__ import annotations

import copy

import torch

from .common.elastic import (  # noqa: F401
    HOSTS_UPDATED_EXIT_CODE, PEER_FAILURE_EXIT_CODE, ObjectState, State,
    install_preemption_handler, on_preemption, preemption_requested, run)
from .common.exceptions import HostsUpdatedInterrupt  # noqa: F401
from .common.faults import recovery_stats  # noqa: F401


def _clone_state_dict(sd):
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor)
                else copy.deepcopy(v)) for k, v in sd.items()}


class _ModelHandler:
    """Snapshot, restore and sync of an ``nn.Module``."""

    def __init__(self, model):
        self.value = model
        self._saved = _clone_state_dict(model.state_dict())

    def save(self):
        self._saved = _clone_state_dict(self.value.state_dict())

    def restore(self):
        # load_state_dict copies into the parameters: the snapshot stays.
        self.value.load_state_dict(self._saved)

    def load(self, sd):
        """A persisted snapshot (``checkpoint.restore_state``)."""
        self.value.load_state_dict(sd)
        self.save()

    def sync(self):
        from .optim import broadcast_parameters

        broadcast_parameters(self.value.state_dict(), root_rank=0)

    def on_reset(self):
        pass

    def set_value(self, model):
        self.value = model
        self.save()


def _is_sharded(optimizer) -> bool:
    from .zero import ZeroOptimizer

    return isinstance(optimizer, ZeroOptimizer)


class _OptimizerHandler:
    """Snapshot, restore and sync of an optimizer's state dict (this
    rank's own parts included, see the module docstring)."""

    def __init__(self, optimizer):
        self.value = optimizer
        self._saved = copy.deepcopy(optimizer.state_dict())

    def save(self):
        self._saved = copy.deepcopy(self.value.state_dict())

    def restore(self):
        # The failed step's buckets, counters and worker go first;
        # load_state_dict copies what it keeps.
        abort = getattr(self.value, "abort_step", None)
        if abort is not None:
            abort()
        self.value.load_state_dict(copy.deepcopy(self._saved))

    def load(self, sd):
        self.value.load_state_dict(sd)
        self.save()

    def sync(self):
        if _is_sharded(self.value):
            return      # each rank's state is its own
        from .optim import broadcast_optimizer_state

        broadcast_optimizer_state(self.value, root_rank=0)

    def on_reset(self):
        rebind = getattr(self.value, "rebind", None)
        if rebind is not None:
            rebind()

    def set_value(self, optimizer):
        self.value = optimizer
        self.save()


class ElasticSampler(torch.utils.data.Sampler):
    """A ``torch.utils.data.Sampler`` that repartitions the unprocessed
    indices after an elastic reset (Horovod's ``hvd.elastic.
    ElasticSampler``): a torch face over :class:`..data.ElasticSampler`
    (the same partition, padding and seeded per-epoch shuffle)."""

    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        from .data import ElasticSampler as _Impl

        self.dataset = dataset
        self._impl = _Impl(len(dataset), shuffle=shuffle, seed=seed)

    @property
    def epoch(self) -> int:
        return self._impl.epoch

    @property
    def processed_indices(self):
        return self._impl.processed_indices

    def set_epoch(self, epoch: int) -> None:
        self._impl.set_epoch(epoch)

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        self._impl.record_batch(batch_idx, batch_size)

    def record_indices(self, indices) -> None:
        self._impl.record_indices(indices)

    def get_indices(self, batch_idx: int, batch_size: int):
        return self._impl.get_indices(batch_idx, batch_size)

    def reset(self) -> None:
        # The dataset's length is read again at every reset.
        self._impl.dataset_size = len(self.dataset)
        self._impl.reset()

    def state_dict(self) -> dict:
        return {"epoch": self._impl.epoch,
                "processed_indices": set(self._impl.processed_indices)}

    def load_state_dict(self, state_dict: dict) -> None:
        self._impl.epoch = state_dict["epoch"]
        self._impl.processed_indices = set(
            state_dict["processed_indices"])
        self.reset()

    def __iter__(self):
        return iter(self._impl)

    def __len__(self) -> int:
        return len(self._impl)


class _SamplerHandler:
    """The processed set: snapshot, restore, and on sync the union of
    every rank's view, repartitioned for the new world."""

    def __init__(self, sampler):
        self.value = sampler
        self._saved = sampler.state_dict()

    def save(self):
        self._saved = self.value.state_dict()

    def restore(self):
        self.value.load_state_dict(self._saved)

    def load(self, sd):
        self.value.load_state_dict(sd)
        self.save()

    def sync(self):
        # Each rank recorded only its own batches since the last commit.
        from .functions import allgather_object

        states = allgather_object(self.value.state_dict(),
                                  name="elastic.sampler")
        merged: set = set()
        for s in states:
            merged |= set(s["processed_indices"])
        self.value.load_state_dict({
            "epoch": max(s["epoch"] for s in states),
            "processed_indices": merged})

    def on_reset(self):
        pass

    def set_value(self, sampler):
        self.value = sampler
        self.save()


def _make_handler(value):
    if isinstance(value, ElasticSampler):
        return _SamplerHandler(value)
    if isinstance(value, torch.nn.Module):
        return _ModelHandler(value)
    if isinstance(value, torch.optim.Optimizer) or (
            hasattr(value, "state_dict")
            and hasattr(value, "load_state_dict")
            and hasattr(value, "param_groups")):
        return _OptimizerHandler(value)
    return None


class TorchState(ObjectState):
    """Elastic state for torch training: models, optimizers and
    :class:`ElasticSampler` s get typed handlers (state-dict snapshots,
    collective sync); everything else rides ``ObjectState``'s deep copy
    and ``broadcast_object``."""

    def __init__(self, model=None, optimizer=None, **kwargs):
        if model is not None:
            kwargs.setdefault("model", model)
        if optimizer is not None:
            kwargs.setdefault("optimizer", optimizer)
        handlers = {}
        plain = {}
        for name, value in kwargs.items():
            h = _make_handler(value)
            if h is not None:
                handlers[name] = h
            else:
                plain[name] = value
        object.__setattr__(self, "_handlers", handlers)
        super().__init__(**plain)
        for name, h in handlers.items():
            object.__setattr__(self, name, h.value)

    def save(self):
        for h in self._handlers.values():
            h.save()
        super().save()

    def restore(self):
        for h in self._handlers.values():
            h.restore()
        super().restore()

    def sync(self):
        for h in self._handlers.values():
            h.sync()
        super().sync()      # ends with self.save(): one full snapshot

    def on_reset(self):
        for h in self._handlers.values():
            h.on_reset()
        super().on_reset()

    def committed_items(self):
        """The committed snapshot: each handler's saved state dict, then
        the plain attributes."""
        return [(k, h._saved) for k, h in self._handlers.items()] + \
            super().committed_items()

    def load_committed(self, name: str, value) -> None:
        """Put a persisted value back (``checkpoint.restore_state``): a
        handler's state dict into its object, a plain value as an
        attribute."""
        h = self._handlers.get(name)
        if h is not None:
            h.load(value)
        else:
            setattr(self, name, value)

    def __setattr__(self, name, value):
        if not name.startswith("_") and hasattr(self, "_handlers") \
                and name in self._handlers:
            self._handlers[name].set_value(value)
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)


def __getattr__(name):
    if name in ("save_state", "restore_state"):
        from . import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
