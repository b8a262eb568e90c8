"""Elastic Keras surface (reference keras/elastic.py:22-86).

``KerasState`` is the TF-shim keras state (weights + optimizer slots to
host numpy, rank-0 sync on topology change); the three callbacks drive a
``State`` from inside ``model.fit`` with the reference's semantics
(_keras/elastic.py CommitStateCallbackImpl / UpdateBatchStateCallbackImpl
/ UpdateEpochStateCallbackImpl).
"""

from __future__ import annotations

from horovod_tpu_torch.common.elastic import run  # noqa: F401  (re-export)
from horovod_tpu_torch.tensorflow.elastic import TensorFlowKerasState


class KerasState(TensorFlowKerasState):
    """Reference keras/elastic.py:22-31. When no optimizer is given the
    compiled model's own optimizer is snapshotted too, so rollback
    rewinds momentum/variance slots alongside the weights."""

    def __init__(self, model, optimizer=None, **kwargs):
        if optimizer is None:
            optimizer = getattr(model, "optimizer", None)
        super().__init__(model, optimizer, **kwargs)


def _callback_base():
    import tensorflow as tf

    return tf.keras.callbacks.Callback


def CommitStateCallback(state, batches_per_commit: int = 1):
    """Commit ``state`` every ``batches_per_commit`` batches and at each
    epoch end (reference _keras/elastic.py CommitStateCallbackImpl —
    the counter resets at train begin so ranks stay consistent across
    sync events)."""
    Base = _callback_base()

    class _Cb(Base):
        def on_train_begin(self, logs=None):  # noqa: ARG002
            del logs
            self._remaining = batches_per_commit

        def on_batch_end(self, batch, logs=None):  # noqa: ARG002
            del logs
            self._remaining -= 1
            if self._remaining == 0:
                state.commit()
                self._remaining = batches_per_commit

        def on_epoch_end(self, epoch, logs=None):  # noqa: ARG002
            del logs
            state.commit()

    return _Cb()


def UpdateBatchStateCallback(state):
    """Track ``state.batch`` through fit (reference _keras/elastic.py
    UpdateBatchStateCallbackImpl tracking semantics).

    The reference additionally shortened the restart epoch by mutating
    ``callback.params['steps']`` — a Keras-2 trainer contract that Keras
    3 ignores (the epoch iterator is built from fit's own arguments;
    callback params are write-only metadata). To avoid replaying
    committed batches after an elastic restart, pass
    ``steps_per_epoch=<total> - state.batch`` to the resume ``fit``
    call; this callback keeps ``state.batch`` correct for exactly that.
    """
    Base = _callback_base()

    class _Cb(Base):
        def on_batch_end(self, batch, logs=None):  # noqa: ARG002
            del logs
            state.batch = batch

        def on_epoch_end(self, epoch, logs=None):  # noqa: ARG002
            del logs
            state.batch = 0

    return _Cb()


def UpdateEpochStateCallback(state):
    """Track the GLOBAL epoch count across resets: keras numbers epochs
    from 0 every fit, so the state's epoch at train begin becomes the
    offset (reference _keras/elastic.py UpdateEpochStateCallbackImpl)."""
    Base = _callback_base()

    class _Cb(Base):
        def on_train_begin(self, logs=None):  # noqa: ARG002
            del logs
            self._initial_epoch = state.epoch

        def on_epoch_end(self, epoch, logs=None):  # noqa: ARG002
            del logs
            state.epoch = self._initial_epoch + epoch + 1

    return _Cb()


__all__ = ["KerasState", "CommitStateCallback", "UpdateBatchStateCallback",
           "UpdateEpochStateCallback", "run"]
