"""TensorFlowKerasState — elastic state for the TF/keras shim (the
port's copy of ``horovod_tpu/tensorflow/elastic.py``).

Reference: horovod/tensorflow/elastic.py:91-155 (TensorFlowKerasState:
snapshot model weights + optimizer variables to host, restore on
rollback, broadcast on sync) and :156-196 (TensorFlowState over plain
variable lists).
"""

from __future__ import annotations

from ..common.elastic import ObjectState


def _optimizer_weights(optimizer):
    """Keras-3 and tf.keras-2 compatible optimizer variable access."""
    if hasattr(optimizer, "variables"):
        vs = optimizer.variables
        return list(vs() if callable(vs) else vs)
    return []


class TensorFlowKerasState(ObjectState):
    """Elastic state for a keras model (+ optionally its optimizer):
    ``save()`` snapshots weights to host numpy, ``restore()`` rolls them
    back after a collective failure, ``sync()`` broadcasts rank 0's
    weights after a topology change (reference tensorflow/elastic.py
    TensorFlowKerasState semantics)."""

    def __init__(self, model, optimizer=None, **kwargs):
        object.__setattr__(self, "model", model)
        object.__setattr__(self, "optimizer", optimizer)
        object.__setattr__(self, "_saved_model", None)
        object.__setattr__(self, "_saved_opt", None)
        super().__init__(**kwargs)
        self.save()

    def _snapshot(self):
        model_w = [w.copy() for w in self.model.get_weights()]
        opt_w = None
        if self.optimizer is not None:
            import numpy as np

            opt_w = [np.array(v) for v in
                     _optimizer_weights(self.optimizer)]
        return model_w, opt_w

    def save(self):
        model_w, opt_w = self._snapshot()
        object.__setattr__(self, "_saved_model", model_w)
        object.__setattr__(self, "_saved_opt", opt_w)
        super().save()

    def restore(self):
        if self._saved_model is not None:
            self.model.set_weights([w.copy()
                                    for w in self._saved_model])
        if self._saved_opt is not None and self.optimizer is not None:
            current = _optimizer_weights(self.optimizer)
            for var, val in zip(current, self._saved_opt):
                var.assign(val)
            # Slot variables created AFTER the snapshot (lazy keras
            # build) did not exist at the committed point — their
            # committed value is zero, not whatever the failed steps
            # left behind.
            for var in current[len(self._saved_opt):]:
                var.assign(var * 0)
        super().restore()

    def sync(self):
        from . import broadcast_variables

        broadcast_variables(self.model.variables, root_rank=0)
        if self.optimizer is not None:
            opt_vars = _optimizer_weights(self.optimizer)
            if opt_vars:
                broadcast_variables(opt_vars, root_rank=0)
        super().sync()  # ends with self.save() → one full snapshot


class TensorFlowState(ObjectState):
    """Elastic state over a plain list of tf.Variables (reference
    tensorflow/elastic.py:156-196)."""

    def __init__(self, variables, **kwargs):
        object.__setattr__(self, "variables", list(variables))
        object.__setattr__(self, "_saved_vars", None)
        super().__init__(**kwargs)
        self.save()

    def save(self):
        import numpy as np

        object.__setattr__(self, "_saved_vars",
                           [np.array(v) for v in self.variables])
        super().save()

    def restore(self):
        if self._saved_vars is not None:
            for var, val in zip(self.variables, self._saved_vars):
                var.assign(val)
        super().restore()

    def sync(self):
        from . import broadcast_variables

        broadcast_variables(self.variables, root_rank=0)
        super().sync()  # ends with self.save()
