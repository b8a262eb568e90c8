"""Keras callbacks namespace (reference keras/callbacks.py:22-207).

The factories live on the TensorFlow shim (they build
``tf.keras.callbacks.Callback`` subclasses at call time so importing this
module never imports TF); this module gives them the reference's import
path: ``hvd.callbacks.MetricAverageCallback()``.
"""

from horovod_tpu_torch.tensorflow import (  # noqa: F401
    BestModelCheckpoint,
    BroadcastGlobalVariablesCallback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
)

__all__ = [
    "BroadcastGlobalVariablesCallback", "MetricAverageCallback",
    "LearningRateScheduleCallback", "LearningRateWarmupCallback",
    "BestModelCheckpoint",
]
