"""The ``horovod.spark.keras`` import path: the Keras estimator family
of :mod:`horovod_tpu_torch.keras_estimator` (the Store and the executor
pool in place of Spark's substrate, the parquet shards of
:mod:`horovod_tpu_torch.parquet` in place of Petastorm)."""

from horovod_tpu_torch.keras_estimator import (  # noqa: F401
    KerasEstimator, TrainedKerasModel)

# Reference exposes the transformer as KerasModel.
KerasModel = TrainedKerasModel
