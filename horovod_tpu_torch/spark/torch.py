"""The ``horovod.spark.torch`` import path: the Torch estimator family
of :mod:`horovod_tpu_torch.torch_estimator`."""

from horovod_tpu_torch.torch_estimator import (TorchEstimator,  # noqa: F401
                                               TrainedTorchModel)

# Horovod names the transformer TorchModel.
TorchModel = TrainedTorchModel
