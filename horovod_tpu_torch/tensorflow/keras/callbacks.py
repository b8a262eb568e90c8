"""Alias of horovod_tpu_torch.keras.callbacks (reference
horovod/tensorflow/keras/callbacks.py)."""

from horovod_tpu_torch.keras.callbacks import *  # noqa: F401,F403
from horovod_tpu_torch.keras.callbacks import __all__  # noqa: F401
