"""Alias of horovod_tpu_torch.keras.elastic (reference
horovod/tensorflow/keras/elastic.py)."""

from horovod_tpu_torch.keras.elastic import *  # noqa: F401,F403
from horovod_tpu_torch.keras.elastic import __all__  # noqa: F401
