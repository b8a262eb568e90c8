"""`horovod.tensorflow.keras` namespace alias (the reference ships the
keras binding twice — standalone keras and tf.keras flavors,
horovod/tensorflow/keras/__init__.py; both surfaces are identical here
because Keras 3 is the only keras)."""

from horovod_tpu_torch.keras import *  # noqa: F401,F403
from horovod_tpu_torch.keras import __all__, callbacks, elastic  # noqa: F401
