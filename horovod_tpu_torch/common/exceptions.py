"""The port's framework exceptions — its own copy of
``horovod_tpu/common/exceptions.py``'s types that the ported modules
raise."""

from __future__ import annotations


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective failed (peer died, runtime wedged)."""


class NotInitializedError(HorovodTpuError):
    """API called before ``init()``."""

    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            "horovod_tpu_torch.init() first.")


class TensorShapeMismatchError(HorovodTpuError):
    """Cross-rank shape/dtype validation failed."""
