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


class MismatchError(TensorShapeMismatchError):
    """Ranks submitted different collective signatures (shape, dtype, op,
    wire) for the same tensor name; ``ranks`` names the offending global
    ranks. A :class:`TensorShapeMismatchError`, so its handlers keep
    working."""

    def __init__(self, message: str, ranks=()):
        super().__init__(message)
        self.ranks = tuple(ranks)


class DuplicateTensorNameError(HorovodTpuError):
    """A tensor name was submitted again while its previous submission
    never completed."""


class AlltoallvLayoutError(HorovodTpuError, NotImplementedError):
    """The controller-negotiated ``alltoallv`` was called in a layout it
    does not support; the eager engine assumes one rank per process."""
