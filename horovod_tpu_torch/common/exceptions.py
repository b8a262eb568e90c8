"""The port's framework exceptions — its own copy of
``horovod_tpu/common/exceptions.py``'s types that the ported modules
raise."""

from __future__ import annotations


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective failed (peer died, runtime wedged)."""


class HostsUpdatedInterrupt(HorovodTpuError):
    """The host set changed (hosts added or removed): the elastic loop
    re-initializes (``State.check_host_updates`` raises it at a
    ``commit()``)."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


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


class StallError(HorovodTpuError):
    """A collective stalled past the shutdown threshold
    (``stall_shutdown_time_seconds``; reference Horovod's
    ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``)."""


class StallTimeoutError(StallError, HorovodInternalError):
    """A collective stalled past the shutdown threshold with
    ``HVD_TPU_STALL_FATAL=raise``: typed, and — as a
    :class:`HorovodInternalError` too — classified as a comm failure by
    the elastic retry loop, so a hung collective aborts into an elastic
    reset instead of wedging the run."""


class AlltoallvLayoutError(HorovodTpuError, NotImplementedError):
    """The controller-negotiated ``alltoallv`` was called in a layout it
    does not support; the eager engine assumes one rank per process."""


class NonFiniteError(HorovodTpuError):
    """A non-finite (NaN/Inf) gradient step was observed under the
    ``abort`` non-finite policy (``HVD_TPU_NONFINITE_POLICY=abort``).
    Raised host-side by ``observe_guard``/``integrity.check_abort``; the
    optimizer skipped the step first, so its state is intact."""


class DivergenceError(HorovodTpuError):
    """Replica parameters diverged across ranks under the ``abort``
    divergence policy (``HVD_TPU_DIVERGE_POLICY=abort``). ``ranks`` names
    the diverged ranks when the detector identified them."""

    def __init__(self, message: str, ranks=()):
        super().__init__(message)
        self.ranks = tuple(ranks)


class CheckpointCorruptError(HorovodTpuError):
    """Checkpoint verification failed (CRC/size mismatch against the
    sidecar manifest) and no earlier verified step is left to fall back
    to (``checkpoint.py``)."""
