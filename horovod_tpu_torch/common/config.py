"""Call-time runtime knobs of the port.

The port's own copy of the knob registry of
``horovod_tpu/common/config.py``: the same ``HVD_TPU_*`` names, so one
environment drives both packages in a parity test. Only the knobs the
ported modules read are declared; every ``runtime_env`` read must name a
declared knob. :class:`Config` is what ``init()`` resolves from those
knobs and the caller's overrides.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

RUNTIME_KNOBS = {
    # Process identity, exported per process by a launcher (read by
    # common/basics.py init()).
    "COORDINATOR": "rendezvous address host:port of rank 0",
    "NUM_PROC": "world size as launched",
    "PROC_ID": "this process's rank",
    "LOCAL_RANK": "rank within the host (default: the rank)",
    "LOCAL_SIZE": "processes on this host (default: the world size)",
    # Training plane.
    "FUSION_THRESHOLD": "gradient fusion bucket size in bytes (64 MiB)",
    "COMPRESSION": "default gradient wire compression "
                   "(none/fp16/bf16/int8_ef)",
    "QUANTIZE_MIN_BYTES": "smallest fused bucket the int8_ef wire "
                          "quantizes (64 KiB; smaller float buckets ride "
                          "bf16)",
    "ADASUM_SCALAR_DTYPE": "dtype of Adasum's dot/norm scalars (float32 "
                           "runs kernel K8; others plain torch)",
    "FLASH_ATTENTION": "flash-attention kernel enable (0 = reference)",
    # Eager collective engine.
    "CACHE_CAPACITY": "eager signature-cache capacity (1024)",
    "JOIN_MODE": "every eager collective runs a coordination round so "
                 "hvd.join() works (0/1)",
    "STALL_CHECK_TIME_SECONDS": "controller round timeout in seconds (60)",
    "STALL_SHUTDOWN_TIME_SECONDS": "how long a joined process waits for "
                                   "its peers before it raises (600; 0 = "
                                   "forever)",
    "MAX_RETAINED_HANDLES": "eager-engine completed-handle cap",
    # Telemetry switches read lazily by their subsystems.
    "METRICS": "registry enable (0 = shared NOOP singletons)",
    "FLIGHTREC": "flight-recorder enable",
    "FLIGHTREC_SIZE": "ring capacity (events)",
    # Serve plane.
    "SERVE_LOG": "serve-controller decision log",
    "SERVE_TRACE": "request-span tracer enable (0 = shared no-op)",
    "SERVE_TRACE_DIR": "trace JSONL dump directory (unset = no dump)",
    "SERVE_TRACE_SIZE": "retained completed request-trace cap",
    "SERVE_BROWNOUT": "pin the brownout ladder level (operator lever)",
}


def runtime_env(name: str, default: Optional[str] = None, *,
                required: bool = False) -> Optional[str]:
    """Read a registered call-time knob ``HVD_TPU_<name>`` as a raw
    string (call sites parse it). ``required=True`` raises KeyError
    when unset. Unregistered names raise."""
    if name not in RUNTIME_KNOBS:
        raise KeyError(
            f"unregistered runtime knob {name!r}; declare it in "
            "config.RUNTIME_KNOBS")
    key = "HVD_TPU_" + name
    if required:
        return os.environ[key]
    return os.environ.get(key, default)


DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
DEFAULT_QUANTIZE_MIN_BYTES = 64 * 1024

# Settings of the JAX package's Config that later slices of the port
# bring: passing one to init() raises, naming the slice.
_LATER_SETTINGS = {
    "hierarchical_allreduce": "slice 3b (mesh routing)",
    "hierarchical_allgather": "slice 3b (mesh routing)",
    "autotune": "the autotune slice",
}


def _truthy(raw: str) -> bool:
    return raw.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Config:
    """The ``init()``-resolved settings of the training plane: the
    environment's knobs, then the caller's overrides. The defaults are
    the JAX package's (``horovod_tpu/common/config.py``)."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD
    compression: Optional[str] = None
    quantize_min_bucket_bytes: int = DEFAULT_QUANTIZE_MIN_BYTES
    adasum_scalar_dtype: str = "float32"
    # Eager engine: the signature cache's capacity, join mode (every
    # collective a coordination round), the controller's round timeout
    # (the JAX package's stall-check time) and how long a joined process
    # waits for its peers. The JAX package's default for the last is 0,
    # a wait its stall inspector watches; the port has no stall
    # inspector, so a joined wait is bounded instead.
    cache_capacity: int = 1024
    join_mode: bool = False
    stall_check_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 600.0

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        c = cls()
        raw = runtime_env("FUSION_THRESHOLD")
        if raw:
            c.fusion_threshold_bytes = int(raw)
        c.compression = runtime_env("COMPRESSION") or None
        raw = runtime_env("QUANTIZE_MIN_BYTES")
        if raw:
            c.quantize_min_bucket_bytes = int(raw)
        c.adasum_scalar_dtype = (runtime_env("ADASUM_SCALAR_DTYPE")
                                 or c.adasum_scalar_dtype)
        raw = runtime_env("CACHE_CAPACITY")
        if raw:
            c.cache_capacity = int(raw)
        c.join_mode = _truthy(runtime_env("JOIN_MODE") or "0")
        for name in ("stall_check_time_seconds",
                     "stall_shutdown_time_seconds"):
            raw = runtime_env(name.upper())
            if raw:
                setattr(c, name, float(raw))
        fields = {f.name for f in dataclasses.fields(cls)}
        for key, value in overrides.items():
            if key in _LATER_SETTINGS:
                raise NotImplementedError(
                    f"init({key}=...) is not ported yet; it comes with "
                    f"{_LATER_SETTINGS[key]} of the port")
            if key not in fields:
                raise TypeError(f"init(): unknown setting {key!r}; "
                                f"known: {sorted(fields)}")
            setattr(c, key, value)
        for name in ("fusion_threshold_bytes", "quantize_min_bucket_bytes"):
            if getattr(c, name) < 0:
                raise ValueError(f"{name} must be >= 0, got "
                                 f"{getattr(c, name)}")
        return c
