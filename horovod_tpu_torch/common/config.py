"""Call-time runtime knobs of the port.

The port's own copy of the knob registry of
``horovod_tpu/common/config.py``: the same ``HVD_TPU_*`` names, so one
environment drives both packages in a parity test. Only the knobs the
ported modules read are declared; every ``runtime_env`` read must name a
declared knob.
"""

from __future__ import annotations

import os
from typing import Optional

RUNTIME_KNOBS = {
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
