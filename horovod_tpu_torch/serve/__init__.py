"""``horovod_tpu_torch.serve`` — the port of ``horovod_tpu.serve``:
GPT decode over an explicit ring-buffer KV cache (``kvcache``), the
continuous batcher and request queue (``batcher``/``queue``), the
per-replica decode engine (``engine``), seeded open-loop traffic
(``traffic``), request tracing (``tracing``), overload control
(``overload``), and the SLO-driven replica controller with
prefill/decode disaggregation (``controller``).

Public names are imported lazily, as in the JAX package.
"""

from __future__ import annotations

_LAZY = {
    "Request": ("queue", "Request"),
    "RequestQueue": ("queue", "RequestQueue"),
    "TrafficTrace": ("traffic", "TrafficTrace"),
    "poisson_trace": ("traffic", "poisson_trace"),
    "DecodeEngine": ("engine", "DecodeEngine"),
    "make_engine_factory": ("engine", "make_engine_factory"),
    "ContinuousBatcher": ("batcher", "ContinuousBatcher"),
    "SLOPolicy": ("controller", "SLOPolicy"),
    "ServeController": ("controller", "ServeController"),
    "ServeCluster": ("controller", "ServeCluster"),
    "init_kv_cache": ("..models.gpt", "init_kv_cache"),
    "ServeTracer": ("tracing", "ServeTracer"),
    "tracer": ("tracing", "tracer"),
    "SLOClass": ("overload", "SLOClass"),
    "BrownoutLadder": ("overload", "BrownoutLadder"),
    "SLO_CLASSES": ("overload", "SLO_CLASSES"),
    "BROWNOUT_RUNGS": ("overload", "BROWNOUT_RUNGS"),
}

_LAZY_MODULES = ("kvcache", "queue", "batcher", "engine", "controller",
                 "traffic", "tracing", "overload")

__all__ = sorted(list(_LAZY) + list(_LAZY_MODULES))


def __getattr__(name):
    import importlib

    if name in _LAZY:
        mod_name, attr = _LAZY[name]
        mod = importlib.import_module(
            mod_name if mod_name.startswith("..") else "." + mod_name,
            __name__)
        val = getattr(mod, attr)
        globals()[name] = val
        return val
    if name in _LAZY_MODULES:
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'horovod_tpu_torch.serve' has no attribute {name!r}")
