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
    "HOSTNAME": "host label of this process (fault plans' host=)",
    # Rendezvous, elastic and launcher wiring (runner/, common/elastic.py).
    "ELASTIC": "elastic mode: poll the driver's KV at commit() and bound "
               "the process group's timeout (0/1)",
    "RENDEZVOUS": "the elastic driver's KV address host:port",
    "TOPOLOGY_VERSION": "the elastic driver's topology version when it "
                        "started this worker",
    "RENDEZVOUS_SECRET": "shared secret (HMAC) of the KV server",
    "RENDEZVOUS_RETRIES": "client retry budget for 5xx/connection errors",
    "RENDEZVOUS_WAIT_MAX_POLL_S": "wait() poll backoff cap",
    "ELASTIC_FORCE_LOCAL": "run an elastic job's named hosts on localhost",
    "ELASTIC_GRACE_SECS": "graceful-exit window before terminate",
    "ELASTIC_RESET_LIMIT": "max elastic resets before giving up",
    "DISCOVERY_DEBOUNCE": "identical scrapes before a host-set change",
    "BLACKLIST_TTL_S": "host blacklist TTL (strike-doubled)",
    # Fault injection (common/faults.py).
    "FAULT_PLAN": "seeded fault-injection plan (JSON)",
    "FAULT_LOG": "JSON-lines injection log path",
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
    # Training integrity, accumulation and the infeed (Config fields).
    "NONFINITE_POLICY": "non-finite gradient policy (off/warn/skip_step/"
                        "zero/scale_backoff/abort)",
    "DIVERGE_CHECK_STEPS": "divergence-detector cadence in steps (0 = off)",
    "DIVERGE_POLICY": "divergence policy (warn/abort/resync)",
    "CHECKPOINT_VERIFY": "verify checkpoints against their CRC sidecar "
                         "(0/1, default 1)",
    "ACCUM_STEPS": "default microbatch count of accumulate() (1 = off)",
    # Topology-aware routing (common/topology.py, ops/collectives.py).
    "ROUTE": "default route of the optimizer's reduction (flat/staged/"
             "staged_int8 or a spec like local:none,cross:int8)",
    "MESH_SHAPE": "routing mesh factorization, slow axis first (e.g. 2x2; "
                  "simulates a multi-host mesh on any world)",
    "HIERARCHICAL_ALLREDUCE": "eager allreduce over local then cross "
                              "(0/1)",
    "HIERARCHICAL_ALLGATHER": "eager allgather over local then cross "
                              "(0/1)",
    "REMAT_POLICY": "remat policy of the microbatch loss (none/full/dots/"
                    "dots_no_batch)",
    "PREFETCH": "default infeed mode (off/single/double)",
    # ZeRO (zero.py): the weight-update-sharding heuristic's threshold.
    "AUTO_SHARD_THRESHOLD": "replicated-parameter bytes from which ZeRO-1 "
                            "is the default candidate (256 MiB)",
    # Dynamic loss scaling of the scale_backoff policy (ScaleConfig).
    "SCALE_INIT": "initial loss scale (2**15)",
    "SCALE_BACKOFF_FACTOR": "loss-scale factor on a bad step (0.5)",
    "SCALE_GROWTH_FACTOR": "loss-scale factor after a good streak (2.0)",
    "SCALE_GROWTH_STEPS": "good steps before the scale grows (200)",
    "SCALE_MIN": "smallest loss scale (1.0)",
    "SCALE_MAX": "largest loss scale (2**24)",
    "RECOVERY_STATS_FILE": "at-exit recovery-counter dump path",
    # Eager collective engine.
    "CACHE_CAPACITY": "eager signature-cache capacity (1024)",
    "JOIN_MODE": "every eager collective runs a coordination round so "
                 "hvd.join() works (0/1)",
    "STALL_CHECK_TIME_SECONDS": "stall warning age and controller round "
                                "timeout in seconds (60)",
    "STALL_SHUTDOWN_TIME_SECONDS": "a collective in flight this long is "
                                   "fatal (0 = never)",
    "MAX_RETAINED_HANDLES": "eager-engine completed-handle cap",
    # Telemetry (common/metrics.py, stall.py, flightrec.py, podmon.py,
    # lockdep.py, affinity.py). Some are also Config fields: init()
    # resolves those once; the subsystems read the rest lazily.
    "METRICS": "registry enable (0 = shared NOOP singletons)",
    "METRICS_FILE": "per-rank JSON-lines metrics dump path (Config field)",
    "METRICS_INTERVAL_S": "metrics dump interval in seconds (Config field)",
    "METRICS_PORT": "/metrics endpoint port: -1 off, 0 ephemeral (Config "
                    "field)",
    "METRICS_TRACE": "metrics<->torch.profiler record_function bridge",
    "METRICS_DEBUG": "/debug/stacks + /debug/profile endpoints",
    "METRICS_ADVERTISE": "endpoint address advertised to the pod monitor",
    "POD_METRICS_ENDPOINTS": "static scrape endpoints for the pod monitor",
    "POD_METRICS_INTERVAL_S": "the pod monitor's scrape interval",
    "POD_REPLICA_SKEW_RATIO": "the replica-stall gauge's skew threshold "
                              "(1.5)",
    "STALL_CHECK_DISABLE": "stall inspector off (0/1; Config field)",
    "STALL_FATAL": "'raise': a fatal stall raises StallTimeoutError "
                   "(Config field)",
    "THREAD_AFFINITY": "one core id per local rank (Config field)",
    "FLIGHTREC": "flight-recorder enable",
    "FLIGHTREC_SIZE": "ring capacity (events)",
    "FLIGHTREC_DIR": "black-box dump directory",
    "FLIGHTREC_PUSH": "push black boxes to the rendezvous KV",
    "FLIGHTREC_SIGNAL_GRACE_S": "elastic driver's wait after its SIGUSR2 "
                                "fan-out",
    "LOCKDEP": "runtime lock-order watchdog (1 records, raise raises)",
    # Autoscale (common/autoscale.py): read by the elastic driver and
    # the workers' step publisher.
    "AUTOSCALE": "autoscale control loop enable",
    "AUTOSCALE_POLICY": "autoscale policy file or inline JSON",
    "AUTOSCALE_LOG": "autoscale decision log (JSON lines)",
    "PARALLEL": "hybrid dp/pp/tp/ep/sp spec, slow axis first "
                "(e.g. dp=2,tp=2; also a Config field)",
    # Autotune (common/autotune.py) and the launches beyond this machine
    # (runner/launch.py).
    "AUTOTUNE": "build the context's autotuner (0/1; Config field)",
    "AUTOTUNE_LOG": "the autotuner's CSV sample log (Config field)",
    "AUTOTUNE_WARMUP_SAMPLES": "samples discarded after each move (3)",
    "AUTOTUNE_STEPS_PER_SAMPLE": "steps scored a sample (10)",
    "NIC_DISCOVERY": "the ssh launch picks the coordinator's address by "
                     "routable-interface discovery (0/1)",
    # Native host runtime (native/) and the controller codec.
    "WIRE_FORMAT": "controller codec override (json = skip native)",
    "DISABLE_NATIVE": "skip the native acceleration library",
    # Sequence parallelism (parallel/ring_attention.py, ulysses.py).
    "SEQ_WIRE": "sequence K/V exchange wire (also a Config field)",
    # Pipeline and expert parallelism (parallel/pipeline.py, moe.py).
    "PP_WIRE": "pipeline stage-boundary wire (also a Config field)",
    "MOE_WIRE": "MoE dispatch/combine wire default (also a Config "
                "field)",
    "MOE_OVERLAP_CHUNKS": "MoE capacity-chunk depth default (also a "
                          "Config field)",
    "MOE_CAPACITY_FACTOR": "MoE expert capacity factor default (also a "
                           "Config field)",
    # Serve plane.
    "SERVE_LOG": "serve-controller decision log",
    "SERVE_PREFIX_CAP": "shared-prefix KV cache entry cap (0 disables)",
    "SERVE_SPEC_K": "speculative-decoding draft depth (0 disables)",
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

def _truthy(raw: str) -> bool:
    return raw.strip().lower() in ("1", "true", "yes", "on")


def env_int(name: str, default: int) -> int:
    """A registered knob as an int; unset or unparsable gives
    ``default`` (the JAX package's ``_env_int``)."""
    try:
        return int(runtime_env(name, str(default)))
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    """A registered knob as a float; unset or unparsable gives
    ``default`` (the JAX package's ``_env_float``)."""
    try:
        return float(runtime_env(name, str(default)))
    except ValueError:
        return default


@dataclasses.dataclass
class Config:
    """The ``init()``-resolved settings of the training plane: the
    environment's knobs, then the caller's overrides. The defaults are
    the JAX package's (``horovod_tpu/common/config.py``)."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD
    compression: Optional[str] = None
    quantize_min_bucket_bytes: int = DEFAULT_QUANTIZE_MIN_BYTES
    adasum_scalar_dtype: str = "float32"
    # Eager engine: the signature cache's capacity and join mode (every
    # collective a coordination round).
    cache_capacity: int = 1024
    join_mode: bool = False
    # Training integrity (common/integrity.py): the non-finite gradient
    # policy (None/"off" disables), the divergence detector's cadence (0 =
    # off) and policy, and checkpoint verification against the sidecar.
    nonfinite_policy: Optional[str] = None
    diverge_check_steps: int = 0
    diverge_policy: str = "warn"
    checkpoint_verify: bool = True
    # Accumulation (optim.accumulate_gradients, accum_steps=): the default
    # microbatch count (1 = off) and the remat policy of the microbatch
    # loss; the infeed mode of data.infeed_pipeline.
    accum_steps: int = 1
    remat_policy: Optional[str] = None
    prefetch: Optional[str] = None
    # Stall inspector (common/stall.py): a collective in flight longer
    # than the check time warns (the check time is also the
    # controller's round timeout); one in flight longer than the
    # shutdown time (0 = never) is fatal, a StallTimeoutError under
    # stall_fatal="raise". The inspector also watches a joined process's
    # wait for its peers, which is otherwise unbounded (the JAX
    # package's contract and defaults).
    stall_check_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 0.0
    stall_check_disable: bool = False
    stall_fatal: Optional[str] = None
    # Telemetry export surfaces wired at init() (the registry's enable is
    # HVD_TPU_METRICS, read at import): the JSON-lines dump path and
    # interval, the /metrics port (-1 off, 0 ephemeral) and the
    # record_function bridge.
    metrics_file: Optional[str] = None
    metrics_interval_s: float = 10.0
    metrics_port: int = -1
    metrics_trace_bridge: bool = False
    # Flight recorder (common/flightrec.py): the ring's enable, capacity
    # and the black-box directory (None: results/flightrec).
    flightrec: bool = True
    flightrec_size: int = 256
    flightrec_dir: Optional[str] = None
    # Host-core pinning: one core id per local rank, comma-separated.
    thread_affinity: Optional[str] = None
    # Autoscale (common/autoscale.py): arm the control loop, its policy
    # (a file path or inline JSON) and the decision log.
    autoscale: bool = False
    autoscale_policy: Optional[str] = None
    autoscale_log: Optional[str] = None
    # Routing (common/topology.py): the optimizer's default route (None =
    # the flat axis unless a call passes route=), the mesh factorization
    # (slow axis first, e.g. "2x2"; None = cross x local from the
    # launcher), and the eager engine's two-level allreduce/allgather
    # over the mesh's local and cross axes.
    route: Optional[str] = None
    mesh_shape: Optional[str] = None
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # Autotune (common/autotune.py): build the context's tuner, its CSV
    # log, the discarded samples after each move and the steps a sample.
    autotune: bool = False
    autotune_log: Optional[str] = None
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    # ZeRO (zero.py): the threshold of should_shard_update.
    auto_shard_threshold_bytes: int = 256 * 1024 * 1024
    # Hybrid parallelism (parallel/spec.py): the ParallelSpec form
    # ("dp=2,tp=2", slow axis first) init() resolves into
    # parallel_spec()/parallel_mesh(); the optimizer takes the spec
    # explicitly (parallel=). ``seq_wire``: the sequence-parallel K/V
    # exchange format ("none" | "bf16" | "int8").
    parallel: Optional[str] = None
    seq_wire: Optional[str] = None
    # The defaults a call takes when it passes None: the pipeline's
    # stage-boundary wire ("none" | "bf16" | "int8"; parallel/pipeline.py)
    # and the MoE dispatch's payload wire ("none" | "bf16" | "int8" |
    # "auto"), capacity-chunk depth and capacity factor (parallel/moe.py,
    # models/gpt.py MoeMlp).
    pp_wire: Optional[str] = None
    moe_wire: Optional[str] = None
    moe_overlap_chunks: int = 1
    moe_capacity_factor: float = 1.25
    # Elastic (common/elastic.py): poll the driver's topology version at
    # commit() and bound the process group's timeout by
    # stall_check_time_seconds, so a survivor of a dead peer raises.
    elastic: bool = False

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
        c.nonfinite_policy = runtime_env("NONFINITE_POLICY")
        c.diverge_check_steps = env_int("DIVERGE_CHECK_STEPS", 0)
        c.diverge_policy = runtime_env("DIVERGE_POLICY") or "warn"
        c.checkpoint_verify = _truthy(runtime_env("CHECKPOINT_VERIFY")
                                      or "1")
        c.accum_steps = env_int("ACCUM_STEPS", 1)
        c.remat_policy = runtime_env("REMAT_POLICY")
        c.prefetch = runtime_env("PREFETCH")
        c.route = runtime_env("ROUTE") or None
        c.mesh_shape = runtime_env("MESH_SHAPE") or None
        c.hierarchical_allreduce = _truthy(
            runtime_env("HIERARCHICAL_ALLREDUCE") or "0")
        c.hierarchical_allgather = _truthy(
            runtime_env("HIERARCHICAL_ALLGATHER") or "0")
        c.auto_shard_threshold_bytes = env_int(
            "AUTO_SHARD_THRESHOLD", c.auto_shard_threshold_bytes)
        c.elastic = _truthy(runtime_env("ELASTIC") or "0")
        c.parallel = runtime_env("PARALLEL") or None
        c.seq_wire = runtime_env("SEQ_WIRE") or None
        c.pp_wire = runtime_env("PP_WIRE") or None
        c.moe_wire = runtime_env("MOE_WIRE") or None
        c.moe_overlap_chunks = env_int("MOE_OVERLAP_CHUNKS",
                                       c.moe_overlap_chunks)
        c.moe_capacity_factor = env_float("MOE_CAPACITY_FACTOR",
                                          c.moe_capacity_factor)
        for name in ("stall_check_time_seconds",
                     "stall_shutdown_time_seconds"):
            raw = runtime_env(name.upper())
            if raw:
                setattr(c, name, float(raw))
        c.stall_check_disable = _truthy(runtime_env("STALL_CHECK_DISABLE")
                                        or "0")
        c.stall_fatal = runtime_env("STALL_FATAL") or None
        c.metrics_file = runtime_env("METRICS_FILE") or None
        c.metrics_interval_s = env_float("METRICS_INTERVAL_S",
                                         c.metrics_interval_s)
        c.metrics_port = env_int("METRICS_PORT", c.metrics_port)
        c.metrics_trace_bridge = _truthy(runtime_env("METRICS_TRACE")
                                         or "0")
        c.flightrec = _truthy(runtime_env("FLIGHTREC") or "1")
        c.flightrec_size = env_int("FLIGHTREC_SIZE", c.flightrec_size)
        c.flightrec_dir = runtime_env("FLIGHTREC_DIR") or None
        c.thread_affinity = runtime_env("THREAD_AFFINITY") or None
        c.autoscale = _truthy(runtime_env("AUTOSCALE") or "0")
        c.autoscale_policy = runtime_env("AUTOSCALE_POLICY") or None
        c.autoscale_log = runtime_env("AUTOSCALE_LOG") or None
        c.autotune = _truthy(runtime_env("AUTOTUNE") or "0")
        c.autotune_log = runtime_env("AUTOTUNE_LOG") or None
        c.autotune_warmup_samples = env_int("AUTOTUNE_WARMUP_SAMPLES",
                                            c.autotune_warmup_samples)
        c.autotune_steps_per_sample = env_int("AUTOTUNE_STEPS_PER_SAMPLE",
                                              c.autotune_steps_per_sample)
        fields = {f.name for f in dataclasses.fields(cls)}
        for key, value in overrides.items():
            if key not in fields:
                raise TypeError(f"init(): unknown setting {key!r}; "
                                f"known: {sorted(fields)}")
            setattr(c, key, value)
        for name in ("fusion_threshold_bytes", "quantize_min_bucket_bytes"):
            if getattr(c, name) < 0:
                raise ValueError(f"{name} must be >= 0, got "
                                 f"{getattr(c, name)}")
        return c
