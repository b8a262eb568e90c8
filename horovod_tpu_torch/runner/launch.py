"""``hvdtpurun-torch``, the port's launcher — its copy of the local and
elastic paths of ``horovod_tpu/runner/launch.py``::

    hvdtpurun-torch -np 2 python train.py
    hvdtpurun-torch -np 2 --elastic --min-np 2 --max-np 2 \\
        -H hostA:1,hostB:1 python train.py

Each worker is a fresh process (``safe_shell_exec.spawn``) with
``HVD_TPU_COORDINATOR`` (``127.0.0.1:<a free port>``), ``HVD_TPU_NUM_PROC``,
``HVD_TPU_PROC_ID`` and ``HVD_TPU_LOCAL_RANK``/``LOCAL_SIZE``, which
``hvd.init()`` reads; the first worker to exit non-zero ends the job
(the rest are terminated). The knob flags export the same
``HVD_TPU_*`` variables as the JAX launcher's. ``--elastic`` hands the
job to ``elastic_driver.run_elastic``.

Telemetry and control: ``--metrics-port N`` gives every worker a
``/metrics`` endpoint (0: an ephemeral port each, advertised over the
rendezvous KV); ``--pod-metrics-port N`` serves the merged
``/pod/metrics`` of all workers from this process (the elastic driver's,
or a pod monitor of its own for a static launch); ``--autoscale-policy
JSON|@file|file`` (validated here: a bad field exits naming it; implies
``--elastic``) arms the elastic driver's autoscale engine, whose
decisions ``--autoscale-log`` appends as JSON lines; ``--check-build``
prints what this installation of the port can do.

Not ported yet (each raises ``NotImplementedError`` naming its slice):
hosts other than this machine (the ssh fan-out, LSF and NIC discovery)
and ``--autotune``. The JAX launcher's TPU-pod discovery has no
counterpart.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import threading
import time
from typing import Dict, List, Optional

from . import hosts as hosts_lib

_SSH_SLICE = "the ssh/LSF launch slice"
_AUTOTUNE_SLICE = "the autotune slice"
_LOCAL_NAMES = ("localhost", "127.0.0.1")


def build_env_for_slot(base_env: Dict[str, str], coordinator: str,
                       num_proc: int, proc_id: int,
                       extra: Optional[Dict[str, str]] = None
                       ) -> Dict[str, str]:
    """One worker's environment: ``base_env`` with the world's
    coordinator, size and this worker's id (what ``basics._world()``
    reads), a per-rank metrics dump file, and ``extra`` on top."""
    env = dict(base_env)
    env["HVD_TPU_COORDINATOR"] = coordinator
    env["HVD_TPU_NUM_PROC"] = str(num_proc)
    env["HVD_TPU_PROC_ID"] = str(proc_id)
    if num_proc > 1 and env.get("HVD_TPU_METRICS_FILE"):
        env["HVD_TPU_METRICS_FILE"] = \
            f"{env['HVD_TPU_METRICS_FILE']}.rank{proc_id}"
    if extra:
        env.update(extra)
    return env


def _slot_local_env(local_rank: int, local_size: int) -> Dict[str, str]:
    return {"HVD_TPU_LOCAL_RANK": str(local_rank),
            "HVD_TPU_LOCAL_SIZE": str(local_size)}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_fail_fast(procs, threads: List[threading.Thread],
                    poll_interval: float = 0.1) -> int:
    """Wait for every worker; on the FIRST non-zero exit terminate the
    rest, and return that exit code."""
    rc = 0
    try:
        while True:
            running = False
            for p in procs:
                code = p.poll()
                if code is None:
                    running = True
                elif code != 0 and rc == 0:
                    rc = code
                    for q in procs:
                        if q.poll() is None:
                            q.terminate()
            if not running:
                break
            time.sleep(poll_interval)
        for t in threads:
            t.join(timeout=2)
        return rc
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        for p in procs:
            p.wait()
        return 1


def run_local(np: int, command: List[str], env_extra: Dict[str, str],
              verbose: bool = False) -> int:
    """Spawn ``np`` workers on this machine (one a slot, local ranks
    0..np-1) and wait for them, failing fast."""
    from . import safe_shell_exec as sse

    coordinator = f"127.0.0.1:{_free_port()}"
    handles: List[sse.SpawnedProcess] = []
    for i in range(np):
        env = build_env_for_slot(dict(os.environ), coordinator, np, i,
                                 {**env_extra, **_slot_local_env(i, np)})
        handles.append(sse.spawn(command, env=env, prefix=str(i)))
    return _wait_fail_fast(handles, [h.thread for h in handles])


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return _build_parser().parse_args(argv)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdtpurun-torch",
        description="Launch a horovod_tpu_torch training job "
                    "(horovodrun's counterpart for the PyTorch port).")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="number of worker processes (default 1)")
    p.add_argument("-H", "--hosts", default=None,
                   help="host list, e.g. host1:4,host2:4")
    p.add_argument("--hostfile", default=None,
                   help="hostfile with 'hostname slots=N' lines")
    p.add_argument("--config-file", default=None,
                   help="YAML config supplying any of these flags "
                        "(explicit CLI flags win)")
    p.add_argument("--ssh-port", type=int, default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--version", action="store_true")
    p.add_argument("-cb", "--check-build", action="store_true")
    p.add_argument("--fusion-threshold-mb", type=float, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--hierarchical-allreduce", action="store_true")
    p.add_argument("--timeline-filename", default=None)
    p.add_argument("--timeline-mark-cycles", action="store_true")
    p.add_argument("--stall-check-time-seconds", type=float, default=None)
    p.add_argument("--stall-shutdown-time-seconds", type=float,
                   default=None)
    p.add_argument("--no-stall-check", action="store_true")
    p.add_argument("--compression", default=None,
                   choices=["none", "fp16", "bf16"])
    p.add_argument("--autotune", action="store_true")
    p.add_argument("--autotune-log-file", default=None)
    p.add_argument("--metrics-port", type=int, default=None)
    p.add_argument("--metrics-file", default=None,
                   help="per-worker metrics JSON-lines dump path "
                        "(.rank<k> is appended in multi-process runs; "
                        "HVD_TPU_METRICS_FILE)")
    p.add_argument("--pod-metrics-port", type=int, default=None)
    p.add_argument("--log-level", default=None)
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--host-discovery-script", default=None)
    p.add_argument("--fault-plan", default=None,
                   help="chaos: JSON fault plan (or @/path/to/plan.json) "
                        "exported to workers as HVD_TPU_FAULT_PLAN (see "
                        "horovod_tpu_torch/common/faults.py)")
    p.add_argument("--autoscale-policy", default=None)
    p.add_argument("--autoscale-log", default=None)
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command")
    return p


def _coerce_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def apply_config_file(args: argparse.Namespace,
                      argv: Optional[List[str]] = None
                      ) -> argparse.Namespace:
    """Fill unset flags from a YAML config (flat, or nested under
    sections; dashes and underscores alike). A flag given on the command
    line wins, even one whose value is falsy; config values go through
    the flag's own type and choices."""
    if not getattr(args, "config_file", None):
        return args
    import yaml

    probe = _build_parser()
    actions = {}
    for a in probe._actions:
        actions[a.dest] = a
        a.default = argparse.SUPPRESS
    explicit = set(vars(probe.parse_args(argv if argv is not None
                                         else sys.argv[1:])))
    with open(args.config_file) as f:
        cfg = yaml.safe_load(f) or {}
    flat: Dict[str, object] = {}

    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            else:
                flat[str(k).replace("-", "_")] = v

    walk(cfg)
    for k, v in flat.items():
        if k in explicit or not hasattr(args, k) or k == "config_file":
            continue
        action = actions.get(k)
        if action is not None:
            if isinstance(action, argparse._StoreTrueAction):
                v = _coerce_bool(v)
            elif action.type is not None and v is not None:
                v = action.type(v)
            if action.choices is not None and v not in action.choices:
                raise ValueError(
                    f"config file: {k}={v!r} not in {action.choices}")
        setattr(args, k, v)
    return args


def check_build() -> str:
    """The port's capability matrix (``hvdtpurun-torch --check-build``,
    the counterpart of the JAX launcher's ``check_build``): what
    torch.distributed offers here and whether each CUDA kernel library
    is built for the current sources."""
    from .. import __version__
    from ..common import basics
    from ..ops import kernels

    def mark(v):
        return "X" if v else " "

    lines = [f"horovod_tpu_torch v{__version__}:", "",
             "Available Frameworks:",
             "    [X] PyTorch (native)", "",
             "Available Controllers:",
             "    [X] torch.distributed + rendezvous KV (multi-process)",
             f"    [{mark(basics.mpi_built())}] MPI",
             f"    [{mark(basics.gloo_built())}] Gloo", "",
             "Available Tensor Operations:",
             f"    [{mark(basics.nccl_built())}] NCCL (torch.distributed)",
             f"    [{mark(basics.gloo_built())}] Gloo (torch.distributed)",
             f"    [{mark(basics.mpi_built())}] MPI",
             f"    [{mark(basics.cuda_built())}] CUDA", "",
             "CUDA kernels (sm_90a, built from csrc/ at first use):"]
    for source in kernels.SOURCES:
        lines.append(f"    [{mark(kernels.library_path(source).is_file())}]"
                     f" {source}")
    return "\n".join(lines)


def _refuse_later_flags(args: argparse.Namespace) -> None:
    """The flags of later slices of the port raise, naming the slice."""
    later = (("autotune", "--autotune", _AUTOTUNE_SLICE),
             ("autotune_log_file", "--autotune-log-file", _AUTOTUNE_SLICE))
    for dest, flag, where in later:
        value = getattr(args, dest, None)
        if value is not None and value is not False:
            raise NotImplementedError(
                f"hvdtpurun-torch {flag} is not ported yet; it comes with "
                f"{where} of the port")


def knob_env(args: argparse.Namespace) -> Dict[str, str]:
    """The ``HVD_TPU_*`` environment the knob flags stand for (the JAX
    launcher's ``knob_env``; a malformed fault plan fails here)."""
    env = {}
    if args.fusion_threshold_mb is not None:
        env["HVD_TPU_FUSION_THRESHOLD"] = str(
            int(args.fusion_threshold_mb * 1024 * 1024))
    if args.cache_capacity is not None:
        env["HVD_TPU_CACHE_CAPACITY"] = str(args.cache_capacity)
    if args.hierarchical_allreduce:
        env["HVD_TPU_HIERARCHICAL_ALLREDUCE"] = "1"
    if args.timeline_filename:
        env["HVD_TPU_TIMELINE"] = args.timeline_filename
    if args.timeline_mark_cycles:
        env["HVD_TPU_TIMELINE_MARK_CYCLES"] = "1"
    if args.stall_check_time_seconds is not None:
        env["HVD_TPU_STALL_CHECK_TIME_SECONDS"] = str(
            args.stall_check_time_seconds)
    if args.stall_shutdown_time_seconds is not None:
        env["HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS"] = str(
            args.stall_shutdown_time_seconds)
    if args.no_stall_check:
        env["HVD_TPU_STALL_CHECK_DISABLE"] = "1"
    if args.compression:
        env["HVD_TPU_COMPRESSION_DTYPE"] = args.compression
    if args.autotune:
        env["HVD_TPU_AUTOTUNE"] = "1"
    if args.autotune_log_file:
        env["HVD_TPU_AUTOTUNE_LOG"] = args.autotune_log_file
    if args.metrics_port is not None:
        env["HVD_TPU_METRICS_PORT"] = str(args.metrics_port)
    if args.metrics_file:
        env["HVD_TPU_METRICS_FILE"] = args.metrics_file
    if getattr(args, "pod_metrics_port", None) is not None:
        env["HVD_TPU_POD_METRICS_PORT"] = str(args.pod_metrics_port)
        env.setdefault("HVD_TPU_METRICS_PORT",
                       str(args.metrics_port
                           if args.metrics_port is not None else 0))
    if args.log_level:
        env["HVD_TPU_LOG_LEVEL"] = args.log_level
    if args.elastic:
        env["HVD_TPU_ELASTIC"] = "1"
    if args.fault_plan:
        plan = args.fault_plan
        if plan.startswith("@"):
            with open(plan[1:]) as f:
                plan = f.read()
        from ..common.faults import FaultPlan

        FaultPlan.from_json(plan)
        env["HVD_TPU_FAULT_PLAN"] = plan
    if getattr(args, "autoscale_policy", None):
        # Parsed here: a typo'd threshold fails THIS launch naming the
        # field. The validated JSON is what the workers get.
        from ..common.autoscale import AutoscalePolicy

        policy = AutoscalePolicy.load(args.autoscale_policy)
        env["HVD_TPU_AUTOSCALE"] = "1"
        env["HVD_TPU_AUTOSCALE_POLICY"] = policy.to_json()
    if getattr(args, "autoscale_log", None):
        env["HVD_TPU_AUTOSCALE_LOG"] = args.autoscale_log
    return env


def _start_pod_monitor(env_extra: Dict[str, str]):
    """The pod monitor of a static launch, when
    ``HVD_TPU_POD_METRICS_PORT`` asks for one: without a rendezvous KV
    in play, one is started here for the workers' endpoint
    advertisement alone. Returns ``(monitor, owned_rdv)``; the caller
    stops both."""
    from ..common import podmon as podmon_lib

    merged_env = {**os.environ, **env_extra}
    port = podmon_lib.monitor_port_from_env(merged_env)
    if port is None:
        return None, None
    from .rendezvous import RendezvousServer

    owned_rdv = None
    sources = [podmon_lib.static_endpoints(
        merged_env.get(podmon_lib.ENV_ENDPOINTS))]
    if "HVD_TPU_RENDEZVOUS" not in merged_env:
        owned_rdv = RendezvousServer("127.0.0.1")
        kv_port = owned_rdv.start()
        env_extra["HVD_TPU_RENDEZVOUS"] = f"127.0.0.1:{kv_port}"
        sources.append(podmon_lib.kv_endpoints(owned_rdv))
    monitor = podmon_lib.PodMonitor(
        podmon_lib.combined_endpoints(*sources))
    print(f"hvdtpurun-torch: /pod/metrics on port {monitor.start(port)}",
          flush=True)
    return monitor, owned_rdv


def _is_local(host_infos) -> bool:
    return host_infos is None or all(
        h.hostname in _LOCAL_NAMES or h.hostname == socket.gethostname()
        for h in host_infos)


def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.version:
        from .. import __version__

        print(__version__)
        return 0
    args = apply_config_file(args, argv)
    _refuse_later_flags(args)
    if args.check_build:
        print(check_build())
        return 0
    if args.num_proc is None:
        args.num_proc = 1
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("hvdtpurun-torch: no command given", file=sys.stderr)
        return 2
    try:
        env_extra = knob_env(args)
    except ValueError as e:
        print(f"hvdtpurun-torch: {e}", file=sys.stderr)
        return 2
    if args.autoscale_policy:
        # Autoscaling is the elastic driver's: the flag implies the mode.
        args.elastic = True
    if args.elastic:
        from .elastic_driver import run_elastic

        return run_elastic(args, command, env_extra)
    if args.hostfile:
        host_infos = hosts_lib.parse_host_files(args.hostfile)
    elif args.hosts:
        host_infos = hosts_lib.parse_hosts(args.hosts)
    else:
        host_infos = None
    if host_infos is not None:
        # -np beyond the hosts' slots raises rather than oversubscribes.
        hosts_lib.get_host_assignments(host_infos, args.num_proc)
    if not _is_local(host_infos):
        raise NotImplementedError(
            "hvdtpurun-torch on hosts other than this machine (the ssh "
            f"fan-out) is not ported yet; it comes with {_SSH_SLICE} of "
            "the port")
    monitor, owned_rdv = _start_pod_monitor(env_extra)
    try:
        return run_local(args.num_proc, command, env_extra, args.verbose)
    finally:
        if monitor is not None:
            monitor.stop()
        if owned_rdv is not None:
            owned_rdv.stop()


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
