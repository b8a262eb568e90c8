"""``hvdtpurun-torch``, the port's launcher — its copy of
``horovod_tpu/runner/launch.py``::

    hvdtpurun-torch -np 2 python train.py
    hvdtpurun-torch -np 4 -H host1:2,host2:2 python train.py
    hvdtpurun-torch -np 2 --elastic --min-np 2 --max-np 2 \\
        -H hostA:1,hostB:1 python train.py

Each worker is a fresh process with ``HVD_TPU_COORDINATOR``,
``HVD_TPU_NUM_PROC``, ``HVD_TPU_PROC_ID``, ``HVD_TPU_LOCAL_RANK``/
``LOCAL_SIZE`` and ``HVD_TPU_HOSTNAME``, which ``hvd.init()`` reads; the
first worker to exit non-zero ends the job (the rest are terminated).
The knob flags export the same ``HVD_TPU_*`` variables as the JAX
launcher's (``--autotune`` -> ``HVD_TPU_AUTOTUNE=1``,
``--autotune-log-file`` -> ``HVD_TPU_AUTOTUNE_LOG``). ``--elastic``
hands the job to ``elastic_driver.run_elastic``.

Where the workers run:

* hosts that are this machine (or none given): local processes on a
  coordinator at ``127.0.0.1``. With ``-np`` unset and no hosts, one
  worker per GPU of this machine (``gpu_hosts.local_gpu_count``:
  ``CUDA_VISIBLE_DEVICES``, else ``nvidia-smi -L``; CUDA is never
  initialized here), the counterpart of the JAX launcher's TPU-pod
  sizing; no GPU found leaves ``-np 1``.
* other hosts (``-H``, ``--hostfile``, or inside an LSF allocation the
  scheduler's hosts, ``lsf.py``): the ssh fan-out, ``run_ssh``. **One
  process per slot**, the torch convention of one process per GPU —
  the JAX launcher starts one process per host, which drives all of
  that host's chips. Ranks go in host order; the coordinator is the
  first host's, or with ``HVD_TPU_NIC_DISCOVERY=1`` the address that
  routable-interface discovery picked (``driver_service.py``; nothing
  found keeps the first host's name). ``*_SECRET`` variables travel
  over ssh's stdin, never in the remote argv; the launcher's own
  ``HVD_TPU_*`` environment is forwarded. Ending the ssh client does not
  signal the remote process (the JAX launcher's limitation too): a
  remote worker whose peer failed exits through its own collective's
  failure.

Telemetry and control: ``--metrics-port N`` gives every worker a
``/metrics`` endpoint (0: an ephemeral port each, advertised over the
rendezvous KV); ``--pod-metrics-port N`` serves the merged
``/pod/metrics`` of all workers from this process (the elastic driver's,
or a pod monitor of its own for a static launch, advertised as
``socket.gethostname()`` to remote workers); ``--autoscale-policy
JSON|@file|file`` (validated here: a bad field exits naming it; implies
``--elastic``) arms the elastic driver's autoscale engine, whose
decisions ``--autoscale-log`` appends as JSON lines; ``--check-build``
prints what this installation of the port can do.
"""

from __future__ import annotations

import argparse
import ipaddress
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common.config import runtime_env
from . import hosts as hosts_lib

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


def used_hosts(host_infos: List[hosts_lib.HostInfo], np: int) -> List[str]:
    """The hosts covering ``np`` slots, in rank order."""
    return list(dict.fromkeys(
        s.hostname for s in hosts_lib.get_host_assignments(host_infos, np)))


def _loopback(hostname: str) -> bool:
    if hostname == "localhost":
        return True
    try:
        return ipaddress.ip_address(hostname).is_loopback
    except ValueError:
        return False


def driver_address(hostnames) -> str:
    """The address workers on ``hostnames`` reach this process at (its
    rendezvous KV, its pod monitor): ``127.0.0.1`` when every host is a
    loopback name, else this machine's hostname."""
    if all(_loopback(h) for h in hostnames):
        return "127.0.0.1"
    return socket.gethostname()


def ssh_argv(hostname: str, env: Dict[str, str], command: List[str],
             ssh_port: Optional[int] = None) -> Tuple[List[str],
                                                     Optional[bytes]]:
    """``(ssh argv, stdin bytes or None)`` that runs ``command`` on
    ``hostname`` in this directory under ``env``. ``*_SECRET`` variables
    are not in the argv (any user of the remote host can read it): they
    travel as one export line on stdin, which the remote shell reads
    and evaluates before the command."""
    secrets = {k: v for k, v in env.items() if k.endswith("_SECRET")}
    plain = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items()
                     if k not in secrets)
    remote = (f"cd {shlex.quote(os.getcwd())} && {plain} "
              + " ".join(shlex.quote(c) for c in command))
    stdin = None
    if secrets:
        remote = ('IFS= read -r __HVD_SECRET_ENV__ && '
                  'eval "export $__HVD_SECRET_ENV__"; ' + remote)
        stdin = (" ".join(f"{k}={shlex.quote(v)}"
                          for k, v in secrets.items()) + "\n").encode()
    argv = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        argv += ["-p", str(ssh_port)]
    return argv + [hostname, remote], stdin


def slot_env(coordinator: str, slot: hosts_lib.SlotInfo, num_proc: int,
             env_extra: Dict[str, str]) -> Dict[str, str]:
    """One remote slot's environment: this process's ``HVD_TPU_*``
    knobs, the world's wiring, the slot's local rank on its host and its
    host name, and ``env_extra`` on top."""
    base = {k: v for k, v in os.environ.items() if k.startswith("HVD_TPU_")}
    return build_env_for_slot(
        base, coordinator, num_proc, slot.rank,
        {**env_extra, **_slot_local_env(slot.local_rank, slot.local_size),
         "HVD_TPU_HOSTNAME": slot.hostname})


def coordinator_host(hosts: List[str],
                     ssh_port: Optional[int] = None) -> Tuple[str, bool]:
    """``(host, discovered)``: the first host, or with
    ``HVD_TPU_NIC_DISCOVERY=1`` and several hosts the address NIC
    discovery picked (True), falling back to the first host."""
    if runtime_env("NIC_DISCOVERY") == "1" and len(hosts) > 1:
        picked = _nic_discovery_coordinator(hosts, ssh_port)
        if picked:
            return picked, True
    return hosts[0], False


def run_ssh(host_infos: List[hosts_lib.HostInfo], command: List[str],
            env_extra: Dict[str, str], np: int, verbose: bool = False,
            ssh_port: Optional[int] = None) -> int:
    """The ssh fan-out: one process a slot of the ``np`` slots the hosts
    give, in host order (see the module docstring), each started with
    ``ssh <host>``; fails fast. Returns the first non-zero exit code, or
    0."""
    from . import safe_shell_exec as sse

    slots = hosts_lib.get_host_assignments(host_infos, np)
    hosts = used_hosts(host_infos, np)
    host, discovered = coordinator_host(hosts, ssh_port)
    coordinator = f"{host}:{_free_port()}"
    print(f"hvdtpurun-torch: {np} workers over ssh on {','.join(hosts)}; "
          f"coordinator {coordinator} "
          f"({'NIC discovery' if discovered else 'first host'})",
          flush=True)
    handles = []
    for s in slots:
        argv, stdin = ssh_argv(s.hostname,
                               slot_env(coordinator, s, np, env_extra),
                               command, ssh_port)
        handles.append(sse.spawn(argv, prefix=f"{s.hostname}[{s.rank}]",
                                 input_data=stdin))
    return _wait_fail_fast(handles, [h.thread for h in handles])


def _nic_discovery_coordinator(hosts: List[str],
                               ssh_port: Optional[int]) -> Optional[str]:
    """Routable-NIC discovery before the fan-out: start a task server on
    every host over ssh (``driver_service --serve --ttl 120``, which
    prints ``TASKSERVER <port>``), intersect the hosts' interface sets
    (loopback dropped) and return the first host's address on the first
    common interface that answers a probe from here. None (keep the
    host name) on any failure: discovery never fails a launch."""
    import select

    from . import driver_service as ds

    servers: List[subprocess.Popen] = []
    try:
        task_addrs = {}
        for hostname in hosts:
            argv = ["ssh", "-o", "StrictHostKeyChecking=no",
                    "-o", "BatchMode=yes"]
            if ssh_port:
                argv += ["-p", str(ssh_port)]
            argv += [hostname, f"cd {shlex.quote(os.getcwd())} && "
                     f"{shlex.quote(sys.executable)} -m "
                     "horovod_tpu_torch.runner.driver_service --serve "
                     "--ttl 120"]
            p = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                 stderr=subprocess.DEVNULL, text=True)
            servers.append(p)
            # A bounded wait: a hung host degrades discovery, it does not
            # hang the launch.
            ready, _, _ = select.select([p.stdout], [], [], 20.0)
            line = (p.stdout.readline() or "").strip() if ready else ""
            if not line.startswith("TASKSERVER "):
                return None
            task_addrs[hostname] = (hostname, int(line.split()[1]))
        common = ds.discover_routable_interfaces(task_addrs)
        ifaces = ds.query_interfaces(task_addrs[hosts[0]])
        port0 = task_addrs[hosts[0]][1]
        for iface in common:
            ip = ifaces.get(iface)
            # A host-local bridge exists everywhere but answers with the
            # wrong machine's stack: only an address that reaches the
            # first host's server from here is taken.
            if ip and ds.probe_reachable((ip, port0)):
                return ip
        return None
    except (OSError, RuntimeError, ValueError):
        return None
    finally:
        for p in servers:
            if p.poll() is None:
                p.terminate()
        for p in servers:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


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


def _start_pod_monitor(env_extra: Dict[str, str],
                       advertise_host: str = "127.0.0.1"):
    """The pod monitor of a static launch, when
    ``HVD_TPU_POD_METRICS_PORT`` asks for one: without a rendezvous KV
    in play, one is started here for the workers' endpoint
    advertisement alone, at ``advertise_host`` (this machine's name for
    remote workers). Returns ``(monitor, owned_rdv)``; the caller stops
    both."""
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
        owned_rdv = RendezvousServer(
            "127.0.0.1" if advertise_host == "127.0.0.1" else "0.0.0.0")
        kv_port = owned_rdv.start()
        env_extra["HVD_TPU_RENDEZVOUS"] = f"{advertise_host}:{kv_port}"
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


def _lsf_hosts():
    """The LSF allocation's hosts inside one, else None; a stale
    ``LSB_JOBID`` without host variables logs a line and launches
    locally."""
    from . import lsf as lsf_lib

    if not lsf_lib.in_lsf():
        return None
    try:
        return lsf_lib.lsf_hosts()
    except RuntimeError as e:
        print(f"hvdtpurun-torch: ignoring LSF environment ({e}); "
              "launching locally", file=sys.stderr)
        return None


def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.version:
        from .. import __version__

        print(__version__)
        return 0
    args = apply_config_file(args, argv)
    if args.check_build:
        print(check_build())
        return 0
    # Only an UNSET -np may grow to this machine's GPU count below.
    np_unset = args.num_proc is None
    if np_unset:
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
        host_infos = _lsf_hosts()
        if host_infos is None and np_unset:
            from . import gpu_hosts

            gpus = gpu_hosts.local_gpu_count()
            if gpus is not None and gpus > 1:
                print(f"hvdtpurun-torch: {gpus} GPUs on this machine; "
                      f"running -np {gpus}", file=sys.stderr)
                args.num_proc = gpus
    if host_infos is not None:
        # -np beyond the hosts' slots raises rather than oversubscribes.
        hosts_lib.get_host_assignments(host_infos, args.num_proc)
    local = _is_local(host_infos)
    monitor, owned_rdv = _start_pod_monitor(
        env_extra, "127.0.0.1" if local else driver_address(
            used_hosts(host_infos, args.num_proc)))
    try:
        if local:
            return run_local(args.num_proc, command, env_extra,
                             args.verbose)
        return run_ssh(host_infos, command, env_extra, args.num_proc,
                       args.verbose, args.ssh_port)
    finally:
        if monitor is not None:
            monitor.stop()
        if owned_rdv is not None:
            owned_rdv.stop()


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
