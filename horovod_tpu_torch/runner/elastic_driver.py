"""The port's elastic driver: host discovery, the blacklist, rank-stable
assignment and the worker lifecycle of one epoch — its copy of
``horovod_tpu/runner/elastic_driver.py`` (``FixedHostDiscovery``,
``ScriptHostDiscovery``, ``HostManager`` with the blacklist TTL,
``ElasticDriver``, ``_run_epoch``, ``run_elastic``).

Per epoch: wait for ``min_np`` slots among the hosts that are not
blacklisted, assign ranks (surviving hosts keep theirs), spawn one
worker a slot with a fresh coordinator port (so every epoch's world
meets on a new TCPStore), and watch the exits. A worker that exits
non-zero on its own blacklists its host (for ``HVD_TPU_BLACKLIST_TTL_S``,
doubled a strike); ``PEER_FAILURE_EXIT_CODE`` (79, "a peer failed") and
``HOSTS_UPDATED_EXIT_CODE`` (80, a topology change or a preemption)
restart the epoch without a blacklist. The driver's rendezvous KV holds
``elastic/topology_version``, which it bumps on every host change and
epoch restart and the workers poll at ``commit()``.

``HVD_TPU_ELASTIC_FORCE_LOCAL`` runs the named hosts on this machine:
each host's workers are local processes of ONE real multi-process world
(the JAX driver gives each worker a world of its own there, because its
CPU backend has no multi-process collectives; gloo has them), so a
``crash`` of one host's worker is a real peer death for the others.

Telemetry and control, in this process so their memory spans epochs:

* the autoscale engine (``common/autoscale.py``, armed by
  ``--autoscale-policy`` / ``HVD_TPU_AUTOSCALE``): every
  ``tick_interval_s`` it reads the workers' step reports off the KV
  (and the pod monitor's scrapes) and its evict/shrink decisions
  blacklist the host for the policy's TTL and end the epoch through
  the same host-update channel a discovery change uses; before each
  epoch ``pre_epoch`` adopts returned or new capacity (a ``grow``) or
  holds it back (``np_cap``);
* the pod monitor (``common/podmon.py``, ``--pod-metrics-port``):
  scrapes every worker's ``/metrics.json`` (advertised over the KV) and
  serves the merged ``/pod/metrics``; workers default to an ephemeral
  ``/metrics`` port when it runs;
* the flight recorder's fan-out: the first failure exit of an epoch
  sends SIGUSR2 to every live worker, so each writes its black box
  (``HVD_TPU_FLIGHTREC_SIGNAL_GRACE_S`` is the wait before a kill).

An epoch on hosts other than this machine spawns its slots over ssh,
one process a slot under ``launch.run_ssh``'s rules (host order, the
coordinator the first host's or NIC discovery's, ``*_SECRET`` variables
on stdin). The rendezvous KV listens on every interface (on
``127.0.0.1`` alone under ``HVD_TPU_ELASTIC_FORCE_LOCAL``); an ssh
epoch's workers reach it at this machine's name (at ``127.0.0.1`` when
every host is a loopback address). Ending an ssh client does not signal its
remote worker, as in the JAX driver: a remote survivor leaves through
its own failed collective (the process group's timeout is the stall
bound under elastic).

Hybrid worlds: under ``HVD_TPU_PARALLEL`` (the caller's environment or
the launcher's) the autoscale engine is role-aware (a ``min_np`` that
splits a model replica fails the launch, naming the roles), the epoch
loop waits at the respec ladder's floor (``engine.min_world``), and
before each epoch ``engine.plan_respec`` re-solves the mesh for the
usable capacity: a new spec is re-exported to the workers as
``HVD_TPU_PARALLEL`` and the world is pinned to its exact size. The
workers carry their state across through ``checkpoint.restore_sharded``.
A caller's spawner or rendezvous server (the Spark and Ray launches) has
no counterpart.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Set

from ..common import faults as faults_lib
from ..common.config import runtime_env
from . import hosts as hosts_lib
from . import launch as launch_lib
from .launch import build_env_for_slot
from .rendezvous import RendezvousServer

logger = logging.getLogger("horovod_tpu_torch")


class HostDiscovery:
    """Pluggable discovery source (reference discovery.py:25-60)."""

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        raise NotImplementedError


class FixedHostDiscovery(HostDiscovery):
    def __init__(self, hosts: Dict[str, int]):
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class ScriptHostDiscovery(HostDiscovery):
    """Discovery via a user script printing 'hostname:slots' lines
    (reference discovery.py HostDiscoveryScript; the integration tests
    mutate the script's output to simulate host churn — elastic_common.py).

    Flap debounce: a CHANGED host set is only reported upward after the
    script returns the same new set ``debounce`` consecutive polls
    (``HVD_TPU_DISCOVERY_DEBOUNCE``, default 2) — one bad scrape (a
    truncated instance list, a half-registered VM) must not trigger a
    spurious reshard that throws away a healthy epoch. The first
    successful scrape is adopted immediately (there is nothing to
    debounce against), and ``debounce<=1`` restores the trusting
    historical behavior.
    """

    def __init__(self, script: str, timeout_s: float = 30.0,
                 debounce: Optional[int] = None):
        self._script = script
        self._timeout_s = timeout_s
        self._last: Dict[str, int] = {}
        self._primed = False
        if debounce is None:
            try:
                debounce = int(runtime_env("DISCOVERY_DEBOUNCE", "2"))
            except ValueError:
                debounce = 2
        self._debounce = max(1, debounce)
        self._pending: Optional[Dict[str, int]] = None
        self._pending_count = 0
        # Failure backoff: a flapping/crashing discovery script gets
        # re-run on an exponential full-jitter schedule
        # (HVD_TPU_DISCOVERY_BACKOFF_{BASE_S,MAX_S}) instead of every
        # poll — the last good answer serves in between.
        self._backoff = faults_lib.Backoff.from_env(
            "HVD_TPU_DISCOVERY_BACKOFF", base_s=1.0, cap_s=30.0)
        self._retry_at = 0.0

    def _fail(self, why: str) -> Dict[str, int]:
        delay = self._backoff.next_delay()
        self._retry_at = time.monotonic() + delay
        faults_lib.stats.bump("discovery_retries")
        logger.warning("elastic: discovery script failed (%s); keeping "
                       "last known hosts, next attempt in %.1fs",
                       why, delay)
        return dict(self._last)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        # A hung or transiently failing script must not kill the discovery
        # thread or wipe the host set — fall back to the last good answer
        # (the reference's HostManager likewise only applies *successful*
        # discovery results).
        if time.monotonic() < self._retry_at:
            return dict(self._last)
        try:
            out = subprocess.run([self._script], capture_output=True,
                                 text=True, timeout=self._timeout_s)
        except (subprocess.TimeoutExpired, OSError) as e:
            return self._fail(str(e))
        if out.returncode != 0:
            return self._fail(f"exit code {out.returncode}")
        hosts: Dict[str, int] = {}
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                name, slots = line.rsplit(":", 1)
                hosts[name] = int(slots)
            else:
                hosts[line] = 1
        self._backoff.reset()
        self._retry_at = 0.0
        return self._debounced(hosts)

    def _debounced(self, hosts: Dict[str, int]) -> Dict[str, int]:
        """Adopt a changed host set only after ``debounce`` consecutive
        identical scrapes; the last adopted answer serves meanwhile."""
        if not self._primed:
            # First successful scrape: nothing to debounce against.
            self._primed = True
            self._last = dict(hosts)
            return dict(hosts)
        if hosts == self._last:
            self._pending = None
            self._pending_count = 0
            return dict(hosts)
        if self._pending is not None and hosts == self._pending:
            self._pending_count += 1
        else:
            self._pending = dict(hosts)
            self._pending_count = 1
        if self._pending_count >= self._debounce:
            logger.info(
                "elastic: discovery change confirmed after %d "
                "consecutive scrapes: %s -> %s", self._pending_count,
                sorted(self._last), sorted(hosts))
            self._last = dict(hosts)
            self._pending = None
            self._pending_count = 0
            return dict(hosts)
        logger.info(
            "elastic: discovery reported a changed host set (%s -> %s); "
            "debouncing (%d/%d consecutive scrapes)",
            sorted(self._last), sorted(hosts), self._pending_count,
            self._debounce)
        return dict(self._last)


@dataclasses.dataclass
class HostState:
    slots: int
    blacklisted: bool = False


@dataclasses.dataclass
class _BlacklistEntry:
    until: float       # monotonic expiry; inf = permanent
    strikes: int       # failures so far — doubles the next exile
    announced: bool = False  # recovery-probe eligibility logged once


class HostManager:
    """Tracks current/blacklisted hosts (reference discovery.py:61-164).

    The blacklist carries a TTL (``HVD_TPU_BLACKLIST_TTL_S``, default
    300 s; <= 0 restores the reference's permanent exile): a host that
    failed once is routinely healthy again after a reboot/reschedule, and
    permanent exile slowly bleeds a long-lived job of capacity. When an
    entry expires the host becomes eligible again (the recovery probe —
    it simply re-enters assignment); a host that fails again is exiled
    for twice as long per accumulated strike."""

    def __init__(self, discovery: HostDiscovery,
                 blacklist_ttl_s: Optional[float] = None,
                 clock=time.monotonic):
        self._discovery = discovery
        self._hosts: Dict[str, HostState] = {}
        if blacklist_ttl_s is None:
            try:
                blacklist_ttl_s = float(runtime_env("BLACKLIST_TTL_S",
                                                    "300"))
            except ValueError:
                blacklist_ttl_s = 300.0
        self._ttl = blacklist_ttl_s
        self._clock = clock
        self._blacklist: Dict[str, _BlacklistEntry] = {}
        self._last_usable: Optional[Dict[str, int]] = None
        self._lock = threading.Lock()

    def _is_blacklisted_locked(self, hostname: str) -> bool:
        e = self._blacklist.get(hostname)
        if e is None:
            return False
        if self._clock() < e.until:
            return True
        if not e.announced:
            # Recovery probe: the exile expired; the host re-enters
            # assignment on the next topology change. Strikes persist so
            # a re-failure is exiled longer, not forever-flapping.
            e.announced = True
            faults_lib.stats.bump("blacklist_recoveries")
            logger.warning(
                "elastic: blacklist TTL expired for host %s (strike %d); "
                "eligible for recovery probe", hostname, e.strikes)
        return False

    def update_available_hosts(self) -> bool:
        """Poll discovery; returns True if the USABLE host set changed —
        including a blacklist TTL expiring with no discovery change."""
        found = self._discovery.find_available_hosts_and_slots()
        found = faults_lib.maybe_discovery_flap(found)
        with self._lock:
            self._hosts = {n: HostState(s) for n, s in found.items()}
            usable = {n: s for n, s in found.items()
                      if not self._is_blacklisted_locked(n)}
            prev = self._last_usable
            self._last_usable = usable
            if prev is None:
                return bool(usable)
            return usable != prev

    def blacklist(self, hostname: str, ttl_s: Optional[float] = None,
                  permanent: bool = False) -> None:
        """Exile a host. ``ttl_s`` overrides the configured TTL for this
        entry (the autoscale engine passes its policy's
        ``evict_ttl_s``); strike doubling applies to either TTL.
        ``permanent=True`` exiles forever (the engine's escalation
        decisions — repeated stragglers, struck-out hosts)."""
        with self._lock:
            e = self._blacklist.get(hostname)
            strikes = (e.strikes if e else 0) + 1
            ttl = self._ttl if ttl_s is None else ttl_s
            if permanent or ttl <= 0:
                until = float("inf")
            else:
                until = self._clock() + ttl * (2 ** (strikes - 1))
            self._blacklist[hostname] = _BlacklistEntry(until, strikes)
        faults_lib.stats.bump("blacklist_events")
        if permanent or ttl <= 0:
            logger.warning("elastic: blacklisted host %s (permanent)",
                           hostname)
        else:
            logger.warning(
                "elastic: blacklisted host %s for %.0fs (strike %d)",
                hostname, ttl * (2 ** (strikes - 1)), strikes)

    def current_hosts(self) -> Dict[str, int]:
        with self._lock:
            return {n: h.slots for n, h in self._hosts.items()
                    if not self._is_blacklisted_locked(n)}

    def is_blacklisted(self, hostname: str) -> bool:
        with self._lock:
            return self._is_blacklisted_locked(hostname)

    def blacklist_snapshot(self) -> Dict[str, Dict]:
        """Diagnostic view: hostname -> {strikes, remaining_s}."""
        with self._lock:
            now = self._clock()
            return {h: {"strikes": e.strikes,
                        "remaining_s": max(0.0, e.until - now)}
                    for h, e in self._blacklist.items()}

    def permanently_exhausted(self) -> bool:
        """True when the job can NEVER regain capacity on its own:
        discovery knows at least one host and every known host sits on
        a permanent (infinite) blacklist entry. A transiently empty
        scrape (a flap) or a finite TTL both return False — those heal
        with time, and aborting on them would turn one bad scrape into
        a dead job."""
        with self._lock:
            if not self._hosts:
                return False
            for h in self._hosts:
                e = self._blacklist.get(h)
                if e is None or e.until != float("inf"):
                    return False
            return True


class ElasticDriver:
    """Discovery loop + stable rank assignment (reference driver.py:68-309).
    """

    def __init__(self, discovery: HostDiscovery, min_np: int, max_np: int,
                 discovery_interval: float = 1.0):
        self.host_manager = HostManager(discovery)
        self.min_np = min_np
        self.max_np = max_np
        self.discovery_interval = discovery_interval
        self._assignments: Dict[str, List[hosts_lib.SlotInfo]] = {}
        self._shutdown = threading.Event()
        self._host_change = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- discovery loop (reference driver.py:90-92, 1 s poll) -------------

    def start_discovery(self) -> None:
        self.host_manager.update_available_hosts()

        def loop():
            while not self._shutdown.is_set():
                if self.host_manager.update_available_hosts():
                    self._host_change.set()
                self._shutdown.wait(self.discovery_interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        if self._thread:
            self._thread.join(timeout=5)

    def hosts_updated(self) -> bool:
        """Consumed by workers' check_host_updates()."""
        if self._host_change.is_set():
            self._host_change.clear()
            return True
        return False

    def wait_for_available_slots(self, min_np: Optional[int] = None,
                                 timeout_s: float = 600.0) -> Dict[str, int]:
        """Block until >= min_np slots exist (reference driver.py:139-160).
        """
        need = min_np if min_np is not None else self.min_np
        deadline = time.monotonic() + timeout_s
        while True:
            hosts = self.host_manager.current_hosts()
            if sum(hosts.values()) >= need:
                return hosts
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fewer than min_np={need} slots available after "
                    f"{timeout_s}s")
            self.host_manager.update_available_hosts()
            time.sleep(self.discovery_interval)

    # -- rank assignment (reference driver.py _update_host_assignments) ---

    def update_assignments(self, np_cap: Optional[int] = None,
                           np_exact: Optional[int] = None
                           ) -> List[hosts_lib.SlotInfo]:
        """Re-assign ranks, keeping existing hosts' ranks stable.
        ``np_cap`` (autoscale hold: the policy refused new capacity)
        additionally caps the world below max_np
        but never below min_np. ``np_exact`` (elastic respec: the
        re-solved mesh must factor the world EXACTLY —
        docs/elastic.md "hybrid worlds") pins np even below min_np."""
        hosts = self.host_manager.current_hosts()
        with self._lock:
            prev_order = [h for h in self._assignments if h in hosts]
            new_hosts = [h for h in hosts if h not in self._assignments]
            ordered = prev_order + sorted(new_hosts)
            np_total = min(self.max_np,
                           sum(hosts[h] for h in ordered))
            if np_cap is not None:
                np_total = max(self.min_np, min(np_total, np_cap))
            if np_exact is not None:
                np_total = min(np_total, np_exact)
            infos = hosts_lib.get_host_assignments(
                [hosts_lib.HostInfo(h, hosts[h]) for h in ordered], np_total)
            self._assignments = {}
            for s in infos:
                self._assignments.setdefault(s.hostname, []).append(s)
            return infos

    def assigned_hosts(self) -> Dict[str, int]:
        """Hosts of the CURRENT epoch's assignments with their slot
        counts — the world that is actually running (the autoscale
        engine evaluates against this, not the usable set: a
        usable-but-unassigned host has no worker whose silence could
        mean a stall)."""
        with self._lock:
            return {h: len(s) for h, s in self._assignments.items()}

    def record_failure(self, hostname: str) -> None:
        # Blacklist only — no _host_change signal: the caller restarts
        # the epoch itself, and a latched event would make the NEXT
        # epoch's first poll read a phantom topology change and throw
        # away freshly spawned workers.
        self.host_manager.blacklist(hostname)

    def clear_host_updates(self) -> None:
        """Drop any pending host-change signal (called at epoch start so
        changes already folded into the new assignments don't re-fire)."""
        self._host_change.clear()


_LOCAL_NAMES = ("localhost", "127.0.0.1")


def _is_local_epoch(slots: List[hosts_lib.SlotInfo]) -> bool:
    if runtime_env("ELASTIC_FORCE_LOCAL"):
        return True
    return all(s.hostname in _LOCAL_NAMES
               or s.hostname == socket.gethostname() for s in slots)


def _stream(proc: subprocess.Popen, tag: str) -> threading.Thread:
    def pump():
        assert proc.stdout is not None
        for line in iter(proc.stdout.readline, b""):
            sys.stdout.write(f"[{tag}]: {line.decode(errors='replace')}")
            sys.stdout.flush()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


def _spawn_epoch(slots: List[hosts_lib.SlotInfo], command: List[str],
                 env_extra: Dict[str, str], ssh_port: Optional[int] = None):
    """One worker a slot, one world over all of them on a fresh
    coordinator port: local processes, or over ssh for hosts beyond this
    machine. Returns ``[(hostname, Popen)]`` and the output pumps."""
    from .launch import _free_port, _slot_local_env

    procs, threads = [], []
    if not _is_local_epoch(slots):
        hosts = list(dict.fromkeys(s.hostname for s in slots))
        host, _ = launch_lib.coordinator_host(hosts, ssh_port)
        coordinator = f"{host}:{_free_port()}"
        env_extra = dict(env_extra)
        rdv = env_extra.get("HVD_TPU_RENDEZVOUS")
        if rdv:
            env_extra["HVD_TPU_RENDEZVOUS"] = (
                f"{launch_lib.driver_address(hosts)}:"
                f"{rdv.rsplit(':', 1)[1]}")
        for s in slots:
            argv, stdin = launch_lib.ssh_argv(
                s.hostname,
                launch_lib.slot_env(coordinator, s, len(slots), env_extra),
                command, ssh_port)
            p = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT,
                                 stdin=subprocess.PIPE if stdin else None)
            if stdin:
                p.stdin.write(stdin)
                p.stdin.close()
            procs.append((s.hostname, p))
            threads.append(_stream(p, f"{s.hostname}[{s.rank}]"))
        return procs, threads
    coordinator = f"127.0.0.1:{_free_port()}"
    for s in slots:
        # Every slot is on this machine: the local rank is the rank, so
        # a machine with several GPUs gives each worker its own.
        env = build_env_for_slot(
            dict(os.environ), coordinator, len(slots), s.rank,
            {**env_extra, **_slot_local_env(s.rank, len(slots)),
             "HVD_TPU_HOSTNAME": s.hostname})
        p = subprocess.Popen(command, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        procs.append((s.hostname, p))
        threads.append(_stream(p, f"{s.hostname}[{s.rank}]"))
    return procs, threads


def _run_epoch(driver: ElasticDriver, slots: List[hosts_lib.SlotInfo],
               command: List[str], env_extra: Dict[str, str],
               poll_interval: float = 0.1, on_hosts_updated=None,
               grace_secs: Optional[float] = None, on_tick=None,
               tick_interval_s: Optional[float] = None,
               ssh_port: Optional[int] = None):
    """Run one epoch and track each worker's exit. Returns ``(rc,
    failed_hosts, interrupted)``: ``failed_hosts`` exited non-zero on
    their own (blacklist candidates); ``interrupted`` means a discovery
    change or an autoscale decision ended the epoch (never
    blacklisted). On a change ``on_hosts_updated`` runs first (the
    topology version moves), then the workers get
    ``HVD_TPU_ELASTIC_GRACE_SECS`` to exit at a ``commit()`` before they
    are terminated; a peer-failure exit ends the epoch the same way.
    ``on_tick`` (the autoscale tick) runs every ``tick_interval_s``; it
    returns True when it reshaped the world. The first failure exit
    sends SIGUSR2 to every live worker (its black box)."""
    from ..common.elastic import (HOSTS_UPDATED_EXIT_CODE,
                                  PEER_FAILURE_EXIT_CODE)

    procs, threads = _spawn_epoch(slots, command, env_extra, ssh_port)
    rc = 0
    failed: Set[str] = set()
    interrupted = terminated = epoch_ending = False
    grace_deadline = None
    grace = (grace_secs if grace_secs is not None else
             float(runtime_env("ELASTIC_GRACE_SECS", "30")))
    dumps_requested = False

    def request_dumps() -> bool:
        # The epoch is dying on a FAILURE: ask every live worker for
        # its black box (SIGUSR2 -> common/flightrec.py), while the
        # survivors are still alive — a peer-failure exit is on its way.
        nonlocal dumps_requested
        signaled = False
        for _, p in procs:
            if p.poll() is not None:
                continue
            try:
                p.send_signal(signal.SIGUSR2)
                signaled = True
            except (ProcessLookupError, OSError):
                pass
        dumps_requested = dumps_requested or signaled
        return signaled

    def terminate_all(dump_first: bool = False):
        if dump_first and not dumps_requested:
            try:
                dump_grace = float(runtime_env(
                    "FLIGHTREC_SIGNAL_GRACE_S", "1.0"))
            except ValueError:
                dump_grace = 1.0
            if request_dumps() and dump_grace > 0:
                time.sleep(dump_grace)
        for _, p in procs:
            try:
                p.terminate()
            except (ProcessLookupError, OSError):
                pass

    next_tick = (time.monotonic() + tick_interval_s
                 if on_tick is not None and tick_interval_s else None)

    try:
        while True:
            running = False
            for hostname, p in procs:
                code = p.poll()
                if code is None:
                    running = True
                elif code != 0 and not terminated:
                    rc = rc or code
                    if code == HOSTS_UPDATED_EXIT_CODE:
                        interrupted = epoch_ending = True
                    elif code == PEER_FAILURE_EXIT_CODE or (
                            dumps_requested and code == -signal.SIGUSR2):
                        # "My peer failed": restart, do not blacklist
                        # (nor a worker the dump request caught exiting).
                        epoch_ending = True
                    else:
                        if hostname not in failed:
                            logger.warning("elastic: the worker on %s "
                                           "exited %d", hostname, code)
                        failed.add(hostname)
            if (epoch_ending and not interrupted and not terminated
                    and not dumps_requested):
                # A peer-failure exit is ending the epoch: collect the
                # survivors' rings now, while they are alive.
                request_dumps()
            if failed and not terminated:
                terminate_all(dump_first=True)
                terminated = True
            if next_tick is not None and not terminated \
                    and not interrupted and time.monotonic() >= next_tick:
                # Autoscale tick: its evict/shrink decisions blacklist
                # their hosts and reshape through the host-update channel.
                next_tick = time.monotonic() + tick_interval_s
                try:
                    reshape = bool(on_tick())
                except Exception:  # noqa: BLE001 — the control loop must
                    logger.exception(   # never kill a healthy epoch
                        "autoscale: tick evaluation failed")
                    reshape = False
                if reshape:
                    interrupted = True
                    if on_hosts_updated is not None:
                        on_hosts_updated()
                    grace_deadline = time.monotonic() + grace
            if not terminated and not interrupted and \
                    driver.hosts_updated():
                interrupted = True
                if on_hosts_updated is not None:
                    on_hosts_updated()
                grace_deadline = time.monotonic() + grace
            if epoch_ending and not terminated and grace_deadline is None:
                grace_deadline = time.monotonic() + grace
            if (grace_deadline is not None and not terminated
                    and time.monotonic() > grace_deadline):
                # Black boxes only on a FAILURE ending: a reshape is
                # routine.
                terminate_all(dump_first=(rc != 0 and not interrupted))
                terminated = True
            if not running:
                break
            time.sleep(poll_interval)
        for t in threads:
            t.join(timeout=2)
        return rc, failed, interrupted
    except KeyboardInterrupt:
        for _, p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        for _, p in procs:
            p.wait()
        return 1, failed, interrupted


def run_elastic(args, command: List[str], env_extra: Dict[str, str],
                discovery: Optional[HostDiscovery] = None,
                reset_limit: Optional[int] = None,
                slot_wait_timeout_s: Optional[float] = None,
                grace_secs: Optional[float] = None) -> int:
    """The driver side of an elastic launch (see the module docstring).
    Returns 0 once an epoch ends with every worker at 0; 1 (or the
    epoch's code) past the reset limit, when every host is permanently
    blacklisted, or when fewer than ``min_np`` slots stay available."""
    import secrets as secrets_lib

    min_np = args.min_np or args.num_proc
    max_np = args.max_np or args.num_proc
    if discovery is None:
        if args.host_discovery_script:
            discovery = ScriptHostDiscovery(args.host_discovery_script)
        else:
            host_infos = (hosts_lib.parse_hosts(args.hosts) if args.hosts
                          else [hosts_lib.HostInfo("localhost", max_np)])
            discovery = FixedHostDiscovery(
                {h.hostname: h.slots for h in host_infos})
    faults_lib.refresh_from_env()
    from ..common import autoscale as autoscale_lib
    from ..common import podmon as podmon_lib
    from ..parallel.spec import ENV_PARALLEL, spec_from_env

    # A hybrid spec (the launcher's or the caller's HVD_TPU_PARALLEL)
    # makes the autoscale engine role-aware.
    parallel_spec = spec_from_env({**os.environ, **env_extra})
    # The autoscale policy: the launcher's knobs (env_extra, validated)
    # over the caller's environment. A bad policy fails the launch.
    autoscale_env = {**os.environ, **{
        k: v for k, v in env_extra.items()
        if k.startswith("HVD_TPU_AUTOSCALE")}}
    autoscale_policy = None
    if autoscale_lib.autoscale_enabled(autoscale_env):
        policy = autoscale_lib.AutoscalePolicy.from_env(autoscale_env)
        if policy.enabled:
            autoscale_policy = policy
            logger.warning("autoscale: enabled (policy: %s)",
                           policy.to_json())
            # A floor that splits a model replica fails the launch here,
            # before the driver starts anything.
            policy.resolve_min_np(min_np, parallel_spec)
    driver = ElasticDriver(discovery, min_np, max_np)
    driver.start_discovery()
    # A fresh secret a job, kept out of this process's environment.
    job_secret = secrets_lib.token_hex(16)
    # Workers on other hosts reach the KV at this machine's name: it
    # listens on every interface (the job's secret signs every request)
    # unless the job runs on this machine by construction.
    rdv = RendezvousServer(
        "127.0.0.1" if runtime_env("ELASTIC_FORCE_LOCAL") else "0.0.0.0",
        secret=job_secret.encode())
    rdv_port = rdv.start()
    topo_version = 0
    rdv.put("elastic", "topology_version", str(topo_version).encode())
    env_extra = dict(env_extra)
    env_extra["HVD_TPU_RENDEZVOUS"] = f"127.0.0.1:{rdv_port}"
    env_extra["HVD_TPU_RENDEZVOUS_SECRET"] = job_secret
    env_extra["HVD_TPU_ELASTIC"] = "1"
    for chaos_var in (faults_lib.ENV_PLAN, faults_lib.ENV_LOG):
        if chaos_var in os.environ:
            env_extra.setdefault(chaos_var, os.environ[chaos_var])

    # The pod monitor: every worker's /metrics.json (advertised over this
    # job's KV, plus HVD_TPU_POD_METRICS_ENDPOINTS) merged on
    # /pod/metrics. Workers default to an ephemeral /metrics port.
    pod_monitor = None
    pod_port = podmon_lib.monitor_port_from_env({**os.environ, **env_extra})
    if pod_port is not None:
        pod_monitor = podmon_lib.PodMonitor(podmon_lib.combined_endpoints(
            podmon_lib.kv_endpoints(rdv), podmon_lib.static_endpoints()))
        print(f"hvdtpurun-torch: /pod/metrics on port "
              f"{pod_monitor.start(pod_port)}", flush=True)
        if "HVD_TPU_METRICS_PORT" not in env_extra \
                and runtime_env("METRICS_PORT") is None:
            env_extra["HVD_TPU_METRICS_PORT"] = "0"

    engine = None
    on_tick = None
    if autoscale_policy is not None:
        # The engine reads the reports off the in-process KV (the pod
        # monitor's scrapes fill in ranks the KV never heard from);
        # workers get the resolved policy, so the publisher's window and
        # the engine's agree.
        fetch = autoscale_lib.kv_report_fetcher(rdv)
        if pod_monitor is not None:
            fetch = podmon_lib.merged_report_fetcher(fetch, pod_monitor)
        engine = autoscale_lib.AutoscaleEngine(
            autoscale_policy, min_np, max_np, fetch,
            log_path=autoscale_env.get(autoscale_lib.ENV_LOG, ""),
            parallel=parallel_spec)
        env_extra[autoscale_lib.ENV_ENABLE] = "1"
        env_extra[autoscale_lib.ENV_POLICY] = autoscale_policy.to_json()

        def autoscale_tick() -> bool:
            # Against the RUNNING world (assigned and usable): a usable
            # but unassigned host has no worker whose silence could mean
            # a stall.
            usable = driver.host_manager.current_hosts()
            assigned = {h: n for h, n in driver.assigned_hosts().items()
                        if h in usable}
            acted = False
            for d in engine.tick(assigned,
                                 driver.host_manager.blacklist_snapshot()):
                if d.action in ("evict", "shrink") and d.target:
                    driver.host_manager.blacklist(
                        d.target, ttl_s=d.ttl_s, permanent=d.permanent)
                    acted = True
            return acted

        on_tick = autoscale_tick

    def bump_version():
        nonlocal topo_version
        topo_version += 1
        rdv.put("elastic", "topology_version", str(topo_version).encode())

    limit = (reset_limit if reset_limit is not None
             else int(runtime_env("ELASTIC_RESET_LIMIT", "100")))
    try:
        attempts = 0
        prev_np: Optional[int] = None
        epoch_down_since: Optional[float] = None
        while True:
            # Under a hybrid spec a LOST host is survived by reshaping as
            # far as the permitted rungs allow: wait at the ladder's floor
            # (below it no rung gives a mesh), not at min_np, which floors
            # the engine's voluntary decisions.
            wait_floor = min_np
            if engine is not None and engine.min_world is not None:
                wait_floor = engine.min_world
            try:
                driver.wait_for_available_slots(
                    wait_floor,
                    timeout_s=(600.0 if slot_wait_timeout_s is None
                               else slot_wait_timeout_s))
            except TimeoutError:
                logger.error(
                    "elastic: world shrank below min_np=%d and stayed "
                    "there (usable hosts: %s, blacklist: %s). The last "
                    "persisted state is intact: rerunning this command "
                    "resumes from it once capacity returns.", min_np,
                    driver.host_manager.current_hosts() or "{}",
                    driver.host_manager.blacklist_snapshot() or "{}")
                return 1
            if epoch_down_since is not None:
                faults_lib.stats.add_downtime(
                    time.monotonic() - epoch_down_since)
                epoch_down_since = None
            # Changes before this clear are folded into the assignment.
            driver.clear_host_updates()
            driver.host_manager.update_available_hosts()
            np_cap = None
            np_exact = None
            if engine is not None:
                # The grow gate: capacity beyond the previous world is
                # adopted (a grow decision) or held (np capped).
                np_cap = engine.pre_epoch(
                    prev_np, driver.host_manager.current_hosts())
                # The respec: re-solve the mesh for the capacity the epoch
                # will get (a held grow caps it); a new spec goes to the
                # workers and pins np to its exact size (a partial mesh
                # would drop ranks from the reduction).
                capacity = sum(driver.host_manager.current_hosts().values())
                if np_cap is not None:
                    capacity = min(capacity, np_cap)
                rd = engine.plan_respec(capacity)
                if rd is not None:
                    env_extra[ENV_PARALLEL] = rd.spec.describe()
                    logger.warning("elastic: respec %s -> %s (np=%d)",
                                   parallel_spec.describe(),
                                   rd.spec.describe(), rd.np)
                if engine.current_spec is not None:
                    np_exact = engine.current_spec.total
            slots = driver.update_assignments(np_cap=np_cap,
                                              np_exact=np_exact)
            if engine is not None and engine.current_spec is not None \
                    and len(slots) != engine.current_spec.total:
                # The assignable world moved between planning and
                # assignment (a host dropped in the window): re-solve for
                # what was assignable; if no permitted rung fits, wait for
                # capacity rather than launch a spec the world cannot
                # factor.
                rd = engine.plan_respec(len(slots))
                if rd is not None:
                    env_extra[ENV_PARALLEL] = rd.spec.describe()
                    slots = driver.update_assignments(np_cap=np_cap,
                                                      np_exact=rd.np)
                if len(slots) != engine.current_spec.total:
                    logger.warning(
                        "elastic: assignable world (%d slots) cannot factor "
                        "the solved spec %s; waiting for capacity",
                        len(slots), engine.current_spec.describe())
                    faults_lib.stats.bump("resets")
                    attempts += 1
                    if attempts > limit:
                        logger.error("elastic: reset limit exceeded")
                        return 1
                    time.sleep(driver.discovery_interval)
                    continue
            if engine is not None:
                engine.observe_assignment({s.hostname for s in slots})
            prev_np = len(slots)
            logger.info("elastic launch attempt %d with np=%d over hosts "
                        "%s", attempts, len(slots),
                        sorted({s.hostname for s in slots}))
            env_extra["HVD_TPU_TOPOLOGY_VERSION"] = str(topo_version)
            rc, failed_hosts, interrupted = _run_epoch(
                driver, slots, command, env_extra,
                on_hosts_updated=bump_version, grace_secs=grace_secs,
                on_tick=on_tick,
                tick_interval_s=(autoscale_policy.tick_interval_s
                                 if autoscale_policy is not None
                                 else None),
                ssh_port=getattr(args, "ssh_port", None))
            if rc == 0 and not failed_hosts and not interrupted:
                return 0
            epoch_down_since = time.monotonic()
            faults_lib.stats.bump("resets")
            for h in failed_hosts:
                driver.record_failure(h)
            bump_version()
            attempts += 1
            if attempts > limit:
                logger.error("elastic: reset limit exceeded")
                return rc or 1
            if not driver.host_manager.current_hosts() and \
                    driver.host_manager.permanently_exhausted():
                logger.error(
                    "elastic: every host is permanently blacklisted; the "
                    "last persisted state is preserved (blacklist: %s)",
                    driver.host_manager.blacklist_snapshot() or "{}")
                return rc or 1
    finally:
        if pod_monitor is not None:
            pod_monitor.stop()
        rdv.stop()
        driver.stop()
