"""Fleet-scale digital twin: the whole control plane at thousands of
ranks on one host — the port's copy of ``horovod_tpu/common/fleetsim.py``.

N simulated hosts x ``ParallelSpec`` roles, driven by data-driven models
(per-host step-time distributions, seeded ``FaultPlan`` schedules,
fleet-level events, Poisson/diurnal traffic), plugged into the port's
unmodified engines:

* :class:`~.autoscale.AutoscaleEngine` — straggler/stall/divergence
  scoring, grow gating, respec planning, exactly the driver's instance;
* :class:`~..runner.elastic_driver.HostManager` — the real TTL
  blacklist with strike doubling, on an injected virtual clock;
* :func:`~..parallel.respec.solve_respec` — reached through the
  engine's ``plan_respec`` at every capacity change;
* per-worker :class:`~.faults.FaultInjector` instances — the same
  1-based hit-counter semantics a live worker sees;
* :class:`~..serve.controller.ServeCluster` — the real SLO controller,
  continuous batchers and warm-KV drain for serve-shaped scenarios,
  whose engines run a GPT on ``device`` (the GPU unless the caller
  passes ``"cpu"``).

One event-loop clock (``vt[0]``) advances everything, so a 4096-rank
world ticks in seconds and the decision log is byte-identical across
repeats by construction: the engines observe only virtual time, seeded
draws and deterministically ordered dict/set iteration. A wall-clock
read on any engine's tick path would break that contract.

A serve record does not depend on token values: the scenarios' engines
have no ``eos_id`` and every clock is virtual, so the records the JAX
package banked in ``results/fleetsim/`` hold for the port's own seeded
weights on any device.

Three layers ride on the core: the scenario library
(:func:`builtin_scenarios`, each entry banked as a regression baseline),
trace replay (:func:`steptimes_from_podmetrics`,
:func:`plan_from_flightrec`, :func:`scenario_from_traces`) and the
serving twin (:func:`run_serve_world`, :func:`diurnal_trace`).

Knobs (``config.RUNTIME_KNOBS``): ``HVD_TPU_FLEETSIM_BASELINE_DIR``,
``HVD_TPU_FLEETSIM_SEED``, ``HVD_TPU_FLEETSIM_TICK_CAP``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .config import runtime_env

EVENT_KINDS = ("preempt_storm", "rack_fail", "slow_burn", "flap")
SCENARIO_KINDS = ("train", "serve")

# Default runaway guard: a scenario whose duration_s/tick_interval_s
# exceeds this many ticks is a config bug, not a simulation
# (overridable via HVD_TPU_FLEETSIM_TICK_CAP).
DEFAULT_TICK_CAP = 200_000


def host_name(i: int) -> str:
    """Canonical simulated host naming: ``h0000`` .. ``h4095`` — fixed
    width keeps sorted() == rank order for worlds up to 10k hosts."""
    return f"h{i:04d}"


# -- fleet-level events -------------------------------------------------------

@dataclasses.dataclass
class FleetEvent:
    """One scheduled fleet-level disturbance (scenario schema,
    docs/fleetsim.md). ``preempt_storm``/``flap`` act on DISCOVERY
    (hosts vanish from the scrape); ``rack_fail``/``slow_burn`` act on
    STEP TIME (hosts slow down — the signature the engine must
    attribute). All times are virtual seconds."""

    kind: str
    t: float                 # virtual start time
    duration_s: float = 0.0  # 0 = persistent for the rest of the run
    frac: float = 0.0        # preempt_storm: fraction of hosts dropped
    rack: int = -1           # rack_fail: rack index (host // hosts_per_rack)
    host: str = ""           # slow_burn: the ramping host
    delay_s: float = 0.0     # rack_fail / slow_burn: added step delay
    ramp_s: float = 0.0      # slow_burn: seconds to reach full delay_s

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "FleetEvent":
        if not isinstance(data, dict):
            raise ValueError(
                f"fleetsim event must be a JSON object, got "
                f"{type(data).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(
                f"fleetsim event: unknown field(s) {unknown}; known "
                f"fields: {sorted(known)}")
        ev = cls(**data)
        if ev.kind not in EVENT_KINDS:
            raise ValueError(
                f"fleetsim event: unknown kind {ev.kind!r}; known "
                f"kinds: {list(EVENT_KINDS)}")
        return ev

    def active(self, now: float) -> bool:
        if now < self.t:
            return False
        return self.duration_s <= 0 or now < self.t + self.duration_s


# -- the scenario schema ------------------------------------------------------

@dataclasses.dataclass
class FleetScenario:
    """A complete, self-describing simulated world (docs/fleetsim.md
    schema table). Everything that shapes the run is data: same
    scenario + same seed => byte-identical decision log."""

    name: str
    kind: str = "train"            # train | serve
    seed: int = 42
    # Topology.
    hosts: int = 8
    slots_per_host: int = 1
    hosts_per_rack: int = 8
    host_names: List[str] = dataclasses.field(default_factory=list)
    # World-size bounds the engine enforces.
    min_np: int = 1
    max_np: int = 0                # 0 = hosts * slots_per_host
    # Virtual-time extent and the honest per-step floor.
    duration_s: float = 30.0
    base_step_s: float = 0.1
    # Per-step multiplicative step-time noise: dt *= 1 + jitter * u,
    # u ~ U[0, 1) from a per-host seeded stream (0 = none).
    jitter: float = 0.0
    # Trace replay: per-host base step time overrides (from
    # steptimes_from_podmetrics); hosts absent here use base_step_s.
    base_by_host: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # Declared hybrid mesh ("dp=2,pp=2,tp=2") — role-aware scoring +
    # respec ladder engage when set.
    parallel: str = ""
    # AutoscalePolicy fields (train) / SLOPolicy fields (serve).
    policy: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Seeded FaultPlan dict (common/faults.py schema).
    plan: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Fleet-level events (FleetEvent dicts).
    events: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    # Serve-only: open-loop traffic shape + cluster layout.
    requests: int = 0
    rate_rps: float = 25.0
    peak_rps: float = 0.0          # > 0: diurnal swing up to this
    period_s: float = 8.0          # diurnal period
    replicas: int = 2
    roles: Dict[str, int] = dataclasses.field(default_factory=dict)
    step_s: float = 0.05           # serve round length (virtual)
    # Multi-tenant mix (docs/serve.md "Overload & tenancy"): SLO class
    # name -> weight; {} keeps the historical unclassed trace. Classed
    # requests inherit the policy's per-class default deadlines.
    class_mix: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def field_names(cls) -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls))

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "FleetScenario":
        """Build from a dict with errors that NAME the bad field — the
        same contract as AutoscalePolicy/SLOPolicy.from_dict."""
        if not isinstance(data, dict):
            raise ValueError(
                f"fleetsim scenario must be a JSON object, got "
                f"{type(data).__name__}")
        known = cls.field_names()
        unknown = sorted(set(data) - set(known))
        if unknown:
            raise ValueError(
                f"fleetsim scenario: unknown field(s) {unknown}; "
                f"known fields: {sorted(known)}")
        if "name" not in data:
            raise ValueError("fleetsim scenario: field 'name' is "
                             "required")
        scn = cls(**data)
        scn.validate()
        return scn

    def validate(self) -> "FleetScenario":
        if self.kind not in SCENARIO_KINDS:
            raise ValueError(
                f"fleetsim scenario: unknown kind {self.kind!r}; "
                f"known kinds: {list(SCENARIO_KINDS)}")
        for name in ("hosts", "slots_per_host", "hosts_per_rack"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"fleetsim scenario: field {name!r} must be >= 1, "
                    f"got {getattr(self, name)}")
        for name in ("duration_s", "base_step_s"):
            if getattr(self, name) <= 0:
                raise ValueError(
                    f"fleetsim scenario: field {name!r} must be > 0, "
                    f"got {getattr(self, name)}")
        for ev in self.events:
            FleetEvent.from_dict(ev)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    # -- derived topology ---------------------------------------------------

    def resolved_hosts(self) -> List[str]:
        if self.host_names:
            return list(self.host_names)
        return [host_name(i) for i in range(self.hosts)]

    def rack_of(self, host: str) -> int:
        names = self.resolved_hosts()
        try:
            return names.index(host) // self.hosts_per_rack
        except ValueError:
            return -1


# -- data-driven step times ---------------------------------------------------

class StepTimeModel:
    """Per-host step-time distribution: a base (constant, replayed
    from a pod-metrics trace, or jittered from a per-host seeded
    stream) plus the scenario's rack_fail / slow_burn event deltas.
    Every draw comes from ``numpy`` generators seeded by (scenario
    seed, host index), so the dt sequence per host is a pure function
    of the scenario — the determinism contract."""

    def __init__(self, scenario: FleetScenario,
                 hosts: Sequence[str]):
        self._base: Dict[str, float] = {
            h: float(scenario.base_by_host.get(h, scenario.base_step_s))
            for h in hosts}
        self._jitter = float(scenario.jitter)
        self._rngs: Dict[str, Any] = {}
        if self._jitter > 0:
            import numpy as np

            self._rngs = {
                h: np.random.default_rng([int(scenario.seed), i])
                for i, h in enumerate(hosts)}
        self._events = [FleetEvent.from_dict(e)
                        for e in scenario.events
                        if e.get("kind") in ("rack_fail", "slow_burn")]
        self._rack_of = {h: scenario.rack_of(h) for h in hosts}

    def step_time(self, host: str, now: float) -> float:
        dt = self._base[host]
        if self._jitter > 0:
            dt *= 1.0 + self._jitter * float(self._rngs[host].random())
        for ev in self._events:
            if not ev.active(now):
                continue
            if ev.kind == "rack_fail" \
                    and self._rack_of.get(host) == ev.rack:
                dt += ev.delay_s
            elif ev.kind == "slow_burn" and ev.host == host:
                ramp = 1.0 if ev.ramp_s <= 0 else min(
                    1.0, (now - ev.t) / ev.ramp_s)
                dt += ev.delay_s * ramp
        return dt


# -- the training-control-plane twin ------------------------------------------

@dataclasses.dataclass
class FleetReport:
    """What a run hands back: the deterministic decision log, the
    injection count, and coarse stats for banked JSON records."""

    decisions: List[str]
    injections: int
    stats: Dict[str, Any]


class FleetSim:
    """The virtual-time twin of the TRAINING control plane: real
    ``AutoscalePolicy`` / ``AutoscaleEngine`` / ``HostManager`` /
    per-host ``FaultInjector`` instances advanced by one deterministic
    clock. The loop structure is the production driver's, shrunk to
    its decision-relevant skeleton: poll discovery, recompute
    assignments (pre_epoch cap + observe_assignment + plan_respec),
    let every assigned host step through its tick budget, publish
    per-rank reports, tick the engine, and apply evict/shrink
    decisions through the HostManager blacklist."""

    def __init__(self, scenario: FleetScenario):
        self.scenario = scenario
        self.engine = None        # set by run()
        self.host_manager = None  # set by run()

    # The discovery twin: base host set minus active storm/flap events,
    # then the legacy FaultPlan "discovery" site (drop_host / flap) —
    # exactly what a cloud reclaim or a flaky scrape does to the
    # driver's poll.
    def _make_discovery(self, hosts, slots, drv_inj, vt, drop_events,
                        storm_hosts):
        from ..runner.elastic_driver import HostDiscovery

        class _SimDiscovery(HostDiscovery):
            def find_available_hosts_and_slots(self):
                found = {h: slots for h in hosts}
                for ev in drop_events:
                    if not ev.active(vt[0]):
                        continue
                    if ev.kind == "flap":
                        return {}
                    for h in storm_hosts.get(id(ev), ()):
                        found.pop(h, None)
                spec = drv_inj.check("discovery")
                if spec is not None:
                    if (spec.mode or "flap") == "drop_host":
                        found.pop(spec.target, None)
                    else:
                        found = {}
                return found

        return _SimDiscovery()

    def run(self) -> FleetReport:
        from . import autoscale as autoscale_lib
        from . import faults as faults_lib
        from ..runner.elastic_driver import HostManager

        scn = self.scenario
        hosts = scn.resolved_hosts()
        pol = autoscale_lib.AutoscalePolicy.from_dict(scn.policy)
        plan = scn.plan or {"seed": scn.seed, "faults": []}
        fp = faults_lib.FaultPlan.from_json(json.dumps(plan))
        host_inj = {h: faults_lib.FaultInjector(fp, log_path="",
                                                rank=str(i), host=h)
                    for i, h in enumerate(hosts)}
        drv_inj = faults_lib.FaultInjector(fp, log_path="")
        vt = [0.0]

        spec = None
        if scn.parallel:
            from ..parallel.spec import ParallelSpec

            spec = ParallelSpec.parse(scn.parallel)

        # Storm membership is a seeded draw, fixed per event for the
        # whole run (a reclaim takes a specific machine set, not a
        # fresh sample per poll).
        drop_events = [FleetEvent.from_dict(e) for e in scn.events
                       if e.get("kind") in ("preempt_storm", "flap")]
        storm_hosts: Dict[int, Tuple[str, ...]] = {}
        for ei, ev in enumerate(drop_events):
            if ev.kind != "preempt_storm":
                continue
            import numpy as np

            rng = np.random.default_rng([int(scn.seed), 1000 + ei])
            count = max(1, int(ev.frac * len(hosts)))
            picked = rng.choice(len(hosts), size=min(count, len(hosts)),
                                replace=False)
            storm_hosts[id(ev)] = tuple(hosts[int(i)]
                                        for i in sorted(picked))

        model = StepTimeModel(scn, hosts)
        hm = HostManager(
            self._make_discovery(hosts, scn.slots_per_host, drv_inj,
                                 vt, drop_events, storm_hosts),
            blacklist_ttl_s=pol.evict_ttl_s, clock=lambda: vt[0])
        state = {h: {"steps": 0, "win": deque(maxlen=pol.window),
                     "down_until": 0.0} for h in hosts}
        reports: Dict[int, Any] = {}
        max_np = scn.max_np or len(hosts) * scn.slots_per_host
        engine = autoscale_lib.AutoscaleEngine(
            pol, scn.min_np, max_np, lambda: dict(reports),
            clock=lambda: vt[0], log_path="", parallel=spec)
        self.engine, self.host_manager = engine, hm

        tick_cap = int(runtime_env("FLEETSIM_TICK_CAP")
                       or DEFAULT_TICK_CAP)
        n_ticks = int(scn.duration_s / pol.tick_interval_s) + 1
        if n_ticks > tick_cap:
            raise ValueError(
                f"fleetsim scenario {scn.name!r}: "
                f"duration_s/tick_interval_s = {n_ticks} ticks exceeds "
                f"the HVD_TPU_FLEETSIM_TICK_CAP guard ({tick_cap})")

        assigned: Dict[str, int] = {}
        prev_np: Optional[int] = None
        ticks = 0
        sim_steps = 0
        while vt[0] < scn.duration_s:
            vt[0] += pol.tick_interval_s
            ticks += 1
            hm.update_available_hosts()
            usable = hm.current_hosts()
            if sum(usable.values()) < scn.min_np:
                continue  # the real driver blocks in wait_for_available_slots
            if set(usable) != set(assigned):
                cap = engine.pre_epoch(prev_np, usable)
                names = sorted(usable)
                if cap is not None and cap < len(names):
                    # Hold: keep previously assigned hosts first (rank
                    # stability), drop the newest.
                    names = (sorted(set(assigned) & set(usable))
                             + sorted(set(usable) - set(assigned)))[:cap]
                assigned = {h: usable[h] for h in names}
                engine.observe_assignment(set(assigned))
                prev_np = len(assigned)
                if spec is not None:
                    # The epoch boundary re-solves the mesh for the
                    # surviving capacity (parallel/respec.py ladder).
                    engine.plan_respec(sum(assigned.values()))
            for i, h in enumerate(hosts):
                if h not in assigned:
                    continue
                st = state[h]
                if vt[0] < st["down_until"]:
                    continue  # preempted worker respawning
                budget = pol.tick_interval_s
                last = scn.base_step_s
                while budget > 0:
                    dt = model.step_time(h, vt[0])
                    fs = host_inj[h].check("straggler")
                    if fs is not None:
                        dt = dt + fs.delay_s if fs.delay_s > 0 \
                            else dt * max(fs.scale, 1.0)
                    pre = host_inj[h].check("preempt")
                    if pre is not None:
                        # The worker dies at this commit; the driver
                        # respawns it next epoch (~2 ticks of downtime).
                        st["down_until"] = vt[0] \
                            + 2 * pol.tick_interval_s
                        break
                    st["win"].append(dt)
                    st["steps"] += 1
                    sim_steps += 1
                    budget -= dt
                    last = dt
                if st["win"]:
                    reports[i] = autoscale_lib.StepReport(
                        rank=i, host=h, step=st["steps"],
                        n=len(st["win"]),
                        p50=statistics.median(st["win"]),
                        mean=sum(st["win"]) / len(st["win"]),
                        last=last, t=vt[0],
                        role=(spec.role_label(i) if spec is not None
                              and i < spec.total else None))
            for d in engine.tick(assigned, hm.blacklist_snapshot()):
                if d.action in ("evict", "shrink") and d.target:
                    hm.blacklist(d.target, ttl_s=d.ttl_s,
                                 permanent=d.permanent)
        injections = sum(len(inj.injections)
                         for inj in list(host_inj.values()) + [drv_inj])
        decisions = engine.decision_log()
        actions = [json.loads(l)["action"] for l in decisions]
        return FleetReport(
            decisions=decisions, injections=injections,
            stats={
                "hosts": len(hosts),
                "ranks": len(hosts) * scn.slots_per_host,
                "ticks": ticks,
                "sim_steps": sim_steps,
                "evictions": actions.count("evict"),
                "shrinks": actions.count("shrink"),
                "grows": actions.count("grow"),
                "respecs": actions.count("respec"),
                "blacklisted": sorted(hm.blacklist_snapshot()),
            })


def simulate_fleet(scenario: FleetScenario) -> FleetReport:
    """One-call form of :class:`FleetSim` for train-kind scenarios."""
    return FleetSim(scenario).run()


# -- the role-aware (fixed-report) twin ---------------------------------------

def simulate_roles(spec, policy: Dict[str, Any], *,
                   hosts: Sequence[str], ranks_per_host: int,
                   straggler_rank: int, straggler_delay: float,
                   peer_fraction: float = 0.8, ticks: int = 12,
                   base_step_s: float = 0.1, min_np: int = 1,
                   max_np: Optional[int] = None) -> List[str]:
    """Virtual-time soak of the ROLE-AWARE decision plane over a fixed
    report pattern: a real AutoscaleEngine built over the declared
    ParallelSpec scores seeded reports in which ``straggler_rank`` is
    the slow peer and its whole dp replica is collectively stalled by
    the 1F1B schedule (``peer_fraction`` of the delay lands on every
    replica peer — overlap hides a sliver, which is exactly what the
    strictly-slowest rule needs to pin the conviction). Each eviction
    re-solves the mesh for the surviving capacity through the respec
    ladder. Deterministic by construction; returns the decision log."""
    from . import autoscale as autoscale_lib

    pol = autoscale_lib.AutoscalePolicy.from_dict(policy)
    total = spec.total
    host_of = {r: hosts[r // ranks_per_host] for r in range(total)}
    slow_rep = spec.replica_of(straggler_rank)
    vt = [0.0]
    reports: Dict[int, Any] = {}
    engine = autoscale_lib.AutoscaleEngine(
        pol, min_np=min_np,
        max_np=total if max_np is None else max_np,
        fetch_reports=lambda: dict(reports),
        clock=lambda: vt[0], log_path="", parallel=spec)
    usable = {h: ranks_per_host for h in hosts}
    engine.observe_assignment(set(usable))
    evicted: set = set()
    for tick in range(1, ticks + 1):
        vt[0] += pol.tick_interval_s
        for r in range(total):
            if host_of[r] in evicted:
                reports.pop(r, None)
                continue
            # The straggler's own step interval carries its full extra
            # delay; its replica peers absorb most of it through the
            # schedule stall (1F1B overlap hides a sliver) — the
            # strictly-slowest rule pins the conviction on the source.
            p50 = base_step_s
            if spec.replica_of(r) == slow_rep:
                p50 = base_step_s + (
                    straggler_delay if r == straggler_rank
                    else peer_fraction * straggler_delay)
            reports[r] = autoscale_lib.StepReport(
                rank=r, host=host_of[r], step=tick, n=8, p50=p50,
                mean=p50, last=p50, t=vt[0],
                role=spec.role_label(r))
        live = {h: s for h, s in usable.items() if h not in evicted}
        for d in engine.tick(live):
            if d.action == "evict" and d.target:
                evicted.add(d.target)
                # The epoch boundary after the evict: re-solve the
                # mesh for the surviving capacity.
                engine.plan_respec(
                    sum(s for h, s in usable.items()
                        if h not in evicted))
    return engine.decision_log()


# -- the serving twin ---------------------------------------------------------

def run_serve_world(*, factory, policy, trace,
                    hosts: Sequence[str], replicas: int = 2,
                    roles: Optional[Dict[str, int]] = None,
                    step_s: float = 0.05,
                    log_path: Optional[str] = None,
                    blacklist_ttl_s: float = 30.0,
                    kill_injector=None,
                    on_kill: Optional[Callable] = None,
                    on_round: Optional[Callable] = None,
                    max_rounds: int = 100000):
    """The shared virtual-clock serving world: the REAL ServeCluster
    (SLO controller, continuous batchers, warm-KV drain) + elastic
    HostManager for replica hosts, advanced by rounds x ``step_s``.
    ``kill_injector`` consults the FaultPlan ``replica_kill`` site each
    round (``on_kill`` observes the cluster just before the kill
    lands); ``on_round`` is the generic extension point. Returns
    ``(report, host_manager, cluster)``."""
    from ..runner.elastic_driver import HostManager
    from ..serve.controller import ServeCluster

    vt = [0.0]
    hosts = tuple(hosts)

    class _SimDiscovery:
        def find_available_hosts_and_slots(self):
            return {h: 1 for h in hosts}

    hm = HostManager(_SimDiscovery(), blacklist_ttl_s=blacklist_ttl_s,
                     clock=lambda: vt[0])
    hm.update_available_hosts()
    cluster = ServeCluster(
        factory, policy=policy, replicas=replicas, step_s=step_s,
        log_path=log_path, host_manager=hm,
        host_of=lambda name: f"host{int(name[1:]) % len(hosts)}",
        roles=roles, clock=lambda: vt[0])

    def hook(c, round_idx):
        vt[0] = round_idx * c.step_s
        if kill_injector is not None:
            spec = kill_injector.check("replica_kill")
            if spec is not None and spec.target in c.batchers:
                if on_kill is not None:
                    on_kill(c, spec)
                c.kill_replica(spec.target)
        if on_round is not None:
            on_round(c, round_idx)

    report = cluster.run(trace, max_rounds=max_rounds,
                         round_hook=hook)
    return report, hm, cluster


def diurnal_trace(seed: int, n_requests: int, base_rps: float,
                  peak_rps: float, period_s: float = 8.0,
                  prompt_lens: Sequence[int] = (4, 8, 16),
                  output_lens: Sequence[int] = (4, 8, 16, 32),
                  vocab_size: int = 128):
    """Seeded open-loop trace with a DIURNAL rate swing: instantaneous
    arrival rate follows ``base + (peak-base) * (1 - cos(2*pi*t /
    period)) / 2`` — trough at t=0, crest at half-period. Gaps are
    drawn sequentially (exponential at the instantaneous rate), so the
    same seed replays the byte-identical request sequence, same
    contract as :func:`~..serve.traffic.poisson_trace`."""
    import math

    import numpy as np

    from ..serve.queue import Request
    from ..serve.traffic import TrafficTrace

    if n_requests < 1 or base_rps <= 0 or peak_rps < base_rps:
        raise ValueError(
            f"diurnal_trace: need n_requests >= 1 and "
            f"peak_rps >= base_rps > 0, got "
            f"{n_requests}/{base_rps}/{peak_rps}")
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        rate = base_rps + (peak_rps - base_rps) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * t / period_s))
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.choice(np.asarray(prompt_lens)))
        olen = int(rng.choice(np.asarray(output_lens)))
        prompt = tuple(int(v) for v in rng.integers(1, vocab_size,
                                                    plen))
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=olen,
                            arrival_t=t))
    return TrafficTrace(seed=seed, requests=reqs)


# -- trace replay -------------------------------------------------------------

def steptimes_from_podmetrics(path: str) -> Dict[str, float]:
    """Ingest a ``/pod/metrics`` JSON-lines dump (one record per
    scrape sample: ``{"rank": int, "host": str, "step_time_s": float}``
    — ``p50``/``value`` accepted as aliases) into a per-host base
    step-time model: the median of each host's samples. Hosts are the
    replay scenario's world; feed the result to
    ``FleetScenario.base_by_host``."""
    per_host: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            host = rec.get("host") or f"rank{rec.get('rank', '?')}"
            val = rec.get("step_time_s", rec.get("p50",
                                                 rec.get("value")))
            if val is None:
                continue
            per_host.setdefault(str(host), []).append(float(val))
    return {h: statistics.median(v) for h, v in sorted(per_host.items())}


def plan_from_flightrec(boxdir: str) -> Dict[str, Any]:
    """Ingest flight-recorder black boxes (``blackbox.rank<k>.json``,
    docs/podmon.md schema) into a FaultPlan-shaped dict: a
    ``stall_timeout`` box becomes a persistent straggler on its host
    (the watchdog latched a wedged collective — replayed as sustained
    slowness the engine must attribute), a ``peer_failure`` box
    becomes a preemption at its recorded step. Best-effort: boxes
    without a host label fall back to ``rank<k>``."""
    import glob
    import os

    faults: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(boxdir,
                                              "blackbox*.json"))):
        try:
            with open(path) as f:
                box = json.load(f)
        except (OSError, ValueError):
            continue
        host = box.get("host") or f"rank{box.get('rank', '?')}"
        trigger = box.get("trigger", "")
        if trigger == "stall_timeout":
            faults.append({"site": "straggler", "step": 1, "times": 0,
                           "host": host, "delay_s": 0.45})
        elif trigger == "peer_failure":
            faults.append({"site": "preempt",
                           "step": max(1, int(box.get("step", 0)) + 1),
                           "host": host})
    return {"seed": 0, "faults": faults}


def scenario_from_traces(name: str,
                         podmetrics: Optional[str] = None,
                         flightrec: Optional[str] = None,
                         **overrides: Any) -> FleetScenario:
    """Build a replay scenario from recorded telemetry: the pod-metrics
    dump fixes the world (one host per distinct label) and each host's
    base step time; the black boxes fix the fault schedule. Overrides
    go straight onto the scenario fields."""
    base_by_host = steptimes_from_podmetrics(podmetrics) \
        if podmetrics else {}
    plan = plan_from_flightrec(flightrec) if flightrec \
        else {"seed": 0, "faults": []}
    if flightrec and base_by_host:
        # A fault naming a host outside the metrics world would never
        # fire; keep only attributable faults.
        plan["faults"] = [f for f in plan["faults"]
                          if f.get("host") in base_by_host]
    host_names = sorted(base_by_host)
    data = {
        "name": name,
        "hosts": max(len(host_names), 1),
        "host_names": host_names,
        "base_by_host": base_by_host,
        "plan": plan,
    }
    data.update(overrides)
    return FleetScenario.from_dict(data)


# -- the scenario library -----------------------------------------------------

def _storm_policy() -> Dict[str, Any]:
    return {
        "tick_interval_s": 0.25, "publish_interval_s": 0.0,
        "window": 8, "straggler_ratio": 2.5, "straggler_patience": 2,
        "min_ranks": 3, "evict_ttl_s": 2.0,
        "evict_permanent_after": 2, "evict_cooldown_s": 0.5,
        "grow_cooldown_s": 0.5, "min_np": 4,
    }


def builtin_scenarios() -> Dict[str, FleetScenario]:
    """The banked scenario library (docs/fleetsim.md). Each entry is a
    regression test: its decision log is byte-identical across repeats
    and checked against ``results/fleetsim/<name>.json``."""
    return {
        # 4096 ranks: a persistent straggler rides through a 25%
        # preemption storm. Rank 42's host carries the full delay and
        # its dp-replica peers (ranks 40-43 of dp=1024,pp=2,tp=2)
        # stall collectively through the 1F1B schedule — the
        # role-aware engine must pin the conviction on the strictly
        # slowest source host, stay storm-churn-invariant (no grow for
        # returning reclaimed hosts), and re-solve the mesh through
        # the respec ladder at every capacity step.
        "preempt_storm_4k": FleetScenario(
            name="preempt_storm_4k", hosts=4096, hosts_per_rack=64,
            min_np=4, duration_s=12.0, parallel="dp=1024,pp=2,tp=2",
            policy=_storm_policy(),
            plan={"seed": 42, "faults": [
                {"site": "straggler", "step": 1, "times": 0,
                 "host": "h0042", "delay_s": 0.45},
            ] + [
                {"site": "straggler", "step": 1, "times": 0,
                 "host": host_name(r), "delay_s": 0.36}
                for r in (40, 41, 43)
            ]},
            events=[{"kind": "preempt_storm", "t": 3.0,
                     "duration_s": 2.0, "frac": 0.25}]),
        # Correlated rack failure: every host of rack 3 (16 of 256)
        # slows together. The engine must convict EXACTLY the failed
        # rack's hosts — one evict per tick, reshape-and-re-measure —
        # and nobody else.
        "rack_failure": FleetScenario(
            name="rack_failure", hosts=256, hosts_per_rack=16,
            min_np=8, duration_s=16.0,
            policy={
                "tick_interval_s": 0.25, "publish_interval_s": 0.0,
                "window": 8, "straggler_ratio": 2.5,
                "straggler_patience": 2, "min_ranks": 3,
                "evict_ttl_s": 120.0, "evict_permanent_after": 1,
                "evict_cooldown_s": 0.25, "grow_cooldown_s": 0.5,
            },
            events=[{"kind": "rack_fail", "t": 2.0, "rack": 3,
                     "delay_s": 0.5}]),
        # Slow burn: one host's step time ramps gradually. Patience
        # must hold fire through the early ramp and convict once the
        # ratio is durably crossed — exactly one eviction, late.
        "slow_burn": FleetScenario(
            name="slow_burn", hosts=64, hosts_per_rack=8, min_np=4,
            duration_s=20.0,
            policy={
                "tick_interval_s": 0.25, "publish_interval_s": 0.0,
                "window": 8, "straggler_ratio": 2.5,
                "straggler_patience": 3, "min_ranks": 3,
                "evict_ttl_s": 60.0, "evict_cooldown_s": 0.5,
                "grow_cooldown_s": 0.5,
            },
            events=[{"kind": "slow_burn", "t": 2.0, "host": "h0007",
                     "delay_s": 0.4, "ramp_s": 8.0}]),
        # Flapping host: h0005 drops out of every ~6th discovery poll
        # while h0002 is an honest persistent straggler. The flapper
        # is recovery churn — the decision log must name ONLY the
        # straggler.
        "flapping_host": FleetScenario(
            name="flapping_host", hosts=16, hosts_per_rack=8,
            min_np=4, duration_s=15.0,
            policy={
                "tick_interval_s": 0.25, "publish_interval_s": 0.0,
                "window": 8, "straggler_ratio": 2.5,
                "straggler_patience": 2, "min_ranks": 3,
                "evict_ttl_s": 60.0, "evict_cooldown_s": 0.5,
                "grow_cooldown_s": 0.5,
            },
            plan={"seed": 42, "faults": [
                {"site": "straggler", "step": 1, "times": 0,
                 "host": "h0002", "delay_s": 0.4},
            ] + [
                {"site": "discovery", "step": s, "times": 1,
                 "mode": "drop_host", "target": "h0005"}
                for s in (6, 12, 18, 24, 30, 36, 42, 48)
            ]}),
        # Diurnal traffic swing on the REAL serve stack: Poisson
        # arrivals crest at peak_rps and fall back. The SLO controller
        # must grow into the crest (queue depth) and drain in the
        # trough (low occupancy) — zero dropped requests throughout.
        "diurnal_serve": FleetScenario(
            name="diurnal_serve", kind="serve", hosts=6,
            requests=120, rate_rps=2.0, peak_rps=40.0, period_s=8.0,
            replicas=2,
            policy={
                "tick_interval_s": 0.1, "window": 16,
                "max_queue_depth": 6, "low_occupancy": 0.15,
                "min_replicas": 1, "max_replicas": 4,
                "grow_cooldown_s": 0.5, "shrink_cooldown_s": 1.5,
            }),
        # Sustained ~2x-capacity mixed-tenancy storm with overload
        # control armed: the brownout ladder must climb (decision-log
        # ``brownout`` lines), degradation must concentrate on the
        # throughput/batch tiers, every request must reach exactly one
        # typed terminal outcome (dropped == 0 means zero SILENT
        # losses), and the whole record replays byte-identically.
        "overload_storm": FleetScenario(
            name="overload_storm", kind="serve", hosts=4,
            requests=160, rate_rps=22.0, replicas=2,
            class_mix={"latency": 0.5, "throughput": 0.3,
                       "batch": 0.2},
            policy={
                "tick_interval_s": 0.1, "window": 16,
                "min_replicas": 2, "max_replicas": 2,
                "overload": True,
                "latency_deadline_s": 1.5,
                "throughput_deadline_s": 3.0,
                "brownout_enter_depth": 10,
                "brownout_exit_depth": 2,
                "brownout_enter_ticks": 2,
                "brownout_exit_ticks": 2,
                "brownout_clamp_tokens": 4,
            }),
    }


def run_scenario(scenario, seed: Optional[int] = None,
                 device="cuda", model=None) -> Dict[str, Any]:
    """Run one scenario (a :class:`FleetScenario`, a dict, or a
    builtin name) and return the bankable record: scenario identity,
    the decision log, and stats. ``seed`` overrides the scenario's.
    ``device`` is where a serve-kind scenario's GPT runs and ``model``
    that GPT (default: ``gpt_tiny`` with seeded weights); train-kind
    scenarios touch neither."""
    if isinstance(scenario, str):
        lib = builtin_scenarios()
        if scenario not in lib:
            raise ValueError(
                f"fleetsim: unknown scenario {scenario!r}; builtin: "
                f"{sorted(lib)}")
        scenario = lib[scenario]
    elif isinstance(scenario, dict):
        scenario = FleetScenario.from_dict(scenario)
    if seed is not None:
        scenario = dataclasses.replace(scenario, seed=int(seed))
        if scenario.plan:
            scenario.plan = dict(scenario.plan, seed=int(seed))
    if scenario.kind == "serve":
        return _serve_scenario_record(scenario, device, model)[0]
    report = simulate_fleet(scenario)
    return {
        "metric": "fleetsim",
        "scenario": scenario.name,
        "kind": scenario.kind,
        "seed": scenario.seed,
        "decisions": report.decisions,
        "injections": report.injections,
        "stats": report.stats,
    }


def serve_scenario_report(scenario, seed: Optional[int] = None,
                          device="cuda", model=None
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Run a serve-kind scenario and return ``(record, report)`` — the
    bankable record (same shape :func:`run_scenario` banks, so
    baselines never grow keys) plus the full ServeCluster report with
    the per-phase percentiles (ttft/tpot/queue-wait) the SLOPolicy
    sweep scores against."""
    if isinstance(scenario, str):
        lib = builtin_scenarios()
        if scenario not in lib:
            raise ValueError(
                f"fleetsim: unknown scenario {scenario!r}; builtin: "
                f"{sorted(lib)}")
        scenario = lib[scenario]
    elif isinstance(scenario, dict):
        scenario = FleetScenario.from_dict(scenario)
    if seed is not None:
        scenario = dataclasses.replace(scenario, seed=int(seed))
        if scenario.plan:
            scenario.plan = dict(scenario.plan, seed=int(seed))
    if scenario.kind != "serve":
        raise ValueError(
            f"fleetsim: serve_scenario_report needs a serve-kind "
            f"scenario, got kind={scenario.kind!r}")
    return _serve_scenario_record(scenario, device, model)


def _serve_scenario_record(scn: FleetScenario, device="cuda", model=None
                           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Serve-kind scenarios drive the real decode stack on ``device``:
    ``model``, else a tiny GPT whose weights are drawn from a seeded
    generator there; torch is imported here so train-kind twins stay
    import-light."""
    import torch

    from . import faults as faults_lib
    from .device import resolve_device
    from ..models.gpt import gpt_tiny
    from ..serve.controller import SLOPolicy
    from ..serve.engine import make_engine_factory
    from ..serve.traffic import poisson_trace

    dev = resolve_device(device)
    if model is None:
        with torch.device(dev):
            model = gpt_tiny()
        model.init_weights(torch.Generator(device=dev).manual_seed(0))
    factory = make_engine_factory(model, device=dev, slots=4, max_len=32,
                                  max_prompt_len=16)
    policy = SLOPolicy.from_dict(scn.policy)
    if scn.peak_rps > scn.rate_rps:
        trace = diurnal_trace(scn.seed, scn.requests, scn.rate_rps,
                              scn.peak_rps, scn.period_s)
    else:
        # The class mix is sorted for determinism (a scenario dict
        # round-trips through JSON); classed requests inherit the
        # policy's per-class default deadlines so OFF/ON arms measure
        # misses identically.
        mix = sorted(scn.class_mix.items()) or None
        deadlines = {name: getattr(policy, f"{name}_deadline_s", 0.0)
                     for name, _ in (mix or [])} or None
        trace = poisson_trace(seed=scn.seed, n_requests=scn.requests,
                              rate_rps=scn.rate_rps, class_mix=mix,
                              class_deadlines=deadlines)
    kill_inj = None
    if scn.plan.get("faults"):
        fp = faults_lib.FaultPlan.from_json(json.dumps(scn.plan))
        kill_inj = faults_lib.FaultInjector(fp, log_path="",
                                            rank="driver", host="sim")
    report, hm, _cluster = run_serve_world(
        factory=factory, policy=policy,
        trace=trace, hosts=[f"host{i}" for i in range(scn.hosts)],
        replicas=scn.replicas, roles=scn.roles or None,
        step_s=scn.step_s, kill_injector=kill_inj)
    stats = {
        "requests": len(trace.requests),
        "completed": report["completed"],
        "dropped": report["dropped"],
        "latency_p99_s": report["latency_p99_s"],
        "blacklisted": sorted(hm.blacklist_snapshot()),
    }
    if "shed" in report:
        # Overload-controlled worlds bank the terminal-outcome split
        # and the ladder watermark; historical scenarios (overload
        # off) keep their exact baseline shape.
        stats.update({
            "shed": report["shed"],
            "rejected": report["rejected"],
            "brownout_max_level": report["brownout_max_level"],
            "class_latency_p99_s": report["class_latency_p99_s"],
        })
    record = {
        "metric": "fleetsim",
        "scenario": scn.name,
        "kind": scn.kind,
        "seed": scn.seed,
        "decisions": report["decisions"],
        "injections": len(kill_inj.injections) if kill_inj else 0,
        "stats": stats,
    }
    return record, report
