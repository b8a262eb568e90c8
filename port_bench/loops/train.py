"""Training cells: a closed loop of the port's data-parallel training step.

One step is ``loss = loss_fn(model(batch))``, ``opt.zero_grad()``,
``loss.backward()``, ``opt.step()``: the port's model (bf16 compute over
fp32 parameters) under ``hvd.DistributedOptimizer(torch.optim.AdamW(...))``
with its defaults, fed by ``hvd.DeviceInfeed`` from a pool of host batches
made from the seed (``shard=True`` on more than one rank). A cell on more
than one chip starts its ranks through the port's own launcher
(``horovod_tpu_torch.runner.run``); each rank's ``hvd.init()`` takes its GPU
and NCCL.

Set-up builds the step once, drives it through its first
``COMPARED_STEPS`` steps (the window's own call and feed, on rows that all
differ) and records what ``correct.py`` compares; then the window runs the
same object for ``--seconds`` with no host read of a device value. The
plain reference (``reference/``) follows those first steps only after the
window, once the program is freed.

``--trace 1`` profiles ``profiled_steps`` steps (and one before them that
is left out) from 40% of the window, records CUDA events around each step's
forward and backward and its optimizer step, and reads the per-layer
metrics from them; its end-to-end numbers are not reported.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import statistics
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import card, correct, registry
from .. import trace as trace_lib
from .. import traffic as traffic_lib
from .. import weights as weights_lib
from ..reference.adamw import AdamW as PlainAdamW
from ..reference.layers import fp32_matmuls
from ..work import peaks as peaks_lib

#: What stands in the program's place: the port (``port``), the control
#: (the reference with fp8 operands), or the port with one planted fault.
PROGRAMS = ("port", "control", "unchanged", "half", "noexchange", "altered",
            "lr")
#: Host batches in a run's pool, fed round and round.
POOL_BATCHES = 8
INFEED_DEPTH = 2
#: Steps of set-up that ``correct.py`` compares with the reference.
COMPARED_STEPS = 3
#: ``torch.optim.AdamW`` under ``DistributedOptimizer``, and the reference's.
ADAMW = {"lr": 1e-4, "betas": (0.9, 0.999), "eps": 1e-8,
         "weight_decay": 0.01}
#: The ``lr`` fault's learning rate, as a share of ``ADAMW``'s.
LR_FAULT = 1.1
STOP_KEY = "port_bench/stop_at"
PROFILE_KEY = "port_bench/profile_at"
#: Steps between rank 0's decision to start profiling or to stop and the
#: step every rank acts at; ranks' hosts are never that far apart (each is
#: held to its device, the devices to each other by the collectives).
STOP_MARGIN = 4
PROFILE_AT = 0.4                 # of the window, when profiling starts


def launch(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every rank's result, in rank order."""
    chips = spec["cell"]["chips"]
    if chips == 1:
        return [rank_main(spec)]
    from horovod_tpu_torch.runner import run as run_ranks

    return run_ranks(rank_main, args=(spec,), np=chips)


def rank_main(spec: Dict[str, Any]) -> Dict[str, Any]:
    card.pin_caches()
    stages = [("rank", time.time())]
    import horovod_tpu_torch as hvd

    card.check_program(hvd)
    stages.append(("import", time.time()))
    ctx = hvd.init(device=None if spec["device"] == "cuda" else "cpu")
    stages.append(("init", time.time()))
    try:
        state = _State(spec, hvd, ctx, stages)
        out = {"rank": state.rank}
        if spec.get("calibrate"):
            out["calibration"] = [state.calibrate(seed, spec["programs"])
                                  for seed in spec["seeds"]]
        else:
            out.update(state.run(spec["seed"], spec["program"]))
        out["setup_stages"] = [(k, t - spec["t_start"]) for k, t in stages]
        out["forbidden"] = card.forbidden_modules()
        if state.dev.type == "cuda":
            out["card"] = torch.cuda.get_device_name(state.dev)
        return out
    finally:
        hvd.shutdown()


class _State:
    def __init__(self, spec, hvd, ctx, stages):
        self.spec, self.hvd, self.stages = spec, hvd, stages
        self.cfg, self.wl, self.tr = spec["config"], spec["workload"], \
            spec["traffic"]
        self.rank, self.size, self.dev = hvd.rank(), hvd.size(), ctx.device
        self.ref_mod = registry.family("reference", self.cfg["family"])
        self.prog_mod = registry.family("program", self.cfg["family"])
        self.widths = self.ref_mod.widths(self.cfg)
        self.specs = self.ref_mod.param_specs(self.cfg)
        self.names = [s[0] for s in self.specs]

    # -- inputs --------------------------------------------------------

    def pool(self, seed: int):
        host = traffic_lib.make_pool(self.tr, self.widths["vocab"], seed,
                                     POOL_BATCHES)
        pinned = self.dev.type == "cuda"
        batches = [{k: (torch.from_numpy(v).pin_memory() if pinned
                        else torch.from_numpy(v)) for k, v in b.items()}
                   for b in host]
        return host, batches

    def infeed(self, batches):
        return self.hvd.DeviceInfeed(itertools.cycle(batches),
                                     depth=INFEED_DEPTH,
                                     device=self.dev,
                                     shard=self.size > 1)

    def own_rows(self, host_batch):
        rows = traffic_lib.rows_of(host_batch, self.rank, self.size)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.dev)
                for k, v in rows.items()}

    # -- one run -------------------------------------------------------

    def run(self, seed: int, program: str) -> Dict[str, Any]:
        host, batches = self.pool(seed)
        self.stages.append(("pool", time.time()))
        prog = self._program(program, seed)
        self.stages.append(("program", time.time()))
        feed = self.infeed(batches)
        got = self._first_steps(prog, feed)
        self.stages.append(("first_steps", time.time()))
        if program == "port":
            window = self._window(prog, feed, host)
        else:
            window = None
        feed.close()
        prog.close()
        del prog, feed, batches
        _free(self.dev)
        ref = self._reference(host, seed)
        out = self._compare(got, ref, seed)
        if window is not None:
            profile = window.pop("profile", None)
            out["window"] = window
            if profile is not None:
                out["trace"] = self._read_trace(profile)
        return out

    def calibrate(self, seed: int, programs) -> Dict[str, Any]:
        """Readings of each program on one seed, against one reference:
        no window."""
        host, batches = self.pool(seed)
        ref = self._reference(host, seed)
        out = {"seed": seed, "reference_losses": ref["losses"]}
        for name in programs:
            if name == "noexchange" and self.size == 1:
                continue
            prog = self._program(name, seed)
            feed = self.infeed(batches)
            got = self._first_steps(prog, feed)
            feed.close()
            prog.close()
            del prog, feed
            _free(self.dev)
            one = self._compare(got, ref, seed)
            out[name] = one["values"]
            out[name + "_leaves"] = one["worst_leaves"]
            out[name + "_levels"] = one["levels"]
        return out

    def _program(self, name: str, seed: int):
        if name not in PROGRAMS:
            raise ValueError(f"unknown program {name!r}; one of {PROGRAMS}")
        if name == "control":
            return _Plain(self, seed, "fp8")
        return _Port(self, seed, name)

    def _first_steps(self, prog, feed) -> Dict[str, Any]:
        """The first steps through the window's call and feed: each step's
        loss, the first gradient's norms as the optimizer holds it, and
        the parameters after the last (copied to the host)."""
        losses, grads = [], None
        for i in range(COMPARED_STEPS):
            losses.append(_value(prog.step(next(feed))))
            if i == 0:
                grads = prog.first_grad_norms()
        params = prog.params()
        final = {n: params[n].detach().to("cpu", copy=True)
                 for n in self.names}
        return {"losses": [losses], "grad_norms": grads, "final": final}

    def _reference(self, host, seed: int) -> Dict[str, Any]:
        plain = _Plain(self, seed, "fp32")
        losses, grads, level = [], None, None
        for i in range(COMPARED_STEPS):
            losses.append(plain.step(self.own_rows(host[i])))
            if i == 0:
                grads = plain.first_grad_norms()
                level = plain.gradient_level()
        params = plain.params()
        final = {n: params[n].detach().to("cpu", copy=True)
                 for n in self.names}
        plain.close()
        del plain, params
        _free(self.dev)
        return {"losses": [losses], "grad_norms": grads, "final": final,
                "level": level}

    def _compare(self, got, ref, seed: int) -> Dict[str, Any]:
        """The readings of ``correct.py``: each side's change over the
        compared steps, per leaf, counted over the elements whose
        reference first gradient reaches each of ``correct.LEVELS``; the
        compared numbers count those at ``correct.QUIET``."""
        start = weights_lib.generate(self.specs, seed, self.dev)
        norms = {"prog": [], "ref": []}
        out_of = []
        ks = range(len(correct.LEVELS))
        with torch.no_grad():
            for n in self.names:
                level = ref["level"][n]
                out_of.append(torch.stack([(level <= k).sum() for k in ks]))
                for side, res in (("prog", got), ("ref", ref)):
                    d = (res["final"][n].to(self.dev) - start[n]).square()
                    norms[side].append(torch.stack(
                        [(d * (level > k)).sum() for k in ks]).sqrt())
        del start
        per = {side: torch.stack(v).T.tolist() for side, v in norms.items()}
        left_out = torch.stack(out_of).sum(0).tolist()
        levels = {}
        for k, q in enumerate(correct.LEVELS):
            prog = {"losses": got["losses"],
                    "grad_norms": got["grad_norms"],
                    "update_norms": dict(zip(self.names, per["prog"][k]))}
            plain = {"losses": ref["losses"],
                     "grad_norms": ref["grad_norms"],
                     "update_norms": dict(zip(self.names, per["ref"][k]))}
            values, leaves = correct.readings(prog, plain)
            levels[q] = (values, leaves, left_out[k])
        values, leaves, _ = levels[correct.QUIET]
        return {"values": values, "worst_leaves": leaves,
                "levels": {f"{q:g}": {"update_norm_gap": v["update_norm_gap"],
                                      "update_median_gap":
                                      v["update_median_gap"],
                                      "left_out": n}
                           for q, (v, _, n) in levels.items()}}

    # -- the window ----------------------------------------------------

    def _window(self, prog, feed, host) -> Dict[str, Any]:
        traced = bool(self.spec["trace"])
        cuda = self.dev.type == "cuda"
        seconds = float(self.spec["seconds"])
        store = None
        if self.size > 1:
            import torch.distributed as dist

            store = dist.distributed_c10d._get_default_store()
        _sync(self.dev)
        if self.size > 1:
            torch.distributed.barrier()
            _sync(self.dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        events: List[tuple] = []
        wait_s, n, stop = 0.0, 0, None
        prof, prof_left, marked = None, 0, []
        step_index = COMPARED_STEPS         # batches the set-up consumed
        t0_wall = time.time()
        self.stages.append(("window", t0_wall))
        t0 = time.perf_counter()
        profile_at = None
        while True:
            if traced and profile_at is None:
                profile_at = self._agree(
                    store, PROFILE_KEY, n,
                    time.perf_counter() - t0 >= PROFILE_AT * seconds)
            if profile_at is not None and n == profile_at:
                prof = _profiler(cuda)
                prof.start()
                prof_left = self.wl["profiled_steps"] + 1
            profiling = prof_left > 0
            ev = None
            if traced and cuda:
                ev = tuple(torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
                events.append(ev)
            with _range(profiling, trace_lib.STEP):
                w = time.perf_counter()
                with _range(profiling, "port_bench.infeed"):
                    batch = next(feed)
                wait_s += time.perf_counter() - w
                prog.step(batch, ev)
            if profiling:
                marked.append(step_index)
                prof_left -= 1
                if prof_left == 0:
                    prof.stop()
            n += 1
            step_index += 1
            elapsed = time.perf_counter() - t0
            profiling = prof_left > 0
            if stop is None:
                stop = self._agree(store, STOP_KEY, n, elapsed >= seconds
                                   and not profiling
                                   and (not traced or prof is not None))
            if stop is not None and n >= stop:
                break
        _sync(self.dev)
        elapsed = time.perf_counter() - t0
        out = {"steps": n, "elapsed_s": elapsed, "t0_wall": t0_wall,
               "infeed_wait_s": wait_s,
               "peak_bytes": (torch.cuda.max_memory_allocated(self.dev)
                              if cuda else None)}
        if prof_left > 0:
            prof.stop()
        if events:
            out["fwd_bwd_ms"] = sum(a.elapsed_time(b) for a, b, _ in events)
            out["opt_step_ms"] = sum(b.elapsed_time(c) for _, b, c in events)
            out["timed_steps"] = len(events)
        if prof is not None:
            out["profile"] = (prof, marked, host)
        if store is not None:
            torch.distributed.barrier()
        return out

    def _agree(self, store, key: str, n: int, due: bool):
        """The step every rank acts at, once rank 0 finds it ``due``
        after its ``n``-th step: ``n`` itself in a world of one, else
        ``n + STOP_MARGIN`` published through the process group's store
        and read by the other ranks. None until then."""
        if store is None:
            return n if due else None
        if self.rank == 0:
            if not due:
                return None
            at = n + STOP_MARGIN
            store.set(key, str(at))
            return at
        if not store.check([key]):
            return None
        at = int(store.get(key))
        if n > at:
            raise RuntimeError(f"rank {self.rank} ran {n} steps, past rank "
                               f"0's step {at} for {key}")
        return at

    def _read_trace(self, profile) -> Dict[str, Any]:
        prof, marked, host = profile
        os.makedirs(card.TRACE_DIR, exist_ok=True)
        path = os.path.join(card.TRACE_DIR, f"{self.spec['cell']['name']}"
                            f".rank{self.rank}.json.gz")
        prof.export_chrome_trace(path)
        summary = trace_lib.summarize(trace_lib.load(path))
        used = marked[len(marked) - summary["steps"]:] \
            if summary["steps"] else []
        s = self.tr["seq_len"]
        summary["profiled"] = []
        for j in used:
            rows = traffic_lib.rows_of(host[j % len(host)], self.rank,
                                       self.size)
            summary["profiled"].append({
                "rows": int(next(iter(rows.values())).shape[0]),
                "seq": s, "lengths": traffic_lib.lengths(rows),
                "targets": traffic_lib.targets(rows)})
        summary["path"] = os.path.relpath(path, card.ROOT)
        return summary


class _Port:
    """The system under test: the port's model under its
    ``DistributedOptimizer``; ``variant`` plants one fault for the check
    of ``correct`` (``unchanged``: the update is never applied; ``half``:
    the loss of the first half of the rows only; ``noexchange``: a bare
    AdamW on this rank's own gradients; ``altered``: the first leaf's
    gradient doubled where backward produces it; ``lr``: the learning
    rate ``LR_FAULT`` times the configured one)."""

    def __init__(self, st: _State, seed: int, variant: str):
        self.variant = variant
        self.model = st.prog_mod.build(st.cfg, st.dev, st.widths)
        start = weights_lib.generate(st.specs, seed, st.dev)
        with torch.no_grad():
            self.model.load_state_dict(start, strict=True)
        del start
        self.beta1 = ADAMW["betas"][0]
        o = dict(ADAMW, lr=ADAMW["lr"] * (LR_FAULT if variant == "lr"
                                          else 1.0))
        base = torch.optim.AdamW(self.model.parameters(), **o)
        self.opt = base if variant == "noexchange" else \
            st.hvd.DistributedOptimizer(
                base, named_parameters=self.model.named_parameters())
        self.loss_fn = st.prog_mod.loss
        if variant == "altered":
            next(self.model.parameters()).register_hook(lambda g: 2 * g)

    def step(self, batch, events=None):
        if self.variant == "half":
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        if events:
            events[0].record()
        loss = self.loss_fn(self.model, batch)
        self.opt.zero_grad()
        loss.backward()
        if events:
            events[1].record()
        if self.variant == "unchanged":
            self.opt.synchronize()
        else:
            self.opt.step()
        if events:
            events[2].record()
        return loss

    def first_grad_norms(self) -> Dict[str, float]:
        names, moments = [], []
        for name, p in self.model.named_parameters():
            m = self.opt.state.get(p, {}).get("exp_avg")
            names.append(name)
            moments.append(m.norm() if m is not None
                           else torch.full((), float("nan"),
                                           device=p.device))
        norms = torch.stack(moments).tolist()
        return {n: v / (1.0 - self.beta1) for n, v in zip(names, norms)}

    def params(self):
        return dict(self.model.named_parameters())

    def close(self):
        for h in getattr(self.opt, "_dist_hooks", ()):
            h.remove()
        self.opt = self.model = None


class _Plain:
    """The plain reference in ``precision`` (``fp32``: the reference;
    ``fp8``: the control in the program's place): fp32 parameters from the
    same seed, the rank's rows in blocks of ``reference_block_rows``, the
    gradients averaged over the ranks with ``torch.distributed``, plain
    AdamW."""

    def __init__(self, st: _State, seed: int, precision: str):
        self.st, self.precision = st, precision
        start = weights_lib.generate(st.specs, seed, st.dev)
        self.p = {n: t.clone().requires_grad_() for n, t in start.items()}
        del start
        self.beta1 = ADAMW["betas"][0]
        self.opt = PlainAdamW(self.p, **ADAMW)

    def step(self, batch, events=None) -> float:
        st = self.st
        count = st.ref_mod.loss_count(batch)
        rows = next(iter(batch.values())).shape[0]
        block = st.wl["reference_block_rows"]
        total = 0.0
        with fp32_matmuls():
            for i in range(0, rows, block):
                part = {k: v[i:i + block] for k, v in batch.items()}
                loss = st.ref_mod.loss_sum(self.p, part, st.cfg,
                                           self.precision)
                (loss / count).backward()
                total += float(loss.detach())
        grads = {n: t.grad for n, t in self.p.items()}
        if st.size > 1:
            flat = torch.cat([g.reshape(-1) for g in grads.values()])
            torch.distributed.all_reduce(flat)
            flat /= st.size
            at = 0
            for g in grads.values():
                g.copy_(flat[at:at + g.numel()].view_as(g))
                at += g.numel()
            del flat
        self.opt.step(grads)
        for t in self.p.values():
            t.grad = None
        return total / count

    def first_grad_norms(self) -> Dict[str, float]:
        names = list(self.p)
        norms = torch.stack([self.opt.first_moment(n).norm()
                             for n in names]).tolist()
        return {n: v / (1.0 - self.beta1) for n, v in zip(names, norms)}

    def gradient_level(self) -> Dict[str, torch.Tensor]:
        """Per element, on the device: how many of ``correct.LEVELS`` (each a
        share of the median leaf's RMS first gradient) the first gradient
        reaches. Elements under ``correct.QUIET``, such as a key's bias
        under softmax, move by round-off alone."""
        g = {n: self.opt.first_moment(n) / (1.0 - self.beta1)
             for n in self.p}
        rms = torch.stack([v.norm() / math.sqrt(v.numel())
                           for v in g.values()]).median()
        out = {}
        for n, v in g.items():
            a = v.abs()
            level = torch.zeros(a.shape, dtype=torch.uint8, device=a.device)
            for q in correct.LEVELS:
                level += a >= q * rms
            out[n] = level
        return out

    def params(self):
        return self.p

    def close(self):
        self.p = self.opt = None


def _value(loss) -> float:
    return float(loss.detach()) if isinstance(loss, torch.Tensor) \
        else float(loss)


def _range(on: bool, name: str):
    return torch.profiler.record_function(name) if on \
        else contextlib.nullcontext()


def _profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# -- the parent: one result from the ranks' results ----------------------

class Ctx:
    """What a metric reader sees: the ranks' results (``window``,
    ``trace``), the cell's files, the card's peaks and the run's start."""

    def __init__(self, spec, ranks, card_name):
        self.spec, self.ranks = spec, ranks
        self.cfg, self.workload = spec["config"], spec["workload"]
        self.traffic = spec["traffic"]
        self.chips = spec["cell"]["chips"]
        self.t_start = spec["t_start"]
        self.card = card_name
        self.peaks = peaks_lib.peaks(card_name) if card_name else None
        self.widths = registry.family("reference",
                                      self.cfg["family"]).widths(self.cfg)

    def windows(self):
        return [r["window"] for r in self.ranks if "window" in r]

    def traces(self):
        return [r["trace"] for r in self.ranks
                if r.get("trace") and r["trace"]["span"]]


def worst(values: List[Dict[str, float]]) -> Dict[str, float]:
    out = {}
    for v in values:
        for k, x in v.items():
            if k not in out or not x <= out[k]:
                out[k] = x
    return out


def report(spec, ranks, metric_entries) -> Dict[str, Any]:
    card_name = ranks[0].get("card")
    ctx = Ctx(spec, ranks, card_name)
    values = worst([r["values"] for r in ranks])
    ok, checks = correct.judge(values, spec["workload"]["limits"])
    metrics = {}
    notes = [f"worst leaves (rank 0): {ranks[0]['worst_leaves']}",
             "change by level (worst over ranks): " + json.dumps(
                 {q: worst([r["levels"][q] for r in ranks])
                  for q in ranks[0]["levels"]}),
             "setup stages (s from start; latest rank): " + ", ".join(
                 f"{k} {max(dict(r['setup_stages'])[k] for r in ranks):.3f}"
                 for k, _ in ranks[0]["setup_stages"])]
    for m in metric_entries:
        got = registry.metric_reader(m["name"])(ctx)
        if isinstance(got, tuple):
            got, note = got
            notes.append(f"{m['name']}: {note}")
        if got is None:
            continue
        metrics[m["name"]] = {"value": got, "unit": m["unit"]}
    windows = ctx.windows()
    device = {"platform": "gpu" if card_name else "cpu",
              "kind": card_name or "cpu", "count": ctx.chips,
              "memory_peak_bytes": max((w["peak_bytes"] or 0)
                                       for w in windows) if windows else 0}
    result = {"correct": ok,
              "attempted": windows[0]["steps"] if windows else 0,
              "failed": 0, "metrics": metrics, "device": device}
    traces = ctx.traces()
    if spec["trace"] and traces:
        device["busy_s"] = statistics.fmean(
            trace_lib.busy(t) * 1e-6 for t in traces)
        device["window_s"] = statistics.fmean(
            (t["span"][1] - t["span"][0]) * 1e-6 for t in traces)
        first = traces[0]
        result["breakdown"] = {
            "device_ops": [[name[:160], us * 1e-6] for name, us in
                           trace_lib.top((d[0], d[2] - d[1])
                                         for d in first["device"])],
            "idle_gaps": [[name[:160], us * 1e-6] for name, us in
                          trace_lib.top(first["gaps"])]}
        notes.append("trace files: " + ", ".join(t["path"] for t in traces))
    result["checks"] = checks
    return {"result": result, "notes": notes,
            "forbidden": sorted({m for r in ranks for m in r["forbidden"]})}
