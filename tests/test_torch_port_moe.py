"""The port's expert parallelism against the JAX package's: top-2 gating
(dispatch, combine, aux loss, demanded load; ties and overflow),
``moe_layer`` on flat ep worlds of 2 and 4 (the wires, the mesh route,
capacity chunking, the int8 straight-through gradient, the stats, router
noise), the ``moe_skew`` chaos site, GPT-MoE (forward, aux, gradients,
the training trajectory against the dense model) and a pp x ep pipeline
of GPT-MoE.

* Gloo ranks on the CPU, each a process running this file with
  ``--moe-worker RANK OUT PARAMS.npz``: a world made with
  ``init(parallel="dp=2,ep=2")`` (its ep axis is a flat ep world of 2,
  the whole world — ``build_mesh({"ep": 4})`` — one of 4, and the 2x2
  mesh the route ``"ep:none,dp:none"`` runs over), then, in the same
  processes, ``"dp=1,pp=2,ep=2"``. The worlds run once per test
  session (``session_world``: one xdist worker runs them, the others
  read their output).
* The oracle is the JAX function under ``shard_map(check_vma=False)`` on
  an ``("ep",)`` (or ``("pp", "ep")``) mesh of the conftest's CPU
  devices, rank r on device r, fed the same numpy inputs; router noise
  is off in every parity case (torch's draws differ from jax.random's).
* Tolerances: exact wire and GPT-MoE values and gradients against JAX to
  ``TOL`` (fp32 rtol and atol 2e-5: the port combines a token's two
  routes by indexing where JAX contracts dense one-hots, the same
  products and sum up to fp32 rounding); gating dispatch, kept slots,
  demand and drop counts exactly, combine weights and aux to ``TOL``;
  chunked capacity bitwise against unchunked; the route bitwise against
  the flat axis; lossy wires within the JAX test's per-hop bounds; the
  int8 straight-through gradient within 20% (+1e-3) of the exact one;
  GPT-MoE's loss within 15% of the dense model's at every step after
  the first (the JAX test's documented bound).

JAX is imported only inside the ``J`` fixture: the worker processes
import this file and must not pay for it.
"""

import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import faults as faults_lib
from horovod_tpu_torch.common import metrics as metrics_lib
from horovod_tpu_torch.models import convert, gpt
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.parallel import moe
from horovod_tpu_torch.parallel import pipeline as pl
from test_torch_port_worlds import run_ranks, session_world

TOL = 2e-5
STE_RTOL = 0.2
TRAJ_RTOL = 0.15
E = 8
MOE_KW = dict(num_layers=2, hidden=32, num_heads=4, mlp_dim=64,
              vocab_size=64, dtype=torch.float32)
TRAJ_STEPS = 8


def _data():
    g = np.random.default_rng(4242)

    def normal(*shape, scale=1.0):
        return (g.standard_normal(shape) * scale).astype(np.float32)

    skew = np.zeros((4, 8), np.float32)
    skew[:, 0] = 5.0
    return {"x": normal(4, 32, 8), "gw": normal(8, 8),
            "xo": normal(4, 16, 4), "gw_skew": skew,
            "xn": normal(4, 512, 16), "gwn": normal(16, 8, scale=0.02),
            "toks": g.integers(0, 64, (8, 16)).astype(np.int64),
            "traj": g.integers(0, 64, (8, 17)).astype(np.int64),
            "ptoks": g.integers(0, 64, (4, 16)).astype(np.int64),
            "ptgts": g.integers(0, 64, (4, 16)).astype(np.int64)}


def _moe_kw_jax(J):
    kw = dict(MOE_KW)
    kw["dtype"] = J.jnp.float32
    return kw


def _jax_moe_params(J, seed=0):
    """GPT-MoE params from the JAX model (numpy leaves; the local layer
    inits the same tree as the ep one)."""
    m = J.gpt.gpt_tiny(moe_experts=E, moe_capacity_factor=2.0,
                       **_moe_kw_jax(J))
    p = m.init(J.jax.random.PRNGKey(seed), np.zeros((2, 16), np.int32))
    return J.jax.tree.map(np.asarray, p)["params"]


def _jax_dense_params(J, seed=0):
    m = J.gpt.gpt_tiny(**_moe_kw_jax(J))
    p = m.init(J.jax.random.PRNGKey(seed), np.zeros((2, 16), np.int32))
    return J.jax.tree.map(np.asarray, p)["params"]


# -- the rank worker ----------------------------------------------------------

def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _tanh_experts(axis=None, route=None, n=1):
    base = moe.ep_index(axis, route) * (E // n)

    def expert_fn(le, toks):
        return torch.tanh(toks * float(base + le + 1))

    return expert_fn


def _moe_cases(out, rank):
    d = _data()
    ep2 = hvd.parallel_mesh()["ep"]
    world = mesh_lib.build_mesh({"ep": 4}, rank, 4)["ep"]
    x = _t(d["x"][rank])
    gw = _t(d["gw"])
    for tag, ax in (("n2", ep2), ("n4", world)):
        f = _tanh_experts(ax, n=ax.size)
        y, aux = moe.moe_layer(x, gw, f, E, capacity_factor=2.0,
                               axis_name=ax)
        out[f"{tag}/y"], out[f"{tag}/aux"] = y, aux
    f4 = _tanh_experts(world, n=4)
    for wire in ("bf16", "int8"):
        out[f"n4/{wire}"] = moe.moe_layer(x, gw, f4, E, capacity_factor=2.0,
                                          axis_name=world, wire=wire)[0]
    for k in (2, 4, 7):
        out[f"n4/chunks{k}"] = moe.moe_layer(
            x, gw, f4, E, capacity_factor=2.0, axis_name=world,
            overlap_chunks=k)[0]
    route = "ep:none,dp:none"
    out["route/y"] = moe.moe_layer(
        x, gw, _tanh_experts(route=route, n=4), E, capacity_factor=2.0,
        axis_name=None, route=route)[0]
    # The int8 straight-through gradient against the exact wire's.
    for wire in ("none", "int8"):
        scale = torch.tensor(1.5, requires_grad=True)
        y, _ = moe.moe_layer(x, gw, lambda le, t: torch.tanh(t * scale), E,
                             capacity_factor=2.0, axis_name=world,
                             wire=wire, key=(2,) if wire == "int8" else None)
        (y ** 2).mean().backward()
        out[f"ste/{wire}"] = C.allreduce(scale.grad.reshape(1), C.Average)
    # Overflow: every token prefers expert 0.
    for tag, chunks in (("a", 1), ("b", 1), ("c", 2)):
        out[f"over/{tag}"] = moe.moe_layer(
            _t(d["xo"][rank]), _t(d["gw_skew"]), lambda le, t: t, E,
            capacity_factor=0.5, axis_name=world, overlap_chunks=chunks,
            return_stats=True)[2]["dropped_tokens"]
    # Router noise from a generator (not jax.random): at 1.0 the untrained
    # router stops overflowing.
    for noise in (0.0, 1.0):
        out[f"noise/{noise}"] = moe.moe_layer(
            _t(d["xn"][rank]), _t(d["gwn"]), lambda le, t: t, E,
            capacity_factor=1.25, axis_name=world, router_noise_std=noise,
            generator=torch.Generator().manual_seed(9 + rank),
            return_stats=True)[2]["dropped_frac"]
    return world


def _gpt_moe_cases(out, rank, world, params, dense):
    """GPT-MoE over the flat ep world of 4: forward, aux, per-rank raw
    gradients of CE + 0.01 aux; then the training trajectories."""
    d = _data()
    toks = _t(d["toks"][2 * rank:2 * rank + 2])
    m = gpt.gpt_tiny(moe_experts=E, moe_axis=world, moe_capacity_factor=2.0,
                     **MOE_KW)
    m.load_state_dict(convert.gpt_params_from_jax(params))
    # The forward runs no collective for the stats: moe_stats() sums them.
    calls, allreduce = [], C.allreduce
    C.allreduce = lambda *a, **k: calls.append(1) or allreduce(*a, **k)
    try:
        logits = m(toks)
    finally:
        C.allreduce = allreduce
    out["gm/forward_allreduces"] = np.array(len(calls))
    aux = m.moe_aux()
    loss = gpt.next_token_loss(logits, toks) + 0.01 * aux
    loss.backward()
    out["gm/logits"], out["gm/aux"] = logits, aux
    for n, p in m.named_parameters():
        out[f"gm/g/{n}"] = p.grad
    st = moe.record_moe_stats(m.moe_stats()[0])
    out["gm/stats_load"] = np.array(st["expert_load"])
    traj = _t(d["traj"][2 * rank:2 * rank + 2])
    for kind in ("dense", "moe"):
        if kind == "moe":
            mm = gpt.gpt_tiny(moe_experts=E, moe_axis=world,
                              moe_capacity_factor=4.0, **MOE_KW)
            mm.load_state_dict(convert.gpt_params_from_jax(params))
        else:
            mm = gpt.gpt_tiny(**MOE_KW)
            mm.load_state_dict(convert.gpt_params_from_jax(dense))
        opt = hvd.DistributedOptimizer(torch.optim.Adam(mm.parameters(),
                                                        lr=3e-3))
        losses = []
        for _ in range(TRAJ_STEPS):
            opt.zero_grad()
            ce = gpt.next_token_loss(mm(traj[:, :-1]), traj[:, 1:])
            total = ce + 0.01 * mm.moe_aux() if kind == "moe" else ce
            total.backward()
            opt.step()
            losses.append(float(C.allreduce(ce.detach().reshape(1),
                                            C.Average)))
        for h in opt._dist_hooks:
            h.remove()
        out[f"traj/{kind}"] = np.array(losses)


def _pp_ep_cases(out, rank, params):
    """dp=1 x pp=2 x ep=2: a GPT-MoE stage (one layer) on each pp rank,
    the experts dispatched over ep; the 1F1B loss and gradients, then
    two steps under DistributedOptimizer(parallel=) with the counters."""
    spec = "dp=1,pp=2,ep=2"
    hvd.init(device="cpu", parallel=spec)
    pspec = hvd.parallel_spec()
    s = pspec.coords(rank)["pp"]
    d = _data()
    x, y = _t(d["ptoks"]), _t(d["ptgts"])
    m = gpt.gpt_tiny(**dict(MOE_KW, num_layers=1), moe_experts=E,
                     moe_axis="ep", moe_capacity_factor=2.0)
    stages, shared = gpt.stack_stage_params(
        convert.gpt_params_from_jax(params), 2)
    m.load_state_dict({**stages[s], **shared})
    sf, pf, lf = gpt.pipeline_fns(m)
    vg = pl.pipeline_accumulate_gradients(sf, lf, accum_steps=2,
                                          axis_name="pp", pre_fn=pf)
    tree = {"stages": gpt.stage_params(m), "shared": gpt.shared_params(m)}
    loss, g = vg(tree, x, y)
    out["ppep/loss"] = loss
    for name, v in list(g["stages"].items()) + list(g["shared"].items()):
        out[f"ppep/g/{name}"] = v
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                   parallel=spec)
    snap = metrics_lib.snapshot if metrics_lib.enabled() else None
    before = snap() if snap else {}
    losses = []
    for _ in range(2):
        opt.zero_grad()
        loss, _ = vg(tree, x, y)
        opt.step()
        losses.append(float(loss))
    out["ppep/train"] = np.array(losses)
    if snap:
        after = snap()
        for fam in ("hvd_tpu_alltoall_bytes_total",
                    "hvd_tpu_pipeline_activation_bytes_total",
                    "hvd_tpu_allreduce_bytes_total"):
            old = {tuple(sorted(v["labels"].items())): v["value"]
                   for v in before.get(fam, {}).get("samples", [])}
            grew = sorted({v["labels"]["axis"]
                           for v in after.get(fam, {}).get("samples", [])
                           if v["value"] > old.get(tuple(sorted(
                               v["labels"].items())), 0.0)})
            out[f"ppep/axes/{fam}"] = np.array(grew)
    for h in opt._dist_hooks:
        h.remove()
    hvd.shutdown()


def _moe_worker(rank: int, out_path: str, params_path: str) -> None:
    out = {}
    loaded = np.load(params_path, allow_pickle=True)
    params, dense = loaded["params"].item(), loaded["dense"].item()
    hvd.init(device="cpu", parallel="dp=2,ep=2")
    world = _moe_cases(out, rank)
    _gpt_moe_cases(out, rank, world, params, dense)
    hvd.shutdown()
    _pp_ep_cases(out, rank, params)
    np.savez(out_path, **{k: v.detach().numpy()
                          if isinstance(v, torch.Tensor) else v
                          for k, v in out.items()})


_WORLD = []


@pytest.fixture()
def world(tmp_path_factory, J):
    def run(out):
        pfile = out / "params.npz"
        np.savez(pfile, params=np.array(_jax_moe_params(J), dtype=object),
                 dense=np.array(_jax_dense_params(J), dtype=object))
        run_ranks(__file__, lambda r: ("--moe-worker", r,
                                       out / f"rank{r}.npz", pfile), 4,
                  timeout=300)

    if not _WORLD:
        out = session_world(tmp_path_factory, "moe", run)
        _WORLD.extend(dict(np.load(out / f"rank{r}.npz"))
                      for r in range(4))
    return _WORLD


# -- the JAX oracle -----------------------------------------------------------

@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.common import faults as jfaults
    from horovod_tpu.models import gpt as jgpt
    from horovod_tpu.parallel import moe as jmoe
    from horovod_tpu.parallel import pipeline as jpl

    return types.SimpleNamespace(jax=jax, jnp=jnp, gpt=jgpt, moe=jmoe,
                                 pl=jpl, faults=jfaults)


def _mesh(J, n, names=("ep",), dims=None):
    from jax.sharding import Mesh

    devs = np.array(J.jax.devices()[:n])
    return Mesh(devs.reshape(dims) if dims else devs, names)


def _jax_moe(J, x, gw, n, **kw):
    """JAX ``moe_layer`` on an ep mesh of n devices, rank r on x[r]."""
    from jax.sharding import PartitionSpec as P

    jnp = J.jnp

    def expert_fn(le, toks):
        ge = J.moe.ep_index("ep") * (E // n) + le
        return jnp.tanh(toks * (ge + 1).astype(toks.dtype))

    f = J.jax.jit(J.jax.shard_map(
        lambda xx: J.jax.tree.map(lambda a: a[None], moe_fn(xx[0])),
        mesh=_mesh(J, n), in_specs=P("ep"), out_specs=P("ep"),
        check_vma=False))

    def moe_fn(xx):
        return J.moe.moe_layer(xx, jnp.asarray(gw), expert_fn, E,
                               capacity_factor=2.0, axis_name="ep", **kw)

    return J.jax.tree.map(np.asarray, f(jnp.asarray(x)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _block_bound(x, r=1.0):
    return r * np.abs(np.asarray(x, np.float64)).max() / 127.0 + 1e-6


# -- gating (one process) -----------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "overflow"])
def test_top2_gating_matches_jax(J, case):
    """Dispatch, combine, aux and demanded load of the port's gating
    against ``_top2_gating_with_demand`` on the same logits: random,
    with tied maxima (the first index wins in both), and overflowing a
    small capacity (the second choice queues behind every first)."""
    g = np.random.default_rng(7)
    logits = g.standard_normal((64, 8)).astype(np.float32)
    cap = 20
    if case == "ties":
        logits = np.round(logits)                 # many exact ties
        logits[:8] = 1.0                          # whole rows tied
    if case == "overflow":
        logits[:, 3] += 4.0
        cap = 5
    got = moe._top2_gating_with_demand(torch.from_numpy(logits), cap)
    want = J.moe._top2_gating_with_demand(J.jnp.asarray(logits), cap)
    dg, cg, ag, dmg = (t.numpy() for t in got)
    dw, cw, aw, dmw = (np.asarray(t) for t in want)
    assert np.array_equal(dg, dw)
    assert np.array_equal(dmg, dmw)
    _close(cg, cw)
    _close(ag, aw)
    if case == "overflow":
        assert dg.sum() < 2 * 64
    d3, c3, a3 = moe.top2_gating(torch.from_numpy(logits), cap)
    assert torch.equal(d3, got[0]) and torch.equal(c3, got[1])


def test_capacity_bounds_and_sizes_match_jax(J):
    for cap, k in ((8, 1), (8, 3), (7, 7), (5, 9), (16, 4)):
        assert moe._capacity_bounds(cap, k) == J.moe._capacity_bounds(cap, k)


def test_record_moe_stats_sets_gauges():
    rec = moe.record_moe_stats({"dropped_tokens": torch.tensor(7.0),
                                "dropped_frac": torch.tensor(0.25),
                                "expert_load": torch.arange(4.0)})
    assert rec == {"dropped_tokens": 7.0, "dropped_frac": 0.25,
                   "expert_load": [0.0, 1.0, 2.0, 3.0]}
    if metrics_lib.enabled():
        snap = metrics_lib.snapshot()
        drop = snap["hvd_tpu_moe_dropped_tokens"]["samples"]
        load = snap["hvd_tpu_moe_expert_load"]["samples"]
        assert drop and drop[0]["value"] == 7.0
        assert {s["labels"]["expert"] for s in load} >= {"0", "1", "2", "3"}


def test_moe_defaults_follow_the_config(monkeypatch):
    """``wire``, ``overlap_chunks`` and ``capacity_factor`` left None take
    ``init()``'s Config when the world is up, else the HVD_TPU_MOE_*
    knobs, else the JAX defaults; ``moe_layer`` and ``MoeMlp`` read
    them."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.config import Config

    for k in ("WIRE", "OVERLAP_CHUNKS", "CAPACITY_FACTOR"):
        monkeypatch.delenv(f"HVD_TPU_MOE_{k}", raising=False)
    monkeypatch.setattr(basics, "is_initialized", lambda: False)
    assert moe.moe_defaults() == ("none", 1, 1.25)
    assert moe.moe_defaults("bf16", 3, 2.0) == ("bf16", 3, 2.0)
    monkeypatch.setenv("HVD_TPU_MOE_WIRE", "int8")
    monkeypatch.setenv("HVD_TPU_MOE_OVERLAP_CHUNKS", "2")
    monkeypatch.setenv("HVD_TPU_MOE_CAPACITY_FACTOR", "0.5")
    assert moe.moe_defaults() == ("int8", 2, 0.5)
    assert moe.moe_defaults(wire="none") == ("none", 2, 0.5)

    g = torch.Generator().manual_seed(5)
    x = torch.randn(32, 16, generator=g)
    gw = torch.randn(16, E, generator=g)
    y_env, _, st_env = moe.moe_layer(x, gw, lambda le, t: t * (le + 1), E,
                                     axis_name=None, return_stats=True)
    y_exp, _, st_exp = moe.moe_layer(x, gw, lambda le, t: t * (le + 1), E,
                                     capacity_factor=0.5, overlap_chunks=2,
                                     axis_name=None, return_stats=True)
    assert torch.equal(y_env, y_exp)
    assert float(st_env["dropped_tokens"]) == float(
        st_exp["dropped_tokens"]) > 0
    mlps = [gpt.MoeMlp(16, E, 32, dtype=torch.float32, **kw)
            for kw in ({}, {"capacity_factor": 0.5, "overlap_chunks": 2},
                       {"capacity_factor": 1.25, "overlap_chunks": 1})]
    for mlp in mlps:
        mlp.load_state_dict(mlps[0].state_dict())
        with torch.no_grad():
            for w in mlp.parameters():
                w.copy_(torch.randn(w.shape,
                                    generator=torch.Generator().manual_seed(
                                        w.numel())))
    xb = x.reshape(2, 16, 16)
    ys = [mlp(xb) for mlp in mlps]
    assert torch.equal(ys[0], ys[1]) and not torch.equal(ys[0], ys[2])

    cfg = Config(moe_wire="bf16", moe_overlap_chunks=3,
                 moe_capacity_factor=2.0)
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "context",
                        lambda: types.SimpleNamespace(config=cfg))
    assert moe.moe_defaults() == ("bf16", 3, 2.0)
    assert moe.moe_defaults(capacity_factor=1.0) == ("bf16", 3, 1.0)


def test_chaos_skew_gate_fires_from_plan(J):
    """Mirrors ``test_chaos_skew_gate_fires_from_plan`` and
    ``test_faults_moe_skew_site_registered``: passthrough without a plan,
    the second hit biases column 3 by 9, as the JAX gate does."""
    gw = torch.zeros((4, 8))
    assert moe.chaos_skew_gate(gw) is gw
    assert "moe_skew" in faults_lib.SITES
    plan = ('{"seed": 1, "faults": [{"site": "moe_skew", "step": 2, '
            '"scale": 9.0, "target": "3"}]}')
    outs = {}
    for name, lib, gate in (("port", faults_lib, moe.chaos_skew_gate),
                            ("jax", J.faults, J.moe.chaos_skew_gate)):
        lib.install(lib.FaultPlan.from_json(plan))
        try:
            first = gate(gw if name == "port" else J.jnp.zeros((4, 8)))
            second = gate(gw if name == "port" else J.jnp.zeros((4, 8)))
            outs[name] = (np.asarray(first), np.asarray(second))
        finally:
            lib.uninstall()
    assert np.array_equal(outs["port"][0], outs["jax"][0])
    assert np.array_equal(outs["port"][1], outs["jax"][1])
    assert outs["port"][1][:, 3] == pytest.approx(9.0)
    inj = faults_lib.FaultInjector(faults_lib.FaultPlan.from_json(
        '[{"site": "moe_skew", "step": 1}]'))
    faults_lib._injector = inj
    try:
        assert faults_lib.maybe_moe_skew() is not None
        assert faults_lib.maybe_moe_skew() is None
    finally:
        faults_lib._injector = None


# -- moe_layer on the worlds --------------------------------------------------

def test_moe_layer_none_matches_jax_n2_and_n4(world, J):
    d = _data()
    want4 = _jax_moe(J, d["x"], d["gw"], 4)
    want2 = [_jax_moe(J, d["x"][2 * g:2 * g + 2], d["gw"], 2)
             for g in range(2)]
    for r, res in enumerate(world):
        _close(res["n4/y"], want4[0][r])
        _close(res["n4/aux"], want4[1][r])
        _close(res["n2/y"], want2[r // 2][0][r % 2])


def test_moe_wire_tolerance(world):
    """Mirrors ``test_moe_wire_tolerance``: two lossy hops, each within
    its per-hop bound (the expert is Lipschitz <= 8, its output
    tanh-bounded)."""
    d = _data()
    for r, res in enumerate(world):
        base = res["n4/y"]
        bf = 2.0 * (8.0 * np.abs(d["x"]).max() + 1.0) * 2.0 ** -8 + 1e-5
        assert np.abs(res["n4/bf16"] - base).max() <= bf
        i8 = 2.0 * (8.0 * _block_bound(d["x"], 0.5)
                    + _block_bound(np.ones(1), 0.5))
        assert np.abs(res["n4/int8"] - base).max() <= i8


def test_moe_overlap_chunking_is_exact(world):
    for res in world:
        for k in (2, 4, 7):
            assert np.array_equal(res[f"n4/chunks{k}"], res["n4/y"])


def test_moe_route_matches_flat_axis(world):
    """Mirrors ``test_moe_route_matches_flat_axis``: the mesh-routed
    dispatch over (ep fast, dp slow) equals the flat world axis."""
    for res in world:
        assert np.array_equal(res["route/y"], res["n4/y"])


def test_int8_dispatch_gradients_flow_ste(world, J):
    """Mirrors ``test_int8_dispatch_gradients_flow_ste``: the exact-wire
    gradient against JAX, and the int8 wire's within 20% of it."""
    from jax.sharding import PartitionSpec as P

    d = _data()
    jnp = J.jnp

    def loss(scale, xx):
        y, _ = J.moe.moe_layer(xx, jnp.asarray(d["gw"]),
                               lambda le, t: jnp.tanh(t * scale), E,
                               capacity_factor=2.0, axis_name="ep")
        return jnp.mean(y ** 2)

    f = J.jax.jit(J.jax.shard_map(
        lambda s, xx: J.jax.lax.pmean(J.jax.grad(loss)(s, xx[0]), "ep"),
        mesh=_mesh(J, 4), in_specs=(P(), P("ep")), out_specs=P(),
        check_vma=False))
    g_jax = float(f(jnp.asarray(1.5), jnp.asarray(d["x"])))
    for res in world:
        g_exact, g_int8 = float(res["ste/none"][0]), float(res["ste/int8"][0])
        _close(g_exact, g_jax)
        assert abs(g_exact) > 1e-3
        assert abs(g_int8 - g_exact) <= STE_RTOL * abs(g_exact) + 1e-3


def test_moe_capacity_overflow_deterministic(world, J):
    """Same inputs, same drops: run to run and across chunk depths, and
    the same count as the JAX layer's."""
    from jax.sharding import PartitionSpec as P

    d = _data()
    f = J.jax.jit(J.jax.shard_map(
        lambda xx: J.moe.moe_layer(
            xx[0], J.jnp.asarray(d["gw_skew"]), lambda le, t: t, E,
            capacity_factor=0.5, axis_name="ep",
            return_stats=True)[2]["dropped_tokens"],
        mesh=_mesh(J, 4), in_specs=P("ep"), out_specs=P(),
        check_vma=False))
    want = float(f(J.jnp.asarray(d["xo"])))
    for res in world:
        a, b, c = (float(res[f"over/{t}"]) for t in "abc")
        assert a > 0 and a == b == c == want


def test_moe_router_noise_balances_untrained_router(world):
    for res in world:
        assert float(res["noise/1.0"]) <= 0.01
        assert float(res["noise/1.0"]) <= float(res["noise/0.0"])


# -- GPT-MoE ------------------------------------------------------------------

def test_gpt_moe_forward_and_intermediates(world, J):
    """Mirrors ``test_gpt_moe_forward_and_intermediates`` over a flat ep
    world of 4 (two token rows a rank): logits, the summed aux loss and
    every raw per-rank gradient of CE + 0.01 aux against the JAX model
    under shard_map; the expert bank keeps its full replicated shape."""
    from jax.sharding import PartitionSpec as P

    params = _jax_moe_params(J)
    d = _data()
    model = J.gpt.gpt_tiny(moe_experts=E, moe_axis="ep",
                           moe_capacity_factor=2.0, **_moe_kw_jax(J))
    jnp = J.jnp

    def fwd(p, tb):
        def loss(pp):
            logits, mods = model.apply({"params": pp}, tb,
                                       mutable=["intermediates"])
            flat = J.jax.tree_util.tree_flatten_with_path(
                mods["intermediates"])[0]
            aux = sum(leaf for path, leaf in flat
                      if "moe_aux" in J.jax.tree_util.keystr(path))
            lp = J.jax.nn.log_softmax(logits)
            ce = -jnp.mean(jnp.take_along_axis(lp, tb[..., None],
                                               axis=-1))
            return ce + 0.01 * aux, (logits, aux)

        (_, (logits, aux)), g = J.jax.value_and_grad(
            loss, has_aux=True)(p)
        return logits, aux[None], J.jax.tree.map(lambda a: a[None], g)

    f = J.jax.jit(J.jax.shard_map(fwd, mesh=_mesh(J, 4),
                                  in_specs=(P(), P("ep")),
                                  out_specs=(P("ep"), P("ep"), P("ep")),
                                  check_vma=False))
    logits, aux, g = f(params, jnp.asarray(d["toks"]))
    logits, aux = np.asarray(logits), np.asarray(aux)
    g = J.jax.tree.map(np.asarray, g)
    assert params["layer0"]["moe"]["w_in"].shape == (E, 32, 64)
    for r, res in enumerate(world):
        _close(res["gm/logits"], logits[2 * r:2 * r + 2])
        _close(res["gm/aux"], aux[r])
        want = convert.gpt_params_from_jax(
            J.jax.tree.map(lambda a: a[r], g))
        for name, v in want.items():
            _close(res[f"gm/g/{name}"], v.numpy())
        assert res["gm/stats_load"].shape == (E,)
        assert res["gm/stats_load"].sum() == 2 * 4 * 2 * 16
        assert int(res["gm/forward_allreduces"]) == 0


def test_gpt_moe_loss_trajectory_matches_dense(world):
    """Mirrors ``test_gpt_moe_loss_trajectory_matches_dense``: it trains,
    and each step's loss is within 15% of the dense model's after the
    first."""
    for res in world:
        dense, moe_l = res["traj/dense"], res["traj/moe"]
        assert moe_l[-1] < moe_l[0]
        for dl, ml in list(zip(dense, moe_l))[1:]:
            assert abs(ml - dl) / dl <= TRAJ_RTOL, (dense, moe_l)


def test_pp_ep_gpt_moe_matches_jax_hybrid(world, J):
    """dp=1 x pp=2 x ep=2: GPT-MoE stages with the experts dispatched over
    ep inside the 1F1B schedule, against the JAX hybrid form on a
    ("pp", "ep") mesh; the counters put the dispatch bytes on ep, the
    stage boundary's on pp and no gradient-reduction bytes off dp."""
    from jax.sharding import PartitionSpec as P

    params = _jax_moe_params(J)
    d = _data()
    model = J.gpt.gpt_tiny(moe_experts=E, moe_axis="ep",
                           moe_capacity_factor=2.0, **_moe_kw_jax(J))
    stages, shared = J.gpt.stack_stage_params(params, 2)
    stage_fn, pre_fn, loss_fn = J.gpt.pipeline_fns(model)
    vg = J.pl.pipeline_accumulate_gradients(stage_fn, loss_fn,
                                            accum_steps=2, axis_name="pp",
                                            pre_fn=pre_fn)

    def wrapped(st, sh, x, y):
        loss, g = vg({"stages": st, "shared": sh}, x, y)
        return (loss[None], J.jax.tree.map(lambda a: a[None],
                                           g["stages"]),
                J.jax.tree.map(lambda a: a[None], g["shared"]))

    mesh = _mesh(J, 4, ("pp", "ep"), (2, 2))
    f = J.jax.jit(J.jax.shard_map(
        wrapped, mesh=mesh, in_specs=(P("pp"), P(), P(), P()),
        out_specs=(P(("pp", "ep")), P(("pp", "ep")), P(("pp", "ep"))),
        check_vma=False))
    loss, g_st, g_sh = f(stages, shared, J.jnp.asarray(d["ptoks"]),
                         J.jnp.asarray(d["ptgts"]))
    loss = np.asarray(loss)
    g_st = J.jax.tree.map(np.asarray, g_st)
    g_sh = J.jax.tree.map(np.asarray, g_sh)
    for r, res in enumerate(world):
        s = r // 2
        _close(res["ppep/loss"], loss[r])
        # Device r holds stage s's (1, lps, ...) block.
        st_r = J.jax.tree.map(lambda a: a[r], g_st)
        want = convert.gpt_stage_params_from_jax(
            st_r, J.jax.tree.map(lambda a: a[r], g_sh), 0)
        for name, v in want.items():
            _close(res[f"ppep/g/{name}"], v.numpy())
        assert np.isfinite(res["ppep/train"]).all()
        if metrics_lib.enabled():
            assert list(res["ppep/axes/hvd_tpu_alltoall_bytes_total"]) == \
                ["ep"]
            assert list(res[
                "ppep/axes/hvd_tpu_pipeline_activation_bytes_total"]) == \
                ["pp"]
            assert set(res["ppep/axes/hvd_tpu_allreduce_bytes_total"]) <= \
                {"dp"}
        del s


if __name__ == "__main__" and sys.argv[1:2] == ["--moe-worker"]:
    _moe_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
