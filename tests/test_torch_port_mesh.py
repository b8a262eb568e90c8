"""The port's mesh routing against the JAX package's: the router
(``WirePlan``, ``mesh_allreduce``/``mesh_reducescatter``/``mesh_allgather``),
the two-level forms, hierarchical Adasum, ``wired_ppermute`` through
autograd, ``alltoallv_chunked``, the eager engine's hierarchical and
chunked paths and ``DistributedOptimizer(route=)``.

* Gloo ranks on the CPU, each a process running this file with
  ``--mesh-worker RANK N OUT``: a 2x2 world (``mesh_shape="2x2"``, ranks
  ``cross * 2 + local``) and a 2x2x2 one for the three-axis plans, each
  run once per session.
* The oracle is the JAX function under ``shard_map`` on a (cross, local)
  or (cross, middle, local) ``Mesh`` of the conftest's virtual CPU
  devices, rank ``r`` on device ``r`` (row-major, slow axis first, as
  the port lays ranks out).
* Tolerances: ``none`` wires to rtol 1e-6 of the JAX result (with an
  absolute floor of 1e-6 of the largest partial sum), and every rank's
  result bitwise rank 0's; round-to-nearest int8 within ``QAR_TOL`` of
  the summed block absmax, as in ``test_torch_port_reduce.py``;
  stochastic int8 (the port's draws differ from ``jax.random``'s) by the
  JAX tests' bound and by the residual-sum invariant; Adasum to 1e-5 of
  the largest value.

JAX is imported only inside the ``J`` fixture: the worker processes
import this file and must not pay for it.
"""

import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import adasum, collectives as C
from test_torch_port_worlds import run_ranks

EXACT_RTOL = 1e-6       # none wires vs JAX, relative (floor: see _exact)
QAR_TOL = 1e-6          # round-to-nearest int8 vs JAX, of the block absmax
ADASUM_TOL = 1e-5       # Adasum vs JAX / fp64, of the largest |value|
PLAN = C.WirePlan.parse("local:none,cross:none")
PLAN_Q = C.WirePlan.parse("local:none,cross:int8")
PLAN_QQ = C.WirePlan.parse("local:int8,cross:int8")
PLANS = {"none": PLAN, "q": PLAN_Q, "qq": PLAN_QQ}
# The residual invariant on both int8 axes (the JAX test's plan: its
# ascent requantizes int8 values, exactly) and on the fast axis alone
# (the ascent's rounding is real, so its owner mask is tested).
RESIDUAL_PLANS = {"qq": PLAN_QQ, "fast": "local:int8,cross:none"}
PLAN3 = "local:none,middle:none,cross:none"
PLAN3_MIXED = "local:none,middle:bf16,cross:int8"
WIRES = ("none", "bf16", "int8")
KEY = (0x5EED, 11)
SPLITS = [[300, 10, 0, 40], [5, 1200, 7, 0], [0, 3, 20, 900],
          [64, 0, 1, 2]]        # rows rank s sends rank d: skewed
OPT_THRESHOLD = 4096 * 4        # bytes: the a/b probe splits into buckets
LR = 1.0


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu import optim as joptim
    from horovod_tpu.ops import adasum as jadasum
    from horovod_tpu.ops import collectives as jC

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax,
                                 optim=joptim, adasum=jadasum, C=jC)


def _data(n):
    g = np.random.default_rng(31 + n)

    def normal(*shape, scale=1.0):
        return (g.standard_normal(shape) * scale).astype(np.float32)

    rows = [sum(r) for r in SPLITS]
    a2a = np.zeros((4, max(rows), 6), np.float32)
    for r, k in enumerate(rows):
        a2a[r, :k] = normal(k, 6)
    return {"x": normal(n, 5000), "x3": normal(n, 5000, scale=3),
            "xi": np.arange(n * 4, dtype=np.int32).reshape(n, 4),
            "flat": normal(n, n * 4096), "ag": normal(n, 3, 5),
            "ada": normal(n, 300), "ada2": normal(n, 5000, scale=2),
            "hier": normal(n, 64, 33), "qhar": normal(n, 1000, 9),
            "pp": normal(n, 5000), "ppcot": normal(n, 5000),
            "a2a": a2a, "ga": normal(n, 3000, scale=2),
            "gb": normal(n, 2000), "eager": normal(n, 258, 31),
            "train_x": normal(8, 24), "train_w": normal(24, 1)}


# -- the rank worker ----------------------------------------------------------

class _Probe(torch.nn.Module):
    """Two parameters whose gradients are given: ``loss = (a * Ga).sum()
    + (b * Gb).sum()``, so SGD(lr=1) subtracts the reduced gradient."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Parameter(torch.zeros(3000))
        self.b = torch.nn.Parameter(torch.zeros(2000))

    def step(self, opt, ga, gb):
        opt.zero_grad()
        ((self.a * ga).sum() + (self.b * gb).sum()).backward()
        opt.step()
        return {"a": self.a.detach().numpy().copy(),
                "b": self.b.detach().numpy().copy()}


def _train(rank, **kw):
    """The JAX tests' shared regression, one row of the batch a rank:
    losses (first, last) over 10 steps."""
    d = _data(4)
    y = (d["train_x"] @ d["train_w"]).reshape(8)
    xb = torch.from_numpy(d["train_x"][2 * rank:2 * rank + 2])
    yb = torch.from_numpy(y[2 * rank:2 * rank + 2])
    w = torch.nn.Parameter(torch.zeros(24, 1))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.05),
                                   named_parameters=[("w", w)], **kw)
    losses = []
    for _ in range(10):
        opt.zero_grad()
        loss = ((xb @ w - yb.reshape(-1, 1)) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(C.allreduce(loss.detach(), hvd.Average)))
    for h in opt._dist_hooks:
        h.remove()
    return np.array([losses[0], losses[-1]])


def _worker_2x2(rank, d, out):
    t = {k: torch.from_numpy(np.array(v[rank])) for k, v in d.items()
         if k not in ("train_x", "train_w")}
    for name, plan in PLANS.items():
        for op in ("sum", "average"):
            out[f"ar/{name}/{op}"] = C.mesh_allreduce(
                t["x"], hvd.Sum if op == "sum" else hvd.Average, plan)
    out["ar/int/average"] = C.mesh_allreduce(t["xi"], hvd.Average, PLAN)
    out["ar/int/sum"] = C.mesh_allreduce(t["xi"], hvd.Sum, PLAN)
    for name, plan in RESIDUAL_PLANS.items():
        out[f"res/{name}/y"], out[f"res/{name}/r"] = C.mesh_allreduce(
            t["x3"], hvd.Sum, plan, key=KEY, return_residual=True)
    out["res/key_q"] = C.mesh_allreduce(t["x3"], hvd.Sum, PLAN_Q, key=KEY)
    out["rs"] = C.mesh_reducescatter(t["flat"], hvd.Sum, PLAN)
    out["rs/ag"] = C.mesh_allgather(out["rs"], PLAN.reversed())
    out["ag"] = C.mesh_allgather(t["ag"], PLAN)
    out["ag/int8"] = C.mesh_allgather(t["ag"], "local:int8,cross:none")
    out["ag/res/y"], out["ag/res/r"] = C.mesh_allgather(
        t["ag"], PLAN_QQ, return_residual=True)
    out["adasum"] = C.mesh_allreduce(t["ada"], hvd.Adasum, PLAN)
    out["adasum/hier"] = adasum.adasum_hierarchical(t["ada"])
    out["adasum/qq"] = C.mesh_allreduce(t["ada2"], hvd.Adasum, PLAN_QQ,
                                        key=KEY)
    out["hier/average"] = C.hierarchical_allreduce(t["hier"], hvd.Average)
    out["hier/staged"] = C.hierarchical_allreduce_staged(t["hier"],
                                                         hvd.Sum)
    out["hier/ag"] = C.hierarchical_allgather(t["hier"])
    out["qhar"] = C.quantized_hierarchical_allreduce(t["qhar"], hvd.Sum)
    shift = [(i, (i + 1) % 2) for i in range(2)]
    for wire in WIRES:
        x = t["pp"].clone().requires_grad_(True)
        y = C.wired_ppermute(x, "local", shift, wire)
        (y * t["ppcot"]).sum().backward()
        out[f"pp/{wire}/y"], out[f"pp/{wire}/g"] = y.detach(), x.grad
        out[f"a2av/{wire}"] = C.alltoallv_chunked(t["a2a"], SPLITS,
                                                  wire=wire)[0]
    # The eager engine (init(hierarchical_allreduce/allgather=True)).
    out["eager/ar"] = hvd.allreduce(t["eager"], op=hvd.Sum, name="e.ar",
                                    prescale_factor=1 / 3,
                                    postscale_factor=1.5)
    out["eager/ag"] = hvd.allgather(t["eager"], name="e.ag")
    try:
        hvd.allreduce(t["eager"], name="e.q",
                      compression=hvd.Compression.int8_ef)
        out["eager/hier_int8_raises"] = np.int64(0)
    except ValueError:
        out["eager/hier_int8_raises"] = np.int64(1)
    mine = torch.from_numpy(d["a2a"][rank][:sum(SPLITS[rank])])
    for chunked in (None, True, False):
        for wire in (WIRES if chunked else ("none",)):
            out[f"eager/a2av/{chunked}/{wire}"] = hvd.alltoall(
                mine, name=f"e.a2av.{chunked}.{wire}", splits=SPLITS[rank],
                chunked=chunked, wire=None if wire == "none" else wire)
    # The optimizer (an a/b probe of given gradients, SGD lr 1).
    for case, kw in (
            ("staged", {"route": "staged"}),
            ("ef_q", {"route": "staged_int8", "compression": "int8_ef",
                      "quantize_min_bucket_bytes": 0}),
            ("max", {"route": "staged", "op": hvd.Max}),
            ("min", {"route": "staged", "op": hvd.Min}),
            ("adasum", {"route": "staged", "op": hvd.Adasum})):
        m = _Probe()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=LR),
            named_parameters=m.named_parameters(),
            fusion_threshold_bytes=OPT_THRESHOLD, **kw)
        for k, v in m.step(opt, t["ga"], t["gb"]).items():
            out[f"opt/{case}/{k}"] = v
        if case == "ef_q":
            out["opt/ef_q/buckets"] = np.int64(len(opt._dist_plan.buckets))
        if hasattr(opt, "_dist_hooks"):
            for h in opt._dist_hooks:
                h.remove()
    out["train/guard"] = _train(rank, route=PLAN_Q, compression="int8_ef",
                                nonfinite_policy="skip_step",
                                quantize_min_bucket_bytes=0)
    out["train/flat"] = _train(rank)
    out["bytes"] = np.array(_bytes_delta(
        lambda: C.mesh_allreduce(t["x"][:4096], hvd.Sum, PLAN_Q)))


def _bytes_delta(fn):
    """What ``fn`` adds to the per-axis wire-byte counter, as
    [(local, none), (cross, int8)]."""
    from horovod_tpu_torch.common import metrics

    def read():
        fam = metrics.registry().snapshot().get(
            "hvd_tpu_allreduce_bytes_total", {"samples": []})
        by = {(s["labels"]["axis"], s["labels"]["wire"]): s["value"]
              for s in fam["samples"]}
        return [by.get(("local", "none"), 0.0), by.get(("cross", "int8"), 0.0)]

    before = read()
    fn()
    return [b - a for a, b in zip(before, read())]


def _worker_2x2x2(rank, d, out):
    x = torch.from_numpy(d["x"][rank])
    out["ar3/none"] = C.mesh_allreduce(x[:4096], hvd.Sum, PLAN3)
    out["ar3/mixed"] = C.mesh_allreduce(x[:4096], hvd.Sum, PLAN3_MIXED)


def _mesh_worker(rank: int, n: int, out_path: str) -> None:
    """One rank of an n-process gloo world (run as a script)."""
    hvd.init(device="cpu", mesh_shape="2x2" if n == 4 else "2x2x2",
             hierarchical_allreduce=True, hierarchical_allgather=True)
    assert hvd.rank() == rank and hvd.size() == n
    out = {}
    (_worker_2x2 if n == 4 else _worker_2x2x2)(rank, _data(n), out)
    hvd.shutdown()
    np.savez(out_path, **{k: v.numpy() if isinstance(v, torch.Tensor)
                          else v for k, v in out.items()})


def _run_world(n, out):
    run_ranks(__file__, lambda r: ("--mesh-worker", r, n,
                                   out / f"rank{r}.npz"), n)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]


_WORLDS = {}


@pytest.fixture()
def world(tmp_path_factory):
    """The 2x2 world's per-rank results (run once per session)."""
    if 4 not in _WORLDS:
        _WORLDS[4] = _run_world(4, tmp_path_factory.mktemp("mesh4"))
    return _WORLDS[4]


@pytest.fixture()
def world8(tmp_path_factory):
    if 8 not in _WORLDS:
        _WORLDS[8] = _run_world(8, tmp_path_factory.mktemp("mesh8"))
    return _WORLDS[8]


# -- the JAX oracle -----------------------------------------------------------

_NAMES = {2: ("cross", "local"), 3: ("cross", "middle", "local")}


def _jax_mesh(J, dims, fn, *stacked):
    """``fn`` on each rank's row of ``stacked`` under shard_map on a mesh
    of ``dims`` (slow first), rank r on device r; outputs stacked by
    rank."""
    from jax.sharding import Mesh, PartitionSpec as P

    names = _NAMES[len(dims)]
    n = int(np.prod(dims))
    mesh = Mesh(np.array(J.jax.devices()[:n]).reshape(dims), names)

    def body(*blocks):
        outs = fn(*[b[0] for b in blocks])
        outs = outs if isinstance(outs, tuple) else (outs,)
        return tuple(o[None] for o in outs)

    f = J.jax.jit(J.jax.shard_map(body, mesh=mesh,
                                  in_specs=tuple(P(names) for _ in stacked),
                                  out_specs=P(names), check_vma=False))
    outs = [np.asarray(o) for o in f(*[J.jnp.asarray(s) for s in stacked])]
    return outs if len(outs) > 1 else outs[0]


def _jplan(J, plan):
    return J.C.WirePlan.parse(C.WirePlan.resolve(plan).describe())


def _exact(got, want, partial):
    """none-wire parity: rtol 1e-6, with an absolute floor of 1e-6 of the
    largest partial sum (a sum that cancels has no relative accuracy)."""
    np.testing.assert_allclose(got, want, rtol=EXACT_RTOL,
                               atol=EXACT_RTOL * np.abs(partial).sum(0).max())


def _same_on_every_rank(ranks, key):
    for r in ranks:
        np.testing.assert_array_equal(r[key], ranks[0][key])


def _rel_q99(got, want):
    return float(np.quantile(np.abs(got - want) / (np.abs(want) + 1.0),
                             0.99))


# -- WirePlan, the cost model and the counters --------------------------------

def test_wireplan_parse_and_helpers(J):
    for spec in ("local:none,cross:int8", "a:fp32,b", "local:int8,cross:int8",
                 PLAN3_MIXED):
        got, want = C.WirePlan.parse(spec), J.C.WirePlan.parse(spec)
        assert got.axis_names == want.axis_names
        assert got.wires == want.wires and got.describe() == want.describe()
        assert got.reversed().describe() == want.reversed().describe()
        assert got.with_wires("bf16").describe() == \
            want.with_wires("bf16").describe()
    assert C.WirePlan.hierarchical(cross_wire="int8") == PLAN_Q


def test_wireplan_resolve_named_routes(J):
    for name in (None, "flat", "none", "", "staged", "hierarchical",
                 "staged_int8", "quantized_cross", "mesh_int8",
                 "local:int8,cross:int8"):
        got, want = C.WirePlan.resolve(name), J.C.WirePlan.resolve(name)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.describe() == want.describe()
    assert C.WirePlan.resolve(PLAN_Q) is PLAN_Q
    assert C.WirePlan.resolve([("local", "none"), ("cross", "int8")]) \
        == PLAN_Q
    with pytest.raises(ValueError, match="unknown route"):
        C.WirePlan.resolve("bogus")


def test_wireplan_validation():
    with pytest.raises(ValueError, match="wire"):
        C.WirePlan.parse("local:float8")
    with pytest.raises(ValueError, match="duplicate"):
        C.WirePlan.parse("local:none,local:int8")
    with pytest.raises(ValueError, match="at least one"):
        C.WirePlan(())


@pytest.mark.parametrize("op", ["sum", "adasum"])
@pytest.mark.parametrize("spec,sizes", [(PLAN, (4, 2)), (PLAN_Q, (4, 2)),
                                        (PLAN_QQ, (2, 2)),
                                        (PLAN3_MIXED, (2, 2, 2))])
def test_mesh_wire_cost_matches_jax(J, spec, sizes, op):
    plan = C.WirePlan.resolve(spec)
    jop = J.C.ReduceOp.SUM if op == "sum" else J.C.ReduceOp.ADASUM
    for nelems in (4096, 16_384 * 1024, 51_463_168):
        got = C.mesh_wire_cost(plan, nelems, sizes,
                               C.ReduceOp.SUM if op == "sum"
                               else C.ReduceOp.ADASUM)
        want = J.C.mesh_wire_cost(_jplan(J, plan), nelems, sizes, jop)
        assert got == want


def test_mesh_wire_cost_slow_axis_strictly_fewer():
    """The JAX test's inequality: the staged plan moves fewer bytes on
    the slow axis than the flat ring, the int8 cross hop a quarter."""
    for mib in (0.0625, 1, 64, 256):
        nelems = int(mib * 2 ** 20 / 4)
        flat_slow = 2.0 * 7 / 8 * nelems * 4
        staged = C.mesh_wire_cost(PLAN, nelems, (4, 2))
        quant = C.mesh_wire_cost(PLAN_Q, nelems, (4, 2))
        assert staged["cross"]["bytes"] < flat_slow
        assert quant["cross"]["bytes"] == pytest.approx(
            staged["cross"]["bytes"] / 4, rel=0.01)


def test_mesh_allreduce_publishes_per_axis_bytes(world):
    """One 4096-element routed SUM on local:none,cross:int8 adds the
    ``mesh_wire_cost`` of its padded length (4096 a rank, as the JAX
    package counts it) to the per-axis counters."""
    want = C.mesh_wire_cost(PLAN_Q, 4 * 4096, (2, 2))
    for r in world:
        assert list(r["bytes"]) == [want["local"]["bytes"],
                                    want["cross"]["bytes"]]


# -- the router against JAX ---------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "average"])
def test_mesh_allreduce_exact_matches_jax(J, world, op):
    x = _data(4)["x"]
    jop = J.C.ReduceOp.SUM if op == "sum" else J.C.ReduceOp.AVERAGE
    want = _jax_mesh(J, (2, 2), lambda v: J.C.mesh_allreduce(
        v, jop, _jplan(J, PLAN)), x)
    _same_on_every_rank(world, f"ar/none/{op}")
    for r in range(4):
        _exact(world[r][f"ar/none/{op}"], want[r], x)


@pytest.mark.parametrize("name", ["q", "qq"])
def test_mesh_allreduce_quantized_matches_jax(J, world, name):
    """Round-to-nearest int8 phases: within QAR_TOL of the block absmax
    of JAX's result, and within the JAX test's bound of the exact sum."""
    x = _data(4)["x"]
    want = _jax_mesh(J, (2, 2), lambda v: J.C.mesh_allreduce(
        v, J.C.ReduceOp.SUM, _jplan(J, PLANS[name])), x)
    _same_on_every_rank(world, f"ar/{name}/sum")
    tol = QAR_TOL * np.abs(x).max(axis=1).sum()
    for r in range(4):
        np.testing.assert_allclose(world[r][f"ar/{name}/sum"], want[r],
                                   rtol=0, atol=tol)
    assert _rel_q99(world[0][f"ar/{name}/sum"], x.sum(0)) < 0.12
    np.testing.assert_allclose(world[0][f"ar/{name}/average"],
                               world[0][f"ar/{name}/sum"] / 4, rtol=1e-6)


def test_mesh_allreduce_int_average_promotes_like_flat(world):
    xi = _data(4)["xi"]
    got = world[0]["ar/int/average"]
    assert np.issubdtype(got.dtype, np.floating)
    np.testing.assert_allclose(got, xi.mean(0), rtol=1e-6)
    assert world[0]["ar/int/sum"].dtype == np.int32
    np.testing.assert_array_equal(world[0]["ar/int/sum"], xi.sum(0))


@pytest.mark.parametrize("plan", sorted(RESIDUAL_PLANS))
def test_mesh_allreduce_residual_sum_invariant(world, plan):
    """Stochastic int8: the exact sum less the result equals the
    residuals summed over the mesh, to fp32 roundoff (and the rounding
    error is far above it)."""
    x3 = _data(4)["x3"]
    _same_on_every_rank(world, f"res/{plan}/y")
    want = x3.sum(0)
    y = world[0][f"res/{plan}/y"]
    rsum = sum(r[f"res/{plan}/r"] for r in world)
    closed = np.abs(want - y - rsum).max()
    assert closed < 1e-4 * (np.abs(want).max() + 1)
    assert np.abs(want - y).max() > 10 * closed
    # Stochastic int8 on the cross hop alone: at most one block scale of
    # each local sum and of the reduced sum an element (r = 1).
    bound = sum(np.abs(x3[c:c + 2].sum(0)).max() for c in (0, 2)) / 127 \
        + np.abs(want).max() / 127
    assert np.abs(world[0]["res/key_q"] - want).max() <= bound


def test_mesh_reducescatter_allgather_roundtrip(J, world):
    flat = _data(4)["flat"]
    want = _jax_mesh(J, (2, 2), lambda v: J.C.mesh_reducescatter(
        v, J.C.ReduceOp.SUM, _jplan(J, PLAN)), flat)
    for r in range(4):
        _exact(world[r]["rs"], want[r], flat)
        _exact(world[r]["rs/ag"], flat.sum(0), flat)
    _same_on_every_rank(world, "rs/ag")


def test_mesh_allgather_flat_row_order(J, world):
    ag = _data(4)["ag"]
    for r in range(4):
        np.testing.assert_array_equal(world[r]["ag"], ag.reshape(12, 5))
    want = _jax_mesh(J, (2, 2), lambda v: J.C.mesh_allgather(
        v, J.C.WirePlan.parse("local:int8,cross:none")), ag)
    np.testing.assert_allclose(world[0]["ag/int8"], want[0], rtol=0,
                               atol=QAR_TOL * np.abs(ag).max())


def test_mesh_allgather_residual_sum_invariant(world):
    """``mesh_allgather(..., return_residual=True)`` on two int8 hops:
    the residuals summed over the ranks are the exact gather less the
    result (each hop's error counted once, by its owner), and the error
    lies within a round-to-nearest step of each hop."""
    ag = _data(4)["ag"].reshape(12, 5)
    _same_on_every_rank(world, "ag/res/y")
    y = world[0]["ag/res/y"]
    total = sum(world[r]["ag/res/r"] for r in range(4))
    np.testing.assert_allclose(total, ag - y, rtol=0,
                               atol=1e-6 * np.abs(ag).max())
    assert np.abs(ag - y).max() <= np.abs(ag).max() / 127
    assert np.abs(total).max() > 0


def test_mesh_adasum_matches_hierarchical_reference(J, world):
    """mesh_allreduce(ADASUM) on shards = the Adasum of the local groups'
    averages: against JAX's routed Adasum, JAX's ``adasum_hierarchical``,
    the port's and the fp64 recursion."""
    ada = _data(4)["ada"]
    ref = adasum.adasum_allreduce_reference([ada[:2].mean(0),
                                             ada[2:].mean(0)])
    jmesh = _jax_mesh(J, (2, 2), lambda v: J.C.mesh_allreduce(
        v, J.C.ReduceOp.ADASUM, _jplan(J, PLAN)), ada)
    jhier = _jax_mesh(J, (2, 2), lambda v: J.adasum.adasum_hierarchical(v),
                      ada)
    tol = ADASUM_TOL * np.abs(ref).max()
    _same_on_every_rank(world, "adasum")
    for r in range(4):
        for got in (world[r]["adasum"], world[r]["adasum/hier"]):
            for want in (ref, jmesh[r], jhier[r]):
                np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_mesh_adasum_int8_wire_within_bound(world):
    ada2 = _data(4)["ada2"]
    ref = adasum.adasum_allreduce_reference([ada2[:2].mean(0),
                                             ada2[2:].mean(0)])
    _same_on_every_rank(world, "adasum/qq")
    assert _rel_q99(world[0]["adasum/qq"], ref) < 0.12


# -- the two-level forms ------------------------------------------------------

def test_hierarchical_allreduce_matches_jax(J, world):
    h = _data(4)["hier"]
    avg = _jax_mesh(J, (2, 2), lambda v: J.C.hierarchical_allreduce(
        v, J.C.ReduceOp.AVERAGE), h)
    staged = _jax_mesh(J, (2, 2), lambda v: J.C.hierarchical_allreduce_staged(
        v, J.C.ReduceOp.SUM), h)
    ag = _jax_mesh(J, (2, 2), lambda v: J.C.hierarchical_allgather(v), h)
    for key in ("hier/average", "hier/staged", "hier/ag"):
        _same_on_every_rank(world, key)
    for r in range(4):
        _exact(world[r]["hier/average"], avg[r], h / 4)
        _exact(world[r]["hier/staged"], staged[r], h)
        np.testing.assert_array_equal(world[r]["hier/ag"], ag[r])


def test_quantized_hierarchical_allreduce_matches_jax(J, world):
    """K2/K4 on both cross hops (the plain versions on the CPU) against
    JAX's function: round to nearest, within QAR_TOL of the block absmax,
    and within the documented bound of the exact sum."""
    q = _data(4)["qhar"]
    want = _jax_mesh(J, (2, 2), lambda v: J.C.quantized_hierarchical_allreduce(
        v, J.C.ReduceOp.SUM), q)
    _same_on_every_rank(world, "qhar")
    tol = QAR_TOL * np.abs(q).max(axis=(1, 2)).sum()
    for r in range(4):
        np.testing.assert_allclose(world[r]["qhar"], want[r], rtol=0,
                                   atol=tol)
    local = q[0::2] + q[1::2]
    bound = (np.abs(local).max() + np.abs(q.sum(0)).max()) / 127
    assert np.abs(world[0]["qhar"] - q.sum(0)).max() <= bound


# -- wired exchanges ----------------------------------------------------------

@pytest.mark.parametrize("wire", WIRES)
def test_wired_ppermute_forward_and_vjp_match_jax(J, world, wire):
    """A shift over the local axis and its backward through autograd
    against ``jax.vjp`` of the JAX function: the cotangent rides the
    inverse shift in the same wire (round to nearest)."""
    d = _data(4)
    shift = [(i, (i + 1) % 2) for i in range(2)]

    def fn(v, cot):
        y, vjp = J.jax.vjp(lambda u: J.C.wired_ppermute(u, "local", shift,
                                                        wire), v)
        return y, vjp(cot)[0]

    y, g = _jax_mesh(J, (2, 2), fn, d["pp"], d["ppcot"])
    for r in range(4):
        for key, want, src in (("y", y, d["pp"]), ("g", g, d["ppcot"])):
            tol = (QAR_TOL * np.abs(src).max()) if wire == "int8" else 0
            np.testing.assert_allclose(world[r][f"pp/{wire}/{key}"], want[r],
                                       rtol=0, atol=tol)
    # The shift itself: rank (c, l) holds (c, 1 - l)'s input.
    partner = [1, 0, 3, 2]
    step = {"none": 0, "bf16": 2 ** -7, "int8": 1 / 254}[wire]
    for r in range(4):
        src = d["pp"][partner[r]]
        np.testing.assert_allclose(world[r][f"pp/{wire}/y"], src, rtol=step,
                                   atol=step * np.abs(src).max())


@pytest.mark.parametrize("wire", WIRES)
def test_alltoallv_chunked_matches_jax(J, world, wire):
    a2a = _data(4)["a2a"]
    want, counts = J.jax.jit(J.jax.shard_map(
        lambda v: tuple(o[None] for o in J.C.alltoallv_chunked(
            v[0], SPLITS, "hvd", wire=wire)),
        mesh=J.jax.sharding.Mesh(np.array(J.jax.devices()[:4]), ("hvd",)),
        in_specs=J.jax.sharding.PartitionSpec("hvd"),
        out_specs=J.jax.sharding.PartitionSpec("hvd"),
        check_vma=False))(J.jnp.asarray(a2a))
    want = np.asarray(want)
    seg = max(max(row) for row in SPLITS)
    for r in range(4):
        got = world[r][f"a2av/{wire}"]
        tol = QAR_TOL * np.abs(a2a).max() if wire == "int8" else 0
        np.testing.assert_allclose(got, want[r], rtol=0, atol=tol)
        for s in range(4):
            rows = got[s * seg:(s + 1) * seg]
            assert not rows[SPLITS[s][r]:].any()    # padding stays zero


# -- the eager engine ---------------------------------------------------------

def test_eager_hierarchical_allreduce_and_allgather(world):
    """``init(hierarchical_allreduce=True)``: a SUM with pre/postscale over
    local then cross, bitwise equal on every rank and within fp32
    summation error of the flat result; the hierarchical allgather is the
    flat one; a quantized default compression raises."""
    e = _data(4)["eager"]
    _same_on_every_rank(world, "eager/ar")
    pre = np.float32(1 / 3)
    want = (e.astype(np.float64) * pre).sum(0) * np.float32(1.5)
    np.testing.assert_allclose(world[0]["eager/ar"], want, rtol=0,
                               atol=4e-7 * np.abs(e).sum(0).max())
    for r in range(4):
        np.testing.assert_array_equal(world[r]["eager/ag"],
                                      e.reshape(-1, 31))
        assert world[r]["eager/hier_int8_raises"] == 1


@pytest.mark.parametrize("wire", WIRES)
def test_eager_chunked_alltoallv_matches_plain(world, wire):
    """``alltoall(splits=, chunked=True, wire=)`` against the exchange
    done by hand: exact on the none wire (and for the flat and the
    default forms), within one wire step on bf16 and int8."""
    a2a = _data(4)["a2a"]
    for r in range(4):
        want = np.concatenate([a2a[s][sum(SPLITS[s][:r]):
                                      sum(SPLITS[s][:r + 1])]
                               for s in range(4)])
        got = world[r][f"eager/a2av/True/{wire}"]
        step = {"none": 0, "bf16": 2 ** -7, "int8": 1 / 254}[wire]
        np.testing.assert_allclose(got, want, rtol=step,
                                   atol=step * np.abs(a2a).max())
        if wire == "none":
            for chunked in ("None", "False"):
                np.testing.assert_array_equal(
                    world[r][f"eager/a2av/{chunked}/none"], want)


# -- the optimizer's route ----------------------------------------------------

def _jax_opt(J, tx, d):
    import jax.numpy as jnp

    p = {"a": jnp.zeros(3000, jnp.float32), "b": jnp.zeros(2000, jnp.float32)}

    def fn(ga, gb):
        u, _ = tx.update({"a": ga, "b": gb}, tx.init(p), p)
        return u["a"], u["b"]

    return _jax_mesh(J, (2, 2), fn, d["ga"], d["gb"])


def test_optimizer_route_staged_matches_jax(J, world):
    """``route="staged"`` (Average, SGD): the JAX
    ``DistributedOptimizer(route=PLAN)`` under shard_map on the 2x2
    mesh."""
    d = _data(4)
    ua, ub = _jax_opt(J, J.optim.DistributedOptimizer(
        J.optax.sgd(LR), route=_jplan(J, PLAN),
        fusion_threshold_bytes=OPT_THRESHOLD), d)
    for r in range(4):
        _exact(world[r]["opt/staged/a"], ua[r], d["ga"] / 4)
        _exact(world[r]["opt/staged/b"], ub[r], d["gb"] / 4)
    _same_on_every_rank(world, "opt/staged/a")


def test_optimizer_route_int8_ef_within_bound(world):
    """``compression="int8_ef", route="staged_int8"``: int8 only on the
    cross hop, stochastic, within the JAX grad-consistency bound of the
    exact average, replicas bitwise equal."""
    d = _data(4)
    assert world[0]["opt/ef_q/buckets"] > 1
    for k in ("a", "b"):
        _same_on_every_rank(world, f"opt/ef_q/{k}")
        assert _rel_q99(-world[0][f"opt/ef_q/{k}"], d["g" + k].mean(0)) \
            < 0.15


@pytest.mark.parametrize("op", ["max", "min"])
def test_minmax_ops_reduce_jointly_under_route(world, op):
    d = _data(4)
    red = np.max if op == "max" else np.min
    for k in ("a", "b"):
        np.testing.assert_array_equal(world[0][f"opt/{op}/{k}"],
                                      -red(d["g" + k], axis=0))


def test_optimizer_route_adasum_matches_reference(world):
    """``op=Adasum, route="staged"``: each parameter's delta is the
    Adasum of the local groups' average deltas (fp64 reference)."""
    d = _data(4)
    _same_on_every_rank(world, "opt/adasum/a")
    for k in ("a", "b"):
        g = -LR * d["g" + k]
        ref = adasum.adasum_allreduce_reference([g[:2].mean(0),
                                                 g[2:].mean(0)])
        np.testing.assert_allclose(world[0][f"opt/adasum/{k}"], ref, rtol=0,
                                   atol=ADASUM_TOL * np.abs(ref).max())


def test_route_composes_with_nonfinite_guard(world):
    """The JAX test's regression under ``route=local:none,cross:int8``,
    int8_ef and ``nonfinite_policy="skip_step"``: it trains, and within
    2% of the flat fp32 run's loss."""
    l0, lN = world[0]["train/guard"]
    f0, fN = world[0]["train/flat"]
    assert np.isfinite(lN) and lN < l0
    assert l0 == pytest.approx(f0, rel=1e-6)
    assert abs(lN - fN) < 0.02 * f0


# -- three axes ---------------------------------------------------------------

def test_mesh_allreduce_3d_matches_jax(J, world8):
    x = _data(8)["x"][:, :4096]
    want = _jax_mesh(J, (2, 2, 2), lambda v: J.C.mesh_allreduce(
        v, J.C.ReduceOp.SUM, J.C.WirePlan.parse(PLAN3)), x)
    _same_on_every_rank(world8, "ar3/none")
    for r in range(8):
        _exact(world8[r]["ar3/none"], want[r], x)


def test_mesh_allreduce_3d_mixed_wires(J, world8):
    """local:none, middle:bf16, cross:int8 (round to nearest): within the
    JAX test's bound of the exact sum and of JAX's own result."""
    x = _data(8)["x"][:, :4096]
    want = _jax_mesh(J, (2, 2, 2), lambda v: J.C.mesh_allreduce(
        v, J.C.ReduceOp.SUM, J.C.WirePlan.parse(PLAN3_MIXED)), x)
    _same_on_every_rank(world8, "ar3/mixed")
    got = world8[0]["ar3/mixed"]
    assert _rel_q99(got, x.sum(0)) < 0.06
    assert _rel_q99(got, want[0]) < 0.06


# -- one process --------------------------------------------------------------

@pytest.fixture()
def world1():
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def test_world_of_one_router_and_fallbacks(world1):
    """A flat world of one: the world axis is "hvd"; a plan over it is
    the identity; a route naming axes this world lacks falls back to the
    flat reduction (the JAX optimizer's rule for unbound axes)."""
    ctx = basics.context()
    assert list(ctx.axes) == ["hvd"] and ctx.hier_axes() is None
    x = torch.arange(10.0)
    assert torch.equal(C.mesh_allreduce(x, hvd.Sum, "hvd:none"), x)
    with pytest.raises(ValueError, match="no mesh axis"):
        C.mesh_allreduce(x, hvd.Sum, PLAN)
    m = _Probe()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=LR),
                                   route="staged")
    assert opt._route is None
    g = torch.ones(3000), torch.ones(2000)
    assert (m.step(opt, *g)["a"] == -1).all()
    y = C.wired_ppermute(x, None, [(0, 0)], "int8")
    assert torch.allclose(y, x, atol=9 / 254)
    with pytest.raises(ValueError, match="more than once"):
        C.ppermute(x, [(0, 0), (0, 0)])


if __name__ == "__main__" and sys.argv[1:2] == ["--mesh-worker"]:
    _mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
