"""The port's topology and process sets against the JAX package's:
``common/topology.py`` (the mesh factorization and its axis lines),
``init(comm=, process_sets=)``, ``ProcessSet`` with
``add_process_set``/``remove_process_set``, set-scoped eager calls and a
set-scoped ``DistributedOptimizer``; and the guard that keeps the port
free of JAX.

* One process: the mesh factorization and the lines of each axis
  against ``horovod_tpu.common.topology`` (``mesh_axes``,
  ``build_mesh_from_axes``); the registration agreement over the
  controller (ranks on threads over ``InMemoryTransport``: a mismatch
  names the rank, a rank that never registers times out); a world of
  one.
* Four gloo ranks on the CPU, each a process running this file with
  ``--ps-worker``, once per session: ``init(process_sets=[[0, 2], [1,
  3]])``; each set's allreduce, allgather, broadcast from a global root
  and alltoall against the JAX package's engine over the same sets
  (the conftest's 8 virtual devices), bitwise; a non-member's call, an
  unregistered set and a mismatched registration raising; a set-scoped
  optimizer.
* Four more, with ``--comm-worker`` and the launcher's environment as it
  is: two disjoint comm worlds at once, ``init(comm=[0, 1])`` and
  ``init(comm=[3, 2])``, then ``[0, 2]`` and ``[1, 3]``; a non-member's
  ``init(comm=)`` raising.

JAX is imported only inside fixtures.
"""

import ast
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics, topology
from horovod_tpu_torch.common.controller import Controller, InMemoryTransport
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from test_torch_port_worlds import run_ranks

REPO = Path(__file__).resolve().parents[1]
SETS = ([0, 2], [1, 3])
# Two rounds of comm worlds, each two at once (launcher ranks, in the
# order that gives their ranks in the world).
COMM_ROUNDS = (([0, 1], [3, 2]), ([0, 2], [1, 3]))


def _data():
    g = np.random.default_rng(5)
    return {"ar": g.standard_normal((4, 8)).astype(np.float32),
            "ag": g.standard_normal((4, 2, 3)).astype(np.float32),
            "bc": g.standard_normal((4, 3)).astype(np.float32),
            "a2a": g.standard_normal((4, 2, 2)).astype(np.float32),
            "world": g.standard_normal((4, 4)).astype(np.float32),
            "grad": g.standard_normal((2, 4, 6)).astype(np.float32)}


# -- the no-JAX guard ---------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in list((REPO / "horovod_tpu_torch").rglob("*.py"))
    + [REPO / "chip_smoke.py", REPO / "chip_startup.py"]))
def test_port_imports_no_jax(path):
    """No module of the port, and neither ``chip_smoke.py`` nor
    ``chip_startup.py``, imports jax, flax or the JAX package
    (``horovod_tpu``)."""
    banned = ("jax", "flax", "horovod_tpu")
    bad = [m for m in _imports(REPO / path)
           if m.split(".")[0] in banned]
    assert not bad, f"{path} imports {bad}"


# -- one process --------------------------------------------------------------

@pytest.mark.parametrize("shape,local_size", [
    (None, 4), (None, 8), ((2, 4), 8), ((2, 2, 2), 8), ((8,), 2),
    ((4, 2), 2)])
def test_mesh_axes_match_jax(shape, local_size):
    """The factorization and every axis's lines of ranks: the JAX
    ``mesh_axes`` on a topology of 8 devices over ``8 / local_size``
    hosts, and the device ids along each axis of its
    ``build_mesh_from_axes`` mesh."""
    import jax
    from horovod_tpu.common import topology as jtopo

    devs = tuple(jax.devices()[:8])
    jt = jtopo.Topology(devices=devs, process_index=0,
                        process_count=8 // local_size,
                        local_device_count=local_size, platform="cpu",
                        is_homogeneous=True)
    want = jtopo.mesh_axes(jt, shape)
    got = topology.mesh_axes(topology.Topology(0, 8, 0, local_size), shape)
    assert [(a.name, a.size, a.kind) for a in got] == \
        [(a.name, a.size, a.kind) for a in want]
    if len(got) == 1:
        return
    mesh = jtopo.build_mesh_from_axes(jt, want)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    slow_first = list(reversed(got))
    for k, ax in enumerate(slow_first):
        lines = sorted(topology.axis_lines([a.size for a in slow_first], k))
        moved = np.moveaxis(ids, mesh.axis_names.index(ax.name), -1)
        assert lines == sorted(map(tuple, moved.reshape(-1, ax.size)))


def test_mesh_shape_parsing_matches_jax(monkeypatch):
    from horovod_tpu.common import topology as jtopo

    for raw in (None, "", "2x4", "2,2,2", "8", "0x2", "ax2", "2x"):
        assert topology.parse_mesh_shape(raw) == jtopo.parse_mesh_shape(raw)
    monkeypatch.setenv("HVD_TPU_MESH_SHAPE", "2x2")
    assert topology.mesh_shape_from_env() == (2, 2)
    with pytest.raises(ValueError, match="factor"):
        topology.mesh_axes(topology.Topology(0, 8, 0, 8), (3, 2))


def test_topology_cross_rank():
    t = topology.Topology(rank=5, size=8, local_rank=1, local_size=4)
    assert (t.cross_rank, t.cross_size, t.is_homogeneous) == (1, 2, True)
    t = topology.Topology(rank=5, size=7, local_rank=1, local_size=4)
    assert (t.cross_rank, t.cross_size, t.is_homogeneous) == (0, 1, False)


def _agree_on_threads(values, timeout=0.5):
    n = len(values)
    transport = InMemoryTransport()
    ctls = [Controller(r, n, transport, timeout_s=timeout) for r in range(n)]
    results, errors = [None] * n, [None] * n

    def work(r):
        try:
            if values[r] is not None:
                results[r] = ctls[r].agree("process_set.0", values[r])
        except Exception as e:  # noqa: BLE001
            errors[r] = e

    threads = [threading.Thread(target=work, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    return results, errors


def test_registration_agreement_names_the_rank_or_times_out():
    """The round ``add_process_set`` runs before any group is made: equal
    registrations agree, another rank list names its rank on every rank,
    a rank that never registers makes the others raise within the
    controller's timeout (no hang)."""
    results, errors = _agree_on_threads(["[0, 2]"] * 4)
    assert errors == [None] * 4 and results == [[]] * 4
    results, errors = _agree_on_threads(["[0, 2]"] * 3 + ["[1, 3]"])
    assert results[:3] == [[3]] * 3 and results[3] == [0, 1, 2]
    results, errors = _agree_on_threads(["[0, 2]"] * 3 + [None])
    assert all(isinstance(e, HorovodInternalError) for e in errors[:3])


@pytest.fixture()
def world1():
    hvd.init(device="cpu", process_sets=[[0]])
    try:
        yield
    finally:
        hvd.shutdown()


def test_registration_surface_world_of_one(world1):
    """The JAX tests' registration cases in a world of one."""
    ps = basics.context().process_sets[0]
    assert ps.ranks == (0,) and ps.size() == 1 and ps.rank() == 0
    assert ps.included() and "registered" in repr(ps)
    x = torch.arange(4.0)
    assert torch.equal(hvd.allreduce(x, process_set=ps), x)
    with pytest.raises(ValueError, match="already initialized"):
        hvd.init(process_sets=[[0]])
    with pytest.raises(ValueError, match="outside world"):
        hvd.add_process_set([0, 99])
    with pytest.raises(ValueError, match="at least one"):
        hvd.ProcessSet([])
    with pytest.raises(ValueError, match="not registered"):
        hvd.allreduce(x, process_set=hvd.ProcessSet([0]))
    with pytest.raises(TypeError, match="ProcessSet"):
        hvd.allreduce(x, process_set=object())
    hvd.remove_process_set([0])
    with pytest.raises(ValueError, match="not registered"):
        ps.engine
    with pytest.raises(ValueError, match="no registered process set"):
        hvd.remove_process_set([0])
    assert (hvd.cross_rank(), hvd.cross_size(), hvd.is_homogeneous()) == \
        (0, 1, True)


def test_init_comm_world_of_one():
    with pytest.raises(ValueError, match="distinct ranks"):
        hvd.init(device="cpu", comm=[1])
    hvd.init(device="cpu", comm=[0])
    try:
        assert hvd.size() == 1 and hvd.rank() == 0
    finally:
        hvd.shutdown()


# -- four ranks ---------------------------------------------------------------

def _ps_worker(rank: int, out_path: str) -> None:
    """One rank of the 4-process world (run as a script)."""
    hvd.init(device="cpu", process_sets=[list(s) for s in SETS])
    d = _data()
    evens, odds = basics.context().process_sets
    mine = evens if rank in evens.ranks else odds
    other = odds if mine is evens else evens
    out = {"set_rank": mine.rank(), "other_rank": other.rank()}
    t = {k: torch.from_numpy(np.array(v[rank])) for k, v in d.items()
         if k != "grad"}
    out["ar"] = hvd.allreduce(t["ar"], op=hvd.Sum, process_set=mine)
    out["ag"] = hvd.allgather(t["ag"], process_set=mine)
    out["bc"] = hvd.broadcast(t["bc"], root_rank=mine.ranks[1],
                              process_set=mine)
    out["a2a"] = hvd.alltoall(t["a2a"], process_set=mine)
    out["world"] = hvd.allreduce(t["world"], op=hvd.Average)
    h = hvd.allreduce_async(t["ar"], op=hvd.Average, process_set=mine)
    out["async"] = hvd.synchronize(h)
    for what, call in (
            ("non_member", lambda: hvd.allreduce(t["ar"], process_set=other)),
            ("bad_root", lambda: hvd.broadcast(t["bc"], other.ranks[0],
                                               process_set=mine))):
        try:
            call()
            out[what] = np.int64(0)
        except ValueError:
            out[what] = np.int64(1)
    # A mismatched registration: rank 3 registers other ranks.
    try:
        hvd.add_process_set([2, 3] if rank == 3 else [0, 1])
        out["mismatch"] = np.int64(0)
    except ValueError:
        out["mismatch"] = np.int64(1)
    # A set-scoped optimizer: SGD(lr=1) on given gradients, 2 steps.
    w = torch.nn.Parameter(torch.zeros(6))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   named_parameters=[("w", w)],
                                   process_set=mine)
    for step in range(2):
        opt.zero_grad()
        (w * torch.from_numpy(d["grad"][step, rank])).sum().backward()
        opt.step()
    out["opt"] = w.detach().clone()
    try:
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                 process_set=other)
        out["opt_non_member"] = np.int64(0)
    except ValueError:
        out["opt_non_member"] = np.int64(1)
    for h in opt._dist_hooks:
        h.remove()
    hvd.remove_process_set(mine.ranks)
    try:
        hvd.allreduce(t["ar"], process_set=mine)
        out["removed"] = np.int64(0)
    except ValueError:
        out["removed"] = np.int64(1)
    hvd.shutdown()
    _save(out_path, out)


def _comm_worker(rank: int, out_path: str) -> None:
    """One process of the comm-world run (run as a script)."""
    out = {}
    for i, worlds in enumerate(COMM_ROUNDS):
        mine, other = worlds if rank in worlds[0] else worlds[::-1]
        try:
            hvd.init(device="cpu", comm=other)
            out[f"non_member/{i}"] = np.int64(0)
        except ValueError:
            out[f"non_member/{i}"] = np.int64(1)
        hvd.init(device="cpu", comm=mine)
        out[f"comm/{i}"] = np.array([hvd.rank(), hvd.size()])
        out[f"sum/{i}"] = hvd.allreduce(torch.tensor([float(rank)]),
                                        op=hvd.Sum)
        hvd.shutdown()
    _save(out_path, out)


def _save(out_path, out):
    np.savez(out_path, **{k: v.numpy() if isinstance(v, torch.Tensor)
                          else v for k, v in out.items()})


def _launch(flag: str, out: Path):
    """Four processes running this file with ``flag``, as a launcher
    starts them; their saved results."""
    run_ranks(__file__, lambda r: (flag, r, out / f"rank{r}.npz"), 4)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


_WORLD = {}


@pytest.fixture()
def world(tmp_path_factory):
    """The 4 ranks' results (run once per session)."""
    if "ps" not in _WORLD:
        _WORLD["ps"] = _launch("--ps-worker", tmp_path_factory.mktemp("ps4"))
    return _WORLD["ps"]


@pytest.fixture()
def comm_world(tmp_path_factory):
    """The comm-world run's results (run once per session)."""
    if "comm" not in _WORLD:
        _WORLD["comm"] = _launch("--comm-worker",
                                 tmp_path_factory.mktemp("comm4"))
    return _WORLD["comm"]


@pytest.fixture(scope="module")
def jax_sets(hvd):
    """The JAX package's engine over the same sets (the conftest's 8
    virtual devices); removed after the module."""
    sets = [hvd.add_process_set(hvd.ProcessSet(s)) for s in SETS]
    yield hvd, sets
    for ps in sets:
        hvd.remove_process_set(ps)


def _per_set(jax_sets, fn, x):
    """``fn(hvd, stacked members' rows, ps)`` for each set, as each
    global rank's result."""
    jhvd, sets = jax_sets
    got = {}
    for ps in sets:
        out = jhvd.gather(fn(jhvd, jhvd.scatter(x[list(ps.ranks)],
                                                process_set=ps), ps),
                          process_set=ps)
        for pos, r in enumerate(ps.ranks):
            got[r] = np.asarray(out[pos])
    return got


def test_registration_surface(world):
    for r in range(4):
        assert world[r]["set_rank"] == SETS[r % 2].index(r)
        assert world[r]["other_rank"] == -1


def test_allreduce_over_subset(world, jax_sets):
    x = _data()["ar"]
    want = _per_set(jax_sets, lambda h, v, ps: h.allreduce(
        v, op=h.Sum, process_set=ps), x)
    for r in range(4):
        np.testing.assert_array_equal(world[r]["ar"], want[r])
        np.testing.assert_allclose(world[r]["async"],
                                   x[SETS[r % 2]].mean(0), rtol=1e-6)


def test_subset_and_world_coexist(world):
    x = _data()["world"]
    for r in range(4):
        np.testing.assert_allclose(world[r]["world"], x.mean(0), rtol=1e-6)
        np.testing.assert_array_equal(world[r]["world"], world[0]["world"])


def test_broadcast_global_root_translation(world, jax_sets):
    x = _data()["bc"]
    want = {}
    for s in SETS:
        want.update(_per_set((jax_sets[0], [ps for ps in jax_sets[1]
                                            if list(ps.ranks) == s]),
                             lambda h, v, ps: h.broadcast(
                                 v, root_rank=ps.ranks[1], process_set=ps),
                             x))
    for r in range(4):
        np.testing.assert_array_equal(world[r]["bc"], want[r])
        np.testing.assert_array_equal(world[r]["bc"], x[SETS[r % 2][1]])
        assert world[r]["bad_root"] == 1


def test_allgather_and_alltoall_over_subset(world, jax_sets):
    d = _data()
    ag = _per_set(jax_sets, lambda h, v, ps: h.allgather(v, process_set=ps),
                  d["ag"])
    a2a = _per_set(jax_sets, lambda h, v, ps: h.alltoall(v, process_set=ps),
                   d["a2a"])
    for r in range(4):
        np.testing.assert_array_equal(world[r]["ag"], ag[r])
        np.testing.assert_array_equal(world[r]["a2a"], a2a[r])


def test_non_member_call_raises(world):
    for r in range(4):
        assert world[r]["non_member"] == 1
        assert world[r]["opt_non_member"] == 1


def test_mismatched_registration_raises_on_every_rank(world):
    assert [int(r["mismatch"]) for r in world] == [1] * 4


def test_remove_then_use_fails(world):
    assert [int(r["removed"]) for r in world] == [1] * 4


def test_set_scoped_optimizer(world):
    """``DistributedOptimizer(process_set=)``: each set averages its own
    members' gradients; replicas within a set bitwise equal, the two sets
    apart."""
    g = _data()["grad"]
    for r in range(4):
        members = SETS[r % 2]
        want = -(g[0][members].mean(0) + g[1][members].mean(0))
        np.testing.assert_allclose(world[r]["opt"], want, rtol=1e-6)
        np.testing.assert_array_equal(world[r]["opt"],
                                      world[members[0]]["opt"])
    assert not np.array_equal(world[0]["opt"], world[1]["opt"])


def test_init_comm_subset_world(comm_world):
    """``init(comm=)``: each comm's processes form a world of their own,
    ranked in comm's order, while the other comm's world runs at once on
    the same launcher rendezvous; a process not in comm raises."""
    for i, worlds in enumerate(COMM_ROUNDS):
        for members in worlds:
            for k, r in enumerate(members):
                assert list(comm_world[r][f"comm/{i}"]) == [k, len(members)]
                assert comm_world[r][f"sum/{i}"].tolist() == \
                    [float(sum(members))]
        for r in range(4):
            assert comm_world[r][f"non_member/{i}"] == 1


if __name__ == "__main__" and sys.argv[1:2] == ["--ps-worker"]:
    _ps_worker(int(sys.argv[2]), sys.argv[3])
if __name__ == "__main__" and sys.argv[1:2] == ["--comm-worker"]:
    _comm_worker(int(sys.argv[2]), sys.argv[3])
