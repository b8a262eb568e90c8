"""The port's parallel roles against the JAX package's: ``ParallelSpec``,
the tensor-parallel primitives and the tp GPT, ring, striped ring and
Ulysses attention, ``mesh_alltoall``, the sp GPT twins and
``DistributedOptimizer(parallel=)``.

* Gloo ranks on the CPU, each a process running this file with
  ``--parallel-worker RANK SPEC OUT``: a world made with
  ``init(parallel="dp=2,tp=2")`` (the tp cases, the sequence functions
  at n = 2 over its tp axis and at n = 4 over the world, the mesh
  all-to-all on the 2x2 mesh) and one with ``parallel="dp=2,sp=2"`` (the
  sp GPT twins and the sp optimizer), each run once per test run.
* The oracle is the JAX function under ``shard_map(check_vma=False)`` on
  a mesh of the conftest's virtual CPU devices, rank ``r`` on device
  ``r`` (row-major, slow axis first, as the spec lays ranks out), fed
  the same seeded numpy inputs. Both packages run per-rank semantics, so
  raw per-rank gradients are compared, not only the combined ones.
* Tolerances (fp32 throughout): functions and the tp/sp GPT forward and
  gradients to ``TOL`` (rtol and atol 2e-5: the port's plain flash
  kernels and the JAX jnp path differ in summation order only; the JAX
  tests hold their own twins to 2e-4); the combined gradients against
  the dense JAX model's to ``GRAD_TOL`` (the JAX test's rtol 2e-3, atol
  2e-5); the lossy sequence wires against the exact oracle by the JAX
  tests' bounds (bf16 0.05, int8 0.15 absolute); the int8 mesh
  all-to-all within one block scale of the exchanged values; three
  AdamW steps to ``STEP_TOL`` (1e-5 absolute). The AdamW ``eps`` is
  1e-3: at 1e-8 Adam divides each gradient by its own size, so a
  summation-order difference in a near-zero gradient moves that element
  by up to a whole step (2.7e-4 seen at lr 1e-2); at 1e-3 the update is
  Lipschitz in the gradient and such differences stay their size.

JAX is imported only inside the ``J`` fixture: the worker processes
import this file and must not pay for it.
"""

import importlib
import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import convert, gpt
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.parallel import tensor_parallel as tp
from horovod_tpu_torch.parallel import ulysses
from horovod_tpu_torch.parallel.spec import ParallelSpec
from test_torch_port_worlds import run_ranks

# The package exports a function of the module's name.
ring = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")

TOL = 2e-5
GRAD_TOL = (2e-3, 2e-5)
STEP_TOL = 1e-5
WIRE_TOL = {"bf16": 0.05, "int8": 0.15}
GPT_KW = dict(num_layers=2, hidden=128, num_heads=4, mlp_dim=256,
              vocab_size=128)
ADAMW = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-3, weight_decay=1e-4)
STEPS = 3
KEY = (0x5EED, 3)
B, S, H, D = 2, 16, 4, 8          # attention inputs (global sequence S)


def _data():
    g = np.random.default_rng(1515)

    def normal(*shape, scale=1.0):
        return (g.standard_normal(shape) * scale).astype(np.float32)

    mask = (g.random((B, S)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0          # every causal row keeps a visible key
    return {
        "x": normal(2, 2, 4, 16), "w1": normal(16, 32, scale=0.3),
        "b1": normal(32, scale=0.1), "w2": normal(32, 16, scale=0.3),
        "b2": normal(16, scale=0.1), "cot": normal(2, 2, 4, 16),
        "qkv_w": normal(16, 48, scale=0.3), "qkv_b": normal(48),
        "out_w": normal(16, 16),
        # Two groups (the dp rows of the 2x2 world) of q, k, v, do.
        "q": normal(2, B, S, H, D), "k": normal(2, B, S, H, D),
        "v": normal(2, B, S, H, D), "do": normal(2, B, S, H, D),
        "mask": mask, "a2a": normal(4, 8, 6),
        "toks": g.integers(0, 128, (4, 16)).astype(np.int64),
        "tgts": g.integers(0, 128, (4, 16)).astype(np.int64),
    }


def _jax_params(seed=0):
    """The dense JAX GPT's params (numpy leaves): the weights of every
    form, carried across by ``convert.gpt_params_from_jax``."""
    import jax

    from horovod_tpu.models.gpt import gpt_tiny

    m = gpt_tiny(**GPT_KW)
    params = m.init(jax.random.PRNGKey(seed), np.zeros((1, 16), np.int32))
    return jax.tree.map(np.asarray, params)["params"]


# -- the rank worker ----------------------------------------------------------

def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _stripe_shard(x, n, i):
    s = x.shape[1] // n
    return ring.stripe_layout(x, n)[:, i * s:(i + 1) * s]


def _seq_cases(out, tag, ax, group):
    """The sequence functions over ``ax`` (n ranks) on ``group``'s
    q/k/v: ring causal/non-causal with a key mask, plain and flash;
    striped plain and flash; the lossy wires; Ulysses; byte counts."""
    d = _data()
    n, i = ax.size, ax.index
    s = S // n
    full = {k: torch.from_numpy(d[k][group]) for k in ("q", "k", "v", "do")}
    contig = {k: v[:, i * s:(i + 1) * s] for k, v in full.items()}
    striped = {k: _stripe_shard(v, n, i) for k, v in full.items()}
    mask = torch.from_numpy(d["mask"][:, i * s:(i + 1) * s])

    def run(name, fn, inp):
        q, k, v = (inp[x].clone().requires_grad_(True) for x in "qkv")
        y = fn(q, k, v)
        (y * inp["do"]).sum().backward()
        out[f"{tag}/{name}/y"] = y.detach()
        for x, t in zip("qkv", (q, k, v)):
            out[f"{tag}/{name}/d{x}"] = t.grad

    for flash in (False, True):
        f = "flash" if flash else "plain"
        for causal in (False, True):
            run(f"ring/{f}/c{int(causal)}",
                lambda q, k, v: ring.ring_attention(
                    q, k, v, ax, causal=causal, mask=mask,
                    use_flash=flash, wire="none"), contig)
        run(f"striped/{f}", lambda q, k, v: ring.striped_attention(
            q, k, v, ax, use_flash=flash, wire="none"), striped)
    for wire in ("bf16", "int8"):
        run(f"striped/wire/{wire}", lambda q, k, v: ring.striped_attention(
            q, k, v, ax, use_flash=True, wire=wire, wire_key=KEY), striped)
    run("ulysses", lambda q, k, v: ulysses.ulysses_attention(
        q, k, v, ax, wire="none"), contig)
    run("ulysses/causal", lambda q, k, v: ulysses.ulysses_attention(
        q, k, v, ax, attend_fn=gpt._causal_attend, wire="none"), contig)
    for wire in ("none", "int8"):
        before = C.PARALLEL_BYTES["seq"]
        ring.striped_attention(striped["q"], striped["k"], striped["v"],
                               ax, wire=wire)
        out[f"{tag}/bytes/{wire}"] = np.float64(C.PARALLEL_BYTES["seq"]
                                                - before)


def _tp_cases(out, rank):
    d = _data()
    dp, ti = divmod(rank, 2)
    x = _t(d["x"][dp], grad=True)
    w1, b1, w2, b2 = (_t(d[k], grad=True) for k in ("w1", "b1", "w2", "b2"))
    y = tp.tp_mlp(x, tp.shard_column(w1), tp.shard_column(b1),
                  tp.shard_row(w2), b2, "tp")
    (y * _t(d["cot"][dp])).sum().backward()
    out["tp/mlp/y"] = y.detach()
    for k, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        out[f"tp/mlp/d{k}"] = t.grad
    xx = _t(d["x"][dp])
    out["tp/col"] = tp.column_parallel(xx, tp.shard_column(_t(d["w1"])),
                                       tp.shard_column(_t(d["b1"])))
    out["tp/row"] = tp.row_parallel(out["tp/col"],
                                    tp.shard_row(_t(d["w2"])), "tp",
                                    _t(d["b2"]))
    w3 = tp.shard_heads(_t(d["qkv_w"]), 4, "tp", fused=3)
    out["tp/heads_w"] = w3
    out["tp/heads_b"] = tp.shard_heads(_t(d["qkv_b"]), 4, "tp", fused=3)
    out["tp/head_rows"] = tp.shard_head_rows(_t(d["out_w"]), 4, "tp")
    qkv = tp.tp_attention_qkv(xx, *(w3[:, j].reshape(16, 8)
                                    for j in range(3)), 2)
    for j, t in enumerate(qkv):
        out[f"tp/qkv{j}"] = t
    out["tp/combined"] = tp.combine_slice_grads(
        {"w1": out["tp/mlp/dw1"]}, "tp")["w1"]


def _gpt_grads(model, toks, tgts):
    model.zero_grad()
    logits = model(toks)
    loss = gpt.next_token_loss(logits, tgts)
    loss.backward()
    return logits.detach(), loss.detach(), {
        n: p.grad.clone() for n, p in model.named_parameters()}


def _train(model, toks, tgts, spec, kind):
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters(),
                                                     **ADAMW),
                                   named_parameters=model.named_parameters(),
                                   parallel=spec)
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = gpt.next_token_loss(model(toks), tgts)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    for h in opt._dist_hooks:
        h.remove()
    return {f"{kind}/p/{n}": p.detach().clone()
            for n, p in model.named_parameters()}, np.array(losses)


def _worker_tp(rank, out):
    hvd.init(device="cpu", parallel="dp=2,tp=2")
    spec = hvd.parallel_spec()
    assert spec.describe() == "dp=2,tp=2"
    mesh = hvd.parallel_mesh()
    out["mesh"] = np.array([[mesh[r].size, mesh[r].index] + list(
        mesh[r].ranks) for r in ("dp", "tp")])
    out["role"] = np.array(basics.context().flightrec.role)
    _tp_cases(out, rank)
    d = _data()
    params = np.load(sys.argv[5], allow_pickle=True)["params"].item()
    sd = convert.gpt_params_from_jax(params)
    dp = rank // 2
    toks = _t(d["toks"][2 * dp:2 * dp + 2])
    tgts = _t(d["tgts"][2 * dp:2 * dp + 2])
    m = gpt.gpt_tiny(tp_axis="tp", **GPT_KW)
    m.load_state_dict(sd)
    logits, loss, grads = _gpt_grads(m, toks, tgts)
    out["gpt/logits"], out["gpt/loss"] = logits, loss
    for n, g in grads.items():
        out[f"gpt/g/{n}"] = g
    comb = tp.combine_slice_grads(grads, "tp")
    for n, g in comb.items():
        out[f"gpt/cg/{n}"] = C.allreduce(g, hvd.Average, axis="dp")
    m2 = gpt.gpt_tiny(tp_axis="tp", **GPT_KW)
    m2.load_state_dict(sd)
    got, losses = _train(m2, toks, tgts, "dp=2,tp=2", "opt")
    out.update(got)
    out["opt/losses"] = losses
    # The sequence functions: n = 2 over the tp axis, n = 4 over the
    # world (one ring of all ranks).
    _seq_cases(out, "n2", basics.context().axis("tp"), dp)
    world = mesh_lib.build_mesh({"sp": 4}, rank, 4)["sp"]
    _seq_cases(out, "n4", world, 0)
    # mesh_alltoall on the 2x2 mesh (tp fast, dp slow), with grads.
    x = _t(d["a2a"][rank], grad=True)
    y = C.mesh_alltoall(x, "tp:none,dp:none")
    (y * torch.arange(y.numel(), dtype=torch.float32).reshape(
        y.shape)).sum().backward()
    out["a2a/none"], out["a2a/none/dx"] = y.detach(), x.grad
    out["a2a/int8"] = C.mesh_alltoall(_t(d["a2a"][rank]),
                                      "tp:int8,dp:bf16")
    hvd.shutdown()


def _worker_sp(rank, out):
    hvd.init(device="cpu", parallel={"dp": 2, "sp": 2})
    d = _data()
    params = np.load(sys.argv[5], allow_pickle=True)["params"].item()
    sd = convert.gpt_params_from_jax(params)
    dp, si = divmod(rank, 2)
    rows = slice(2 * dp, 2 * dp + 2)
    for impl in ("ring", "ulysses"):
        toks, tgts = _t(d["toks"][rows]), _t(d["tgts"][rows])
        if impl == "ring":
            toks, tgts = (_stripe_shard(t, 2, si) for t in (toks, tgts))
        else:
            toks, tgts = toks[:, si * 8:(si + 1) * 8], \
                tgts[:, si * 8:(si + 1) * 8]
        m = gpt.gpt_tiny(seq_parallel="sp", seq_impl=impl, seq_wire="none",
                         **GPT_KW)
        m.load_state_dict(sd)
        logits, loss, grads = _gpt_grads(m, toks, tgts)
        out[f"{impl}/logits"], out[f"{impl}/loss"] = logits, loss
        for n, g in grads.items():
            out[f"{impl}/g/{n}"] = g
        if impl == "ring":
            m2 = gpt.gpt_tiny(seq_parallel="sp", seq_impl=impl,
                              seq_wire="none", **GPT_KW)
            m2.load_state_dict(sd)
            got, losses = _train(m2, toks, tgts, "dp=2,sp=2", "opt")
            out.update(got)
            out["opt/losses"] = losses
    hvd.shutdown()


def _parallel_worker(rank: int, kind: str, out_path: str) -> None:
    out = {}
    (_worker_tp if kind == "tp" else _worker_sp)(rank, out)
    np.savez(out_path, **{k: v.detach().numpy()
                          if isinstance(v, torch.Tensor) else v
                          for k, v in out.items()})


_WORLDS = {}


def _world(kind, tmp_path_factory):
    if kind not in _WORLDS:
        out = tmp_path_factory.mktemp(f"parallel_{kind}")
        pfile = out / "params.npz"
        np.savez(pfile, params=np.array(_jax_params(), dtype=object))
        run_ranks(__file__, lambda r: ("--parallel-worker", r, kind,
                                       out / f"rank{r}.npz", pfile), 4,
                  timeout=300)
        _WORLDS[kind] = [dict(np.load(out / f"rank{r}.npz"))
                         for r in range(4)]
    return _WORLDS[kind]


@pytest.fixture()
def world_tp(tmp_path_factory):
    return _world("tp", tmp_path_factory)


@pytest.fixture()
def world_sp(tmp_path_factory):
    return _world("sp", tmp_path_factory)


# -- the JAX oracle -----------------------------------------------------------

@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models import gpt as jgpt
    from horovod_tpu.ops import collectives as jC
    jring = importlib.import_module("horovod_tpu.parallel.ring_attention")
    from horovod_tpu.parallel import spec as jspec
    from horovod_tpu.parallel import tensor_parallel as jtp
    from horovod_tpu.parallel import ulysses as jul

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax, gpt=jgpt,
                                 C=jC, ring=jring, spec=jspec, tp=jtp,
                                 ul=jul)


def _jax_mesh(J, dims, names, fn, *stacked, replicated=()):
    """``fn(*replicated, *rank_rows)`` on each rank's row of ``stacked``
    under shard_map on a mesh of ``dims`` (slow first) named ``names``,
    rank r on device r; outputs stacked by rank (pytrees allowed)."""
    from jax.sharding import Mesh, PartitionSpec as P

    n = int(np.prod(dims))
    mesh = Mesh(np.array(J.jax.devices()[:n]).reshape(dims), names)

    def body(*args):
        rep, blocks = args[:len(replicated)], args[len(replicated):]
        outs = fn(*rep, *[b[0] for b in blocks])
        return J.jax.tree.map(lambda o: o[None], outs)

    f = J.jax.jit(J.jax.shard_map(
        body, mesh=mesh,
        in_specs=tuple(P() for _ in replicated)
        + tuple(P(names) for _ in stacked),
        out_specs=P(names), check_vma=False))
    outs = f(*[J.jax.tree.map(J.jnp.asarray, r) for r in replicated],
             *[J.jnp.asarray(s) for s in stacked])
    return J.jax.tree.map(np.asarray, outs)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _rank_rows(world, key):
    return np.stack([r[key] for r in world])


# -- ParallelSpec, the layout, the raising names ------------------------------

@pytest.mark.parametrize("form", ["dp=2,tp=2", {"dp": 2, "sp": 2},
                                  "dp=2,pp=2,tp=2", " dp=8 ", "sp=4,dp=2"])
def test_parallel_spec_matches_jax(J, form):
    got, want = ParallelSpec.resolve(form), J.spec.ParallelSpec.resolve(form)
    assert got.dims == want.dims and got.describe() == want.describe()
    for attr in ("roles", "sizes", "total", "dp_axes", "pp_axis", "tp_axis",
                 "ep_axis", "sp_axis", "replica_ranks"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for r in range(got.total):
        assert got.coords(r) == want.coords(r)
        assert got.role_label(r) == want.role_label(r)
        assert got.replica_of(r) == want.replica_of(r)
    g, w = got.grad_route(), want.grad_route()
    assert (g is None) == (w is None)
    if g is not None:
        assert g.describe() == w.describe()


@pytest.mark.parametrize("bad", ["dp=2,zz=2", "dp=2,dp=2", "dp=0", "dp2",
                                 ""])
def test_parallel_spec_validation_matches_jax(J, bad):
    with pytest.raises(ValueError):
        J.spec.ParallelSpec.parse(bad)
    with pytest.raises(ValueError):
        ParallelSpec.parse(bad)


def test_spec_from_env_and_axis_order(J, monkeypatch):
    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu_torch.parallel import spec as tspec

    assert mesh_lib.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tspec.ROLES == J.spec.ROLES
    env = {"HVD_TPU_PARALLEL": "dp=2,tp=4"}
    assert tspec.spec_from_env(env) == ParallelSpec.parse("dp=2,tp=4")
    assert tspec.spec_from_env({}) is None
    with pytest.raises(ValueError):
        tspec.spec_from_env({"HVD_TPU_PARALLEL": "dp=x"})


@pytest.mark.parametrize("n", [2, 4])
def test_stripe_layout_round_trip_matches_jax(J, n):
    x = np.random.default_rng(n).standard_normal((2, 16, 3)).astype(
        np.float32)
    got = ring.stripe_layout(torch.from_numpy(x), n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.ring.stripe_layout(J.jnp.asarray(x), n)))
    np.testing.assert_array_equal(ring.unstripe_layout(got, n).numpy(), x)


def test_later_roles_raise_naming_their_slice():
    """The pipeline, MoE and respec names are ported (slice 16) and the
    optimizers take pp and ep specs and zero_stage with a spec: outside a
    world made with the spec they ask for it (here: no world at all). The
    role-aware elastic driver path is ported: under ``HVD_TPU_PARALLEL``
    an epoch runs, and an autoscale floor that splits a replica fails the
    launch naming the roles. The tp model's KV-cache path is ported."""
    import horovod_tpu_torch.parallel as P
    from horovod_tpu_torch.runner import elastic_driver

    for name in ("pipeline_apply", "pipeline_train_step_1f1b",
                 "pipeline_accumulate_gradients", "select_last_stage",
                 "moe_layer", "top2_gating", "solve_respec",
                 "RespecDecision", "min_world"):
        assert callable(getattr(P, name)), name
    m = torch.nn.Linear(2, 2)
    for spec in ("dp=2,pp=2", "dp=2,ep=2"):
        with pytest.raises(hvd.NotInitializedError):
            hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=1),
                                     parallel=spec)
    with pytest.raises(hvd.NotInitializedError):
        hvd.ZeroOptimizer(torch.optim.SGD(m.parameters(), lr=1),
                          parallel="dp=2")
    with pytest.raises(hvd.NotInitializedError):
        hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=1),
                                 zero_stage=1, parallel="dp=2,tp=2")
    args = types.SimpleNamespace(min_np=2, max_np=2, num_proc=2,
                                 host_discovery_script=None, hosts=None)
    assert elastic_driver.run_elastic(
        args, ["true"], {"HVD_TPU_PARALLEL": "dp=1,pp=2"},
        discovery=elastic_driver.FixedHostDiscovery({"localhost": 2})) == 0
    with pytest.raises(ValueError, match="roles pp=2"):
        elastic_driver.run_elastic(
            types.SimpleNamespace(min_np=3, max_np=4, num_proc=4,
                                  host_discovery_script=None, hosts=None),
            ["true"], {"HVD_TPU_PARALLEL": "dp=2,pp=2",
                       "HVD_TPU_AUTOSCALE_POLICY": '{"enabled": true}'},
            discovery=elastic_driver.FixedHostDiscovery({"localhost": 4}))
    # The tp model with a KV cache is ported: over a tp axis of one
    # rank it decodes as the dense model does; over a mesh axis name
    # its cache (this rank's heads) needs the world that names it.
    from horovod_tpu_torch.common.topology import Axis

    mm = gpt.gpt_tiny(tp_axis=Axis("tp", None, 1, 0, (0,)))
    dense = gpt.gpt_tiny()
    dense.load_state_dict(mm.state_dict())
    toks = torch.tensor([[3, 5, 7, 2]])
    got, cache = mm(toks, gpt.init_kv_cache(mm, 1, 8, device="cpu"))
    want, _ = dense(toks, gpt.init_kv_cache(dense, 1, 8, device="cpu"))
    assert cache["layers"][0]["k"].shape == (1, 8, 4, 16)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    with pytest.raises(hvd.NotInitializedError):
        gpt.init_kv_cache(gpt.gpt_tiny(tp_axis="tp"), 1, 4, device="cpu")


# -- the tp world ---------------------------------------------------------------

def test_parallel_mesh_and_role(world_tp):
    for r, res in enumerate(world_tp):
        dp, ti = divmod(r, 2)
        np.testing.assert_array_equal(
            res["mesh"], [[2, dp, ti, ti + 2], [2, ti, 2 * dp, 2 * dp + 1]])
        assert str(res["role"]) == f"dp{dp}/tp{ti}"


def test_tp_primitives_match_jax(J, world_tp):
    d = _data()
    jtp = J.tp

    def fn(w1, b1, w2, b2, x, cot):
        def loss(x, w1, b1, w2, b2):
            y = jtp.tp_mlp(x, jtp.shard_column(w1, "tp"),
                           jtp.shard_column(b1, "tp"),
                           jtp.shard_row(w2, "tp"), b2, "tp")
            return (y * cot).sum(), y
        (_, y), g = J.jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                         has_aux=True)(x, w1, b1, w2, b2)
        col = jtp.column_parallel(x, jtp.shard_column(w1, "tp"),
                                  jtp.shard_column(b1, "tp"))
        row = jtp.row_parallel(col, jtp.shard_row(w2, "tp"), "tp", b2)
        w3 = jtp.shard_heads(jax_qkv_w, 4, "tp", fused=3)
        qkv = jtp.tp_attention_qkv(x, *(w3[:, j].reshape(16, 8)
                                        for j in range(3)), 2)
        return (y, *g, col, row, w3,
                jtp.shard_heads(jax_qkv_b, 4, "tp", fused=3),
                jtp.shard_head_rows(jax_out_w, 4, "tp"), *qkv,
                jtp.combine_slice_grads(g[1], "tp"))

    jax_qkv_w = J.jnp.asarray(d["qkv_w"])
    jax_qkv_b = J.jnp.asarray(d["qkv_b"])
    jax_out_w = J.jnp.asarray(d["out_w"])
    xs = np.repeat(d["x"], 2, axis=0)
    cots = np.repeat(d["cot"], 2, axis=0)
    want = _jax_mesh(J, (2, 2), ("dp", "tp"), fn, xs, cots,
                     replicated=(d["w1"], d["b1"], d["w2"], d["b2"]))
    keys = ["tp/mlp/y", "tp/mlp/dx", "tp/mlp/dw1", "tp/mlp/db1",
            "tp/mlp/dw2", "tp/mlp/db2", "tp/col", "tp/row", "tp/heads_w",
            "tp/heads_b", "tp/head_rows", "tp/qkv0", "tp/qkv1", "tp/qkv2",
            "tp/combined"]
    for key, w in zip(keys, want):
        _close(_rank_rows(world_tp, key), w)


def _jax_gpt(J, **kw):
    return J.gpt.gpt_tiny(**GPT_KW, **kw)


def _ce(J, logits, y):
    lp = J.jax.nn.log_softmax(logits.astype(J.jnp.float32))
    return -J.jnp.mean(J.jnp.take_along_axis(lp, y[..., None], axis=-1))


def _torch_grads(params_tree):
    """A JAX grads tree as the port's parameter names and layouts."""
    return convert.gpt_params_from_jax(params_tree)


def test_tp_gpt_forward_and_grads_match_jax(J, world_tp):
    """GPT(tp_axis=) against the JAX tp twin: logits, loss and every raw
    per-rank gradient (slice gradients carry the tp factor on both
    sides), on the dense tree converted from the JAX params."""
    d = _data()
    params = _jax_params()
    model = _jax_gpt(J, tp_axis="tp")

    def fn(p, t, y):
        def loss(p):
            logits = model.apply({"params": p}, t)
            return _ce(J, logits, y), logits
        (l, logits), g = J.jax.value_and_grad(loss, has_aux=True)(p)
        return logits, l, g

    toks = np.repeat(d["toks"].reshape(2, 2, 16), 2, axis=0)
    tgts = np.repeat(d["tgts"].reshape(2, 2, 16), 2, axis=0)
    logits, loss, grads = _jax_mesh(J, (2, 2), ("dp", "tp"), fn,
                                    toks.astype(np.int32),
                                    tgts.astype(np.int32),
                                    replicated=(params,))
    _close(_rank_rows(world_tp, "gpt/logits"), logits)
    _close(_rank_rows(world_tp, "gpt/loss"), loss)
    for r in range(4):
        want = _torch_grads(J.jax.tree.map(lambda g: g[r], grads))
        for name, w in want.items():
            _close(world_tp[r][f"gpt/g/{name}"], w.numpy())


def test_tp_gpt_combined_grads_match_dense_jax(J, world_tp):
    """The pmean over tp then dp of the tp twin's gradients is the dense
    JAX model's gradient of the global batch's mean loss, for every
    parameter — sliced or replicated, LayerNorms and the tied embedding
    included: the weights and gradients carry across all forms."""
    d = _data()
    params = _jax_params()
    dense = _jax_gpt(J)
    g = J.jax.grad(lambda p: _ce(J, dense.apply(
        {"params": p}, J.jnp.asarray(d["toks"], J.jnp.int32)),
        J.jnp.asarray(d["tgts"], J.jnp.int32)))(params)
    want = _torch_grads(J.jax.tree.map(np.asarray, g))
    for r in range(4):
        for name, w in want.items():
            np.testing.assert_allclose(world_tp[r][f"gpt/cg/{name}"],
                                       w.numpy(), rtol=GRAD_TOL[0],
                                       atol=GRAD_TOL[1])


def _jax_train(J, hvd, spec_str, model, impl=None):
    """Three AdamW steps of the JAX ``DistributedOptimizer(parallel=)``
    under shard_map; returns the final params and the per-rank losses."""
    d = _data()
    spec = J.spec.ParallelSpec.parse(spec_str)
    mesh = spec.mesh(J.jax.devices()[:4])
    from jax.sharding import PartitionSpec as P

    tx = hvd.DistributedOptimizer(
        J.optax.adamw(ADAMW["lr"], b1=ADAMW["betas"][0],
                      b2=ADAMW["betas"][1], eps=ADAMW["eps"],
                      weight_decay=ADAMW["weight_decay"]), parallel=spec)
    params = J.jax.tree.map(J.jnp.asarray, _jax_params())
    state = tx.init(params)
    toks, tgts = d["toks"].astype(np.int32), d["tgts"].astype(np.int32)
    if impl == "ring":
        toks = np.asarray(J.ring.stripe_layout(J.jnp.asarray(toks), 2))
        tgts = np.asarray(J.ring.stripe_layout(J.jnp.asarray(tgts), 2))

    def step(p, st, t, y):
        loss, g = J.jax.value_and_grad(
            lambda p: _ce(J, model.apply({"params": p}, t), y))(p)
        upd, st = tx.update(g, st, p)
        return J.optax.apply_updates(p, upd), st, loss[None]

    dspec = spec.data_spec()
    f = J.jax.jit(J.jax.shard_map(
        step, mesh=mesh, in_specs=(P(), P(), dspec, dspec),
        out_specs=(P(), P(), P(tuple(spec.roles))), check_vma=False))
    losses = []
    for _ in range(STEPS):
        params, state, loss = f(params, state, J.jnp.asarray(toks),
                                J.jnp.asarray(tgts))
        losses.append(np.asarray(loss))
    return _torch_grads(J.jax.tree.map(np.asarray, params)), \
        np.stack(losses, axis=1)


def test_tp_optimizer_three_adamw_steps_match_jax(J, hvd, world_tp):
    want, losses = _jax_train(J, hvd, "dp=2,tp=2", _jax_gpt(J, tp_axis="tp"))
    for r in range(4):
        _close(world_tp[r]["opt/losses"], losses[r], 1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(world_tp[r][f"opt/p/{name}"],
                                       w.numpy(), atol=STEP_TOL, rtol=0)
        if r:   # the replicated masters agree bitwise across the world
            for name in want:
                np.testing.assert_array_equal(world_tp[r][f"opt/p/{name}"],
                                              world_tp[0][f"opt/p/{name}"])


# -- the sequence functions -------------------------------------------------------

def _seq_oracle(J, n, fn_of, kind):
    """The JAX function over an ``sp`` ring of n on the groups' q/k/v:
    outputs and q/k/v gradients per rank (n = 2: a (dp, sp) mesh of two
    rings; n = 4: one ring)."""
    d = _data()
    groups = 2 if n == 2 else 1
    s = S // n
    rows = {k: [] for k in ("q", "k", "v", "do")}
    masks = []
    for gi in range(groups):
        for i in range(n):
            for k in rows:
                x = d[k][gi]
                if kind == "striped":
                    x = np.asarray(J.ring.stripe_layout(J.jnp.asarray(x), n))
                rows[k].append(x[:, i * s:(i + 1) * s])
            masks.append(d["mask"][:, i * s:(i + 1) * s])
    stacked = [np.stack(rows[k]) for k in ("q", "k", "v", "do")]

    def fn(q, k, v, do, m):
        def loss(q, k, v):
            y = fn_of(q, k, v, m)
            return (y * do).sum(), y
        (_, y), g = J.jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
        return (y, *g)

    dims, names = ((2, 2), ("dp", "sp")) if n == 2 else ((4,), ("sp",))
    return _jax_mesh(J, dims, names, fn, *stacked, np.stack(masks))


def _check_seq(world, J, n, name, fn_of, kind, tol=TOL):
    want = _seq_oracle(J, n, fn_of, kind)
    for part, w in zip(("y", "dq", "dk", "dv"), want):
        _close(_rank_rows(world, f"n{n}/{name}/{part}"), w, tol)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", ["plain", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_with_key_mask_matches_jax(J, world_tp, n, form,
                                                  causal):
    """Ring attention (contiguous shards, the key mask rotating with its
    block) in both forms against the JAX ring, forward and q/k/v
    gradients."""
    _check_seq(world_tp, J, n, f"ring/{form}/c{int(causal)}",
               lambda q, k, v, m: J.ring.ring_attention(
                   q, k, v, "sp", causal=causal, mask=m, wire="none"),
               "contig")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", ["plain", "flash"])
def test_striped_attention_matches_jax(J, world_tp, n, form):
    """The striped ring, the flash form's strict blocks (rolled K/V, key
    0 masked: a fully masked query row weighed out) included, forward
    and gradients."""
    _check_seq(world_tp, J, n, f"striped/{form}",
               lambda q, k, v, m: J.ring.striped_attention(
                   q, k, v, "sp", wire="none"), "striped")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_striped_lossy_wires_within_jax_bounds(J, world_tp, n, wire):
    """The JAX tests' wire bounds against the exact oracle (the int8
    draws differ from jax.random's, so the bound, not the bits)."""
    want = _seq_oracle(J, n, lambda q, k, v, m: J.ring.striped_attention(
        q, k, v, "sp", wire="none"), "striped")
    err = np.abs(_rank_rows(world_tp, f"n{n}/striped/wire/{wire}/y")
                 - want[0])
    assert float(err.max()) < WIRE_TOL[wire]
    for part, w in zip(("dq", "dk", "dv"), want[1:]):
        g = _rank_rows(world_tp, f"n{n}/striped/wire/{wire}/{part}")
        assert np.isfinite(g).all()
        assert float(np.abs(g - w).max()) < WIRE_TOL[wire] * (
            1 + np.abs(w).max())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(J, world_tp, n, causal):
    from horovod_tpu.models.gpt import _causal_attend

    name = "ulysses/causal" if causal else "ulysses"
    _check_seq(world_tp, J, n, name,
               lambda q, k, v, m: J.ul.ulysses_attention(
                   q, k, v, "sp", attend_fn=_causal_attend if causal
                   else None, wire="none"), "contig")


@pytest.mark.parametrize("n", [2, 4])
def test_seq_kv_bytes_int8_cuts_4x(world_tp, n):
    for r in world_tp:
        fp32, i8 = float(r[f"n{n}/bytes/none"]), float(r[f"n{n}/bytes/int8"])
        assert fp32 == (n - 1) * 2 * B * (S // n) * H * D * 4
        assert 3.9 <= fp32 / i8 < 4.0


def test_mesh_alltoall_matches_jax_on_2x2(J, world_tp):
    d = _data()

    def fn(x):
        def f(x):
            y = J.C.mesh_alltoall(x, J.C.WirePlan.parse("tp:none,dp:none"))
            return (y * J.jnp.arange(y.size, dtype=J.jnp.float32).reshape(
                y.shape)).sum(), y
        (_, y), g = J.jax.value_and_grad(f, has_aux=True)(x)
        q = J.C.mesh_alltoall(x, J.C.WirePlan.parse("tp:int8,dp:bf16"))
        return y, g, q

    y, g, q = _jax_mesh(J, (2, 2), ("dp", "tp"), fn, d["a2a"])
    np.testing.assert_array_equal(_rank_rows(world_tp, "a2a/none"), y)
    np.testing.assert_array_equal(_rank_rows(world_tp, "a2a/none/dx"), g)
    got = _rank_rows(world_tp, "a2a/int8")
    scale = np.abs(d["a2a"]).max() / 127
    assert float(np.abs(got - q).max()) <= 2 * scale


# -- the sp world -------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_gpt_forward_and_grads_match_jax(J, world_sp, impl):
    """GPT(seq_parallel=, seq_impl=) against the JAX sp twin: logits,
    loss and raw per-rank gradients (ring on stripe-laid tokens, Ulysses
    on contiguous shards), RoPE at this rank's global positions."""
    d = _data()
    params = _jax_params()
    model = _jax_gpt(J, seq_parallel="sp", seq_impl=impl, seq_wire="none")

    def fn(p, t, y):
        def loss(p):
            logits = model.apply({"params": p}, t)
            return _ce(J, logits, y), logits
        (l, logits), g = J.jax.value_and_grad(loss, has_aux=True)(p)
        return logits, l, g

    rows_t, rows_y = [], []
    for r in range(4):
        dp, si = divmod(r, 2)
        t, y = d["toks"][2 * dp:2 * dp + 2], d["tgts"][2 * dp:2 * dp + 2]
        if impl == "ring":
            t, y = (np.asarray(J.ring.stripe_layout(J.jnp.asarray(a), 2))
                    for a in (t, y))
        rows_t.append(t[:, si * 8:(si + 1) * 8])
        rows_y.append(y[:, si * 8:(si + 1) * 8])
    logits, loss, grads = _jax_mesh(
        J, (2, 2), ("dp", "sp"), fn, np.stack(rows_t).astype(np.int32),
        np.stack(rows_y).astype(np.int32), replicated=(params,))
    _close(_rank_rows(world_sp, f"{impl}/logits"), logits)
    _close(_rank_rows(world_sp, f"{impl}/loss"), loss)
    for r in range(4):
        want = _torch_grads(J.jax.tree.map(lambda g: g[r], grads))
        for name, w in want.items():
            _close(world_sp[r][f"{impl}/g/{name}"], w.numpy())


def test_sp_optimizer_three_adamw_steps_match_jax(J, hvd, world_sp):
    want, losses = _jax_train(J, hvd, "dp=2,sp=2", _jax_gpt(
        J, seq_parallel="sp", seq_impl="ring", seq_wire="none"), "ring")
    for r in range(4):
        _close(world_sp[r]["opt/losses"], losses[r], 1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(world_sp[r][f"opt/p/{name}"],
                                       w.numpy(), atol=STEP_TOL, rtol=0)
            np.testing.assert_array_equal(world_sp[r][f"opt/p/{name}"],
                                          world_sp[0][f"opt/p/{name}"])


if __name__ == "__main__" and sys.argv[1:2] == ["--parallel-worker"]:
    _parallel_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
