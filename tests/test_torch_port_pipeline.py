"""The port's pipeline against the JAX package's: the 1F1B schedule
(``pipeline_accumulate_gradients`` in the chain and the GPT forms,
``pipeline_train_step_1f1b``), GPipe's ``pipeline_apply`` with
``select_last_stage``, the stage-boundary wires and byte counter, and the
hybrid optimizers over pp (``DistributedOptimizer(parallel=)``, ZeRO-3
per stage, sp inside the stages), plus per-layer remat.

* Gloo ranks on the CPU, each a process running this file with
  ``--pipeline-worker RANK OUT PARAMS.npz``: one world made with
  ``init(parallel="dp=2,pp=2")``, then, in the same processes, one with
  ``"dp=1,pp=2,sp=2"`` (the JAX oracles use 8 devices for dp=2,pp=2,sp=2).
  Each pp rank holds only its stage. The worlds run once per test
  session (``session_world``: one xdist worker runs them, the others
  read their output).
* The oracle is the JAX function under ``shard_map(check_vma=False)`` on
  a ``("pp",)`` mesh of the conftest's CPU devices, fed the same seeded
  numpy inputs (the GPT weights are the JAX model's, carried across by
  ``convert.gpt_stage_params_from_jax``).
* Tolerances: against JAX, fp32 rtol and atol ``TOL`` = 2e-5; against
  the port's own single-process ``accumulate_gradients`` the loss and
  the stage gradients are BITWISE (the same operations in the same
  order), the shared embedding/head gradients within 1e-7 absolute (the
  pipeline sums the head half and the embedding half after the
  microbatch sums; one backward adds them per microbatch: fp32 addition
  order, as the JAX test allows); the lossy wires by the JAX test's
  bounds (loss rtol 0.1, gradients rtol 0.5 atol 0.05); sp inside the
  stages against the dense loss to 1e-4 (the JAX test's); ZeRO-3 per
  stage bitwise against the replicated optimizer (an elementwise
  optimizer on a sum of two terms).

JAX is imported only inside the ``J`` fixture: the worker processes
import this file and must not pay for it.
"""

import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import metrics as metrics_lib
from horovod_tpu_torch.models import convert, gpt
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.optim import accumulate_gradients
from horovod_tpu_torch.parallel import pipeline as pl
from horovod_tpu_torch.parallel.mesh import local_batch
from test_torch_port_worlds import run_ranks, session_world

TOL = 2e-5
SHARED_ATOL = 1e-7
WIRE_LOSS_RTOL, WIRE_GRAD = 0.1, (0.5, 0.05)
SP_LOSS_TOL = 1e-4
GPT_KW = dict(num_layers=2, hidden=64, num_heads=4, mlp_dim=128,
              vocab_size=128)
# The JAX test's acceptance model: its full parameters exceed the
# simulated single-replica budget, each pipeline rank's resident tree
# (its stage + the shared embedding/head) fits.
BIG_KW = dict(num_layers=8, hidden=128, num_heads=4, mlp_dim=512,
              vocab_size=512)
REPLICA_BUDGET_BYTES = 4 * 1024 * 1024
WIRE_CHAIN = dict(n=2, d=8, mb=2, k=4)


def _data():
    g = np.random.default_rng(1616)

    def normal(*shape, scale=1.0):
        return (g.standard_normal(shape) * scale).astype(np.float32)

    out = {"Ws": normal(2, 6, 6, scale=0.3),
           "Ww": normal(2, 8, 8, scale=0.3),
           "Xw": normal(8, 8), "Yw": normal(8, 8),
           "Wa": normal(2, 8, 8, scale=0.4), "xa": normal(4, 2, 8),
           "toks": g.integers(0, 128, (4, 16)).astype(np.int64),
           "tgts": g.integers(0, 128, (4, 16)).astype(np.int64),
           "big_toks": g.integers(0, 512, (8, 16)).astype(np.int64),
           "big_tgts": g.integers(0, 512, (8, 16)).astype(np.int64)}
    for k in (2, 5):
        out[f"X{k}"] = normal(k * 3, 6)
        out[f"Y{k}"] = normal(k * 3, 6)
    return out


def _jax_params(J, kw, seed=0):
    """The dense JAX GPT's params (numpy leaves)."""
    m = J.gpt.gpt_tiny(**kw)
    params = m.init(J.jax.random.PRNGKey(seed), np.zeros((1, 16), np.int32))
    return J.jax.tree.map(np.asarray, params)["params"]


# -- the rank worker ----------------------------------------------------------

def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _tanh_stage(w, x):
    return torch.tanh(x @ w)


def _sq_sum(o, y):
    return ((o - y) ** 2).sum()


def _sq_mean(o, y):
    return ((o - y) ** 2).mean()


def _act_bytes():
    return dict(pl.ACTIVATION_BYTES)


def _counter(name):
    out = {}
    for s in metrics_lib.snapshot().get(name, {}).get("samples", []):
        out[tuple(sorted(s["labels"].items()))] = float(s["value"])
    return out


def _delta(before, after):
    """The series that grew, as ``"axis/wire"``."""
    return {f"{dict(k)['axis']}/{dict(k)['wire']}": v - before.get(k, 0.0)
            for k, v in after.items() if v - before.get(k, 0.0) > 0}


def _chain_cases(out, d, s):
    """The homogeneous chain over the pp axis: 1F1B at k = 2 and 5 (and
    the single-process accumulate reference of the whole chain), the
    train step, the wires and the counter, GPipe with its gradient."""
    for k in (2, 5):
        w = _t(d["Ws"][s], grad=True)
        vg = pl.pipeline_accumulate_gradients(_tanh_stage, _sq_sum,
                                              accum_steps=k, axis_name="pp")
        loss, g = vg(w, _t(d[f"X{k}"]), _t(d[f"Y{k}"]))
        out[f"chain{k}/loss"], out[f"chain{k}/g"] = loss, g
        out[f"chain{k}/dot_grad"] = w.grad
        ws = [_t(d["Ws"][i], grad=True) for i in range(2)]

        def full_loss(x, y):
            a = x
            for wi in ws:
                a = _tanh_stage(wi, a)
            return _sq_sum(a, y)

        ref = accumulate_gradients(full_loss, accum_steps=k)(
            _t(d[f"X{k}"]), _t(d[f"Y{k}"]))
        out[f"chain{k}/ref_loss"], out[f"chain{k}/ref_g"] = ref, ws[s].grad
    # pipeline_train_step_1f1b: the SUM of the losses, param-dtype grads.
    w = _t(d["Ws"][s], grad=True)
    xm = _t(d["X2"]).reshape(2, 3, 6)
    ym = _t(d["Y2"]).reshape(2, 3, 6)
    g, loss_sum = pl.pipeline_train_step_1f1b(_tanh_stage, _sq_sum, w, xm,
                                              ym, "pp")
    out["step/g"], out["step/loss_sum"] = g, loss_sum
    # The wires: the same chain in none, bf16, int8; the counter's bytes.
    for wire in ("none", "bf16", "int8"):
        w = _t(d["Ww"][s], grad=True)
        vg = pl.pipeline_accumulate_gradients(
            _tanh_stage, _sq_mean, accum_steps=WIRE_CHAIN["k"],
            axis_name="pp", wire=wire)
        a0, m0 = _act_bytes(), _counter(
            "hvd_tpu_pipeline_activation_bytes_total")
        r0 = _counter("hvd_tpu_allreduce_bytes_total")
        loss, g = vg(w, _t(d["Xw"]), _t(d["Yw"]))
        out[f"wire/{wire}/loss"], out[f"wire/{wire}/g"] = loss, g
        out[f"wire/{wire}/bytes"] = np.array(
            _act_bytes().get("pp", 0.0) - a0.get("pp", 0.0))
        out[f"wire/{wire}/labels"] = np.array(sorted(_delta(
            m0, _counter("hvd_tpu_pipeline_activation_bytes_total"))))
        out[f"wire/{wire}/reduce_labels"] = np.array(sorted(_delta(
            r0, _counter("hvd_tpu_allreduce_bytes_total"))))
    # GPipe: autodiff through pipeline_apply and select_last_stage.
    for wire in ("none", "int8"):
        w = _t(d["Wa"][s], grad=True)
        a0 = _act_bytes()
        outs = pl.select_last_stage(
            pl.pipeline_apply(_tanh_stage, w, _t(d["xa"]), "pp", wire=wire),
            "pp")
        (outs ** 2).sum().backward()
        out[f"apply/{wire}/outs"], out[f"apply/{wire}/g"] = outs, w.grad
        out[f"apply/{wire}/bytes"] = np.array(
            _act_bytes().get("pp", 0.0) - a0.get("pp", 0.0))


def _stage_state(params, s, n_stages):
    """Stage ``s``'s state dict from the dense JAX params (numpy), through
    the JAX stacked layout ``(num_stages, lps, ...)``."""
    keys = sorted((k for k in params if k.startswith("layer")),
                  key=lambda k: int(k[len("layer"):]))
    lps = len(keys) // n_stages

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*[nd[k] for nd in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    stages = stack(*[stack(*[params[keys[i * lps + j]] for j in range(lps)])
                     for i in range(n_stages)])
    shared = {k: v for k, v in params.items() if not k.startswith("layer")}
    return convert.gpt_stage_params_from_jax(stages, shared, s)


def _gpt_case(out, d, params, s):
    """The GPT form (embedding + tied head at the two ends) against the
    port's single-process accumulate of the whole model."""
    m = gpt.gpt_tiny(**dict(GPT_KW, num_layers=1))
    m.load_state_dict(_stage_state(params, s, 2))
    sf, pf, lf = gpt.pipeline_fns(m)
    vg = pl.pipeline_accumulate_gradients(sf, lf, accum_steps=2,
                                          axis_name="pp", pre_fn=pf)
    toks, tgts = _t(d["toks"]), _t(d["tgts"])
    loss, g = vg({"stages": gpt.stage_params(m),
                  "shared": gpt.shared_params(m)}, toks, tgts)
    out["gpt/loss"] = loss
    for name, v in list(g["stages"].items()) + list(g["shared"].items()):
        out[f"gpt/g/{name}"] = v
    full = gpt.gpt_tiny(**GPT_KW)
    full.load_state_dict(convert.gpt_params_from_jax(params))
    ref = accumulate_gradients(
        lambda x, y: gpt.next_token_loss(full(x), y), accum_steps=2)(
        toks, tgts)
    out["gpt/ref_loss"] = ref
    for name, p in full.named_parameters():
        out[f"gpt/ref_g/{name}"] = p.grad


def _hybrid_run(d, params, spec, s, steps, zero=False, bytes_out=None):
    """``steps`` Adam steps of the acceptance GPT's stage ``s`` under
    ``DistributedOptimizer(parallel=spec)`` (or ZeRO-3 per stage) on this
    rank's dp rows; returns the global losses and the stage's masters."""
    m = gpt.gpt_tiny(**dict(BIG_KW, num_layers=BIG_KW["num_layers"] // 2))
    m.load_state_dict(_stage_state(params, s, 2))
    sf, pf, lf = gpt.pipeline_fns(m)
    vg = pl.pipeline_accumulate_gradients(sf, lf, accum_steps=2,
                                          axis_name="pp", pre_fn=pf)
    pspec = hvd.parallel_spec()
    rank = hvd.rank()
    x = local_batch(_t(d["big_toks"]), pspec, rank)
    y = local_batch(_t(d["big_tgts"]), pspec, rank)
    base = torch.optim.Adam(m.parameters(), lr=1e-2)
    if zero:
        opt = hvd.ZeroOptimizer(base, zero_stage=3, parallel=spec)
    else:
        opt = hvd.DistributedOptimizer(base, parallel=spec,
                                       named_parameters=m.named_parameters())
    act0, red0 = _act_bytes(), _counter("hvd_tpu_allreduce_bytes_total")
    tree = {"stages": gpt.stage_params(m), "shared": gpt.shared_params(m)}
    losses = []
    for _ in range(steps):
        if zero:
            opt.gather_params()
        else:
            opt.zero_grad()
        loss, _ = vg(tree, x, y)
        opt.step()
        losses.append(float(C.allreduce(loss.reshape(1), C.Average,
                                        axis="dp")))
    if zero:
        opt.gather_params()
    masters = torch.cat([p.detach().reshape(-1) for p in m.parameters()])
    if bytes_out is not None:
        bytes_out["act"] = _act_bytes().get("pp", 0.0) - act0.get("pp", 0.0)
        bytes_out["reduce"] = sorted(_delta(red0, _counter(
            "hvd_tpu_allreduce_bytes_total")))
        if zero:
            snap = metrics_lib.snapshot().get(
                "hvd_tpu_zero_param_bytes_resident", {}).get("samples", [])
            bytes_out["resident"] = [v["value"] for v in snap
                                     if v["labels"].get("stage") == "3"]
    if not zero:
        for h in opt._dist_hooks:
            h.remove()
    return np.array(losses), masters


def _world_dp_pp(out, rank, params, big):
    hvd.init(device="cpu", parallel="dp=2,pp=2")
    s = hvd.parallel_spec().coords(rank)["pp"]
    d = _data()
    _chain_cases(out, d, s)
    _gpt_case(out, d, params, s)
    info = {}
    out["hyb/losses"], out["hyb/masters"] = _hybrid_run(
        d, big, "dp=2,pp=2", s, 6, bytes_out=info)
    out["hyb/act_bytes"] = np.array(info["act"])
    out["hyb/reduce_labels"] = np.array(info["reduce"])
    out["hyb2/losses"], out["hyb2/masters"] = _hybrid_run(
        d, big, "dp=2,pp=2", s, 6)
    zinfo = {}
    out["z3/losses"], out["z3/masters"] = _hybrid_run(
        d, big, "dp=2,pp=2", s, 3, zero=True, bytes_out=zinfo)
    out["z3/resident"] = np.array(zinfo["resident"][-1:])
    out["z3b/losses"], out["z3b/masters"] = _hybrid_run(
        d, big, "dp=2,pp=2", s, 3, zero=True)
    out["rep3/losses"], out["rep3/masters"] = _hybrid_run(
        d, big, "dp=2,pp=2", s, 3)
    stage = gpt.gpt_tiny(**dict(BIG_KW, num_layers=4))
    out["stage_bytes"] = np.array(gpt.param_bytes(stage))
    hvd.shutdown()


def _world_sp(out, rank, params):
    """dp=1 x pp=2 x sp=2: Ulysses inside each stage; the ZeRO-3 run with
    the int8 sequence wire, twice."""
    spec = "dp=1,pp=2,sp=2"
    hvd.init(device="cpu", parallel=spec)
    pspec = hvd.parallel_spec()
    s = pspec.coords(rank)["pp"]
    d = _data()
    x = local_batch(_t(d["toks"]), pspec, rank)
    y = local_batch(_t(d["tgts"]), pspec, rank)
    kw = dict(GPT_KW, num_layers=1, seq_parallel="sp", seq_impl="ulysses")
    m = gpt.gpt_tiny(seq_wire="none", **kw)
    m.load_state_dict(_stage_state(params, s, 2))
    sf, pf, lf = gpt.pipeline_fns(m)
    vg = pl.pipeline_accumulate_gradients(sf, lf, accum_steps=2,
                                          axis_name="pp", pre_fn=pf)
    loss, _ = vg({"stages": gpt.stage_params(m),
                  "shared": gpt.shared_params(m)}, x, y)
    out["sp/loss"] = C.allreduce(loss.reshape(1), C.Average, axis="sp")
    for rep in (0, 1):
        m = gpt.gpt_tiny(seq_wire="int8", **kw)
        m.load_state_dict(_stage_state(params, s, 2))
        sf, pf, lf = gpt.pipeline_fns(m)
        vg = pl.pipeline_accumulate_gradients(sf, lf, accum_steps=2,
                                              axis_name="pp", pre_fn=pf)
        opt = hvd.ZeroOptimizer(torch.optim.Adam(m.parameters(), lr=1e-2),
                                zero_stage=3, parallel=spec)
        tree = {"stages": gpt.stage_params(m),
                "shared": gpt.shared_params(m)}
        losses = []
        for _ in range(2):
            opt.gather_params()
            loss, _ = vg(tree, x, y)
            opt.step()
            losses.append(float(C.allreduce(loss.reshape(1), C.Average,
                                            axis="sp")))
        digest = sum(float(t.abs().sum()) for t in opt.shard_state.shards)
        out[f"spz{rep}/losses"] = np.array(losses)
        out[f"spz{rep}/digest"] = np.array(digest)
    hvd.shutdown()


def _pipeline_worker(rank: int, out_path: str, params_path: str) -> None:
    out = {}
    loaded = np.load(params_path, allow_pickle=True)
    params, big = loaded["params"].item(), loaded["big"].item()
    _world_dp_pp(out, rank, params, big)
    _world_sp(out, rank, params)
    np.savez(out_path, **{k: v.detach().numpy()
                          if isinstance(v, torch.Tensor) else v
                          for k, v in out.items()})


_WORLD = []


@pytest.fixture()
def world(tmp_path_factory, J):
    def run(out):
        pfile = out / "params.npz"
        np.savez(pfile, params=np.array(_jax_params(J, GPT_KW),
                                        dtype=object),
                 big=np.array(_jax_params(J, BIG_KW, seed=42),
                              dtype=object))
        run_ranks(__file__, lambda r: ("--pipeline-worker", r,
                                       out / f"rank{r}.npz", pfile), 4,
                  timeout=300)

    if not _WORLD:
        out = session_world(tmp_path_factory, "pipeline", run)
        _WORLD.extend(dict(np.load(out / f"rank{r}.npz"))
                      for r in range(4))
    return _WORLD


# -- the JAX oracle -----------------------------------------------------------

@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import gpt as jgpt
    from horovod_tpu.optim import accumulate_gradients as jaccum
    from horovod_tpu.parallel import pipeline as jpl

    return types.SimpleNamespace(jax=jax, jnp=jnp, gpt=jgpt, pl=jpl,
                                 accum=jaccum)


def _pp_mesh(J, n=2):
    from jax.sharding import Mesh

    return Mesh(np.array(J.jax.devices()[:n]), ("pp",))


def _jax_chain(J, Ws, X, Y, k, loss_fn, wire="none"):
    from jax.sharding import PartitionSpec as P

    jnp = J.jnp
    vg = J.pl.pipeline_accumulate_gradients(
        lambda w, x: jnp.tanh(x @ w), loss_fn, accum_steps=k,
        axis_name="pp", wire=wire)

    def wrapped(w, x, y):
        loss, g = vg(w[0], x, y)
        return loss, g[None]

    f = J.jax.jit(J.jax.shard_map(wrapped, mesh=_pp_mesh(J),
                                  in_specs=(P("pp"), P(), P()),
                                  out_specs=(P(), P("pp")),
                                  check_vma=False))
    loss, g = f(jnp.asarray(Ws), jnp.asarray(X), jnp.asarray(Y))
    return np.asarray(loss), np.asarray(g)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# -- the chain ---------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 5])
def test_1f1b_chain_matches_jax_and_own_accumulate(world, J, k):
    """Mirrors ``test_1f1b_scan_bitwise_vs_accum_reference`` (n = 2): the
    mean loss and mean stage gradients against the JAX schedule, and
    bitwise against the port's single-process accumulate of the chain;
    the gradients also land in ``.grad``."""
    d = _data()
    want_l, want_g = _jax_chain(J, d["Ws"], d[f"X{k}"], d[f"Y{k}"], k,
                                lambda o, y: ((o - y) ** 2).sum())
    for r, res in enumerate(world):
        s = r % 2
        _close(res[f"chain{k}/loss"], want_l)
        _close(res[f"chain{k}/g"], want_g[s])
        assert np.array_equal(res[f"chain{k}/loss"], res[f"chain{k}/ref_loss"])
        assert np.array_equal(res[f"chain{k}/g"], res[f"chain{k}/ref_g"])
        assert np.array_equal(res[f"chain{k}/dot_grad"], res[f"chain{k}/g"])


def test_train_step_1f1b_matches_jax(world, J):
    """``pipeline_train_step_1f1b``: the summed-loss gradients of each
    stage and the loss sum on the last stage (zero elsewhere)."""
    from jax.sharding import PartitionSpec as P

    d = _data()
    jnp = J.jnp

    def body(w, x, y):
        g, ls = J.pl.pipeline_train_step_1f1b(
            lambda ww, a: jnp.tanh(a @ ww), lambda o, t: ((o - t) ** 2).sum(),
            w[0], x, y, "pp")
        return g[None], ls[None]

    f = J.jax.jit(J.jax.shard_map(body, mesh=_pp_mesh(J),
                                  in_specs=(P("pp"), P(), P()),
                                  out_specs=(P("pp"), P("pp")),
                                  check_vma=False))
    g, ls = f(jnp.asarray(d["Ws"]), jnp.asarray(d["X2"].reshape(2, 3, 6)),
              jnp.asarray(d["Y2"].reshape(2, 3, 6)))
    for r, res in enumerate(world):
        s = r % 2
        _close(res["step/g"], np.asarray(g)[s])
        if s == 1:
            _close(res["step/loss_sum"], np.asarray(ls)[1])
        else:
            assert float(res["step/loss_sum"]) == 0.0


def test_1f1b_wire_bf16_int8_close_to_fp32(world):
    """Mirrors ``test_1f1b_wire_bf16_int8_close_to_fp32``: the lossy
    stage-boundary wires train within the JAX test's bounds of the exact
    schedule; the gradients stay nonzero."""
    for res in world:
        l0, g0 = res["wire/none/loss"], res["wire/none/g"]
        for wire in ("bf16", "int8"):
            l, g = res[f"wire/{wire}/loss"], res[f"wire/{wire}/g"]
            assert np.isfinite(l)
            np.testing.assert_allclose(l, l0, rtol=WIRE_LOSS_RTOL)
            np.testing.assert_allclose(g, g0, rtol=WIRE_GRAD[0],
                                       atol=WIRE_GRAD[1])
            assert np.abs(g).sum() > 0


def test_activation_bytes_pp_only_and_int8_ratio(world):
    """Mirrors ``test_activation_byte_counter_pp_axis_only_and_int8_cuts``:
    the schedule stamps bytes on the pp axis only, the gradient-reduction
    counter none; each rank's bytes are exactly its live sends (stage 0
    the k forward activations, stage 1 the k cotangents), and the int8
    wire's bytes are ``_wire_elem_bytes``'s share of fp32's."""
    k, mb, dd = WIRE_CHAIN["k"], WIRE_CHAIN["mb"], WIRE_CHAIN["d"]
    for res in world:
        assert float(res["wire/none/bytes"]) == k * mb * dd * 4
        assert float(res["wire/int8/bytes"]) == \
            k * mb * dd * C._wire_elem_bytes("int8", 4)
        assert float(res["wire/bf16/bytes"]) == k * mb * dd * 2
        if metrics_lib.enabled():
            for wire in ("none", "bf16", "int8"):
                labels = list(res[f"wire/{wire}/labels"])
                assert labels == [f"pp/{wire}"], labels
                assert len(res[f"wire/{wire}/reduce_labels"]) == 0


def test_pipeline_apply_matches_jax_and_int8_grads_flow(world, J):
    """GPipe through autograd (``test_pipeline_apply_int8_wire_grads_flow``):
    the selected outputs and every stage's gradient against JAX at the
    exact wire; under int8 the straight-through gradient reaches every
    stage, finite and nonzero. The counter stamps the JAX planned sends
    ((n_micro + n - 1) payloads)."""
    from jax.sharding import PartitionSpec as P

    d = _data()
    jnp = J.jnp

    def loss(w, x):
        outs = J.pl.select_last_stage(J.pl.pipeline_apply(
            lambda ww, a: jnp.tanh(a @ ww), w[0], x, "pp", wire="none"),
            "pp")
        return (outs ** 2).sum(), outs

    f = J.jax.jit(J.jax.shard_map(
        lambda w, x: (J.jax.grad(lambda ww: loss(ww, x)[0])(w),
                      loss(w, x)[1]),
        mesh=_pp_mesh(J), in_specs=(P("pp"), P()),
        out_specs=(P("pp"), P()), check_vma=False))
    g, outs = f(jnp.asarray(d["Wa"]), jnp.asarray(d["xa"]))
    for r, res in enumerate(world):
        s = r % 2
        _close(res["apply/none/outs"], np.asarray(outs))
        _close(res["apply/none/g"], np.asarray(g)[s])
        gi = res["apply/int8/g"]
        assert np.isfinite(gi).all() and np.abs(gi).sum() > 0
        assert float(res["apply/none/bytes"]) == (4 + 2 - 1) * 2 * 8 * 4


# -- the GPT form -------------------------------------------------------------

def test_1f1b_gpt_hybrid_matches_jax_and_own_accumulate(world, J):
    """Mirrors ``test_1f1b_gpt_hybrid_matches_accum_reference``: each pp
    rank holds one decoder layer and the shared embedding/head; loss and
    gradients against the JAX hybrid form, and against the port's
    single-process accumulate of the whole model (loss and stage grads
    bitwise, shared grads within ``SHARED_ATOL``)."""
    from jax.sharding import PartitionSpec as P

    params = _jax_params(J, GPT_KW)
    d = _data()
    model = J.gpt.gpt_tiny(**GPT_KW)
    stages, shared = J.gpt.stack_stage_params(params, 2)
    stage_fn, pre_fn, loss_fn = J.gpt.pipeline_fns(model)
    vg = J.pl.pipeline_accumulate_gradients(stage_fn, loss_fn,
                                            accum_steps=2, axis_name="pp",
                                            pre_fn=pre_fn)

    def wrapped(st, sh, x, y):
        loss, g = vg({"stages": st, "shared": sh}, x, y)
        return loss, g["stages"], g["shared"]

    f = J.jax.jit(J.jax.shard_map(
        wrapped, mesh=_pp_mesh(J), in_specs=(P("pp"), P(), P(), P()),
        out_specs=(P(), P("pp"), P()), check_vma=False))
    loss, g_st, g_sh = f(stages, shared, J.jnp.asarray(d["toks"]),
                         J.jnp.asarray(d["tgts"]))
    g_st = J.jax.tree.map(np.asarray, g_st)
    g_sh = J.jax.tree.map(np.asarray, g_sh)
    for r, res in enumerate(world):
        s = r % 2
        _close(res["gpt/loss"], np.asarray(loss))
        want = convert.gpt_stage_params_from_jax(g_st, g_sh, s)
        for name, v in want.items():
            _close(res[f"gpt/g/{name}"], v.numpy())
        assert np.array_equal(res["gpt/loss"], res["gpt/ref_loss"])
        for name in want:
            got = res[f"gpt/g/{name}"]
            if name.startswith("layers."):
                j = int(name.split(".")[1]) + s
                ref = res[f"gpt/ref_g/layers.{j}." + name.split(".", 2)[2]]
                assert np.array_equal(got, ref), name
            else:
                np.testing.assert_allclose(got, res[f"gpt/ref_g/{name}"],
                                           rtol=0, atol=SHARED_ATOL)


# -- the hybrid optimizers ----------------------------------------------------

def test_hybrid_pp_dp_trains_model_too_large_for_one_replica(world, J):
    """Mirrors the JAX acceptance: the model's full parameters exceed the
    single-replica budget and each pp rank's resident stage fits; six
    Adam steps under ``DistributedOptimizer(parallel="dp=2,pp=2")``
    lower the loss; the masters agree across each dp pair."""
    big = _jax_params(J, BIG_KW, seed=42)
    full = gpt.gpt_tiny(**BIG_KW)
    full.load_state_dict(convert.gpt_params_from_jax(big))
    assert gpt.param_bytes(full) == J.gpt.param_bytes(big)
    assert gpt.param_bytes(full) > REPLICA_BUDGET_BYTES
    for r, res in enumerate(world):
        assert int(res["stage_bytes"]) < REPLICA_BUDGET_BYTES
        losses = res["hyb/losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        partner = world[r ^ 2]          # the other dp replica, same stage
        assert np.array_equal(res["hyb/masters"], partner["hyb/masters"])


def test_hybrid_bitwise_deterministic_across_seeded_repeats(world):
    for res in world:
        assert np.array_equal(res["hyb/losses"], res["hyb2/losses"])
        assert np.array_equal(res["hyb/masters"], res["hyb2/masters"])


def test_hybrid_byte_accounting_axes(world):
    """Mirrors ``test_hybrid_byte_accounting_axes`` (and the optimizer's
    repair: without a route= the dp reduction goes through the router):
    activation bytes on pp only, gradient-reduction bytes on dp only."""
    if not metrics_lib.enabled():
        pytest.skip("metrics disabled")
    for res in world:
        assert float(res["hyb/act_bytes"]) > 0
        labels = list(res["hyb/reduce_labels"])
        assert labels and all(lab.startswith("dp/") for lab in labels), \
            labels


def test_zero3_shards_live_per_pipeline_stage(world):
    """Mirrors ``test_zero3_shards_live_per_pipeline_stage`` on dp=2,pp=2:
    each stage shards over its own dp pair (resident bytes under half the
    stage's replicated tree), the run repeats bitwise, and it equals the
    replicated ``DistributedOptimizer`` run bitwise."""
    for res in world:
        assert np.isfinite(res["z3/losses"]).all()
        assert np.array_equal(res["z3/losses"], res["z3b/losses"])
        assert np.array_equal(res["z3/masters"], res["z3b/masters"])
        assert np.array_equal(res["z3/losses"], res["rep3/losses"])
        assert np.array_equal(res["z3/masters"], res["rep3/masters"])
        if res["z3/resident"].size:
            assert float(res["z3/resident"][0]) < \
                int(res["stage_bytes"]) / 2 + 1


def test_sp_inside_pipeline_1f1b_matches_dense_loss(world, J):
    """Mirrors ``test_sp_inside_pipeline_1f1b_matches_dense_loss`` on
    dp=1,pp=2,sp=2: Ulysses inside each stage, the sp-averaged 1F1B loss
    against the dense JAX model's cross-entropy on the same batch."""
    params = _jax_params(J, GPT_KW)
    d = _data()
    dense = J.gpt.gpt_tiny(**GPT_KW)
    logits = dense.apply({"params": params}, J.jnp.asarray(d["toks"]))
    lp = J.jax.nn.log_softmax(logits.astype(J.jnp.float32))
    want = float(-J.jnp.mean(J.jnp.take_along_axis(
        lp, J.jnp.asarray(d["tgts"])[..., None], axis=-1)))
    for res in world:
        assert abs(float(res["sp/loss"][0]) - want) < SP_LOSS_TOL


def test_sp_under_zero3_trains_deterministically(world):
    """Mirrors ``test_sp_under_zero3_trains_deterministically`` on
    dp=1,pp=2,sp=2 with the int8 sequence wire: two identical runs give
    identical losses and shard digests, all finite."""
    for res in world:
        assert np.isfinite(res["spz0/losses"]).all()
        assert np.array_equal(res["spz0/losses"], res["spz1/losses"])
        assert float(res["spz0/digest"]) == float(res["spz1/digest"])


# -- single process -----------------------------------------------------------

def test_gpt_remat_matches_plain_bitwise():
    """``GPT(remat=True)`` (each layer under non-reentrant checkpoint)
    against ``remat=False``: the same loss and every gradient, bitwise."""
    g = torch.Generator().manual_seed(16)
    toks = torch.randint(0, 128, (2, 16), generator=g)
    tgts = torch.randint(0, 128, (2, 16), generator=g)
    a = gpt.gpt_tiny(**GPT_KW).init_weights(torch.Generator().manual_seed(1))
    b = gpt.gpt_tiny(remat=True, **GPT_KW)
    b.load_state_dict(a.state_dict())
    la = gpt.next_token_loss(a(toks), tgts)
    lb = gpt.next_token_loss(b(toks), tgts)
    la.backward()
    lb.backward()
    assert torch.equal(la, lb)
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa.grad, pb.grad), n


def test_stack_stage_params_and_pp_wire_default(monkeypatch, J):
    """The stage split matches the JAX layout leaf for leaf, and the
    wire default comes from ``HVD_TPU_PP_WIRE``."""
    params = _jax_params(J, dict(GPT_KW, num_layers=4))
    sd = convert.gpt_params_from_jax(params)
    stages, shared = gpt.stack_stage_params(sd, 2)
    jst, jsh = J.gpt.stack_stage_params(params, 2)
    jst = J.jax.tree.map(np.asarray, jst)
    for s in range(2):
        want = convert.gpt_stage_params_from_jax(jst, jsh, s)
        assert set(want) == set(stages[s]) | set(shared)
        for k, v in want.items():
            got = stages[s].get(k, shared.get(k))
            assert torch.equal(got, v), k
    with pytest.raises(ValueError):
        gpt.stack_stage_params(sd, 3)
    monkeypatch.delenv("HVD_TPU_PP_WIRE", raising=False)
    assert pl._resolve_pp_wire(None) == "none"
    assert pl._resolve_pp_wire("bf16") == "bf16"
    monkeypatch.setenv("HVD_TPU_PP_WIRE", "int8")
    assert pl._resolve_pp_wire(None) == "int8"


def test_config_knobs_match_jax(monkeypatch):
    from horovod_tpu.common.config import Config as JConfig
    from horovod_tpu_torch.common.config import Config

    c, j = Config.from_env(), JConfig()
    for name in ("pp_wire", "moe_wire", "moe_overlap_chunks",
                 "moe_capacity_factor"):
        assert getattr(c, name) == getattr(j, name), name
    # JAX's tool defaults for the mesh degrees and the sequence impl are
    # read by its bench alone; the port has no reader for them.
    for name in ("pp_stages", "tp", "seq_parallel", "seq_impl"):
        assert not hasattr(c, name), name
    monkeypatch.setenv("HVD_TPU_PP_WIRE", "bf16")
    monkeypatch.setenv("HVD_TPU_MOE_CAPACITY_FACTOR", "2.5")
    c = Config.from_env()
    assert c.pp_wire == "bf16" and c.moe_capacity_factor == 2.5


def test_exports_match_jax():
    import horovod_tpu_torch.parallel as P

    for name in ("pipeline_accumulate_gradients", "pipeline_apply",
                 "pipeline_train_step_1f1b", "select_last_stage"):
        assert callable(getattr(hvd, name)) and callable(getattr(P, name))
        assert name in hvd.__all__


if __name__ == "__main__" and sys.argv[1:2] == ["--pipeline-worker"]:
    _pipeline_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
