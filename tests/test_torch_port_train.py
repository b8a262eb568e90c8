"""The port's training path against the JAX package's.

* GPT: ``gpt_tiny`` (fp32) with the flax parameters carried across by
  ``gpt_params_from_jax``: full-sequence logits against ``model.apply``
  and the mean next-token loss and every gradient (mapped back by
  ``gpt_params_to_jax``) against ``jax.value_and_grad`` of the benchmark's
  GPT loss, all within 1e-4. The JAX model attends through its reference
  path off-TPU; the port through the flash kernels' plain versions.
* Fusion: ``plan_fusion`` gives the JAX planner's buckets (leaf indices,
  closing order, shapes, element counts) for ``flatten`` and ``reverse``.
* Data parallel: two gloo ranks on the CPU, each a process running this
  file as a script, train a small MLP with ``DistributedOptimizer`` for
  three steps; the result must match the JAX ``DistributedOptimizer``
  under ``shard_map`` on a 2-device mesh to 1e-5, for Average, Sum,
  ``backward_passes_per_step=2``, fp16 and bf16 compression, the
  predivide factors 2 and 3, and after ``broadcast_parameters`` +
  ``broadcast_optimizer_state``.

JAX is imported lazily (the ``J`` fixture): the worker processes import
this file and must not pay for it.
"""

import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import fusion
from horovod_tpu_torch.models import convert, gpt
from test_torch_port_worlds import run_ranks

GPT_TOL = 1e-4          # logits, loss and gradients, fp32
DP_TOL = 1e-5           # updated parameters, 2-rank DP vs JAX
DP_STEPS = 3
DP_THRESHOLD = 64       # bytes: three fusion buckets for the MLP
DP_CASES = ("average", "sum", "bpps2", "fp16", "bf16", "predivide",
            "predivide3")


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd_jax
    from horovod_tpu.common import fusion as jfusion
    from horovod_tpu.models import gpt as jgpt
    from horovod_tpu.ops import collectives as jC
    from horovod_tpu.ops.compression import Compression as jCompression

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, optax=optax, hvd=hvd_jax, fusion=jfusion,
        gpt=jgpt, C=jC, Compression=jCompression)


# -- GPT --------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(J):
    jm = J.gpt.gpt_tiny()
    tokens = np.random.default_rng(3).integers(0, 128, (2, 33))
    params = jm.init(J.jax.random.PRNGKey(0), tokens[:, :-1])
    tm = gpt.gpt_tiny()
    tm.load_state_dict(convert.gpt_params_from_jax(
        J.jax.tree.map(np.asarray, params)))
    return jm, params, tm, tokens


def test_full_sequence_logits_match_jax(J, tiny):
    jm, params, tm, tokens = tiny
    want = np.asarray(jm.apply(params, J.jnp.asarray(tokens[:, :-1])))
    got = tm(torch.from_numpy(tokens[:, :-1])).detach().numpy()
    assert got.shape == want.shape == (2, 32, 128)
    np.testing.assert_allclose(got, want, atol=GPT_TOL, rtol=GPT_TOL)


def test_loss_and_gradients_match_jax(J, tiny):
    """``next_token_loss`` and every parameter's gradient against
    ``jax.value_and_grad`` of the benchmark's loss (mean softmax CE of
    the next token)."""
    jm, params, tm, tokens = tiny

    def loss_of(p, tb):
        logits = jm.apply({"params": p}, tb[:, :-1])
        return J.optax.softmax_cross_entropy_with_integer_labels(
            logits, tb[:, 1:]).mean()

    jloss, jgrads = J.jax.value_and_grad(loss_of)(params["params"],
                                                  J.jnp.asarray(tokens))
    tm.zero_grad()
    tt = torch.from_numpy(tokens)
    loss = gpt.next_token_loss(tm(tt[:, :-1]), tt[:, 1:])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=GPT_TOL)
    got = convert.gpt_params_to_jax(
        {n: p.grad for n, p in tm.named_parameters()})["params"]
    want = J.jax.tree.map(np.asarray, jgrads)
    flat_got = J.jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(J.jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(g, flat_want[path], atol=GPT_TOL,
                                   rtol=GPT_TOL,
                                   err_msg=J.jax.tree_util.keystr(path))


def test_converter_round_trip(J, tiny):
    """``gpt_params_from_jax`` after ``gpt_params_to_jax`` is the identity
    on the port's state dict, and the tree it makes has the flax tree's
    structure and values."""
    _, params, tm, _ = tiny
    sd = tm.state_dict()
    tree = convert.gpt_params_to_jax(sd)
    back = convert.gpt_params_from_jax(tree)
    assert set(back) == set(sd)
    for name, t in sd.items():
        assert torch.equal(back[name], t), name
    want = J.jax.tree.map(np.asarray, params)
    assert J.jax.tree.structure(tree) == J.jax.tree.structure(want)
    for a, b in zip(J.jax.tree.leaves(tree), J.jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


# -- fusion -----------------------------------------------------------------

def _fusion_leaves():
    """gpt_tiny's parameters in the port's order, with an int32 and a
    bf16 leaf spliced in so the planner interleaves three dtypes."""
    leaves = [p.detach() for p in gpt.gpt_tiny().parameters()]
    leaves.insert(3, torch.zeros((300,), dtype=torch.int32))
    leaves.insert(9, torch.zeros((64, 8), dtype=torch.bfloat16))
    return leaves


@pytest.mark.parametrize("order", ["flatten", "reverse"])
def test_plan_fusion_matches_jax(J, order):
    leaves = _fusion_leaves()
    jleaves = [J.jnp.zeros(tuple(t.shape), str(t.dtype).split(".")[1])
               for t in leaves]
    threshold = 16 * 1024
    got = fusion.plan_fusion(leaves, threshold, order=order)
    want = J.fusion.plan_fusion(jleaves, threshold, order=order)
    assert len(got.buckets) == len(want.buckets) > 3
    assert got.order == want.order == order
    for gb, wb in zip(got.buckets, want.buckets):
        assert gb.leaf_indices == wb.leaf_indices
        assert gb.shapes == wb.shapes
        assert gb.total_elems == wb.total_elems
        assert str(gb.dtype).split(".")[1] == str(wb.dtype)


def test_fuse_unfuse_round_trip():
    leaves = _fusion_leaves()
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(t.shape, generator=gen).to(t.dtype)
              for t in leaves]
    plan = fusion.plan_fusion(leaves, 4096, order="reverse")
    flats = fusion.fuse(leaves, plan)
    assert all(f.dim() == 1 for f in flats)
    for a, b in zip(leaves, fusion.unfuse(flats, plan)):
        assert torch.equal(a, b)
    doubled = fusion.fused_apply([t.float() for t in leaves],
                                 lambda f: f * 2, threshold_bytes=4096)
    for a, b in zip(leaves, doubled):
        assert torch.equal(b, a.float() * 2)
    padded, n = fusion.pad_to_multiple(torch.arange(10.0), 8)
    assert padded.shape == (16,) and n == 10 and padded[10:].eq(0).all()


# -- runtime, collectives and the optimizer in one process --------------------

@pytest.fixture()
def world1():
    ctx = hvd.init(device="cpu")
    try:
        yield ctx
    finally:
        hvd.shutdown()


def test_init_device_rule_and_identity(world1):
    """``init(device="cpu")`` is a gloo world of one; a bare re-init is
    idempotent, one with overrides raises; the queries need a live
    context."""
    assert (hvd.rank(), hvd.size(), hvd.local_rank()) == (0, 1, 0)
    assert hvd.device() == torch.device("cpu")
    assert world1.backend == "gloo"
    assert hvd.init() is world1
    with pytest.raises(ValueError, match="already initialized"):
        hvd.init(device="cpu")
    with pytest.raises(ValueError, match="already initialized"):
        hvd.init(fusion_threshold_bytes=1)


def test_queries_before_init_raise():
    assert not hvd.is_initialized()
    with pytest.raises(hvd.NotInitializedError):
        hvd.rank()
    with pytest.raises(hvd.NotInitializedError):
        hvd.allreduce(torch.ones(3))


def test_init_without_gpu_raises():
    """Without a GPU and without ``device="cpu"``, ``init()`` raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()


def test_collectives_world_of_one(world1):
    x = torch.tensor([1.0, -2.0, 3.5])
    for op in (hvd.Average, hvd.Sum, hvd.Min, hvd.Max):
        torch.testing.assert_close(hvd.allreduce(x, op=op), x)
    torch.testing.assert_close(
        hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0,
                      postscale_factor=0.25), x * 0.5)
    ints = torch.tensor([1, 3, 5])
    # Integer scaling in fp64, cast back: 0.5 * 3 = 1.5 -> 1, not 0.
    assert hvd.allreduce(ints, op=hvd.Sum,
                         prescale_factor=0.5).tolist() == [0, 1, 2]
    assert hvd.allreduce(x, op=hvd.Sum) is not x
    assert len(hvd.grouped_allreduce([x, x * 2])) == 2
    torch.testing.assert_close(hvd.allgather(x[None]), x[None])
    torch.testing.assert_close(hvd.broadcast(x, 0), x)
    # Horovod's in-place async allreduce: an int handle; synchronize
    # writes the average (over a world of one, x) into y and returns y.
    y = x.clone()
    h = hvd.allreduce_async_(y, name="y")
    assert isinstance(h, int)
    assert hvd.synchronize(h) is y
    torch.testing.assert_close(y, x)
    with pytest.raises(TypeError, match="ProcessSet"):
        hvd.allreduce_async_(y, name="y", process_set=object())
    torch.testing.assert_close(hvd.allreduce(x, op=hvd.ReduceOp.PRODUCT), x)
    # Adasum runs no level in a world of one.
    torch.testing.assert_close(hvd.allreduce(x, op=hvd.ReduceOp.ADASUM), x)
    hvd.barrier()


def _mlp_model(params=None):
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Tanh(),
                            torch.nn.Linear(4, 3))
    if params is not None:
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
    return m


def _mlp_loss(m, x, y):
    return ((m(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()


def test_distributed_optimizer_contract(world1):
    """Bucket count, the zero_grad guard, the backward_passes_per_step
    guard, skip_synchronize, and the options that wait for later
    slices."""
    m = _mlp_model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1),
        named_parameters=m.named_parameters(),
        fusion_threshold_bytes=DP_THRESHOLD)
    assert isinstance(opt, torch.optim.SGD)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    y = rng.standard_normal((4, 3)).astype(np.float32)
    _mlp_loss(m, x, y).backward()
    assert opt.bucket_allreduces == 3       # every bucket closed by hooks
    with pytest.raises(AssertionError, match="zero_grad"):
        opt.zero_grad()
    with pytest.raises(AssertionError, match="backward_passes_per_step"):
        _mlp_loss(m, x, y).backward()
    opt.synchronize()
    with opt.skip_synchronize():
        opt.step()
    assert opt.bucket_allreduces == 3       # no second reduction
    opt.zero_grad()
    # The Adasum optimizer takes the guard and accumulation (slice 12).
    for kw in ({"nonfinite_policy": "skip_step", "op": hvd.Adasum},
               {"accum_steps": 2, "op": hvd.Adasum}):
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.1), **kw)
        assert (opt._guard is not None) == ("nonfinite_policy" in kw)
        assert opt.accum_steps == kw.get("accum_steps", 1)
    # The guard and accumulation are ported (slice 9), the route (slice
    # 10): accepted; a world of one has no mesh axes, so the route falls
    # back to the flat axis.
    for kw in ({"nonfinite_policy": "skip_step"}, {"accum_steps": 2},
               {"route": "staged"}):
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1), **kw)
        assert opt._route is None
        for h in opt._dist_hooks:
            h.remove()
    # ZeRO (slice 11): zero_stage returns the sharded optimizer.
    assert isinstance(hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1), zero_stage=1),
        hvd.ZeroOptimizer)
    # The int8 wire format cannot ride a sum (int8_ef is the reduce-safe
    # form); int8_ef and Adasum are tested in test_torch_port_reduce.py.
    with pytest.raises(ValueError, match="int8_ef"):
        hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                 compression="int8")
    with pytest.raises(ValueError):
        hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                 op=hvd.Sum, gradient_predivide_factor=2.0)


@pytest.mark.parametrize("name", ["add_process_set", "ProcessSet",
                                  "ZeroOptimizer", "accumulate_gradients",
                                  "observe_guard", "models.bert_large",
                                  "models.ResNet50", "save_sharded",
                                  "chaos_poison", "flight_recorder",
                                  "start_metrics_server", "StepTimer",
                                  "AutotunedStepper"])
def test_later_slices_raise_not_implemented(name):
    """The JAX package's API that later slices bring is present by name
    and raises NotImplementedError naming its slice. The models slice
    (BERT, ResNet, ...), slice 9 (``accumulate_gradients``,
    ``observe_guard``, ...), slice 10 (``ProcessSet``,
    ``add_process_set``, ...), slice 11 (``ZeroOptimizer``,
    ``save_sharded``, ...) and slice 12 (``chaos_poison``, ``run``,
    ``save_state``, ...) and slice 13 (``flight_recorder``, the metrics
    server, ``StepTimer``) are ported: their names resolve. The
    autotune slice (``AutotunedStepper``) and the parallel roles still
    raise naming their slice."""
    import horovod_tpu_torch.models as models

    mod, attr = (models, name.split(".")[1]) if "." in name else (hvd, name)
    if mod is models or name in ("accumulate_gradients", "observe_guard",
                                 "add_process_set", "ProcessSet",
                                 "ZeroOptimizer", "save_sharded",
                                 "chaos_poison", "flight_recorder",
                                 "start_metrics_server", "StepTimer"):
        assert callable(getattr(mod, attr))
    else:
        with pytest.raises(NotImplementedError, match="the autotune slice"):
            getattr(mod, attr)
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name")


# -- two gloo ranks against the JAX DistributedOptimizer on a 2-device mesh -

def _dp_data():
    rng = np.random.default_rng(7)
    m = _mlp_model()
    params = {k: v.detach().numpy().copy() for k, v in
              m.state_dict().items()}
    return {
        "params": params,
        # (step, micro-batch, rank, batch, features)
        "x": rng.standard_normal((DP_STEPS, 2, 2, 4, 5)).astype(np.float32),
        "y": rng.standard_normal((DP_STEPS, 2, 2, 4, 3)).astype(np.float32),
        # rank-specific starting points for the broadcast case
        "x_local": rng.standard_normal((2, 4, 5)).astype(np.float32),
        "y_local": rng.standard_normal((2, 4, 3)).astype(np.float32),
        "params_rank": [{k: (v + 0.3 * (r + 1) * rng.standard_normal(
            v.shape)).astype(np.float32) for k, v in params.items()}
            for r in range(2)],
    }


def _dp_worker(rank: int, out_path: str) -> None:
    """One rank of the 2-process gloo world (run as a script)."""
    hvd.init(device="cpu")
    assert hvd.rank() == rank and hvd.size() == 2
    data = _dp_data()
    kwargs = {"average": {}, "sum": {"op": hvd.Sum},
              "bpps2": {"backward_passes_per_step": 2},
              "fp16": {"compression": "fp16"},
              "bf16": {"compression": hvd.Compression.bf16},
              "predivide": {"gradient_predivide_factor": 2.0},
              "predivide3": {"gradient_predivide_factor": 3.0}}
    out = {}
    for case in DP_CASES:
        m = _mlp_model(data["params"])
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1),
            named_parameters=m.named_parameters(),
            fusion_threshold_bytes=DP_THRESHOLD, **kwargs[case])
        micro = 2 if case == "bpps2" else 1
        for step in range(DP_STEPS):
            opt.zero_grad()
            for mb in range(micro):
                _mlp_loss(m, data["x"][step, mb, rank],
                          data["y"][step, mb, rank]).backward()
            opt.step()
        for k, v in m.state_dict().items():
            out[f"{case}/{k}"] = v.numpy()
    # Ranks start apart (weights, learning rate, momentum state), then
    # take rank 0's parameters and optimizer state and train together.
    m = _mlp_model(data["params_rank"][rank])
    opt = torch.optim.SGD(m.parameters(), lr=0.1 * (rank + 1), momentum=0.9)
    _mlp_loss(m, data["x_local"][rank], data["y_local"][rank]).backward()
    opt.step()
    hvd.broadcast_parameters(m.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    out["broadcast/lr"] = np.float32(opt.param_groups[0]["lr"])
    opt = hvd.DistributedOptimizer(opt, named_parameters=m.named_parameters(),
                                   fusion_threshold_bytes=DP_THRESHOLD)
    for step in range(DP_STEPS - 1):
        opt.zero_grad()
        _mlp_loss(m, data["x"][step, 0, rank],
                  data["y"][step, 0, rank]).backward()
        opt.step()
    for k, v in m.state_dict().items():
        out[f"broadcast/{k}"] = v.numpy()
    hvd.shutdown()
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    """Run the two ranks once for every case; returns their results."""
    out = tmp_path_factory.mktemp("dp")
    run_ranks(__file__, lambda r: ("--dp-worker", r, out / f"rank{r}.npz"), 2,
              timeout=120)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def _jax_mlp_loss(J, p, x, y):
    h = J.jnp.tanh(x @ p["0.weight"].T + p["0.bias"])
    return ((h @ p["2.weight"].T + p["2.bias"] - y) ** 2).mean()


def _jax_dp_run(J, tx, params, state, xs, ys):
    """Steps of ``tx`` under shard_map on a 2-device mesh; ``xs``/``ys``
    are lists of (2 ranks, batch, features) micro-batches, one
    ``tx.update`` each."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(J.jax.devices()[:2]), ("hvd",))

    def body(p, st, xb, yb):
        p = J.C.to_local(p, "hvd")
        g = J.jax.grad(lambda q: _jax_mlp_loss(J, q, xb[0], yb[0]))(p)
        upd, st = tx.update(g, st, p)
        return J.optax.apply_updates(p, upd), st

    step = J.jax.jit(J.jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P("hvd"), P("hvd")),
        out_specs=(P(), P()), check_vma=False))
    for x, y in zip(xs, ys):
        params, state = step(params, state, x, y)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("case", DP_CASES)
def test_two_rank_dp_matches_jax(J, dp_ranks, case):
    data = _dp_data()
    jkw = {"average": {}, "sum": {"op": J.C.ReduceOp.SUM},
           "bpps2": {"backward_passes_per_step": 2,
                     "average_aggregated_gradients": False},
           "fp16": {"compression": J.Compression.fp16},
           "bf16": {"compression": J.Compression.bf16},
           "predivide": {"prescale_factor": 0.5, "postscale_factor": 2.0},
           "predivide3": {"prescale_factor": 1 / 3, "postscale_factor": 3.0}}
    tx = J.hvd.DistributedOptimizer(J.optax.sgd(0.1), axis_name="hvd",
                                    fusion_threshold_bytes=DP_THRESHOLD,
                                    **jkw[case])
    params = {k: J.jnp.asarray(v) for k, v in data["params"].items()}
    micro = 2 if case == "bpps2" else 1
    xs = [data["x"][s, mb] for s in range(DP_STEPS) for mb in range(micro)]
    ys = [data["y"][s, mb] for s in range(DP_STEPS) for mb in range(micro)]
    want = _jax_dp_run(J, tx, params, tx.init(params), xs, ys)
    for name, ref in want.items():
        for r in range(2):
            np.testing.assert_allclose(dp_ranks[r][f"{case}/{name}"], ref,
                                       rtol=DP_TOL, atol=DP_TOL,
                                       err_msg=f"{case} rank {r} {name}")


def test_two_rank_broadcasts_match_jax(J, dp_ranks):
    """After ``broadcast_parameters`` and ``broadcast_optimizer_state``
    from rank 0 (weights, momentum buffers and the learning rate), both
    ranks train as rank 0's optimizer would: equal to the JAX run that
    starts from rank 0's local step."""
    data = _dp_data()
    sgd = J.optax.sgd(0.1, momentum=0.9)
    p0 = {k: J.jnp.asarray(v) for k, v in data["params_rank"][0].items()}
    g = J.jax.grad(lambda p: _jax_mlp_loss(J, p, data["x_local"][0],
                                           data["y_local"][0]))(p0)
    upd, state = sgd.update(g, sgd.init(p0), p0)
    p1 = J.optax.apply_updates(p0, upd)
    tx = J.hvd.DistributedOptimizer(sgd, axis_name="hvd",
                                    fusion_threshold_bytes=DP_THRESHOLD)
    steps = range(DP_STEPS - 1)
    want = _jax_dp_run(J, tx, p1, state, [data["x"][s, 0] for s in steps],
                       [data["y"][s, 0] for s in steps])
    for r in range(2):
        assert float(dp_ranks[r]["broadcast/lr"]) == pytest.approx(0.1)
        for name, ref in want.items():
            np.testing.assert_allclose(dp_ranks[r][f"broadcast/{name}"],
                                       ref, rtol=DP_TOL, atol=DP_TOL,
                                       err_msg=f"rank {r} {name}")


if __name__ == "__main__" and sys.argv[1:2] == ["--dp-worker"]:
    _dp_worker(int(sys.argv[2]), sys.argv[3])
