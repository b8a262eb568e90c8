"""The port's D2 overlap (``horovod_tpu_torch/common/overlap.py``,
``DistributedOptimizer(overlap=True)``, ``ZeroOptimizer(overlap=True)``)
against the contracts of ``tests/test_overlap.py`` and against the
synchronous path.

* ``chain_issue_order``, ``fused_apply_overlapped`` and
  ``staged_value_and_grad`` against the JAX package's functions on the
  same seeded inputs: identity on values (exact), the fused apply equal
  to ``fused_apply`` bitwise, the staged gradients to 1e-5 of JAX's and
  the per-stage reduction applied once a stage.
* The worker: chains run on one thread, in submission order; a failed
  chain re-raises at ``wait()`` and no later chain runs.
* Gloo worlds (this file run as ``--overlap-worker RANK N OUT``), each
  arm from the same seeded ``gpt_tiny`` (2 layers, hidden 64) and the
  same per-rank batches, ``overlap=False`` then ``True`` in one process,
  held BITWISE after every step: flat ``int8_ef`` at n = 2 (parameters,
  residuals, the rounding step); a 2x2 mesh with the routed
  ``local:none,cross:int8`` int8_ef and Adasum over ``staged``; ZeRO
  stage 3 at n = 2 with the forward prefetch; and the guard's +Inf
  drill under overlap (``int8_ef`` + ``skip_step``, rank 1 at step 2):
  residuals and the rounding step unchanged across the skip, and equal
  to the synchronous run's; and ZeRO stage 3 over a SyncBatchNorm model,
  whose own all-reduces wait for the gathers submitted before them.
* A collective of the caller's own waits for the chains submitted
  before it (``drain_before_collective``); an abandoned worker runs
  nothing more.

JAX is imported only inside the ``J`` fixture.
"""

import sys
import threading
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import fusion
from horovod_tpu_torch.common import overlap
from horovod_tpu_torch.models import gpt as gpt_mod
from test_torch_port_worlds import run_ranks

STAGED_TOL = 1e-5       # staged gradients vs JAX, of the largest |value|
STEPS = 3
BATCH, SEQ = 2, 16
THRESHOLD = 16 * 1024   # several buckets of gpt_tiny
ROUTE_Q = "local:none,cross:int8"
BAD = (1, 1)            # (step, rank) of the guard drill's +Inf


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.common import fusion as jfusion
    from horovod_tpu.common import overlap as joverlap

    return types.SimpleNamespace(jax=jax, jnp=jnp, fusion=jfusion,
                                 overlap=joverlap)


def _mlp_leaves(rng, depth=6, width=16):
    """The JAX test's ``_mlp_tree`` as leaves in JAX's flatten order
    (``layerNN`` sorted, ``b`` before ``w``)."""
    out = []
    for _ in range(depth):
        w = rng.standard_normal((width, width)).astype(np.float32)
        b = rng.standard_normal((width,)).astype(np.float32)
        out += [b, w]
    return out


def _tree(leaves):
    return {f"layer{i // 2:02d}": {"b": leaves[i], "w": leaves[i + 1]}
            for i in range(0, len(leaves), 2)}


def test_chain_issue_order_is_identity_on_values(J):
    rng = np.random.default_rng(0)
    flats = [rng.standard_normal((n,)).astype(np.float32) for n in (5, 7, 3)]
    outs = overlap.chain_issue_order([torch.from_numpy(f) for f in flats],
                                     lambda f: f * 2.0)
    jouts = J.overlap.chain_issue_order([J.jnp.asarray(f) for f in flats],
                                        lambda f: f * 2.0)
    for o, jo, f in zip(outs, jouts, flats):
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(o.numpy(), f * 2.0)


def test_fused_apply_overlapped_matches_fused_apply(J):
    leaves = _mlp_leaves(np.random.default_rng(1))
    tl = [torch.from_numpy(x) for x in leaves]
    plain = fusion.fused_apply(tl, lambda f: f * 3.0, threshold_bytes=512)
    ovl = overlap.fused_apply_overlapped(tl, lambda f: f * 3.0, 512)
    jovl = J.jax.tree.leaves(J.overlap.fused_apply_overlapped(
        J.jax.tree.map(J.jnp.asarray, _tree(leaves)), lambda f: f * 3.0,
        512))
    for a, b, c in zip(plain, ovl, jovl):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))


def test_chains_run_in_submission_order_on_one_thread():
    w = overlap.IssueWorker()
    seen = []
    try:
        pend = [w.submit(lambda i: seen.append(
            (i, threading.get_ident())) or i, i) for i in range(20)]
        assert [p.wait() for p in pend] == list(range(20))
    finally:
        w.close()
    assert [i for i, _ in seen] == list(range(20))
    assert len({t for _, t in seen}) == 1
    assert seen[0][1] != threading.get_ident()


def test_a_failed_chain_reraises_and_stops_the_worker():
    w = overlap.IssueWorker()
    ran = []

    def bad():
        raise RuntimeError("hop 2 failed")

    try:
        p1 = w.submit(lambda: ran.append(1))
        p2 = w.submit(bad)
        p3 = w.submit(lambda: ran.append(3))
        p1.wait()
        with pytest.raises(RuntimeError, match="hop 2 failed"):
            p2.wait()
        with pytest.raises(RuntimeError, match="earlier overlapped"):
            p3.wait()
    finally:
        w.close()
    assert ran == [1]


def test_staged_value_and_grad_matches_monolithic(J):
    width, stages = 6, 3
    rng = np.random.default_rng(2)
    params = [{"b": np.zeros((width,), np.float32),
               "w": (rng.standard_normal((width, width)) * 0.3)
               .astype(np.float32)} for _ in range(stages)]
    x = rng.standard_normal((4, width)).astype(np.float32)

    def t_stage(p, act):
        return torch.tanh(act @ p["w"] + p["b"])

    def j_stage(p, act):
        return J.jnp.tanh(act @ p["w"] + p["b"])

    tp = [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]
    jp = [{k: J.jnp.asarray(v) for k, v in p.items()} for p in params]
    loss, grads = overlap.staged_value_and_grad(
        [t_stage] * stages, lambda a: (a ** 2).mean(), tp,
        torch.from_numpy(x))
    jloss, jgrads = J.overlap.staged_value_and_grad(
        [j_stage] * stages, lambda a: J.jnp.mean(a ** 2), jp,
        J.jnp.asarray(x))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for g, jg in zip(grads, jgrads):
        for k in ("b", "w"):
            want = np.asarray(jg[k])
            np.testing.assert_allclose(
                g[k].numpy(), want, rtol=0,
                atol=STAGED_TOL * np.abs(want).max())
    calls = []

    def reduce_fn(g):
        calls.append(threading.get_ident())
        return {k: v * 2.0 for k, v in g.items()}

    _, grads2 = overlap.staged_value_and_grad(
        [t_stage] * stages, lambda a: (a ** 2).mean(), tp,
        torch.from_numpy(x), reduce_fn=reduce_fn)
    assert len(calls) == stages and threading.get_ident() not in calls
    for g, g2 in zip(grads, grads2):
        for k in ("b", "w"):
            np.testing.assert_array_equal(g2[k].numpy(), g[k].numpy() * 2.0)
    with pytest.raises(ValueError, match="stage fns"):
        overlap.staged_value_and_grad([t_stage], lambda a: a.sum(), tp,
                                      torch.from_numpy(x))


def test_the_worker_does_not_keep_its_optimizer_alive():
    """An optimizer with a worker is freed once its user drops it (the
    worker holds no finished chain), and its worker thread then ends."""
    import gc
    import weakref

    hvd.init(device="cpu")
    try:
        m = torch.nn.Linear(4, 3)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.1),
                                       overlap=True)
        m(torch.ones(2, 4)).sum().backward()
        opt.step()
        thread = opt._worker._thread
        ref = weakref.ref(opt)
        for h in opt._dist_hooks:
            h.remove()
        del opt
        gc.collect()
        assert ref() is None
        thread.join(10)
        assert not thread.is_alive()
    finally:
        hvd.shutdown()


def test_synchronize_reraises_a_failed_hop():
    """A hop that fails on the worker raises at ``synchronize()``."""
    hvd.init(device="cpu")
    try:
        m = torch.nn.Linear(4, 3)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.1),
                                       overlap=True)

        def boom(*a):
            raise RuntimeError("injected hop failure")

        opt._chain = boom
        m(torch.ones(2, 4)).sum().backward()
        with pytest.raises(RuntimeError, match="injected hop failure"):
            opt.synchronize()
    finally:
        hvd.shutdown()


def test_own_collective_waits_for_the_submitted_chains():
    """A collective of the caller's thread is issued only after every
    chain submitted before it has run; a chain's own collective (on the
    worker thread) does not wait on itself."""
    hvd.init(device="cpu")
    try:
        w = overlap.IssueWorker()
        order = []

        def slow():
            threading.Event().wait(0.2)
            order.append("chain")
            return hvd.allreduce(torch.ones(2), op=hvd.Sum)

        pend = w.submit(slow)
        hvd.allreduce(torch.ones(2), op=hvd.Sum)
        order.append("caller")
        assert order == ["chain", "caller"]
        assert torch.equal(pend.wait(), torch.ones(2))
        w.abandon()
        gone = w.submit(slow)
        with pytest.raises(RuntimeError, match="abandoned"):
            gone.wait()
        hvd.allreduce(torch.ones(2))    # an abandoned worker holds nothing
        assert order == ["chain", "caller"]
    finally:
        hvd.shutdown()


# -- gloo worlds ----------------------------------------------------------------

def _model(seed=3):
    torch.manual_seed(seed)
    return gpt_mod.gpt_tiny()


def _batch(rank, step):
    g = torch.Generator().manual_seed(1000 * step + rank)
    return torch.randint(0, 128, (BATCH, SEQ + 1), generator=g)


def _loss(model, tokens):
    return gpt_mod.next_token_loss(model(tokens[:, :-1]), tokens[:, 1:])


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def _dist_arm(rank, on, poison=False, **kw):
    """One arm of a DistributedOptimizer run; per step the parameters,
    residuals and rounding step."""
    model = _model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters(),
        fusion_threshold_bytes=THRESHOLD, overlap=on, **kw)
    steps = []
    for s in range(STEPS):
        opt.zero_grad()
        loss = _loss(model, _batch(rank, s))
        if poison and (s, rank) == BAD:
            # d/dw (w * inf) = +Inf in one element of the first gradient.
            loss = loss + next(model.parameters()).view(-1)[0] * float(
                "inf")
        loss.backward()
        opt.step()
        steps.append({"params": _params(model),
                      "res": {k: v.clone()
                              for k, v in getattr(opt, "_ef_residual",
                                                  {}).items()},
                      "ef_step": getattr(opt, "_ef_step", 0)})
    for h in getattr(opt, "_dist_hooks", ()):
        h.remove()
    return steps, opt


def _zero_arm(rank, on, accumulate):
    """ZeRO stage 3 through ``accumulate`` or through ``gather_params``,
    a forward and backward, and ``step``; per step the shards and how
    many parameter uses waited on a bucket (the prefetch's waits)."""
    model = _model()
    opt = hvd.ZeroOptimizer(torch.optim.AdamW(model.parameters(), lr=1e-3),
                            zero_stage=3, fusion_threshold_bytes=THRESHOLD,
                            overlap=on)
    fn = opt.accumulate(lambda t: _loss(model, t))
    steps = []
    for s in range(STEPS):
        if accumulate:
            fn(_batch(rank, s))
        else:
            opt.gather_params()
            _loss(model, _batch(rank, s)).backward()
        opt.step()
        steps.append([sh.clone() for sh in opt.shard_state.shards])
    return steps, opt


def _zero_syncbn_arm(rank, on):
    """ZeRO stage 3 under ``accumulate`` over a model whose forward and
    backward issue their own collectives (SyncBatchNorm's two Sum
    all-reduces, between the prefetch's gathers); per step the shards
    and the running statistics."""
    torch.manual_seed(5)
    model = torch.nn.Sequential(
        torch.nn.Linear(8, 64), hvd.SyncBatchNorm(64), torch.nn.Tanh(),
        torch.nn.Linear(64, 64), hvd.SyncBatchNorm(64), torch.nn.Tanh(),
        torch.nn.Linear(64, 4))
    opt = hvd.ZeroOptimizer(torch.optim.AdamW(model.parameters(), lr=1e-3),
                            zero_stage=3, fusion_threshold_bytes=4096,
                            overlap=on)
    fn = opt.accumulate(lambda x: model(x).pow(2).mean())
    steps = []
    for s in range(STEPS):
        g = torch.Generator().manual_seed(1000 * s + rank)
        fn(torch.randn(6, 8, generator=g))
        opt.step()
        steps.append([sh.clone() for sh in opt.shard_state.shards]
                     + [b.clone() for b in model.buffers()])
    return steps, opt


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _overlap_worker(rank: int, n: int, out_path: str) -> None:
    out = {}
    if n == 2:
        hvd.init(device="cpu")
        kw = {"compression": "int8_ef", "quantize_min_bucket_bytes": 0}
        off, o1 = _dist_arm(rank, False, **kw)
        on, o2 = _dist_arm(rank, True, **kw)
        out["flat/equal"] = [_same(a, b) for a, b in zip(off, on)]
        out["flat/int8_buckets"] = sum(
            w == "int8" for w in o2._dist_plan.wire_dtypes)
        out["flat/buckets"] = len(o2._dist_plan.buckets)
        out["flat/chains"] = o2._worker.chains
        out["flat/ef_step"] = [s["ef_step"] for s in on]
        kw["nonfinite_policy"] = "skip_step"
        goff, _ = _dist_arm(rank, False, poison=True, **kw)
        gon, og = _dist_arm(rank, True, poison=True, **kw)
        out["guard/equal"] = [_same(a, b) for a, b in zip(goff, gon)]
        out["guard/ef_step"] = [s["ef_step"] for s in gon]
        out["guard/res_kept"] = _same(gon[BAD[0]]["res"],
                                      gon[BAD[0] - 1]["res"])
        out["guard/params_kept"] = _same(gon[BAD[0]]["params"],
                                         gon[BAD[0] - 1]["params"])
        out["guard/agreements"] = og.guard_agreements
        zoff, _ = _zero_arm(rank, False, True)
        zon, oz = _zero_arm(rank, True, True)
        zoff2, _ = _zero_arm(rank, False, False)
        zon2, _ = _zero_arm(rank, True, False)
        out["zero/equal"] = [_same(a, b) for a, b in zip(zoff, zon)]
        out["zero/equal_plain_loop"] = [_same(a, b)
                                        for a, b in zip(zoff2, zon2)]
        out["zero/chains"] = oz._worker.chains
        out["zero/buckets"] = len(oz.shard_state.plan.buckets)
        boff, _ = _zero_syncbn_arm(rank, False)
        bon, ob = _zero_syncbn_arm(rank, True)
        out["zero_syncbn/equal"] = [_same(a, b) for a, b in zip(boff, bon)]
        out["zero_syncbn/buckets"] = len(ob.shard_state.plan.buckets)
        out["zero_syncbn/chains"] = ob._worker.chains
    else:
        hvd.init(device="cpu", mesh_shape="2x2")
        kw = {"compression": "int8_ef", "quantize_min_bucket_bytes": 0,
              "route": ROUTE_Q}
        off, _ = _dist_arm(rank, False, **kw)
        on, o2 = _dist_arm(rank, True, **kw)
        out["routed/equal"] = [_same(a, b) for a, b in zip(off, on)]
        out["routed/route"] = o2._route is not None
        aoff, _ = _dist_arm(rank, False, op=hvd.Adasum, route="staged")
        aon, oa = _dist_arm(rank, True, op=hvd.Adasum, route="staged")
        out["adasum/equal"] = [_same(a["params"], b["params"])
                               for a, b in zip(aoff, aon)]
        out["adasum/reductions"] = oa.adasum_reductions
        out["adasum/n_params"] = len(oa._all_params())
    hvd.shutdown()
    torch.save(out, out_path)


_WORLDS = {}


def _world(n, tmp_path_factory):
    if n not in _WORLDS:
        out = tmp_path_factory.mktemp(f"overlap{n}")
        run_ranks(__file__, lambda r: ("--overlap-worker", r, n,
                                       out / f"rank{r}.pt"), n,
                  timeout=300)
        _WORLDS[n] = [torch.load(out / f"rank{r}.pt") for r in range(n)]
    return _WORLDS[n]


def test_flat_int8_ef_overlap_is_bitwise(tmp_path_factory):
    """n = 2, int8_ef: parameters, residuals and the rounding step of
    ``overlap=True`` bitwise ``overlap=False``'s after every step; every
    bucket's chain ran on the worker."""
    for rank in _world(2, tmp_path_factory):
        assert rank["flat/equal"] == [True] * STEPS
        assert rank["flat/int8_buckets"] >= 2
        assert rank["flat/chains"] == rank["flat/buckets"] * STEPS
        assert rank["flat/ef_step"] == [1, 2, 3]


def test_guard_drill_under_overlap(tmp_path_factory):
    """+Inf on rank 1 at step 2 with int8_ef + skip_step under overlap:
    every rank skips, residuals, the rounding step and the weights stay
    as they were, and the run is bitwise the synchronous one."""
    for rank in _world(2, tmp_path_factory):
        assert rank["guard/equal"] == [True] * STEPS
        assert rank["guard/ef_step"] == [1, 1, 2]
        assert rank["guard/res_kept"] and rank["guard/params_kept"]
        assert rank["guard/agreements"] == STEPS


def test_zero_stage3_prefetch_is_bitwise(tmp_path_factory):
    """ZeRO stage 3 at n = 2 with AdamW: the shards after every step of
    the prefetch under ``accumulate``'s forward, and of ``gather_params``
    on the worker in a plain loop, bitwise the synchronous gather's; one
    chain a bucket a step ran on the worker."""
    for rank in _world(2, tmp_path_factory):
        assert rank["zero/equal"] == [True] * STEPS
        assert rank["zero/equal_plain_loop"] == [True] * STEPS
        assert rank["zero/buckets"] > 2
        assert rank["zero/chains"] == rank["zero/buckets"] * STEPS


def test_zero_prefetch_with_the_models_own_collectives(tmp_path_factory):
    """ZeRO stage 3 at n = 2 over a SyncBatchNorm model: the model's own
    all-reduces wait for the gathers submitted before them, so the
    prefetch neither hangs nor crosses them, and the shards and running
    statistics after every step are bitwise the synchronous gather's."""
    for rank in _world(2, tmp_path_factory):
        assert rank["zero_syncbn/equal"] == [True] * STEPS
        assert rank["zero_syncbn/buckets"] > 2
        assert rank["zero_syncbn/chains"] == \
            rank["zero_syncbn/buckets"] * STEPS


def test_routed_and_adasum_overlap_is_bitwise(tmp_path_factory):
    """A 2x2 mesh: the routed local:none,cross:int8 int8_ef run and
    Adasum over ``staged`` (which accepts ``overlap=True`` and runs its
    synchronous loop) bitwise their synchronous runs."""
    for rank in _world(4, tmp_path_factory):
        assert rank["routed/route"]
        assert rank["routed/equal"] == [True] * STEPS
        assert rank["adasum/equal"] == [True] * STEPS
        assert rank["adasum/reductions"] == rank["adasum/n_params"] * STEPS


if __name__ == "__main__" and sys.argv[1:2] == ["--overlap-worker"]:
    _overlap_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
