"""The port's TensorFlow shim (``horovod_tpu_torch.tensorflow``) against
the JAX package's (``horovod_tpu.tensorflow``).

One gloo world of 2 ranks (each a process running this file with
``--tf-worker``, on the CPU) and the JAX shim on a 2-device CPU mesh
(``--shim-oracle``) run side by side, once a test session, for this
file and ``test_torch_port_keras.py``; the cases read what they
recorded.

* Replicated inputs (every rank the same tensor, the JAX shim's world):
  each result equals the JAX shim's — integer results and Sum results
  bitwise, averaged float results and optimizer steps within 1e-6 of the
  largest magnitude (the JAX shim reduces through XLA).
* Each rank its own inputs: each result equals the reduction done by
  hand from both ranks' inputs (reference Horovod's per-rank semantics:
  allgather, broadcast, alltoall and reducescatter included).
* The dtype matrix of ``test_shim_dtype_matrix.py``'s TF half (uint8,
  int32, int64, float16, bfloat16, float32, float64): the output dtype
  is the input's. The JAX package computes int64/float64 in 32 bits and
  the port at full width, so the parity inputs are small integers,
  which both compute exactly.
* ``DistributedGradientTape`` and ``DistributedOptimizer`` (local
  aggregation, predivide, Adasum) inside and outside a ``tf.function``;
  graph mode chains a function's collectives in trace order.
* The elastic states and the TF1 session hook.
"""

import os
import sys

import numpy as np
import pytest

from test_torch_port_worlds import TF_ENV, rank_env, run_procs, session_world

N = 2
TOL = 1e-6
DTYPES = ("uint8", "int32", "int64", "float16", "bfloat16", "float32",
          "float64")
PRE, POST = 0.5, 3.0


def _data(rank):
    """Seeded inputs: ``rank=None`` the replicated ones, else this
    rank's own."""
    g = np.random.default_rng(2000 if rank is None else 2010 + rank)
    return {
        "x": g.standard_normal((4, 3)).astype(np.float32),
        "grp": [g.standard_normal(s).astype(np.float32)
                for s in ((5,), (2, 3))],
        "ints": g.integers(-20, 20, (4, 3)).astype(np.int32),
        "sp_val": g.standard_normal((2 + (rank or 0), 3)).astype(
            np.float32),
        "sp_idx": g.integers(0, 5, 2 + (rank or 0)).astype(np.int64),
        "X": g.standard_normal((8, 4)).astype(np.float32),
        "y": g.standard_normal((8, 2)).astype(np.float32),
        "w0": np.random.default_rng(5).standard_normal((4, 2)).astype(
            np.float32),
        "grads": [g.standard_normal((4, 2)).astype(np.float32)
                  for _ in range(3)],
    }


def _f32(t):
    import tensorflow as tf

    return tf.cast(t, tf.float32).numpy()


#: The TF half of ``test_shim_dtype_matrix.py``: each op on its dtypes.
MATRIX = {"sum": DTYPES, "avg": DTYPES,
          "min": ("int32", "bfloat16", "float32"),
          "max": ("int32", "bfloat16", "float32"),
          "pre": ("int32", "float32", "float64"),
          "post": ("int32", "float32"),
          "ag": ("uint8", "int64", "bfloat16", "float32"),
          "bc": ("uint8", "int64", "bfloat16", "float32"),
          "a2a": ("int32", "bfloat16", "float32"),
          "g": ("int32", "bfloat16", "float32")}


def _dtype_matrix(api, out, prefix):
    """The TF half of the dtype matrix on small integers."""
    import tensorflow as tf

    def put(tag, name, o):
        assert o.dtype == tf.as_dtype(name), (tag, name, o.dtype)
        out[f"{prefix}dm/{tag}/{name}"] = _f32(o)

    ops = {"sum": api.Sum, "avg": api.Average, "min": api.Min,
           "max": api.Max}
    for tag, names in MATRIX.items():
        for name in names:
            dt = tf.as_dtype(name)
            if tag in ops:
                put(tag, name, api.allreduce(tf.cast(tf.range(6) % 5, dt),
                                             op=ops[tag],
                                             name=f"dm.{tag}.{name}"))
            elif tag in ("pre", "post"):
                vals = [1, 3, 10] if tag == "pre" else [1, 3]
                scale = {f"{tag}scale_factor": 0.5}
                put(tag, name, api.allreduce(
                    tf.cast(tf.constant(vals), dt), op=api.Sum,
                    name=f"dm.{tag}.{name}", **scale))
            elif tag in ("ag", "bc"):
                m = tf.cast(tf.reshape(tf.range(6) % 5, (2, 3)), dt)
                put(tag, name, api.allgather(m, name=f"dm.ag.{name}")
                    if tag == "ag" else api.broadcast(
                        m, 0, name=f"dm.bc.{name}"))
            elif tag == "a2a":
                put(tag, name, api.alltoall(tf.cast(tf.range(4) % 5, dt),
                                            name=f"dm.a2a.{name}"))
            else:
                fused = api.grouped_allreduce(
                    [tf.cast(tf.range(5) % 4, dt),
                     tf.cast(tf.reshape(tf.range(8) % 3, (2, 4)), dt)],
                    op=api.Sum, name=f"dm.g.{name}")
                for i, o in enumerate(fused):
                    put(f"g{i}", name, o)


def _collectives(api, d, out, prefix, n):
    import tensorflow as tf

    x = tf.constant(d["x"])
    for op, tag in ((api.Sum, "sum"), (api.Average, "avg"),
                    (api.Min, "min"), (api.Max, "max")):
        out[f"{prefix}ar/{tag}"] = api.allreduce(x, op=op,
                                                 name=f"ar.{tag}").numpy()
    out[f"{prefix}ar/scaled"] = api.allreduce(
        x, op=api.Sum, prescale_factor=PRE, postscale_factor=POST,
        name="ar.scaled").numpy()
    out[f"{prefix}ar/int_avg"] = api.allreduce(
        tf.constant(d["ints"]), op=api.Average, name="ar.int").numpy()
    for i, o in enumerate(api.grouped_allreduce(
            [tf.constant(g) for g in d["grp"]], op=api.Sum, name="gar",
            prescale_factor=PRE, postscale_factor=POST)):
        out[f"{prefix}gar/{i}"] = o.numpy()
    out[f"{prefix}ag"] = api.allgather(x, name="ag").numpy()
    out[f"{prefix}bc"] = api.broadcast(x, root_rank=n - 1,
                                       name="bc").numpy()
    out[f"{prefix}a2a"] = api.alltoall(x, name="a2a").numpy()
    for op, tag in ((api.Sum, "sum"), (api.Average, "avg")):
        out[f"{prefix}rs/{tag}"] = api.reducescatter(
            x, op=op, name=f"rs.{tag}").numpy()
    for i, o in enumerate(api.grouped_allgather(
            [x, tf.constant(d["ints"])], name="gag")):
        out[f"{prefix}gag/{i}"] = o.numpy()
    for i, o in enumerate(api.grouped_reducescatter(
            [x, tf.constant(d["ints"])], op=api.Sum, name="grs")):
        out[f"{prefix}grs/{i}"] = o.numpy()

    @tf.function
    def graph(t):
        return (api.allgather(t, name="g.ag"),
                api.broadcast(t, root_rank=n - 1, name="g.bc"),
                api.allreduce(t, op=api.Sum, name="g.ar"),
                api.grouped_allreduce([t, 2.0 * t], op=api.Average,
                                      name="g.gar")[1],
                api.reducescatter(t, op=api.Sum, name="g.rs"),
                api.alltoall(t, name="g.a2a"))

    for rep in range(2):
        outs = graph(x)
        for k, o in enumerate(outs):
            out[f"{prefix}graph{rep}/{k}"] = o.numpy()
    # The static shapes the trace declares (allgather n x, reducescatter
    # 1/n of dim 0).
    out[f"{prefix}graph/shapes"] = np.array(repr([
        tuple(o.shape) for o in
        graph.get_concrete_function(x).structured_outputs]))
    sl = tf.IndexedSlices(tf.constant(d["sp_val"]),
                          tf.constant(d["sp_idx"]), dense_shape=(5, 3))
    for op, tag in ((api.Sum, "sum"), (api.Average, "avg")):
        o = api.allreduce(sl, op=op, name=f"sp.{tag}")
        assert isinstance(o, tf.IndexedSlices)
        out[f"{prefix}sp/{tag}"] = tf.math.unsorted_segment_sum(
            o.values, o.indices, 5).numpy()
    o = api.allreduce(sl, op=api.Average, name="spd",
                      sparse_as_dense=True)
    assert not isinstance(o, tf.IndexedSlices)
    out[f"{prefix}sp/dense"] = o.numpy()
    v = tf.Variable(d["x"])
    api.broadcast_variables([v], root_rank=n - 1)
    out[f"{prefix}bvars"] = v.numpy()


def _model_step(api, d, out, prefix):
    """The tape and the optimizer, eager and traced."""
    import tensorflow as tf

    X, y = tf.constant(d["X"]), tf.constant(d["y"])

    def loss_of(w):
        return tf.reduce_mean(tf.square(tf.matmul(X, w) - y))

    w = tf.Variable(d["w0"])
    with api.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = loss_of(w)
    out[f"{prefix}tape/eager"] = tape.gradient(loss, w).numpy()

    @tf.function
    def traced_grad():
        with api.DistributedGradientTape(tf.GradientTape()) as t:
            lo = loss_of(w)
        return t.gradient(lo, [w])[0]

    out[f"{prefix}tape/graph"] = traced_grad().numpy()

    cases = {"plain": {}, "predivide": {"gradient_predivide_factor": 4.0},
             "agg_avg": {"backward_passes_per_step": 2,
                         "average_aggregated_gradients": True},
             "agg_sum": {"backward_passes_per_step": 2}}
    for tag, kw in cases.items():
        for mode in ("eager", "graph"):
            v = tf.Variable(d["w0"])
            opt = api.DistributedOptimizer(
                tf.keras.optimizers.SGD(learning_rate=0.1), **kw)
            step = (lambda g, opt=opt, v=v: opt.apply_gradients([(g, v)]))
            if mode == "graph":
                step = tf.function(step)
            for g in d["grads"][:2]:
                step(tf.constant(g))
            out[f"{prefix}opt/{tag}/{mode}"] = v.numpy()
    v = tf.Variable(d["w0"])
    u = tf.Variable(d["w0"][:1] * 2.0)
    opt = api._DistributedAdasumOptimizer(
        tf.keras.optimizers.SGD(learning_rate=0.5))
    opt.apply_gradients([(tf.constant(d["grads"][0]), v),
                         (tf.constant(d["grads"][1][:1]), u)])
    out[f"{prefix}adasum/v"] = v.numpy()
    out[f"{prefix}adasum/u"] = u.numpy()


def _states(api, d, out, prefix):
    import tensorflow as tf
    from importlib import import_module

    el = import_module(api.__name__ + ".elastic")
    v1, v2 = tf.Variable(d["x"]), tf.Variable(d["grp"][1])
    state = el.TensorFlowState([v1, v2], step=5)
    v1.assign(v1 * 3.0)
    state.restore()
    out[f"{prefix}state/restored"] = v1.numpy()
    v2.assign(v2 + 1.0)
    state.commit()
    state.sync()
    out[f"{prefix}state/synced"] = v2.numpy()
    out[f"{prefix}state/step"] = np.array(state.step)

    model = tf.keras.Sequential([tf.keras.layers.Input((4,)),
                                 tf.keras.layers.Dense(2, use_bias=False)])
    model.set_weights([d["w0"]])
    opt = tf.keras.optimizers.SGD(learning_rate=0.1, momentum=0.9)
    model.compile(optimizer=opt, loss="mse")
    kstate = el.TensorFlowKerasState(model, optimizer=opt, epoch=0)
    model.train_on_batch(d["X"], d["y"])
    kstate.epoch = 1
    kstate.commit()
    committed = model.get_weights()[0].copy()
    model.train_on_batch(d["X"], d["y"])
    kstate.epoch = 2
    kstate.restore()
    out[f"{prefix}kstate/restored_ok"] = np.array(
        np.array_equal(model.get_weights()[0], committed)
        and kstate.epoch == 1)
    kstate.sync()
    out[f"{prefix}kstate/synced"] = model.get_weights()[0]

    v1c = tf.compat.v1
    graph = tf.Graph()
    with graph.as_default():
        w = v1c.get_variable("hook_w", initializer=d["x"])
        hook = api.BroadcastGlobalVariablesHook(0)
        with v1c.train.MonitoredTrainingSession(hooks=[hook]) as sess:
            out[f"{prefix}hook"] = sess.run(w)


def _objects(api, rank, out):
    out["obj/bcast"] = np.array(api.broadcast_object({"r": rank},
                                                     root_rank=1)["r"])
    out["obj/gather"] = np.array(api.allgather_object(rank * 10))


def _tf_worker(rank: int, n: int, out_dir: str) -> None:
    """One rank of the gloo world (run as a script): this file's cases,
    then ``test_torch_port_keras.py``'s in the same world."""
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.tensorflow as api
    import test_torch_port_keras as keras_cases

    hvd.init(device="cpu")
    assert api.rank() == rank and api.size() == n
    assert api.tpu_available() is False and api.gloo_enabled()
    out = {}
    for prefix, d in (("rep/", _data(None)), ("own/", _data(rank))):
        _collectives(api, d, out, prefix, n)
        _model_step(api, d, out, prefix)
        _states(api, d, out, prefix)
    _dtype_matrix(api, out, "rep/")
    _objects(api, rank, out)
    import tensorflow as tf

    try:
        api.DistributedOptimizer(tf.keras.optimizers.SGD(0.1),
                                 gradient_predivide_factor=2.0, op=api.Sum)
        out["predivide_error"] = np.array("")
    except ValueError as e:
        out["predivide_error"] = np.array(str(e))
    kout = keras_cases.rank_cases(rank, n, out_dir)
    hvd.shutdown()
    if rank == 0:
        kout.update(keras_cases.reference_cases(n))
    np.savez(os.path.join(out_dir, f"tf.port.{rank}.npz"), **out)
    np.savez(os.path.join(out_dir, f"keras.port.{rank}.npz"), **kout)


def _shim_oracle(n: int, out_dir: str) -> None:
    """The JAX shim on an n-device CPU mesh, on the replicated inputs
    (run as a script); then the JAX Keras surface's cases."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import horovod_tpu as jhvd
    import horovod_tpu.tensorflow as api
    import test_torch_port_keras as keras_cases

    jhvd.init()
    assert jhvd.size() == n
    out = {}
    d = _data(None)
    _collectives(api, d, out, "rep/", n)
    _model_step(api, d, out, "rep/")
    _states(api, d, out, "rep/")
    _dtype_matrix(api, out, "rep/")
    np.savez(os.path.join(out_dir, "tf.shim.npz"), **out)
    np.savez(os.path.join(out_dir, "keras.shim.npz"),
             **keras_cases.oracle_cases(out_dir))


def tf_keras_world(out) -> None:
    """The gloo world of N ranks and the JAX oracle, side by side, for
    this file and ``test_torch_port_keras.py`` (one TensorFlow start-up
    a process serves both): each writes ``tf.<key>.npz`` and
    ``keras.<key>.npz`` into ``out``."""
    env = rank_env(N, **TF_ENV)
    cmds = {f"port.{r}": (
        [sys.executable, __file__, "--tf-worker", str(r), str(N), str(out)],
        dict(env, HVD_TPU_PROC_ID=str(r))) for r in range(N)}
    cmds["shim"] = (
        [sys.executable, __file__, "--shim-oracle", str(N), str(out)],
        rank_env(JAX_PLATFORMS="cpu", HVD_TPU_FORCE_CPU_DEVICES=str(N),
                 XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
                 **TF_ENV))
    run_procs(cmds, timeout=400)


def world_results(tmp_path_factory, part: str) -> dict:
    """``part`` ("tf" or "keras") of the session's TF world."""
    out = session_world(tmp_path_factory, "tf_keras", tf_keras_world)
    keys = [f"port.{r}" for r in range(N)] + ["shim"]
    return {k: dict(np.load(out / f"{part}.{k}.npz", allow_pickle=False))
            for k in keys}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return world_results(tmp_path_factory, "tf")


def _close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} x {scale}"


# Keys of rank-0 results equal to the shim's bitwise (Sum, integer, min,
# max, gathers and exchanges) and within TOL (averages and steps).
EXACT = ("ar/sum", "ar/min", "ar/max", "ar/scaled", "ar/int_avg", "gar/0",
         "gar/1", "ag", "bc", "a2a", "rs/sum", "gag/0", "gag/1", "grs/0",
         "grs/1", "sp/sum", "bvars", "state/restored", "state/synced",
         "state/step", "kstate/restored_ok", "hook",
         *[f"graph{r}/{k}" for r in (0, 1) for k in (0, 1, 2, 4, 5)])
CLOSE = ("ar/avg", "rs/avg", "sp/avg", "sp/dense", "graph0/3", "graph1/3",
         "tape/eager", "tape/graph", "adasum/v", "adasum/u",
         "kstate/synced",
         *[f"opt/{t}/{m}" for t in ("plain", "predivide", "agg_avg",
                                    "agg_sum") for m in ("eager", "graph")])


@pytest.mark.parametrize("key", EXACT + CLOSE)
def test_replicated_inputs_match_the_jax_shim(runs, key):
    """Rank 0's result on the replicated inputs equals the JAX shim's
    (rank 1's too, where the collective gives every rank the same
    value)."""
    want = runs["shim"][f"rep/{key}"]
    got = runs["port.0"][f"rep/{key}"]
    assert got.shape == want.shape and got.dtype == want.dtype, key
    if key in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want, TOL, key)
    if not any(key.startswith(k) for k in ("a2a", "rs", "grs", "graph")):
        np.testing.assert_array_equal(runs["port.1"][f"rep/{key}"], got)


def test_graph_mode_declares_static_shapes(runs):
    for r in range(N):
        assert str(runs[f"port.{r}"]["rep/graph/shapes"]) == \
            str(runs["shim"]["rep/graph/shapes"]) == repr(
                [(8, 3), (4, 3), (4, 3), (4, 3), (2, 3), (4, 3)])


MATRIX_KEYS = [f"dm/{t}/{name}" for tag, names in MATRIX.items()
               for name in names
               for t in ((tag,) if tag != "g" else ("g0", "g1"))]


@pytest.mark.parametrize("key", MATRIX_KEYS)
def test_dtype_matrix_matches_the_jax_shim(runs, key):
    """Every dtype of the TF matrix: the shim's values bitwise (small
    integers: exact at 32 bits and at full width); both shims give the
    input's dtype back (asserted as each result is recorded)."""
    want = runs["shim"][f"rep/{key}"]
    for r in range(N):
        if key.startswith("dm/a2a") and r:
            continue
        np.testing.assert_array_equal(runs[f"port.{r}"][f"rep/{key}"], want)


@pytest.fixture(scope="module")
def own(runs):
    return [runs[f"port.{r}"] for r in range(N)], [_data(r)
                                                   for r in range(N)]


def test_own_inputs_reduce_as_by_hand(own):
    """Each rank its own tensor: the sums of two operands bitwise, the
    gathers and exchanges as reference Horovod defines them per rank."""
    import torch

    outs, data = own
    x = [d["x"] for d in data]
    total = x[0] + x[1]
    ints = [d["ints"] for d in data]
    for r in range(N):
        o = outs[r]
        np.testing.assert_array_equal(o["own/ar/sum"], total)
        np.testing.assert_array_equal(
            o["own/ar/avg"], (torch.from_numpy(total) /
                              torch.tensor(2.0)).numpy())
        np.testing.assert_array_equal(o["own/ar/min"], np.minimum(*x))
        np.testing.assert_array_equal(o["own/ar/max"], np.maximum(*x))
        pre = np.float32(PRE)
        np.testing.assert_array_equal(
            o["own/ar/scaled"], (x[0] * pre + x[1] * pre) * np.float32(POST))
        np.testing.assert_array_equal(
            o["own/ar/int_avg"],
            ((ints[0] + ints[1]) / np.float32(2)).astype(np.int32))
        for i in range(2):
            g = [d["grp"][i] for d in data]
            np.testing.assert_array_equal(
                o[f"own/gar/{i}"], (g[0] * pre + g[1] * pre)
                * np.float32(POST))
        np.testing.assert_array_equal(o["own/ag"], np.concatenate(x))
        np.testing.assert_array_equal(o["own/bc"], x[1])
        np.testing.assert_array_equal(o["own/bvars"], x[1])
        np.testing.assert_array_equal(
            o["own/a2a"], np.concatenate([xi[2 * r:2 * r + 2] for xi in x]))
        np.testing.assert_array_equal(o["own/rs/sum"],
                                      total[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["own/gag/1"], np.concatenate(ints))
        np.testing.assert_array_equal(
            o["own/grs/1"], (ints[0] + ints[1])[2 * r:2 * r + 2])
        for rep in (0, 1):
            np.testing.assert_array_equal(o[f"own/graph{rep}/0"],
                                          np.concatenate(x))
            np.testing.assert_array_equal(o[f"own/graph{rep}/1"], x[1])
            np.testing.assert_array_equal(o[f"own/graph{rep}/2"], total)
            np.testing.assert_array_equal(o[f"own/graph{rep}/4"],
                                          total[2 * r:2 * r + 2])


def test_own_sparse_slices_gather_every_rank(own):
    """Ranks hold 2 and 3 slices: the gathered values and indices sum
    (Sum) or average (Average) as the dense gradients do."""
    outs, data = own
    dense = []
    for d in data:
        z = np.zeros((5, 3), np.float64)
        np.add.at(z, d["sp_idx"], d["sp_val"])
        dense.append(z)
    for r in range(N):
        _close(outs[r]["own/sp/sum"], dense[0] + dense[1], 1e-6, "sum")
        _close(outs[r]["own/sp/avg"], (dense[0] + dense[1]) / 2, 1e-6,
               "avg")
        _close(outs[r]["own/sp/dense"], (dense[0] + dense[1]) / 2, 1e-6,
               "dense")


def _grad(d, w):
    X, y = d["X"].astype(np.float64), d["y"].astype(np.float64)
    return 2.0 * X.T @ (X @ w - y) / y.size


def test_own_tape_and_optimizer_average_the_ranks(own):
    """The tape's gradient is the mean of both ranks' (eager and traced);
    each optimizer case applies what its options say to the mean of the
    ranks' gradients; both ranks end with the same weights."""
    outs, data = own
    w0 = data[0]["w0"].astype(np.float64)
    mean = (_grad(data[0], w0) + _grad(data[1], w0)) / 2
    g = [[d["grads"][k].astype(np.float64) for d in data] for k in (0, 1)]
    avg = [(a + b) / 2 for a, b in g]
    want = {"plain": w0 - 0.1 * avg[0] - 0.1 * avg[1],
            "predivide": w0 - 0.1 * avg[0] - 0.1 * avg[1],
            "agg_avg": w0 - 0.1 * (avg[0] + avg[1]) / 2,
            "agg_sum": w0 - 0.1 * (avg[0] + avg[1])}
    for r in range(N):
        o = outs[r]
        for mode in ("eager", "graph"):
            _close(o[f"own/tape/{mode}"], mean, 1e-5, f"tape {mode}")
            for tag, w in want.items():
                _close(o[f"own/opt/{tag}/{mode}"], w, 1e-6, f"{tag} {mode}")
                np.testing.assert_array_equal(
                    o[f"own/opt/{tag}/{mode}"],
                    outs[0][f"own/opt/{tag}/{mode}"])


def test_own_adasum_optimizer_combines_the_deltas(own):
    """Each rank's SGD delta, Adasum-combined over the fused vector of
    both variables: (1 - a.b / 2|a|^2) a + (1 - a.b / 2|b|^2) b."""
    outs, data = own
    deltas = [np.concatenate([-0.5 * d["grads"][0].ravel(),
                              -0.5 * d["grads"][1][:1].ravel()]
                             ).astype(np.float64) for d in data]
    a, b = deltas
    dot = a @ b
    comb = (1 - dot / (2 * (a @ a))) * a + (1 - dot / (2 * (b @ b))) * b
    w0 = data[0]["w0"].astype(np.float64)
    want_v = w0 + comb[:8].reshape(4, 2)
    want_u = 2.0 * w0[:1] + comb[8:].reshape(1, 2)
    for r in range(N):
        _close(outs[r]["own/adasum/v"], want_v, 1e-5, "v")
        _close(outs[r]["own/adasum/u"], want_u, 1e-5, "u")


def test_own_states_sync_rank0(own):
    """``sync()`` gives every rank rank 0's committed weights; the hook
    broadcasts rank 0's variables."""
    outs, data = own
    for r in range(N):
        o = outs[r]
        np.testing.assert_array_equal(o["own/state/restored"],
                                      data[r]["x"])
        np.testing.assert_array_equal(o["own/state/synced"],
                                      data[0]["grp"][1] + np.float32(1.0))
        assert bool(o["own/kstate/restored_ok"])
        np.testing.assert_array_equal(o["own/kstate/synced"],
                                      outs[0]["own/kstate/synced"])
        np.testing.assert_array_equal(o["own/hook"], data[0]["x"])


def test_objects(own):
    outs, _ = own
    for r in range(N):
        assert int(outs[r]["obj/bcast"]) == 1
        assert list(outs[r]["obj/gather"]) == [0, 10]


def test_the_shims_resolve_through_the_top_level():
    import horovod_tpu_torch as hvd

    assert hvd.tensorflow.__name__ == "horovod_tpu_torch.tensorflow"
    assert hvd.mxnet.__name__ == "horovod_tpu_torch.mxnet"
    assert hvd.tensorflow.allreduce is not None
    from horovod_tpu_torch.tensorflow.keras import DistributedOptimizer

    assert callable(DistributedOptimizer)


def test_predivide_requires_average(runs):
    assert "op=Average" in str(runs["port.0"]["predivide_error"])


def test_bfloat16_crosses_the_numpy_boundary(monkeypatch):
    """TF's bfloat16 host arrays (ml_dtypes) round-trip through torch
    bit for bit; other dtypes keep theirs."""
    import ml_dtypes
    import torch

    from horovod_tpu_torch.common import host_bridge

    monkeypatch.setattr(host_bridge, "device", lambda: torch.device("cpu"))
    a = np.array([1.5, -2.25, 3.0e-3, 65504.0], ml_dtypes.bfloat16)
    t = host_bridge.to_torch(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    back = host_bridge.to_numpy(t, a.dtype)
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back.view(np.int16), a.view(np.int16))
    np.testing.assert_array_equal(host_bridge.to_numpy(t, np.float32),
                                  a.astype(np.float32))
    for dt in (np.uint8, np.int64, np.float16, np.float64):
        x = np.arange(5).astype(dt)
        y = host_bridge.to_torch(x)
        y.add_(1)  # a copy: the caller's array is untouched
        assert host_bridge.to_numpy(y, dt).dtype == dt
        np.testing.assert_array_equal(x, np.arange(5).astype(dt))


if __name__ == "__main__" and sys.argv[1:2] == ["--tf-worker"]:
    _tf_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
if __name__ == "__main__" and sys.argv[1:2] == ["--shim-oracle"]:
    _shim_oracle(int(sys.argv[2]), sys.argv[3])
