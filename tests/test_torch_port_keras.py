"""The port's Keras surface (``horovod_tpu_torch.keras``, its callbacks
and elastic states, and the ``tensorflow.keras`` alias) against the JAX
package's (``horovod_tpu.keras``): ``test_keras_namespace.py``'s cases.

The cases run in ``test_torch_port_tf_shim.py``'s session world (one
TensorFlow start-up a process): its gloo world of 2 ranks (on the CPU)
runs :func:`rank_cases`, and its JAX oracle on a 2-device CPU mesh
:func:`oracle_cases`.

* Replicated inputs (every rank the same data and initial weights):
  each fit's weights and loss history equal the JAX surface's within
  1e-6 of the largest magnitude; the allreduce results bitwise.
* Each rank its own data: an SGD fit with the broadcast and
  metric-average callbacks ends with the same weights on both ranks,
  within 1e-5 of a single-process fit that takes both ranks' batches
  together (the mean gradient of two equal batches), and with the same
  averaged loss history; rank 0's initial weights win the broadcast.
* ``load_model`` wraps saved optimizers (plain, distributed, custom),
  the elastic ``KerasState`` and its callbacks, the LR callbacks, and
  ``BestModelCheckpoint`` writes on rank 0 only.
"""

import os

import numpy as np
import pytest


N = 2
TOL = 1e-6
OWN_TOL = 1e-5
ROWS, BATCH, EPOCHS = 16, 8, 3


def _data(rank):
    g = np.random.default_rng(3000 if rank is None else 3010 + rank)
    return {"x": g.standard_normal((ROWS, 4)).astype(np.float32),
            "y": g.standard_normal((ROWS, 3)).astype(np.float32),
            "w": [g.standard_normal((4, 3)).astype(np.float32),
                  g.standard_normal(3).astype(np.float32)],
            "t": g.standard_normal(5).astype(np.float32)}


def _model(keras, w=None):
    m = keras.Sequential([keras.layers.Input((4,)),
                          keras.layers.Dense(3, name="d")])
    if w is not None:
        m.set_weights(w)
    return m


def _fit(hvdk, keras, d, opt, tmp, tag, extra=()):
    m = _model(keras, d["w"])
    m.compile(optimizer=opt, loss="mse")
    hist = m.fit(d["x"], d["y"], epochs=EPOCHS, batch_size=BATCH,
                 verbose=0, shuffle=False,
                 callbacks=[hvdk.callbacks.BroadcastGlobalVariablesCallback(
                     0), hvdk.callbacks.MetricAverageCallback(), *extra])
    return m, hist


def _run(hvdk, d, out, prefix, tmp):
    import keras
    import tensorflow as tf

    t = tf.constant(d["t"])
    out[f"{prefix}ar/avg"] = hvdk.allreduce(t, name="k.avg").numpy()
    out[f"{prefix}ar/sum"] = hvdk.allreduce(t, average=False,
                                            name="k.sum").numpy()
    out[f"{prefix}ar/scaled"] = hvdk.allreduce(
        t, average=False, prescale_factor=0.5, postscale_factor=3.0,
        name="k.scaled").numpy()
    out[f"{prefix}ag"] = hvdk.allgather(t, name="k.ag").numpy()
    out[f"{prefix}bc"] = hvdk.broadcast(t, 0, name="k.bc").numpy()

    m = _model(keras, d["w"])
    m.compile(optimizer=keras.optimizers.SGD(0.1), loss="mse")
    hvdk.broadcast_global_variables(0, model=m)
    for i, w in enumerate(m.get_weights()):
        out[f"{prefix}bgv/{i}"] = w

    for tag, make in (("sgd", lambda: keras.optimizers.SGD(0.1)),
                      ("adam", lambda: keras.optimizers.Adam(0.01))):
        opt = hvdk.DistributedOptimizer(make())
        out[f"{prefix}fit/{tag}/cls"] = np.array(type(opt).__name__)
        extra = []
        if tag == "sgd":
            extra = [hvdk.callbacks.LearningRateScheduleCallback(
                        0.1, lambda e: 0.5 ** e, staircase=True),
                     hvdk.callbacks.BestModelCheckpoint(
                        os.path.join(tmp, "best.keras"), monitor="loss")]
        m, hist = _fit(hvdk, keras, d, opt, tmp, tag, extra)
        for i, w in enumerate(m.get_weights()):
            out[f"{prefix}fit/{tag}/w{i}"] = w
        out[f"{prefix}fit/{tag}/loss"] = np.array(hist.history["loss"])
    out[f"{prefix}best_written"] = np.array(
        os.path.exists(os.path.join(tmp, "best.keras")))

    # load_model: distributed, plain and custom optimizers come back
    # wrapped, with their weights and learning rate.
    x, y = d["x"][:8], d["y"][:8]
    m = _model(keras, d["w"])
    m.compile(optimizer=hvdk.DistributedOptimizer(keras.optimizers.Adam(
        learning_rate=0.025)), loss="mse")
    m.fit(x, y, epochs=1, verbose=0, shuffle=False)
    path = os.path.join(tmp, f"{prefix[:-1]}_model.keras")
    m.save(path)
    m2 = hvdk.load_model(path)
    out[f"{prefix}load/cls"] = np.array(type(m2.optimizer).__name__)
    out[f"{prefix}load/lr"] = np.array(float(np.asarray(
        m2.optimizer.learning_rate)))
    out[f"{prefix}load/same"] = np.array(all(
        np.array_equal(a, b) for a, b in zip(m.get_weights(),
                                             m2.get_weights())))
    m2.fit(x, y, epochs=1, verbose=0, shuffle=False)
    out[f"{prefix}load/refit"] = m2.get_weights()[0]

    class MyOpt(keras.optimizers.SGD):
        pass

    for tag, opt, kw in (("plain", keras.optimizers.Adam(0.01), {}),
                         ("custom", MyOpt(0.1),
                          {"custom_optimizers": [MyOpt]})):
        m = _model(keras, d["w"])
        m.compile(optimizer=opt, loss="mse")
        m.fit(x, y, epochs=1, verbose=0, shuffle=False)
        path = os.path.join(tmp, f"{prefix[:-1]}_{tag}.keras")
        m.save(path)
        out[f"{prefix}load/{tag}"] = np.array(
            type(hvdk.load_model(path, **kw).optimizer).__name__)

    # The elastic state and its callbacks inside fit.
    m = _model(keras, d["w"])
    m.compile(optimizer=keras.optimizers.SGD(0.1), loss="mse")
    m.fit(x[:4], y[:4], epochs=1, verbose=0, shuffle=False)
    state = hvdk.elastic.KerasState(m, batch=0, epoch=0)
    w0 = [w.copy() for w in m.get_weights()]
    m.set_weights([w + 1.0 for w in w0])
    state.restore()
    out[f"{prefix}el/restored"] = np.array(
        state.optimizer is m.optimizer and bool(state._saved_opt)
        and all(np.array_equal(a, b) for a, b in zip(m.get_weights(), w0)))
    m.fit(x, y, epochs=2, batch_size=4, verbose=0, shuffle=False,
          callbacks=[hvdk.elastic.CommitStateCallback(state, 2),
                     hvdk.elastic.UpdateBatchStateCallback(state),
                     hvdk.elastic.UpdateEpochStateCallback(state)])
    out[f"{prefix}el/epoch_batch"] = np.array([state.epoch, state.batch])
    state.sync()
    out[f"{prefix}el/synced"] = m.get_weights()[0]

    # The warmup callback's first and last learning rates.
    m = _model(keras, d["w"])
    opt = keras.optimizers.SGD(learning_rate=0.8)
    m.compile(optimizer=opt, loss="mse")
    cb = hvdk.callbacks.LearningRateWarmupCallback(
        initial_lr=0.8, warmup_epochs=2, steps_per_epoch=4)
    cb.set_model(m)
    cb.on_epoch_begin(0)
    cb.on_batch_begin(0)
    lrs = [float(opt.learning_rate)]
    cb.on_epoch_begin(1)
    cb.on_batch_begin(4)
    lrs.append(float(opt.learning_rate))
    out[f"{prefix}warmup"] = np.array(lrs)


def _surface_checks(hvdk):
    import keras

    import horovod_tpu_torch.tensorflow.keras as alias

    assert alias.DistributedOptimizer is hvdk.DistributedOptimizer
    assert alias.load_model is hvdk.load_model
    assert alias.callbacks.MetricAverageCallback is \
        hvdk.callbacks.MetricAverageCallback
    assert alias.elastic.KerasState is hvdk.elastic.KerasState
    assert hvdk.xla_built() is False and hvdk.tpu_available() is False
    with pytest.raises(ValueError, match="Average and Sum"):
        hvdk.DistributedOptimizer(keras.optimizers.SGD(0.1), op=hvdk.Max)
    with pytest.raises(ValueError, match="BroadcastGlobalVariables"):
        hvdk.broadcast_global_variables(0)


def rank_cases(rank: int, n: int, tmp: str) -> dict:
    """This rank's cases in the live port world (``--tf-worker`` of
    ``test_torch_port_tf_shim.py`` calls it)."""
    import horovod_tpu_torch.keras as hvdk

    assert hvdk.rank() == rank and hvdk.size() == n
    _surface_checks(hvdk)
    out = {}
    for prefix, d in (("rep/", _data(None)), ("own/", _data(rank))):
        sub = os.path.join(tmp, f"keras_rank{rank}", prefix[:-1])
        os.makedirs(sub, exist_ok=True)
        _run(hvdk, d, out, prefix, sub)
    return out


def reference_cases(n: int) -> dict:
    """The single-process reference fit (rank 0, after its world)."""
    return {f"ref/w{i}": w for i, w in
            enumerate(_reference_fit([_data(r) for r in range(n)]))}


def oracle_cases(tmp: str) -> dict:
    """The JAX surface's cases on the replicated inputs, in the oracle
    process (the JAX package initialized on its n-device mesh)."""
    import horovod_tpu.keras as hvdk

    out = {}
    sub = os.path.join(tmp, "keras_shim")
    os.makedirs(sub, exist_ok=True)
    _run(hvdk, _data(None), out, "rep/", sub)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_port_tf_shim import world_results

    return world_results(tmp_path_factory, "keras")


def _close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} x {scale}"


EXACT = ("ar/sum", "ar/scaled", "ag", "bc", "bgv/0", "bgv/1",
         "fit/sgd/cls", "fit/adam/cls", "load/cls", "load/lr", "load/same",
         "load/plain", "load/custom", "el/restored", "el/epoch_batch",
         "warmup")
CLOSE = ("ar/avg", "load/refit", "el/synced",
         *[f"fit/{t}/{k}" for t in ("sgd", "adam")
           for k in ("w0", "w1", "loss")])


@pytest.mark.parametrize("key", EXACT + CLOSE)
def test_replicated_inputs_match_the_jax_surface(runs, key):
    want = runs["shim"][f"rep/{key}"]
    for r in range(N):
        got = runs[f"port.{r}"][f"rep/{key}"]
        assert got.shape == want.shape, key
        if key in EXACT:
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, TOL, f"{key} rank {r}")


def test_class_names_and_warmup(runs):
    o = runs["port.0"]
    assert str(o["rep/fit/adam/cls"]) == "DistributedAdam"
    assert str(o["rep/load/plain"]) == "DistributedAdam"
    assert str(o["rep/load/custom"]) == "DistributedMyOpt"
    np.testing.assert_allclose(o["rep/warmup"], [0.8 / N, 0.8], rtol=1e-6)
    assert list(o["rep/el/epoch_batch"]) == [2, 0]


def test_best_checkpoint_written_by_rank0_only(runs):
    assert bool(runs["port.0"]["rep/best_written"])
    assert not bool(runs["port.1"]["rep/best_written"])


def _reference_fit(data):
    """A single-process SGD fit on both ranks' batches together: batch i
    is rank 0's batch i then rank 1's (the mean of two equal batches'
    mean gradients), rank 0's initial weights, the same LR schedule
    (rank 0's worker runs it after its world is shut down)."""
    import keras

    xs, ys = [], []
    for i in range(0, ROWS, BATCH):
        for d in data:
            xs.append(d["x"][i:i + BATCH])
            ys.append(d["y"][i:i + BATCH])
    m = _model(keras, data[0]["w"])
    opt = keras.optimizers.SGD(0.1)
    m.compile(optimizer=opt, loss="mse")

    class Schedule(keras.callbacks.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            opt.learning_rate = 0.1 * 0.5 ** epoch

    m.fit(np.concatenate(xs), np.concatenate(ys), epochs=EPOCHS,
          batch_size=N * BATCH, verbose=0, shuffle=False,
          callbacks=[Schedule()])
    return m.get_weights()


def test_own_inputs_fit_as_one_process(runs):
    outs = [runs[f"port.{r}"] for r in range(N)]
    data = [_data(r) for r in range(N)]
    for r in range(N):
        for i in range(2):
            _close(outs[r][f"own/fit/sgd/w{i}"], outs[0][f"ref/w{i}"],
                   OWN_TOL, f"w{i} r{r}")
        for key in ("fit/sgd/w0", "fit/sgd/w1", "fit/sgd/loss",
                    "fit/adam/w0", "fit/adam/loss", "el/synced"):
            np.testing.assert_array_equal(outs[r][f"own/{key}"],
                                          outs[0][f"own/{key}"])
        np.testing.assert_array_equal(outs[r]["own/bgv/0"],
                                      data[0]["w"][0])
        np.testing.assert_array_equal(outs[r]["own/bc"], data[0]["t"])


def test_own_allreduce_flags(runs):
    data = [_data(r) for r in range(N)]
    t = [d["t"] for d in data]
    for r in range(N):
        o = runs[f"port.{r}"]
        np.testing.assert_array_equal(o["own/ar/sum"], t[0] + t[1])
        np.testing.assert_array_equal(o["own/ag"], np.concatenate(t))
        _close(o["own/ar/avg"], (t[0] + t[1]) / 2, 1e-7, "avg")
