"""The port's ``KerasEstimator`` against the JAX package's: one seeded
tf.keras model fitted over a pool of 2 workers by each package on the
same data, initial weights and optimizer (SGD, mse, a validation split).

* The pools: one port ``Executor`` of 2 (``device="cpu"``, gloo) and
  one JAX ``Executor`` of 2 (one CPU device a worker), run side by side
  once a test session under the session's world slot; both packages fit the
  pickle format and the parquet format through ``fit(executor=)``.
* Keras shuffles each epoch from its global seed, so every worker of
  both pools is seeded alike first (``keras.utils.set_random_seed``).
* Every epoch's loss and validation loss, the final weights and
  ``transform`` are held to 1e-6 of the JAX value's largest magnitude
  (``RTOL``); ``TrainedKerasModel.load`` reads back the same model; the
  ``spark.keras`` import path names the same classes.
"""

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from test_torch_port_worlds import REPO, TF_ENV, session_world, world_slot

RTOL = 1e-6
SEED = 1234
ROWS, FEATURES, EPOCHS, BATCH, LR, VAL = 40, 4, 2, 8, 0.05, 0.2
QUIET = {**TF_ENV, "OMP_NUM_THREADS": "1"}
JAX_WORKER_ENV = {"XLA_FLAGS": "--xla_force_host_platform_device_count=1",
                  "HVD_TPU_FORCE_CPU_DEVICES": "1", "JAX_PLATFORMS": "cpu",
                  **QUIET}
PORT_WORKER_ENV = {**QUIET, "PYTHONPATH": os.pathsep.join(
    [str(REPO / "tests"), str(REPO)]
    + [p for p in [os.environ.get("PYTHONPATH")] if p])}


def _data():
    g = np.random.default_rng(20)
    X = g.standard_normal((ROWS, FEATURES)).astype(np.float32)
    w = g.standard_normal((FEATURES, 2)).astype(np.float32)
    return X, (X @ w).astype(np.float32)


def _model():
    import tensorflow as tf

    g = np.random.default_rng(21)
    m = tf.keras.Sequential([tf.keras.layers.Input((FEATURES,)),
                             tf.keras.layers.Dense(6, activation="tanh"),
                             tf.keras.layers.Dense(2)])
    m.set_weights([g.standard_normal(w.shape).astype(np.float32) * 0.5
                   for w in m.get_weights()])
    m.compile(optimizer=tf.keras.optimizers.SGD(LR), loss="mse")
    return m


def _record(trained, X):
    return {"history": trained.history, "val_history": trained.val_history,
            "weights": trained.model.get_weights(),
            "transform": trained.transform(X)}


def _fits(KerasEstimator, TrainedKerasModel, store, ex, prefix, **kw):
    import keras

    X, y = _data()
    rec = {}
    # Keras shuffles each epoch's batches from its global seed: seed
    # every worker of both pools alike, so both packages' fits draw the
    # same orders.
    ex.run(keras.utils.set_random_seed, args=(SEED,))
    for fmt in ("pickle", "parquet"):
        run_id = f"{prefix}_{fmt}"
        trained = KerasEstimator(
            model=_model(), store=store, num_proc=2, epochs=EPOCHS,
            batch_size=BATCH, run_id=run_id, data_format=fmt, **kw).fit(
                X, y, validation=VAL, executor=ex)
        rec[fmt] = _record(trained, X)
        rec[fmt]["reloaded"] = TrainedKerasModel.load(store, run_id
                                                      ).transform(X)
    return rec


def _run(out):
    from horovod_tpu.executor import Executor as JExecutor
    from horovod_tpu.keras_estimator import KerasEstimator as JEst
    from horovod_tpu.keras_estimator import TrainedKerasModel as JTrained
    from horovod_tpu.store import LocalStore as JLocalStore
    from horovod_tpu_torch.executor import Executor
    from horovod_tpu_torch.keras_estimator import (KerasEstimator,
                                                   TrainedKerasModel)
    from horovod_tpu_torch.store import LocalStore

    def port():
        with Executor(np=2, env=PORT_WORKER_ENV) as ex:
            return _fits(KerasEstimator, TrainedKerasModel,
                         LocalStore(str(out / "port")), ex, "port",
                         device="cpu")

    def jax():
        with JExecutor(np=2, env=JAX_WORKER_ENV) as ex:
            return _fits(JEst, JTrained, JLocalStore(str(out / "jax")), ex,
                         "jax")

    # The two pools side by side: their workers spend most of the run
    # importing TensorFlow.
    with world_slot(), ThreadPoolExecutor(max_workers=2) as pool:
        futures = {"port": pool.submit(port), "jax": pool.submit(jax)}
        rec = {k: f.result() for k, f in futures.items()}
    with open(out / "results.pkl", "wb") as f:
        pickle.dump(rec, f)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    out = session_world(tmp_path_factory, "keras_estimators", _run)
    with open(out / "results.pkl", "rb") as f:
        return pickle.load(f)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: {err} > {RTOL} x {scale}"


@pytest.mark.parametrize("fmt", ["pickle", "parquet"])
@pytest.mark.parametrize("key", ["history", "val_history", "weights",
                                 "transform", "reloaded"])
def test_keras_estimator_matches_jax(fits, fmt, key):
    got, want = fits["port"][fmt][key], fits["jax"][fmt][key]
    if key == "weights":
        assert len(got) == len(want) == 4
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{fmt} weight {i}")
        return
    if key.endswith("history"):
        assert len(got) == len(want) == EPOCHS
    _close(got, want, f"{fmt} {key}")


def test_keras_estimator_trains(fits):
    for fmt in ("pickle", "parquet"):
        hist = fits["port"][fmt]["history"]
        assert hist[-1] < hist[0]
        np.testing.assert_array_equal(fits["port"][fmt]["reloaded"],
                                      fits["port"][fmt]["transform"])


def test_spark_keras_import_path():
    from horovod_tpu_torch import keras_estimator
    from horovod_tpu_torch.spark import keras as spark_keras

    assert spark_keras.KerasEstimator is keras_estimator.KerasEstimator
    assert spark_keras.KerasModel is keras_estimator.TrainedKerasModel


def test_keras_estimator_requires_a_store():
    from horovod_tpu_torch.keras_estimator import KerasEstimator

    with pytest.raises(ValueError, match="store"):
        KerasEstimator(model=None).fit(*_data())
    with pytest.raises(ValueError):
        KerasEstimator(model=None, data_format="csv")
