"""The port's cluster layer against the JAX package's: the executor pool
(``test_executor.py``'s cases), the parquet shards, the rank shard and
the validation split, and the two estimators fitted over a pool of 2 by
each package on the same seeded numpy data.

* The pools: one port ``Executor`` of 2 (``device="cpu"``, gloo) and one
  JAX ``Executor`` of 2 (one CPU device a worker), each started once a
  test session (``test_torch_port_worlds.session_world``) under the
  session's world slot; every fit of a package goes through its pool
  (``fit(executor=)``). The cases read what the session's run recorded.
* ``Estimator``: the JAX flax MLP's ``model.init(PRNGKey(seed), X[:1])``
  carried into the port's ``MLP`` with ``models/convert.py``,
  ``optax.sgd`` matched by ``torch.optim.SGD``; the pickle format with
  ``softmax_cross_entropy`` (integer labels), the parquet format with
  ``mse``. Per-epoch ``history``/``val_history``, the final checkpoint
  and ``transform`` are held to 1e-5 of the JAX value's largest
  magnitude (``EST_RTOL``).
* ``TorchEstimator``: one seeded torch model fitted by the JAX
  estimator (the JAX package's PyTorch shim in its workers) and by the
  port (its ``DistributedOptimizer`` and ``broadcast_parameters``), SGD,
  mse. The final ``state_dict`` is held to 1e-6 (``TORCH_EST_RTOL``);
  on this data it is also bitwise equal (both average two fp32
  gradients, which is exact to the last bit), and the test asserts that
  too.
"""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

from horovod_tpu_torch import estimator as est_mod
from horovod_tpu_torch.executor import Executor
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.mlp import MLP
from horovod_tpu_torch.parquet import ParquetDataset, write_parquet_shards
from horovod_tpu_torch.store import LocalStore
from horovod_tpu_torch.torch_estimator import (TorchEstimator,
                                               TrainedTorchModel)
from test_torch_port_worlds import REPO, session_world, world_slot

EST_RTOL = 1e-5
TORCH_EST_RTOL = 1e-6
ROWS, FEATURES, CLASSES = 64, 4, 3
EPOCHS, BATCH, LR = 3, 8, 0.1
VAL = 0.125
# One CPU device a JAX worker (the conftest's 8 would make each a world
# of 8), the CPU platform, one thread a process.
JAX_WORKER_ENV = {"XLA_FLAGS": "--xla_force_host_platform_device_count=1",
                  "HVD_TPU_FORCE_CPU_DEVICES": "1", "JAX_PLATFORMS": "cpu",
                  "OMP_NUM_THREADS": "1"}
# The workers import this file by name (cloudpickle pickles a module's
# functions by reference).
PORT_WORKER_ENV = {"OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
    [str(REPO / "tests"), str(REPO)]
    + [p for p in [os.environ.get("PYTHONPATH")] if p])}
# (data format, loss, output width): both formats, both named losses.
FITS = {"pickle": ("softmax_cross_entropy", CLASSES),
        "parquet": ("mse", 1)}


def _data(loss: str):
    g = np.random.default_rng(19)
    X = g.standard_normal((ROWS, FEATURES)).astype(np.float32)
    if loss == "mse":
        w = g.standard_normal((FEATURES, 1)).astype(np.float32)
        return X, (X @ w).astype(np.float32)
    return X, g.integers(0, CLASSES, ROWS)


def _torch_model():
    torch.manual_seed(7)
    return torch.nn.Sequential(torch.nn.Linear(FEATURES, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 1))


# -- functions the pools run (module-level: the workers import this file by
#    name where cloudpickle is absent) --------------------------------------

def _probe():
    return int(os.environ["HVD_TPU_PROC_ID"])


def _setup_counter():
    import builtins

    builtins._hvd_port_counter = 10


def _bump_counter():
    import builtins

    builtins._hvd_port_counter += 1
    return builtins._hvd_port_counter


def _boom():
    raise ValueError("remote kaboom")


def _one():
    return 1


def _world_setup():
    import horovod_tpu_torch as hvd

    hvd.shutdown()
    hvd.init(device="cpu")
    return hvd.size()


def _reduce_round(value):
    import horovod_tpu_torch as hvd

    out = hvd.allreduce(torch.full((2,), value), op=hvd.Sum,
                        name=f"round{value}")
    return float(out[0])


# -- the session's run -------------------------------------------------------

def _port_run(ex, store) -> dict:
    import jax
    from horovod_tpu.models import MLP as FlaxMLP

    rec = {"probe": [ex.run(_probe), ex.run(_probe)]}
    ex.run(_setup_counter)
    rec["counter"] = [ex.run(_bump_counter), ex.run(_bump_counter)]
    try:
        ex.run(_boom)
        rec["boom"] = None
    except RuntimeError as e:
        rec["boom"] = str(e)
    rec["after_boom"] = ex.run(_one)
    rec["single"] = ex.execute_single(_probe, rank=1)
    rec["world"] = [ex.run(_world_setup), ex.run(_reduce_round, (3.0,)),
                    ex.run(_reduce_round, (5.0,))]
    for fmt, (loss, width) in FITS.items():
        X, y = _data(loss)
        flax_params = FlaxMLP(features=(16,), num_classes=width).init(
            jax.random.PRNGKey(0), X[:1])
        model = MLP(in_features=FEATURES, features=(16,),
                    num_classes=width)
        model.load_state_dict(convert.mlp_params_from_jax(flax_params))
        est = est_mod.Estimator(
            model=model, optimizer=functools.partial(torch.optim.SGD, lr=LR),
            loss=loss, store=store, num_proc=2, epochs=EPOCHS,
            batch_size=BATCH, run_id=f"port_{fmt}", seed=0,
            data_format=fmt, device="cpu")
        trained = est.fit(X, y, validation=VAL, executor=ex)
        again = est_mod.TrainedModel.load(
            store, f"port_{fmt}", MLP(in_features=FEATURES, features=(16,),
                                      num_classes=width), device="cpu")
        rec[f"est_{fmt}"] = {
            "history": trained.history, "val_history": trained.val_history,
            "ranks": [r["rank"] for r in trained.worker_results],
            "final": trained.params, "transform": trained.transform(X),
            "reloaded": again.transform(X),
            "epoch_ckpts": [store.exists(store.path_join(
                store.get_checkpoint_path(f"port_{fmt}"),
                f"epoch_{e}.pkl")) for e in range(EPOCHS)]}
    X, y = _data("mse")
    trained = TorchEstimator(
        model=_torch_model(), optimizer=functools.partial(
            torch.optim.SGD, lr=LR), loss="mse", store=store, num_proc=2,
        epochs=EPOCHS, batch_size=BATCH, run_id="port_torch",
        device="cpu").fit(X, y, validation=VAL, executor=ex)
    rec["torch_est"] = {
        "state": {k: v.numpy() for k, v in trained.model.state_dict().items()},
        "history": trained.history, "val_history": trained.val_history,
        "transform": trained.transform(X),
        "workers": trained.worker_results}
    # No fallback: without device="cpu" the workers raise (no GPU here).
    try:
        est_mod.Estimator(model=_torch_model(), optimizer=functools.partial(
            torch.optim.SGD, lr=LR), store=store, run_id="port_nogpu").fit(
                X, y, executor=ex)
        rec["no_gpu"] = None
    except RuntimeError as e:
        rec["no_gpu"] = str(e)
    return rec


def _jax_run(store) -> dict:
    import jax
    import optax
    from horovod_tpu.estimator import Estimator as JEstimator
    from horovod_tpu.estimator import TrainedModel as JTrainedModel
    from horovod_tpu.executor import Executor as JExecutor
    from horovod_tpu.models import MLP as FlaxMLP
    from horovod_tpu.torch_estimator import TorchEstimator as JTorchEstimator

    rec = {}
    with JExecutor(np=2, env=JAX_WORKER_ENV) as ex:
        for fmt, (loss, width) in FITS.items():
            X, y = _data(loss)
            model = FlaxMLP(features=(16,), num_classes=width)
            est = JEstimator(model=model, optimizer=optax.sgd(LR),
                             loss=loss, store=store, num_proc=2,
                             epochs=EPOCHS, batch_size=BATCH,
                             run_id=f"jax_{fmt}", seed=0, data_format=fmt)
            trained = est.fit(X, y, validation=VAL, executor=ex)
            again = JTrainedModel.load(store, f"jax_{fmt}", model)
            rec[f"est_{fmt}"] = {
                "history": trained.history,
                "val_history": trained.val_history,
                "final": jax.tree.map(np.asarray, trained.params),
                "transform": np.asarray(trained.transform(X)),
                "reloaded": np.asarray(again.transform(X))}
        X, y = _data("mse")
        trained = JTorchEstimator(
            model=_torch_model(), optimizer=functools.partial(
                torch.optim.SGD, lr=LR), loss="mse", store=store,
            num_proc=2, epochs=EPOCHS, batch_size=BATCH,
            run_id="jax_torch").fit(X, y, validation=VAL, executor=ex)
        rec["torch_est"] = {
            "state": {k: v.numpy()
                      for k, v in trained.model.state_dict().items()},
            "history": trained.history, "val_history": trained.val_history,
            "transform": trained.transform(X)}
    return rec


def _run(out):
    store = LocalStore(str(out / "store"))
    with world_slot():
        with Executor(np=2, env=PORT_WORKER_ENV) as ex:
            port = _port_run(ex, store)
            procs = list(ex._procs)
        port["pool_exited"] = [p.poll() for p in procs]
        jax_rec = _jax_run(store)
    with open(out / "results.pkl", "wb") as f:
        pickle.dump({"port": port, "jax": jax_rec}, f)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    out = session_world(tmp_path_factory, "cluster_estimators", _run)
    with open(out / "results.pkl", "rb") as f:
        return pickle.load(f)


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


# -- the executor (test_executor.py's cases) ----------------------------------

def test_executor_runs_on_every_worker_and_persists(fits):
    assert fits["port"]["probe"] == [[0, 1], [0, 1]]


def test_executor_state_survives_across_runs(fits):
    assert fits["port"]["counter"] == [[11, 11], [12, 12]]


def test_executor_error_carries_remote_traceback(fits):
    msg = fits["port"]["boom"]
    assert msg is not None and "remote kaboom" in msg
    assert "Traceback" in msg and "worker 0" in msg and "worker 1" in msg
    assert fits["port"]["after_boom"] == [1, 1]


def test_executor_execute_single(fits):
    assert fits["port"]["single"] == 1


def test_executor_gloo_world_across_runs(fits):
    assert fits["port"]["world"] == [[2, 2], [6.0, 6.0], [10.0, 10.0]]


def test_executor_shutdown_stops_every_worker(fits):
    assert fits["port"]["pool_exited"] == [0, 0]


def test_executor_failed_start_leaks_nothing(monkeypatch):
    """A worker that cannot connect (here: an interpreter that exits at
    once) fails ``start()`` within its timeout and leaves no process or
    socket behind."""
    import subprocess
    import sys

    started = []
    real = subprocess.Popen

    def popen(argv, **kw):
        p = real([sys.executable, "-c", "raise SystemExit(3)"], **kw)
        started.append(p)
        return p

    monkeypatch.setattr(subprocess, "Popen", popen)
    ex = Executor(np=2, start_timeout_s=2.0)
    with pytest.raises(OSError):
        ex.start()
    assert len(started) == 2 and all(p.poll() is not None for p in started)
    assert ex._server is None and not ex._procs and not ex._socks
    with pytest.raises(RuntimeError, match="not started"):
        ex.run(_one)


# -- parquet, the rank shard and the validation split -------------------------

def _columns(rows: int):
    g = np.random.default_rng(rows)
    return {"x": g.standard_normal((rows, 2, 3)).astype(np.float32),
            "y": g.integers(0, 5, rows)}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("rows,shards,size", [(10, 4, 2), (9, 3, 3),
                                              (5, 2, 3)])
def test_parquet_shards_cross_read(tmp_path, writer, rows, shards, size):
    """Shards one package writes, the other reads: the same rows, in the
    same split over the ranks (an empty rank gets 0 rows of each
    column's shape)."""
    from horovod_tpu import parquet as jparquet
    from horovod_tpu.store import LocalStore as JLocalStore

    cols = _columns(rows)
    root = str(tmp_path / "root")
    port_store, jax_store = LocalStore(root), JLocalStore(root)
    if writer == "port":
        write_parquet_shards(port_store, root + "/ds", cols, shards)
        readers = (jparquet.ParquetDataset, jax_store)
        same = (ParquetDataset, port_store)
    else:
        jparquet.write_parquet_shards(jax_store, root + "/ds", cols, shards)
        readers = (ParquetDataset, port_store)
        same = (jparquet.ParquetDataset, jax_store)
    got, want = [], []
    for rank in range(size):
        a = readers[0](readers[1], root + "/ds", rank=rank, size=size)
        b = same[0](same[1], root + "/ds", rank=rank, size=size)
        assert a.total_rows == b.total_rows == rows
        got.append(a.load())
        want.append(b.load())
        for k in cols:
            assert got[-1][k].dtype == cols[k].dtype
            np.testing.assert_array_equal(got[-1][k], want[-1][k])
    # Rank r holds the contiguous files r, r + size, ...: their rows in
    # that order, over every rank, are the whole dataset.
    bounds = np.linspace(0, rows, shards + 1, dtype=int)
    order = np.concatenate([np.arange(bounds[f], bounds[f + 1])
                            for r in range(size)
                            for f in range(r, shards, size)])
    for k in cols:
        np.testing.assert_array_equal(
            np.concatenate([g[k] for g in got]), cols[k][order])


def test_parquet_batches_match_jax(tmp_path):
    from horovod_tpu import parquet as jparquet
    from horovod_tpu.store import LocalStore as JLocalStore

    cols = _columns(23)
    root = str(tmp_path)
    write_parquet_shards(LocalStore(root), root + "/ds", cols, 3)
    a = list(ParquetDataset(LocalStore(root), root + "/ds", batch_size=4,
                            shuffle_seed=5))
    b = list(jparquet.ParquetDataset(JLocalStore(root), root + "/ds",
                                     batch_size=4, shuffle_seed=5))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in cols:
            np.testing.assert_array_equal(x[k], y[k])
    assert ParquetDataset(LocalStore(root), root + "/ds").num_rows() == 23


@pytest.mark.parametrize("rows,nproc", [(64, 2), (10, 3), (7, 4), (5, 1)])
def test_rank_shard_matches_jax(rows, nproc):
    from horovod_tpu import estimator as jest

    X = np.arange(rows * 2).reshape(rows, 2)
    y = np.arange(rows)
    for rank in range(nproc):
        for a, b in zip(est_mod.rank_shard(X, y, rank, nproc),
                        jest.rank_shard(X, y, rank, nproc)):
            np.testing.assert_array_equal(a, b)


def test_rank_shard_rejects_an_empty_rank():
    with pytest.raises(ValueError, match="cannot feed"):
        est_mod.rank_shard(np.zeros((2, 1)), np.zeros(2), 0, 3)


@pytest.mark.parametrize("validation,seed", [(0.125, 0), (0.3, 4), (None, 0)])
def test_split_validation_matches_jax(validation, seed):
    from horovod_tpu import estimator as jest

    X, y = _data("mse")
    a = est_mod.split_validation(X, y, validation, seed=seed)
    b = jest.split_validation(X, y, validation, seed=seed)
    for u, v in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(u, v)
    if validation is None:
        assert a[2] is None and b[2] is None
    else:
        for u, v in zip(a[2], b[2]):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("name", ["mse", "softmax_cross_entropy"])
def test_losses_match_optax(name):
    import jax.numpy as jnp
    from horovod_tpu import estimator as jest

    g = np.random.default_rng(3)
    pred = g.standard_normal((6, 5)).astype(np.float32)
    y = (g.standard_normal((6, 5)).astype(np.float32) if name == "mse"
         else g.integers(0, 5, 6))
    got = float(est_mod._resolve_loss(name)(torch.from_numpy(pred),
                                            torch.from_numpy(y)))
    want = float(jest._resolve_loss(name)(jnp.asarray(pred), jnp.asarray(y)))
    assert abs(got - want) <= 1e-6 * abs(want)
    with pytest.raises(ValueError, match="unknown loss"):
        est_mod._resolve_loss("hinge")


# -- the estimators against the JAX ones --------------------------------------

@pytest.mark.parametrize("fmt", list(FITS))
def test_estimator_matches_jax(fits, fmt):
    port, ref = fits["port"][f"est_{fmt}"], fits["jax"][f"est_{fmt}"]
    assert port["ranks"] == [0, 1]
    assert len(port["history"]) == len(port["val_history"]) == EPOCHS
    _close(port["history"], ref["history"], EST_RTOL, "history")
    _close(port["val_history"], ref["val_history"], EST_RTOL, "val_history")
    want = convert.mlp_params_from_jax(ref["final"])
    assert set(port["final"]) == set(want)
    for k, v in want.items():
        _close(port["final"][k], v.numpy(), EST_RTOL, f"final {k}")
    _close(port["transform"], ref["transform"], EST_RTOL, "transform")
    np.testing.assert_array_equal(port["reloaded"], port["transform"])
    assert port["epoch_ckpts"] == [True] * EPOCHS


def test_torch_estimator_matches_jax(fits):
    port, ref = fits["port"]["torch_est"], fits["jax"]["torch_est"]
    assert set(port["state"]) == set(ref["state"])
    for k, v in ref["state"].items():
        _close(port["state"][k], v, TORCH_EST_RTOL, k)
        np.testing.assert_array_equal(port["state"][k], v)
    _close(port["history"], ref["history"], TORCH_EST_RTOL, "history")
    _close(port["val_history"], ref["val_history"], TORCH_EST_RTOL,
           "val_history")
    _close(port["transform"], ref["transform"], TORCH_EST_RTOL, "transform")
    steps = EPOCHS * -(-(int(ROWS * (1 - VAL)) // 2) // BATCH)
    for r, w in enumerate(port["workers"]):
        assert w["rank"] == r and len(w["losses"]) == len(w["step_ms"]) \
            == steps
        # The CPU launches no kernel: every count stays 0.
        assert not any(w["launches"].values()), w["launches"]


def test_fit_without_gpu_raises_with_the_remote_traceback(fits):
    msg = fits["port"]["no_gpu"]
    assert msg is not None and "Executor.run failed" in msg
    assert "no CUDA device is available" in msg


def test_torch_estimator_rejects_unknown_loss():
    from horovod_tpu.torch_estimator import TorchEstimator as JTorchEstimator

    for cls in (TorchEstimator, JTorchEstimator):
        with pytest.raises(ValueError, match="loss"):
            cls(model=None, optimizer=None, loss="hinge")
    assert TorchEstimator.LOSSES == JTorchEstimator.LOSSES


def test_estimator_params_surface():
    """The Spark-ML Params accessors: the JAX package's params plus the
    port's ``device`` and ``backend``; chainable setters, the bulk form,
    and the constructor's validation in the setters."""
    from horovod_tpu import estimator as jest

    assert est_mod.Estimator._PARAMS == jest.Estimator._PARAMS + (
        "device", "backend")
    e = est_mod.Estimator(model=None, optimizer=None)
    assert (e.getDevice(), e.getBackend()) == ("cuda", None)
    assert e.setEpochs(7).setBatchSize(64).setNumProc(3) is e
    assert (e.getEpochs(), e.getBatchSize(), e.getNumProc()) == (7, 64, 3)
    e.setParams(seed=5, data_format="parquet", device="cpu", backend="gloo")
    assert e.getSeed() == 5 and e.getDataFormat() == "parquet"
    assert (e.getDevice(), e.getBackend()) == ("cpu", "gloo")
    with pytest.raises(ValueError, match="unknown param"):
        e.setParams(nope=1)
    with pytest.raises(ValueError, match="data_format"):
        e.setDataFormat("csv")
    with pytest.raises(ValueError, match="data_format"):
        est_mod.Estimator(model=None, optimizer=None, data_format="arrow")
    with pytest.raises(ValueError, match="store"):
        est_mod.Estimator(model=None, optimizer=None).fit(
            np.zeros((2, 1)), np.zeros(2))


def test_trained_torch_model_transforms_an_empty_input(tmp_path):
    store = LocalStore(str(tmp_path))
    m = _torch_model()
    store.write_obj(store.path_join(store.get_checkpoint_path("r"),
                                    "torch_final.pkl"),
                    est_mod.state_arrays(m))
    t = TrainedTorchModel.load(store, "r", _torch_model(), device="cpu")
    assert t.transform(np.zeros((0, FEATURES), np.float32)).shape == (0, 1)
    assert t.history == [] and t.device.type == "cpu"


def test_top_level_resolves_the_cluster_modules():
    import horovod_tpu_torch as hvd

    for name in ("executor", "store", "estimator", "spark"):
        assert getattr(hvd, name).__name__ == f"horovod_tpu_torch.{name}"
    from horovod_tpu_torch.spark import torch as spark_torch

    assert spark_torch.TorchEstimator is TorchEstimator
    assert spark_torch.TorchModel is TrainedTorchModel
