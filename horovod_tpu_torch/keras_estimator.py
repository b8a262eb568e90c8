"""KerasEstimator — the port's copy of ``horovod_tpu/keras_estimator.py``
(the reference's Spark Keras estimator, spark/keras/estimator.py:106-390:
serialize a keras model, train it inside cluster workers under a Horovod
DistributedOptimizer with the broadcast/metric callbacks, return a
transformer) on the executor pool and a Store.

The keras model crosses the process boundary as (architecture JSON,
weights, serialized optimizer/loss) — keras models do not pickle — and
each worker joins the world (``init(device=, backend=)``, as the port's
``Estimator`` does), rebuilds the model, wraps the optimizer in
``horovod_tpu_torch.tensorflow.DistributedOptimizer``, and fits on its
equalized rank shard with ``BroadcastGlobalVariablesCallback`` +
``MetricAverageCallback``, exactly the remote-trainer recipe of the
reference (spark/keras/remote.py). Keras itself computes on the host;
the gradients' reduction runs on the world's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .estimator import (init_world, load_parquet_shard, load_parquet_val,
                        rank_shard, split_validation, stage_data,
                        validate_data_format)
from .store import Store


def _serialize_model(model) -> Dict[str, Any]:
    import tensorflow as tf

    return {
        "arch_json": model.to_json(),
        "weights": model.get_weights(),
        "optimizer": tf.keras.optimizers.serialize(model.optimizer)
        if model.optimizer is not None else None,
        "loss": model.loss if isinstance(model.loss, str) else None,
    }


def _keras_train_worker(store: Store, run_id: str,
                        blob: Dict[str, Any], loss, optimizer_cfg,
                        epochs: int, batch_size: int,
                        has_val: bool,
                        data_format: str = "pickle", device="cuda",
                        backend: Optional[str] = None) -> Dict[str, Any]:
    """Runs in each executor worker (reference spark/keras/remote.py
    RemoteTrainer): rank-sharded fit under the TF shim's distributed
    optimizer + callbacks; rank 0 persists weights/history. Every rank
    reads the validation set: its loss is averaged over the ranks."""
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvdtf

    ctx = init_world(device, backend)
    rank, nproc = ctx.rank, ctx.size

    if data_format == "parquet":
        Xs, ys = load_parquet_shard(store, run_id, rank, nproc)
        val = load_parquet_val(store, run_id) if has_val else None
    else:
        X, y = store.read_obj(store.get_data_path(run_id, "train"))
        val = store.read_obj(store.get_data_path(run_id, "val")) \
            if has_val else None
        # Equalized shards: uneven per-epoch batch counts would
        # desynchronize the per-step allreduce collectives across
        # ranks (the reference remote trainer equalizes
        # steps_per_epoch too).
        Xs, ys = rank_shard(X, y, rank, nproc)
    if val is not None:
        val = (np.asarray(val[0]), np.asarray(val[1]))

    opt_cfg = optimizer_cfg or blob["optimizer"]
    opt = tf.keras.optimizers.deserialize(opt_cfg) if opt_cfg \
        else tf.keras.optimizers.SGD()
    if loss is None and blob["loss"] is None:
        raise ValueError(
            "loss is not serializable from the compiled model (only "
            "string losses cross the worker boundary); pass "
            "KerasEstimator(loss=...) explicitly")
    model = tf.keras.models.model_from_json(blob["arch_json"])
    model.set_weights(blob["weights"])
    model.compile(optimizer=hvdtf.DistributedOptimizer(opt),
                  loss=loss or blob["loss"])

    hist = model.fit(
        Xs, ys, epochs=epochs, batch_size=batch_size, verbose=0,
        validation_data=val,
        callbacks=[hvdtf.BroadcastGlobalVariablesCallback(0),
                   hvdtf.MetricAverageCallback()])

    history = [float(v) for v in hist.history["loss"]]
    val_history = [float(v)
                   for v in hist.history.get("val_loss", [])]
    if rank == 0:
        store.write_obj(
            store.path_join(store.get_checkpoint_path(run_id),
                            "keras_final.pkl"),
            {"arch_json": blob["arch_json"],
             "weights": model.get_weights()})
        store.write_obj(
            store.path_join(store.get_logs_path(run_id),
                            "history.pkl"),
            {"train": history, "val": val_history})
    return {"rank": rank, "history": history,
            "val_history": val_history}


class TrainedKerasModel:
    """The fitted transformer (reference KerasModel Spark Transformer):
    host-side batched predict over the persisted weights."""

    def __init__(self, model, store: Store, run_id: str,
                 history=None, val_history=None):
        self.model = model
        self.store = store
        self.run_id = run_id
        self.history = history or []
        self.val_history = val_history or []

    @classmethod
    def load(cls, store: Store, run_id: str) -> "TrainedKerasModel":
        import tensorflow as tf

        blob = store.read_obj(store.path_join(
            store.get_checkpoint_path(run_id), "keras_final.pkl"))
        model = tf.keras.models.model_from_json(blob["arch_json"])
        model.set_weights(blob["weights"])
        history: List[float] = []
        val_history: List[float] = []
        hist_path = store.path_join(store.get_logs_path(run_id),
                                    "history.pkl")
        if store.exists(hist_path):
            logged = store.read_obj(hist_path)
            history = logged.get("train", [])
            val_history = logged.get("val", [])
        return cls(model, store, run_id, history, val_history)

    def transform(self, X, batch_size: int = 1024) -> np.ndarray:
        outs = [np.asarray(self.model(X[i:i + batch_size]))
                for i in range(0, len(X), batch_size)]
        if outs:
            return np.concatenate(outs)
        out_shape = tuple(d for d in self.model.output_shape[1:])
        return np.empty((0,) + out_shape, np.float32)


class KerasEstimator:
    """fit/transform for tf.keras models over the executor pool
    (reference spark/keras/estimator.py KerasEstimator). ``device``
    (default ``"cuda"``) and ``backend`` (default None: NCCL on the card)
    go to every worker's ``init()``; ranks that share one card need
    ``backend="gloo"``.

    Usage::

        model = tf.keras.Sequential([...]); model.compile(...)
        est = KerasEstimator(model=model, store=store, num_proc=2,
                             epochs=5, batch_size=32, device="cuda")
        trained = est.fit(X, y)
        pred = trained.transform(X_test)
    """

    def __init__(self, model, store: Optional[Store] = None,
                 loss: Optional[str] = None, optimizer=None,
                 num_proc: int = 2, epochs: int = 1,
                 batch_size: int = 32, run_id: Optional[str] = None,
                 worker_env: Optional[Dict[str, str]] = None,
                 data_format: str = "pickle", device="cuda",
                 backend: Optional[str] = None):
        validate_data_format(data_format)
        self.model = model
        self.store = store
        self.loss = loss
        self.optimizer = optimizer
        self.num_proc = num_proc
        self.epochs = epochs
        self.batch_size = batch_size
        self.run_id = run_id
        self.worker_env = worker_env
        self.data_format = data_format
        self.device = device
        self.backend = backend

    def fit(self, X, y, validation=None,
            executor=None) -> TrainedKerasModel:
        import time

        import tensorflow as tf

        from .executor import Executor

        if self.store is None:
            raise ValueError("KerasEstimator requires a store=")
        run_id = self.run_id or f"krun_{int(time.time() * 1000):x}"
        X, y, validation = split_validation(X, y, validation)
        stage_data(self.store, run_id, X, y, validation,
                   self.data_format, num_shards=self.num_proc)

        blob = _serialize_model(self.model)
        opt_cfg = tf.keras.optimizers.serialize(self.optimizer) \
            if self.optimizer is not None else None
        args = (self.store, run_id, blob, self.loss, opt_cfg,
                self.epochs, self.batch_size, validation is not None,
                self.data_format, self.device, self.backend)
        if executor is not None:
            results = executor.run(_keras_train_worker, args=args)
        else:
            with Executor(np=self.num_proc,
                          env=self.worker_env) as ex:
                results = ex.run(_keras_train_worker, args=args)

        del results  # rank order only; load() reads the persisted
        # history so the Store stays the single source of truth.
        return TrainedKerasModel.load(self.store, run_id)
