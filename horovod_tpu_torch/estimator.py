"""Estimator: fit/transform over the executor pool with the run's
artifacts in a Store — the port's copy of ``horovod_tpu/estimator.py``
(Horovod's Spark estimators: a training job inside the cluster's
workers over partitioned data, checkpoints and logs through the Store,
a transformer back).

The model is an ``nn.Module`` that carries its own starting weights;
rank 0 broadcasts them. ``optimizer`` is a factory ``params ->
torch.optim.Optimizer``. Each worker trains on its rank's strided shard
(the batch order of ``np.random.default_rng(seed).permutation``, the JAX
one) and averages the gradients through ``grouped_allreduce(op=
Average)``; rank 0 checkpoints every epoch. Inputs are cast to the
parameters' dtype, so token ids need a model that takes floats or an
integer-label loss.

The device rule: ``device=`` (default ``"cuda"``) and ``backend=``
(default None: NCCL on the card, gloo on the CPU) go to every worker's
``init()``; several ranks on one card need ``backend="gloo"``. Without
a GPU and without ``device="cpu"`` the workers raise, and ``fit``
re-raises with their tracebacks. ``transform`` runs on the same device.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np

from .store import Store


def split_validation(X, y, validation, seed: int = 0):
    """Validation for every estimator family: a float fraction becomes a
    seeded random (train, val) split; a (Xv, yv) tuple passes through.
    Returns (X, y, validation or None)."""
    X, y = np.asarray(X), np.asarray(y)
    if isinstance(validation, float):
        if not 0.0 < validation < 1.0:
            raise ValueError("validation fraction must be in (0, 1)")
        idx = np.random.default_rng(seed).permutation(len(X))
        n_val = max(int(len(X) * validation), 1)
        validation = (X[idx[:n_val]], y[idx[:n_val]])
        X, y = X[idx[n_val:]], y[idx[n_val:]]
    return X, y, validation


def stage_pickle_data(store: Store, run_id: str, X, y,
                      validation) -> None:
    """Write the train (and optional val) arrays into the run layout."""
    if validation is not None:
        store.write_obj(store.get_data_path(run_id, "val"),
                        (np.asarray(validation[0]),
                         np.asarray(validation[1])))
    store.write_obj(store.get_data_path(run_id, "train"), (X, y))


def validate_data_format(data_format: str) -> str:
    if data_format not in ("pickle", "parquet"):
        raise ValueError(
            f"data_format must be 'pickle' or 'parquet', got "
            f"{data_format!r}")
    return data_format


def stage_data(store: Store, run_id: str, X, y, validation,
               data_format: str, num_shards: int) -> None:
    """One staging dispatch for every estimator family."""
    if data_format == "parquet":
        stage_parquet_data(store, run_id, X, y, validation,
                           num_shards=num_shards)
    else:
        stage_pickle_data(store, run_id, X, y, validation)


def stage_parquet_data(store: Store, run_id: str, X, y, validation,
                       num_shards: int) -> None:
    """Train (one shard a worker) and optional val as parquet."""
    from .parquet import write_parquet_shards

    run_path = store.get_run_path(run_id)
    write_parquet_shards(
        store, store.path_join(run_path, "train_parquet"),
        {"x": X, "y": y}, num_shards=max(num_shards, 1))
    if validation is not None:
        write_parquet_shards(
            store, store.path_join(run_path, "val_parquet"),
            {"x": np.asarray(validation[0]),
             "y": np.asarray(validation[1])}, num_shards=1)


def load_parquet_shard(store: Store, run_id: str, rank: int,
                       nproc: int):
    """This rank's parquet shard (its files only), equalized to
    ``total_rows // nproc`` rows: a long shard is trimmed and a short
    one padded by cycling, so every rank takes the same number of
    steps. A rank with no file raises."""
    from .parquet import ParquetDataset

    ds = ParquetDataset(
        store, store.path_join(store.get_run_path(run_id),
                               "train_parquet"),
        rank=rank, size=nproc)
    shard = ds.load()
    Xs, ys = shard["x"], shard["y"]
    if nproc > 1 and ds.total_rows is not None:
        min_shard = ds.total_rows // nproc
        if min_shard == 0:
            raise ValueError(
                f"{ds.total_rows} training rows cannot feed "
                f"{nproc} workers")
        if len(Xs) == 0:
            raise ValueError(
                f"rank {rank} drew no parquet shard files (dataset "
                f"has fewer files than {nproc} workers) — rewrite "
                f"the shards with num_shards >= the worker count")
        if len(Xs) < min_shard:
            reps = -(-min_shard // len(Xs))
            Xs = np.concatenate([Xs] * reps)[:min_shard]
            ys = np.concatenate([ys] * reps)[:min_shard]
        else:
            Xs, ys = Xs[:min_shard], ys[:min_shard]
    return Xs, ys


def load_parquet_val(store: Store, run_id: str):
    from .parquet import ParquetDataset

    v = ParquetDataset(
        store, store.path_join(store.get_run_path(run_id),
                               "val_parquet")).load()
    return v["x"], v["y"]


def rank_shard(X, y, rank: int, nproc: int):
    """The strided shard of ``rank``, equalized to ``len(X) // nproc``
    rows (every rank runs the same number of steps). Raises when a rank
    would get nothing."""
    if nproc <= 1:
        return X, y
    min_shard = len(X) // nproc
    if min_shard == 0:
        raise ValueError(
            f"{len(X)} training rows cannot feed {nproc} workers — "
            f"reduce num_proc or provide more data")
    return X[rank::nproc][:min_shard], y[rank::nproc][:min_shard]


def _mse(pred, y):
    return ((pred - y) ** 2).mean()


def _softmax_cross_entropy(logits, labels):
    """optax's ``softmax_cross_entropy_with_integer_labels(...).mean()``:
    integer labels index the last axis of the logits."""
    import torch

    picked = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (torch.logsumexp(logits, dim=-1) - picked).mean()


def _resolve_loss(loss):
    if callable(loss):
        return loss
    if loss == "mse":
        return _mse
    if loss == "softmax_cross_entropy":
        return _softmax_cross_entropy
    raise ValueError(f"unknown loss {loss!r} (use a callable, 'mse', or "
                     "'softmax_cross_entropy')")


def init_world(device, backend: Optional[str]):
    """``init(device=, backend=)`` in a worker; a world an earlier call
    on the same pool made is kept when it has this device and backend,
    else it is shut down and made again. Returns the context."""
    import horovod_tpu_torch as hvd
    from .common.device import resolve_device

    want = resolve_device(device)
    if hvd.is_initialized():
        ctx = hvd.init()
        default = "gloo" if want.type == "cpu" else "nccl"
        if ctx.device.type == want.type \
                and want.index in (None, ctx.device.index) \
                and ctx.backend == (backend or default):
            return ctx
        hvd.shutdown()
    return hvd.init(device=device, backend=backend)


def load_rank_data(store: Store, run_id: str, rank: int, nproc: int,
                   has_val: bool, data_format: str):
    """This rank's training shard and, on rank 0 when the fit has one,
    the validation set (the other ranks' validation is never read)."""
    if data_format == "parquet":
        Xs, ys = load_parquet_shard(store, run_id, rank, nproc)
        val = load_parquet_val(store, run_id) \
            if (has_val and rank == 0) else None
        return Xs, ys, val
    X, y = store.read_obj(store.get_data_path(run_id, "train"))
    val = store.read_obj(store.get_data_path(run_id, "val")) \
        if (has_val and rank == 0) else None
    Xs, ys = rank_shard(X, y, rank, nproc)
    return Xs, ys, val


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters (a copy)."""
    from .ops import kernels

    return dict(kernels.LAUNCHES)


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()}


def state_arrays(model) -> Dict[str, np.ndarray]:
    """The model's ``state_dict`` as host numpy arrays (a checkpoint)."""
    return {k: v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}


def _train_worker(store: Store, run_id: str, model, optimizer, loss,
                  epochs: int, batch_size: int, seed: int,
                  shuffle: bool, has_val: bool = False,
                  data_format: str = "pickle", device="cuda",
                  backend: Optional[str] = None) -> Dict[str, Any]:
    """One worker's training loop: its rank's shard, gradients averaged
    over the world through the eager engine's grouped allreduce, rank 0
    checkpointing."""
    import time

    import torch

    import horovod_tpu_torch as hvd

    ctx = init_world(device, backend)
    rank, nproc, dev = ctx.rank, ctx.size, ctx.device
    Xs, ys, val = load_rank_data(store, run_id, rank, nproc, has_val,
                                 data_format)
    model = model.to(dev)
    params = list(model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = optimizer(params)
    loss_fn = _resolve_loss(loss)
    pdtype = params[0].dtype

    def to_tensors(xa, ya):
        xt = torch.from_numpy(np.ascontiguousarray(xa)).to(dev, pdtype)
        yt = torch.from_numpy(np.ascontiguousarray(ya)).to(dev)
        if loss == "mse":
            yt = yt.to(pdtype)
        elif loss == "softmax_cross_entropy":
            yt = yt.long()
        return xt, yt

    Xt, yt = to_tensors(Xs, ys)
    val_t = to_tensors(*val) if val is not None else None
    before = launch_counts()
    nrows = len(Xs)
    steps = max(nrows // batch_size, 1)
    history: List[float] = []
    val_history: List[float] = []
    step_ms: List[float] = []
    shuffle_rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = (shuffle_rng.permutation(nrows) if shuffle
                 else np.arange(nrows))
        epoch_loss = 0.0
        for s in range(steps):
            idx = order[s * batch_size:(s + 1) * batch_size]
            if len(idx) == 0:
                continue
            t0 = time.perf_counter()
            rows = torch.from_numpy(idx).to(dev)
            l = loss_fn(model(Xt[rows]), yt[rows])
            grads = torch.autograd.grad(l, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            reduced = hvd.grouped_allreduce(
                grads, op=hvd.Average, name=f"est.{run_id}.e{epoch}.s{s}")
            for p, g in zip(params, reduced):
                p.grad = g
            opt.step()
            epoch_loss += l.item()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append(epoch_loss / steps)
        if val_t is not None:
            with torch.no_grad():
                val_history.append(float(loss_fn(model(val_t[0]),
                                                  val_t[1])))
        if rank == 0:
            ckpt = store.path_join(store.get_checkpoint_path(run_id),
                                   f"epoch_{epoch}.pkl")
            store.write_obj(ckpt, state_arrays(model))
            store.write_obj(
                store.path_join(store.get_logs_path(run_id),
                                "history.pkl"),
                {"train": history, "val": val_history})
    if rank == 0:
        store.write_obj(
            store.path_join(store.get_checkpoint_path(run_id),
                            "final.pkl"), state_arrays(model))
    return {"rank": rank, "history": history, "val_history": val_history,
            "step_ms": step_ms, "launches": launches_since(before)}


def batched_predict(model, X, batch_size: int, device):
    """``model`` over ``X`` in batches on ``device``, the inputs cast to
    the parameters' dtype; a numpy array (a 0-row forward gives the
    shape of an empty input)."""
    import torch

    model.eval()
    pdtype = next(model.parameters()).dtype
    X = np.asarray(X)
    outs = []
    with torch.no_grad():
        for i in range(0, len(X), batch_size):
            xb = torch.from_numpy(np.ascontiguousarray(
                X[i:i + batch_size])).to(device, pdtype)
            outs.append(model(xb).cpu().numpy())
        if outs:
            return np.concatenate(outs)
        empty = torch.zeros((0,) + tuple(X.shape[1:]), dtype=pdtype,
                            device=device)
        return model(empty).cpu().numpy()


def read_history(store: Store, run_id: str):
    """(train, val) histories of a run's log, empty when it has none."""
    hist_path = store.path_join(store.get_logs_path(run_id), "history.pkl")
    if not store.exists(hist_path):
        return [], []
    logged = store.read_obj(hist_path)
    if isinstance(logged, dict):
        return logged.get("train", []), logged.get("val", [])
    return logged, []


def load_weights(model, weights: Dict[str, np.ndarray], device):
    """``model`` with ``weights`` (a checkpoint's arrays) on ``device``."""
    import torch

    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in weights.items()})
    return model.to(device)


class TrainedModel:
    """The fitted transformer (Horovod's ``HorovodModel``): inference
    over the trained weights on the estimator's device, loadable from
    the Store. ``params`` holds the checkpoint's arrays."""

    def __init__(self, model, params, store: Store, run_id: str,
                 history: Optional[List[float]] = None,
                 val_history: Optional[List[float]] = None,
                 device="cuda"):
        from .common.device import resolve_device

        self.device = resolve_device(device)
        self.model = load_weights(model, params, self.device)
        self.params = params
        self.store = store
        self.run_id = run_id
        self.history = history or []
        self.val_history = val_history or []
        #: Each worker's result dict of the fit that made this model.
        self.worker_results: List[Dict[str, Any]] = []

    @classmethod
    def load(cls, store: Store, run_id: str, model,
             device="cuda") -> "TrainedModel":
        params = store.read_obj(store.path_join(
            store.get_checkpoint_path(run_id), "final.pkl"))
        history, val_history = read_history(store, run_id)
        return cls(model, params, store, run_id, history, val_history,
                   device)

    def transform(self, X, batch_size: int = 1024) -> np.ndarray:
        """Batched inference (the Transformer.transform contract)."""
        return batched_predict(self.model, X, batch_size, self.device)

    predict = transform


class Estimator:
    """Distributed fit/transform over the executor pool.

    Usage::

        store = hvd.store.Store.create("/tmp/run_store")
        est = hvd.estimator.Estimator(
            model=MLP(in_features=4, num_classes=1),
            optimizer=lambda p: torch.optim.SGD(p, lr=0.05), loss="mse",
            store=store, num_proc=2, epochs=5, batch_size=16,
            backend="gloo")
        trained = est.fit(X, y)
        pred = trained.transform(X_test)
    """

    def __init__(self, model, optimizer, loss: Any = "mse",
                 store: Optional[Store] = None, num_proc: int = 2,
                 epochs: int = 1, batch_size: int = 32,
                 run_id: Optional[str] = None, shuffle: bool = True,
                 seed: int = 0,
                 worker_env: Optional[Dict[str, str]] = None,
                 data_format: str = "pickle", device="cuda",
                 backend: Optional[str] = None):
        validate_data_format(data_format)
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.store = store
        self.num_proc = num_proc
        self.epochs = epochs
        self.batch_size = batch_size
        self.run_id = run_id
        self.shuffle = shuffle
        self.seed = seed
        self.worker_env = worker_env
        self.data_format = data_format
        self.device = device
        self.backend = backend

    # -- the Spark-ML Params surface (Horovod's EstimatorParams: chainable
    #    setX/getX accessors and the bulk setParams; the attribute is the
    #    storage). ---------------------------------------------------------

    _PARAMS = ("model", "optimizer", "loss", "store", "num_proc",
               "epochs", "batch_size", "run_id", "shuffle", "seed",
               "worker_env", "data_format", "device", "backend")

    def setParams(self, **kwargs) -> "Estimator":
        for k, v in kwargs.items():
            if k not in self._PARAMS:
                raise ValueError(
                    f"unknown param {k!r}; valid: {self._PARAMS}")
            self._set_one(k, v)
        return self

    def _set_one(self, name: str, value) -> "Estimator":
        if name == "data_format":
            # The constructor's validation: a bad format must not reach
            # the workers.
            validate_data_format(value)
        setattr(self, name, value)
        return self

    def fit(self, X, y, validation=None, executor=None) -> TrainedModel:
        """Train over the executor pool; returns the fitted transformer.

        ``validation``: a ``(Xv, yv)`` tuple or a float fraction of the
        rows to hold out; its per-epoch loss lands in
        ``TrainedModel.val_history``. ``executor`` reuses a running pool
        (its world too, when the device and backend match); otherwise a
        pool of ``num_proc`` workers is started for this fit."""
        import time

        from .executor import Executor

        if self.store is None:
            raise ValueError("Estimator requires a store= "
                             "(hvd.store.Store.create(prefix))")
        run_id = self.run_id or f"run_{int(time.time() * 1000):x}"
        X, y, validation = split_validation(X, y, validation,
                                            seed=self.seed)
        # One shard a worker, so every rank's files[rank::size] is
        # non-empty.
        stage_data(self.store, run_id, X, y, validation,
                   self.data_format, num_shards=self.num_proc)

        args = (self.store, run_id, self.model, self.optimizer, self.loss,
                self.epochs, self.batch_size, self.seed, self.shuffle,
                validation is not None, self.data_format, self.device,
                self.backend)
        if executor is not None:
            results = executor.run(_train_worker, args=args)
        else:
            with Executor(np=self.num_proc,
                          env=self.worker_env) as ex:
                results = ex.run(_train_worker, args=args)
        # A fresh replica: the caller's model keeps its starting weights.
        trained = TrainedModel.load(self.store, run_id,
                                    copy.deepcopy(self.model), self.device)
        trained.history = results[0]["history"]
        trained.val_history = results[0]["val_history"]
        trained.worker_results = results
        return trained


def _install_param_accessors() -> None:
    """setEpochs/getEpochs and the rest for every Estimator param
    (snake_case param -> CamelCase setter and getter)."""
    for p in Estimator._PARAMS:
        camel = "".join(s.capitalize() for s in p.split("_"))

        def setter(self, value, _p=p):
            return self._set_one(_p, value)

        def getter(self, _p=p):
            return getattr(self, _p)

        setattr(Estimator, f"set{camel}", setter)
        setattr(Estimator, f"get{camel}", getter)


_install_param_accessors()
