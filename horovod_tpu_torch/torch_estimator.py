"""TorchEstimator — the port's copy of ``horovod_tpu/torch_estimator.py``
(Horovod's ``spark/torch/estimator.py``: ship a torch model into the
cluster's workers, train it under ``DistributedOptimizer``, return a
transformer), on the executor pool and a Store.

The model object itself crosses to the workers (cloudpickle where it is
installed, else pickle: then its class must be importable there). Each
worker joins the world (``init(device=, backend=)``), moves the model to
its device, wraps the user's optimizer factory in the port's
``DistributedOptimizer(named_parameters=)``, broadcasts rank 0's
parameters and trains its equalized rank shard in order (no shuffle),
so every rank takes the same number of steps. Inputs are cast to the
parameters' dtype; ``cross_entropy`` targets are int64. Rank 0 writes
the final ``state_dict`` and the loss history to the Store.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .estimator import (batched_predict, init_world, launch_counts,
                        launches_since, load_rank_data, load_weights,
                        read_history, split_validation, stage_data,
                        state_arrays, validate_data_format)
from .store import Store


def _torch_train_worker(store: Store, run_id: str, model,
                        optimizer_factory: Callable, loss_name: str,
                        epochs: int, batch_size: int,
                        has_val: bool,
                        data_format: str = "pickle", device="cuda",
                        backend: Optional[str] = None) -> Dict[str, Any]:
    """One worker of a fit (Horovod's ``spark/torch/remote.py``
    RemoteTrainer). Returns this rank's per-step losses and host
    milliseconds and the kernel launches of its training loop."""
    import time

    import torch

    import horovod_tpu_torch as hvd

    ctx = init_world(device, backend)
    rank, nproc, dev = ctx.rank, ctx.size, ctx.device
    Xs, ys, val = load_rank_data(store, run_id, rank, nproc, has_val,
                                 data_format)
    model = model.to(dev)
    pdtype = next(model.parameters()).dtype

    def to_tensors(xa, ya):
        xt = torch.from_numpy(np.ascontiguousarray(xa)).to(dev, pdtype)
        yt = torch.from_numpy(np.ascontiguousarray(ya)).to(dev)
        yt = yt.long() if loss_name == "cross_entropy" else yt.to(pdtype)
        return xt, yt

    Xt, yt = to_tensors(Xs, ys)
    val_t = to_tensors(*val) if val is not None else None

    loss_fn = {"mse": torch.nn.MSELoss(),
               "cross_entropy": torch.nn.CrossEntropyLoss()}[loss_name]
    opt = hvd.DistributedOptimizer(
        optimizer_factory(model.parameters()),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    # Ceil stepping takes the last partial batch (the same count on
    # every rank: the shards are equalized).
    starts = list(range(0, len(Xt), batch_size)) or [0]
    history: List[float] = []
    val_history: List[float] = []
    losses: List[float] = []
    step_ms: List[float] = []
    before = launch_counts()
    try:
        for _ in range(epochs):
            model.train()
            epoch_loss = 0.0
            for s0 in starts:
                t0 = time.perf_counter()
                opt.zero_grad()
                l = loss_fn(model(Xt[s0:s0 + batch_size]),
                            yt[s0:s0 + batch_size])
                l.backward()
                opt.step()
                # float() waits for the step's work on the device.
                losses.append(l.item())
                step_ms.append((time.perf_counter() - t0) * 1e3)
                epoch_loss += losses[-1]
            history.append(epoch_loss / len(starts))
            if val_t is not None:
                model.eval()
                with torch.no_grad():
                    val_history.append(float(loss_fn(model(val_t[0]),
                                                     val_t[1])))
        launches = launches_since(before)
    finally:
        # The pool outlives this fit: its hooks must not fire again.
        for h in getattr(opt, "_dist_hooks", ()):
            h.remove()
    if rank == 0:
        store.write_obj(
            store.path_join(store.get_checkpoint_path(run_id),
                            "torch_final.pkl"), state_arrays(model))
        store.write_obj(
            store.path_join(store.get_logs_path(run_id), "history.pkl"),
            {"train": history, "val": val_history})
    return {"rank": rank, "history": history, "val_history": val_history,
            "losses": losses, "step_ms": step_ms, "launches": launches}


class TrainedTorchModel:
    """Horovod's ``TorchModel`` transformer: batched inference on the
    estimator's device."""

    def __init__(self, model, store: Store, run_id: str,
                 history=None, val_history=None, device="cuda"):
        from .common.device import resolve_device

        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.store = store
        self.run_id = run_id
        self.history = history or []
        self.val_history = val_history or []
        #: Each worker's result dict of the fit that made this model.
        self.worker_results: List[Dict[str, Any]] = []

    @classmethod
    def load(cls, store: Store, run_id: str, model,
             device="cuda") -> "TrainedTorchModel":
        weights = store.read_obj(store.path_join(
            store.get_checkpoint_path(run_id), "torch_final.pkl"))
        model = load_weights(model, weights, device)
        history, val_history = read_history(store, run_id)
        return cls(model, store, run_id, history, val_history, device)

    def transform(self, X, batch_size: int = 1024) -> np.ndarray:
        return batched_predict(self.model, X, batch_size, self.device)


class TorchEstimator:
    """fit/transform for torch models over the executor pool (Horovod's
    ``spark/torch/estimator.py``).

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer`` (e.g.
    ``functools.partial(torch.optim.SGD, lr=0.05)``), so each worker
    builds it on its own replica. ``device`` (default ``"cuda"``) and
    ``backend`` (default None: NCCL on the card) go to every worker's
    ``init()``; ranks that share one card need ``backend="gloo"``.
    """

    LOSSES = ("mse", "cross_entropy")

    def __init__(self, model, optimizer: Callable,
                 loss: str = "mse", store: Optional[Store] = None,
                 num_proc: int = 2, epochs: int = 1,
                 batch_size: int = 32, run_id: Optional[str] = None,
                 worker_env: Optional[Dict[str, str]] = None,
                 data_format: str = "pickle", device="cuda",
                 backend: Optional[str] = None):
        validate_data_format(data_format)
        self.data_format = data_format
        if loss not in self.LOSSES:
            raise ValueError(f"loss must be one of {self.LOSSES}, "
                             f"got {loss!r}")
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.store = store
        self.num_proc = num_proc
        self.epochs = epochs
        self.batch_size = batch_size
        self.run_id = run_id
        self.worker_env = worker_env
        self.device = device
        self.backend = backend

    def fit(self, X, y, validation=None,
            executor=None) -> TrainedTorchModel:
        import time

        from .executor import Executor

        if self.store is None:
            raise ValueError("TorchEstimator requires a store=")
        run_id = self.run_id or f"trun_{int(time.time() * 1000):x}"
        X, y, validation = split_validation(X, y, validation)
        stage_data(self.store, run_id, X, y, validation,
                   self.data_format, num_shards=self.num_proc)

        args = (self.store, run_id, self.model, self.optimizer,
                self.loss, self.epochs, self.batch_size,
                validation is not None, self.data_format, self.device,
                self.backend)
        if executor is not None:
            results = executor.run(_torch_train_worker, args=args)
        else:
            with Executor(np=self.num_proc,
                          env=self.worker_env) as ex:
                results = ex.run(_torch_train_worker, args=args)
        # A fresh replica: a second fit() must not start from the
        # first one's weights.
        trained = TrainedTorchModel.load(self.store, run_id,
                                         copy.deepcopy(self.model),
                                         self.device)
        trained.worker_results = results
        return trained
