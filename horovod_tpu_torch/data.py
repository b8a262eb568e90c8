"""Data layer of the port: rank sharding, elastic sampling and the device
infeed — its copy of ``horovod_tpu/data.py`` for PyTorch.

:class:`DeviceInfeed` keeps up to ``depth`` batches already on the device
ahead of the consumer, so batch N+1's host-to-device copy overlaps the
step on batch N. On a CUDA device its worker thread pins each host batch
and copies it with ``non_blocking=True`` on its own ``torch.cuda.Stream``,
recording an event per batch; the consumer's ``__next__`` makes the
current stream wait on that event and calls ``record_stream`` on every
tensor, so that the caching allocator cannot hand the batch's memory back
to the copy stream while the step still reads it. On the CPU it is a
plain bounded queue.

Batches are trees (tensors or numpy arrays in dicts, lists and tuples).
Consumer starvation is measured at the consumer's edge:
``hvd_tpu_infeed_wait_seconds`` (how long ``next`` blocked),
``hvd_tpu_infeed_queue_depth``, ``hvd_tpu_infeed_batches_total`` and
``hvd_tpu_infeed_bytes_total`` (host bytes handed to placement). While a
profiler records, a :class:`DeviceInfeed`'s whole ``__next__`` (the wait
and the hand-over) is the span ``hvd.infeed.next``.
"""

from __future__ import annotations

import atexit
import contextlib
import queue as queue_mod
import threading
import time
import weakref
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .common import basics
from .common import config as config_lib
from .common import metrics as metrics_lib
from .common import tree as tree_lib
from .common.device import resolve_device

_M_WAIT = metrics_lib.histogram(
    "hvd_tpu_infeed_wait_seconds",
    "time the consumer blocked waiting for the next device batch "
    "(DeviceInfeed/BackgroundPrefetcher)")
_M_DEPTH = metrics_lib.gauge(
    "hvd_tpu_infeed_queue_depth",
    "ready device batches queued ahead of the consumer")
_M_BATCHES = metrics_lib.counter(
    "hvd_tpu_infeed_batches_total",
    "batches delivered through the device-infeed pipelines")
_M_BYTES = metrics_lib.counter(
    "hvd_tpu_infeed_bytes_total",
    "host bytes handed to device placement by the infeed pipelines")


class ElasticSampler:
    """Partitions dataset indices across ranks and, after an elastic
    reset, repartitions only the unprocessed remainder of the epoch
    (Horovod's ``torch/elastic/sampler.py``). Call :meth:`record_batch`
    after each step, :meth:`set_epoch` at the epoch's end and
    :meth:`reset` after a change of the world."""

    def __init__(self, dataset_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.dataset_size = int(dataset_size)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: set = set()
        self.rank = 0
        self.num_replicas = 1
        self.remaining_indices: List[int] = []
        self.num_samples = 0
        self.total_size = 0
        self.reset()

    def reset(self) -> None:
        """Re-read the world and repartition the unprocessed indices."""
        if basics.is_initialized():
            self.rank, self.num_replicas = basics.rank(), basics.size()
        else:
            self.rank, self.num_replicas = 0, 1
        self._repartition()

    def set_epoch(self, epoch: int) -> None:
        """A new epoch: clear the processed set and reshuffle from (seed,
        epoch), the same order on every rank."""
        self.epoch = epoch
        self.processed_indices = set()
        self._repartition()

    def get_indices(self, batch_idx: int, batch_size: int) -> List[int]:
        start = batch_idx * batch_size
        return self.local_indices()[start:start + batch_size]

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        self.record_indices(self.get_indices(batch_idx, batch_size))

    def record_indices(self, indices: Sequence[int]) -> None:
        self.processed_indices.update(int(i) for i in indices)

    def _repartition(self) -> None:
        indices = [i for i in range(self.dataset_size)
                   if i not in self.processed_indices]
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = list(rng.permutation(indices))
        self.remaining_indices = [int(i) for i in indices]
        # Padded to a multiple of the world so every rank sees as many
        # samples.
        n = len(self.remaining_indices)
        self.num_samples = -(-n // self.num_replicas) if n else 0
        self.total_size = self.num_samples * self.num_replicas
        if n and self.total_size > n:
            self.remaining_indices += self.remaining_indices[
                :self.total_size - n]

    def local_indices(self) -> List[int]:
        """This rank's shard (strided)."""
        return self.remaining_indices[self.rank:self.total_size:
                                      self.num_replicas]

    def __iter__(self) -> Iterator[int]:
        return iter(self.local_indices())

    def __len__(self) -> int:
        return self.num_samples

    def __getstate__(self):
        d = dict(self.__dict__)
        d["processed_indices"] = sorted(self.processed_indices)
        return d

    def __setstate__(self, d):
        d = dict(d)
        d["processed_indices"] = set(d["processed_indices"])
        self.__dict__.update(d)


def shard_batch(batch, rank: Optional[int] = None,
                size: Optional[int] = None):
    """This rank's rows of a global batch tree (each leaf's dim 0 split
    in ``size`` equal parts)."""
    r = basics.rank() if rank is None else rank
    n = basics.size() if size is None else size

    def one(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch dim {b} not divisible by size {n}")
        per = b // n
        return x[r * per:(r + 1) * per]

    return tree_lib.map_tree(one, batch)


def _compose_shard_transform(transform: Optional[Callable]) -> Callable:
    """This rank's :func:`shard_batch` slice after ``transform``: only 1/n
    of the global batch reaches placement."""
    r = basics.rank() if basics.is_initialized() else 0
    n = basics.size() if basics.is_initialized() else 1
    base = transform
    return (lambda b: shard_batch(base(b) if base is not None else b,
                                  rank=r, size=n))


def _host_nbytes(batch) -> int:
    total = 0
    for leaf in tree_lib.leaves(batch):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += getattr(leaf, "nbytes", 0)
    return total


def _as_tensor(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _place_batch(batch, device: torch.device, stream=None):
    """Every leaf of ``batch`` on ``device`` (numpy arrays as tensors).
    With a CUDA ``stream``: pinned host copies sent with
    ``non_blocking=True`` on that stream; returns ``(batch, event)``."""
    def one(x):
        x = _as_tensor(x)
        if not isinstance(x, torch.Tensor):
            return x
        if device.type != "cuda":
            return x.to(device)
        if x.device.type == "cpu" and not x.is_pinned():
            x = x.pin_memory()
        return x.to(device, non_blocking=True)

    if stream is None:
        return tree_lib.map_tree(one, batch), None
    with torch.cuda.stream(stream):
        out = tree_lib.map_tree(one, batch)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _hand_over(batch, event):
    """On the consumer's thread: the current stream waits for the copy,
    and every tensor is marked in use by it (``record_stream``)."""
    if event is None:
        return batch
    current = torch.cuda.current_stream()
    current.wait_event(event)
    for t in tree_lib.tensors(batch):
        if t.is_cuda:
            t.record_stream(current)
    return batch


def _infeed_device(device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    return basics.device() if basics.is_initialized() else resolve_device()


# Live infeeds, closed at interpreter exit: a worker mid-copy at teardown
# leaves an unjoined thread behind.
_LIVE_INFEEDS: "weakref.WeakSet" = weakref.WeakSet()
_ATEXIT_REGISTERED = False


def _close_live_infeeds() -> None:
    for infeed in list(_LIVE_INFEEDS):
        infeed.close()


class DeviceInfeed:
    """Double-buffered device infeed: a background thread keeps up to
    ``depth`` batches already on ``device`` ahead of the consumer::

        with hvd.DeviceInfeed(host_batches, depth=2) as infeed:
            for batch in infeed:
                loss = step(*batch)

    ``device`` defaults to the ``init()`` device (else the GPU).
    ``shard=True`` slices THIS rank's rows (:func:`shard_batch`) on the
    worker before placement; ``transform`` is a host-side hook run on
    the worker. Delivery order is the source order; iteration ends after
    the source is exhausted; a worker-side exception is raised to the
    consumer AFTER the batches before it. ``close()`` (also by ``with``,
    by exhaustion, and at interpreter exit) stops the worker, drains the
    queue and joins the thread."""

    _DONE = object()

    def __init__(self, iterator: Iterable, depth: int = 2, device=None,
                 transform: Optional[Callable] = None,
                 shard: bool = False):
        global _ATEXIT_REGISTERED
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if shard:
            transform = _compose_shard_transform(transform)
        self.device = _infeed_device(device)
        self._transform = transform
        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._closed = False
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(
            target=self._run, args=(iter(iterator),), daemon=True,
            name="hvd-device-infeed")
        if not _ATEXIT_REGISTERED:
            atexit.register(_close_live_infeeds)
            _ATEXIT_REGISTERED = True
        _LIVE_INFEEDS.add(self)
        self._thread.start()

    def _put(self, item) -> bool:
        """A bounded put that stays responsive to close(): False when the
        consumer is gone."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _run(self, it):
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        try:
            # The current device is per thread: the copy stream's device.
            with ctx:
                for batch in it:
                    if self._stop.is_set():
                        return
                    if self._transform is not None:
                        batch = self._transform(batch)
                    _M_BYTES.inc(_host_nbytes(batch))
                    item = _place_batch(batch, self.device, self._stream)
                    if not self._put(item):
                        return
                    _M_DEPTH.set(self._q.qsize())
        except Exception as e:  # raised on the consumer's next()
            self._error = e
        finally:
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        with metrics_lib.span("hvd.infeed.next"):
            t0 = time.perf_counter()
            item = self._q.get()
            _M_WAIT.observe(time.perf_counter() - t0)
            _M_DEPTH.set(self._q.qsize())
            if item is self._DONE:
                self.close()
                if self._error is not None:
                    raise self._error
                raise StopIteration
            _M_BATCHES.inc()
            return _hand_over(*item)

    def close(self) -> None:
        """Stop the worker, drain queued batches, join the thread.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        while True:  # drain so that a blocked put() returns
            try:
                self._q.get_nowait()
            except queue_mod.Empty:
                break
        self._thread.join(timeout=5.0)
        _M_DEPTH.set(0)
        _LIVE_INFEEDS.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


class BackgroundPrefetcher(DeviceInfeed):
    """:class:`DeviceInfeed` under its historical name and ``size=``
    spelling."""

    def __init__(self, iterator: Iterable, size: int = 2, device=None):
        super().__init__(iterator, depth=size, device=device)


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Up to ``size`` batches of ``iterator`` already on the device ahead
    of consumption (a :class:`DeviceInfeed`); dropping the generator
    mid-iteration closes the infeed."""
    with DeviceInfeed(iterator, depth=size, device=device) as infeed:
        yield from infeed


def infeed_pipeline(iterator: Iterable, mode: Optional[str] = None,
                    device=None, transform: Optional[Callable] = None,
                    shard: bool = False) -> Iterator:
    """The infeed modes side by side (``HVD_TPU_PREFETCH``):

    - ``"off"``: each batch placed on demand on the consumer's thread,
      waiting until it is on the device (the A/B baseline);
    - ``"single"``: one batch staged ahead on the consumer's thread;
    - ``"double"``: :class:`DeviceInfeed` with ``depth=2``.

    ``mode=None`` takes ``init(prefetch=)`` / ``HVD_TPU_PREFETCH``, else
    ``double``."""
    if mode is None:
        if basics.is_initialized():
            mode = basics.context().config.prefetch
        if mode is None:
            mode = config_lib.runtime_env("PREFETCH")
        mode = mode or "double"
    if mode not in ("off", "single", "double"):
        raise ValueError(
            f"unknown infeed mode {mode!r}: off | single | double")
    if mode == "double":
        with DeviceInfeed(iterator, depth=2, device=device,
                          transform=transform, shard=shard) as infeed:
            yield from infeed
        return
    dev = _infeed_device(device)
    if shard:
        transform = _compose_shard_transform(transform)

    def place(batch):
        if transform is not None:
            batch = transform(batch)
        _M_BYTES.inc(_host_nbytes(batch))
        return _place_batch(batch, dev)[0]

    it = iter(iterator)
    if mode == "off":
        for batch in it:
            t0 = time.perf_counter()
            out = place(batch)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            _M_WAIT.observe(time.perf_counter() - t0)
            _M_BATCHES.inc()
            yield out
        return
    # "single": one batch staged ahead on this thread.
    try:
        staged = place(next(it))
    except StopIteration:
        return
    while staged is not None:
        out = staged
        t0 = time.perf_counter()
        try:
            staged = place(next(it))
        except StopIteration:
            staged = None
        _M_WAIT.observe(time.perf_counter() - t0)
        _M_BATCHES.inc()
        yield out
