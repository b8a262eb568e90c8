"""The port's data layer (``horovod_tpu_torch/data.py``) against the JAX
package's (``horovod_tpu/data.py``), after the reference tests of
``tests/test_data.py``.

* ``ElasticSampler``: the same shards as the JAX sampler for every rank
  of a world, shuffled or not, after a mid-epoch reset (processed indices
  left out) and a new epoch; equal after a pickle round trip.
* ``shard_batch``: the same rows as JAX's.
* ``DeviceInfeed`` and the helpers on the CPU (``device="cpu"``; the copy
  stream path is held on the card by ``tests/test_torch_port_cuda.py``):
  delivery in source order under a slow consumer, a worker error raised
  after the batches before it, ``close()`` joining the thread (also from
  ``with`` and from a dropped generator), ``shard=True`` slicing this
  rank's rows, the three ``infeed_pipeline`` modes delivering the same
  batches and moving the infeed metrics, and ``init(prefetch=)``
  honoured. Numpy batches arrive as tensors.
"""

import pickle
import threading
import time
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import data as data_lib
from horovod_tpu_torch.common import basics


@pytest.fixture(scope="module")
def J():
    from horovod_tpu import data as jdata

    return types.SimpleNamespace(data=jdata)


@pytest.fixture()
def world1():
    ctx = hvd.init(device="cpu")
    try:
        yield ctx
    finally:
        hvd.shutdown()


def _pair(J, n, world, **kw):
    """The port's and the JAX package's sampler at rank 0 of ``world``."""
    out = []
    for mod in (data_lib, J.data):
        s = mod.ElasticSampler(n, **kw)
        s.rank, s.num_replicas = 0, world
        s._repartition()
        out.append(s)
    return out


@pytest.mark.parametrize("n,world", [(64, 8), (10, 8), (37, 3), (5, 1)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_elastic_sampler_matches_jax(J, n, world, shuffle):
    """Every rank's shard, the padding, a mid-epoch reset with processed
    indices and the next epoch's shuffle, as the JAX sampler gives
    them."""
    port, ref = _pair(J, n, world, shuffle=shuffle, seed=5)
    assert (port.num_samples, port.total_size) == (ref.num_samples,
                                                   ref.total_size)

    def shards():
        out = []
        for s in (port, ref):
            rows = []
            for r in range(world):
                s.rank = r
                rows.append(s.local_indices())
            s.rank = 0
            out.append(rows)
        return out

    a, b = shards()
    assert a == b
    assert sorted(set(i for row in a for i in row)) == list(range(n))
    for s in (port, ref):
        s.record_batch(batch_idx=0, batch_size=2)
        s._repartition()
    a, b = shards()
    assert a == b and port.processed_indices == ref.processed_indices
    assert set(port.remaining_indices).isdisjoint(port.processed_indices)
    for s in (port, ref):
        s.set_epoch(1)
    a, b = shards()
    assert a == b and port.processed_indices == set()


def test_elastic_sampler_pickles_and_reads_the_world(world1):
    s = data_lib.ElasticSampler(8)
    assert (s.rank, s.num_replicas) == (0, 1) and len(s) == 8
    s.record_indices([1, 2])
    s2 = pickle.loads(pickle.dumps(s))
    assert s2.processed_indices == {1, 2}
    assert s2.local_indices() == s.local_indices() == list(s)


def test_shard_batch(J):
    x = np.arange(16).reshape(16, 1)
    for rank in (0, 2, 7):
        got = data_lib.shard_batch({"x": torch.from_numpy(x)}, rank=rank,
                                   size=8)
        want = J.data.shard_batch({"x": x}, rank=rank, size=8)
        np.testing.assert_array_equal(got["x"].numpy(),
                                      np.asarray(want["x"]))
    with pytest.raises(ValueError, match="not divisible"):
        data_lib.shard_batch(torch.ones(10, 2), rank=0, size=8)


def test_prefetch_to_device_order_and_device():
    batches = [{"x": np.full((2,), i, np.float32)} for i in range(5)]
    out = list(data_lib.prefetch_to_device(iter(batches), size=2,
                                           device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor)
        assert b["x"].device.type == "cpu"
        np.testing.assert_allclose(b["x"].numpy(), i)


def test_background_prefetcher(world1):
    batches = [np.full((2,), i, np.float32) for i in range(6)]
    out = list(data_lib.BackgroundPrefetcher(batches, size=3))
    assert [int(b[0]) for b in out] == list(range(6))


def test_background_prefetcher_propagates_error():
    def gen():
        yield np.ones(2)
        raise RuntimeError("decode failed")

    it = data_lib.BackgroundPrefetcher(gen(), size=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_device_infeed_order_under_slow_consumer():
    batches = [torch.full((2,), float(i)) for i in range(8)]
    got = []
    with data_lib.DeviceInfeed(iter(batches), depth=2,
                               device="cpu") as infeed:
        for b in infeed:
            time.sleep(0.01)
            got.append(int(b[0]))
    assert got == list(range(8))


def test_device_infeed_raising_iterator():
    def gen():
        yield np.ones(2)
        yield np.ones(2) * 2
        raise RuntimeError("decode failed")

    infeed = data_lib.DeviceInfeed(gen(), depth=2, device="cpu")
    assert int(next(infeed)[0]) == 1
    assert int(next(infeed)[0]) == 2
    with pytest.raises(RuntimeError, match="decode failed"):
        next(infeed)
    infeed._thread.join(timeout=5)
    assert not infeed._thread.is_alive()


def test_device_infeed_close_joins_thread():
    def endless():
        i = 0
        while True:
            yield np.full((2,), i, np.float32)
            i += 1

    infeed = data_lib.DeviceInfeed(endless(), depth=2, device="cpu")
    next(infeed)
    next(infeed)
    infeed.close()
    assert not infeed._thread.is_alive()
    infeed.close()
    with pytest.raises(StopIteration):
        next(infeed)


def test_device_infeed_context_manager_abandon():
    def endless():
        while True:
            yield np.ones(2)

    with data_lib.DeviceInfeed(endless(), depth=2, device="cpu") as infeed:
        next(infeed)
    assert not infeed._thread.is_alive()


def test_prefetch_generator_close_stops_thread():
    def endless():
        while True:
            yield np.ones(2)

    def alive():
        return [t for t in threading.enumerate()
                if t.name == "hvd-device-infeed" and t.is_alive()]

    before = alive()
    gen = data_lib.prefetch_to_device(endless(), size=2, device="cpu")
    next(gen)
    gen.close()
    deadline = time.time() + 5
    while time.time() < deadline and len(alive()) > len(before):
        time.sleep(0.05)
    assert len(alive()) <= len(before)


def test_device_infeed_shard_fuses_rank_slice(world1, monkeypatch):
    """``shard=True`` slices this rank's rows on the worker, before
    placement (rank 1 of a world of 4 here)."""
    monkeypatch.setattr(basics, "rank", lambda: 1)
    monkeypatch.setattr(basics, "size", lambda: 4)
    global_batch = {"x": np.arange(32, dtype=np.float32).reshape(16, 2)}
    with data_lib.DeviceInfeed(iter([global_batch]), depth=1,
                               shard=True) as infeed:
        out = next(infeed)
    assert tuple(out["x"].shape) == (4, 2)
    np.testing.assert_array_equal(out["x"].numpy(), global_batch["x"][4:8])


def _metric(name):
    fam = hvd.metrics().get(name, {})
    s = fam.get("samples", [])
    return s[0]["value"] if s else 0


@pytest.mark.parametrize("mode", ["off", "single", "double"])
def test_infeed_pipeline_modes_and_metrics(world1, mode):
    """Each mode delivers the same batches in order; the batch and byte
    counters and the wait histogram move."""
    batches = [(np.full((2,), i, np.float32),) for i in range(4)]
    before = (_metric("hvd_tpu_infeed_batches_total"),
              _metric("hvd_tpu_infeed_bytes_total"))
    out = [int(b[0][0]) for b in data_lib.infeed_pipeline(iter(batches),
                                                           mode)]
    assert out == list(range(4))
    assert _metric("hvd_tpu_infeed_batches_total") == before[0] + 4
    assert _metric("hvd_tpu_infeed_bytes_total") == before[1] + 4 * 8
    assert _metric("hvd_tpu_infeed_wait_seconds")["count"] > 0
    with pytest.raises(ValueError, match="unknown infeed mode"):
        list(data_lib.infeed_pipeline(iter(batches), "bogus"))


def test_infeed_pipeline_honors_config_prefetch():
    """``mode=None`` takes ``init(prefetch=)``: a bad value raises as an
    explicit bad mode does."""
    batches = [(np.full((2,), i, np.float32),) for i in range(3)]
    for prefetch, ok in (("off", True), ("bogus", False)):
        hvd.init(device="cpu", prefetch=prefetch)
        try:
            if ok:
                assert [int(b[0][0]) for b in
                        data_lib.infeed_pipeline(iter(batches))] == [0, 1, 2]
            else:
                with pytest.raises(ValueError, match="unknown infeed mode"):
                    list(data_lib.infeed_pipeline(iter(batches)))
        finally:
            hvd.shutdown()


def test_device_infeed_defaults_to_the_gpu():
    """Without ``init()`` and without ``device=`` the infeed takes the
    GPU, and raises where there is none (the port's device rule)."""
    if torch.cuda.is_available():
        with data_lib.DeviceInfeed(iter([]), depth=1) as infeed:
            assert infeed.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            data_lib.DeviceInfeed(iter([]), depth=1)
    with pytest.raises(ValueError, match="depth"):
        data_lib.DeviceInfeed(iter([]), depth=0, device="cpu")
