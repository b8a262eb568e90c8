"""The port's MXNet shim (``horovod_tpu_torch.mxnet``) against the JAX
package's (``horovod_tpu.mxnet``): ``test_mxnet_shim.py``'s cases on the
same duck-typed fakes (mxnet is not installed; the shim speaks the
NDArray protocol, ``asnumpy()`` / ``t[:] = v``, which numpy arrays and
the fakes below share).

One gloo world of 2 ranks (``--mx-worker``) and the JAX shim on a
2-device CPU mesh (``--shim-oracle``) run side by side, once a module.
Replicated inputs: the port's results equal the JAX shim's bitwise
(sums, scaled sums, gathers, the optimizer's fake updates) or within
1e-6 of the largest magnitude (averages). Each rank's own inputs: the
results equal the hand reductions, the uneven ``alltoall(splits=)``
sends rank ``d`` its rows, and a small gluon-shaped SGD loop over both
ranks' data ends with the weights of one process averaging the two
gradients, on both ranks.
"""

import sys

import numpy as np
import pytest

from test_torch_port_worlds import rank_env, run_procs

N = 2
TOL = 1e-6


def _data(rank):
    g = np.random.default_rng(4000 if rank is None else 4010 + rank)
    return {"x": g.standard_normal((4, 3)).astype(np.float32),
            "ints": g.integers(-9, 9, (6,)).astype(np.int32),
            "g": [g.standard_normal(3).astype(np.float32) for _ in range(3)],
            "X": g.standard_normal((16, 4)).astype(np.float32)}


class _FakeOptimizer:
    """Duck-typed mx.optimizer.Optimizer: rescale_grad + update."""

    def __init__(self, lr=0.1):
        self.lr = lr
        self.rescale_grad = 1.0
        self.updates = []

    def update(self, index, weight, grad, state):
        idxs = index if isinstance(index, (list, tuple)) else [index]
        ws = weight if isinstance(weight, list) else [weight]
        gs = grad if isinstance(grad, list) else [grad]
        for i, w_, g_ in zip(idxs, ws, gs):
            self.updates.append(i)
            w_ -= self.lr * self.rescale_grad * g_

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self.lr = lr


class _FakeParam:
    def __init__(self, grad, grad_req="write"):
        self.grad_req = grad_req
        self._grad = grad

    def list_grad(self):
        return [self._grad]


class _FakeGluonParam:
    def __init__(self, value):
        self._value = value

    def data(self):
        return self._value


class _FakeNDArray:
    """The NDArray protocol: ``asnumpy()``, ``shape`` and ``t[:] = v``."""

    def __init__(self, a):
        self._a = np.array(a)

    @property
    def shape(self):
        return self._a.shape

    def asnumpy(self):
        return self._a.copy()

    def __setitem__(self, key, value):
        self._a[key] = value


def _run(api, d, out, prefix):
    x = d["x"]
    out[f"{prefix}ar/avg"] = api.allreduce(x, average=True, name="m.avg")
    out[f"{prefix}ar/sum"] = api.allreduce(x, average=False, name="m.sum")
    out[f"{prefix}ar/int"] = api.allreduce(d["ints"], average=False,
                                           name="m.int")
    out[f"{prefix}ar/scaled"] = api.allreduce(
        x, average=False, prescale_factor=0.5, postscale_factor=3.0,
        name="m.scaled")
    t = x.copy()
    ret = api.allreduce_(t, average=False, prescale_factor=0.5,
                         name="m.inplace")
    out[f"{prefix}ar_/same"] = np.array(ret is t)
    out[f"{prefix}ar_"] = t
    nd = _FakeNDArray(x)
    api.allreduce_(nd, average=True, name="m.nd")
    out[f"{prefix}ar_/nd"] = nd.asnumpy()
    out[f"{prefix}bc"] = api.broadcast(x, root_rank=N - 1, name="m.bc")
    u = x.copy()
    api.broadcast_(u, root_rank=0, name="m.bc_")
    out[f"{prefix}bc_"] = u
    out[f"{prefix}ag"] = api.allgather(x, name="m.ag")

    inner = _FakeOptimizer(lr=1.0)
    opt = api.DistributedOptimizer(inner)
    out[f"{prefix}opt/rescale"] = np.array(inner.rescale_grad)
    w = np.full(3, 10.0, np.float32)
    g = d["g"][0].copy()
    opt.update(0, w, g, None)
    out[f"{prefix}opt/w"] = w
    ws = [np.full(3, 1.0, np.float32), np.full(3, 2.0, np.float32)]
    gs = [d["g"][1].copy(), d["g"][2].copy()]
    for i in (0, 1):
        opt.update_multi_precision([i], [ws[i]], [gs[i]], None)
    out[f"{prefix}opt/ws"] = np.stack(ws)
    out[f"{prefix}opt/updates"] = np.array(inner.updates)
    opt.set_learning_rate(0.5)
    out[f"{prefix}opt/lr"] = np.array(opt.lr)

    g0, g1 = d["g"][0].copy(), d["g"][1].copy()
    frozen = np.full(3, 7.0, np.float32)
    api.allreduce_grads_inplace(
        [_FakeParam(g0), _FakeParam(frozen, grad_req="null"),
         _FakeParam(g1)], prefix="t1.", gradient_predivide_factor=2.0)
    out[f"{prefix}grads"] = np.stack([g0, frozen, g1])

    params = {"w0": _FakeGluonParam(x.copy()), "w1": d["g"][2].copy()}
    api.broadcast_parameters(params, root_rank=0, prefix="bp.")
    out[f"{prefix}bp/w0"] = params["w0"].data()
    out[f"{prefix}bp/w1"] = params["w1"]


def _train(api, d, out, prefix):
    """The gluon-shaped loop of ``test_mxnet_shim.py``."""
    X = d["X"]
    y = X @ np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    w = np.zeros(4, np.float32)
    opt = api.DistributedOptimizer(_FakeOptimizer(lr=0.1))
    losses = []
    for step in range(30):
        err = X @ w - y
        losses.append(float((err ** 2).mean()))
        opt.update(step, w, (2.0 * X.T @ err / len(X)).astype(np.float32),
                   None)
    out[f"{prefix}train/w"] = w
    out[f"{prefix}train/losses"] = np.array(losses)


def _mx_worker(rank: int, n: int, out_path: str) -> None:
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.mxnet as api

    hvd.init(device="cpu")
    assert api.rank() == rank and api.size() == n
    out = {}
    for prefix, d in (("rep/", _data(None)), ("own/", _data(rank))):
        _run(api, d, out, prefix)
        _train(api, d, out, prefix)
    # Uneven alltoall: rank r sends r + 1 rows to each rank.
    rows = np.full((2 * (rank + 1), 1), float(rank), np.float32)
    out["a2av"] = api.alltoall(rows, splits=[rank + 1] * n, name="a2av")
    out["a2a"] = api.alltoall(np.arange(4, dtype=np.float32) + 10 * rank,
                              name="a2a")
    out["obj"] = np.array(api.allgather_object(rank))
    if not api._HAS_MXNET:
        with pytest.raises(ImportError):
            api.DistributedTrainer({}, object())
    with pytest.raises(ValueError):
        api.broadcast_parameters([1, 2, 3])
    hvd.shutdown()
    np.savez(out_path, **out)


def _shim_oracle(n: int, out_path: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import horovod_tpu as jhvd
    import horovod_tpu.mxnet as api

    jhvd.init()
    assert jhvd.size() == n
    out = {}
    _run(api, _data(None), out, "rep/")
    _train(api, _data(None), out, "rep/")
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mxnet")
    env = rank_env(N)
    cmds = {f"port.{r}": (
        [sys.executable, __file__, "--mx-worker", str(r), str(N),
         str(tmp / f"port.{r}.npz")], dict(env, HVD_TPU_PROC_ID=str(r)))
        for r in range(N)}
    cmds["shim"] = (
        [sys.executable, __file__, "--shim-oracle", str(N),
         str(tmp / "shim.npz")],
        rank_env(JAX_PLATFORMS="cpu", HVD_TPU_FORCE_CPU_DEVICES=str(N),
                 XLA_FLAGS=f"--xla_force_host_platform_device_count={N}"))
    run_procs(cmds, timeout=240)
    return {key: dict(np.load(tmp / f"{key}.npz")) for key in cmds}


def _close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} x {scale}"


EXACT = ("ar/sum", "ar/int", "ar/scaled", "ar_/same", "ar_", "bc", "bc_",
         "ag", "opt/rescale", "opt/w", "opt/ws", "opt/updates", "opt/lr",
         "grads", "bp/w0", "bp/w1")
CLOSE = ("ar/avg", "ar_/nd", "train/w", "train/losses")


@pytest.mark.parametrize("key", EXACT + CLOSE)
def test_replicated_inputs_match_the_jax_shim(runs, key):
    want = runs["shim"][f"rep/{key}"]
    for r in range(N):
        got = runs[f"port.{r}"][f"rep/{key}"]
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if key in EXACT:
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, TOL, f"{key} rank {r}")


def test_own_inputs_reduce_as_by_hand(runs):
    data = [_data(r) for r in range(N)]
    x = [d["x"] for d in data]
    half = np.float32(0.5)
    for r in range(N):
        o = runs[f"port.{r}"]
        np.testing.assert_array_equal(o["own/ar/sum"], x[0] + x[1])
        np.testing.assert_array_equal(o["own/ar/int"],
                                      data[0]["ints"] + data[1]["ints"])
        np.testing.assert_array_equal(
            o["own/ar/scaled"], (x[0] * half + x[1] * half)
            * np.float32(3.0))
        np.testing.assert_array_equal(o["own/ar_"], x[0] * half
                                      + x[1] * half)
        _close(o["own/ar/avg"], (x[0] + x[1]) / 2, 1e-7, "avg")
        np.testing.assert_array_equal(o["own/bc"], x[1])
        np.testing.assert_array_equal(o["own/bc_"], x[0])
        np.testing.assert_array_equal(o["own/ag"], np.concatenate(x))
        np.testing.assert_array_equal(o["own/bp/w0"], x[0])
        np.testing.assert_array_equal(o["own/bp/w1"], data[0]["g"][2])
        g = [[d["g"][k] for d in data] for k in (0, 1)]
        np.testing.assert_array_equal(
            o["own/grads"], np.stack([g[0][0] * half + g[0][1] * half,
                                      np.full(3, 7.0, np.float32),
                                      g[1][0] * half + g[1][1] * half]))
        # SUM then rescale_grad 1/2: the average step, on both ranks.
        _close(o["own/opt/w"], 10.0 - (g[0][0] + g[0][1]) / 2, 1e-6, "w")


def test_own_train_loop_averages_the_ranks(runs):
    """Both ranks end with one process's weights that average the two
    ranks' gradients each step."""
    data = [_data(r) for r in range(N)]
    true_w = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    w = np.zeros(4, np.float64)
    for _ in range(30):
        grads = []
        for d in data:
            X = d["X"].astype(np.float64)
            grads.append(2.0 * X.T @ (X @ w - X @ true_w) / len(X))
        w = w - 0.1 * (grads[0] + grads[1]) / 2
    for r in range(N):
        _close(runs[f"port.{r}"]["own/train/w"], w, 1e-5, f"rank {r}")
        np.testing.assert_array_equal(runs[f"port.{r}"]["own/train/w"],
                                      runs["port.0"]["own/train/w"])


def test_alltoall_sends_each_rank_its_rows(runs):
    for r in range(N):
        o = runs[f"port.{r}"]
        np.testing.assert_array_equal(
            o["a2av"].reshape(-1), np.repeat(np.arange(N, dtype=np.float32),
                                             np.arange(1, N + 1)))
        np.testing.assert_array_equal(
            o["a2a"], np.concatenate([np.arange(4, dtype=np.float32)[
                2 * r:2 * r + 2] + 10 * s for s in range(N)]))
        assert list(o["obj"]) == [0, 1]


if __name__ == "__main__" and sys.argv[1:2] == ["--mx-worker"]:
    _mx_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
if __name__ == "__main__" and sys.argv[1:2] == ["--shim-oracle"]:
    _shim_oracle(int(sys.argv[2]), sys.argv[3])
