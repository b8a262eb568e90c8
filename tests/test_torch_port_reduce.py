"""The port's multi-rank gradient reduction against the JAX package's:
the stochastic quantizer K3, the Adasum kernels K8/K9, the quantized
allreduce and reduce-scatter, ``adasum_allreduce``, the int8_ef wire
planner and ``DistributedOptimizer`` with ``compression="int8_ef"`` and
``op=Adasum``.

* Kernels (one process). On the CPU the port's wrappers take their plain
  versions; they are held against ``horovod_tpu.ops.pallas_kernels`` run
  as its jnp fallback and as the Pallas bodies in interpret mode. K3 gets
  the JAX package's own thresholds ``u = jax.random.uniform(key, (rows,
  128))``: codes and scales bitwise. K8 within 1e-6 of the fp64 sums and
  5e-6 of JAX's (whose interpret-mode sums of bf16 inputs are themselves
  up to 2.2e-6 off), the norms relative to themselves and the dot
  relative to ``|a| |b|`` (a dot of near-orthogonal vectors cancels, so
  its own relative error is not a property of the kernel); K9 within
  1e-6 of JAX's combine, relative to its largest value (one bf16 ulp for
  bf16 outputs).
* Collectives (gloo ranks, each a process running this file as a script
  with ``--reduce-worker``, as ``test_torch_port_train.py`` does). At 2
  and 4 ranks: ``quantized_allreduce(key=None, return_residual=True)``
  and ``quantized_reducescatter`` against the JAX functions under
  ``shard_map`` on a 2- and 4-device mesh, ``y`` and the residual to
  1e-6 of the block absmax (127 times the block scale); the stochastic
  path within the documented bound of the exact sum;
  ``adasum_allreduce`` on the none/bf16/int8 wires against JAX (and, on
  the exact wire, against ``adasum_allreduce_reference`` in fp64) to
  1e-5 of the largest value (on a lossy wire at 4 ranks up to 0.1% of
  the elements may sit one wire step away, where the second level
  rounds a value a few ulps from JAX's the other way); every rank's
  result bitwise equal to rank 0's.
* The optimizer at 2 ranks: ``int8_ef`` with every bucket below
  ``quantize_min_bucket_bytes`` (the bf16 wire) equal to the JAX
  ``DistributedOptimizer(compression="int8_ef")`` on a 2-device mesh to
  1e-6; the toy MLP classifier trained 20 SGD steps with int8 buckets
  within 2% of the port's own fp32 run (the JAX package's gate,
  ``test_compression_e2e.py``); ``op=Adasum`` equal to a numpy oracle
  (each rank's local SGD delta, then ``adasum_allreduce_reference``) to
  1e-5, with bitwise-equal replicas; an int8_ef run restored from its
  ``state_dict`` (the error-feedback residual and step included)
  continuing bitwise as the uninterrupted run.

JAX is imported only inside the ``J`` fixture: the worker processes
import this file and must not pay for it.
"""

import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics, fusion
from horovod_tpu_torch.ops import adasum, collectives as C, kernels

REPO = Path(__file__).resolve().parents[1]
KERNEL_TOL = 1e-6       # K8 vs fp64, K9 vs JAX (see the module docstring)
JAX_SUM_TOL = 5e-6      # K8 vs JAX: its interpret-mode bf16 sums are
                        # themselves up to 2.2e-6 off the exact value
QAR_TOL = 1e-6          # quantized allreduce vs JAX, of the block absmax
ADASUM_TOL = 1e-5       # adasum vs JAX / the fp64 reference, of max |ref|
OPT_TOL = 1e-6          # int8_ef on the bf16 wire vs the JAX optimizer
ORACLE_TOL = 1e-5       # Adasum optimizer vs the numpy oracle
WIRES = ("none", "bf16", "int8")
SIZE = 9001             # a ragged element count: three 4096 blocks, padded
OPT_STEPS = 3
OPT_THRESHOLD = 64      # bytes: three fusion buckets for the small MLP
GATE_STEPS = 20
RESUME_STEPS = (3, 3)   # int8_ef steps before the checkpoint, and after


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd_jax
    from horovod_tpu.common import fusion as jfusion
    from horovod_tpu.ops import adasum as jadasum
    from horovod_tpu.ops import collectives as jC
    from horovod_tpu.ops import pallas_kernels as pk

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax,
                                 hvd=hvd_jax, fusion=jfusion,
                                 adasum=jadasum, C=jC, pk=pk)


# -- K3 ---------------------------------------------------------------------

def _to_dtype(J, x, dtype):
    """The same values for both packages: numpy f32 rounded to the dtype
    by JAX, handed to torch bit for bit."""
    xj = J.jnp.asarray(x, getattr(J.jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(J.jnp.float32))).to(
        getattr(torch, dtype))
    return xj, xt


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4096), (9001,), (33, 4, 16), (1,)])
def test_stochastic_quantize_matches_jax(J, rng, shape, dtype, use_pallas):
    """Fed the JAX function's own thresholds, K3's plain version gives its
    codes and scales bit for bit, from the fallback and from the Pallas
    body in interpret mode."""
    xj, xt = _to_dtype(J, rng.standard_normal(shape).astype(np.float32) * 7,
                       dtype)
    key = J.jax.random.PRNGKey(11)
    q, s, n = J.pk.quantize_int8_stochastic(xj, key, use_pallas=use_pallas)
    rows = kernels.stochastic_rows(xt.numel())
    u = np.array(J.jax.random.uniform(key, (rows, 128), J.jnp.float32))
    tq, ts, tn = kernels.quantize_int8_stochastic(xt, torch.from_numpy(u))
    assert tn == n and tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


@pytest.mark.parametrize("n", [100, 4096, 9001])
def test_stochastic_quantize_rounds_to_neighbor(rng, n):
    """Every element rounds to an adjacent int8 level: |deq - x| < scale
    (test_pallas_kernels.py's property)."""
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 10)
    u = torch.from_numpy(rng.random((kernels.stochastic_rows(n), 128))
                         .astype(np.float32))
    q, s, cnt = kernels.quantize_int8_stochastic(x, u)
    out = kernels.dequantize_int8(q, s, cnt, x.shape)
    assert (out - x).abs().max().item() <= s.max().item() + 1e-6
    assert not q.reshape(-1)[n:].any()          # the padding codes are 0


def test_stochastic_quantize_unbiased(rng):
    """E[dequant(quant(x))] = x: the mean of 64 draws beats one draw's
    error by ~sqrt(64) (test_pallas_kernels.py's bound)."""
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 3)
    draws = 64
    acc = np.zeros(4096, np.float64)
    for _ in range(draws):
        u = torch.from_numpy(rng.random((32, 128)).astype(np.float32))
        q, s, n = kernels.quantize_int8_stochastic(x, u)
        acc += kernels.dequantize_int8(q, s, n, x.shape).double().numpy()
    mean_err = acc / draws - x.double().numpy()
    scale = float(s.max())
    assert np.abs(mean_err).max() < 5 * 0.5 * scale / np.sqrt(draws)
    assert abs(mean_err.mean()) < scale / np.sqrt(draws)


# -- K8 / K9 ------------------------------------------------------------------

def _pair(rng, n, case):
    a = rng.standard_normal(n).astype(np.float32)
    b = (0.6 * a + rng.standard_normal(n)).astype(np.float32)
    if case == "zero_b":
        b[:] = 0
    elif case == "zero_both":
        a[:] = 0
        b[:] = 0
    return a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,case", [(5000, "dense"), (4096, "dense"),
                                    (140_000, "dense"), (9001, "zero_b"),
                                    (4097, "zero_both"), (1, "dense")])
def test_adasum_kernels_match_jax(J, rng, n, case, dtype):
    """K8 and K9 against ``adasum_dot_norms``/``adasum_combine`` with
    ``use_pallas=True`` — 140,000 elements take three Pallas blocks — and
    a zero side (coefficient 1) and two zero sides."""
    a, b = _pair(rng, n, case)
    aj, at = _to_dtype(J, a, dtype)
    bj, bt = _to_dtype(J, b, dtype)
    want = np.asarray(J.pk.adasum_dot_norms(aj, bj, use_pallas=True))
    got = kernels.adasum_dot_norms(at, bt).numpy()
    assert got.dtype == np.float32 and got.shape == (3,)
    a64, b64 = at.double().numpy(), bt.double().numpy()
    exact = np.array([a64 @ b64, a64 @ a64, b64 @ b64])
    # Each sum's scale: |a| |b| for the dot, the norms themselves.
    scale = np.array([np.sqrt(exact[1] * exact[2]), exact[1], exact[2]])
    assert (np.abs(got - exact) <= KERNEL_TOL * scale).all()
    assert (np.abs(got - want) <= JAX_SUM_TOL * scale).all()
    # The combine from one set of scalars (JAX's), so the comparison is of
    # the combine alone.
    cj = np.asarray(J.pk.adasum_combine(aj, bj, J.jnp.asarray(want),
                                        use_pallas=True).astype(
                                            J.jnp.float32))
    ct = kernels.adasum_combine(at, bt, torch.from_numpy(want))
    assert ct.dtype == at.dtype and ct.shape == at.shape
    ct = ct.to(torch.float32).numpy()
    # bf16 output: one bf16 ulp, where the two fp32 values round apart.
    tol = KERNEL_TOL if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(ct, cj, rtol=tol,
                               atol=tol * max(np.abs(cj).max(), 1e-30))
    if case != "dense":                 # both coefficients are exactly 1
        plain_sum = (at.float() + bt.float()).to(at.dtype).float().numpy()
        np.testing.assert_array_equal(ct, plain_sum)


def test_adasum_kernels_are_symmetric(rng):
    """Swapping a and b swaps the norms and keeps the dot and the combine
    bit for bit — what keeps the two partners of a pair equal."""
    a, b = _pair(rng, 70_001, "dense")
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    d_ab = kernels.adasum_dot_norms(at, bt)
    d_ba = kernels.adasum_dot_norms(bt, at)
    assert torch.equal(d_ab[[0, 2, 1]], d_ba)
    assert torch.equal(kernels.adasum_combine(at, bt, d_ab),
                       kernels.adasum_combine(bt, at, d_ba))


def test_kernel_wrappers_reject_bad_inputs():
    a = torch.ones(10)
    with pytest.raises(TypeError):
        kernels.adasum_dot_norms(a, a.to(torch.bfloat16))
    with pytest.raises(ValueError):
        kernels.adasum_dot_norms(a, torch.ones(11))
    with pytest.raises(TypeError):
        kernels.adasum_combine(a.half(), a.half(), torch.zeros(3))
    with pytest.raises(ValueError):
        kernels.quantize_int8_stochastic(a, torch.zeros((1, 128)))


# -- the wire planner ---------------------------------------------------------

def test_assign_wire_dtypes_matches_jax(J):
    """Large float buckets int8, small fp32 bf16, small bf16 and integer
    buckets none — the JAX planner's decisions on one mixed plan."""
    shapes = [((64, 64), "float32"), ((300,), "int32"), ((10,), "float32"),
              ((128, 256), "bfloat16"), ((8,), "bfloat16"),
              ((4096, 8), "float32"), ((3,), "float32"),
              ((50_000,), "int32")]
    leaves = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in shapes]
    jleaves = [J.jnp.zeros(s, d) for s, d in shapes]
    for threshold in (1024, 64 * 1024):
        for qmin in (0, 4096, 64 * 1024):
            got = fusion.assign_wire_dtypes(
                fusion.plan_fusion(leaves, threshold, order="reverse"), qmin)
            want = J.fusion.assign_wire_dtypes(
                J.fusion.plan_fusion(jleaves, threshold, order="reverse"),
                qmin)
            assert got.wire_dtypes == want.wire_dtypes
            assert len(set(got.wire_dtypes)) > 1 or qmin == 0


# -- one process: the contract of the new options --------------------------

@pytest.fixture()
def world1():
    ctx = hvd.init(device="cpu")
    try:
        yield ctx
    finally:
        hvd.shutdown()


def test_world_of_one_reductions_are_identities(world1):
    """At n == 1 no level of Adasum runs and nothing is quantized: the
    results are the inputs (new tensors) and the residual is zero."""
    x = torch.linspace(-3, 3, 5000)
    y = hvd.allreduce(x, op=hvd.Adasum)
    assert torch.equal(y, x) and y is not x
    y, res = hvd.quantized_allreduce(x, key=(1, 2), return_residual=True)
    assert torch.equal(y, x) and not res.any()
    own, res = C.quantized_reducescatter(torch.ones(4096), key=(3,),
                                         return_residual=True)
    assert torch.equal(own, torch.ones(4096)) and not res.any()


def test_optimizer_options_contract(world1):
    """int8 is no reduce-safe wire; Adasum takes one backward pass per
    step and the none/bf16/int8_ef wires; int8_ef stamps its plan and
    advances its key once per step."""
    m = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Tanh(),
                            torch.nn.Linear(4, 3))

    def opt(**kw):
        return hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1),
            named_parameters=m.named_parameters(), **kw)

    with pytest.raises(ValueError, match="int8_ef"):
        opt(compression="int8")
    with pytest.raises(ValueError, match="int8_ef"):
        opt(compression=hvd.Compression.int8)
    with pytest.raises(NotImplementedError, match="Adasum"):
        opt(op=hvd.Adasum, backward_passes_per_step=2)
    with pytest.raises(ValueError, match="Adasum"):
        opt(op=hvd.Adasum, compression="fp16")
    for comp, wire in (("none", "none"), ("int8_ef", "none"),
                       ("bf16", "bf16")):
        assert opt(op=hvd.Adasum, compression=comp)._adasum_wire == wire
    o = opt(compression="int8_ef", fusion_threshold_bytes=OPT_THRESHOLD,
            quantize_min_bucket_bytes=40)
    assert o._dist_plan.wire_dtypes == ("int8", "bf16", "int8")
    for _ in range(2):
        o.zero_grad()
        m(torch.ones(2, 5)).sum().backward()
        o.step()
    assert o._ef_step == 2 and hvd.observe_ef_residual(o) == 0.0
    assert hvd.observe_ef_residual(opt()) is None


def test_backend_rule(world1, monkeypatch):
    """``backend="gloo"`` may keep the GPU; ``nccl`` (or the default) with
    more local ranks than GPUs raises before NCCL, naming gloo."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert basics._resolve_backend(cuda, None, 1) == "nccl"
    assert basics._resolve_backend(cuda, "gloo", 2) == "gloo"
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match='backend="gloo"'):
            basics._resolve_backend(cuda, backend, 2)
    with pytest.raises(ValueError, match="nccl"):
        basics._resolve_backend(torch.device("cpu"), "nccl", 1)
    with pytest.raises(ValueError, match="backend"):
        basics._resolve_backend(torch.device("cpu"), "mpi", 1)
    assert world1.backend == "gloo"
    with pytest.raises(ValueError, match="already initialized"):
        hvd.init(backend="gloo")


# -- gloo ranks --------------------------------------------------------------

def _reduce_data(n):
    rng = np.random.default_rng(100 + n)
    common = rng.standard_normal(5000).astype(np.float32)
    return {
        "x": (rng.standard_normal((n, SIZE)) * 3).astype(np.float32),
        "flat": rng.standard_normal((n, 2 * n * 4096)).astype(np.float32),
        "ada": (0.7 * common + rng.standard_normal((n, 5000))).astype(
            np.float32),
    }


def _mlp(params=None):
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Tanh(),
                            torch.nn.Linear(4, 3))
    if params is not None:
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
    return m


def _mlp_loss(m, x, y):
    return ((m(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()


def _opt_data():
    rng = np.random.default_rng(9)
    params = {k: v.detach().numpy().copy() for k, v in
              _mlp().state_dict().items()}
    return {"params": params,
            "x": rng.standard_normal((OPT_STEPS, 2, 4, 5)).astype(
                np.float32),
            "y": rng.standard_normal((OPT_STEPS, 2, 4, 3)).astype(
                np.float32)}


def _gate_data():
    """The JAX package's toy classifier data (test_compression_e2e.py):
    16 samples of 64 features per rank, labels from a random linear map."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    w = rng.standard_normal((64, 10)).astype(np.float32)
    y = (x.reshape(-1, 64) @ w).argmax(-1).reshape(2, 16)
    return x, y


def _gate_run(rank, compression):
    """20 SGD steps of a 64-64-32-10 MLP on this rank's data; returns the
    final loss averaged over the ranks."""
    x, y = _gate_data()
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.ReLU(),
                            torch.nn.Linear(64, 32), torch.nn.ReLU(),
                            torch.nn.Linear(32, 10))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1),
        named_parameters=m.named_parameters(), compression=compression,
        quantize_min_bucket_bytes=0)
    xb, yb = torch.from_numpy(x[rank]), torch.from_numpy(y[rank])
    for _ in range(GATE_STEPS):
        loss = torch.nn.functional.cross_entropy(m(xb), yb)
        opt.zero_grad()
        loss.backward()
        opt.step()
    if compression == "int8_ef":
        assert all(w == "int8" for w in opt._dist_plan.wire_dtypes)
        assert opt._ef_step == GATE_STEPS
    return float(hvd.allreduce(loss.detach(), op=hvd.Average))


def _resume_runs(rank):
    """The toy classifier under SGD with momentum and every bucket int8
    with error feedback: k + m steps uninterrupted; k steps, a checkpoint
    through ``torch.save``, then a fresh model and wrapper restored from
    it for m more; and the same with the checkpoint's error-feedback
    state dropped. Returns each run's parameters and the checkpoint's
    error-feedback step and residual norm."""
    import io

    x, y = _gate_data()
    xb, yb = torch.from_numpy(x[rank]), torch.from_numpy(y[rank])
    k, m_steps = RESUME_STEPS

    def fresh():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.ReLU(),
                                torch.nn.Linear(64, 10))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
            named_parameters=m.named_parameters(), compression="int8_ef",
            quantize_min_bucket_bytes=0)
        return m, opt

    def train(m, opt, steps):
        for _ in range(steps):
            loss = torch.nn.functional.cross_entropy(m(xb), yb)
            opt.zero_grad()
            loss.backward()
            opt.step()

    def params(m, label):
        return {f"resume/{label}/{n}": v.detach().numpy().copy()
                for n, v in m.state_dict().items()}

    out = {}
    m, opt = fresh()
    train(m, opt, k + m_steps)
    out.update(params(m, "whole"))
    m, opt = fresh()
    train(m, opt, k)
    buf = io.BytesIO()
    torch.save({"model": m.state_dict(), "opt": opt.state_dict()}, buf)
    ef = opt.state_dict()["ef_state"]
    out["resume/ef_step"] = np.array(ef["step"])
    out["resume/ef_norm"] = np.array(float(sum(
        r.double().pow(2).sum() for r in ef["residual"].values())) ** 0.5)
    for label, keep_ef in (("restored", True), ("no_ef", False)):
        buf.seek(0)
        ckpt = torch.load(buf)
        if not keep_ef:
            del ckpt["opt"]["ef_state"]
        m, opt = fresh()
        m.load_state_dict(ckpt["model"])
        opt.load_state_dict(ckpt["opt"])
        train(m, opt, m_steps)
        out.update(params(m, label))
    return out


def _reduce_worker(rank: int, n: int, out_path: str) -> None:
    """One rank of an n-process gloo world (run as a script)."""
    hvd.init(device="cpu")
    assert hvd.rank() == rank and hvd.size() == n
    d = _reduce_data(n)
    out = {}
    x = torch.from_numpy(d["x"][rank])
    for op in ("sum", "average"):
        y, res = hvd.quantized_allreduce(
            x, op=hvd.Sum if op == "sum" else hvd.Average,
            return_residual=True)
        out[f"qar/{op}/y"], out[f"qar/{op}/res"] = y.numpy(), res.numpy()
    out["qar/key/y"] = hvd.quantized_allreduce(x, op=hvd.Sum,
                                               key=(0x5EED, 7, 1)).numpy()
    own, res = C.quantized_reducescatter(torch.from_numpy(d["flat"][rank]),
                                         hvd.Sum, return_residual=True)
    out["qrs/own"], out["qrs/res"] = own.numpy(), res.numpy()
    for wire in WIRES:
        out[f"adasum/{wire}"] = hvd.adasum_allreduce(
            torch.from_numpy(d["ada"][rank]), wire=wire).numpy()
    out["adasum/int8_key"] = hvd.adasum_allreduce(
        torch.from_numpy(d["ada"][rank]), wire="int8", key=(5,)).numpy()
    out["adasum/op"] = hvd.allreduce(torch.from_numpy(d["ada"][rank]),
                                     op=hvd.Adasum).numpy()
    out["adasum/f64_scalars"] = hvd.adasum_allreduce(
        torch.from_numpy(d["ada"][rank]), scalar_dtype=torch.float64).numpy()
    if n == 2:
        od = _opt_data()
        for case in ("ef_bf16", "adasum"):
            m = _mlp(od["params"])
            kw = ({"compression": "int8_ef",
                   "fusion_threshold_bytes": OPT_THRESHOLD,
                   "quantize_min_bucket_bytes": 1 << 30}
                  if case == "ef_bf16" else {"op": hvd.Adasum})
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(m.parameters(), lr=0.1),
                named_parameters=m.named_parameters(), **kw)
            for step in range(OPT_STEPS):
                opt.zero_grad()
                _mlp_loss(m, od["x"][step, rank], od["y"][step, rank]
                          ).backward()
                opt.step()
                for k, v in m.state_dict().items():
                    out[f"{case}/{step}/{k}"] = v.numpy().copy()
        for comp in ("none", "int8_ef"):
            out[f"gate/{comp}"] = np.float64(_gate_run(rank, comp))
        out.update(_resume_runs(rank))
    hvd.shutdown()
    np.savez(out_path, **out)


def _run_world(n, out):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, HVD_TPU_COORDINATOR=f"127.0.0.1:{port}",
               HVD_TPU_NUM_PROC=str(n), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--reduce-worker", str(r), str(n),
         str(out / f"rank{r}.npz")],
        env=dict(env, HVD_TPU_PROC_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {n} failed:\n{logs[r]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]


_WORLDS = {}


def _world(n, tmp_path_factory):
    """Run the n ranks once per session; returns (n, their results)."""
    if n not in _WORLDS:
        _WORLDS[n] = _run_world(n, tmp_path_factory.mktemp(f"reduce{n}"))
    return n, _WORLDS[n]


@pytest.fixture(params=[2, 4], ids=["n2", "n4"])
def world(request, tmp_path_factory):
    return _world(request.param, tmp_path_factory)


@pytest.fixture()
def world2(tmp_path_factory):
    """The 2-rank world, which also runs the optimizer cases."""
    return _world(2, tmp_path_factory)[1]


def _jax_per_rank(J, n, fn, *stacked):
    """``fn`` on each rank's row of ``stacked`` under shard_map on an
    n-device mesh; returns its outputs stacked by rank."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(J.jax.devices()[:n]), ("hvd",))

    def body(*blocks):
        outs = fn(*[b[0] for b in blocks])
        outs = outs if isinstance(outs, tuple) else (outs,)
        return tuple(o[None] for o in outs)

    f = J.jax.jit(J.jax.shard_map(body, mesh=mesh,
                                  in_specs=tuple(P("hvd") for _ in stacked),
                                  out_specs=P("hvd"), check_vma=False))
    return [np.asarray(o) for o in f(*[J.jnp.asarray(s) for s in stacked])]


def _block_scale(xs):
    """The scale the quantized results are compared at: the block absmax
    the scales come from (127 s), bounded by the summed contributions'.
    Under jit the JAX package's scale can land an ulp from the IEEE
    quotient the port computes, which moves a dequantized value by an
    ulp of itself."""
    return sum(np.abs(x).max() for x in xs)


@pytest.mark.parametrize("op", ["sum", "average"])
def test_quantized_allreduce_matches_jax(J, world, op):
    n, ranks = world
    x = _reduce_data(n)["x"]
    jop = J.C.ReduceOp.SUM if op == "sum" else J.C.ReduceOp.AVERAGE
    y, res = _jax_per_rank(J, n, lambda v: J.C.quantized_allreduce(
        v, jop, "hvd", return_residual=True), x)
    tol = QAR_TOL * _block_scale(x)
    for r in range(n):
        got_y, got_res = ranks[r][f"qar/{op}/y"], ranks[r][f"qar/{op}/res"]
        np.testing.assert_array_equal(got_y, ranks[0][f"qar/{op}/y"])
        np.testing.assert_allclose(got_y, y[r], rtol=0, atol=tol)
        np.testing.assert_allclose(got_res, res[r], rtol=0, atol=tol)


def test_quantized_reducescatter_matches_jax(J, world):
    n, ranks = world
    flat = _reduce_data(n)["flat"]
    own, res = _jax_per_rank(J, n, lambda v: J.C.quantized_reducescatter(
        v, J.C.ReduceOp.SUM, "hvd", return_residual=True), flat)
    tol = QAR_TOL * _block_scale(flat)
    for r in range(n):
        np.testing.assert_allclose(ranks[r]["qrs/own"], own[r], rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(ranks[r]["qrs/res"], res[r], rtol=0,
                                   atol=tol)


def test_stochastic_quantized_allreduce_within_bound(world):
    """With a key both roundings are stochastic (K3's plain version): the
    result lies within ``sum of s_rank + s_reduced`` of the exact sum in
    every 4096-element block, and every rank holds the same result."""
    n, ranks = world
    x = _reduce_data(n)["x"].astype(np.float64)
    exact = x.sum(0)
    pad = (-SIZE) % 4096

    def block_max(v):
        return np.abs(np.pad(v, (0, pad))).reshape(-1, 4096).max(1)

    s_ranks = sum(block_max(v) for v in x) / 127
    s_red = (block_max(exact) + s_ranks) / 127
    bound = np.repeat(s_ranks + s_red, 4096)[:SIZE] + 1e-6
    for r in range(n):
        got = ranks[r]["qar/key/y"]
        np.testing.assert_array_equal(got, ranks[0]["qar/key/y"])
        assert (np.abs(got - exact) <= bound).all()


@pytest.mark.parametrize("wire", WIRES)
def test_adasum_allreduce_matches_jax_and_reference(J, world, wire):
    n, ranks = world
    ada = _reduce_data(n)["ada"]
    want = _jax_per_rank(J, n, lambda v: J.adasum.adasum_allreduce(
        v, "hvd", wire=wire), ada)[0]
    ref = adasum.adasum_allreduce_reference(list(ada))
    tol = ADASUM_TOL * np.abs(ref).max()
    # On a lossy wire the second level rounds the combined values again:
    # one a few ulps from JAX's can round to the neighbouring bf16 value
    # or int8 code, so up to 0.1% of the elements may differ by one wire
    # step (relative to the largest value: 2^-7 bf16, 2/127 int8).
    step = {"none": 0.0, "bf16": 2 ** -7, "int8": 2 / 127}[wire]
    for r in range(n):
        got = ranks[r][f"adasum/{wire}"]
        np.testing.assert_array_equal(got, ranks[0][f"adasum/{wire}"])
        off = np.abs(got - want[r])
        assert (off > tol).mean() <= (0.001 if step else 0.0), wire
        assert off.max() <= max(tol, step * np.abs(ref).max()), wire
        if wire == "none":
            np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
            np.testing.assert_array_equal(ranks[r]["adasum/op"], got)
            # fp64 scalars: the plain path, not the kernels.
            np.testing.assert_allclose(ranks[r]["adasum/f64_scalars"], ref,
                                       rtol=0, atol=tol)
        if wire == "int8":
            # The stochastic wire: replicas equal, within a few scale
            # steps of the exact recursion.
            keyed = ranks[r]["adasum/int8_key"]
            np.testing.assert_array_equal(keyed,
                                          ranks[0]["adasum/int8_key"])
            assert np.abs(keyed - ref).max() <= 0.05 * np.abs(ref).max()


def _jax_mlp_loss(J, p, x, y):
    h = J.jnp.tanh(x @ p["0.weight"].T + p["0.bias"])
    return ((h @ p["2.weight"].T + p["2.bias"] - y) ** 2).mean()


def test_int8_ef_on_the_bf16_wire_matches_jax(J, world2):
    """Every bucket below ``quantize_min_bucket_bytes`` rides bf16: three
    SGD steps equal the JAX int8_ef optimizer on a 2-device mesh."""
    ranks = world2
    from jax.sharding import Mesh, PartitionSpec as P

    od = _opt_data()
    tx = J.hvd.DistributedOptimizer(J.optax.sgd(0.1), axis_name="hvd",
                                    compression="int8_ef",
                                    fusion_threshold_bytes=OPT_THRESHOLD,
                                    quantize_min_bucket_bytes=1 << 30)
    mesh = Mesh(np.array(J.jax.devices()[:2]), ("hvd",))

    def body(p, st, xb, yb):
        p = J.C.to_local(p, "hvd")
        g = J.jax.grad(lambda q: _jax_mlp_loss(J, q, xb[0], yb[0]))(p)
        upd, st = tx.update(g, st, p)
        return J.optax.apply_updates(p, upd), st

    step = J.jax.jit(J.jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P("hvd"), P("hvd")),
        out_specs=(P(), P()), check_vma=False))
    params = {k: J.jnp.asarray(v) for k, v in od["params"].items()}
    state = tx.init(params)
    for s in range(OPT_STEPS):
        params, state = step(params, state, od["x"][s], od["y"][s])
        for name, ref in params.items():
            for r in range(2):
                np.testing.assert_allclose(
                    ranks[r][f"ef_bf16/{s}/{name}"], np.asarray(ref),
                    rtol=OPT_TOL, atol=OPT_TOL,
                    err_msg=f"step {s} rank {r} {name}")


def test_int8_ef_trains_within_2pct_of_fp32(world2):
    """The toy classifier, 20 SGD steps, every bucket int8 with error
    feedback: final loss within 2% of the same run in fp32."""
    ranks = world2
    fp32, ef = float(ranks[0]["gate/none"]), float(ranks[0]["gate/int8_ef"])
    assert np.isfinite(fp32) and np.isfinite(ef)
    assert abs(ef - fp32) / fp32 < 0.02, (fp32, ef)


def test_int8_ef_checkpoint_resumes_bitwise(world2):
    """An int8_ef run saved after k steps (``state_dict`` through
    ``torch.save``) and restored into a fresh model and wrapper continues
    bitwise as the uninterrupted k + m step run on every rank; the
    checkpoint holds the error-feedback step k and a nonzero residual,
    without which the continuation differs."""
    k, _ = RESUME_STEPS
    for r, rank in enumerate(world2):
        assert int(rank["resume/ef_step"]) == k, r
        assert float(rank["resume/ef_norm"]) > 0, r
        names = [key[len("resume/whole/"):] for key in rank
                 if key.startswith("resume/whole/")]
        assert names
        for name in names:
            np.testing.assert_array_equal(
                rank[f"resume/restored/{name}"], rank[f"resume/whole/{name}"],
                err_msg=f"rank {r} {name}")
        assert any(not np.array_equal(rank[f"resume/no_ef/{name}"],
                                      rank[f"resume/whole/{name}"])
                   for name in names), r


def test_adasum_optimizer_matches_numpy_oracle(world2):
    """Each rank's local SGD step, the fp64 Adasum of the two deltas per
    tensor, applied to the weights: the port's ``op=Adasum`` optimizer
    within 1e-5, both replicas bitwise equal."""
    ranks = world2
    od = _opt_data()
    params = {k: v.copy() for k, v in od["params"].items()}
    for s in range(OPT_STEPS):
        deltas = {}
        for r in range(2):
            m = _mlp(params)
            sgd = torch.optim.SGD(m.parameters(), lr=0.1)
            _mlp_loss(m, od["x"][s, r], od["y"][s, r]).backward()
            sgd.step()
            for k, v in m.state_dict().items():
                deltas.setdefault(k, []).append(v.numpy() - params[k])
        for k in params:
            reduced = adasum.adasum_allreduce_reference(deltas[k])
            params[k] = (params[k] + reduced).astype(np.float32)
            np.testing.assert_array_equal(ranks[1][f"adasum/{s}/{k}"],
                                          ranks[0][f"adasum/{s}/{k}"])
            np.testing.assert_allclose(ranks[0][f"adasum/{s}/{k}"],
                                       params[k], rtol=ORACLE_TOL,
                                       atol=ORACLE_TOL,
                                       err_msg=f"step {s} {k}")


if __name__ == "__main__" and sys.argv[1:2] == ["--reduce-worker"]:
    _reduce_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
