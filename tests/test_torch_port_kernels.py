"""The port's scale kernel (K1 ``scale_buffer``) and int8 KV-wire codec
(K2 ``quantize_int8``, K4 ``dequantize_int8``) against the JAX package's.

K1: the plain version bitwise equal to ``pallas_kernels.scale_buffer``
as its jnp fallback and as the Pallas body in interpret mode, fp32/bf16
in and out; ``collectives._apply_scale`` bitwise equal to the JAX
``_apply_scale`` for fp32, bf16 and fp16 at scales no power of two; and
a 2-rank gloo ``allreduce(op=Average, prescale_factor=1/3,
postscale_factor=0.7)`` in bf16 (each rank a process running this file
with ``--scale-worker``) bitwise equal to the JAX ``allreduce`` under
``shard_map`` on a 2-device mesh, compiled so that it rounds where its
code says (XLA's CPU compiler otherwise keeps the prescaled bf16
operand in fp32 across its fp32-promoted all-reduce).

On the CPU the port's wrappers take their plain PyTorch versions; those
are held here against ``horovod_tpu.ops.pallas_kernels`` run both as its
jnp fallback and as the Pallas kernel body in interpret mode. Bounds
(the reference's own, ``tests/test_pallas_kernels.py``): codes bitwise,
scales rtol 1e-6, dequantized output exact in f32 and after the same
cast in bf16. The CUDA kernels themselves are held against the plain
versions on the card by ``test_torch_port_cuda.py`` and
``chip_smoke.py``.

The JAX package's two paths disagree with each other on some blocks:
its Pallas body in interpret mode divides by 127 and by the scale
through reciprocals, so a block's scale can land 1 ulp from the IEEE
quotient its jnp fallback (and the port, and the CUDA kernel) computes,
and a code in that block can then round the other way. Against the
interpret path the codes are therefore bitwise wherever the two scales
are bitwise equal, and within 1 elsewhere.

Every kernel launch goes through ``kernels._launch``, which calls the C
entry point under a ``torch.cuda.device`` guard on the tensor's device
(the C side launches on the current device): checked here with the
guard and the stream query replaced by recorders, and by reading which
functions of the module reach the libraries.
"""

import ast
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch.ops import collectives, kernels

REPO = Path(__file__).resolve().parents[1]

SCALE_RTOL = 1e-6

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16}
SCALES = (1 / 3, 0.1, 0.7, 2.5)


def _inputs(rng, shape, dtype):
    """The same values for both packages: numpy f32, rounded to the
    dtype by JAX, handed to torch bit for bit."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 3,
                    _JAX[dtype])
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        _TORCH[dtype])
    return x, xt


def _bits(x):
    """The bit patterns of a float array (jax or torch) as int32."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32).numpy()
    return np.asarray(np.asarray(x, np.float32)).view(np.int32)


# -- K1: scale_buffer --------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [7, 1024, 5000])
def test_scale_buffer_matches_jax(rng, n, dtype, out_dtype, use_pallas):
    """The plain K1 (the CPU path of the wrapper) gives the JAX function's
    bits, from its fallback and from the Pallas body."""
    x, xt = _inputs(rng, (n,), dtype)
    for scale in (2.5, 1 / 3):
        want = pk.scale_buffer(x, scale, out_dtype=_JAX[out_dtype],
                               use_pallas=use_pallas)
        got = kernels.scale_buffer(xt, scale, _TORCH[out_dtype])
        assert got.dtype == _TORCH[out_dtype] and got.shape == xt.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(
            _bits(got), _bits(kernels.scale_buffer_plain(
                xt, scale, _TORCH[out_dtype])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n", [1, 4095, 9001])
def test_apply_scale_matches_jax(rng, n, dtype):
    """``_apply_scale`` rounds the scale to the tensor's dtype, as the JAX
    function does; a product in fp32 with the unrounded scale (the port's
    arithmetic before) differs in bf16 and fp16."""
    from horovod_tpu.ops import collectives as jC

    x, xt = _inputs(rng, (n,), dtype)
    for scale in SCALES:
        got = collectives._apply_scale(xt, scale)
        assert got.dtype == xt.dtype
        np.testing.assert_array_equal(_bits(got),
                                      _bits(jC._apply_scale(x, scale)))
    assert collectives._apply_scale(xt, 1.0) is xt
    ints = torch.tensor([1, 3, 5])
    assert collectives._apply_scale(ints, 0.5).tolist() == [0, 1, 2]


def test_scale_buffer_rejects_bad_inputs():
    x = torch.ones(10)
    with pytest.raises(TypeError):
        kernels.scale_buffer(x.double(), 2.0)
    with pytest.raises(TypeError):
        kernels.scale_buffer(x, 2.0, torch.int32)


def _scale_data():
    rng = np.random.default_rng(31)
    return (rng.standard_normal((2, 9001)) * 3).astype(np.float32)


def _scale_worker(rank: int, out_path: str) -> None:
    """One rank of a 2-process gloo world (run as a script)."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    x = torch.from_numpy(_scale_data()[rank]).to(torch.bfloat16)
    y = hvd.allreduce(x, op=hvd.Average, name="scaled",
                      prescale_factor=1 / 3, postscale_factor=0.7)
    hvd.shutdown()
    np.save(out_path, y.to(torch.float32).numpy())


def test_two_rank_scaled_bf16_allreduce_matches_jax(tmp_path):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.ops import collectives as jC

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, HVD_TPU_COORDINATOR=f"127.0.0.1:{port}",
               HVD_TPU_NUM_PROC="2", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--scale-worker", str(r),
         str(tmp_path / f"rank{r}.npy")], env=dict(env, HVD_TPU_PROC_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r]}"

    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    f = jax.jit(jax.shard_map(
        lambda v: jC.allreduce(v[0], jC.ReduceOp.AVERAGE, "hvd", 1 / 3,
                               0.7)[None],
        mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd")))
    x = jnp.asarray(_scale_data(), jnp.bfloat16)
    want = f.lower(x).compile(
        compiler_options={"xla_allow_excess_precision": False})(x)
    for r in range(2):
        np.testing.assert_array_equal(
            _bits(np.load(tmp_path / f"rank{r}.npy")),
            _bits(np.asarray(want[r].astype(jnp.float32))))


# -- K2 / K4 --------------------------------------------------------------------

def _assert_quant_equal(jq, tq):
    """Codes bitwise in every block whose scale is bitwise equal (all
    blocks, against the jnp fallback), within 1 in the rest; scales to
    rtol 1e-6."""
    q, s, n = jq
    tq_, ts, tn = tq
    assert tn == n
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=SCALE_RTOL)
    same = ts.numpy() == np.asarray(s)
    got = tq_.numpy().reshape(len(same), -1).astype(np.int32)
    want = np.asarray(q).reshape(len(same), -1).astype(np.int32)
    np.testing.assert_array_equal(got[same], want[same])
    assert np.abs(got - want).max(initial=0) <= 1
    return same


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4096), (5000,), (33, 4, 16), (1,)])
def test_quantize_matches_jax(rng, shape, dtype, use_pallas):
    x, xt = _inputs(rng, shape, dtype)
    jq = pk.quantize_int8(x, use_pallas=use_pallas)
    tq = kernels.quantize_int8(xt)
    assert tuple(tq[0].shape) == tuple(jq[0].shape)
    same = _assert_quant_equal(jq, tq)
    if not use_pallas:
        assert same.all()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4096), (5000,), (33, 4, 16)])
def test_dequantize_matches_jax(rng, shape, dtype, use_pallas):
    x, _ = _inputs(rng, shape, dtype)
    q, s, n = pk.quantize_int8(x, use_pallas=False)
    want = pk.dequantize_int8(q, s, n, shape, dtype=_JAX[dtype],
                              use_pallas=use_pallas)
    got = kernels.dequantize_int8(torch.from_numpy(np.array(q)),
                                  torch.from_numpy(np.array(s)), n,
                                  shape, dtype=_TORCH[dtype])
    assert got.dtype == _TORCH[dtype] and tuple(got.shape) == shape
    np.testing.assert_array_equal(
        got.to(torch.float32).numpy(),
        np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_ties_and_zero_block_match_jax(dtype):
    """Exact .5 ties round half to even (rint, not round-half-away), an
    all-zero block quantizes to zero codes with the 1e-30 floor scale,
    and a ragged tail pads with code 0."""
    x = np.zeros(3 * 4096 + 77, np.float32)
    # Block 1: absmax 127 -> scale exactly 1, so x/s is x itself.
    x[4096:4096 + 8] = [127.0, 2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5]
    x[2 * 4096:] = np.linspace(-4, 4, 4096 + 77)
    xj = jnp.asarray(x, _JAX[dtype])
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        _TORCH[dtype])
    assert _assert_quant_equal(pk.quantize_int8(xj, use_pallas=False),
                               kernels.quantize_int8(xt)).all()
    assert _assert_quant_equal(pk.quantize_int8(xj, use_pallas=True),
                               kernels.quantize_int8(xt))[:2].all()
    q, s, n = kernels.quantize_int8(xt)
    flat = q.reshape(-1)
    assert flat[:4096].abs().max().item() == 0
    assert s[0].item() == pytest.approx(1e-30 / 127.0, rel=SCALE_RTOL)
    assert flat[4096:4096 + 8].tolist() == [127, 2, -2, 4, -4, 0, 0, 2]
    assert flat[n:].abs().max().item() == 0


def test_roundtrip_error_bound(rng):
    """absmax/127 per block bounds the round-trip error by scale/2."""
    _, xt = _inputs(rng, (9001,), "float32")
    q, s, n = kernels.quantize_int8(xt)
    out = kernels.dequantize_int8(q, s, n, xt.shape)
    assert (out - xt).abs().max().item() <= s.max().item() / 2 + 1e-6


def test_cpu_tensor_takes_plain_path_and_counts_no_launch(monkeypatch,
                                                          rng):
    """On the CPU the wrappers never build or load the CUDA library and
    count no kernel launch."""
    def no_cuda(*_):
        raise AssertionError("CPU tensors must not reach the CUDA library")

    monkeypatch.setattr(kernels, "_load", no_cuda)
    kernels.reset_launch_counts()
    _, xt = _inputs(rng, (5000,), "bfloat16")
    kernels.scale_buffer(xt, 0.5, torch.float32)
    q, s, n = kernels.quantize_int8(xt)
    kernels.dequantize_int8(q, s, n, (5000,), torch.bfloat16)
    a = torch.from_numpy(rng.standard_normal((1, 8, 2, 64))
                         .astype(np.float32))
    o, lse = kernels.flash_fwd(a, a, a, causal=True)
    kernels.flash_bwd(a, a, a, None, True, o, lse, a)
    u = torch.zeros((kernels.stochastic_rows(5000), 128))
    kernels.quantize_int8_stochastic(xt, u)
    dn = kernels.adasum_dot_norms(xt, xt)
    kernels.adasum_combine(xt, xt, dn)
    assert set(kernels.LAUNCHES) == {"scale_buffer", "quantize_int8",
                                     "dequantize_int8",
                                     "quantize_int8_stochastic",
                                     "flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv", "adasum_dot_norms",
                                     "adasum_combine"}
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_wrappers_reject_bad_inputs(rng):
    _, xt = _inputs(rng, (100,), "float32")
    with pytest.raises(TypeError):
        kernels.quantize_int8(xt.to(torch.float16))
    q, s, n = kernels.quantize_int8(xt)
    with pytest.raises(TypeError):
        kernels.dequantize_int8(q, s, n, (100,), torch.float16)
    with pytest.raises(ValueError):
        kernels.dequantize_int8(q, s, n, (101,))
    with pytest.raises(TypeError):
        kernels.dequantize_int8(q.to(torch.int16), s, n, (100,))


if __name__ == "__main__" and sys.argv[1:2] == ["--scale-worker"]:
    _scale_worker(int(sys.argv[2]), sys.argv[3])


# -- the device guard of every launch --------------------------------------

def test_launch_runs_under_a_guard_on_the_tensor_device(monkeypatch):
    """``_launch`` enters ``torch.cuda.device(t.device)``, queries that
    device's current stream, calls the C entry point with the stream as
    its last argument, and leaves the guard; a nonzero return raises
    naming the CUDA error, with the guard left all the same."""
    events = []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            events.append(("enter", self.dev))

        def __exit__(self, *exc):
            events.append(("exit", self.dev))
            return False

    def current_stream(dev=None):
        events.append(("stream", dev))
        return types.SimpleNamespace(cuda_stream=0xBEEF)

    calls = []

    def entry(*args):
        events.append(("call",))
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(hvd_probe=entry)
    monkeypatch.setattr(kernels, "_load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    dev = torch.device("cuda", 1)
    t = types.SimpleNamespace(device=dev)
    kernels._launch("probe", t, "probe.cu", "hvd_probe", 3, 4.5)
    assert events == [("enter", dev), ("stream", dev), ("call",),
                      ("exit", dev)]
    assert calls == [(3, 4.5, 0xBEEF)]
    events.clear()
    lib.hvd_probe = lambda *args: 700
    with pytest.raises(RuntimeError, match="probe: .*cudaError 700"):
        kernels._launch("probe", t, "probe.cu", "hvd_probe")
    assert events[-1] == ("exit", dev)


def test_every_kernel_launch_goes_through_the_guard():
    """The C libraries are reached only from ``_launch``: no other
    function of ``ops/kernels.py`` calls ``_load`` or reads a stream, and
    every C entry point of every source is named in a ``_launch`` call."""
    tree = ast.parse(Path(kernels.__file__).read_text())
    loads, streams, launched = set(), set(), set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Name):
                if node.func.id == "_load":
                    loads.add(fn.name)
                if node.func.id == "_launch" and len(node.args) >= 4 \
                        and isinstance(node.args[3], ast.Constant):
                    launched.add(node.args[3].value)
            if isinstance(node, ast.Attribute) and node.attr in (
                    "current_stream", "cuda_stream"):
                streams.add(fn.name)
    assert loads == {"_launch"} and streams == {"_launch"}
    assert launched == {fn for sigs in kernels._SIGNATURES.values()
                        for fn in sigs}
