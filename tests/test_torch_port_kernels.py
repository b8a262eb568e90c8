"""The port's int8 KV-wire codec (K2 ``quantize_int8``, K4
``dequantize_int8``) against the JAX package's.

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
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch.ops import kernels

SCALE_RTOL = 1e-6

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(rng, shape, dtype):
    """The same values for both packages: numpy f32, rounded to the
    dtype by JAX, handed to torch bit for bit."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 3,
                    _JAX[dtype])
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        _TORCH[dtype])
    return x, xt


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
    def no_cuda():
        raise AssertionError("CPU tensors must not reach the CUDA library")

    monkeypatch.setattr(kernels, "_load", no_cuda)
    kernels.reset_launch_counts()
    _, xt = _inputs(rng, (5000,), "bfloat16")
    q, s, n = kernels.quantize_int8(xt)
    kernels.dequantize_int8(q, s, n, (5000,), torch.bfloat16)
    assert kernels.LAUNCHES == {"quantize_int8": 0, "dequantize_int8": 0}


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
