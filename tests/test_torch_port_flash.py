"""The port's flash attention (K5 forward, K6/K7 backward) against the
JAX package's.

On the CPU the port's kernel wrappers take their plain PyTorch versions;
those are held here against ``horovod_tpu.ops.flash_attention`` with
``use_pallas=True``, which runs the real Pallas kernel bodies in
interpret mode (as ``tests/test_flash_attention.py`` does), at
B = 2, S = 128, H = 2, D in {64, 128} with 64-row blocks so the JAX
kernels take their multi-block and causal-bound paths. Bounds are the
reference's own (``tests/test_flash_attention.py``): fp32 forward 2e-4,
bf16 inputs 2e-2, gradients 5e-3. The JAX wrapper pads D = 64 to 128 and
folds a sqrt(2) into q; the port takes D = 64 with scale exactly 1/8 —
the two agree to fp32 rounding, well inside these bounds. The CUDA
kernels are held against the same plain versions on the card by
``test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jflash
from horovod_tpu_torch.ops import flash_attention as tflash
from horovod_tpu_torch.ops import kernels

B, S, H = 2, 128, 2
BLOCK = 64
FWD_TOL = 2e-4          # fp32 forward (test_flash_attention.py:27)
BF16_TOL = 2e-2         # bf16 inputs (test_flash_attention.py:103)
GRAD_TOL = 5e-3         # gradients (test_flash_attention.py:76)


def _qkv(rng, d, s=S):
    return [rng.standard_normal((B, s, H, d)).astype(np.float32)
            for _ in range(3)]


def _key_mask(rng, s=S):
    mask = (rng.random((B, s)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return mask


def _jax_fwd(q, k, v, mask, causal):
    return jflash.flash_attention_with_lse(
        *(jnp.asarray(a) for a in (q, k, v)),
        mask=None if mask is None else jnp.asarray(mask), causal=causal,
        use_pallas=True, block_q=BLOCK, block_k=BLOCK)


def _torch_fwd(q, k, v, mask, causal):
    return tflash.flash_attention_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["masked", "causal"])
def test_forward_matches_jax_kernel(rng, d, causal):
    """o and lse: non-causal with a key mask, and causal, fp32."""
    q, k, v = _qkv(rng, d)
    mask = None if causal else _key_mask(rng)
    jo, jlse = _jax_fwd(q, k, v, mask, causal)
    to, tlse = _torch_fwd(q, k, v, mask, causal)
    assert to.shape == (B, S, H, d) and tlse.shape == (B, H, S)
    assert to.dtype == torch.float32 and tlse.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_forward_bf16_inputs(rng):
    """bf16 q, k, v (the same rounded values in both packages): o stays
    bf16 and agrees within 2e-2; lse is fp32."""
    q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in _qkv(rng, 64))
    jo, jlse = jflash.flash_attention_with_lse(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        use_pallas=True, block_q=BLOCK, block_k=BLOCK)
    to, tlse = tflash.flash_attention_with_lse(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=True)
    assert to.dtype == torch.bfloat16 and tlse.dtype == torch.float32
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["masked", "causal"])
def test_backward_matches_jax_kernel(rng, d, causal):
    """dq, dk, dv of a loss that reads both o and lse (so the lse
    cotangent is nonzero), against jax.grad through the Pallas backward
    kernels."""
    q, k, v = _qkv(rng, d)
    mask = None if causal else _key_mask(rng)
    w_o = rng.standard_normal((B, S, H, d)).astype(np.float32)
    w_l = rng.standard_normal((B, H, S)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = _jax_fwd(q, k, v, mask, causal)
        return (o * w_o).sum() + (lse * w_l).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = tflash.flash_attention_with_lse(
        tq, tk, tv, mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    ((o * torch.from_numpy(w_o)).sum()
     + (lse * torch.from_numpy(w_l)).sum()).backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref), rtol=GRAD_TOL, atol=GRAD_TOL,
            err_msg=f"d{name} (causal={causal}, D={d})")


def test_fully_masked_row_is_uniform_like_jax(rng):
    """A batch row whose keys are all masked: every logit is -1e30, so
    the softmax is the uniform average of v — finite, equal to the JAX
    kernel's result, not NaN and not 0."""
    q, k, v = _qkv(rng, 64)
    mask = _key_mask(rng)
    mask[1, :] = 0.0
    jo, jlse = _jax_fwd(q, k, v, mask, False)
    to, tlse = _torch_fwd(q, k, v, mask, False)
    assert torch.isfinite(to).all() and torch.isfinite(tlse).all()
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse),
                               rtol=FWD_TOL, atol=FWD_TOL)
    uniform = np.broadcast_to(v[1].mean(axis=0), (S, H, 64))
    np.testing.assert_allclose(to[1].numpy(), uniform, rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_ragged_sequence_matches_jax_reference(rng):
    """S = 100 has no multiple-of-8 divisor, so the JAX wrapper declines
    to its reference; the port's kernels take any S. Forward and
    gradients agree with the JAX reference path."""
    q, k, v = _qkv(rng, 64, s=100)

    def jloss(q, k, v):
        return (jflash.flash_attention(q, k, v, causal=True) ** 2).sum()

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    loss = (tflash.flash_attention(tq, tk, tv, causal=True) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=FWD_TOL)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["masked", "causal"])
def test_reference_attention_matches_jax(rng, causal):
    q, k, v = _qkv(rng, 64)
    mask = None if causal else _key_mask(rng)
    want = jflash.reference_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        mask=None if mask is None else jnp.asarray(mask), causal=causal)
    got = tflash.reference_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_plain_backward_equals_the_autograd_path(rng):
    """``_flash_bwd_plain`` (what the card's kernels are held against)
    is what the CPU autograd path computes."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 64))
    mask = torch.from_numpy(_key_mask(rng))
    do = torch.from_numpy(rng.standard_normal((B, S, H, 64))
                          .astype(np.float32))
    dlse = torch.from_numpy(rng.standard_normal((B, H, S))
                            .astype(np.float32))
    o, lse = kernels._flash_fwd_plain(q, k, v, mask, False)
    want = kernels._flash_bwd_plain(q, k, v, mask, False, o, lse, do, dlse)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    to, tlse = tflash.flash_attention_with_lse(*leaves, mask=mask)
    torch.autograd.backward((to, tlse), (do, dlse))
    for leaf, ref in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, ref, rtol=0, atol=0)


def test_flash_knob_declines_to_reference(rng, monkeypatch):
    """``HVD_TPU_FLASH_ATTENTION=0`` turns the kernels off: CPU tensors
    take the reference result, and any other tensor raises instead of
    taking a plain path (a meta tensor stands in for the card's)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 64))
    monkeypatch.setenv("HVD_TPU_FLASH_ATTENTION", "0")
    assert not tflash.flash_available(S)
    assert tflash.flash_attention_with_lse(q, k, v) is None
    torch.testing.assert_close(tflash.flash_attention(q, k, v, causal=True),
                               tflash.reference_attention(q, k, v,
                                                          causal=True))
    meta = torch.empty((B, S, H, 64), device="meta")
    kernels.reset_launch_counts()
    for fn in (tflash.flash_attention_with_lse, tflash.flash_attention):
        with pytest.raises(RuntimeError, match="HVD_TPU_FLASH_ATTENTION"):
            fn(meta, meta, meta, causal=True)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    monkeypatch.setenv("HVD_TPU_FLASH_ATTENTION", "1")
    assert tflash.flash_available(S)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_backward_wrappers_check_do(device, bad):
    """The backward kernels read ``do`` through q's shape and dtype, so
    K6 and K7 refuse a ``do`` that differs in either, before any launch
    and on every device."""
    q = torch.zeros((B, S, H, 64), dtype=torch.bfloat16, device=device)
    row = torch.zeros((B, H, S), device=device)
    do = torch.zeros((B, S + 1, H, 64), dtype=torch.bfloat16,
                     device=device) if bad == "shape" else q.float()
    kernels.reset_launch_counts()
    for fn in (kernels.flash_bwd_dq, kernels.flash_bwd_dkv):
        with pytest.raises(ValueError if bad == "shape" else TypeError,
                           match="do must have q's"):
            fn(q, q, q, None, True, do, row, row)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_non_cpu_tensor_never_takes_the_plain_path():
    """The plain versions run only for CPU tensors: any other device
    reaches the kernel launch or raises — here a meta tensor raises
    before a launch, and counts none."""
    q = torch.empty((B, S, H, 64), device="meta")
    kernels.reset_launch_counts()
    for fn, args in ((kernels.flash_fwd, (q, q, q)),
                     (kernels.flash_bwd_dq, (q, q, q, None, True, q,
                                             None, None)),
                     (kernels.flash_bwd_dkv, (q, q, q, None, True, q,
                                              None, None))):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*args)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="same|share"):
        kernels.flash_fwd(torch.zeros((1, 4, 1, 64)),
                          torch.zeros((1, 5, 1, 64)),
                          torch.zeros((1, 4, 1, 64)))
