"""What the bf16 Hopper route of K5 (flash forward), K6 (flash dQ) and K7
(flash dK/dV) changes, checked on the CPU.

1. The wrapper's layout rule (``kernels.tma_layout_ok``): a pure function
   of shape, strides, element size and data pointer. The fused QKV
   projection's ``split`` views pass without a copy; a view whose row
   stride or base address is not a multiple of 16 bytes is copied once
   (the kernel still reads the copy).
2. The new kernels' roundings: they round P and dS to bf16 before the
   products P.V, dS.K, P^T.dO and dS^T.Q, where the JAX kernels and the
   package's plain versions keep them fp32. An emulation of those
   roundings, defined here (K5's online softmax and K6's sum over 64-key
   tiles, as the kernels run them), is held at (2, 512, 4, 64) on
   bf16-valued inputs, causal, causal with a key mask and with a key mask
   alone, to the bf16 tolerance 2e-2 against ``_flash_fwd_plain``/
   ``_flash_bwd_dq_plain``/``_flash_bwd_dkv_plain`` and against the JAX
   ``_fwd_kernel``/``_dq_kernel``/``_dkv_kernel`` run in interpret mode
   on the same numpy inputs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jflash
from horovod_tpu_torch.ops import kernels

B, S, H, D = 2, 512, 4, 64
TILE = 64                   # the kernels' q and key tiles
BF16_TOL = 2e-2             # chip_smoke.py FLASH_TOL["bfloat16"]


# -- 1. the layout rule ---------------------------------------------------------

def _fused_views(dtype=torch.bfloat16, b=B, s=S, h=H, d=D):
    qkv = torch.zeros((b, s, 3 * h * d), dtype=dtype)
    return [t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1)]


def _ok(t):
    return kernels.tma_layout_ok(tuple(t.shape), t.stride(),
                                 t.element_size(), t.data_ptr())


@pytest.mark.parametrize("which", [0, 1, 2], ids=["q", "k", "v"])
def test_fused_qkv_views_pass_without_a_copy(which):
    """The training path's q, k, v: row stride 3 H D, base offset
    ``which`` x H x D elements — all multiples of 16 bytes."""
    t = _fused_views()[which]
    assert t.stride() == (S * 3 * H * D, 3 * H * D, D, 1)
    assert _ok(t)
    assert kernels._tma_operand(t) is t


def test_contiguous_tensor_passes():
    t = torch.zeros((B, S, H, D), dtype=torch.bfloat16)
    assert _ok(t) and kernels._tma_operand(t) is t


def _row_stride_off():
    """Rows H D + 4 elements apart: 2,056 bytes, not a multiple of 16."""
    base = torch.arange(B * S * (H * D + 4), dtype=torch.float32)
    return base.to(torch.bfloat16).reshape(B, S, H * D + 4)[
        ..., :H * D].reshape(B, S, H, D)


def _base_off():
    """A base address 2 bytes past a 16-byte boundary."""
    flat = torch.arange(B * S * H * D + 1, dtype=torch.float32)
    return flat.to(torch.bfloat16)[1:].reshape(B, S, H, D)


@pytest.mark.parametrize("make", [_row_stride_off, _base_off],
                         ids=["row_stride", "base_address"])
def test_misaligned_view_is_copied_once(make):
    t = make()
    assert not _ok(t)
    c = kernels._tma_operand(t)
    assert c is not t and c.is_contiguous() and _ok(c)
    assert torch.equal(c, t)


def test_rule_cases():
    """The rule by its arguments alone: a dimension of length 1 may have
    any stride; a strided head dimension or an odd element stride fails;
    element size counts (fp32 rows of 4 elements are 16 bytes)."""
    ok = kernels.tma_layout_ok
    assert ok((1, 8, 2, 64), (3, 128, 64, 1), 2, 4096)
    assert not ok((2, 8, 2, 64), (3, 128, 64, 1), 2, 4096)
    assert not ok((2, 8, 2, 64), (1024, 128, 64, 2), 2, 4096)
    assert not ok((2, 8, 2, 64), (1024, 132, 64, 1), 2, 4096)
    assert ok((2, 8, 2, 4), (64, 8, 4, 1), 4, 4096)
    assert not ok((2, 8, 2, 4), (64, 8, 4, 1), 2, 4096)
    assert not ok((2, 8, 2, 64), (1024, 128, 64, 1), 2, 4104)


# -- 2. the kernels' roundings --------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _logits(q, k, mask, causal):
    """(B, H, S, S) fp32 logits as the kernels form them: -1e30 under
    the key mask, -inf after the query."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s,
                        torch.full_like(s, kernels.MASK_VALUE))
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones((n, n), dtype=torch.bool).triu(1),
                          float("-inf"))
    return s


def _emulated_fwd(q, k, v, mask, causal):
    """K5's bf16 route: online softmax over 64-key tiles in fp32, each
    tile's P rounded to bf16 before P.V, the sum l kept in fp32, o
    rounded to bf16."""
    s = _logits(q, k, mask, causal)
    b, h, n, _ = s.shape
    m = torch.full((b, h, n, 1), kernels.MASK_VALUE)
    l = torch.zeros((b, h, n, 1))
    acc = torch.zeros((b, h, n, q.shape[-1]))
    for k0 in range(0, n, TILE):
        sj = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
        p = torch.exp(sj - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", _bf16(p), v[:, k0:k0 + TILE])
        m = m_new
    l = l.clamp_min(1e-30)
    o = _bf16((acc / l).permute(0, 2, 1, 3))
    return o, (m + torch.log(l)).squeeze(-1)


def _emulated_dq(q, k, v, mask, causal, do, lse, delta, dlse):
    """K6's bf16 route: P and dS in fp32, each 64-key tile's dS rounded
    to bf16 before dS.K, the tiles' products summed in fp32; dq scaled
    and rounded to bf16."""
    p = torch.exp(_logits(q, k, mask, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta[..., None] + dlse[..., None])
    acc = torch.zeros(q.shape)
    for k0 in range(0, ds.shape[-1], TILE):
        acc = acc + torch.einsum("bhqk,bkhd->bqhd",
                                 _bf16(ds[..., k0:k0 + TILE]),
                                 k[:, k0:k0 + TILE])
    return _bf16(acc / math.sqrt(q.shape[-1]))


def _emulated_dkv(q, k, v, mask, causal, do, lse, delta, dlse):
    """K7's bf16 route: P and dS in fp32, each rounded to bf16 before
    P^T.dO and dS^T.Q; dk and dv rounded to bf16."""
    p = torch.exp(_logits(q, k, mask, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta[..., None] + dlse[..., None])
    scale = 1.0 / math.sqrt(q.shape[-1])
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), do)
    return _bf16(dk), _bf16(dv)


def _inputs(seed, masked):
    """bf16-valued fp32 numpy inputs: q, k, v, do, dlse and, if asked, a
    key mask with key 0 always on."""
    rng = np.random.default_rng(seed)

    def bf(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return _bf16(torch.from_numpy(x)).numpy()

    q, k, v, do = (bf((B, S, H, D)) for _ in range(4))
    dlse = rng.standard_normal((B, H, S)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((B, S)) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
    return q, k, v, do, dlse, mask


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL, err_msg=what)


def _jax_mask(mask):
    return jnp.ones((B, S), jnp.float32) if mask is None \
        else jnp.asarray(mask)


CASES = [(True, False), (True, True), (False, True)]
IDS = ["causal", "causal_keymask", "keymask"]


@pytest.mark.parametrize("causal,masked", CASES, ids=IDS)
def test_bf16_forward_rounding_within_tolerance(causal, masked):
    """K5's roundings against the plain version and the JAX kernel."""
    q, k, v, _, _, mask = _inputs(7, masked)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = _emulated_fwd(*t, tmask, causal)
    o0, lse0 = kernels._flash_fwd_plain(*t, tmask, causal)
    _close(o, o0, "o vs plain")
    _close(lse, lse0, "lse vs plain")
    jo, jlse = jflash._flash_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v)), _jax_mask(mask), causal,
        TILE, TILE, True)
    _close(o, jo, "o vs the JAX _fwd_kernel")
    _close(lse, jlse, "lse vs the JAX _fwd_kernel")


@pytest.mark.parametrize("causal,masked", CASES, ids=IDS)
def test_bf16_dkv_rounding_within_tolerance(causal, masked):
    """K7's roundings against the plain version and the JAX kernel, with
    lse, delta and a nonzero dlse from the plain forward."""
    q, k, v, do, dlse, mask = _inputs(11, masked)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tdo, tdlse = torch.from_numpy(do), torch.from_numpy(dlse)
    tmask = None if mask is None else torch.from_numpy(mask)
    o0, lse0 = kernels._flash_fwd_plain(*t, tmask, causal)
    delta = kernels.flash_delta(o0, tdo)
    dk, dv = _emulated_dkv(*t, tmask, causal, tdo, lse0, delta, tdlse)
    dk0, dv0 = kernels._flash_bwd_dkv_plain(*t, tmask, causal, tdo, lse0,
                                            delta, tdlse)
    _close(dk, dk0, "dk vs plain")
    _close(dv, dv0, "dv vs plain")
    res = (*(jnp.asarray(a) for a in (q, k, v)), _jax_mask(mask),
           jnp.asarray(o0.numpy()), jnp.asarray(lse0.numpy()))
    _, jdk, jdv, _ = jflash._flash_bwd(causal, TILE, TILE, True, res,
                                       (jnp.asarray(do), jnp.asarray(dlse)))
    _close(dk, jdk, "dk vs the JAX _dkv_kernel")
    _close(dv, jdv, "dv vs the JAX _dkv_kernel")


@pytest.mark.parametrize("causal,masked", CASES, ids=IDS)
def test_bf16_dq_rounding_within_tolerance(causal, masked):
    """K6's roundings against the plain version and the JAX kernel, with
    lse, delta and a nonzero dlse from the plain forward."""
    q, k, v, do, dlse, mask = _inputs(13, masked)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tdo, tdlse = torch.from_numpy(do), torch.from_numpy(dlse)
    tmask = None if mask is None else torch.from_numpy(mask)
    o0, lse0 = kernels._flash_fwd_plain(*t, tmask, causal)
    delta = kernels.flash_delta(o0, tdo)
    dq = _emulated_dq(*t, tmask, causal, tdo, lse0, delta, tdlse)
    dq0 = kernels._flash_bwd_dq_plain(*t, tmask, causal, tdo, lse0, delta,
                                      tdlse)
    _close(dq, dq0, "dq vs plain")
    res = (*(jnp.asarray(a) for a in (q, k, v)), _jax_mask(mask),
           jnp.asarray(o0.numpy()), jnp.asarray(lse0.numpy()))
    jdq, _, _, _ = jflash._flash_bwd(causal, TILE, TILE, True, res,
                                     (jnp.asarray(do), jnp.asarray(dlse)))
    _close(dq, jdq, "dq vs the JAX _dq_kernel")


def test_length_one_dimension_gets_the_dense_stride():
    """The strides handed to the kernels: a dimension of length 1 (which
    the rule ignores) is given its dense stride, which a TMA map takes."""
    t = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16).as_strided(
        (1, 8, 2, 64), (3, 128, 64, 1))
    assert _ok(t)
    assert kernels._bsh_strides(t) == [8 * 2 * 64, 128, 64]
    v = _fused_views()[2]
    assert kernels._bsh_strides(v) == list(v.stride()[:3])
