"""Plain PyTorch pieces of the reference models, in fp32.

``precision`` selects how a matmul's operands are held: ``"fp32"`` (the
reference; TF32 must be off, see :func:`fp32_matmuls`) or ``"fp8"`` (the
control: every operand of every dense layer and of the head rounded to
float8 e4m3 with a per-tensor scale, and the gradient flowing back through
it to float8 e5m2, as fp8 training holds them; the product is then taken in
fp32). Imports nothing of the program."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().to(torch.float32)
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x / scale).to(dtype).to(torch.float32) * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def block_specs(i: int, h: int, m: int):
    """``param_specs`` entries of pre-LN block ``i`` (hidden ``h``, MLP
    ``m``): ``(name, shape, kind, std)``."""
    p = f"layers.{i}."
    return [(p + "ln1.weight", (h,), "ln_scale", 0.0),
            (p + "ln1.bias", (h,), "ln_shift", 0.0),
            (p + "attn.qkv.weight", (3 * h, h), "weight", h ** -0.5),
            (p + "attn.qkv.bias", (3 * h,), "bias", 0.0),
            (p + "attn.out.weight", (h, h), "weight", h ** -0.5),
            (p + "attn.out.bias", (h,), "bias", 0.0),
            (p + "ln2.weight", (h,), "ln_scale", 0.0),
            (p + "ln2.bias", (h,), "ln_shift", 0.0),
            (p + "mlp_in.weight", (m, h), "weight", h ** -0.5),
            (p + "mlp_in.bias", (m,), "bias", 0.0),
            (p + "mlp_out.weight", (h, m), "weight", m ** -0.5),
            (p + "mlp_out.bias", (h,), "bias", 0.0)]


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {precision!r}")


def linear(x, w, b, precision: str):
    """``x @ w.T + b`` with operands held in ``precision``."""
    return F.linear(operand(x, precision), operand(w, precision), b)


def layer_norm(x, w, b, eps: float):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def softmax_attention(q, k, v, causal: bool, key_mask=None):
    """Materialized attention on (B, S, H, D): scores q k^T / sqrt(D), the
    causal or key mask, softmax over keys, then the weighted values."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    neg = torch.finfo(s.dtype).min
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, neg)
    if key_mask is not None:
        s = s.masked_fill(key_mask[:, None, None, :] <= 0, neg)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@contextlib.contextmanager
def fp32_matmuls():
    """Full fp32 products: a float32 matmul on the GPU may run in TF32
    unless both switches are off."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
