"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the scale kernel (K1), the int8 codec (K2/K4, per leaf, grouped
and into a cache slot), flash attention (K5/K6/K7), the stochastic
quantizer (K3) and the Adasum combine (K8/K9), and the paths that run
them — two of them as two gloo ranks sharing the one card, each a
process running this file with ``--card-worker``. Every test here needs
an NVIDIA GPU and skips with a reason elsewhere. This file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parents[1]
NEW_KERNELS = {"scale_buffer": 0, "quantize_int8_stochastic": 0,
               "adasum_dot_norms": 0, "adasum_combine": 0}

SCALE_RTOL = 1e-6
FLASH_FWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
FLASH_GRAD_TOL = {torch.float32: 5e-3, torch.bfloat16: 2e-2}


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card():
    """K2/K4 launched on the card against their plain versions at the
    serve path's leaf shape and ragged sizes: codes and outputs bitwise,
    scales to 1e-6, one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels.reset_launch_counts()
    shapes = [(1024, 16, 64), (37, 16, 64), (5000,), (1,)]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            q, s, n = kernels.quantize_int8(x)
            q0, s0, n0 = kernels._quantize_plain(x)
            out = kernels.dequantize_int8(q, s, n, shape, dtype)
            out0 = kernels._dequantize_plain(q0, s0, n0, shape, dtype)
            torch.cuda.synchronize()
            assert torch.equal(q, q0)
            assert ((s - s0).abs() / s0).max().item() <= SCALE_RTOL
            assert torch.equal(out, out0)
    assert kernels.LAUNCHES == {
        "quantize_int8": 2 * len(shapes), "dequantize_int8": 2 * len(shapes),
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        **NEW_KERNELS}
    assert kernels.CODEC_LEAVES == {"quantize_int8": 2 * len(shapes),
                                    "dequantize_int8": 2 * len(shapes)}


def _codec_group(gen):
    """The grouped case: 48 handoff leaves (1024, 16, 64) bf16, two fp32
    leaves, the ragged sizes in both dtypes, a bf16 and an fp32 view one
    element past a 16-byte boundary (the scalar path), and an all-zero
    first block in leaf 0: 62 leaves."""
    xs = [torch.randn((1024, 16, 64), generator=gen, device="cuda")
          .to(torch.bfloat16) for _ in range(48)]
    xs += [torch.randn((1024, 16, 64), generator=gen, device="cuda")
           for _ in range(2)]
    for dtype in (torch.bfloat16, torch.float32):
        xs += [torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((1,), (4095,), (4097,), (5000,), (37, 16, 64))]
        xs.append(torch.randn(9001, generator=gen, device="cuda")
                  .to(dtype)[1:])
    xs[0].view(-1)[:4096] = 0
    return xs


def _check_group(xs):
    """quantize_int8_group then dequantize_int8_into over ``xs`` (each
    misaligned input dequantized into a misaligned output), leaf by leaf
    against the plain versions: codes and outputs bitwise, scales to
    1e-6."""
    got = kernels.quantize_int8_group(xs)
    outs = [torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:]
            .view(x.shape) if x.data_ptr() % 16 else torch.empty_like(x)
            for x in xs]
    kernels.dequantize_int8_into(got, outs)
    torch.cuda.synchronize()
    for x, (q, s, n), out in zip(xs, got, outs):
        q0, s0, n0 = kernels._quantize_plain(x)
        assert n == n0 and torch.equal(q, q0)
        assert ((s - s0).abs() / s0).max().item() <= SCALE_RTOL
        want = kernels._dequantize_plain(q0, s0, n0, x.shape, x.dtype)
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_grouped_codec_matches_plain_on_card():
    """One grouped K2 launch and one grouped K4 launch code 62 leaves of
    mixed dtypes, ragged sizes and alignments (two misaligned views take
    the scalar path) bitwise like the plain versions leaf by leaf; 65
    leaves or more split into two launches a side."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = _codec_group(gen)
    assert len(xs) == 62
    assert sum(x.data_ptr() % 16 != 0 for x in xs) == 2
    kernels.reset_launch_counts()
    _check_group(xs)
    assert kernels.LAUNCHES["quantize_int8"] == 1
    assert kernels.LAUNCHES["dequantize_int8"] == 1
    assert kernels.CODEC_LEAVES == {"quantize_int8": 62,
                                    "dequantize_int8": 62}
    more = xs + [torch.randn(4096 * (1 + i % 3) - i, generator=gen,
                             device="cuda") for i in range(8)]
    kernels.reset_launch_counts()
    _check_group(more)
    assert kernels.LAUNCHES["quantize_int8"] == 2
    assert kernels.LAUNCHES["dequantize_int8"] == 2
    assert kernels.CODEC_LEAVES == {"quantize_int8": 70,
                                    "dequantize_int8": 70}


@pytest.mark.cuda
def test_dequantize_into_a_cache_slot_keeps_the_other_slots():
    """K4 into slot 3 of an (8, 1024, 16, 64) bf16 slab filled with a
    NaN sentinel: the slot is bitwise the plain version's, the other
    seven slots keep the sentinel to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(6)
    slab = torch.empty((8, 1024, 16, 64), dtype=torch.bfloat16,
                       device="cuda")
    slab.view(torch.int16).fill_(0x7FA5)
    x = torch.randn((1024, 16, 64), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    q, s, n = kernels.quantize_int8(x)
    kernels.dequantize_int8_into([(q, s, n)], [slab[3]])
    want = kernels._dequantize_plain(q, s, n, x.shape, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(slab[3], want)
    others = torch.cat([slab[:3], slab[4:]]).view(torch.int16)
    assert bool((others == 0x7FA5).all())


@pytest.mark.cuda
def test_disagg_serving_on_card_runs_the_kernels():
    """The slice's path on the card: a disaggregated gpt_tiny cluster
    (fp32, seeded weights) hands every sequence over through the CUDA
    codec — one grouped launch of each kernel per handoff, coding 2
    layers x (k, v) = 4 leaves — and gives the same greedy token streams
    as the same weights on the CPU, where the plain codec runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.serve import controller, engine, traffic

    weights = gpt.gpt_tiny().init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    streams = {}
    for device in ("cpu", "cuda"):
        factory = engine.make_engine_factory(
            gpt.gpt_tiny(), weights, device=device, slots=4, max_len=32,
            max_prompt_len=16)
        cluster = controller.ServeCluster(
            factory, policy=controller.SLOPolicy(),
            roles={"prefill": 1, "decode": 1}, step_s=0.05, log_path="")
        kernels.reset_launch_counts()
        rep = cluster.run(traffic.poisson_trace(seed=5, n_requests=20,
                                                rate_rps=20.0))
        assert rep["dropped"] == 0 and rep["handoffs"] >= 1
        streams[device] = {r.rid: r.tokens for r in cluster.completed}
        launches = rep["handoffs"] if device == "cuda" else 0
        assert kernels.LAUNCHES == {
            "quantize_int8": launches, "dequantize_int8": launches,
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            **NEW_KERNELS}
        assert kernels.CODEC_LEAVES == {"quantize_int8": 4 * launches,
                                        "dequantize_int8": 4 * launches}
    assert streams["cuda"] == streams["cpu"]


# (B, S, H, D), dtype, causal, key mask, nonzero dlse, q/k/v as split
# views of one fused (B, S, 3 H D) tensor
FLASH_CASES = [
    ((8, 512, 16, 64), torch.bfloat16, True, False, False, False),
    ((8, 512, 16, 64), torch.float32, True, False, False, False),
    ((2, 256, 4, 64), torch.float32, False, True, False, False),
    ((2, 256, 4, 128), torch.float32, True, False, True, False),
    ((2, 200, 4, 64), torch.float32, True, True, True, False),
    ((2, 200, 4, 128), torch.bfloat16, False, False, True, False),
    ((2, 200, 4, 64), torch.bfloat16, True, True, True, False),
    ((8, 512, 16, 64), torch.bfloat16, True, False, False, True),
    ((2, 256, 4, 128), torch.bfloat16, True, False, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c[0]))
                         + f"-{str(c[1])[6:]}-causal{int(c[2])}"
                         f"-mask{int(c[3])}-dlse{int(c[4])}"
                         + ("-fused" if c[5] else ""))
def test_flash_kernels_match_plain_on_card(case):
    """K5, K6 and K7 launched on the card against their plain versions on
    the same inputs — the training shape, fp32 and bf16, key mask, D =
    128, a ragged S and a nonzero lse cotangent; in bf16 (the wgmma/TMA
    route of K5 and K7) also a ragged S with a key mask, D = 128 causal
    and the fused QKV views of the training path — one counted launch of
    each per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape, dtype, causal, use_mask, use_dlse, fused = case
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, s, h, d = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    if fused:
        qkv = torch.cat([t.reshape(b, s, h * d) for t in (q, k, v)], -1)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, -1))
    mask = None
    if use_mask:
        mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3
                ).float()
        mask[:, 0] = 1.0
    dlse = torch.randn((b, h, s), generator=gen, device="cuda") \
        if use_dlse else None
    kernels.reset_launch_counts()
    o, lse = kernels.flash_fwd(q, k, v, mask, causal)
    o0, lse0 = kernels._flash_fwd_plain(q, k, v, mask, causal)
    delta = kernels.flash_delta(o0, do)
    dq = kernels.flash_bwd_dq(q, k, v, mask, causal, do, lse0, delta, dlse)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, mask, causal, do, lse0, delta,
                                   dlse)
    dq0 = kernels._flash_bwd_dq_plain(q, k, v, mask, causal, do, lse0,
                                      delta, dlse)
    dk0, dv0 = kernels._flash_bwd_dkv_plain(q, k, v, mask, causal, do, lse0,
                                            delta, dlse)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {
        "quantize_int8": 0, "dequantize_int8": 0,
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
        **NEW_KERNELS}
    assert o.dtype == dtype and dq.dtype == dtype and lse.dtype == \
        torch.float32
    tol, gtol = FLASH_FWD_TOL[dtype], FLASH_GRAD_TOL[dtype]
    torch.testing.assert_close(o.float(), o0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse0, rtol=tol, atol=tol)
    for got, want in ((dq, dq0), (dk, dk0), (dv, dv0)):
        torch.testing.assert_close(got.float(), want.float(), rtol=gtol,
                                   atol=gtol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c[0]))
                         + f"-{str(c[1])[6:]}-causal{int(c[2])}"
                         f"-mask{int(c[3])}-dlse{int(c[4])}"
                         + ("-fused" if c[5] else ""))
def test_flash_backward_one_call_matches_plain_on_card(case):
    """The training path's backward, ``flash_bwd`` — one C call that
    launches K6 (in bf16 ``flash_bwd_dq_sm90``) and then K7 — against
    the plain K6 + K7 on the same inputs, one counted launch of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape, dtype, causal, use_mask, use_dlse, fused = case
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, s, h, d = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    if fused:
        qkv = torch.cat([t.reshape(b, s, h * d) for t in (q, k, v)], -1)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, -1))
    mask = None
    if use_mask:
        mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3
                ).float()
        mask[:, 0] = 1.0
    dlse = torch.randn((b, h, s), generator=gen, device="cuda") \
        if use_dlse else None
    o0, lse0 = kernels._flash_fwd_plain(q, k, v, mask, causal)
    kernels.reset_launch_counts()
    got = kernels.flash_bwd(q, k, v, mask, causal, o0, lse0, do, dlse)
    want = kernels._flash_bwd_plain(q, k, v, mask, causal, o0, lse0, do,
                                    dlse)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {
        "quantize_int8": 0, "dequantize_int8": 0, "flash_fwd": 0,
        "flash_bwd_dq": 1, "flash_bwd_dkv": 1, **NEW_KERNELS}
    gtol = FLASH_GRAD_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=gtol,
                                   atol=gtol)


@pytest.mark.cuda
def test_every_kernel_launches_inside_an_explicit_device_guard():
    """Inside ``torch.cuda.device(0)`` each of K1-K9 launches once on
    device 0's tensors and agrees with its plain version (the wrappers'
    own guard nests in the caller's). A second device is not exercised:
    it needs a machine with two cards."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(4)
    kernels.reset_launch_counts()
    with torch.cuda.device(0):
        x = torch.randn(9001, generator=gen, device="cuda:0")
        assert torch.equal(kernels.scale_buffer(x, 0.7),
                           kernels.scale_buffer_plain(x, 0.7))
        q, sc, n = kernels.quantize_int8(x)
        q0, sc0, _ = kernels._quantize_plain(x)
        assert torch.equal(q, q0)
        assert torch.equal(kernels.dequantize_int8(q, sc, n, x.shape),
                           kernels._dequantize_plain(q, sc, n, x.shape,
                                                     torch.float32))
        u = torch.rand((kernels.stochastic_rows(n), 128), generator=gen,
                       device="cuda:0")
        assert torch.equal(kernels.quantize_int8_stochastic(x, u)[0],
                           kernels._quantize_stochastic_plain(x, u)[0])
        y = torch.randn(9001, generator=gen, device="cuda:0")
        dn = kernels.adasum_dot_norms(x, y)
        assert torch.equal(kernels.adasum_combine(x, y, dn),
                           kernels._adasum_combine_plain(x, y, dn))
        shape = (2, 128, 2, 64)
        qa, ka, va, do = (torch.randn(shape, generator=gen,
                                      device="cuda:0").to(torch.bfloat16)
                          for _ in range(4))
        o, lse = kernels.flash_fwd(qa, ka, va, None, True)
        o0, lse0 = kernels._flash_fwd_plain(qa, ka, va, None, True)
        grads = kernels.flash_bwd(qa, ka, va, None, True, o0, lse0, do)
        want = kernels._flash_bwd_plain(qa, ka, va, None, True, o0, lse0,
                                        do)
        torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o0.float(), rtol=2e-2, atol=2e-2)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                   atol=2e-2)
    assert kernels.LAUNCHES == {name: 1 for name in kernels.LAUNCHES}


@pytest.mark.cuda
def test_gpt_training_step_on_card_matches_cpu():
    """One DistributedOptimizer(SGD) step of a small fp32 GPT (head dim
    64) on the card — through NCCL, with K5/K6/K7 launched once per
    layer each — against the same step on the CPU with the plain
    versions: loss to 1e-5 relative, updated parameters to 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt

    def model():
        return gpt.gpt_tiny(hidden=128, num_heads=2, num_layers=2)

    weights = model().init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    toks = torch.randint(0, 128, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    hvd.init()
    try:
        for device in ("cpu", "cuda"):
            m = model().to(device)
            m.load_state_dict(weights)
            opt = torch.optim.SGD(m.parameters(), lr=0.1)
            if device == "cuda":
                opt = hvd.DistributedOptimizer(
                    opt, named_parameters=m.named_parameters())
            t = toks.to(device)
            kernels.reset_launch_counts()
            loss = gpt.next_token_loss(m(t[:, :-1]), t[:, 1:])
            opt.zero_grad()
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            out[device] = (loss.item(), {n: p.detach().cpu() for n, p in
                                         m.named_parameters()})
            want = 2 if device == "cuda" else 0
            assert kernels.LAUNCHES == {
                "quantize_int8": 0, "dequantize_int8": 0,
                "flash_fwd": want, "flash_bwd_dq": want,
                "flash_bwd_dkv": want, **NEW_KERNELS}, device
    finally:
        hvd.shutdown()
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for name, p in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][name], p, rtol=1e-4,
                                   atol=1e-4, msg=name)


@pytest.mark.cuda
def test_reduce_kernels_match_plain_on_card():
    """K3 bitwise given the same thresholds; K8 within 1e-5 of the fp64
    sums (of each sum's scale) and symmetric in (a, b); K9 bitwise given
    the same scalars, symmetric, and a plain sum where a side is zero —
    one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(3)
    kernels.reset_launch_counts()
    sizes = [1, 4095, 4097, 9001, 300_000]
    calls = 0
    for n in sizes:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(n, generator=gen, device="cuda") * 3).to(dtype)
            u = torch.rand((kernels.stochastic_rows(n), 128), generator=gen,
                           device="cuda")
            q, s, _ = kernels.quantize_int8_stochastic(x, u)
            q0, s0, _ = kernels._quantize_stochastic_plain(x, u)
            a = torch.randn(n, generator=gen, device="cuda")
            b = (0.6 * a + torch.randn(n, generator=gen, device="cuda"))
            if n == 4097:
                b.zero_()
            a, b = a.to(dtype), b.to(dtype)
            dn = kernels.adasum_dot_norms(a, b)
            dn_swap = kernels.adasum_dot_norms(b, a)
            out = kernels.adasum_combine(a, b, dn)
            out_swap = kernels.adasum_combine(b, a, dn_swap)
            out0 = kernels._adasum_combine_plain(a, b, dn)
            torch.cuda.synchronize()
            calls += 1
            assert torch.equal(q, q0) and torch.equal(s, s0)
            a64, b64 = a.double(), b.double()
            exact = torch.stack([a64 @ b64, a64 @ a64, b64 @ b64])
            scale = torch.stack([(exact[1] * exact[2]).sqrt(), exact[1],
                                 exact[2]])
            assert ((dn.double() - exact).abs() <= 1e-5 * scale).all()
            assert torch.equal(dn[[0, 2, 1]], dn_swap)
            assert torch.equal(out, out0) and torch.equal(out, out_swap)
            if n == 4097:
                assert torch.equal(out, a)
    assert kernels.LAUNCHES == {
        "scale_buffer": 0, "quantize_int8": 0, "dequantize_int8": 0,
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "quantize_int8_stochastic": calls, "adasum_dot_norms": 2 * calls,
        "adasum_combine": 2 * calls}


@pytest.mark.cuda
def test_scale_kernel_matches_plain_on_card():
    """K1 bitwise equal to its plain version for every pair of fp32, bf16
    and fp16 in and out, at ragged sizes (around the streaming pass's
    whole trips too) and from an address one element off the 16-byte
    grid (the scalar path), with one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(5)
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    kernels.reset_launch_counts()
    calls = 0
    for n in (1, 7, 1024, 4095, 4097, 9001, 300_001, 5_000_003):
        base = torch.randn(n + 1, generator=gen, device="cuda") * 3
        for din in dtypes:
            for x in (base[:n].to(din), base.to(din)[1:]):
                for dout in dtypes:
                    for scale in (1 / 3, 0.7, 2.5):
                        got = kernels.scale_buffer(x, scale, dout)
                        want = kernels.scale_buffer_plain(x, scale, dout)
                        calls += 1
                        assert got.dtype == dout
                        assert torch.equal(got.view(-1), want.view(-1)), (
                            n, din, dout, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {
        "quantize_int8": 0, "dequantize_int8": 0, "flash_fwd": 0,
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0, **NEW_KERNELS,
        "scale_buffer": calls}


@pytest.mark.cuda
def test_init_refuses_nccl_for_ranks_sharing_a_gpu(monkeypatch):
    """Two local ranks and one GPU: ``init()`` and ``init(backend=
    "nccl")`` raise before NCCL is reached, naming ``backend="gloo"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HVD_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("HVD_TPU_NUM_PROC", "2")
    monkeypatch.setenv("HVD_TPU_PROC_ID", "0")
    monkeypatch.setenv("HVD_TPU_LOCAL_SIZE",
                       str(torch.cuda.device_count() + 1))
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match='backend="gloo"'):
            hvd.init(backend=backend)
        assert not hvd.is_initialized()


def _card_worker(rank: int, out_path: str) -> None:
    """One of two gloo ranks on the card (run as a script): one step of
    each reduction mode on a small GPT, with its launches and a digest of
    the parameters."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt

    ctx = hvd.init(backend="gloo")
    assert ctx.backend == "gloo" and ctx.device.type == "cuda"
    out = {}
    # The eager engine: pre/postscale through K1, once each.
    g = torch.randn(5000, generator=torch.Generator(device="cuda")
                    .manual_seed(rank), device="cuda")
    kernels.reset_launch_counts()
    h = hvd.allreduce_async(g, op=hvd.Sum, name="g", prescale_factor=1 / 3,
                            postscale_factor=1.5)
    y = hvd.synchronize(h)
    every = hvd.allgather(g[None])
    want = kernels.scale_buffer_plain(
        kernels.scale_buffer_plain(every[0], 1 / 3)
        + kernels.scale_buffer_plain(every[1], 1 / 3), 1.5)
    out["eager"] = {"launches": dict(kernels.LAUNCHES),
                    "equal": torch.equal(y, want)}
    for mode in ("int8_ef", "adasum"):
        m = gpt.gpt_tiny(hidden=128, num_heads=2).to("cuda")
        m.init_weights(torch.Generator(device="cuda").manual_seed(0))
        hvd.broadcast_parameters(m.state_dict(), root_rank=0)
        kw = {"compression": "int8_ef"} if mode == "int8_ef" \
            else {"op": hvd.Adasum}
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(m.parameters(), lr=1e-3),
            named_parameters=m.named_parameters(), **kw)
        toks = torch.randint(0, 128, (2, 65), generator=torch.Generator()
                             .manual_seed(rank)).to("cuda")
        kernels.reset_launch_counts()
        loss = gpt.next_token_loss(m(toks[:, :-1]), toks[:, 1:])
        opt.zero_grad()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        flat = torch.cat([p.detach().reshape(-1) for p in m.parameters()])
        every = [torch.empty_like(flat) for _ in range(2)]
        torch.distributed.all_gather(every, flat)
        out[mode] = {
            "launches": dict(kernels.LAUNCHES), "loss": loss.item(),
            "params": len(list(m.parameters())),
            "layers": m.num_layers,
            "int8_buckets": list(getattr(opt, "_dist_plan", None)
                                 .wire_dtypes).count("int8")
            if mode == "int8_ef" else 0,
            "replicas_equal": torch.equal(every[0], every[1])}
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.mark.cuda
def test_two_gloo_ranks_on_card_reduce_through_the_kernels(tmp_path):
    """Two processes share the card over gloo: an eager allreduce with
    pre/postscale launches K1 twice and gives the plain arithmetic's
    bits; one int8_ef step launches K3 twice per int8 bucket, one Adasum
    step launches K8 and K9 once per parameter, and both leave the two
    replicas bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, HVD_TPU_COORDINATOR=f"127.0.0.1:{port}",
               HVD_TPU_NUM_PROC="2",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--card-worker", str(r),
         str(tmp_path / f"rank{r}.json")],
        env=dict(env, HVD_TPU_PROC_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r]}"
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        eager = res.pop("eager")
        assert eager["equal"], r
        assert eager["launches"] == {
            "quantize_int8": 0, "dequantize_int8": 0, "flash_fwd": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, **NEW_KERNELS,
            "scale_buffer": 2}, r
        for mode, rec in res.items():
            flash = rec["layers"]
            want = {"quantize_int8": 0, "dequantize_int8": 0,
                    "flash_fwd": flash, "flash_bwd_dq": flash,
                    "flash_bwd_dkv": flash, **NEW_KERNELS}
            if mode == "int8_ef":
                assert rec["int8_buckets"] >= 1
                want["quantize_int8_stochastic"] = 2 * rec["int8_buckets"]
            else:
                want["adasum_dot_norms"] = rec["params"]
                want["adasum_combine"] = rec["params"]
            assert rec["launches"] == want, (r, mode)
            assert rec["replicas_equal"], (r, mode)


if __name__ == "__main__" and sys.argv[1:2] == ["--card-worker"]:
    _card_worker(int(sys.argv[2]), sys.argv[3])
