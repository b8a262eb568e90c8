"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the int8 codec (K2/K4) and flash attention (K5/K6/K7), and the two
paths that run them. Every test here needs an NVIDIA GPU and skips with
a reason elsewhere. This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from horovod_tpu_torch.ops import kernels

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
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


@pytest.mark.cuda
def test_disagg_serving_on_card_runs_the_kernels():
    """The slice's path on the card: a disaggregated gpt_tiny cluster
    (fp32, seeded weights) hands every sequence over through the CUDA
    codec — 2 layers x (k, v) = 4 launches of each kernel per handoff —
    and gives the same greedy token streams as the same weights on the
    CPU, where the plain codec runs."""
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
        launches = 4 * rep["handoffs"] if device == "cuda" else 0
        assert kernels.LAUNCHES == {
            "quantize_int8": launches, "dequantize_int8": launches,
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert streams["cuda"] == streams["cpu"]


# (B, S, H, D), dtype, causal, key mask, nonzero dlse
FLASH_CASES = [
    ((8, 512, 16, 64), torch.bfloat16, True, False, False),
    ((8, 512, 16, 64), torch.float32, True, False, False),
    ((2, 256, 4, 64), torch.float32, False, True, False),
    ((2, 256, 4, 128), torch.float32, True, False, True),
    ((2, 200, 4, 64), torch.float32, True, True, True),
    ((2, 200, 4, 128), torch.bfloat16, False, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c[0]))
                         + f"-{str(c[1])[6:]}-causal{int(c[2])}"
                         f"-mask{int(c[3])}-dlse{int(c[4])}")
def test_flash_kernels_match_plain_on_card(case):
    """K5, K6 and K7 launched on the card against their plain versions on
    the same inputs — the training shape, fp32 and bf16, key mask, D =
    128, a ragged S and a nonzero lse cotangent — one counted launch of
    each per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape, dtype, causal, use_mask, use_dlse = case
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, s, h, _ = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
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
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert o.dtype == dtype and dq.dtype == dtype and lse.dtype == \
        torch.float32
    tol, gtol = FLASH_FWD_TOL[dtype], FLASH_GRAD_TOL[dtype]
    torch.testing.assert_close(o.float(), o0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse0, rtol=tol, atol=tol)
    for got, want in ((dq, dq0), (dk, dk0), (dv, dv0)):
        torch.testing.assert_close(got.float(), want.float(), rtol=gtol,
                                   atol=gtol)


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
                "flash_bwd_dkv": want}, device
    finally:
        hvd.shutdown()
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for name, p in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][name], p, rtol=1e-4,
                                   atol=1e-4, msg=name)
