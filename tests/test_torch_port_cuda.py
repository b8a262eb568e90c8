"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips with a reason
elsewhere. This file imports no JAX, so it also runs on a machine without
it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from horovod_tpu_torch.ops import kernels

SCALE_RTOL = 1e-6


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
    assert kernels.LAUNCHES == {"quantize_int8": 2 * len(shapes),
                                "dequantize_int8": 2 * len(shapes)}


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
        assert kernels.LAUNCHES == {"quantize_int8": launches,
                                    "dequantize_int8": launches}
    assert streams["cuda"] == streams["cpu"]
