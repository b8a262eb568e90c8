"""``horovod_tpu_torch`` — the PyTorch/CUDA port of ``horovod_tpu``.

The JAX package ``horovod_tpu`` is the frozen reference; this package
sits beside it and imports neither JAX nor anything of it. Plain tensor
code is PyTorch, and every TPU (Pallas) kernel on a ported path is a
kernel written by hand for NVIDIA Hopper under ``csrc/``, built with
``nvcc`` at first use.

Ported so far (slice 1): disaggregated GPT serving — ``serve`` (engine,
batcher, controller with prefill/decode roles, tracing, overload
control), ``models.gpt`` (the KV-cache path), and the int8 KV-wire codec
kernels ``ops.kernels.quantize_int8``/``dequantize_int8``.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.
"""

from .common.device import resolve_device
from .common.metrics import metrics

__all__ = ["metrics", "resolve_device"]
