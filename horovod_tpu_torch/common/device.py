"""The device rule of the port's entry points.

Entry points default to the GPU. They run on the CPU only when the
caller asks for it (``device="cpu"``, as the tests do), and with no GPU
and no explicit CPU request they raise instead of falling back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.
    Raises when a CUDA device is asked for (or implied) and none is
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU "
            "unless the caller passes device='cpu' explicitly")
    return dev
