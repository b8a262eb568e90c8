"""The numpy boundary of the framework shims (``tensorflow``, ``keras``,
``mxnet``): a host array becomes a torch tensor on this process's
device, a collective's result comes back as a host array in the
caller's dtype."""

from __future__ import annotations

import numpy as np
import torch

from .basics import device


def to_torch(arr) -> torch.Tensor:
    """A host array as a torch tensor on :func:`~.basics.device`. A
    ``bfloat16`` array (``ml_dtypes``, TensorFlow's host form) is not
    taken by ``torch.from_numpy``: its bits ride an int16 view."""
    # A C-ordered copy that keeps a 0-d array 0-d (ascontiguousarray
    # would not): the collective must not write into the caller's array.
    arr = np.array(arr, order="C", copy=True)
    if arr.dtype.name == "bfloat16":
        arr = arr.view(np.int16)
        return torch.from_numpy(arr).view(torch.bfloat16).to(device())
    return torch.from_numpy(arr).to(device())


def to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    """A torch result as a host array of ``dtype`` (the input's: an
    integer AVERAGE, which the engine returns as floats, is cast
    back)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        out = t.view(torch.int16).numpy().view(dtype) \
            if np.dtype(dtype).name == "bfloat16" \
            else t.float().numpy()
    else:
        out = t.numpy()
    return out.astype(dtype, copy=False)
