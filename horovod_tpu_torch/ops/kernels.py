"""Hand-written Hopper kernels of the port and their plain versions.

K2 ``quantize_int8`` and K4 ``dequantize_int8`` are the block-scaled
int8 wire codec the serve plane's prefill -> decode handoff rides
(``serve/kvcache.py`` export/import). They keep the signatures and
return contracts of ``horovod_tpu/ops/pallas_kernels.py``
``quantize_int8``/``dequantize_int8``: one fp32 absmax scale per
4096-element block, round half to even, codes clipped to +-127, ``q``
laid out as ``(rows, 128)`` int8 with ``rows`` a multiple of 32.

Dispatch rule: a tensor on the CPU takes the plain PyTorch version
beside each kernel; a CUDA tensor launches the CUDA kernel from
``csrc/int8_codec.cu`` or raises. There is no fallback from a failed
launch to the plain version.

The kernel library is built with ``nvcc`` at first use into
``build/horovod_tpu_torch/`` beside the package (listed in
``.gitignore``) and loaded through ``ctypes``; the build is keyed by a
hash of the source and flags, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

_LANES = 128
_Q_ROWS = 32
BLOCK = _Q_ROWS * _LANES           # elements per scale

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "horovod_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Kernel launches per wrapper, counted where the kernel is launched and
#: nowhere else (the plain CPU path never counts). ``chip_smoke.py``
#: zeroes these before the main path and reads them after it.
LAUNCHES: Dict[str, int] = {"quantize_int8": 0, "dequantize_int8": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- build + load -------------------------------------------------------------

def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from csrc/ at first use")
    return found


def build_library(source: str = "int8_codec.cu") -> Path:
    """Compile one ``csrc`` source into a shared library (once per
    source/flags hash) and return its path. Safe under concurrent
    callers: each compiles to a private name and renames into place."""
    src = _CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}.{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library("int8_codec.cu")))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.hvd_quantize_int8.argtypes = [p, i, ll, p, p, ll, p]
            lib.hvd_quantize_int8.restype = i
            lib.hvd_dequantize_int8.argtypes = [p, p, ll, ll, p, i, p]
            lib.hvd_dequantize_int8.restype = i
            _lib = lib
    return _lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {err})")


# -- shapes ---------------------------------------------------------------------

def _rows(n: int) -> int:
    """Row count of the (rows, 128) int8 layout: whole 32-row blocks."""
    rows = -(-n // _LANES)
    return -(-rows // _Q_ROWS) * _Q_ROWS


def _check_float(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")


# -- K2: quantize_int8 ------------------------------------------------------------

def _quantize_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                               int]:
    """Plain PyTorch K2: the JAX fallback's arithmetic, op for op."""
    n = x.numel()
    rows = _rows(n)
    flat = torch.zeros(rows * _LANES, dtype=torch.float32, device=x.device)
    flat[:n] = x.reshape(-1).to(torch.float32)
    blocks = flat.reshape(rows // _Q_ROWS, BLOCK)
    absmax = torch.clamp(blocks.abs().amax(dim=1), min=1e-30)
    # A tensor divisor, not the Python scalar: on a CUDA tensor PyTorch
    # turns division by a scalar into multiplication by its reciprocal,
    # which is 1 ulp off the IEEE quotient the kernel and the JAX
    # fallback compute for some blocks.
    scales = absmax / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127)
    return q.to(torch.int8).reshape(rows, _LANES), scales, n


def quantize_int8(x: torch.Tensor):
    """Block-scaled int8 quantization. Returns ``(q, scales, n)``: ``q``
    is (rows, 128) int8 (zero codes past ``n``), ``scales`` one fp32
    scale per 4096-element block, ``n`` the element count."""
    _check_float(x, "quantize_int8")
    if x.device.type == "cpu":
        return _quantize_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8: input must be contiguous")
    n = x.numel()
    rows = _rows(n)
    nblocks = rows // _Q_ROWS
    q = torch.empty((rows, _LANES), dtype=torch.int8, device=x.device)
    scales = torch.empty((nblocks,), dtype=torch.float32, device=x.device)
    err = _load().hvd_quantize_int8(
        x.data_ptr(), _DTYPE_CODE[x.dtype], n, q.data_ptr(),
        scales.data_ptr(), nblocks, _stream(x))
    _check_launch("quantize_int8", err)
    if nblocks:
        LAUNCHES["quantize_int8"] += 1
    return q, scales, n


# -- K4: dequantize_int8 ----------------------------------------------------------

def _dequantize_plain(q: torch.Tensor, scales: torch.Tensor, n: int,
                      shape, dtype) -> torch.Tensor:
    """Plain PyTorch K4: the JAX fallback's arithmetic, op for op."""
    nblocks = q.shape[0] // _Q_ROWS
    blocks = q.reshape(nblocks, BLOCK).to(torch.float32)
    out = (blocks * scales[:, None]).to(dtype)
    return out.reshape(-1)[:n].reshape(shape)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, n: int, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: the first ``n`` values, scaled
    back, cast to ``dtype`` and shaped ``shape``."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dequantize_int8: output dtype {dtype} not "
                        "supported (float32 or bfloat16)")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("dequantize_int8: needs int8 codes and float32 "
                        f"scales, got {q.dtype} / {scales.dtype}")
    n = int(n)
    shape = tuple(int(d) for d in shape)
    numel = 1
    for d in shape:
        numel *= d
    nblocks = -(-n // BLOCK)
    if numel != n or q.numel() < nblocks * BLOCK \
            or scales.numel() < nblocks:
        raise ValueError(
            f"dequantize_int8: shape {shape} / n {n} do not fit codes "
            f"{tuple(q.shape)} and {scales.numel()} scales")
    if q.device.type == "cpu":
        return _dequantize_plain(q, scales, n, shape, dtype)
    if q.device.type != "cuda" or scales.device != q.device:
        raise ValueError("dequantize_int8: codes and scales must be on "
                         f"one CUDA device, got {q.device} / "
                         f"{scales.device}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_int8: inputs must be contiguous")
    out = torch.empty(shape, dtype=dtype, device=q.device)
    err = _load().hvd_dequantize_int8(
        q.data_ptr(), scales.data_ptr(), n, nblocks, out.data_ptr(),
        _DTYPE_CODE[dtype], _stream(q))
    _check_launch("dequantize_int8", err)
    if nblocks:
        LAUNCHES["dequantize_int8"] += 1
    return out
