"""Hand-written Hopper kernels of the port and their plain versions.

K1 ``scale_buffer`` is the pre/postscale pass of the eager collective
engine (``collectives._apply_scale``): ``cast_out(float(x) * s)`` with one
fp32 multiply and one rounding, fp32/bf16/fp16 in and out. It keeps
``horovod_tpu/ops/pallas_kernels.py`` ``scale_buffer``'s contract: the
scale is taken in fp32 as given; ``_apply_scale`` rounds it to the
tensor's dtype first.

K2 ``quantize_int8`` and K4 ``dequantize_int8`` are the block-scaled
int8 wire codec the serve plane's prefill -> decode handoff rides
(``serve/kvcache.py`` export/import). They keep the signatures and
return contracts of ``horovod_tpu/ops/pallas_kernels.py``
``quantize_int8``/``dequantize_int8``: one fp32 absmax scale per
4096-element block, round half to even, codes clipped to +-127, ``q``
laid out as ``(rows, 128)`` int8 with ``rows`` a multiple of 32. The
handoff codes all of a slot's leaves in one launch a side:
:func:`quantize_int8_group` (codes and scales of every leaf as views of
one buffer each) and :func:`dequantize_int8_into` (straight into the
caller's tensors, the cache slots); the per-leaf functions are groups of
one through the same C entry points.

K3 ``quantize_int8_stochastic`` is K2 with unbiased stochastic rounding,
the quantizer of the int8 gradient wire (``collectives.
quantized_allreduce``): the same block scale, then ``floor(x/s) + (u <
frac)`` against fp32 thresholds ``u`` that the caller draws outside the
kernel, so kernel and plain version agree bit for bit given the same
``u``.

K8 ``adasum_dot_norms`` and K9 ``adasum_combine`` are the two passes of
the pairwise Adasum combine (``ops/adasum.py``): ``[a.b, |a|^2, |b|^2]``
in fp32, then ``a * ca + b * cb`` with the coefficients derived from
those three scalars in the kernel. Both are symmetric in (a, b) to the
bit, so the two partners of an Adasum pair hold equal results.

K5 ``flash_fwd``, K6 ``flash_bwd_dq`` and K7 ``flash_bwd_dkv`` are the
flash-attention forward and backward of the training path
(``ops/flash_attention.py`` wraps them in a ``torch.autograd.Function``).
They compute what ``horovod_tpu/ops/flash_attention.py``'s
``_fwd_kernel``/``_dq_kernel``/``_dkv_kernel`` compute, on q, k, v laid
out ``(B, S, H, D)``: logits scaled by ``1/sqrt(D)``, keys the key mask
hides at -1e30, keys after the query (causal) and past a ragged ``S``
left out, fp32 softmax, ``lse`` ``(B, H, S)`` fp32, and the backward's
``ds = p * (dp - delta + dlse)``. The head dimension is 64 or 128. At
the training shape they are bound by bytes (10.1, 12.7 and 15.2 us at
3.35 TB/s). One C entry point takes two routes by dtype. bf16 K5, K6
and K7 are Hopper kernels: ``wgmma`` products on 64 x 64 tiles that TMA
lands in swizzled shared memory through a 2-stage ring, with P and dS
rounded to bf16 before the products that take them (the one numeric
difference from the JAX kernels, inside the bf16 tolerance); their
wrappers hand them q, k, v (and do) whose base and strides are
multiples of 16 bytes (:func:`tma_layout_ok`), copying any other once.
fp32 stays on the CUDA-core kernels: fp32 FMAs, since TF32 could not
meet the fp32 tolerances. :func:`flash_bwd`, the training path's
backward, launches K6 and then K7 in one C call.
``csrc/flash_attention.cu``'s header has the design and the compiler's
registers and shared memory.

Dispatch rule: a tensor on the CPU takes the plain PyTorch version
beside each kernel; a CUDA tensor launches the CUDA kernel from
``csrc/`` on the tensor's own device (:func:`_launch`) or raises. There
is no fallback from a failed build or launch to the plain version.

Each ``csrc`` source is built with ``nvcc`` at first use into its own
shared library under ``build/horovod_tpu_torch/`` beside the package
(listed in ``.gitignore``) and loaded through ``ctypes``; the build is
keyed by a hash of the source and flags, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import struct
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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
LAUNCHES: Dict[str, int] = {"scale_buffer": 0, "quantize_int8": 0,
                            "dequantize_int8": 0,
                            "quantize_int8_stochastic": 0,
                            "flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0, "adasum_dot_norms": 0,
                            "adasum_combine": 0}
#: Leaves coded by the K2/K4 launches counted in :data:`LAUNCHES` (a
#: grouped launch codes many).
CODEC_LEAVES: Dict[str, int] = {"quantize_int8": 0, "dequantize_int8": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SCALE_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
#: ctypes signature (argtypes, restype) of every C entry point, by source.
_SIGNATURES = {
    "scale_buffer.cu": {
        "hvd_scale_buffer": ([_P, _I, _P, _I, _LL, _F, _P], _I),
    },
    "int8_codec.cu": {
        "hvd_quantize_int8_group": ([_P, _I, _LL, _P], _I),
        "hvd_dequantize_int8_group": ([_P, _I, _LL, _P], _I),
        "hvd_quantize_int8_stochastic": ([_P, _I, _LL, _P, _P, _P, _LL, _P],
                                         _I),
    },
    "flash_attention.cu": {
        "hvd_flash_attention": ([_I] * 7 + [_F] + [_P] * 14, _I),
    },
    "adasum.cu": {
        "hvd_adasum_dot_norms": ([_P, _P, _I, _LL, _P, _I, _P, _P], _I),
        "hvd_adasum_combine": ([_P, _P, _I, _LL, _P, _F, _P, _P], _I),
    },
}
SOURCES: Tuple[str, ...] = tuple(_SIGNATURES)

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, CODEC_LEAVES):
        for name in counts:
            counts[name] = 0


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


def build_all() -> List[Path]:
    """Build every ``csrc`` source at once, one ``nvcc`` per source
    running side by side; returns the libraries in :data:`SOURCES`
    order. Raises on the first failed build."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return list(pool.map(build_library, SOURCES))


def _load(source: str) -> ctypes.CDLL:
    with _lib_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(source)))
            for fn, (argtypes, restype) in _SIGNATURES[source].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[source] = lib
    return lib


def _launch(name: str, t: torch.Tensor, source: str, fn: str,
            *args) -> None:
    """Call C entry point ``fn`` of ``source`` with ``args`` and, last,
    the current stream of ``t``'s device, under a ``torch.cuda.device``
    guard on that device: the C side launches on the current device and
    keeps its per-device state (the shared-memory opt-in) by it. Raises
    if the launch failed. Every kernel launch of this module goes through
    here."""
    entry = getattr(_load(source), fn)
    with torch.cuda.device(t.device):
        err = entry(*args, torch.cuda.current_stream(t.device).cuda_stream)
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


# -- K1: scale_buffer -------------------------------------------------------------

def scale_buffer_plain(x: torch.Tensor, scale: float,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Plain PyTorch K1: an fp32 product with the scale in fp32, cast
    once to ``out_dtype`` (the JAX fallback's arithmetic)."""
    out_dtype = out_dtype or x.dtype
    return (x.float() * torch.tensor(scale, dtype=torch.float32)
            ).to(out_dtype)


def scale_buffer(x: torch.Tensor, scale: float,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K1: ``cast_out(float(x) * scale)`` in x's shape, ``scale`` taken in
    fp32 as given; x and ``out_dtype`` (default x's) are each fp32, bf16
    or fp16."""
    out_dtype = out_dtype or x.dtype
    for dt, what in ((x.dtype, "input"), (out_dtype, "output")):
        if dt not in _SCALE_DTYPE_CODE:
            raise TypeError(f"scale_buffer: {what} dtype {dt} not supported "
                            "(float32, bfloat16 or float16)")
    if x.device.type == "cpu":
        return scale_buffer_plain(x, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"scale_buffer: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("scale_buffer: input must be contiguous")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    n = x.numel()
    _launch("scale_buffer", x, "scale_buffer.cu", "hvd_scale_buffer",
            x.data_ptr(), _SCALE_DTYPE_CODE[x.dtype], out.data_ptr(),
            _SCALE_DTYPE_CODE[out_dtype], n, float(scale))
    if n:
        LAUNCHES["scale_buffer"] += 1
    return out


# -- K2: quantize_int8 ------------------------------------------------------------

def _blocks_and_scales(x: torch.Tensor):
    """``x`` as zero-padded fp32 (nblocks, 4096) blocks and their scales
    ``max(absmax, 1e-30) / 127`` — the JAX fallback's arithmetic."""
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
    return blocks, absmax / torch.full_like(absmax, 127.0)


def _quantize_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                               int]:
    """Plain PyTorch K2: the JAX fallback's arithmetic, op for op."""
    blocks, scales = _blocks_and_scales(x)
    q = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1, _LANES), scales, x.numel()


def quantize_int8(x: torch.Tensor):
    """Block-scaled int8 quantization. Returns ``(q, scales, n)``: ``q``
    is (rows, 128) int8 (zero codes past ``n``), ``scales`` one fp32
    scale per 4096-element block, ``n`` the element count. A group of
    one of :func:`quantize_int8_group`."""
    _check_float(x, "quantize_int8")
    return quantize_int8_group([x])[0]


# -- K3: quantize_int8_stochastic -----------------------------------------

def _quantize_stochastic_plain(x: torch.Tensor, u: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Plain PyTorch K3: the JAX fallback's arithmetic, op for op."""
    blocks, scales = _blocks_and_scales(x)
    scaled = blocks / scales[:, None]
    fl = torch.floor(scaled)
    q = fl + (u.reshape(blocks.shape) < (scaled - fl)).to(torch.float32)
    q = torch.clamp(q, -127, 127)
    return q.to(torch.int8).reshape(-1, _LANES), scales, x.numel()


def stochastic_rows(n: int) -> int:
    """Rows of the ``(rows, 128)`` fp32 thresholds ``u`` that
    :func:`quantize_int8_stochastic` takes for ``n`` elements."""
    return _rows(n)


def quantize_int8_stochastic(x: torch.Tensor, u: torch.Tensor):
    """Block-scaled int8 quantization with unbiased stochastic rounding.
    ``u`` holds one fp32 threshold in [0, 1) per element of the padded
    layout, shape ``(stochastic_rows(n), 128)``, on ``x``'s device: an
    element rounds up where ``u`` is below its fractional part. Returns
    ``(q, scales, n)`` as :func:`quantize_int8` does."""
    _check_float(x, "quantize_int8_stochastic")
    n = x.numel()
    rows = _rows(n)
    if u.dtype != torch.float32 or u.numel() != rows * _LANES:
        raise ValueError(f"quantize_int8_stochastic: u must be float32 with "
                         f"{rows} x {_LANES} elements, got {u.dtype} "
                         f"{tuple(u.shape)}")
    if x.device.type == "cpu" and u.device.type == "cpu":
        return _quantize_stochastic_plain(x, u)
    if x.device.type != "cuda" or u.device != x.device:
        raise ValueError("quantize_int8_stochastic: x and u must be on one "
                         f"CUDA device (or both on the CPU), got {x.device} "
                         f"/ {u.device}")
    if not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("quantize_int8_stochastic: inputs must be "
                         "contiguous")
    nblocks = rows // _Q_ROWS
    q = torch.empty((rows, _LANES), dtype=torch.int8, device=x.device)
    scales = torch.empty((nblocks,), dtype=torch.float32, device=x.device)
    _launch("quantize_int8_stochastic", x, "int8_codec.cu",
            "hvd_quantize_int8_stochastic", x.data_ptr(),
            _DTYPE_CODE[x.dtype], n, u.data_ptr(), q.data_ptr(),
            scales.data_ptr(), nblocks)
    if nblocks:
        LAUNCHES["quantize_int8_stochastic"] += 1
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
    back, cast to ``dtype`` and shaped ``shape``. A group of one of
    :func:`dequantize_int8_into` into a new tensor."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dequantize_int8: output dtype {dtype} not "
                        "supported (float32 or bfloat16)")
    n = int(n)
    shape = tuple(int(d) for d in shape)
    if math.prod(shape) != n:
        raise ValueError(f"dequantize_int8: shape {shape} does not hold "
                         f"n = {n} values")
    out = torch.empty(shape, dtype=dtype, device=q.device)
    dequantize_int8_into([(q, scales, n)], [out])
    return out


# -- K2/K4 grouped: one launch codes up to 64 leaves -------------------------

_GROUP_LEAVES = 64              # table entries a launch (csrc kMaxLeaves)
#: One table entry of a grouped K2/K4 launch, ``CodecLeaf`` of
#: ``csrc/int8_codec.cu`` (48 bytes, no padding): ``src``, ``dst``,
#: ``scales`` (device pointers; K2 reads ``src`` and writes the codes to
#: ``dst``, K4 reads the codes from ``src`` and writes ``dst``), ``n``,
#: ``first`` (the leaf's first block in the launch's grid), ``dtype`` (of
#: K2's input or K4's output) and ``vec`` (1 where both ``src`` and
#: ``dst`` are 16-byte aligned, else the kernel's scalar path).
_LEAF = struct.Struct("=QQQqqii")


def _codec_tables(leaves):
    """Cut ``(src, dst, scales, n, dtype)`` records of leaves with
    ``n > 0`` into launches of at most 64 leaves; yields ``(table,
    nleaves, blocks)``: the packed entries, ``first`` a prefix sum of
    block counts from 0 in each launch."""
    for start in range(0, len(leaves), _GROUP_LEAVES):
        chunk = leaves[start:start + _GROUP_LEAVES]
        entries, blocks = [], 0
        for src, dst, scales, n, dtype in chunk:
            entries.append(_LEAF.pack(src, dst, scales, n, blocks, dtype,
                                      int(src % 16 == 0 and dst % 16 == 0)))
            blocks += -(-n // BLOCK)
        yield b"".join(entries), len(chunk), blocks


def _group_device(what: str, tensors) -> torch.device:
    """The one device of ``tensors``: the CPU, or a CUDA device on which
    every tensor is contiguous; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on more than one device "
                         f"{sorted(str(d) for d in devices)}")
    dev = devices.pop()
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")
    return dev


def quantize_int8_group(xs) -> List[Tuple[torch.Tensor, torch.Tensor, int]]:
    """K2 over a group of fp32/bf16 tensors, one launch per 64 of them:
    ``[(q, scales, n), ...]`` in ``xs`` order, each as
    :func:`quantize_int8` returns it. On the card every ``q`` is a view
    of one code buffer (each leaf's codes start at a multiple of 4096
    bytes) and every ``scales`` a view of one scale buffer."""
    xs = list(xs)
    for x in xs:
        _check_float(x, "quantize_int8_group")
    if not xs:
        return []
    dev = _group_device("quantize_int8_group", xs)
    if dev.type == "cpu":
        return [_quantize_plain(x) for x in xs]
    ns = [x.nelement() for x in xs]
    nblocks = [-(-n // BLOCK) for n in ns]
    total = sum(nblocks)
    codes = torch.empty((total * _Q_ROWS, _LANES), dtype=torch.int8,
                        device=dev)
    scales = torch.empty((total,), dtype=torch.float32, device=dev)
    q_base, s_base = codes.data_ptr(), scales.data_ptr()
    leaves, first = [], 0
    for x, n, nb in zip(xs, ns, nblocks):
        if nb:
            leaves.append((x.data_ptr(), q_base + first * BLOCK,
                           s_base + first * 4, n, _DTYPE_CODE[x.dtype]))
        first += nb
    for table, nleaves, blocks in _codec_tables(leaves):
        _launch("quantize_int8", xs[0], "int8_codec.cu",
                "hvd_quantize_int8_group", table, nleaves, blocks)
        LAUNCHES["quantize_int8"] += 1
        CODEC_LEAVES["quantize_int8"] += nleaves
    return list(zip(codes.split([nb * _Q_ROWS for nb in nblocks]),
                    scales.split(nblocks), ns))


def dequantize_int8_into(items, outs) -> None:
    """K4 over a group, one launch per 64 leaves: ``items[i] = (q,
    scales, n)`` as :func:`quantize_int8` returns it is dequantized in
    place into ``outs[i]``, an fp32 or bf16 tensor of ``n`` elements in
    any shape (contiguous on the card), such as a cache slot."""
    items, outs = list(items), list(outs)
    if len(items) != len(outs):
        raise ValueError(f"dequantize_int8_into: {len(items)} items but "
                         f"{len(outs)} outputs")
    tensors = []
    for (q, scales, n), out in zip(items, outs):
        if out.dtype not in _DTYPE_CODE:
            raise TypeError(f"dequantize_int8_into: output dtype "
                            f"{out.dtype} not supported (float32 or "
                            "bfloat16)")
        if q.dtype != torch.int8 or scales.dtype != torch.float32:
            raise TypeError("dequantize_int8_into: needs int8 codes and "
                            f"float32 scales, got {q.dtype} / "
                            f"{scales.dtype}")
        nblocks = -(-int(n) // BLOCK)
        if out.nelement() != n or q.nelement() < nblocks * BLOCK \
                or scales.nelement() < nblocks:
            raise ValueError(
                f"dequantize_int8_into: an output of {out.nelement()} "
                f"elements / n {n} do not fit codes {tuple(q.shape)} and "
                f"{scales.nelement()} scales")
        tensors += (q, scales, out)
    if not items:
        return
    dev = _group_device("dequantize_int8_into", tensors)
    if dev.type == "cpu":
        for (q, scales, n), out in zip(items, outs):
            out.copy_(_dequantize_plain(q, scales, n, out.shape,
                                        out.dtype))
        return
    leaves = [(q.data_ptr(), out.data_ptr(), scales.data_ptr(), int(n),
               _DTYPE_CODE[out.dtype])
              for (q, scales, n), out in zip(items, outs) if n]
    for table, nleaves, blocks in _codec_tables(leaves):
        _launch("dequantize_int8", outs[0], "int8_codec.cu",
                "hvd_dequantize_int8_group", table, nleaves, blocks)
        LAUNCHES["dequantize_int8"] += 1
        CODEC_LEAVES["dequantize_int8"] += nleaves


# -- K8/K9: the Adasum combine ------------------------------------------------

ADASUM_EPS = 1e-30
_DOT_NORMS_MAX_PARTS = 1024         # CTAs of K8's first pass, at most


def _dot_norms_parts(n: int) -> int:
    """CTAs of K8's first pass: a function of ``n`` alone, so the sum's
    order (and its bits) never depend on anything else."""
    return max(1, min(-(-n // (256 * 16)), _DOT_NORMS_MAX_PARTS))


def _check_pair(what: str, a: torch.Tensor, b: torch.Tensor) -> str:
    """Dtype, shape and device checks of K8/K9; returns ``"cpu"`` or
    ``"cuda"``."""
    _check_float(a, what)
    if b.dtype != a.dtype:
        raise TypeError(f"{what}: a and b dtypes differ ({a.dtype}, "
                        f"{b.dtype})")
    if a.shape != b.shape:
        raise ValueError(f"{what}: a and b shapes differ "
                         f"({tuple(a.shape)}, {tuple(b.shape)})")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return "cpu"
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{what}: a and b must be on one CUDA device (or "
                         f"both on the CPU), got {a.device} / {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    return "cuda"


def _adasum_dot_norms_plain(a: torch.Tensor, b: torch.Tensor
                            ) -> torch.Tensor:
    """Plain PyTorch K8: three fp32 dot products."""
    af = a.reshape(-1).to(torch.float32)
    bf = b.reshape(-1).to(torch.float32)
    return torch.stack([torch.dot(af, bf), torch.dot(af, af),
                        torch.dot(bf, bf)])


def adasum_dot_norms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K8: ``[a.b, |a|^2, |b|^2]`` as a (3,) fp32 tensor on a's device,
    summed in fp32 in an order fixed by the element count."""
    if _check_pair("adasum_dot_norms", a, b) == "cpu":
        return _adasum_dot_norms_plain(a, b)
    n = a.numel()
    out = torch.zeros((3,), dtype=torch.float32, device=a.device)
    if n == 0:
        return out
    parts = _dot_norms_parts(n)
    scratch = torch.empty((3 * parts,), dtype=torch.float32,
                          device=a.device)
    _launch("adasum_dot_norms", a, "adasum.cu", "hvd_adasum_dot_norms",
            a.data_ptr(), b.data_ptr(), _DTYPE_CODE[a.dtype], n,
            scratch.data_ptr(), parts, out.data_ptr())
    LAUNCHES["adasum_dot_norms"] += 1
    return out


def _adasum_coefficient(dot: torch.Tensor, nrm2: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """``1 - dot / max(2 |x|^2, eps)``, or 1 where ``|x|^2 = 0``."""
    return torch.where(nrm2 > 0, 1.0 - dot / torch.clamp(2.0 * nrm2,
                                                         min=eps),
                       torch.ones_like(nrm2))


def _adasum_combine_plain(a: torch.Tensor, b: torch.Tensor,
                          dn: torch.Tensor, eps: float = ADASUM_EPS
                          ) -> torch.Tensor:
    """Plain PyTorch K9: the coefficients, then ``a * ca``, ``b * cb``
    and their sum as three separate fp32 ops, cast to a's dtype."""
    dn = dn.to(torch.float32)
    ca = _adasum_coefficient(dn[0], dn[1], eps)
    cb = _adasum_coefficient(dn[0], dn[2], eps)
    out = a.to(torch.float32) * ca + b.to(torch.float32) * cb
    return out.to(a.dtype)


def adasum_combine(a: torch.Tensor, b: torch.Tensor, dn: torch.Tensor,
                   eps: float = ADASUM_EPS) -> torch.Tensor:
    """K9: ``a * ca + b * cb`` in a's dtype and shape, with ``ca = 1 -
    dot / max(2 |a|^2, eps)`` (1 when ``|a|^2 = 0``) and ``cb`` the same
    with ``|b|^2``; ``dn`` is K8's ``[a.b, |a|^2, |b|^2]``."""
    if _check_pair("adasum_combine", a, b) == "cpu":
        if dn.device.type != "cpu":
            raise ValueError("adasum_combine: dn must be on the CPU with "
                             "a and b")
        return _adasum_combine_plain(a, b, dn, eps)
    if dn.numel() != 3 or dn.device != a.device:
        raise ValueError(f"adasum_combine: dn must hold 3 values on "
                         f"{a.device}, got {tuple(dn.shape)} on {dn.device}")
    dn = dn.to(torch.float32).contiguous()
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    n = a.numel()
    if n == 0:
        return out
    _launch("adasum_combine", a, "adasum.cu", "hvd_adasum_combine",
            a.data_ptr(), b.data_ptr(), _DTYPE_CODE[a.dtype], n,
            dn.data_ptr(), eps, out.data_ptr())
    LAUNCHES["adasum_combine"] += 1
    return out


# -- K5/K6/K7: flash attention ------------------------------------------------

MASK_VALUE = -1e30          # a masked logit (not -inf: a fully masked row
                            # averages its keys instead of producing NaN)
FLASH_HEAD_DIMS = (64, 128)
_FWD, _DQ, _DKV, _BWD = 0, 1, 2, 3


def _masked_logits(q: torch.Tensor, k: torch.Tensor,
                   mask: Optional[torch.Tensor], causal: bool
                   ) -> torch.Tensor:
    """(B, H, Sq, Sk) fp32 logits of ``(q * scale) . k``: -1e30 where the
    key mask is 0, -inf after the query when ``causal`` (such a key never
    contributes)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale,
                     k.to(torch.float32))
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s,
                        torch.full_like(s, MASK_VALUE))
    if causal:
        n = s.shape[-1]
        after = torch.ones((n, n), dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill(after, float("-inf"))
    return s


def _flash_fwd_plain(q, k, v, mask=None, causal=False):
    """Plain PyTorch K5: the JAX kernel's math without blocking. Returns
    ``(o in q's dtype, lse (B, H, S) fp32)``."""
    s = _masked_logits(q, k, mask, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _flash_probs(q, k, v, mask, causal, do, lse, delta, dlse):
    """``p = exp(s - lse)`` and ``ds = p * (dp - delta + dlse)``, fp32
    (B, H, Sq, Sk), as the JAX backward kernels form them."""
    p = torch.exp(_masked_logits(q, k, mask, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(torch.float32),
                      v.to(torch.float32))
    shift = -delta if dlse is None else dlse - delta
    return p, p * (dp + shift[..., None])


def _flash_bwd_dq_plain(q, k, v, mask, causal, do, lse, delta, dlse=None):
    """Plain PyTorch K6: ``dq = ds . k * scale`` in q's dtype."""
    _, ds = _flash_probs(q, k, v, mask, causal, do, lse, delta, dlse)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(torch.float32)) * scale
    return dq.to(q.dtype)


def _flash_bwd_dkv_plain(q, k, v, mask, causal, do, lse, delta, dlse=None):
    """Plain PyTorch K7: ``dk = ds^T . q * scale``, ``dv = p^T . do``."""
    p, ds = _flash_probs(q, k, v, mask, causal, do, lse, delta, dlse)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(torch.float32)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do * o)`` (B, H, S) fp32, from ``o`` as saved —
    plain PyTorch on every device, as the JAX package keeps it plain
    jnp beside its backward kernels. An fp32 product and a row sum: on
    the card the einsum form, which PyTorch runs as a batched matmul
    over copies, was the slower one."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(-1).transpose(
        1, 2)


def _flash_bwd_plain(q, k, v, mask, causal, o, lse, do, dlse=None):
    """Plain PyTorch K6 + K7: ``(dq, dk, dv)`` from the forward's saved
    ``o`` and ``lse`` and the cotangents ``do`` and ``dlse``."""
    delta = flash_delta(o, do)
    dq = _flash_bwd_dq_plain(q, k, v, mask, causal, do, lse, delta, dlse)
    dk, dv = _flash_bwd_dkv_plain(q, k, v, mask, causal, do, lse, delta,
                                  dlse)
    return dq, dk, dv


def _check_attention(what: str, q, k, v, mask, *rest, do=None) -> str:
    """Shapes and dtypes every flash wrapper checks (``do``, where the
    backward takes it, is read through q's shape and dtype); returns the
    device type (``"cpu"`` or ``"cuda"``)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one (B, S, H, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_float(q, what)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    if do is not None:
        if do.shape != q.shape:
            raise ValueError(f"{what}: do must have q's shape "
                             f"{tuple(q.shape)}, got {tuple(do.shape)}")
        if do.dtype != q.dtype:
            raise TypeError(f"{what}: do must have q's dtype {q.dtype}, "
                            f"got {do.dtype}")
        rest = (do, *rest)
    b, s = q.shape[:2]
    if mask is not None and tuple(mask.shape) != (b, s):
        raise ValueError(f"{what}: key mask must be (B, S) = {(b, s)}, "
                         f"got {tuple(mask.shape)}")
    tensors = [t for t in (q, k, v, mask, *rest) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return "cpu"
    if any(t.device != q.device for t in tensors) \
            or q.device.type != "cuda":
        raise ValueError(f"{what}: all tensors must be on one CUDA device "
                         f"(or all on the CPU), got "
                         f"{sorted({str(t.device) for t in tensors})}")
    d = q.shape[-1]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"{what}: the CUDA kernel takes head_dim in "
                         f"{FLASH_HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(
            (f"input {i}", t) for i, t in enumerate(rest)
            if t is not None and t.dim() == 4):
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last "
                             "(head) dimension")
    return "cuda"


def _f32(t: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    """An fp32 contiguous side input (mask, lse, delta, dlse) of the
    given shape, or None."""
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash attention: side input of shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    return t.to(torch.float32).contiguous()


def tma_layout_ok(shape, strides, elem_size: int, data_ptr: int) -> bool:
    """Whether the bf16 K5/K7 can read a ``(B, S, H, D)`` tensor in place
    through a TMA map: the head dimension contiguous, the base address
    and the stride of every other dimension longer than 1 whole multiples
    of 16 bytes. The fused QKV projection's ``split`` views pass."""
    if strides[-1] != 1 or data_ptr % 16:
        return False
    return all(n == 1 or st * elem_size % 16 == 0
               for n, st in zip(shape[:-1], strides[:-1]))


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where :func:`tma_layout_ok`, else one contiguous copy
    (the kernel still reads it; there is no plain path)."""
    if tma_layout_ok(tuple(t.shape), t.stride(), t.element_size(),
                     t.data_ptr()):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bsh_strides(t: torch.Tensor) -> List[int]:
    """Element strides of (b, s, h); a dimension of length 1 gets the
    dense stride, since no kernel steps along it and a TMA map takes no
    stride that is not a multiple of 16 bytes."""
    _, s, h, d = t.shape
    dense = (s * h * d, h * d, d)
    return [dense[i] if t.shape[i] == 1 else t.stride(i) for i in range(3)]


def _launch_flash(which: int, names: Tuple[str, ...], q, k, v, mask,
                  causal, *, do=None, lse=None, delta=None, dlse=None,
                  out=None, out2=None, out3=None, lse_out=None) -> None:
    b, s, h, d = q.shape
    strides: List[int] = []
    for t in (q, k, v, do if do is not None else q):
        strides += _bsh_strides(t)
    strides_arr = (ctypes.c_longlong * 12)(*strides)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _launch("+".join(names), q, "flash_attention.cu", "hvd_flash_attention",
            which, _DTYPE_CODE[q.dtype], b, s, h, d, int(bool(causal)),
            1.0 / math.sqrt(d), ptr(q), ptr(k), ptr(v), ptr(do), ptr(mask),
            ptr(lse), ptr(delta), ptr(dlse), ptr(out), ptr(out2), ptr(out3),
            ptr(lse_out), strides_arr)
    if q.numel():
        for name in names:
            LAUNCHES[name] += 1


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, causal: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: attention forward. Returns ``(o (B, S, H, D) in q's dtype,
    lse (B, H, S) fp32)``. ``mask`` is an optional (B, S) key mask,
    1 = attend."""
    if _check_attention("flash_fwd", q, k, v, mask) == "cpu":
        return _flash_fwd_plain(q, k, v, mask, causal)
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_operand(t) for t in (q, k, v))
    b, s, h, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch_flash(_FWD, ("flash_fwd",), q, k, v, _f32(mask, (b, s)),
                  causal, out=o, lse_out=lse)
    return o, lse


def flash_bwd_dq(q, k, v, mask, causal, do, lse, delta, dlse=None
                 ) -> torch.Tensor:
    """K6: ``dq`` in q's dtype. ``lse``, ``delta`` and ``dlse`` are
    (B, H, S) fp32; ``dlse=None`` is a zero cotangent."""
    if _check_attention("flash_bwd_dq", q, k, v, mask, lse, delta, dlse,
                        do=do) == "cpu":
        return _flash_bwd_dq_plain(q, k, v, mask, causal, do, lse, delta,
                                   dlse)
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_tma_operand(t) for t in (q, k, v, do))
    b, s, h, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_flash(_DQ, ("flash_bwd_dq",), q, k, v, _f32(mask, (b, s)),
                  causal, do=do, lse=_f32(lse, (b, h, s)),
                  delta=_f32(delta, (b, h, s)), dlse=_f32(dlse, (b, h, s)),
                  out=dq)
    return dq


def flash_bwd_dkv(q, k, v, mask, causal, do, lse, delta, dlse=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: ``(dk, dv)`` in k's and v's dtype."""
    if _check_attention("flash_bwd_dkv", q, k, v, mask, lse, delta, dlse,
                        do=do) == "cpu":
        return _flash_bwd_dkv_plain(q, k, v, mask, causal, do, lse, delta,
                                    dlse)
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_tma_operand(t) for t in (q, k, v, do))
    b, s, h, _ = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_flash(_DKV, ("flash_bwd_dkv",), q, k, v, _f32(mask, (b, s)),
                  causal, do=do, lse=_f32(lse, (b, h, s)),
                  delta=_f32(delta, (b, h, s)), dlse=_f32(dlse, (b, h, s)),
                  out=dk, out2=dv)
    return dk, dv


def flash_bwd(q, k, v, mask, causal, o, lse, do, dlse=None):
    """K6 + K7: ``(dq, dk, dv)`` from the forward's saved ``o`` and
    ``lse`` and the cotangents ``do`` and ``dlse`` (None = zero). On the
    card one C call launches K6 and then K7 on the same stream, with the
    inputs checked, laid out and converted once for both (and, in bf16,
    their four TMA maps encoded once); each kernel counts its launch."""
    if _check_attention("flash_bwd", q, k, v, mask, lse, dlse,
                        do=do) == "cpu":
        return _flash_bwd_plain(q, k, v, mask, causal, o, lse, do, dlse)
    b, s, h, _ = q.shape
    delta = _f32(flash_delta(o, do), (b, h, s))
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_tma_operand(t) for t in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_flash(_BWD, ("flash_bwd_dq", "flash_bwd_dkv"), q, k, v,
                  _f32(mask, (b, s)), causal, do=do,
                  lse=_f32(lse, (b, h, s)), delta=delta,
                  dlse=_f32(dlse, (b, h, s)), out=dq, out2=dk, out3=dv)
    return dq, dk, dv
