"""The run's surroundings: cache directories pinned inside the checkout,
the card's description, and the check that no JAX module was loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Every cache of the run and of the program, at fixed paths inside the
#: checkout (``build/`` is ignored by git), so that only a cell's first run
#: in a checkout compiles. The port builds its kernels into
#: ``build/horovod_tpu_torch/`` by itself.
CACHE_DIR = os.path.join(ROOT, "build", "port_bench")
TRACE_DIR = os.path.join(CACHE_DIR, "traces")
#: Top-level module names that no process of a run may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "horovod_tpu")


def pin_caches(environ=None) -> None:
    """Point the bytecode cache and every compiler cache at fixed
    directories in the checkout, for this process and the ones it starts.
    The card's machine sets ``PYTHONDONTWRITEBYTECODE`` and torch ships no
    ``.pyc``: without a cache each process compiles torch from source."""
    env = os.environ if environ is None else environ
    pyc = os.path.join(CACHE_DIR, "pycache")
    env["PYTHONPYCACHEPREFIX"] = pyc
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        env[var] = os.path.join(CACHE_DIR, sub)
    # Libraries that would load JAX or flax by themselves stay off them.
    env["USE_FLAX"] = "0"
    env["USE_JAX"] = "0"
    if environ is None:
        sys.pycache_prefix = pyc
        sys.dont_write_bytecode = False


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is exactly one of
    :data:`FORBIDDEN` (``horovod_tpu_torch`` is not ``horovod_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def check_program(module) -> None:
    """The system under test is the checkout's own port, not a copy
    installed elsewhere: a checkout without it has nothing to measure."""
    path = os.path.realpath(module.__file__)
    if not path.startswith(os.path.realpath(ROOT) + os.sep):
        raise RuntimeError(f"{module.__name__} was imported from {path}, "
                           f"outside the checkout {ROOT}")


def _smi(args) -> str:
    try:
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi {' '.join(args)}: {e}"
    return (out.stdout or out.stderr).rstrip()


def card_lines() -> str:
    """The card's name and power limit, and how the cards are linked
    (``topo -m``; where the machine refuses it, the NVLink peer matrix and
    the first card's links)."""
    topo = _smi(["topo", "-m"])
    if "Failed" in topo or "nvidia-smi" in topo:
        topo = "\n".join((topo, _smi(["topo", "-p2p", "n"]),
                          _smi(["nvlink", "--status", "-i", "0"])))
    return "\n".join((
        "card: " + _smi(["--query-gpu=index,name,power.limit,clocks.max.sm",
                         "--format=csv,noheader"]).replace("\n", "; "),
        "topology:", topo))
