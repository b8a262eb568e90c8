"""Role-named mesh axes over ``torch.distributed`` — the port of
``horovod_tpu/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` whose named axes carry
dp/pp/fsdp/ep/sp/tp; here the mesh is a dict from role to
:class:`~..common.topology.Axis`: one ``torch.distributed`` subgroup per
line of each axis, made by ``common.topology.build_axes`` over the
row-major rank grid, slow axis first. Group creation is collective over
the world, so every rank builds the same mesh in the same order
(``init(parallel=)`` does it once and compares the spec across ranks
first).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..common import topology as topo_lib
from .spec import ROLES as _SPEC_ROLES
from .spec import ParallelSpec

# Canonical axis order of a dict-built mesh, slowest first (the JAX
# package's): dp tolerates the slow hop, tp and sp want the fastest.
# ``fsdp`` is a mesh-only axis name, not a ParallelSpec role.
AXIS_ORDER = ("dp", "pp", "fsdp", "ep", "sp", "tp")

_missing = set(_SPEC_ROLES) - set(AXIS_ORDER)
if _missing:
    raise RuntimeError(
        f"parallel/mesh.AXIS_ORDER is missing ParallelSpec role(s) "
        f"{sorted(_missing)} — add a placement for them")
del _missing


def _ordered_dims(axes) -> list:
    if isinstance(axes, ParallelSpec):
        return [(r, int(s)) for r, s in axes.dims]
    unknown = set(axes) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes: {unknown}; known: "
                         f"{AXIS_ORDER}")
    return [(n, int(axes[n])) for n in AXIS_ORDER if n in axes]


def build_mesh(axes, rank: Optional[int] = None,
               size: Optional[int] = None, new_group=None
               ) -> Dict[str, topo_lib.Axis]:
    """Role -> :class:`Axis` for ``axes``: a :class:`ParallelSpec` (its
    order) or a ``{name: size}`` dict (laid out in :data:`AXIS_ORDER`;
    size-1 axes are kept). ``rank``/``size`` default to the default
    process group's; the product of the sizes must equal ``size``. A
    one-axis mesh is the world itself (no group is made). Collective:
    every rank calls it with the same ``axes``."""
    import torch.distributed as dist

    dims = _ordered_dims(axes)
    if rank is None:
        rank = dist.get_rank()
    if size is None:
        size = dist.get_world_size()
    total = 1
    for _, s in dims:
        total *= s
    if not dims or total != size:
        raise ValueError(
            f"mesh axes {dict(dims)} cover {total} ranks but the world "
            f"has {size} (the sizes must factor the world exactly)")
    if len(dims) == 1:
        name = dims[0][0]
        return {name: topo_lib.Axis(name, None, size, rank,
                                    tuple(range(size)))}
    maxes = [topo_lib.MeshAxis(n, s) for n, s in reversed(dims)]
    built = topo_lib.build_axes(maxes, rank, size,
                                new_group or dist.new_group)
    return {n: built[n] for n, _ in dims}


def local_batch(x: torch.Tensor, spec: ParallelSpec, rank: int,
                seq_dim: int = 1) -> torch.Tensor:
    """This rank's block of a global batch (the JAX ``data_spec``
    layout): rows split over the dp coordinate, the sequence dimension
    split contiguously over the sp coordinate, replicated over
    pp/tp/ep."""
    c = spec.coords(rank)
    ndp, nsp = spec.size_of("dp"), spec.size_of("sp")
    if x.shape[0] % ndp:
        raise ValueError(f"batch {x.shape[0]} not divisible by dp {ndp}")
    rows = x.shape[0] // ndp
    x = x[c.get("dp", 0) * rows:(c.get("dp", 0) + 1) * rows]
    if nsp > 1:
        if x.shape[seq_dim] % nsp:
            raise ValueError(f"sequence {x.shape[seq_dim]} not divisible "
                             f"by sp {nsp}")
        n = x.shape[seq_dim] // nsp
        x = x.narrow(seq_dim, c["sp"] * n, n)
    return x

