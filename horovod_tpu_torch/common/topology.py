"""Process topology of the port: the launcher's rank layout, the routing
axes of the mesh and their ``torch.distributed`` subgroups.

The port of ``horovod_tpu/common/topology.py``. There a rank is a device
of a JAX mesh and an axis is a name inside ``shard_map``; here a rank is
a process and an axis is an :class:`Axis`: a ``torch.distributed``
subgroup, its size and this rank's position in it. A collective of
``ops/collectives.py`` over an axis runs over that subgroup.

* :class:`Topology` comes from the launcher's environment
  (``HVD_TPU_LOCAL_SIZE`` processes a host, ranks host-major), not from
  a device list: ``cross_rank = rank // local_size``.
* :class:`MeshAxis`, :func:`parse_mesh_shape`, :func:`mesh_shape_from_env`
  and :func:`mesh_axes` are the JAX package's, copied: the routing
  factorization ``HVD_TPU_MESH_SHAPE`` (or ``init(mesh_shape=)``)
  simulates on any world, else cross x local from the topology, else the
  flat axis; axes come fast first.
* :func:`build_axes` takes the place of ``build_mesh_from_axes`` and
  ``build_hierarchical_mesh``: ranks are laid out row-major, slow axis
  first (``rank = cross * n_local + local`` on a 2-D mesh), and every
  line of every axis becomes a subgroup. Group creation is collective
  over the world, so every rank creates every line's group, in one
  fixed order (axes slow to fast, lines in row-major order of the other
  coordinates), and keeps the ones it belongs to.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Sequence, Tuple

from . import config as config_lib

# Axis kinds, fastest first: "ici" the intra-host links, "dcn" the
# cross-host hop (the JAX package's names; on the card NVLink and the
# network between hosts).
AXIS_ICI = "ici"
AXIS_DCN = "dcn"


@dataclasses.dataclass(frozen=True)
class Topology:
    """This process's place in the launched world: ``size`` ranks,
    ``local_size`` a host, hosts in rank order."""

    rank: int
    size: int
    local_rank: int
    local_size: int

    @property
    def is_homogeneous(self) -> bool:
        """Every host runs ``local_size`` processes."""
        return self.local_size > 0 and self.size % self.local_size == 0

    @property
    def cross_size(self) -> int:
        return self.size // self.local_size if self.is_homogeneous else 1

    @property
    def cross_rank(self) -> int:
        return self.rank // self.local_size if self.is_homogeneous else 0


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One routing axis: its name, the number of ranks along it, the link
    tier it maps onto. :func:`mesh_axes` orders them fast to slow."""

    name: str
    size: int
    kind: str = AXIS_ICI


@dataclasses.dataclass(frozen=True)
class Axis:
    """A collective's axis in the port: the subgroup (``None`` for the
    default group, the world), its size, this rank's index in it, and
    the global ranks along it in index order."""

    name: str
    group: Any
    size: int
    index: int
    ranks: Tuple[int, ...]


def parse_mesh_shape(raw: Optional[str]) -> Optional[tuple]:
    """``"2x4"`` / ``"2,2,2"`` -> dims, slow axis first; None when unset
    or invalid."""
    if not raw:
        return None
    try:
        dims = tuple(int(d) for d in str(raw).replace("x", ",").split(",")
                     if d.strip())
    except ValueError:
        return None
    if not dims or any(d < 1 for d in dims):
        return None
    return dims


def mesh_shape_from_env() -> Optional[tuple]:
    """The ``HVD_TPU_MESH_SHAPE`` override that simulates a multi-axis
    mesh on any world."""
    return parse_mesh_shape(config_lib.runtime_env("MESH_SHAPE"))


# Axis names by mesh rank, slow -> fast.
_AXIS_NAMES = {1: ("hvd",), 2: ("cross", "local"),
               3: ("cross", "middle", "local")}


def mesh_axes(topology: Topology,
              shape: Optional[Sequence[int]] = None) -> tuple:
    """The routing axes of ``topology``, FAST axis first: ``shape`` (slow
    first), else ``HVD_TPU_MESH_SHAPE``, else cross x local when the
    world spans hosts evenly, else the flat axis. Raises when the shape
    does not factor the world size."""
    dims = tuple(shape) if shape is not None else mesh_shape_from_env()
    if dims is None:
        if topology.is_homogeneous and topology.cross_size > 1:
            dims = (topology.cross_size, topology.local_size)
        else:
            dims = (topology.size,)
    total = 1
    for d in dims:
        total *= d
    if total != topology.size:
        raise ValueError(
            f"mesh shape {dims} covers {total} ranks but the world has "
            f"{topology.size} (HVD_TPU_MESH_SHAPE must factor the world "
            "size exactly)")
    names = _AXIS_NAMES.get(len(dims))
    if names is None:
        raise ValueError(
            f"mesh shapes of rank {len(dims)} are not supported "
            "(1-D flat, 2-D cross x local, 3-D cross x middle x local)")
    axes = [MeshAxis(n, d, AXIS_ICI if i == len(dims) - 1 else AXIS_DCN)
            for i, (n, d) in enumerate(zip(names, dims))]
    return tuple(reversed(axes))


def axis_lines(dims: Sequence[int], k: int):
    """The lines of axis ``k`` of a row-major mesh of ``dims`` (slow
    first): for each assignment of the other coordinates, in row-major
    order, the global ranks with axis ``k``'s coordinate 0, 1, ...."""
    strides = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        strides[i] = strides[i + 1] * dims[i + 1]
    others = [range(d) if i != k else range(1) for i, d in enumerate(dims)]
    for coord in itertools.product(*others):
        base = sum(c * s for c, s in zip(coord, strides))
        yield tuple(base + j * strides[k] for j in range(dims[k]))


def build_axes(axes: Sequence[MeshAxis], rank: int, size: int,
               new_group) -> Dict[str, Axis]:
    """The :class:`Axis` handles of a :func:`mesh_axes` factorization for
    ``rank``: every line of every axis made a group through
    ``new_group(ranks)`` (``torch.distributed.new_group``), on every
    rank in the same order. A 1-D mesh is the world itself (no group is
    made). The world axis is always there, as ``"hvd"``."""
    out = {"hvd": Axis("hvd", None, size, rank, tuple(range(size)))}
    slow_first = list(reversed(list(axes)))
    if len(slow_first) <= 1:
        return out
    dims = [a.size for a in slow_first]
    for k, ax in enumerate(slow_first):
        for line in axis_lines(dims, k):
            group = new_group(list(line))
            if rank in line:
                out[ax.name] = Axis(ax.name, group, len(line),
                                    line.index(rank), line)
    return out
