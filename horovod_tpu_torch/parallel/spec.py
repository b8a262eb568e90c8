"""ParallelSpec — hybrid dp x pp x tp x ep x sp parallelism declared on
one mesh; the port of ``horovod_tpu/parallel/spec.py``.

Each mesh axis plays a ROLE:

  ``dp``  data parallelism      — batch shards, gradient allreduce
  ``pp``  pipeline parallelism  — decoder stages (a later slice of the port)
  ``tp``  tensor parallelism    — column/row-parallel weights and
                                  sharded-head attention
                                  (parallel/tensor_parallel.py)
  ``ep``  expert parallelism    — MoE dispatch (a later slice of the port)
  ``sp``  sequence parallelism  — ring/Ulysses attention over
                                  sequence-sharded activations
                                  (parallel/ring_attention.py,
                                  parallel/ulysses.py)

Roles are declared SLOW axis first, FAST axis last (row-major rank
order, the ``HVD_TPU_MESH_SHAPE`` convention): ``"dp=2,tp=2"`` puts rank
``r`` at ``dp = r // 2, tp = r % 2``, so the tp pair shares the fastest
links. ``hvd.init(parallel=...)`` takes a dict, a spec string (the
``HVD_TPU_PARALLEL`` form) or a ParallelSpec, builds one
``torch.distributed`` subgroup per axis line (``parallel/mesh.py``) and
publishes ``hvd.parallel_spec()`` and ``hvd.parallel_mesh()``.
``DistributedOptimizer(parallel=spec)`` reduces gradients over the
``dp`` axis only, after pmean-combining slice gradients over ``tp``
then ``sp``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

# Roles a mesh axis can play; the axis handle's name is the role name.
ROLES = ("dp", "pp", "tp", "ep", "sp")

# The env form init(parallel=) reads and the role-aware consumers (the
# flight recorder) resolve.
ENV_PARALLEL = "HVD_TPU_PARALLEL"


def spec_from_env(env=None) -> Optional["ParallelSpec"]:
    """The ParallelSpec of ``HVD_TPU_PARALLEL``, or None. Raises
    ValueError on a malformed value (a typo'd spec must not silently run
    role-blind)."""
    env = os.environ if env is None else env
    raw = env.get(ENV_PARALLEL)
    if not raw or not str(raw).strip():
        return None
    return ParallelSpec.parse(raw)


@dataclasses.dataclass(frozen=True)
class ParallelSpec:
    """Immutable role -> size assignment, SLOW axis first: ``dims`` is an
    ordered tuple of ``(role, size)`` pairs."""

    dims: Tuple[Tuple[str, int], ...]

    def __post_init__(self):
        if not self.dims:
            raise ValueError("ParallelSpec needs at least one axis")
        seen = set()
        for role, size in self.dims:
            if role not in ROLES:
                raise ValueError(
                    f"unknown parallelism role {role!r}; choose from "
                    f"{ROLES}")
            if role in seen:
                raise ValueError(f"duplicate role {role!r} in spec")
            seen.add(role)
            if int(size) < 1:
                raise ValueError(
                    f"axis {role!r} needs size >= 1, got {size}")

    # -- construction -------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "ParallelSpec":
        """``"dp=2,pp=2,tp=2"`` (slow -> fast) — the HVD_TPU_PARALLEL
        form."""
        dims = []
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"bad parallel spec segment {part!r}: expected "
                    "role=size, e.g. 'dp=2,pp=2,tp=2'")
            role, size = part.split("=", 1)
            dims.append((role.strip(), int(size)))
        return cls(tuple(dims))

    @classmethod
    def resolve(cls, value) -> Optional["ParallelSpec"]:
        """A spec from a ``parallel=`` value: a spec, a role -> size dict
        (insertion order = slow -> fast) or a spec string; None stays
        None."""
        if value is None:
            return None
        if isinstance(value, ParallelSpec):
            return value
        if isinstance(value, dict):
            return cls(tuple((str(k), int(v)) for k, v in value.items()))
        return cls.parse(str(value))

    # -- views --------------------------------------------------------

    @property
    def roles(self) -> Tuple[str, ...]:
        return tuple(r for r, _ in self.dims)

    @property
    def sizes(self) -> dict:
        return {r: s for r, s in self.dims}

    def size_of(self, role: str) -> int:
        return self.sizes.get(role, 1)

    @property
    def total(self) -> int:
        n = 1
        for _, s in self.dims:
            n *= s
        return n

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """Axes the gradient allreduce runs over — ``dp`` only (a size-1
        dp axis is kept)."""
        return tuple(r for r, _ in self.dims if r == "dp")

    @property
    def pp_axis(self) -> Optional[str]:
        return "pp" if self.size_of("pp") > 1 else None

    @property
    def tp_axis(self) -> Optional[str]:
        return "tp" if self.size_of("tp") > 1 else None

    @property
    def ep_axis(self) -> Optional[str]:
        return "ep" if self.size_of("ep") > 1 else None

    @property
    def sp_axis(self) -> Optional[str]:
        return "sp" if self.size_of("sp") > 1 else None

    def describe(self) -> str:
        return ",".join(f"{r}={s}" for r, s in self.dims)

    # -- rank -> role coordinates --------------------------------------

    @property
    def replica_ranks(self) -> int:
        """Ranks per model replica: the product of every non-dp role
        size."""
        n = 1
        for role, size in self.dims:
            if role != "dp":
                n *= size
        return n

    def coords(self, rank: int) -> dict:
        """Role -> index of a flat rank, row-major over ``dims`` (the
        LAST declared axis varies fastest)."""
        if not 0 <= int(rank) < self.total:
            raise ValueError(
                f"rank {rank} outside the {self.total}-rank spec "
                f"{self.describe()!r}")
        rem = int(rank)
        rev = []
        for role, size in reversed(self.dims):
            rev.append((role, rem % size))
            rem //= size
        return dict(reversed(rev))

    def role_label(self, rank: int) -> str:
        """``"dp1/pp0/tp1"``: the rank's coordinates, stamped on black
        boxes."""
        return "/".join(f"{r}{i}" for r, i in self.coords(rank).items())

    def replica_of(self, rank: int) -> int:
        """The dp-replica index of a rank (0 without a dp axis)."""
        return self.coords(rank).get("dp", 0)

    # -- routing ------------------------------------------------------

    def grad_route(self, wires=None):
        """The WirePlan the gradient allreduce runs over — the ``dp``
        axes only, fast axis first; ``wires`` maps axis -> wire
        (``{"dp": "int8"}``). None when there is no dp axis."""
        from ..ops.collectives import AxisPhase, WirePlan

        axes = self.dp_axes
        if not axes:
            return None
        wires = wires or {}
        return WirePlan(tuple(AxisPhase(a, wires.get(a, "none"))
                              for a in reversed(axes)))
