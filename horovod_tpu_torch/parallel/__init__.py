"""Parallelism roles over ``torch.distributed`` — the port of
``horovod_tpu/parallel``: the hybrid :class:`ParallelSpec` and its
role-named mesh axes, tensor parallelism, and sequence parallelism (ring,
striped ring, Ulysses). The pipeline schedules, MoE and respec come with
a later slice of the port and raise ``NotImplementedError`` naming it.
"""

from .mesh import AXIS_ORDER, build_mesh, local_batch  # noqa: F401
from .ring_attention import (resolve_seq_wire,  # noqa: F401
                             ring_attend_fn, ring_attention,
                             stripe_layout, striped_attend_fn,
                             striped_attention, striped_positions,
                             unstripe_layout)
from .spec import ENV_PARALLEL, ROLES, ParallelSpec, spec_from_env  # noqa
from .tensor_parallel import (column_parallel,  # noqa: F401
                              combine_slice_grads, row_parallel,
                              shard_column, shard_head_rows,
                              shard_heads, shard_row,
                              tp_attention_qkv, tp_mlp)
from .ulysses import ulysses_attend_fn, ulysses_attention  # noqa: F401

#: The slice of the port that brings the rest of the JAX package's
#: parallel roles.
NEXT_SLICE = "the pipeline and MoE slice"
LATER = ("pipeline_accumulate_gradients", "pipeline_apply",
         "pipeline_train_step_1f1b", "select_last_stage", "moe_layer",
         "top2_gating", "solve_respec", "RespecDecision", "min_world")


def __getattr__(name):
    if name in LATER:
        raise NotImplementedError(
            f"horovod_tpu_torch.parallel.{name} is not ported yet; it "
            f"comes with {NEXT_SLICE} of the port")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
