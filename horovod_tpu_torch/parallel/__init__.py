"""Parallelism roles over ``torch.distributed`` — the port of
``horovod_tpu/parallel``: the hybrid :class:`ParallelSpec` and its
role-named mesh axes, tensor parallelism, and sequence parallelism (ring,
striped ring, Ulysses), the GPipe and 1F1B pipeline, expert-parallel
MoE, and the elastic respec solver.
"""

from .mesh import AXIS_ORDER, build_mesh, local_batch  # noqa: F401
from .moe import moe_layer, top2_gating  # noqa: F401
from .pipeline import (pipeline_accumulate_gradients,  # noqa: F401
                       pipeline_apply, pipeline_train_step_1f1b,
                       select_last_stage)
from .respec import RespecDecision, min_world, solve_respec  # noqa: F401
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

