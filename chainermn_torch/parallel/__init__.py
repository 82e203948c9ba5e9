"""Parallel strategies of the port: the rank mesh (:mod:`.mesh`),
sequence parallelism and the paged KV-cache attention (:mod:`.sequence`,
:mod:`.paged_kernel`), Megatron tensor parallelism (:mod:`.tensor`) and
its weights-at-rest layout (:mod:`.gspmd`), mixture of experts
(:mod:`.moe`) and FSDP (:mod:`.fsdp`). The names are those of
``chainermn_tpu.parallel``; ``jit_fsdp_train_step`` is
:func:`~chainermn_torch.parallel.fsdp.fsdp_train_step`."""

from chainermn_torch.parallel.mesh import (
    DEFAULT_AXIS,
    INTER_AXIS,
    INTRA_AXIS,
    RankGeometry,
    make_3d_mesh,
    make_hierarchical_mesh,
    make_mesh,
)
from chainermn_torch.parallel.moe import (
    ExpertParallelMLP,
    GShardMoE,
    MoeStatsAccumulator,
)
from chainermn_torch.parallel.gspmd import (
    gspmd_lm_train_step,
    megatron_opt_shard,
    megatron_param_specs,
    megatron_shard,
)
from chainermn_torch.parallel.tensor import (
    ColumnParallelDense,
    RowParallelDense,
    TensorParallelAttention,
    TensorParallelMLP,
    reshard_tp_qkv,
)
from chainermn_torch.parallel.sequence import (
    full_attention,
    ring_attention,
    sequence_parallel_attention,
    ulysses_attention,
)
from chainermn_torch.parallel.fsdp import (
    fsdp_shard,
    fsdp_spec,
    fsdp_train_step as jit_fsdp_train_step,
)

__all__ = [
    "DEFAULT_AXIS",
    "INTER_AXIS",
    "INTRA_AXIS",
    "RankGeometry",
    "make_mesh",
    "make_hierarchical_mesh",
    "make_3d_mesh",
    "ExpertParallelMLP",
    "GShardMoE",
    "MoeStatsAccumulator",
    "gspmd_lm_train_step",
    "megatron_param_specs",
    "megatron_shard",
    "megatron_opt_shard",
    "fsdp_shard",
    "fsdp_spec",
    "jit_fsdp_train_step",
    "ColumnParallelDense",
    "RowParallelDense",
    "TensorParallelAttention",
    "TensorParallelMLP",
    "reshard_tp_qkv",
    "full_attention",
    "ring_attention",
    "ulysses_attention",
    "sequence_parallel_attention",
]
