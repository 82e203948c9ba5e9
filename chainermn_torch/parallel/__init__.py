"""Parallel strategies of the port: the rank mesh (:mod:`.mesh`),
sequence parallelism and the paged KV-cache attention (:mod:`.sequence`,
:mod:`.paged_kernel`), Megatron tensor parallelism (:mod:`.tensor`) and
its weights-at-rest layout (:mod:`.gspmd`), mixture of experts
(:mod:`.moe`) and FSDP (:mod:`.fsdp`)."""

from chainermn_torch.parallel.gspmd import (
    gspmd_lm_train_step,
    megatron_opt_shard,
    megatron_param_specs,
    megatron_shard,
)
from chainermn_torch.parallel.moe import (
    ExpertParallelMLP,
    GShardMoE,
    MoeStatsAccumulator,
)

__all__ = ["ExpertParallelMLP", "GShardMoE", "MoeStatsAccumulator",
           "gspmd_lm_train_step", "megatron_opt_shard",
           "megatron_param_specs", "megatron_shard"]
