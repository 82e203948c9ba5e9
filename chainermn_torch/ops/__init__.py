"""Ops: the flash attention kernels (:mod:`.flash_attention`), the
chunked cross entropy (:mod:`.losses`) and the pipeline schedule
(:mod:`.pipeline`)."""

from chainermn_torch.ops.pipeline import (
    init_pipeline_lm,
    jit_pp_lm_train_step,
    make_pipeline_lm,
    pipeline_apply,
    pp_lm_opt_init,
)

__all__ = ["pipeline_apply", "make_pipeline_lm", "init_pipeline_lm",
           "pp_lm_opt_init", "jit_pp_lm_train_step"]
