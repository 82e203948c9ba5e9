"""Ops: the flash attention kernels (:mod:`.flash_attention`), the
chunked cross entropy (:mod:`.losses`) and the pipeline schedule
(:mod:`.pipeline`).

As in ``chainermn_tpu.ops``, ``chainermn_torch.ops.flash_attention`` is
the function, which shadows the submodule's name on the package: reach
the module with ``importlib.import_module(
"chainermn_torch.ops.flash_attention")`` or import names from it
(``from chainermn_torch.ops.flash_attention import ...``)."""

from chainermn_torch.ops.flash_attention import flash_attention
from chainermn_torch.ops.pipeline import (
    init_pipeline_lm,
    jit_pp_lm_train_step,
    make_pipeline_lm,
    pipeline_apply,
    pp_lm_opt_init,
)

__all__ = ["flash_attention", "pipeline_apply", "make_pipeline_lm",
           "init_pipeline_lm", "pp_lm_opt_init", "jit_pp_lm_train_step"]
