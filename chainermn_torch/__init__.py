"""chainermn_torch — the PyTorch/CUDA port of ``chainermn_tpu`` for an
NVIDIA H100 (Hopper, sm_90a).

The layout mirrors the JAX package so each module's counterpart is easy
to find. It holds two paths so far:

- paged serving: the dense :class:`~chainermn_torch.models.TransformerLM`,
  the paged KV-cache attention (:mod:`chainermn_torch.parallel.sequence`)
  with its hand-written paged-decode CUDA kernel
  (:mod:`chainermn_torch.parallel.paged_kernel`), and the serving engine,
  scheduler, metrics and client (:mod:`chainermn_torch.serving`);
- LM training: ``TransformerLM(attention='flash')`` on the hand-written
  flash forward, dq and dk/dv CUDA kernels
  (:mod:`chainermn_torch.ops.flash_attention`), the communicator
  (:func:`create_communicator`), the multi-node optimizer
  (:func:`create_multi_node_optimizer`) and the step
  (:func:`chainermn_torch.training.lm_train_step`).

The package imports ``torch`` and numpy only; weights cross over from
flax through :func:`chainermn_torch.interop.params_from_flax`.
"""

from chainermn_torch.communicators import create_communicator
from chainermn_torch.optimizers import create_multi_node_optimizer

__version__ = "0.1.0"

__all__ = ["create_communicator", "create_multi_node_optimizer"]
