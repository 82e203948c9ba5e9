"""chainermn_torch — the PyTorch/CUDA port of ``chainermn_tpu`` for an
NVIDIA H100 (Hopper, sm_90a).

The layout mirrors the JAX package so each module's counterpart is easy
to find. This slice holds the paged serving path: the dense
:class:`~chainermn_torch.models.TransformerLM`, the paged KV-cache
attention (:mod:`chainermn_torch.parallel.sequence`) with its hand-written
paged-decode CUDA kernel (:mod:`chainermn_torch.parallel.paged_kernel`),
and the serving engine, scheduler, metrics and client
(:mod:`chainermn_torch.serving`). The package imports ``torch`` and
numpy only; weights cross over from flax through
:func:`chainermn_torch.interop.params_from_flax`.
"""

__version__ = "0.1.0"
