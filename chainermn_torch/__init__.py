"""chainermn_torch — the PyTorch/CUDA port of ``chainermn_tpu`` for an
NVIDIA H100 (Hopper, sm_90a).

The layout mirrors the JAX package so each module's counterpart is easy
to find. It holds these paths so far:

- paged serving: the dense :class:`~chainermn_torch.models.TransformerLM`,
  the paged KV-cache attention (:mod:`chainermn_torch.parallel.sequence`)
  with its hand-written paged-decode CUDA kernel
  (:mod:`chainermn_torch.parallel.paged_kernel`), and the serving engine,
  scheduler, metrics and client (:mod:`chainermn_torch.serving`);
- LM training: ``TransformerLM(attention='flash')`` on the hand-written
  flash forward, dq and dk/dv CUDA kernels
  (:mod:`chainermn_torch.ops.flash_attention`) and
  :func:`chainermn_torch.training.lm_train_step`;
- ChainerMN's data-parallel training: every communicator strategy
  (:func:`create_communicator`), the multi-node optimizer with double
  buffering (:func:`create_multi_node_optimizer`), ZeRO-1
  (:func:`create_zero_optimizer`), multi-node BatchNorm
  (:class:`MultiNodeBatchNormalization`, :func:`create_mnbn_model`), the
  differentiable collectives (:mod:`chainermn_torch.functions`), dataset
  scattering, and :func:`chainermn_torch.training.train_step` over the
  ResNet family (:mod:`chainermn_torch.models`);
- the ImageNet trainer (``python -m
  chainermn_torch.examples.imagenet.train_imagenet``): the iterators
  (:mod:`chainermn_torch.iterators`), the native C++ batch loader
  (:mod:`chainermn_torch.native`), the device prefetcher
  (:mod:`chainermn_torch.dataflow`), the warmup-cosine LR schedule, the
  multi-node evaluator, FSDP/HSDP (:mod:`chainermn_torch.parallel.fsdp`),
  GoogLeNet and VGG16, and the global except hook;
- ChainerMN's model parallelism and extensions: :class:`MultiNodeChainList`
  over the differentiable ``send``/``recv``/``pseudo_connect``
  (:mod:`chainermn_torch.functions`) with
  :func:`create_component_wise_optimizer`, the CRC-footer checkpointer
  (:func:`create_multi_node_checkpointer`), :class:`AllreducePersistent`,
  :class:`ObservationAggregator`, the profiling helpers
  (:mod:`chainermn_torch.extensions`) and fault injection and retry
  (:mod:`chainermn_torch.resilience`), with the MNIST and seq2seq example
  twins under :mod:`chainermn_torch.examples`;
- context and tensor parallelism of the LM: ring, zigzag and Ulysses
  attention on the flash kernels (:mod:`chainermn_torch.parallel.sequence`),
  Megatron layers and the vocab-parallel head
  (:mod:`chainermn_torch.parallel.tensor`), the ``dp x sp x tp`` rank mesh
  (:mod:`chainermn_torch.parallel.mesh`, :class:`MeshCommunicator`) and
  ``lm_train_step``'s sequence- and tensor-parallel steps;
- expert, weights-at-rest and pipeline parallelism of the LM: the MoE
  blocks (:mod:`chainermn_torch.parallel.moe`), the Megatron layout with
  each rank storing its shards (:mod:`chainermn_torch.parallel.gspmd`),
  GPipe (:mod:`chainermn_torch.ops.pipeline`), ``remat``, the fused
  chunked cross entropy (:mod:`chainermn_torch.ops.losses`) and the
  ``train_lm`` example twin.

The package imports ``torch`` and numpy only; weights cross over from
flax through :mod:`chainermn_torch.interop`.
"""

from chainermn_torch import dataflow, functions, monitor, resilience
from chainermn_torch.global_except_hook import add_hook as add_global_except_hook
from chainermn_torch.communicators import (
    CommunicatorBase,
    FlatCommunicator,
    HierarchicalCommunicator,
    MeshCommunicator,
    NaiveCommunicator,
    ProcessGroupCommunicator,
    PureNcclCommunicator,
    SingleNodeCommunicator,
    TwoDimensionalCommunicator,
    create_communicator,
)
from chainermn_torch.datasets import (
    SubDataset,
    create_empty_dataset,
    get_n_iterations_for_one_epoch,
    scatter_dataset,
    scatter_index,
)
from chainermn_torch.evaluators import create_multi_node_evaluator
from chainermn_torch.extensions import (
    AllreducePersistent,
    ObservationAggregator,
    create_multi_node_checkpointer,
)
from chainermn_torch.iterators import (
    SerialIterator,
    create_multi_node_iterator,
    create_synchronized_iterator,
)
from chainermn_torch.links import (
    MultiNodeBatchNormalization,
    MultiNodeChainList,
    create_mnbn_model,
)
from chainermn_torch.optimizers import (
    clip_by_global_norm_sharded,
    create_component_wise_optimizer,
    create_multi_node_optimizer,
    create_zero_optimizer,
    warmup_cosine_decay_schedule,
)

__version__ = "0.1.0"

__all__ = [
    "CommunicatorBase", "MeshCommunicator", "ProcessGroupCommunicator",
    "NaiveCommunicator",
    "FlatCommunicator", "PureNcclCommunicator", "HierarchicalCommunicator",
    "TwoDimensionalCommunicator", "SingleNodeCommunicator",
    "create_communicator",
    "create_multi_node_optimizer", "create_zero_optimizer",
    "create_component_wise_optimizer",
    "clip_by_global_norm_sharded", "warmup_cosine_decay_schedule",
    "MultiNodeChainList", "MultiNodeBatchNormalization", "create_mnbn_model",
    "SubDataset", "scatter_dataset", "scatter_index", "create_empty_dataset",
    "get_n_iterations_for_one_epoch",
    "SerialIterator", "create_multi_node_iterator",
    "create_synchronized_iterator", "create_multi_node_evaluator",
    "AllreducePersistent", "ObservationAggregator",
    "create_multi_node_checkpointer",
    "add_global_except_hook",
    "dataflow", "functions", "monitor", "resilience",
]
