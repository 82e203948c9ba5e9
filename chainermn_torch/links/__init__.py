"""Links (the port of ``chainermn_tpu/links/``): BatchNorm with flax's
semantics, its multi-node sibling, the model walker that swaps one for
the other, and ``MultiNodeChainList`` (model parallelism)."""

from chainermn_torch.links.batch_normalization import (
    BatchNorm,
    MultiNodeBatchNormalization,
    multi_node_batch_normalization,
)
from chainermn_torch.links.create_mnbn_model import create_mnbn_model
from chainermn_torch.links.multi_node_chain_list import MultiNodeChainList

__all__ = ["BatchNorm", "MultiNodeBatchNormalization",
           "multi_node_batch_normalization", "create_mnbn_model",
           "MultiNodeChainList"]
