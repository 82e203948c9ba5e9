"""Links (the port of ``chainermn_tpu/links/``): BatchNorm with flax's
semantics, its multi-node sibling, and the model walker that swaps one
for the other. ``MultiNodeChainList`` is a later slice."""

from chainermn_torch.links.batch_normalization import (
    BatchNorm,
    MultiNodeBatchNormalization,
    multi_node_batch_normalization,
)
from chainermn_torch.links.create_mnbn_model import create_mnbn_model

__all__ = ["BatchNorm", "MultiNodeBatchNormalization",
           "multi_node_batch_normalization", "create_mnbn_model"]
