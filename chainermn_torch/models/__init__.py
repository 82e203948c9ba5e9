"""Models served by the port."""

from chainermn_torch.models.transformer import (
    TransformerBlock,
    TransformerLM,
    generate,
    init_paged_kv_caches,
)

__all__ = ["TransformerBlock", "TransformerLM", "generate",
           "init_paged_kv_caches"]
