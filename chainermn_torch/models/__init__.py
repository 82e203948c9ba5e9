"""Models of the port."""

from chainermn_torch.models.mlp import MLP
from chainermn_torch.models.resnet import (
    AlexNet,
    BasicBlock,
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from chainermn_torch.models.transformer import (
    TransformerBlock,
    TransformerLM,
    generate,
    init_kv_caches,
    init_paged_kv_caches,
)
from chainermn_torch.models.vision import VGG16, GoogLeNet, InceptionBlock

__all__ = ["MLP", "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "BottleneckBlock", "BasicBlock", "AlexNet",
           "GoogLeNet", "InceptionBlock", "VGG16",
           "TransformerBlock", "TransformerLM", "generate",
           "init_kv_caches", "init_paged_kv_caches"]
