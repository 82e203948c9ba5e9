"""Host/device data movement: the device-to-host fetch, the training
loop's windowed loss fetch and the training input's copy-ahead
prefetcher."""

from chainermn_torch.dataflow.dispatch import LossWindow, device_fetch
from chainermn_torch.dataflow.prefetch import DevicePrefetcher

__all__ = ["DevicePrefetcher", "LossWindow", "device_fetch"]
