"""Host/device data movement: the serving step's device-to-host fetch and
the training input's copy-ahead prefetcher."""

from chainermn_torch.dataflow.dispatch import device_fetch
from chainermn_torch.dataflow.prefetch import DevicePrefetcher

__all__ = ["DevicePrefetcher", "device_fetch"]
