"""Host/device data movement for the serving path."""

from chainermn_torch.dataflow.dispatch import device_fetch

__all__ = ["device_fetch"]
