"""The one device-to-host sync point of a serving step (the port's copy of
``chainermn_tpu/dataflow/dispatch.py::device_fetch``)."""

from __future__ import annotations

import numpy as np
import torch


def device_fetch(values):
    """Copy tensor(s) to host numpy arrays. ``.cpu()`` waits for the
    device to produce the bytes, so this is also the step's completion
    barrier. Accepts a tensor or a tuple/list of tensors."""
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    if isinstance(values, (tuple, list)):
        return type(values)(device_fetch(v) for v in values)
    return np.asarray(values)


__all__ = ["device_fetch"]
