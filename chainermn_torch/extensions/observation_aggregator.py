"""ObservationAggregator — cross-rank averaging of reported metrics (the
port of ``chainermn_tpu/extensions/observation_aggregator.py``): per-rank
observation dicts (loss, accuracy, timings) are averaged across ranks, so
root's log reflects the whole job, not one shard."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from chainermn_torch.communicators.communicator_base import CommunicatorBase


def _host(v):
    """Tensors leave the device as numpy arrays; other values pass."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


class ObservationAggregator:
    """Callable: ``agg(observation_dict) -> cross-rank mean dict``.

    Numeric values (numbers, numpy arrays, tensors) are averaged;
    non-numeric values pass through from rank 0 untouched. Keys must agree
    across ranks. Every rank calls it."""

    def __init__(self, communicator: CommunicatorBase) -> None:
        self._comm = communicator

    def __call__(self, observation: Mapping[str, Any]) -> dict[str, Any]:
        gathered = self._comm.allgather_obj(
            {k: _host(v) for k, v in observation.items()})
        keys = list(gathered[0].keys())
        for d in gathered[1:]:
            if list(d.keys()) != keys:
                raise ValueError(f"observation keys diverged across ranks: "
                                 f"{keys} vs {list(d.keys())}")
        out: dict[str, Any] = {}
        for k in keys:
            vals = [d[k] for d in gathered]
            if all(isinstance(v, (int, float, np.number, np.ndarray))
                   for v in vals):
                mean = np.mean([np.asarray(v) for v in vals], axis=0)
                out[k] = float(mean) if mean.ndim == 0 else mean
            else:
                out[k] = vals[0]
        return out


__all__ = ["ObservationAggregator"]
