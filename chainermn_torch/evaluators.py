"""Multi-node evaluation (the port of ``chainermn_tpu/evaluators``).

Each rank evaluates its shard; :func:`create_multi_node_evaluator` wraps
the evaluator (anything with ``evaluate() -> dict`` or a callable
returning a metrics dict) so every rank gets the element-wise mean of all
ranks' dicts, gathered over the communicator's object channel. Values may
be scalars, numpy arrays or tensors (which are moved to the host first).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from chainermn_torch.communicators.communicator_base import CommunicatorBase


def _host(x):
    """A metric value as a numpy array (tensors leave the device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _mean_dicts(dicts: list[Mapping[str, Any]]) -> dict[str, Any]:
    keys = sorted(dicts[0].keys())
    for d in dicts[1:]:
        if sorted(d.keys()) != keys:  # order-insensitive; sets must match
            raise ValueError(
                f"evaluators returned mismatched metric keys: {keys} vs {sorted(d.keys())}"
            )
    out: dict[str, Any] = {}
    for k in keys:
        mean = np.mean([_host(d[k]) for d in dicts], axis=0)
        out[k] = float(mean) if mean.ndim == 0 else mean  # elementwise for arrays
    return out


class _MultiNodeEvaluator:
    """Wrapper produced by :func:`create_multi_node_evaluator`."""

    def __init__(self, actual_evaluator, communicator: CommunicatorBase) -> None:
        self._evaluator = actual_evaluator
        self._comm = communicator

    def evaluate(self) -> dict[str, Any]:
        inner = self._evaluator
        local = inner.evaluate() if hasattr(inner, "evaluate") else inner()
        if not isinstance(local, Mapping):
            raise TypeError(
                f"evaluator must return a metrics dict, got {type(local).__name__}"
            )
        gathered = self._comm.allgather_obj(
            {k: _host(v) for k, v in local.items()})
        return _mean_dicts(gathered)

    __call__ = evaluate

    def __getattr__(self, name):  # delegate everything else to the wrapped one
        return getattr(self._evaluator, name)


def create_multi_node_evaluator(actual_evaluator, communicator: CommunicatorBase):
    """Wrap an evaluator so results are cross-rank means (reference name).

    The wrapped evaluator's ``evaluate()`` is called on every process with its
    local shard; the returned dict's values are averaged elementwise across
    processes. All processes receive the averaged dict (root-only reporting is
    the caller's choice, as in the reference examples)."""
    return _MultiNodeEvaluator(actual_evaluator, communicator)


__all__ = ["create_multi_node_evaluator"]
