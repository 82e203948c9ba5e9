"""Resilience (the port of ``chainermn_tpu/resilience``): fault
injection over named cut-points, bounded retry, and the step-level
exception boundary with checkpoint-restore recovery
(:class:`ResilientTrainer`, :func:`resilient_fit`)."""

from chainermn_torch.resilience.faults import (
    FaultInjector,
    InjectedFault,
    get_injector,
    inject,
    torn_fraction,
)
from chainermn_torch.resilience.retry import RetryPolicy
from chainermn_torch.resilience.trainer import ResilientTrainer, resilient_fit

__all__ = ["FaultInjector", "InjectedFault", "ResilientTrainer",
           "RetryPolicy", "get_injector", "inject", "resilient_fit",
           "torn_fraction"]
