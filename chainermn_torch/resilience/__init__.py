"""Resilience (the port of ``chainermn_tpu/resilience``): fault
injection over named cut-points and bounded retry, the pieces the
checkpointer uses. ``resilient_fit`` (``resilience/trainer.py``) waits
for the training loop ``fit``."""

from chainermn_torch.resilience.faults import (
    FaultInjector,
    InjectedFault,
    get_injector,
    inject,
    torn_fraction,
)
from chainermn_torch.resilience.retry import RetryPolicy

__all__ = ["FaultInjector", "InjectedFault", "RetryPolicy", "get_injector",
           "inject", "torn_fraction"]
