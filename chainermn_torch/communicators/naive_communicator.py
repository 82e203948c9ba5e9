"""Per-gradient all-reduce strategy (the port of
``chainermn_tpu/communicators/naive_communicator.py``): one all-reduce a
gradient, no packing — the simplest correct strategy."""

from chainermn_torch.communicators.process_group_communicator import (
    ProcessGroupCommunicator,
)


class NaiveCommunicator(ProcessGroupCommunicator):
    pass  # the base class's behaviour is the naive strategy


__all__ = ["NaiveCommunicator"]
