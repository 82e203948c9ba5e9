"""One controller, many processes: how a tensor-parallel engine's ranks
stay in step.

The reference's tensor-parallel engine is one process driving programs
traced inside a ``shard_map``. The port's ranks are processes, one a
shard of the heads. If every rank ran its own scheduler, a decision that
reads the wall clock (a deadline, the brownout ladder, a chunk budget,
the watchdog, the SLO engine) could go one way on one rank and another
way on the next; one rank would then sit in a collective the others
never enter. So only the tensor axis's rank 0, the **leader**, runs a
scheduler, and its engine is the one the metrics and a ``FleetRouter``
see. Before each step program runs, the leader broadcasts the program's
name and host operands (tokens, positions, tables, slots, the active
mask) over the tensor group's object channel; ranks > 0, the
**followers**, loop in :meth:`ServingEngine.follow`, run the same program
on their own shards, and leave on :data:`CLOSE`. A follower decides
nothing: every branch it takes is the leader's, sent as data.

Sampled tokens are drawn on the leader alone (the programs stop at the
logits when ``temperature > 0``); the next program's operands carry them
to the followers, so no rank depends on its generators staying in step
with another's.

Besides program runs the channel carries :data:`RESTART` (zero the
stores in place) and :data:`SWAP` (new weights, as CPU tensors).
"""

from __future__ import annotations

import numpy as np
import torch

CLOSE = "__close__"
RESTART = "__restart__"
SWAP = "__swap__"


def _host(value):
    """A program operand as a host numpy array (device tensors are
    copied off the card)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class TPChannel:
    """The leader-to-followers message channel over ``group`` (the
    tensor axis's communicator; its rank 0 leads). ``operand_bytes``
    counts the program operands the leader sent."""

    def __init__(self, group) -> None:
        self.group = group
        self.operand_bytes = 0

    @property
    def leader(self) -> bool:
        return self.group.rank == 0

    def announce(self, name: str, values: dict) -> None:
        """Leader: program ``name`` runs next, on ``values``."""
        ops = {k: _host(v) for k, v in values.items()}
        self.operand_bytes += sum(a.nbytes for a in ops.values())
        self.send(name, ops)

    def send(self, name: str, payload=None) -> None:
        """Leader: one message (a control name and its payload)."""
        self.group.bcast_obj((name, payload), 0)

    def recv(self) -> tuple:
        """Follower: the leader's next ``(name, payload)``."""
        return self.group.bcast_obj(None, 0)


__all__ = ["CLOSE", "RESTART", "SWAP", "TPChannel"]
