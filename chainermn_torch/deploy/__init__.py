"""The weight lifecycle (the port's ``chainermn_tpu/deploy``, less the
elastic restore of ``reshard.py``, which waits for the sharded
checkpointer: ROADMAP.md, Queue A items 9.1 and 9.2).

- :mod:`~chainermn_torch.deploy.versions`: :class:`VersionLog` and
  :class:`WeightVersion`, the audit trail of published weights;
- :mod:`~chainermn_torch.deploy.publish`: :class:`WeightPublisher`, a
  new ``state_dict`` into a live :class:`~chainermn_torch.serving.engine.
  ServingEngine` behind the scheduler's swap fence, with no program
  rebuilt and no request dropped;
  :meth:`~chainermn_torch.fleet.router.FleetRouter.publish` rolls it
  replica by replica across a fleet.
"""

from chainermn_torch.deploy.publish import (
    PublishError,
    SwapHandle,
    WeightPublisher,
)
from chainermn_torch.deploy.versions import VersionLog, WeightVersion

__all__ = ["PublishError", "SwapHandle", "VersionLog", "WeightPublisher",
           "WeightVersion"]
