"""The weight lifecycle (the port's ``chainermn_tpu/deploy``).

- :mod:`~chainermn_torch.deploy.versions`: :class:`VersionLog` and
  :class:`WeightVersion`, the audit trail of published weights;
- :mod:`~chainermn_torch.deploy.publish`: :class:`WeightPublisher`, a
  new ``state_dict`` into a live :class:`~chainermn_torch.serving.engine.
  ServingEngine` behind the scheduler's swap fence, with no program
  rebuilt and no request dropped;
  :meth:`~chainermn_torch.fleet.router.FleetRouter.publish` rolls it
  replica by replica across a fleet;
- :mod:`~chainermn_torch.deploy.reshard`: :func:`elastic_restore` and
  :func:`restore_train_state`, a
  :class:`~chainermn_torch.extensions.sharded_checkpoint.
  ShardedCheckpointer` snapshot restored at another tensor-parallel
  degree or world size (:func:`snapshot_meta` writes the manifest it
  reads, :func:`train_state_dict` the name-keyed train state).
"""

from chainermn_torch.deploy.publish import (
    PublishError,
    SwapHandle,
    WeightPublisher,
)
from chainermn_torch.deploy.reshard import (
    elastic_restore,
    restore_train_state,
    snapshot_meta,
    train_state_dict,
)
from chainermn_torch.deploy.versions import VersionLog, WeightVersion

__all__ = ["PublishError", "SwapHandle", "VersionLog", "WeightPublisher",
           "WeightVersion", "elastic_restore", "restore_train_state",
           "snapshot_meta", "train_state_dict"]
