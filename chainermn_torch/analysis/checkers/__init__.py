"""Checker registry: the eight graftlint rules, in report order."""

from chainermn_torch.analysis.checkers.locks import (
    LockDisciplineChecker,
    LockOrderChecker,
)
from chainermn_torch.analysis.checkers.hotpath import HostSyncChecker
from chainermn_torch.analysis.checkers.recompile import RecompileChecker
from chainermn_torch.analysis.checkers.imports import ImportHygieneChecker
from chainermn_torch.analysis.checkers.names import ConsistencyChecker
from chainermn_torch.analysis.checkers.blocking import BlockingUnderLockChecker
from chainermn_torch.analysis.checkers.threads import ThreadLifecycleChecker


def all_checkers() -> list:
    """Fresh instances of every registered checker."""
    return [
        LockDisciplineChecker(),
        LockOrderChecker(),
        BlockingUnderLockChecker(),
        ThreadLifecycleChecker(),
        HostSyncChecker(),
        RecompileChecker(),
        ImportHygieneChecker(),
        ConsistencyChecker(),
    ]


__all__ = [
    "BlockingUnderLockChecker",
    "ConsistencyChecker",
    "HostSyncChecker",
    "ImportHygieneChecker",
    "LockDisciplineChecker",
    "LockOrderChecker",
    "RecompileChecker",
    "ThreadLifecycleChecker",
    "all_checkers",
]
