"""Concurrency analysis for the port: the runtime sanitizer
(:mod:`chainermn_torch.analysis.sanitizer`) that the fleet's and the
scheduler's locks are built through. The reference's static checkers
are not ported yet."""

from chainermn_torch.analysis import sanitizer

__all__ = ["sanitizer"]
