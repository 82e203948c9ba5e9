"""Fail-fast global exception hook (the port of
``chainermn_tpu/global_except_hook.py``).

ChainerMN's hook prints the traceback and calls ``MPI_Abort``, so one
rank's Python exception ends the whole job instead of leaving the other
ranks waiting inside a collective. NCCL and gloo collectives hang across
processes the same way; the abort here is a hard ``os._exit`` after the
traceback (and the port's event log, when it holds events) is written,
so the launcher sees the rank die and tears down the rest. Installing is
idempotent and chains: the previous hook still prints first.

Set ``CHAINERMN_TORCH_GLOBAL_EXCEPT_HOOK=1`` to install it at import.
"""

from __future__ import annotations

import os
import sys
import traceback

_installed = False


def _make_hook(prev_hook, exit_code: int):
    def _global_except_hook(exctype, value, tb):
        try:
            rank = os.environ.get("RANK", "?")
            sys.stderr.write(
                f"chainermn_torch: uncaught exception on rank {rank} — "
                "aborting the job to avoid deadlocked collectives\n")
            if prev_hook not in (None, sys.__excepthook__):
                prev_hook(exctype, value, tb)  # it owns the printing
            else:
                traceback.print_exception(exctype, value, tb)
            # the flight recorder: what the process was doing, when the
            # monitor was in use (a bare crash does not import it)
            mon = sys.modules.get("chainermn_torch.monitor")
            if mon is not None:
                try:
                    log = mon.get_event_log()
                    if log.tail():
                        log.dump(file=sys.stderr)
                except Exception:
                    pass
            sys.stderr.flush()
            sys.stdout.flush()
        finally:
            # the MPI_Abort analog: never hang in atexit or teardown
            os._exit(exit_code)

    return _global_except_hook


def add_hook(exit_code: int = 1) -> None:
    """Install the hook (the reference's ``add_hook``). Idempotent."""
    global _installed
    if _installed:
        return
    sys.excepthook = _make_hook(sys.excepthook, exit_code)
    _installed = True


if os.environ.get("CHAINERMN_TORCH_GLOBAL_EXCEPT_HOOK", "0") == "1":
    add_hook()


__all__ = ["add_hook"]
