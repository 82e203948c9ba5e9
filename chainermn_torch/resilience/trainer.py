"""Step-level exception boundary with checkpoint-restore recovery (the
port of ``chainermn_tpu/resilience/trainer.py``).

The reference's recovery story is fail-and-restart: the job dies, the
scheduler relaunches it, ``maybe_load`` resumes from the newest common
snapshot. :func:`resilient_fit` closes the loop inside one launch as
well: every training step runs inside an exception boundary that, on
failure, dumps the monitor flight recorder (once per failure episode:
the dump guard is shared with the watchdog and ``global_except_hook``),
restores the newest common :class:`~chainermn_torch.extensions.
checkpoint.MultiNodeCheckpointer` snapshot, and replays from there under
a bounded restore budget. Cross-launch resume falls out of the same
path: a fresh process calling :func:`resilient_fit` over the same
snapshot directory continues where the dead one stopped.

Bit-exact resume contract: a snapshot carries the full replay state, the
user ``state`` tree plus the iterator's ``state_dict()``, so the
post-resume loss trajectory is identical to an uninterrupted run.
Iteration ``k``'s snapshot holds the state after ``k`` steps with the
iterator positioned to draw batch ``k``; restore sets the loop index
back to ``k`` and the replayed steps recompute the same math
(``step_fn`` must be deterministic given ``(state, batch)``).

The port's state is a torch model's and optimizer's ``state_dict()``,
which returns the live tensors. The checkpointer's ``host_state`` copies
them to host numpy arrays before ``save``/``save_async`` returns, so the
next step's in-place update never reaches a snapshot; the boundary never
reuses the in-flight state after a failure (it always restores from
disk, through ``restore_hook``).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional

from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.monitor.trace import get_tracer
from chainermn_torch.resilience.cutpoints import TRAINER_STEP
from chainermn_torch.resilience.faults import inject
from chainermn_torch.resilience.retry import RetryPolicy


class ResilientTrainer:
    """Drive ``step_fn`` for ``n_steps`` with crash recovery.

    Parameters
    ----------
    step_fn : callable
        ``step_fn(state, batch) -> state`` over a ``state`` tree (dicts,
        lists and tuples of tensors, arrays and host scalars): for a torch
        model, step it in place and return ``{"model":
        model.state_dict(), "optimizer": optimizer.state_dict(), ...}``
        (live tensors, no copies; the snapshot copies them).
    checkpointer : MultiNodeCheckpointer
        Owns snapshot naming, GC, checksum verification, and the
        cross-rank newest-common-iteration agreement.
    save_every : int
        Snapshot cadence in steps (a snapshot is also taken at iteration
        0 — before any batch — so a failure before the first periodic
        save still has a restore point; and at ``n_steps``).
    max_restores : int
        Recovery budget; the failure that exhausts it re-raises.
    retry : RetryPolicy, optional
        Wrapped around checkpoint save/load I/O (host-transient faults
        get absorbed before they count as a training failure). Default: 3
        attempts.
    dump_on_failure : bool
        Dump the flight recorder (once per failure episode) to stderr at
        the boundary.
    restore_hook : callable, optional
        ``restore_hook(state) -> state`` applied to every snapshot-loaded
        state (resume and recovery alike) before stepping. Snapshots hold
        host numpy arrays (:func:`~chainermn_torch.extensions.checkpoint.
        host_state`); for a torch model the hook loads them back in place
        (``model.load_state_dict(to_tensors(state["model"]))`` and the
        optimizer's likewise) and returns the live state again.
    async_save : bool
        Snapshot via ``checkpointer.save_async``: the loop blocks only on
        the ``host_state`` copy (the consistency point: ``state_dict()``
        returns the live tensors, which the next step overwrites, so the
        copy must finish before ``save_async`` returns) while serialization +
        disk write + GC run on the checkpointer's writer thread. The
        snapshot CONTENT is identical to the sync path, so resume stays
        bit-exact. Recovery never races a pending write (``maybe_load``
        joins first), and :meth:`fit` closes with a ``wait_async`` so the
        final snapshot is durable — a writer failure raises there. With
        async saves the trainer-level ``retry`` only covers enqueue-time
        faults; give write-retry budget to the CHECKPOINTER
        (``MultiNodeCheckpointer(retry=...)``), which applies it on the
        writer thread.
    """

    def __init__(self, step_fn: Callable, checkpointer, *,
                 save_every: int = 10, max_restores: int = 3,
                 retry: Optional[RetryPolicy] = None,
                 dump_on_failure: bool = True,
                 restore_hook: Optional[Callable] = None,
                 async_save: bool = False) -> None:
        if save_every < 1:
            raise ValueError(f"save_every must be >= 1, got {save_every}")
        self.step_fn = step_fn
        self.checkpointer = checkpointer
        self.save_every = int(save_every)
        self.max_restores = int(max_restores)
        self.retry = retry if retry is not None else RetryPolicy(3)
        self.dump_on_failure = dump_on_failure
        self.restore_hook = restore_hook
        self.async_save = bool(async_save)
        if self.async_save and not hasattr(checkpointer, "save_async"):
            raise TypeError(
                f"async_save=True needs a checkpointer with save_async(); "
                f"{type(checkpointer).__name__} has none")
        reg = get_registry()
        self._c_failures = reg.counter("trainer_failures_total")
        self._c_restores = reg.counter("trainer_restores_total")
        self._h_mttr = reg.histogram("trainer_mttr_seconds", unit="s")
        self._events = get_event_log()
        self._tracer = get_tracer()
        # one trace per failure EPISODE (first failure -> first completed
        # post-restore step): its root span IS the MTTR interval, its
        # children attribute the recovery (flight dump, snapshot load,
        # replay). Error-marked, so sampling never drops it.
        self._episode = None

    # -- checkpoint plumbing --------------------------------------------- #

    def _save(self, state, iterator, iteration: int) -> None:
        # ambient span: with async_save the enqueue (the host_state copy)
        # is the only critical-path cost and the step trace shows exactly it
        with self._tracer.span("checkpoint_enqueue", iteration=iteration,
                               asynchronous=self.async_save):
            snap = {"state": state, "iterator": iterator.state_dict()}
            save = (self.checkpointer.save_async if self.async_save
                    else self.checkpointer.save)
            self.retry.call(save, snap, iteration, op="checkpoint.save")
        self._events.emit("trainer_snapshot", iteration=iteration,
                          asynchronous=self.async_save)

    def _load(self):
        return self.retry.call(self.checkpointer.maybe_load,
                               op="checkpoint.load")

    def _restore_state(self, state):
        return state if self.restore_hook is None else \
            self.restore_hook(state)

    def _episode_label(self) -> dict:
        if self._episode is not None and self._episode.enabled:
            return {"trace": self._episode.trace_id}
        return {}

    def _finish_episode(self, **labels) -> None:
        if self._episode is not None:
            self._episode.finish(**labels)
            self._episode = None

    # -- the loop -------------------------------------------------------- #

    def fit(self, state, iterator, n_steps: int, *,
            on_step: Optional[Callable] = None) -> tuple:
        """Run to ``n_steps`` total iterations (resuming included);
        returns ``(state, report)`` where ``report`` carries
        ``resumed_from`` / ``failures`` / ``restores`` / per-recovery
        ``mttr_s`` (failure to first completed post-restore step) and the
        checkpointer's save/load timing stats."""
        loaded, start = self._load()
        if loaded is not None:
            state = self._restore_state(loaded["state"])
            iterator.load_state_dict(loaded["iterator"])
            if start:
                self._events.emit("trainer_resume", iteration=start)
        else:
            # iteration-0 restore point: initial state, untouched iterator
            self._save(state, iterator, 0)
        resumed_from = start
        failures = restores = 0
        mttr: list = []
        t_fail: Optional[float] = None
        i = start
        while i < n_steps:
            # per-step span tree (ambient): prefetch-wait, dispatch, and
            # — on saving steps — the checkpoint enqueue, same taxonomy
            # as training.fit; a failed step's trace is error-marked so
            # sampling keeps it
            with self._tracer.trace("train_step", kind="train", step=i,
                                    loop="resilient") as step_tr:
                try:
                    inject(TRAINER_STEP, step=i)
                    with self._tracer.span("prefetch_wait"):
                        batch = next(iterator)
                    with self._tracer.span("dispatch"):
                        state = self.step_fn(state, batch)
                except Exception as e:  # noqa: BLE001 — recovery boundary
                    step_tr.mark_error(type(e).__name__)
                    failures += 1
                    self._c_failures.inc()
                    if t_fail is None:
                        # first failure of the episode: open the MTTR
                        # trace (root = failure -> first recovered step)
                        t_fail = time.perf_counter()
                        self._episode = self._tracer.trace(
                            "failure_episode", kind="resilience", step=i,
                            error=type(e).__name__)
                        self._episode.mark_error(type(e).__name__)
                    ep = self._episode
                    self._events.emit("trainer_failure", step=i,
                                      error=type(e).__name__,
                                      detail=str(e)[:200],
                                      **self._episode_label())
                    if self.dump_on_failure:
                        with ep.span("flight_dump"):
                            get_event_log().dump(file=sys.stderr,
                                                 once="failure")
                    if restores >= self.max_restores:
                        self._events.emit("trainer_giving_up", step=i,
                                          restores=restores,
                                          **self._episode_label())
                        self._finish_episode(gave_up=True)
                        raise
                    with ep.span("restore", attempt=restores + 1):
                        loaded, it_r = self._load()
                        if loaded is None:
                            # no snapshot anywhere: nothing to restore
                            self._finish_episode(gave_up=True)
                            raise
                        state = self._restore_state(loaded["state"])
                        iterator.load_state_dict(loaded["iterator"])
                    i = it_r
                    restores += 1
                    self._c_restores.inc()
                    self._events.emit("trainer_restore", iteration=it_r,
                                      restores=restores,
                                      **self._episode_label())
                    get_event_log().reset_dump_guard()  # next dump is new
                    continue
                if t_fail is not None:
                    dt = time.perf_counter() - t_fail
                    mttr.append(dt)
                    self._h_mttr.observe(dt)
                    self._events.emit("trainer_recovered", step=i,
                                      mttr_s=round(dt, 6),
                                      **self._episode_label())
                    # the episode's root span closes HERE: its duration
                    # IS the MTTR (failure -> first completed step)
                    self._finish_episode(mttr_s=round(dt, 6),
                                         recovered_step=i)
                    t_fail = None
                if on_step is not None:
                    on_step(i, state)
                i += 1
                if i % self.save_every == 0 or i == n_steps:
                    self._save(state, iterator, i)
        if self.async_save:
            # end-of-run barrier: the final snapshot must be durable (and
            # any writer failure loud) before the run reports success
            self.checkpointer.wait_async()
        report = {
            "steps": int(n_steps),
            "resumed_from": int(resumed_from),
            "failures": int(failures),
            "restores": int(restores),
            "mttr_s": mttr,
            "checkpoint_stats": self.checkpointer.get_stats(),
        }
        return state, report


def resilient_fit(step_fn: Callable, state, iterator, n_steps: int,
                  checkpointer, *, on_step: Optional[Callable] = None,
                  **kwargs) -> tuple:
    """One-call form of :class:`ResilientTrainer` (see its docstring):
    ``state, report = resilient_fit(step, state, it, N, ckpt)``."""
    trainer = ResilientTrainer(step_fn, checkpointer, **kwargs)
    return trainer.fit(state, iterator, n_steps, on_step=on_step)


__all__ = ["ResilientTrainer", "resilient_fit"]
