"""Sharded checkpointing (the port of
``chainermn_tpu/extensions/sharded_checkpoint.py``), built on
``torch.distributed.checkpoint`` (DCP) where the reference uses orbax.

A snapshot is one DCP directory ``<path>/<step>``:

- each rank writes only what it owns. DCP's default planner dedups a
  plain tensor that several ranks hold under one key, so the port's
  Megatron parameters, whole on every rank
  (:mod:`chainermn_torch.parallel.tensor`), are written once, not once a
  rank; an FSDP2 ``DTensor`` (:mod:`chainermn_torch.parallel.fsdp`) is
  written as its shards;
- restore loads onto the **template's** placements: the template's
  tensors are filled in place on their own devices, a ``DTensor`` on its
  own mesh and placements, whatever the save-time layout was;
- snapshots are step-stamped and the ``keep`` newest are kept.

Every save also writes a small **manifest** sidecar (save-time TP
degree, head geometry, world size, caller meta): a pickled dict with the
CRC32 footer of :mod:`chainermn_torch.extensions.checkpoint` — the same
bytes as the reference's ``_add_footer`` — written atomically (tmp +
rename) by rank 0 after every rank's write, under ``<path>.meta/``. A
corrupt manifest reads as absent. An optional
:class:`~chainermn_torch.resilience.retry.RetryPolicy` wraps the save and
load I/O (``sharded_checkpoint.save`` / ``sharded_checkpoint.load``),
and both carry their fault-injection cut-points.

The manifest format is shared with the JAX package; the tensors are not:
an orbax tree and a DCP directory are different formats, and neither
package reads the other's.
"""

from __future__ import annotations

import os
import pickle
import shutil
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

from chainermn_torch.extensions.checkpoint import _add_footer, _strip_footer
from chainermn_torch.resilience.cutpoints import (
    SHARDED_CHECKPOINT_LOAD,
    SHARDED_CHECKPOINT_SAVE,
)
from chainermn_torch.resilience.faults import inject


def _dcp():
    """``torch.distributed.checkpoint``, imported at the first save or
    load: importing it takes 1.4 s on a workstation and ~6 s on the card
    host (``torch.distributed.tensor``, sympy), which every process that
    imports ``chainermn_torch`` would otherwise pay."""
    import torch.distributed.checkpoint as dcp

    return dcp


def _map_tensors(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class ShardedCheckpointer:
    """Step-stamped sharded snapshots under ``path``.

    Usage (every rank of ``process_group``, default the whole world,
    calls each method)::

        cp = ShardedCheckpointer("/ckpts/run1", keep=3)
        cp.save(step, {"params": model.state_dict(), "opt": opt_state})
        restored, step = cp.maybe_restore(
            {"params": model.state_dict(), "opt": opt_state})   # in place
    """

    def __init__(self, path: str, keep: int = 3, *, retry=None,
                 process_group=None) -> None:
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._path = os.path.abspath(path)
        self._keep = int(keep)
        self._retry = retry
        self._pg = process_group
        self._meta_dir = self._path + ".meta"
        self._pending = None
        os.makedirs(self._path, exist_ok=True)

    def _call(self, fn, *args, op: str):
        if self._retry is not None:
            return self._retry.call(fn, *args, op=op)
        return fn(*args)

    def _dist(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    def _rank(self) -> int:
        return dist.get_rank(self._pg) if self._dist() else 0

    def _barrier(self) -> None:
        if self._dist():
            dist.barrier(group=self._pg)

    def _dcp_kw(self) -> dict:
        if self._dist():
            return {"process_group": self._pg}
        return {"no_dist": True}

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._path, str(int(step)))

    # ------------------------------------------------------------------ #
    # save                                                                #
    # ------------------------------------------------------------------ #

    def save(self, step: int, state: Any, *, wait: bool = True,
             meta: Optional[dict] = None) -> None:
        """Write a snapshot of ``state`` (a dict tree of tensors, DTensors
        and picklable leaves) at ``step``; each rank writes what it owns.
        ``meta`` (TP degree, head geometry, anything picklable) lands in
        the step's manifest. ``wait=False`` returns once DCP has staged
        the tensors in host memory (``dcp.async_save``) and its writer
        writes the files; :meth:`wait_until_finished` (or the next save,
        or ``close``) joins it, then writes the manifest and GCs."""
        self.wait_until_finished()
        step = int(step)
        target = self._step_dir(step)

        def write():
            dcp = _dcp()
            inject(SHARDED_CHECKPOINT_SAVE, step=step)
            if wait:
                dcp.save(state, checkpoint_id=target, **self._dcp_kw())
                return None
            return dcp.async_save(state, checkpoint_id=target,
                                  **self._dcp_kw())

        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*single process.*")
            future = self._call(write, op="sharded_checkpoint.save")
        if future is None:
            self._finish(step, meta or {})
        else:
            self._pending = (future, step, meta or {})

    def wait_until_finished(self) -> None:
        """Join a ``wait=False`` save (a no-op when none is pending)."""
        if self._pending is None:
            return
        future, step, meta = self._pending
        self._pending = None
        future.result()
        self._finish(step, meta)

    def _finish(self, step: int, meta: dict) -> None:
        """After every rank's write: rank 0 writes the manifest and drops
        the snapshots past the ``keep`` newest."""
        self._barrier()
        if self._rank() == 0:
            self._write_manifest(step, meta)
            for old in self.all_steps()[:-self._keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
            self._gc_manifests()
        self._barrier()

    def _write_manifest(self, step: int, meta: dict) -> None:
        os.makedirs(self._meta_dir, exist_ok=True)
        payload = pickle.dumps(dict(meta, step=int(step)))
        final = self._manifest_path(step)
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_add_footer(payload))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    def _gc_manifests(self) -> None:
        live = set(self.all_steps())
        for name in os.listdir(self._meta_dir):
            if not name.startswith("manifest_") or name.endswith(".tmp"):
                continue
            try:
                s = int(name[len("manifest_"):].split(".", 1)[0])
            except ValueError:
                continue
            if s not in live:
                try:
                    os.remove(os.path.join(self._meta_dir, name))
                except OSError:
                    pass

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._meta_dir, f"manifest_{int(step)}.bin")

    def manifest(self, step: Optional[int] = None) -> Optional[dict]:
        """The manifest saved with ``step`` (the newest when ``None``), or
        ``None`` when there is none or it is corrupt (a bad checksum is
        absence, never trusted)."""
        if step is None:
            steps = self.all_steps()
            if not steps:
                return None
            step = steps[-1]
        path = self._manifest_path(step)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            payload, verified = _strip_footer(f.read())
        if verified is False:
            return None
        try:
            return pickle.loads(payload)
        except Exception:  # noqa: BLE001 — corrupt == absent
            return None

    # ------------------------------------------------------------------ #
    # restore                                                             #
    # ------------------------------------------------------------------ #

    def maybe_restore(self, template: Any, *, shardings=None,
                      step: Optional[int] = None,
                      ) -> tuple[Optional[Any], Optional[int]]:
        """Restore a snapshot onto ``template``'s layout.

        Returns ``(state, step)``, or ``(None, None)`` when there is no
        snapshot. ``template`` gives the structure, shapes, dtypes and
        placements (pass the live state you would otherwise initialise):
        its tensors are filled **in place**, each on its own device, a
        ``DTensor`` as its own shards, and ``state`` is the template's
        tree with its other leaves replaced by the saved ones. Keys the
        snapshot holds and the template does not are left out.
        ``shardings``, a device, loads every plain tensor onto fresh
        tensors on that device instead (e.g. ``"cpu"``). ``step`` pins a
        snapshot (the newest when ``None``)."""
        if step is None:
            steps = self.all_steps()
            if not steps:
                return None, None
            step = steps[-1]
        step = int(step)
        if shardings is not None:
            dev = torch.device(shardings)
            template = _map_tensors(
                template, lambda t: t if _is_dtensor(t) else
                torch.empty(t.shape, dtype=t.dtype, device=dev))
        state = _map_tensors(template, lambda t: t)    # a new tree, same leaves

        def load():
            dcp = _dcp()
            inject(SHARDED_CHECKPOINT_LOAD, step=step)
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*single process.*")
                dcp.load(state, checkpoint_id=self._step_dir(step),
                         **self._dcp_kw())

        self._call(load, op="sharded_checkpoint.load")
        return state, step

    def all_steps(self) -> list[int]:
        """The steps with a complete snapshot (DCP's ``.metadata``
        written), ascending."""
        out = []
        for name in os.listdir(self._path):
            if name.isdigit() and os.path.exists(
                    os.path.join(self._path, name, ".metadata")):
                out.append(int(name))
        return sorted(out)

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


__all__ = ["ShardedCheckpointer"]
