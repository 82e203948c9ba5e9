"""Elastic resharded restore (the port of ``chainermn_tpu/deploy/reshard.py``):
a snapshot saved at one tensor-parallel degree and world size resumes
at another.

A :class:`~chainermn_torch.extensions.sharded_checkpoint.ShardedCheckpointer`
snapshot already loads onto whatever placements the restore template has.
What it cannot know is the save-time **TP degree**: the fused qkv
weight's feature order is ``(rank, 3, local_head, d_head)``-major
(:class:`~chainermn_torch.parallel.tensor.TensorParallelAttention`), so
a degree change permutes it through the degree-free head order
(:func:`~chainermn_torch.parallel.tensor.reshard_tp_qkv`). The
reference's first step, a replicated gather, is free here: the port's
TP parameters are whole on every rank. What is left is the permutation,
applied to every leaf under a qkv parameter's name — the weight and
bias, and the optimizer's moments of them.

The optimizer moments need names: a ``torch.optim`` state dict keys its
state by parameter index. :func:`train_state_dict` saves the optimizer
through ``torch.distributed.checkpoint.state_dict``'s name-keyed form
(``{"state": {fqn: {...}}, "param_groups": ...}``), and
:func:`restore_train_state` loads it back by name into the optimizer
of the new world — which, for the multi-node wrapper, is the wrapper
around the NEW communicator. ZeRO state (rank-major shards) is saved a
rank under its own key and is not reshardable across world sizes, as in
the reference.

:func:`elastic_restore` reads the save-time degree and head geometry
from the snapshot's manifest (:func:`snapshot_meta`), and is the plain
restore, bit-exact, when the degrees agree. The ``deploy.reshard``
cut-point covers the decision.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from chainermn_torch.resilience.cutpoints import DEPLOY_RESHARD
from chainermn_torch.resilience.faults import inject

_QKV = ("attn.qkv.weight", "attn.qkv.bias")


def snapshot_meta(*, comm=None, model=None, **extra) -> dict:
    """The manifest a resharding restore needs, for
    ``ShardedCheckpointer.save(step, state, meta=...)``: the world size
    and mesh shape (from ``comm``), the TP degree, head geometry and
    whether the blocks are tensor-parallel (from ``model`` and ``comm``).
    Extra keys pass through."""
    meta = dict(extra)
    if comm is not None:
        meta["world_size"] = int(comm.size)
        mesh = getattr(comm, "mesh", None)
        if mesh is not None:
            meta["mesh_shape"] = tuple(int(s) for s in mesh.ranks.shape)
            meta["mesh_axes"] = tuple(str(a) for a in mesh.axis_names)
    if model is not None:
        meta["n_heads"] = int(model.n_heads)
        meta["d_head"] = int(model.d_model) // int(model.n_heads)
        meta["tp_degree"] = _tp_degree(model, comm)
        # the parameter names follow the blocks' kind (attn.qkv vs qkv)
        meta["tensor_parallel"] = model.tensor_axis is not None
    return meta


def _tp_degree(model, comm=None) -> int:
    """The size of ``model``'s tensor axis (1 without one)."""
    axis = getattr(model, "tensor_axis", None)
    if axis is None:
        return 1
    if isinstance(axis, str) and hasattr(comm, "axis_size"):
        return int(comm.axis_size(axis))
    from chainermn_torch.parallel.mesh import resolve_axis

    group = resolve_axis(axis)
    if group is None:
        raise ValueError(f"tensor axis {axis!r} is not bound: pass comm= or "
                         "tp_degree=")
    return int(group.size)


def _permute_qkv(tree: Any, heads: int, dh: int, old_tp: int,
                 new_tp: int) -> int:
    """Permute, in place, every tensor leaf of ``tree`` whose path names a
    qkv parameter (its weight, its bias, their optimizer moments); 0-dim
    leaves (a step count) stay. Returns how many were permuted."""
    import torch

    from chainermn_torch.parallel.tensor import reshard_tp_qkv

    n = 0

    def walk(node, path):
        nonlocal n
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node) if isinstance(node, (list, tuple))
                 else ())
        for k, v in items:
            p = f"{path}.{k}" if path else str(k)
            if isinstance(v, torch.Tensor):
                if v.dim() and any(q in p for q in _QKV):
                    key = "x." + next(q for q in _QKV if q in p)
                    v.copy_(reshard_tp_qkv({key: v}, heads, dh, old_tp,
                                           new_tp)[key])
                    n += 1
            else:
                walk(v, p)

    walk(tree, "")
    return n


def elastic_restore(
    checkpointer, template: Any, *, comm=None, model=None,
    step: Optional[int] = None, tp_degree: Optional[int] = None,
    n_heads: Optional[int] = None, d_head: Optional[int] = None,
) -> Tuple[Optional[Any], Optional[int]]:
    """Restore the newest (or ``step``-pinned) snapshot onto ``template``
    (filled in place), which may be of another TP degree than the
    snapshot.

    Returns ``(state, step)`` or ``(None, None)`` when there is no
    snapshot. The target degree comes from ``model`` and ``comm`` (or
    ``tp_degree``); the save-time degree and head geometry from the
    manifest, with ``n_heads``/``d_head`` (then ``model``) as fallback.
    When the degrees agree — manifest-less snapshots included — this is
    ``maybe_restore`` exactly; when they differ, every qkv leaf of the
    whole tree (parameters and optimizer moments) is permuted from the
    old degree's column order to the new one's."""
    new_tp = (int(tp_degree) if tp_degree is not None
              else _tp_degree(model, comm) if model is not None else 1)
    manifest = checkpointer.manifest(step) or {}
    old_tp = int(manifest.get("tp_degree", new_tp))
    inject(DEPLOY_RESHARD, old_tp=old_tp, new_tp=new_tp)

    if old_tp == new_tp:
        return checkpointer.maybe_restore(template, step=step)
    heads = n_heads if n_heads is not None else manifest.get("n_heads")
    dh = d_head if d_head is not None else manifest.get("d_head")
    if heads is None and hasattr(model, "n_heads"):
        heads = int(model.n_heads)
        dh = int(model.d_model) // int(model.n_heads)
    if heads is None or dh is None:
        raise ValueError(
            f"elastic restore across TP degrees ({old_tp} -> {new_tp}) "
            "needs the head geometry — save with meta=snapshot_meta(...) "
            "or pass n_heads/d_head explicitly")
    state, got_step = checkpointer.maybe_restore(template, step=step)
    if state is None:
        return None, None
    import torch

    with torch.no_grad():
        if not _permute_qkv(state, int(heads), int(dh), old_tp, new_tp):
            raise ValueError(
                "elastic restore found no tensor-parallel qkv leaf "
                "(attn.qkv.*) to permute — nothing was resharded")
    return state, got_step


def _inner(optimizer):
    return getattr(optimizer, "actual_optimizer", optimizer)


def _is_zero(optimizer) -> bool:
    from chainermn_torch.optimizers import ZeroOptimizer

    return isinstance(optimizer, ZeroOptimizer)


def _optimizer_state(model, optimizer):
    """The optimizer's state keyed by parameter name (its state made
    first if it has none yet); a ZeRO optimizer's inner state under this
    rank's own key."""
    from torch.distributed.checkpoint.state_dict import (
        _init_optim_state,
        get_optimizer_state_dict,
    )

    if _is_zero(optimizer):
        inner = optimizer.actual_optimizer
        _init_optim_state(inner)       # a zero-lr step makes the moments
        return {f"zero_rank{optimizer.communicator.rank}": inner.state_dict()}
    return get_optimizer_state_dict(model, _inner(optimizer))


def train_state_dict(model, optimizer) -> dict:
    """``{"params": model.state_dict(), "opt": ...}`` to save with
    :meth:`ShardedCheckpointer.save`: the optimizer's state keyed by
    parameter name, so a restore at another TP degree finds the qkv
    moments (and a multi-node wrapper's inner optimizer is what is
    saved). A ZeRO optimizer's state is saved under ``zero_rank{r}``."""
    return {"params": model.state_dict(),
            "opt": _optimizer_state(model, optimizer)}


def restore_train_state(
    checkpointer, *, model, optimizer, comm=None,
    params_template: Optional[dict] = None, step: Optional[int] = None,
    extra: Optional[dict] = None,
) -> Tuple[Optional[dict], Optional[int]]:
    """Elastic restore of a :func:`train_state_dict` snapshot into
    ``model`` and ``optimizer`` of the new world: ``optimizer`` is the
    new world's (``create_multi_node_optimizer(inner, new_comm)``, or a
    plain one for a TP step), ``model`` the new degree's. The parameters
    load in place (``params_template`` defaults to ``model.state_dict()``)
    and the moments by name. ``extra`` adds more template entries (e.g.
    ``{"it": 0}``). Returns ``(state, step)`` or ``(None, None)``.

    A ZeRO optimizer restores only at its save-time world size."""
    from torch.distributed.checkpoint.state_dict import (
        set_optimizer_state_dict,
    )

    if _is_zero(optimizer):
        saved = (checkpointer.manifest(step) or {}).get("world_size")
        now = optimizer.communicator.size
        if saved is not None and int(saved) != now:
            raise ValueError(
                f"ZeRO state is rank-major [n, shard] and is NOT elastically "
                f"reshardable across world sizes ({saved} -> {now}) — "
                "restore it at the same size, or checkpoint the gathered "
                "inner state instead")
    if params_template is None:
        params_template = model.state_dict()
    template = {"params": params_template,
                "opt": _optimizer_state(model, optimizer)}
    if extra:
        template.update(extra)
    state, got = elastic_restore(checkpointer, template, comm=comm,
                                 model=model, step=step)
    if state is None:
        return None, None
    model.load_state_dict(state["params"])   # a no-op copy when in place
    if _is_zero(optimizer):
        optimizer.actual_optimizer.load_state_dict(
            state["opt"][f"zero_rank{optimizer.communicator.rank}"])
    else:
        set_optimizer_state_dict(model, _inner(optimizer), state["opt"])
    return state, got


__all__ = ["elastic_restore", "restore_train_state", "snapshot_meta",
           "train_state_dict"]
