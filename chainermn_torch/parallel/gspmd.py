"""Megatron tensor parallelism as a layout, weights at rest (the port of
``chainermn_tpu/parallel/gspmd.py``).

The JAX package keeps the dense ``TransformerLM`` code, annotates each
parameter with its Megatron partition and lets XLA's partitioner insert
the collectives. PyTorch has no partitioner, so here the layout and the
collectives are explicit, and the contract is the reference's:

- :func:`megatron_shard` cuts the dense model's parameters in place so
  that each rank stores only its shard of every leaf the table below
  names (optimizer state created afterwards is sharded with them), and
  :func:`megatron_opt_shard` cuts state an optimizer already holds;
- :func:`gspmd_lm_train_step` runs the dense model's computation over
  those shards: Megatron's *f*/*g* around each block's attention and
  FFN, a masked lookup plus a sum all-reduce for the vocab-sharded
  embedding, an all-gather of the vocab-sharded logits for the
  replicated cross entropy, and for ``moe_impl='gshard'`` each rank's
  experts' share of the dispatch and combine summed over the axis. Its
  loss equals the replicated model's.

Leaf table (``gspmd.py:29-41`` over the port's names; ``n`` the axis
size). A rule whose dimension does not divide by ``n`` leaves its group
replicated, as the partitioner would:

=============================  ===============  ==========================
leaf                           shape            sharded over
=============================  ===============  ==========================
``blocks.i.qkv.weight``        ``[3*H*Dh, d]``  heads, in each of q, k, v
``blocks.i.qkv.bias``          ``[3*H*Dh]``     heads, in each of q, k, v
``blocks.i.proj.weight``       ``[d, H*Dh]``    dim 1 (heads)
``blocks.i.fc1.weight|bias``   ``[ff, d]``      dim 0
``blocks.i.fc2.weight``        ``[d, ff]``      dim 1
``lm_head.weight|bias``        ``[V, d]``       dim 0 (vocab)
``embed.weight``               ``[V, d]``       dim 0 (vocab)
``blocks.i.moe.w1|b1|w2|b2``   ``[E, ...]``     dim 0 (experts)
=============================  ===============  ==========================

LayerNorms, ``pos_embed``, ``proj.bias``, ``fc2.bias`` and the MoE gate
stay replicated on purpose.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from chainermn_torch.functions.collective_communication import (
    copy_to_parallel_region,
    reduce_from_parallel_region,
)
from chainermn_torch.parallel.moe import drop_frac_from_sown

_KNOWN_REPLICATED = ("pos_embed.weight", "proj.bias", "fc2.bias",
                     "moe.gate.weight", "moe.gate.bias")
# unmatched replicated bytes above this warn (strict raises on any)
_UNMATCHED_WARN_BYTES = 1 << 20


def _rule(name: str, shape, n_heads: int):
    """``(sharded dim or 'heads', size along it)`` of the rule that names
    leaf ``name``, or ``None`` when no rule does."""
    def ends(*tails):
        return name.endswith(tails)

    if ends("qkv.weight", "qkv.bias") and not ends("attn.qkv.weight",
                                                   "attn.qkv.bias"):
        return "heads", n_heads
    if ends("proj.weight") and len(shape) == 2:
        return 1, n_heads
    if ends("fc1.weight", "fc1.bias", "lm_head.weight", "lm_head.bias") \
            or name == "embed.weight":
        return 0, shape[0]
    if ends("fc2.weight") and len(shape) == 2:
        return 1, shape[1]
    if ends("moe.w1", "moe.b1", "moe.w2", "moe.b2"):
        return 0, shape[0]
    return None


def megatron_param_specs(model, n_tp: int, *, strict: bool = False,
                         report: bool = False):
    """Per-leaf layout of a dense ``TransformerLM`` (``gspmd.py:148``):
    ``{name: spec}`` with ``spec`` the sharded dimension (``'heads'`` for
    qkv, whose heads are cut within each of q, k and v) or ``None`` for a
    replicated leaf. Matching is by name, so a leaf no rule names and the
    known-replicated list does not hold is reported: ``strict=True``
    raises on any, otherwise a warning fires past ~1 MiB of them.
    ``report=True`` returns ``(specs, {'paths': ..., 'bytes': ...})`` by
    status (sharded, undividable, known_replicated, unmatched)."""
    specs = {}
    rep = {s: [] for s in
           ("sharded", "undividable", "known_replicated", "unmatched")}
    nbytes = dict.fromkeys(rep, 0)
    for name, p in model.named_parameters():
        rule = _rule(name, tuple(p.shape), model.n_heads)
        if rule is None:
            status = ("known_replicated" if name.endswith(_KNOWN_REPLICATED)
                      or ".ln" in f".{name}" else "unmatched")
            spec = None
        elif rule[1] % n_tp:
            status, spec = "undividable", None
        else:
            status, spec = "sharded", rule[0]
        specs[name] = spec
        rep[status].append(name)
        nbytes[status] += p.numel() * p.element_size()
    if rep["unmatched"]:
        msg = (f"megatron_param_specs: {len(rep['unmatched'])} leaves "
               f"({nbytes['unmatched']} bytes) matched no sharding rule and "
               "are not known-replicated — they will be stored REPLICATED "
               f"on every rank: {rep['unmatched'][:8]}")
        if strict:
            raise ValueError(msg)
        if nbytes["unmatched"] > _UNMATCHED_WARN_BYTES:
            warnings.warn(msg, stacklevel=2)
    return (specs, {"paths": rep, "bytes": nbytes}) if report else specs


def _cut(t, spec, rank: int, n: int, n_heads: int):
    """This rank's shard of ``t`` under ``spec``."""
    if spec == "heads":
        rest = t.shape[1:]
        v = t.reshape(3, n_heads, -1, *rest)
        lh = n_heads // n
        return v[:, rank * lh:(rank + 1) * lh].reshape(-1, *rest)
    size = t.shape[spec] // n
    return t.narrow(spec, rank * size, size)


def shard_state_dict(state_dict: dict, specs: dict, rank: int, n: int,
                     n_heads: int) -> dict:
    """Rank ``rank``'s shards (of ``n``) of a dense LM ``state_dict`` under
    ``specs`` (:func:`megatron_param_specs`): what JAX's
    ``sharding.shard_shape`` gives that rank, in the port's layouts."""
    return {k: (v if specs.get(k) is None
                else _cut(v, specs[k], rank, n, n_heads).clone())
            for k, v in state_dict.items()}


def _tp_axis(comm, tp_axis: Optional[str]):
    """The tensor axis's communicator: ``comm`` itself for a flat one, its
    ``tp_axis`` group for a mesh (``gspmd.py:192``)."""
    axes = getattr(comm, "axis_name", None)
    if isinstance(axes, tuple):
        if tp_axis is None or tp_axis not in axes:
            raise ValueError(f"multi-axis mesh {axes!r}: pass tp_axis= "
                             "naming the tensor axis")
        return comm.axis(tp_axis)
    if tp_axis is not None:
        raise ValueError(f"tp_axis {tp_axis!r} given for a flat "
                         "communicator: it is the tensor axis itself")
    return comm


@torch.no_grad()
def megatron_shard(model, comm, tp_axis: Optional[str] = None):
    """Cut ``model``'s parameters in place to this rank's Megatron shards
    (``gspmd.py:206``): each named leaf keeps only its shard (the whole
    tensor is freed), replicated leaves stay. Build the optimizer after
    this, or cut its state with :func:`megatron_opt_shard`. Returns
    ``model``; its dense ``forward`` refuses to run from then on — the
    step (or :func:`sharded_forward`) runs it."""
    ax = _tp_axis(comm, tp_axis)
    if getattr(model, "_megatron_axis", None) is not None:
        raise ValueError("model is already in the Megatron layout")
    specs = megatron_param_specs(model, ax.size)
    for name, p in model.named_parameters():
        if specs[name] is not None:
            p.megatron_full_shape = tuple(p.shape)
            p.data = _cut(p.data, specs[name], ax.rank, ax.size,
                          model.n_heads).clone()
    model._megatron_axis = ax
    model._megatron_specs = specs
    return model


@torch.no_grad()
def megatron_opt_shard(optimizer, model):
    """Co-shard the state ``optimizer`` already holds with ``model``'s
    parameters after :func:`megatron_shard` (``gspmd.py:231``): every
    state tensor shaped like its parameter's whole leaf is cut the same
    way; step counts and scalars stay. Returns ``optimizer``."""
    ax = model._megatron_axis
    specs = dict(model._megatron_specs)
    for name, p in model.named_parameters():
        if specs[name] is None or p not in optimizer.state:
            continue
        st = optimizer.state[p]
        for k, v in st.items():
            if torch.is_tensor(v) and tuple(v.shape) == p.megatron_full_shape:
                st[k] = _cut(v, specs[name], ax.rank, ax.size,
                             model.n_heads).clone()
    return optimizer


class _GatherVocab(torch.autograd.Function):
    """The vocab shards of the logits gathered along the last axis; the
    backward keeps this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm, ctx.width = comm, x.shape[-1]
        parts = comm.allgather(x)                    # [n, ..., V/n]
        return torch.cat(list(parts.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, w = ctx.comm.rank, ctx.width
        return g[..., r * w:(r + 1) * w].contiguous(), None


def _cut_leaf(p) -> bool:
    """Whether :func:`megatron_shard` cut ``p`` to a shard."""
    return hasattr(p, "megatron_full_shape")


def _block(blk, x, ax):
    """One dense block over its held shards; ``(x, aux)``. A group whose
    leaves were cut runs between Megatron's *f* and *g*; one left whole
    (undividable) runs as the dense block does."""
    from chainermn_torch.models.transformer import _dense, _layer_norm

    dt = blk.compute_dtype
    b, t, _ = x.shape
    dh = blk.d_model // blk.n_heads
    cut = _cut_leaf(blk.qkv.weight)
    h = _layer_norm(blk.ln1, x, dt)
    lh = blk.qkv.weight.shape[0] // (3 * dh)
    qkv = _dense(blk.qkv, copy_to_parallel_region(h, ax) if cut else h,
                 dt).view(b, t, 3, lh, dh)
    o = blk._attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    o = F.linear(o.reshape(b, t, lh * dh), blk.proj.weight.to(dt))
    if cut:
        o = reduce_from_parallel_region(o, ax)
    x = x + (o + blk.proj.bias.to(dt))
    h = _layer_norm(blk.ln2, x, dt)
    if blk.moe_experts:
        y, aux = blk.moe(h, axis=ax if _cut_leaf(blk.moe.w1) else None)
        return x + y, aux
    cut = _cut_leaf(blk.fc1.weight)
    h = _dense(blk.fc1, copy_to_parallel_region(h, ax) if cut else h, dt)
    y = F.linear(F.gelu(h, approximate="tanh"), blk.fc2.weight.to(dt))
    if cut:
        y = reduce_from_parallel_region(y, ax)
    return x + (y + blk.fc2.bias.to(dt)), torch.zeros((), device=x.device)


def sharded_forward(model, tokens, *, return_aux: bool = False):
    """The dense LM's forward (``attention`` 'full' or 'flash', no
    sequence or tensor axis) over the shards :func:`megatron_shard` left:
    float32 logits ``[B, T, vocab]`` on every rank, and the summed aux
    loss with ``return_aux``. The model's ``remat`` recomputes each block
    in the backward, its collectives included."""
    from chainermn_torch.models.transformer import _dense, _layer_norm

    ax = model._megatron_axis
    dt = model.compute_dtype
    tokens = tokens.to(model.device).long()
    emb = model.embed.weight
    if not _cut_leaf(emb):
        x = F.embedding(tokens, emb).to(dt)
    else:
        local = tokens - ax.rank * emb.shape[0]
        inside = (local >= 0) & (local < emb.shape[0])
        x = F.embedding(local.clamp(0, emb.shape[0] - 1), emb).to(dt)
        x = reduce_from_parallel_region(x * inside[..., None].to(dt), ax)
    pos = torch.arange(tokens.shape[1], device=model.device)
    x = x + F.embedding(pos, model.pos_embed.weight).to(dt)[None]
    aux = torch.zeros((), device=model.device)
    remat = model.remat and torch.is_grad_enabled()
    for blk in model.blocks:
        x, a = (checkpoint(_block, blk, x, ax, use_reentrant=False)
                if remat else _block(blk, x, ax))
        aux = aux + a
    x = _layer_norm(model.ln_f, x, dt)
    head = model.lm_head
    if not _cut_leaf(head.weight):
        logits = _dense(head, x, dt).float()
    else:
        logits = _dense(head, copy_to_parallel_region(x, ax), dt).float()
        logits = _GatherVocab.apply(logits, ax)
    return (logits, aux) if return_aux else logits


def gspmd_lm_train_step(model, optimizer, comm, tp_axis: Optional[str] = None,
                        dp_axis: Optional[str] = None,
                        moe_aux_weight: float = 0.01) -> Callable:
    """The weights-at-rest Megatron LM step (``gspmd.py:246``):
    ``step(tokens, targets) -> (loss, stats)``, ``stats`` ``{}`` for a
    dense model and ``{'moe_drop_frac': ...}`` for a gshard-MoE one.

    ``model`` is the DENSE ``TransformerLM`` (no ``tensor_axis`` or
    ``sequence_axis``; MoE only as ``moe_impl='gshard'``), placed with
    :func:`megatron_shard` (the step places it when it is not yet), and
    ``optimizer`` a plain ``torch.optim`` optimizer over its parameters.
    ``comm`` is the tensor axis itself (a flat communicator: the batch is
    replicated, pure TP), or a
    :class:`~chainermn_torch.communicators.MeshCommunicator` with
    ``tp_axis`` naming the tensor axis and ``dp_axis`` the axis each rank
    takes its batch shard over. After the backward a sharded leaf holds
    its shard's whole gradient and a replicated leaf the same gradient on
    every tensor rank; the step averages them over the data ranks (the
    replicated ones over all ranks), then updates."""
    if getattr(model, "tensor_axis", None) is not None or (
            getattr(model, "sequence_axis", None) is not None):
        raise ValueError(
            "gspmd_lm_train_step takes the DENSE model: the step derives the "
            "TP collectives from the parameter layout — rebuild without "
            "tensor_axis/sequence_axis")
    moe = bool(getattr(model, "moe_experts", 0))
    if moe and getattr(model, "moe_impl", "ep") != "gshard":
        raise ValueError(
            "MoE under the gspmd step needs moe_impl='gshard' (the 'ep' "
            "experts exchange tokens over their own axis)")
    if getattr(comm, "allreduce_grad_dtype", None) is not None:
        warnings.warn(
            "gspmd_lm_train_step ignores the communicator's "
            f"allreduce_grad_dtype={comm.allreduce_grad_dtype!r}: this "
            "step's collectives run in the tensors' own dtypes", stacklevel=2)
    if getattr(model, "_megatron_axis", None) is None:
        megatron_shard(model, comm, tp_axis)
    elif model._megatron_axis is not _tp_axis(comm, tp_axis):
        raise ValueError("model was sharded over another tensor axis")
    dp = None
    if dp_axis is not None:
        if not isinstance(getattr(comm, "axis_name", None), tuple):
            raise ValueError("dp_axis needs a MeshCommunicator")
        dp = comm.axis(dp_axis)
    sharded = [p for p in model.parameters() if _cut_leaf(p)]
    replicated = [p for p in model.parameters() if not _cut_leaf(p)]

    def mean_into(params, group):
        live = [p for p in params if p.grad is not None]
        for p, g in zip(live, group.multi_node_mean_grad(
                [p.grad for p in live])):
            p.grad = g

    def step(tokens, targets):
        dev = model.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        optimizer.zero_grad(set_to_none=True)
        logits, aux = sharded_forward(model, tokens, return_aux=True)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1))
        loss = ce + moe_aux_weight * aux
        loss.backward()
        mean_into(replicated, comm)
        if dp is not None:
            mean_into(sharded, dp)
        optimizer.step()
        loss = loss.detach()
        if dp is not None:
            loss = dp.allreduce(loss, "mean")
        if not moe:
            return loss, {}
        return loss, {"moe_drop_frac": drop_frac_from_sown(
            model.moe_stats())}

    return step


def stored_fraction(model, optimizer=None) -> dict:
    """Elements this rank stores over the replicated model's: of the
    parameters, of the optimizer's state tensors, and the share the
    replicated leaves alone take of the whole model (``n_elements``: the
    replicated model's parameter count)."""
    full = sum(_full_numel(p) for p in model.parameters())
    held = sum(p.numel() for p in model.parameters())
    rep = sum(p.numel() for p in model.parameters() if not _cut_leaf(p))
    out = {"params": held / full, "replicated_share": rep / full,
           "n_elements": full}
    if optimizer is not None:
        o_full = o_held = 0
        for p in model.parameters():
            for v in optimizer.state.get(p, {}).values():
                if torch.is_tensor(v) and v.shape == p.shape and v.dim():
                    o_full += _full_numel(p)
                    o_held += v.numel()
        out["opt"] = o_held / max(o_full, 1)
    return out


def _full_numel(p) -> int:
    return math.prod(getattr(p, "megatron_full_shape", p.shape))


__all__ = ["gspmd_lm_train_step", "megatron_opt_shard",
           "megatron_param_specs", "megatron_shard", "shard_state_dict",
           "sharded_forward", "stored_fraction"]
