"""Megatron tensor parallelism over a group (the port of
``chainermn_tpu/parallel/tensor.py``).

As in the reference, parameters keep their **global** shapes and are
stored whole on every rank; each rank slices its block at apply time by
its index on the tensor axis. So one converter serves both packages, and
a checkpoint is the dense model's tree (up to the qkv column order, see
:func:`reshard_tp_qkv`). The forward collectives are explicit: Megatron's
*f* (:func:`~chainermn_torch.functions.copy_to_parallel_region`) where a
replicated activation enters a column-parallel layer, *g*
(:func:`~chainermn_torch.functions.reduce_from_parallel_region`) closing a
row-parallel one — one all-reduce per MLP and one per attention block.

Gradients: after the backward every rank holds the full gradient of each
replicated-compute leaf (LayerNorms, embeddings, row biases) and the
zero-padded slice gradient of each sliced leaf (marked
``tensor_parallel_sliced``). The exact global gradient is the psum of the
sliced leaves over the tensor axis and the mean of everything over the
data ranks; :func:`chainermn_torch.training.lm_train_step` assembles it
(the reference's global-objective pattern, made explicit).

The axis argument is a communicator, or an axis name that a live
:class:`~chainermn_torch.communicators.MeshCommunicator` binds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch.functions.collective_communication import (
    allreduce,
    copy_to_parallel_region,
    reduce_from_parallel_region,
)
from chainermn_torch.parallel.mesh import resolve_axis


def _tp_axis(axis):
    comm = resolve_axis(axis)
    if comm is None:
        raise ValueError(f"tensor axis {axis!r} is not bound: build a "
                         "MeshCommunicator with it first, or pass its "
                         "communicator")
    return comm


def _mark_sliced(*params) -> None:
    for p in params:
        p.tensor_parallel_sliced = True


def _local(width: int, n: int, what: str) -> int:
    if width % n:
        raise ValueError(f"global {what} {width} not divisible by "
                         f"tensor-axis size {n}")
    return width // n


class ColumnParallelDense(nn.Module):
    """``y = x @ W[:, my slice] + b[my slice]`` (``tensor.py:52``): the
    output feature-sharded. ``weight [features, in_features]`` and
    ``bias [features]`` are global and sliced leaves. The input passes
    Megatron's *f*, so its gradient is summed over the axis."""

    def __init__(self, in_features: int, features: int, axis_name, *,
                 use_bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        self.in_features, self.features = in_features, features
        self.axis_name, self.compute_dtype = axis_name, compute_dtype
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)
        nn.init.normal_(self.weight, std=in_features ** -0.5)
        _mark_sliced(*(p for p in (self.weight, self.bias) if p is not None))

    def forward(self, x):
        comm = _tp_axis(self.axis_name)
        local = _local(self.features, comm.size, "features")
        sl = slice(comm.rank * local, (comm.rank + 1) * local)
        dt = self.compute_dtype
        x = copy_to_parallel_region(x.to(dt), comm)
        b = None if self.bias is None else self.bias[sl].to(dt)
        return F.linear(x, self.weight[sl].to(dt), b)


class RowParallelDense(nn.Module):
    """``y = psum(x_local @ W[my slice, :]) + b`` (``tensor.py:91``): the
    input feature-sharded, the output replicated. ``weight [features,
    in_features]`` (global ``in_features``) is a sliced leaf; ``bias``
    adds after Megatron's *g* on every rank alike."""

    def __init__(self, in_features: int, features: int, axis_name, *,
                 use_bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        self.in_features, self.features = in_features, features
        self.axis_name, self.compute_dtype = axis_name, compute_dtype
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)
        nn.init.normal_(self.weight, std=in_features ** -0.5)
        _mark_sliced(self.weight)

    def forward(self, x):
        comm = _tp_axis(self.axis_name)
        local = _local(self.in_features, comm.size, "in_features")
        if x.shape[-1] != local:
            raise ValueError(
                f"input is {x.shape[-1]}-wide locally but global in_features"
                f" {self.in_features} / {comm.size} ranks = {local}")
        sl = slice(comm.rank * local, (comm.rank + 1) * local)
        dt = self.compute_dtype
        y = reduce_from_parallel_region(
            F.linear(x.to(dt), self.weight[:, sl].to(dt)), comm)
        return y if self.bias is None else y + self.bias.to(dt)


class TensorParallelMLP(nn.Module):
    """column(d_ff) -> tanh GELU -> row(d_model): one all-reduce
    (``tensor.py:132``)."""

    def __init__(self, d_model: int, d_ff: int, axis_name, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.fc1 = ColumnParallelDense(d_model, d_ff, axis_name, **kw)
        self.fc2 = RowParallelDense(d_ff, d_model, axis_name, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class TensorParallelAttention(nn.Module):
    """Multi-head attention with the heads sharded over the tensor axis
    (``tensor.py:150``): column-parallel qkv, this rank's heads attended
    by any kind of
    :func:`~chainermn_torch.parallel.sequence.sequence_parallel_attention`
    (over ``sequence_axis`` for the sequence-parallel kinds), then a
    row-parallel output projection.

    The qkv features are ``(rank, 3, local_head, d_head)``-major, as in
    the reference: rank ``r``'s contiguous slice is its own q, k and v.
    That bakes the degree into the stored weight;
    :func:`reshard_tp_qkv` converts between degrees."""

    def __init__(self, d_model: int, n_heads: int, axis_name, *,
                 causal: bool = True, attention: str = "full",
                 sequence_axis=None,
                 compute_dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        from chainermn_torch.parallel.sequence import (
            sequence_parallel_attention,
        )

        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads "
                             f"{n_heads}")
        self.d_model, self.n_heads = d_model, n_heads
        self.axis_name, self.causal = axis_name, causal
        self.attention, self.sequence_axis = attention, sequence_axis
        self._attend = sequence_parallel_attention(attention, sequence_axis,
                                                   causal=causal)
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.qkv = ColumnParallelDense(d_model, 3 * d_model, axis_name, **kw)
        self.proj = RowParallelDense(d_model, d_model, axis_name, **kw)

    def forward(self, x, pos_offset=0, kv_cache=None):
        """``x [B, T, d]`` replicated over the axis. With ``kv_cache`` (a
        dense or paged layer dict over this rank's ``n_heads / n`` local
        heads, ``tensor.py:209-214``) the rank writes its heads' K/V rows
        at ``pos_offset`` in place and attends through the cache — the
        paged store through the paged-decode kernel when the dict asks
        for it; without, its ``attention`` kind runs."""
        if kv_cache is not None and self.sequence_axis is not None:
            raise ValueError("kv_cache decoding needs an unsharded sequence "
                             "— rebuild without sequence_axis for "
                             "inference")
        if kv_cache is not None and not self.causal:
            raise ValueError("kv_cache decoding is causal by construction "
                             "(the position mask); causal=False with a "
                             "cache would silently mask attention to later "
                             "cached positions")
        n = _tp_axis(self.axis_name).size
        if self.n_heads % n:
            raise ValueError(f"n_heads {self.n_heads} not divisible by "
                             f"tensor-axis size {n}")
        b, t, _ = x.shape
        lh, dh = self.n_heads // n, self.d_model // self.n_heads
        qkv = self.qkv(x).view(b, t, 3, lh, dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if kv_cache is not None:
            from chainermn_torch.parallel.sequence import (
                update_cache_and_attend,
            )

            o = update_cache_and_attend(kv_cache, q, k, v, pos_offset)
        else:
            o = self._attend(q, k, v)
        return self.proj(o.reshape(b, t, lh * dh))


def reshard_tp_qkv(state_dict: dict, n_heads: int, d_head: int,
                   old_tp: int, new_tp: int) -> dict:
    """A copy of ``state_dict`` with every tensor-parallel qkv weight and
    bias (keys ending ``attn.qkv.weight``/``attn.qkv.bias``, features on
    dim 0) moved from the ``old_tp`` column order to ``new_tp``'s
    (``tensor.py:229``), through the degree-free ``(3, head, d_head)``
    order; ``new_tp=1`` is the dense model's order. The projection needs
    no permutation. Raises if a degree does not divide ``n_heads``, on a
    leaf of the wrong width, and when no qkv leaf is found."""
    if n_heads % old_tp or n_heads % new_tp:
        raise ValueError(f"n_heads {n_heads} must divide by both TP degrees "
                         f"({old_tp}, {new_tp})")
    width = 3 * n_heads * d_head

    def reorder(t, src, dst):
        rest = t.shape[1:]
        c = t.reshape(src, 3, n_heads // src, d_head, *rest)
        c = c.movedim(0, 1).reshape(3, n_heads, d_head, *rest)
        c = c.reshape(3, dst, n_heads // dst, d_head, *rest).movedim(1, 0)
        return c.reshape(width, *rest)

    out, n_fixed = dict(state_dict), 0
    for key, t in state_dict.items():
        if not key.endswith(("attn.qkv.weight", "attn.qkv.bias")):
            continue
        if t.shape[0] != width:
            raise ValueError(
                f"{key} has {t.shape[0]} features but n_heads={n_heads}, "
                f"d_head={d_head} imply 3*h*dh={width}")
        out[key] = reorder(t, old_tp, new_tp)
        n_fixed += 1
    if not n_fixed:
        raise ValueError("reshard_tp_qkv found no tensor-parallel qkv leaf "
                         "(attn.qkv.*) — nothing was resharded")
    return out


def vocab_parallel_cross_entropy(local_logits, targets, axis_name):
    """Per-token cross entropy over vocab-sharded logits
    (``tensor.py:295``): ``local_logits [..., V/n]`` is rank ``r``'s
    contiguous slice ``[r*V/n, (r+1)*V/n)``, ``targets`` global ids. A max
    all-reduce for the shift (no gradient), then Megatron's *g* over the
    local sum-exp and over the target's logit, which only its shard's
    rank holds. Equal on every rank of the axis; the full ``[..., V]``
    logits never exist."""
    comm = _tp_axis(axis_name)
    v_local = local_logits.shape[-1]
    logits = local_logits.float()
    start = comm.rank * v_local
    gmax = comm.allreduce(logits.detach().amax(dim=-1), "max")
    shifted = logits - gmax[..., None]
    denom = reduce_from_parallel_region(shifted.exp().sum(dim=-1), comm)
    in_shard = (targets >= start) & (targets < start + v_local)
    idx = (targets - start).clamp(0, v_local - 1)
    t_local = shifted.gather(-1, idx[..., None].long())[..., 0]
    t_logit = reduce_from_parallel_region(
        torch.where(in_shard, t_local, torch.zeros_like(t_local)), comm)
    return torch.log(denom) - t_logit


def global_objective(local_loss, communicator):
    """The mean of the per-rank loss over ``communicator``'s ranks
    (``tensor.py:327``), differentiable: the backward is the mean of the
    ranks' cotangents, so a loss every rank backpropagates with the same
    cotangent hands each rank's own loss that cotangent unchanged, and
    the train step's gradient assembly (the mean over ranks, the psum of
    the sliced leaves) completes the global gradient. The reference finds
    the axes to reduce by vma tracking; the port has none, so the caller
    names the communicator."""
    return allreduce(local_loss, communicator, "mean")


def sliced_parameters(model: nn.Module) -> list:
    """The parameters of ``model`` that tensor-parallel layers slice."""
    return [p for p in model.parameters()
            if getattr(p, "tensor_parallel_sliced", False)]


__all__ = ["ColumnParallelDense", "RowParallelDense", "TensorParallelAttention",
           "TensorParallelMLP", "global_objective", "reshard_tp_qkv",
           "sliced_parameters", "vocab_parallel_cross_entropy"]
