"""Mixture-of-experts FFNs (the port of ``chainermn_tpu/parallel/moe.py``).

Two numeric twins share one routing function, :func:`_route` (top-k,
capacity, priority and drop math):

- :class:`ExpertParallelMLP` shards the experts over a group: each rank
  routes its own tokens, a capacity-bounded dispatch buffer goes to the
  experts' ranks by one row-exchange all-to-all, and the results come
  back by the same exchange (its own transpose, so the backward is the
  same collective);
- :class:`GShardMoE` dispatches and combines by two einsums over a
  ``[assignments, E, C]`` one-hot tensor with no collective; the
  weights-at-rest step (:mod:`chainermn_torch.parallel.gspmd`) runs it
  with each rank holding its experts' share of the stacks.

Both return ``(out [B,T,D], aux_loss)`` (the Switch load-balance loss
over first choices) and keep a per-forward routing record in
``module.stats`` — ``drop_frac`` (the share of assignments dropped at the
capacity bound) and ``frac_routed`` (each expert's first-choice load) —
where flax sows ``moe_stats``. Construction writes no record.

As in the reference, the expert stacks ``w1 [E,d,ff]``, ``b1 [E,1,ff]``,
``w2 [E,ff,d]``, ``b2 [E,1,d]`` are stored in ``compute_dtype``; the gate
is a float32 ``Linear(d, E)`` computed in ``compute_dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch.functions.collective_communication import (
    all_to_all,
    allreduce,
    copy_to_parallel_region,
    reduce_from_parallel_region,
)
from chainermn_torch.parallel.mesh import resolve_axis


def _route(gate_probs, n_experts: int, top_k: int, capacity_factor: float):
    """Top-k routing (``moe.py:39``): ``gate_probs [n_tok, E]`` (f32) ->
    ``(combine_w [n_tok, k], flat_idx [k*n_tok], pos [k*n_tok],
    keep [k*n_tok], first_choice_frac [E], capacity)``.

    Assignments are copy-major (every first choice before every second
    choice), so when capacity binds the second choices drop first.
    ``top_k=1`` keeps the raw probability as the combine weight;
    ``top_k=2`` renormalises the two to sum to 1. The capacity is the
    reference's ``int(max(1, ceil(k*n_tok/E) * capacity_factor))``, the
    integer ceiling taken before the float product. ``torch.topk`` orders
    equal probabilities as it likes where ``lax.top_k`` takes the lower
    index; exact ties do not occur with real-valued gates."""
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    n_tok = gate_probs.shape[0]
    topk_probs, topk_idx = torch.topk(gate_probs, top_k, dim=-1)
    if top_k == 1:
        combine_w = topk_probs
    else:
        combine_w = topk_probs / topk_probs.sum(-1, keepdim=True)
    first_choice_frac = F.one_hot(topk_idx[:, 0], n_experts).float().mean(0)
    capacity = int(max(1, (top_k * n_tok + n_experts - 1)
                       // n_experts * capacity_factor))
    flat_idx = topk_idx.T.reshape(-1)
    one_hot = F.one_hot(flat_idx, n_experts)
    pos = ((one_hot.cumsum(0) - 1) * one_hot).sum(-1)
    keep = pos < capacity
    return combine_w, flat_idx, pos, keep, first_choice_frac, capacity


def _expert_init(*shape, device, dtype):
    """flax's ``variance_scaling(1.0, 'fan_in', 'truncated_normal',
    batch_axis=0)``: each expert an independent ``(in, out)`` matrix."""
    w = torch.empty(shape, device=device, dtype=torch.float32)
    std = (1.0 / shape[1]) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)
    return w.to(dtype)


class _Experts(nn.Module):
    """The gate and the expert stacks, shared by both implementations."""

    def __init__(self, n_experts: int, d_model: int, d_ff: int, *,
                 capacity_factor: float, top_k: int,
                 compute_dtype: torch.dtype, device) -> None:
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {top_k}")
        self.n_experts, self.d_model, self.d_ff = n_experts, d_model, d_ff
        self.capacity_factor, self.top_k = capacity_factor, top_k
        self.compute_dtype = compute_dtype
        self.gate = nn.Linear(d_model, n_experts, device=device)
        nn.init.normal_(self.gate.weight, std=d_model ** -0.5)
        nn.init.zeros_(self.gate.bias)
        kw = dict(device=device, dtype=compute_dtype)
        self.w1 = nn.Parameter(_expert_init(n_experts, d_model, d_ff, **kw))
        self.b1 = nn.Parameter(torch.zeros(n_experts, 1, d_ff, **kw))
        self.w2 = nn.Parameter(_expert_init(n_experts, d_ff, d_model, **kw))
        self.b2 = nn.Parameter(torch.zeros(n_experts, 1, d_model, **kw))
        self.stats: dict = {}

    def _gate(self, x):
        """``(tokens [n_tok, d], gate_probs [n_tok, E] f32)``."""
        b, t, d = x.shape
        if d != self.d_model:
            raise ValueError(f"input dim {d} != d_model {self.d_model}")
        dt = self.compute_dtype
        tokens = x.reshape(b * t, d).to(dt)
        logits = F.linear(tokens, self.gate.weight.to(dt),
                          self.gate.bias.to(dt))
        return tokens, torch.softmax(logits.float(), dim=-1)

    def _ffn(self, xs, lo: int, hi: int):
        """Experts ``lo..hi-1`` of the held stacks on ``xs [e, C, d]``."""
        h = torch.relu(torch.bmm(xs, self.w1[lo:hi]) + self.b1[lo:hi])
        return torch.bmm(h, self.w2[lo:hi]) + self.b2[lo:hi]


class ExpertParallelMLP(_Experts):
    """Top-k-routed MoE FFN (``moe.py:73``; k = 1 Switch, k = 2 GShard)
    with the experts sharded over ``axis_name`` (a communicator, or an
    axis name a live :class:`~chainermn_torch.communicators.MeshCommunicator`
    binds). ``n_experts`` must divide by the group's size; rank ``r``
    runs experts ``[r*E/n, (r+1)*E/n)`` of the stacks, which every rank
    stores whole, as the reference does. ``forward(x [B,T,D])`` on this
    rank's tokens returns ``(out, aux_loss)``; with ``global_aux`` the
    aux statistics are averaged over the group first, so the objective is
    the global batch's Switch loss (its gradient flows through the mean
    all-reduce, whose backward is the same mean)."""

    def __init__(self, n_experts: int, d_model: int, d_ff: int, axis_name,
                 *, capacity_factor: float = 1.25, top_k: int = 1,
                 global_aux: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__(n_experts, d_model, d_ff,
                         capacity_factor=capacity_factor, top_k=top_k,
                         compute_dtype=compute_dtype, device=device)
        self.axis_name, self.global_aux = axis_name, global_aux

    def forward(self, x):
        comm = resolve_axis(self.axis_name)
        if comm is None:
            raise ValueError(f"expert axis {self.axis_name!r} is not bound: "
                             "build a MeshCommunicator with it first, or "
                             "pass its communicator")
        n = comm.size
        if self.n_experts % n:
            raise ValueError(f"n_experts={self.n_experts} not divisible by "
                             f"axis size {n}")
        b, t, d = x.shape
        le, kk = self.n_experts // n, self.top_k
        tokens, gate_probs = self._gate(x)
        n_tok = b * t
        combine_w, flat_idx, pos, keep, frac, cap = _route(
            gate_probs, self.n_experts, kk, self.capacity_factor)
        mean_prob = gate_probs.mean(0)
        if self.global_aux:
            frac = comm.allreduce(frac, "mean")
            mean_prob = allreduce(mean_prob, comm, "mean")
        aux = self.n_experts * (frac * mean_prob).sum()
        self.stats = {"drop_frac": comm.allreduce(
            1.0 - keep.float().mean(), "mean"), "frac_routed": frac}

        # dispatch[e*C + c]: the payload bound for expert e at slot c; a
        # dropped assignment writes a spare last row, which is cut off
        n_slots = self.n_experts * cap
        slot = torch.where(keep, flat_idx * cap + pos,
                           torch.full_like(pos, n_slots))
        payload = tokens.repeat(kk, 1)                   # copy-major
        dispatch = payload.new_zeros(n_slots + 1, d).index_copy(
            0, slot, payload)[:n_slots]
        # row r of the send buffer is this rank's block for rank r's
        # experts; after the exchange row s is rank s's block for mine
        recv = all_to_all(dispatch.view(n, le * cap, d), comm, 0, 0)
        recv = recv.view(n, le, cap, d).transpose(0, 1).reshape(
            le, n * cap, d)
        r = comm.rank
        out = self._ffn(recv, r * le, (r + 1) * le)
        out = out.view(le, n, cap, d).transpose(0, 1).reshape(n, le * cap, d)
        back = all_to_all(out, comm, 0, 0).reshape(n_slots, d)
        back = torch.cat([back, back.new_zeros(1, d)])  # dropped -> 0
        w = combine_w.T.reshape(-1)[:, None].to(back.dtype)
        y = (back[slot] * w).view(kk, n_tok, d).sum(0)
        return y.view(b, t, d).to(x.dtype), aux


class GShardMoE(_Experts):
    """Einsum-dispatch MoE FFN (``moe.py:224``): the same contract and
    routing as :class:`ExpertParallelMLP` with no collective — the whole
    batch is visible, so the aux statistics are global as they stand.
    ``dispatch[a, e, c] = 1`` iff assignment ``a`` goes to expert ``e``
    at slot ``c``; ``expert_in = einsum('ad,aec->ecd')`` and the combine
    ``einsum('ecd,aec->ad')`` weighted by the gate probabilities. Memory:
    the dispatch tensor holds ``k * n_tok * E * C`` elements of
    ``compute_dtype``.

    Under :func:`~chainermn_torch.parallel.gspmd.megatron_shard` the
    module holds only its rank's block of the expert stacks; the
    weights-at-rest step then calls :meth:`forward` with ``axis``: this
    rank computes its experts' share of the dispatch and combine, and the
    shares are summed over the axis (Megatron's *f* on the payload and
    the combine weights, *g* on the result)."""

    def __init__(self, n_experts: int, d_model: int, d_ff: int, *,
                 capacity_factor: float = 1.25, top_k: int = 1,
                 compute_dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__(n_experts, d_model, d_ff,
                         capacity_factor=capacity_factor, top_k=top_k,
                         compute_dtype=compute_dtype, device=device)

    def forward(self, x, axis=None):
        b, t, d = x.shape
        kk = self.top_k
        tokens, gate_probs = self._gate(x)
        n_tok = b * t
        combine_w, flat_idx, pos, keep, frac, cap = _route(
            gate_probs, self.n_experts, kk, self.capacity_factor)
        aux = self.n_experts * (frac * gate_probs.mean(0)).sum()
        self.stats = {"drop_frac": 1.0 - keep.float().mean(),
                      "frac_routed": frac}
        held = self.w1.shape[0]
        lo = 0 if axis is None else axis.rank * held
        if axis is None and held != self.n_experts:
            raise ValueError(f"this GShardMoE holds {held} of "
                             f"{self.n_experts} experts: pass the axis "
                             "they are sharded over")
        dt = tokens.dtype
        e_hot = F.one_hot(flat_idx, self.n_experts)[:, lo:lo + held]
        dispatch = ((e_hot * keep[:, None]).to(dt)[:, :, None]
                    * F.one_hot(pos.clamp(max=cap - 1), cap).to(dt)[:, None])
        payload, w = tokens.repeat(kk, 1), combine_w.T.reshape(-1)
        if axis is not None:
            payload = copy_to_parallel_region(payload, axis)
            w = copy_to_parallel_region(w, axis)
        expert_in = torch.einsum("ad,aec->ecd", payload, dispatch)
        out = self._ffn(expert_in, 0, held)
        combined = torch.einsum("ecd,aec->ad", out,
                                dispatch * w[:, None, None].to(dt))
        y = combined.view(kk, n_tok, d).sum(0)
        if axis is not None:
            y = reduce_from_parallel_region(y, axis)
        return y.view(b, t, d).to(x.dtype), aux


def drop_frac_from_sown(sown) -> torch.Tensor:
    """Mean ``drop_frac`` over the MoE layers' routing records
    (``moe.py:306``): ``sown`` is an iterable of ``stats`` dicts (what
    :meth:`chainermn_torch.models.TransformerLM.moe_stats` returns).
    ``0.0`` when no layer routed (``moe_experts`` set but no block is an
    MoE block) — report, do not crash."""
    drops = [s["drop_frac"] for s in sown if "drop_frac" in s]
    if not drops:
        return torch.tensor(0.0)
    return torch.stack([torch.as_tensor(v, dtype=torch.float32)
                        for v in drops]).mean()


class MoeStatsAccumulator:
    """Per-step MoE routing telemetry summed into an epoch summary
    (``moe.py:324``): feed it the ``stats`` dict every LM step returns
    (``{}`` from dense models is a no-op) and read :meth:`summary` at log
    boundaries. It keeps a running sum, max and count of device scalars:
    no device-to-host sync inside the loop, two transfers a summary."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._sum: Optional[torch.Tensor] = None
        self._max: Optional[torch.Tensor] = None
        self._count = 0

    def update(self, stats: dict) -> None:
        if stats and "moe_drop_frac" in stats:
            d = torch.as_tensor(stats["moe_drop_frac"])
            if self._count == 0:
                self._sum, self._max = d, d
            else:
                self._sum = self._sum + d
                self._max = torch.maximum(self._max, d)
            self._count += 1

    @property
    def steps(self) -> int:
        return self._count

    def summary(self) -> dict:
        if not self._count:
            return {"moe_drop_frac_mean": 0.0, "moe_drop_frac_max": 0.0,
                    "steps": 0}
        return {"moe_drop_frac_mean": float(self._sum) / self._count,
                "moe_drop_frac_max": float(self._max),
                "steps": self._count}


__all__ = ["ExpertParallelMLP", "GShardMoE", "MoeStatsAccumulator",
           "drop_frac_from_sown"]
