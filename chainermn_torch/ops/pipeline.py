"""Microbatched pipeline parallelism, GPipe's fill-drain schedule (the
port of ``chainermn_tpu/ops/pipeline.py``).

Every rank of the pipeline group holds one stage and runs the same
explicit schedule of ``n_microbatches + n_stages - 1`` ticks: at each
tick rank 0 takes the next microbatch, every other rank the activation
its predecessor sent last tick, and each stage's output moves to the
next rank by the differentiable ``ppermute``. Autograd replays the ticks
in reverse, so the backward runs the transposed transfers (stage i+1 to
i) in the mirror order on every rank. Stages must keep their input's
shape (transformer blocks do). Bubble fraction: ``(S - 1) / (M + S - 1)``.

Every transfer stays in each rank's autograd graph, so every rank runs
its half of every backward transfer: rank 0 never reads what it receives
(nothing), but keeps it at a zero gradient; the ranks before the last
keep their (unused) copy of the output window the same way.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from chainermn_torch._device import resolve_device
from chainermn_torch.functions.collective_communication import (
    ppermute,
    reduce_from_parallel_region,
)
from chainermn_torch.parallel.mesh import resolve_axis


class _Anchor(torch.autograd.Function):
    """``x`` unchanged, ``keep`` held in the graph at a zero gradient."""

    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = (keep.shape, keep.dtype)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.keep
        return g, g.new_zeros(shape, dtype=dtype)


def pipeline_apply(stage_fn: Callable, x, axis_name, n_microbatches: int,
                   remat: bool = False):
    """Run ``x`` through ``n_stages = group size`` pipeline stages
    (``pipeline.py:42``).

    ``stage_fn(micro) -> micro_out`` applies THIS rank's resident stage
    (the reference's ``stage_fn(params, micro)`` with the parameters
    bound, as a module binds them). ``x`` is the whole batch, the same on
    every rank; its leading dim must divide by ``n_microbatches``.
    ``axis_name`` is the pipeline group (a communicator or a bound axis
    name). ``remat=True`` recomputes each stage in the backward
    (``torch.utils.checkpoint``): only the microbatch boundaries stay
    alive. Returns the last stage's output for the whole batch on every
    rank (the last rank's valid window summed over the group, whose
    backward hands each rank its own cotangent)."""
    comm = resolve_axis(axis_name)
    if comm is None:
        raise ValueError(f"pipeline axis {axis_name!r} is not bound")
    n, idx = comm.size, comm.rank
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by n_microbatches "
                         f"{n_microbatches}")
    fn = stage_fn
    if remat:
        def fn(t):
            return checkpoint(stage_fn, t, use_reentrant=False)

    micro = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
    ticks = n_microbatches + n - 1
    perm = [(i, i + 1) for i in range(n - 1)]     # stage i -> i+1, no wrap
    state, outs = None, []
    for t in range(ticks):
        if idx == 0:
            inp = micro[min(t, n_microbatches - 1)]
            if state is not None:
                inp = _Anchor.apply(inp, state)
        else:
            inp = torch.zeros_like(micro[0]) if state is None else state
        out = fn(inp)
        outs.append(out)
        if t < ticks - 1:          # the last tick's transfer would feed none
            state = ppermute(out, comm, perm)
    # the last stage emits microbatch m at tick m + n - 1; what it made
    # earlier is fill
    valid = torch.stack(outs[n - 1:n - 1 + n_microbatches])
    if idx != n - 1:
        valid = _Anchor.apply(torch.zeros_like(valid), valid)
    full = reduce_from_parallel_region(valid, comm)
    return full.reshape(b, *x.shape[1:])


class _PPEmbed(nn.Module):
    """Token plus position embedding, in ``compute_dtype``."""

    def __init__(self, vocab_size, d_model, max_len, compute_dtype,
                 device) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed = nn.Embedding(vocab_size, d_model, device=device)
        self.pos_embed = nn.Embedding(max_len, d_model, device=device)

    def forward(self, tokens):
        dt = self.compute_dtype
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        return (F.embedding(tokens, self.embed.weight).to(dt)
                + F.embedding(pos, self.pos_embed.weight).to(dt)[None])


class _PPHead(nn.Module):
    """The final LayerNorm and the LM head; float32 logits."""

    def __init__(self, vocab_size, d_model, compute_dtype, device) -> None:
        super().__init__()
        from chainermn_torch.models.transformer import _LN_EPS

        self.compute_dtype = compute_dtype
        self.ln_f = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        self.lm_head = nn.Linear(d_model, vocab_size, device=device)

    def forward(self, x):
        from chainermn_torch.models.transformer import _dense, _layer_norm

        dt = self.compute_dtype
        return _dense(self.lm_head, _layer_norm(self.ln_f, x, dt), dt).float()


def make_pipeline_lm(vocab_size: int, d_model: int, n_heads: int,
                     n_stages: int, d_ff: Optional[int] = None,
                     max_len: int = 512,
                     compute_dtype: torch.dtype = torch.float32, *,
                     device=None):
    """The three parts of a pipelined decoder LM on this rank
    (``pipeline.py:143``): ``(embed, block, head)``, ``block`` this rank's
    stage (a causal :class:`~chainermn_torch.models.TransformerBlock` with
    ``attention='full'``); the model has ``n_stages`` of them, one a rank.
    Parameters are float32 on ``device`` (the current card when
    ``None``), seeded by :func:`init_pipeline_lm`."""
    from chainermn_torch.models.transformer import TransformerBlock

    device = resolve_device(device)
    embed = _PPEmbed(vocab_size, d_model, max_len, compute_dtype, device)
    block = TransformerBlock(d_model, n_heads, d_ff or 4 * d_model,
                             compute_dtype=compute_dtype, device=device)
    block.n_stages = n_stages
    head = _PPHead(vocab_size, d_model, compute_dtype, device)
    return embed, block, head


@torch.no_grad()
def init_pipeline_lm(modules, seed: int, stage: int) -> None:
    """Seed the pipelined LM in place (``pipeline.py:160``): the embedding
    and the head from ``seed`` (the same on every rank), stage ``stage``'s
    block from its own stream, so the stages differ as the reference's
    stacked init does: normal(0, 0.02) matrices and embeddings, zero
    biases, unit LayerNorm scales, drawn on the CPU."""
    embed, block, head = modules

    def fill(module, gen):
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)

    gen = torch.Generator().manual_seed(int(seed))
    fill(embed, gen)
    fill(head, gen)
    fill(block, torch.Generator().manual_seed(int(seed) + 1 + int(stage)))


def pp_lm_specs(modules) -> dict:
    """Where each parameter of the pipelined LM lives (``pipeline.py:173``):
    ``'stage'`` for this rank's block (and its optimizer moments), one a
    rank; ``'replicated'`` for the embedding and the head."""
    embed, block, head = modules
    out = {}
    for part, mod, where in (("embed", embed, "replicated"),
                             ("block", block, "stage"),
                             ("head", head, "replicated")):
        for name, _ in mod.named_parameters():
            out[f"{part}.{name}"] = where
    return out


def pp_lm_opt_init(make_optimizer: Callable, modules):
    """The pipelined LM's optimizer (``pipeline.py:291``):
    ``make_optimizer(params)`` over this rank's embedding, stage and head
    parameters, so the stage's moments live on its rank only."""
    return make_optimizer([p for m in modules for p in m.parameters()])


@torch.no_grad()
def _reduce_grads(params, comm, op: str) -> None:
    """Each gradient all-reduced over ``comm`` in place (a parameter the
    loss did not reach counts as zero)."""
    for p in params:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = comm.allreduce(g, op)


def jit_pp_lm_train_step(modules, optimizer, comm, n_microbatches: int,
                         remat: bool = True) -> Callable:
    """The pipeline-parallel LM step (``pipeline.py:190``):
    ``step(tokens, targets) -> loss`` with the whole batch on every rank
    of ``comm`` (one stage a rank; ``n_stages`` must equal its size).
    ``remat=True`` recomputes each stage in the backward.

    The embedding feeds the pipeline on rank 0 only, so its gradient lives
    there and the step sums it over the ranks; every rank computes the
    head on the same output, so the head's gradient is averaged (an
    identity up to rounding); each stage's gradient stays on its rank.
    Returns the loss averaged over the ranks (equal on all of them)."""
    embed, block, head = modules
    if isinstance(getattr(comm, "axis_name", None), tuple):
        raise ValueError("pipeline LM needs a flat single-axis communicator "
                         f"(got axes {comm.axis_name!r})")
    n_stages = getattr(block, "n_stages", comm.size)
    if n_stages != comm.size:
        raise ValueError(f"the model has {n_stages} stages but the pipeline "
                         f"group has {comm.size} ranks — build it with "
                         f"n_stages={comm.size}")
    embed_params = list(embed.parameters())
    head_params = list(head.parameters())

    def step(tokens, targets):
        dev = next(block.parameters()).device
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        optimizer.zero_grad(set_to_none=True)
        y = pipeline_apply(block, embed(tokens), comm, n_microbatches,
                           remat=remat)
        logits = head(y)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
        loss.backward()
        _reduce_grads(embed_params, comm, "sum")
        _reduce_grads(head_params, comm, "mean")
        optimizer.step()
        return comm.allreduce(loss.detach(), "mean")

    return step


__all__ = ["init_pipeline_lm", "jit_pp_lm_train_step", "make_pipeline_lm",
           "pipeline_apply", "pp_lm_opt_init", "pp_lm_specs"]
