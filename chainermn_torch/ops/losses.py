"""Token-chunked softmax cross entropy fused with the LM head (the port
of ``chainermn_tpu/ops/losses.py``).

:func:`chunked_softmax_cross_entropy` never builds the ``[N, vocab]``
float32 logits or their gradient, the train step's largest pair: the
forward computes one ``[chunk, vocab]`` tile at a time and keeps each
token's log-sum-exp; the backward recomputes each tile from it, forms
``dlogits = (softmax - onehot) * g`` in place and accumulates the
hidden, weight and bias gradients in float32. The tile products are
plain matrix products (the reference computes them outside any Pallas
kernel too): operands in their storage dtypes, promoted to their common
type, accumulated in float32.

Two faults of the reference are not copied (ROADMAP Queue C): its last
chunk is zero-padded, so the backward exponentiates ``bias - 0`` on the
padded rows (``losses.py:95``), which overflows to inf and then NaN
(``inf * 0``) once a bias exceeds about 88; here the last chunk runs at
its own length. And its backward builds a dense ``[chunk, vocab]``
one-hot (``losses.py:109``); here 1 is subtracted at each row's target
column in place.
"""

from __future__ import annotations

import torch

_DEFAULT_CHUNK = 4096


def _tile_logits(h, weight, bias):
    """One chunk's float32 logits ``h @ weight.T + bias`` from operands in
    their storage dtypes, multiplied in their common type."""
    dt = torch.promote_types(h.dtype, weight.dtype)
    lg = (h.to(dt) @ weight.to(dt).T).float()
    return lg if bias is None else lg + bias.float()


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, bias, targets, chunk):
        n = hidden.shape[0]
        losses = hidden.new_empty(n, dtype=torch.float32)
        lse = hidden.new_empty(n, dtype=torch.float32)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            lg = _tile_logits(hidden[s:e], weight, bias)
            lse[s:e] = torch.logsumexp(lg, dim=-1)
            losses[s:e] = lse[s:e] - lg.gather(1, targets[s:e, None])[:, 0]
        ctx.save_for_backward(hidden, weight, bias, targets, lse)
        ctx.chunk = chunk
        return losses

    @staticmethod
    def backward(ctx, g):
        hidden, weight, bias, targets, lse = ctx.saved_tensors
        n = hidden.shape[0]
        g = g.float()
        dh = torch.empty_like(hidden)
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device)
        db = None if bias is None else torch.zeros(
            bias.shape, dtype=torch.float32, device=bias.device)
        for s in range(0, n, ctx.chunk):
            e = min(s + ctx.chunk, n)
            lg = _tile_logits(hidden[s:e], weight, bias)
            dlg = lg.sub_(lse[s:e, None]).exp_()
            rows = torch.arange(e - s, device=dlg.device)
            dlg[rows, targets[s:e]] -= 1.0
            dlg.mul_(g[s:e, None])
            dh[s:e] = (dlg.to(weight.dtype).float()
                       @ weight.float()).to(hidden.dtype)
            dw.addmm_(dlg.to(hidden.dtype).float().T, hidden[s:e].float())
            if db is not None:
                db += dlg.sum(0)
        return (dh, dw.to(weight.dtype),
                None if db is None else db.to(bias.dtype), None, None)


def chunked_softmax_cross_entropy(hidden, weight, bias, targets, *,
                                  chunk_size: int = _DEFAULT_CHUNK):
    """Per-token cross entropy of ``softmax(hidden @ weight.T + bias)``
    against integer ``targets`` (``losses.py:139``) without building the
    logits.

    ``hidden [..., d]`` final hidden states; ``weight [vocab, d]`` the LM
    head's ``Linear`` weight (the flax kernel transposed); ``bias
    [vocab]`` or None; ``targets [...]`` integer ids shaped like
    ``hidden``'s leading dims. ``chunk_size`` tokens a tile: live memory
    is O(chunk_size * vocab) float32. Returns float32 per-token losses
    shaped like ``targets``, differentiable in ``hidden``, ``weight`` and
    ``bias``."""
    lead = targets.shape
    d = hidden.shape[-1]
    losses = _ChunkedCE.apply(hidden.reshape(-1, d), weight, bias,
                              targets.reshape(-1).long(), int(chunk_size))
    return losses.reshape(lead)


__all__ = ["chunked_softmax_cross_entropy"]
