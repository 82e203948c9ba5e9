"""The comparisons that decide ``correct``: the numbers the program's
outputs give against the reference's, each judged against its limit in
the cell file."""

from __future__ import annotations

import statistics


def widest_logit_gap(ref_logits: list, served: list) -> float:
    """The largest amount by which a served token's reference logit lies
    below the reference's best at its position; ``ref_logits[i]`` holds
    sequence ``i``'s logits ``[n_i, V]`` at the positions that produced
    ``served[i]`` (``n_i`` tokens)."""
    worst = 0.0
    for lg, toks in zip(ref_logits, served):
        if toks.numel() == 0:
            continue
        toks = toks.to(lg.device).long().view(-1, 1)
        gap = lg.max(dim=-1).values - lg.gather(1, toks)[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def loss_gap(prog: list, ref: list) -> float:
    """The largest relative gap between the program's and the reference's
    loss over the compared steps."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap between two norms: ``|prog - ref|`` over the
    larger of the reference's norm of that leaf and the median leaf's,
    over the leaves in ``keep`` (all by default). Returns the gap and the
    leaf."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    worst, at = 0.0, ""
    for k in names:
        g = abs(prog[k] - ref[k]) / max(ref[k], med)
        if g >= worst:
            worst, at = g, k
    return worst, at


def moved_leaves(ref_grad: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's norm."""
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= share * med}
