"""Training: the port's ``lm_train_step`` over a one-rank communicator
and ``create_multi_node_optimizer`` around ``torch.optim.AdamW``, fed
fresh seeded rows every step.

Set-up builds one step object (model with float32 weights drawn on the
device, optimizer, step) and drives it through its first three steps
on the window's own feed: they build every kernel, and they are the
steps the reference follows. After step 1 the optimizer's first moment
gives each leaf's first gradient (``m = (1 - beta1) g``); after step 3
each leaf's change from its drawn value is taken, before step 4 moves
it. The same object then runs the window: ``train_step_ms`` is the
window's seconds over its steps, closed by a fetch of the last loss.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from harness.checks import leaf_gap, loss_gap, moved_leaves
from harness.trace import Tracer, region
from harness.traffic import TrainTraffic
from harness.weights import (
    dims,
    draw_group,
    fill_model,
    group_specs,
    part_norms,
)

CHECKED_STEPS = 3


def build_step(model, cell: dict, dev):
    """The step as a user of the port builds it."""
    from chainermn_torch import create_communicator
    from chainermn_torch.optimizers import create_multi_node_optimizer
    from chainermn_torch.training import lm_train_step

    comm = create_communicator("pure_nccl", device=dev)
    o = cell["optimizer"]
    opt = create_multi_node_optimizer(torch.optim.AdamW(
        model.parameters(), lr=o["lr"], betas=tuple(o["betas"]),
        eps=o["eps"], weight_decay=o["weight_decay"]), comm)
    return lm_train_step(model, opt, comm), opt, comm


def run(ctx) -> dict:
    from chainermn_torch.models import TransformerLM

    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    m = dims(cfg)
    cuda = dev.type == "cuda"
    beta1 = float(cell["optimizer"]["betas"][0])

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    model = TransformerLM(m["vocab"], d_model=m["d"], n_heads=m["heads"],
                          n_layers=m["layers"], d_ff=m["ff"],
                          max_len=m["positions"],
                          compute_dtype=getattr(torch, cfg["compute_dtype"]),
                          attention=cell.get("attention", "flash"),
                          device=dev)
    fill_model(model, cfg, ctx.seed, torch.float32)
    step, opt, comm = build_step(model, cell, dev)
    feed = TrainTraffic(ctx.traffic, ctx.seed, m["vocab"], dev)
    params = dict(model.named_parameters())

    losses = []
    for k in range(CHECKED_STEPS):
        loss, _ = step(*feed.next())
        losses.append(loss)
        if k == 0:
            # the first gradient as the optimizer got it: m1 = (1-b1) g
            # (a leaf the step left without state got no gradient)
            grad_norms = {n: v / (1 - beta1) for n, v in part_norms(
                {n: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                 for n, p in params.items()}).items()}
    checked_losses = [float(x) for x in losses]
    change = {}
    with torch.no_grad():
        for gi in range(len(group_specs(cfg))):
            drawn = draw_group(cfg, ctx.seed, gi, torch.float32, dev)
            change.update(part_norms({n: params[n] - v
                                      for n, v in drawn.items()}))
    tracer = Tracer() if ctx.trace else None
    if tracer is not None:
        Tracer.warm(dev)
    sync()

    # ---- the window ----
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    t_trace = t_end - min(ctx.trace_seconds, ctx.seconds)
    window_losses, traced_steps = [], 0
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if tracer is not None and not tracer.started and now >= t_trace:
            tracer.start()
        with region("bench.train_step"):
            loss, _ = step(*feed.next())
        window_losses.append(loss)
        if tracer is not None and tracer.active:
            traced_steps += 1
    last = float(window_losses[-1])      # the fetch closes the window
    t_close = time.perf_counter()
    if tracer is not None and tracer.active:
        tracer.stop(sync)
    window_s = t_close - t0
    n = len(window_losses)
    failed = sum(not math.isfinite(float(x)) for x in window_losses)
    del last
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = tracer.summary() if tracer is not None else None
    if summary is not None:
        summary.steps = {"train_steps": traced_steps}

    # ---- the check: the reference follows the first steps ----
    comm.finalize()
    del step, opt, comm, model, params, window_losses, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    from reference.gpt2 import train_reference

    replay = TrainTraffic(ctx.traffic, ctx.seed, m["vocab"], dev)
    batches = [replay.next() for _ in range(CHECKED_STEPS)]
    # ~2048 tokens a call keep the reference's float32 activations small
    ref = train_reference(cfg, ctx.seed, batches, cell["optimizer"],
                          device=dev,
                          rows_per_call=max(1, 2048 // feed.seq_len))
    limits = cell["check"]["limits"]
    keep = moved_leaves(ref["grad_norms"])
    got = {"loss_gap": loss_gap(checked_losses, ref["losses"]),
           "grad_norm_gap": leaf_gap(grad_norms, ref["grad_norms"])[0],
           "change_norm_gap": leaf_gap(change, ref["change_norms"],
                                       keep)[0]}
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in got.items() if k in limits}
    return {
        "e2e": {"train_step_ms": window_s / n * 1e3}, "setup_end": t0,
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": n, "failed": failed, "checks": checks,
        "memory_peak_bytes": peak, "trace": summary,
        "host": {"window_s": window_s, "train_steps": n,
                 "batch": feed.batch, "seq_len": feed.seq_len,
                 "reference_s": time.perf_counter() - t_ref, **got},
    }
