"""Closed-loop serving: ``clients`` callers, each sending its next
request as soon as its last one completes, into the port's
``FCFSScheduler`` over a ``ServingEngine`` built as the cell file says.

Set-up builds the model with weights drawn on the device, the engine
(every step program captured by ``warmup()``), and gives every client a
request already in flight (:meth:`harness.traffic.ServeTraffic.initial`),
stepping until each has its first token, so the window opens in steady
state. The window drives ``sched.step()`` for ``seconds``; requests that
arrive in it run to completion after it (their latencies count in the
tails, their later tokens not in the tokens a second). With every slot
busy the tails swing with the order of the lengths, so they are
per-layer readings here, beside the tokens a second. Then a sample of the finished requests, drawn from
the seed with the longest among them, is compared with the reference's
full forward over each prompt and its served tokens.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from harness.checks import widest_logit_gap
from harness.common import sub_seed
from harness.trace import Tracer, region
from harness.traffic import ServeTraffic
from harness.weights import dims, fill_model

DRAIN_S = 60.0     # the longest a window's request may run past the close


class _Client:
    __slots__ = ("req", "arrival", "times")

    def __init__(self) -> None:
        self.req = None
        self.arrival = 0.0
        self.times: list = []


def _prefilled(req, engine, RequestState) -> int:
    """Prompt tokens of ``req`` whose K/V the engine has written."""
    if req.tokens:
        return len(req.prompt)
    if req.state is RequestState.PREFILLING:
        st = engine.chunk_state(req.slot)
        return st.frontier if st is not None else 0
    return 0


def run(ctx) -> dict:
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.monitor import get_registry
    from chainermn_torch.serving import (
        FCFSScheduler,
        RequestState,
        ServingEngine,
    )

    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    m = dims(cfg)
    dtype = getattr(torch, cfg["compute_dtype"])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    model = TransformerLM(m["vocab"], d_model=m["d"], n_heads=m["heads"],
                          n_layers=m["layers"], d_ff=m["ff"],
                          max_len=m["positions"], compute_dtype=dtype,
                          device=dev)
    # the engine casts the weights itself; casting first lets the float32
    # copies go before the KV store is allocated
    model.cast_weights_()
    if cuda:
        torch.cuda.empty_cache()
    fill_model(model, cfg, ctx.seed, dtype)
    eng_kw = dict(cell["engine"])
    if not cuda:
        eng_kw.pop("capture", None)
    engine = ServingEngine(model, device=dev, **eng_kw)
    engine.warmup()
    sched = FCFSScheduler(engine, **cell.get("scheduler", {}))
    traffic = ServeTraffic(ctx.traffic, ctx.seed, m["vocab"])
    # the engine's own counter of decode rounds, under the engine's labels
    labels = {"engine": "serving"}
    if engine.paged:
        labels["paged_kernel"] = "on" if engine.paged_kernel else "off"
    decode_steps = get_registry().counter("serving_decode_steps_total",
                                          labels)

    clients = [_Client() for _ in range(traffic.clients)]
    done: list = []
    submitting = True

    def send(c: _Client, prompt, budget) -> None:
        if c.req is not None:
            done.append((c.req, c.arrival, c.times))
        c.times = times = []
        c.arrival = time.perf_counter()
        c.req = sched.submit(prompt, budget, stream_cb=lambda _t: times.append(
            time.perf_counter()))

    def refill() -> None:
        for c in clients:
            if c.req is not None and c.req.finished and submitting:
                send(c, *traffic.next())

    for c, (prompt, budget) in zip(clients, traffic.initial()):
        send(c, prompt, budget)
    while any(not c.req.tokens for c in clients):
        sched.step()
        refill()
    tracer = Tracer() if ctx.trace else None
    if tracer is not None:
        Tracer.warm(dev)
    sync()

    # ---- the window ----
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    t_trace = t_end - min(ctx.trace_seconds, ctx.seconds)
    d0 = decode_steps.value
    occupancy, traced = [], []
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if tracer is not None and not tracer.started and now >= t_trace:
            tracer.start()
        if tracer is not None and tracer.active:
            live = [c.req for c in clients if not c.req.finished]
            before = {r.id: (len(r.tokens), _prefilled(r, engine,
                                                       RequestState))
                      for r in live}
        with region("bench.sched_step"):
            sched.step()
        occupancy.append(engine.active_slots)
        if tracer is not None and tracer.active:
            rows, spans = [], []
            for r in live:
                n0, p0 = before[r.id]
                n1, p1 = len(r.tokens), _prefilled(r, engine, RequestState)
                if n1 - n0 - (1 if n0 == 0 and n1 > 0 else 0) == 1:
                    rows.append(len(r.prompt) + n1 - 1)
                if p1 > p0:
                    spans.append((p0, p1, n0 == 0 and n1 > 0))
            traced.append({"decode_rows": rows, "prefill_spans": spans})
        with region("bench.clients"):
            refill()
    sync()
    t_close = time.perf_counter()
    if tracer is not None and tracer.active:
        tracer.stop(sync)
    d1 = decode_steps.value
    submitting = False

    # ---- requests that arrived in the window run to their end ----
    in_window = [(c.req, c.arrival, c.times) for c in clients
                 if t0 <= c.arrival < t_close]
    in_window += [d for d in done if t0 <= d[1] < t_close]
    deadline = t_close + DRAIN_S
    while (any(not r.finished for r, _, _ in in_window)
           and time.perf_counter() < deadline):
        sched.step()
    sync()

    everything = done + [(c.req, c.arrival, c.times) for c in clients]
    tokens_in_window = sum(1 for _, _, ts in everything for t in ts
                           if t0 <= t < t_close)
    window_s = t_close - t0
    ok = [(r, a, ts) for r, a, ts in in_window
          if r.state is RequestState.DONE and len(ts) >= 2]
    ttft = [ts[0] - a for _, a, ts in ok]
    tpot = [(ts[-1] - ts[0]) / (len(ts) - 1) for _, _, ts in ok]
    e2e = {"serve_tokens_per_s": tokens_in_window / window_s}
    tails = ({"ttft_p95_ms": _p95(ttft) * 1e3,
              "tpot_p95_ms": _p95(tpot) * 1e3} if ok else {})
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = tracer.summary() if tracer is not None else None

    # ---- the check: a sample of finished requests against the reference
    finished = [r for r, _, _ in everything if r.state is RequestState.DONE]
    check = cell["check"]
    sample = _sample(finished, int(check["sample_requests"]), ctx.seed)
    seqs = [torch.as_tensor(np.concatenate([r.prompt, r.tokens[:-1]]),
                            dtype=torch.long) for r in sample]
    starts = [len(r.prompt) - 1 for r in sample]
    served = [torch.as_tensor(r.tokens, dtype=torch.long) for r in sample]
    hold = {"attempted": len(in_window),
            "failed": len(in_window) - len(ok),
            "served_compared": sum(len(s) for s in served)}
    del sched, engine, model, clients, done, everything, in_window, finished
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    from reference.gpt2 import served_logits

    gap = float("inf")
    if sample:
        ref = served_logits(cfg, ctx.seed, seqs, starts, weight_dtype=dtype,
                            device=dev)["f32"]
        gap = widest_logit_gap(ref, served)
    limit = float(check["limits"]["max_logit_gap"])
    return {
        "e2e": e2e, "setup_end": t0, "correct": gap <= limit,
        "attempted": hold["attempted"], "failed": hold["failed"],
        "checks": {"max_logit_gap": {"value": gap, "limit": limit}},
        "memory_peak_bytes": peak, "trace": summary,
        "host": {"window_s": window_s, "decode_steps": d1 - d0,
                 "n_slots": cell["engine"]["n_slots"],
                 "occupancy": occupancy, "traced_steps": traced,
                 "reference_s": time.perf_counter() - t_ref,
                 "served_tokens_compared": hold["served_compared"],
                 "requests_in_window": hold["attempted"], **tails},
    }


def _p95(values: list) -> float:
    """The 95th percentile, interpolated between order statistics."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def _sample(finished: list, k: int, seed: int) -> list:
    """The longest finished request and ``k - 1`` others drawn from the
    seed."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: len(r.prompt) + len(r.tokens))
    rest = [r for r in finished if r is not longest]
    rng = np.random.Generator(np.random.PCG64(sub_seed(seed, "sample")))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]
