#!/usr/bin/env python
"""Continuous-batching LM serving demo, on the port — the twin of
``examples/lm/serve_lm.py``'s single-engine path.

Builds a small ``TransformerLM`` from a seed, stands up the in-process
serving stack (:mod:`chainermn_torch.serving`: engine + scheduler + the
background client thread) and pushes a burst of ragged random prompts
through it, one streamed token by token. Prints the serving metrics
(TTFT/TPOT percentiles, tokens/s, slot occupancy) and the done line.

The same single-engine flags with the same defaults as the reference:

- admission: ``--prefill-len``/``--prefill-buckets``/``--prefill-batch``;
  ``--prefix-blocks``/``--prefix-block-size`` (the dense engine's prefix
  store) with ``--shared-prefix`` traffic;
- ``--paged-kv`` (``--kv-blocks``, ``--kv-block-size``, ``--kv-quant``):
  the shared block store, prefix hits as shared table entries;
- ``--speculate ngram|draft`` with ``--spec-k`` (paged, ``--temperature
  0``) and ``--chunk-tokens`` (paged chunked prefill);
- overload: ``--max-queue``, ``--deadline``, ``--tenants``,
  ``--priority``, ``--tenant-weights`` and ``--brownout``;
- ``--watchdog SECONDS``: the engine's hang watchdog;
- ``--verify-parity``: the first three completed requests against solo
  ``generate()`` with the same seed. Under greedy decoding a divergence
  passes only where the reference's top-2 logit gap at that token is
  below the compute dtype's tie tolerance (1e-4 in float32, 1e-2 in
  bfloat16): the engine's and ``generate()``'s products differ in shape,
  so a near-tie may round either way.

The fleet, deploy, tensor-parallel and monitor flags raise
``SystemExit`` naming the ROADMAP.md item they wait for.

Run on the card (the model computes in bfloat16 there, float32 on the
CPU)::

    python -m chainermn_torch.examples.lm.serve_lm --requests 16 --slots 4
    python -m chainermn_torch.examples.lm.serve_lm --paged-kv \\
        --temperature 0 --speculate ngram --spec-k 4 --verify-parity

``main(argv)`` returns a summary dict.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from chainermn_torch._device import resolve_device
from chainermn_torch.models import TransformerLM, generate
from chainermn_torch.serving import (
    QueueFullError,
    ServingClient,
    ServingEngine,
)

_TIE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# flag -> the ROADMAP.md item it waits for
_UNPORTED = {
    "replicas": "the fleet router (Queue A item 12)",
    "prefill_replicas": "KV migration between tiers (Queue A item 11.5)",
    "decode_replicas": "KV migration between tiers (Queue A item 11.5)",
    "share_prefixes": "prefix KV export/import (Queue A item 11.5)",
    "rebalance": "KV migration (Queue A item 11.5)",
    "affinity": "the fleet router (Queue A item 12)",
    "no_affinity": "the fleet router (Queue A item 12)",
    "autoscale": "the fleet controller (Queue A item 12)",
    "min_replicas": "the fleet controller (Queue A item 12)",
    "max_replicas": "the fleet controller (Queue A item 12)",
    "canary": "the fleet controller and deploy (Queue A item 12)",
    "canary_bake": "the fleet controller and deploy (Queue A item 12)",
    "reshard_from": "deploy/reshard.py (Queue A item 9.1)",
    "tensor_parallel": "tensor-parallel serving (Queue A item 11.2)",
    "prometheus": "the rest of monitor/ (Queue A item 13)",
    "trace": "monitor/trace (Queue A item 13)",
    "trace_out": "monitor/trace (Queue A item 13)",
    "slo_ttft_ms": "monitor/slo (Queue A item 13)",
    "http_port": "monitor/http (Queue A item 13)",
    "health": "monitor/health and timeseries (Queue A item 13)",
    "ts_cadence": "monitor/timeseries (Queue A item 13)",
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slots", type=int, default=4,
                    help="cache slots = max concurrent decodes")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prefill-len", type=int, default=16,
                    help="prompts are padded to this length (one bucket)")
    ap.add_argument("--prefill-buckets", default="",
                    help="comma-separated padded-length ladder, e.g. '4,16'")
    ap.add_argument("--prefill-batch", type=int, default=1,
                    help="admit up to this many same-bucket requests per "
                         "prefill call")
    ap.add_argument("--prefix-blocks", type=int, default=0,
                    help="dense engine: prefix store blocks (0: off)")
    ap.add_argument("--prefix-block-size", type=int, default=4)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="every burst prompt starts with a shared prefix "
                         "of this many tokens (0: fully ragged)")
    ap.add_argument("--paged-kv", action="store_true",
                    help="the shared paged block store")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="paged: store blocks incl. the scratch block "
                         "(0: dense-equivalent capacity)")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-quant", choices=("none", "int8"), default="none")
    ap.add_argument("--speculate", choices=("off", "ngram", "draft"),
                    default="off",
                    help="speculative decoding (needs --paged-kv and "
                         "--temperature 0)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="paged chunked prefill: tokens a step (0: off)")
    ap.add_argument("--verify-parity", action="store_true")
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--eos-id", type=int, default=1,
                    help="token retiring a request early (-1: disabled)")
    ap.add_argument("--watchdog", type=float, default=0.0,
                    help="hang watchdog around every engine call, in "
                         "seconds (0: off)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue (0: unbounded)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request deadline in seconds (0: off)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="label the burst round-robin with this many "
                         "tenants (1: 'default')")
    ap.add_argument("--priority", choices=("interactive", "batch", "mixed"),
                    default="interactive")
    ap.add_argument("--tenant-weights", default="",
                    help="weighted-fair admission: 'name=weight,...'")
    ap.add_argument("--brownout", type=int, default=0,
                    help="arm the brownout ladder up to this level (0: off)")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA card; 'cpu' to ask for "
                         "the CPU")
    for flag in ("replicas", "prefill_replicas", "decode_replicas",
                 "min_replicas", "max_replicas", "http_port", "trace"):
        ap.add_argument("--" + flag.replace("_", "-"), type=int,
                        default=None, help="not ported yet")
    for flag in ("canary_bake", "slo_ttft_ms", "ts_cadence"):
        ap.add_argument("--" + flag.replace("_", "-"), type=float,
                        default=None, help="not ported yet")
    for flag in ("reshard_from", "trace_out"):
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help="not ported yet")
    for flag in ("share_prefixes", "rebalance", "affinity", "no_affinity",
                 "autoscale", "canary", "tensor_parallel", "prometheus",
                 "health"):
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        default=None, help="not ported yet")
    return ap


def _check_flags(args) -> None:
    for flag, what in _UNPORTED.items():
        value = getattr(args, flag)
        if value is None or (flag == "replicas" and value == 1):
            continue
        raise SystemExit(f"--{flag.replace('_', '-')} needs {what}, which "
                         "is not ported yet (ROADMAP.md)")
    if args.paged_kv and args.prefix_blocks:
        raise SystemExit("--paged-kv keeps the prefix cache on the shared "
                         "block store; drop --prefix-blocks and size it "
                         "with --kv-blocks/--kv-block-size")
    if args.speculate != "off" and not args.paged_kv:
        raise SystemExit("--speculate commits accepted tokens into shared "
                         "block-store blocks; add --paged-kv")
    if args.speculate != "off" and args.temperature != 0.0:
        raise SystemExit("--speculate verifies drafts against the greedy "
                         "argmax; pass --temperature 0")
    if args.chunk_tokens and not args.paged_kv:
        raise SystemExit("--chunk-tokens stages chunks on the shared block "
                         "store; add --paged-kv")


def _scheduler_kw(args) -> tuple[dict, object]:
    """The client's scheduler keywords (fairness, brownout, deadlines,
    chunking) and the brownout policy, if armed."""
    kw = dict(max_queue=args.max_queue or None,
              default_deadline_s=args.deadline or None,
              chunk_tokens_per_step=args.chunk_tokens or None)
    if args.tenant_weights:
        weights = {}
        for pair in args.tenant_weights.split(","):
            name, _, w = pair.partition("=")
            if not w:
                raise SystemExit(f"--tenant-weights: '{pair}' is not "
                                 "name=weight")
            weights[name.strip()] = float(w)
        kw.update(fair=True, tenant_weights=weights)
    policy = None
    if args.brownout:
        from chainermn_torch.serving.fairness import BrownoutPolicy

        policy = BrownoutPolicy(max_level=args.brownout,
                                queue_high=float(args.slots),
                                up_after_s=0.05, down_after_s=0.2,
                                cooldown_s=0.1)
        kw["brownout"] = policy
    return kw, policy


def _parity(model, jobs, args, eos) -> dict:
    """Up to three completed requests against solo ``generate()``; a
    greedy divergence passes only at a recorded near-tie."""
    tol = _TIE_TOL[model.compute_dtype]
    checked, near_ties = 0, []
    for h, prompt, n_new, seed in jobs:
        if h.state.value != "done" or checked >= 3:
            continue
        ref = generate(model, prompt[None], n_new,
                       temperature=args.temperature, seed=seed,
                       eos_id=eos)[0].cpu().numpy()
        out = h.output
        bad = np.flatnonzero(out != ref[:len(out)])
        if bad.size:
            at = int(bad[0])
            gap = None
            if args.temperature == 0.0:
                with torch.no_grad():
                    lg = model(torch.as_tensor(ref[None, :at],
                                               device=model.device))[0, -1]
                top2 = torch.topk(lg.float(), 2).values
                gap = float(top2[0] - top2[1])
            if gap is None or gap >= tol:
                raise AssertionError(
                    f"request {h.id} diverged from solo generate() at "
                    f"token {at} (top-2 gap {gap}, tie tolerance {tol})")
            near_ties.append({"request": h.id, "position": at,
                              "top2_gap": gap})
        checked += 1
    return {"checked": checked, "near_ties": near_ties}


def main(argv=None) -> dict:
    """Run the demo with ``argv`` (``sys.argv[1:]`` when ``None``); returns
    the served count, the metrics report, the engine's speculative,
    prefix and paged-store statistics, the brownout episode and the
    parity check."""
    args = _parser().parse_args(argv)
    _check_flags(args)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    max_len = args.prefill_len + args.max_new
    model = TransformerLM(args.vocab, args.d_model, args.heads, args.layers,
                          max_len=max_len, compute_dtype=dtype,
                          device=device, seed=0)
    rng = np.random.RandomState(0)
    buckets = (tuple(int(b) for b in args.prefill_buckets.split(","))
               if args.prefill_buckets else None)
    paged_kw = {}
    if args.paged_kv:
        paged_kw = dict(kv_blocks=args.kv_blocks or None,
                        kv_block_size=args.kv_block_size,
                        kv_quant=args.kv_quant)
    spec_cfg = None
    if args.speculate != "off":
        from chainermn_torch.serving import SpeculativeConfig

        draft = None
        if args.speculate == "draft":
            draft = TransformerLM(args.vocab, max(16, args.d_model // 2),
                                  max(1, args.heads // 2), 1,
                                  max_len=max_len, compute_dtype=dtype,
                                  device=device, seed=2)
        spec_cfg = SpeculativeConfig(k=args.spec_k, drafter=args.speculate,
                                     draft_model=draft)
    engine = ServingEngine(
        model, n_slots=args.slots, prefill_len=args.prefill_len,
        prefill_buckets=buckets, prefill_batch=args.prefill_batch,
        prefix_cache_blocks=args.prefix_blocks,
        prefix_block_size=args.prefix_block_size, paged=args.paged_kv,
        speculative=spec_cfg, temperature=args.temperature,
        watchdog=args.watchdog or None, device=device, **paged_kw)
    engine.warmup()      # first-call costs off the burst's clock
    sched_kw, brownout = _scheduler_kw(args)
    eos = None if args.eos_id < 0 else args.eos_id
    shared = (rng.randint(2, args.vocab, args.shared_prefix)
              .astype(np.int32) if args.shared_prefix
              else np.zeros((0,), np.int32))
    t0 = time.time()
    rejected = shed_or_failed = 0
    jobs = []
    with ServingClient(engine, eos_id=eos, **sched_kw) as client:
        tail_max = max(1, args.prefill_len - len(shared))
        stream_toks: list[int] = []
        streamed = client.submit(
            np.concatenate([shared, rng.randint(2, args.vocab,
                                                min(5, tail_max))
                            .astype(np.int32)]),
            args.max_new, seed=1, stream_cb=stream_toks.append)
        handles = []
        tenants = ([f"tenant{j}" for j in range(args.tenants)]
                   if args.tenants > 1 else ["default"])
        for i in range(args.requests - 1):
            prompt = np.concatenate([shared, rng.randint(
                2, args.vocab, rng.randint(1, tail_max + 1))
                .astype(np.int32)])
            n_new = int(rng.randint(1, args.max_new + 1))
            prio = ("batch" if args.priority == "batch"
                    or (args.priority == "mixed" and i % 2 == 1)
                    else "interactive")
            try:
                h = client.submit(prompt, n_new, seed=100 + i,
                                  tenant=tenants[i % len(tenants)],
                                  priority=prio)
            except QueueFullError:
                rejected += 1
                continue
            handles.append(h)
            jobs.append((h, prompt, n_new, 100 + i))
        for h in handles + [streamed]:
            try:
                h.wait(timeout=600)
            except Exception as e:  # noqa: BLE001 — shed past a deadline
                shed_or_failed += 1
                print(f"request {h.id}: {type(e).__name__}: {e}")
        report = client.metrics.report()
    wall = time.time() - t0
    print(f"streamed request: {len(stream_toks)} tokens "
          f"(first few: {stream_toks[:8]})")
    done = (sum(h.state.value == "done" for h in handles)
            + (streamed.state.value == "done"))
    print(f"{done}/{args.requests} requests served in {wall:.2f}s through "
          f"{args.slots} slots ({rejected} rejected at admission, "
          f"{shed_or_failed} shed/failed)", flush=True)
    for k, v in sorted(report.items()):
        print(f"  {k}: {v}")
    summary = {"served": done, "requests": args.requests,
               "rejected": rejected, "shed_or_failed": shed_or_failed,
               "wall_s": wall, "report": report,
               "streamed_tokens": len(stream_toks),
               "compute_dtype": str(dtype).split(".")[-1],
               "spec": engine.spec_stats(), "prefix": engine.prefix_stats(),
               "kv": engine.kv_stats()}
    if brownout is not None:
        bj = brownout.to_json()
        summary["brownout"] = bj
        print(f"brownout episode: steps={bj['steps']} "
              f"final_level={bj['level']} ({bj['action']}) "
              f"last_reason={bj['last_reason']}")
    if args.verify_parity:
        summary["parity"] = _parity(model, jobs, args, eos)
        print(f"parity vs solo generate: OK "
              f"({summary['parity']['checked']} requests, "
              f"{len(summary['parity']['near_ties'])} near-tie(s))")
    for name in ("prefix", "kv", "spec"):
        if summary[name]:
            print(f"{name}: " + ", ".join(f"{k}={v}" for k, v in
                                          summary[name].items()))
    summary["executables"] = engine.compile_counts_detailed()
    summary["recompiles"] = engine.recompiles
    print(f"engine executables: {summary['executables']} "
          f"(captured={engine.capture}, recompiles={summary['recompiles']})")
    return summary


if __name__ == "__main__":
    main()
