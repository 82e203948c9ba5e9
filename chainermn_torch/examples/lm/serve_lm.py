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
- the fleet: ``--replicas N`` engines behind a ``FleetRouter`` (prefix
  affinity, ``--no-affinity`` for pure least-loaded);
  ``--prefill-replicas P --decode-replicas D`` (with ``--paged-kv``):
  disaggregated tiers, every request's KV migrating to the decode tier
  after its prefill; ``--share-prefixes``: cross-replica prefix sharing;
  ``--rebalance``: one live decode moved from the busiest replica to a
  peer while the burst is in flight. Each replica's engine has weights of
  its own (the same seed);
- the control plane: ``--health`` samples every registry series at
  ``--ts-cadence`` and scores each replica healthy, degraded or critical
  (TTFT drift, queue depth, decode stall), printed at the end;
  ``--autoscale`` runs a ``FleetController`` that scales the fleet
  between ``--min-replicas`` and ``--max-replicas`` on sustained queue
  pressure or idleness, and with ``--canary`` deploys every float tensor
  bumped by 0.01 after the burst: one replica takes it, bakes for
  ``--canary-bake`` seconds against the fleet's health, then the rest
  roll (or all roll back); ``--slo-ttft-ms`` declares a TTFT p99 SLO and
  prints its burn rates;
- ``--verify-parity``: the first three completed requests against solo
  ``generate()`` with the same seed. Under greedy decoding a divergence
  passes only where the reference's top-2 logit gap at that token is
  below the compute dtype's tie tolerance (1e-4 in float32, 1e-2 in
  bfloat16): the engine's and ``generate()``'s products differ in shape,
  so a near-tie may round either way.

``--trace N`` traces every Nth request (the scheduler's span tree:
queue, admit, prefill, one decode_step a token, retire; shed and errored
requests are always kept; 0 disables tracing) and ``--trace-out FILE``
writes the retained traces as Chrome trace-event JSON.

Every scheduler keeps a per-tenant cost ledger: the run prints the
tenant bill (device seconds by kind, KV block-seconds, queue wait) and
the goodput split. ``--http-port P`` serves the monitor's scrape
endpoints (``/metrics``, ``/traces``, ``/slo``, ``/events``, ``/fleet``,
``/timeseries``, ``/health``, ``/control``, ``/costs``; 0 picks a free
port) for the burst and scrapes its own ``/costs``; ``--prometheus``
prints the registry's Prometheus exposition at the end.

``--tensor-parallel``: every rank (one process each, ``RANK``/
``WORLD_SIZE`` set) builds the LM with its blocks sharded over a tensor
axis of all the ranks and the same engine over its local heads; rank 0
serves the burst and prints everything, the others replay its programs
(``ServingEngine.follow``). ``--reshard-from DIR`` restores the weights
from a ``train_lm.py --snapshot-to`` snapshot through
``deploy.elastic_restore``, permuting the qkv columns from the
snapshot's TP degree to this run's. ``--verify-parity`` of a
tensor-parallel run holds the streams to solo ``generate()`` of the
dense LM on the same weights.

Run on the card (the model computes in bfloat16 there, float32 on the
CPU)::

    python -m chainermn_torch.examples.lm.serve_lm --requests 16 --slots 4
    python -m chainermn_torch.examples.lm.serve_lm --paged-kv \\
        --temperature 0 --speculate ngram --spec-k 4 --verify-parity
    python -m chainermn_torch.examples.lm.serve_lm --paged-kv \\
        --prefill-replicas 1 --decode-replicas 1 --verify-parity
    python -m chainermn_torch.examples.lm.serve_lm --replicas 2 --paged-kv \\
        --kv-block-size 2 --shared-prefix 12 --share-prefixes --rebalance
    python -m chainermn_torch.examples.lm.serve_lm --autoscale \\
        --min-replicas 1 --max-replicas 3 --slots 1 --requests 24 --canary
    # on each of 4 ranks, a snapshot train_lm.py saved at tp = 2:
    python -m chainermn_torch.examples.lm.serve_lm --tensor-parallel \\
        --reshard-from snap --verify-parity

``main(argv)`` returns a summary dict.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from chainermn_torch._device import resolve_device
from chainermn_torch.fleet import FleetRouter
from chainermn_torch.models import TransformerLM, generate
from chainermn_torch import monitor
from chainermn_torch.monitor import get_registry, get_tracer
from chainermn_torch.serving import (
    QueueFullError,
    ServingClient,
    ServingEngine,
)

_TIE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the fleet router (1: the "
                         "single-engine client)")
    ap.add_argument("--prefill-replicas", type=int, default=0,
                    help="disaggregated tiers (with --paged-kv and "
                         "--decode-replicas): the first P replicas prefill "
                         "every new request, whose KV then migrates to a "
                         "decode-tier replica (0: a symmetric fleet)")
    ap.add_argument("--decode-replicas", type=int, default=0,
                    help="disaggregated tiers: replicas that only decode "
                         "migrated requests (the fleet is P + D)")
    ap.add_argument("--share-prefixes", action="store_true",
                    help="cross-replica prefix sharing (a --paged-kv fleet "
                         "with affinity): an affinity miss on a prefix "
                         "another replica holds imports its blocks before "
                         "the admission")
    ap.add_argument("--rebalance", action="store_true",
                    help="move one live decode from the busiest replica "
                         "to a peer while the burst is in flight (a "
                         "--paged-kv fleet)")
    ap.add_argument("--affinity", dest="affinity", action="store_true",
                    default=True, help="prefix-affinity routing (default)")
    ap.add_argument("--no-affinity", dest="affinity", action="store_false",
                    help="pure occupancy-aware least-loaded routing")
    ap.add_argument("--autoscale", action="store_true",
                    help="a background FleetController scales the fleet "
                         "between --min-replicas and --max-replicas on "
                         "sustained queue pressure or idleness (implies "
                         "the fleet and the --health wiring)")
    ap.add_argument("--min-replicas", type=int, default=1,
                    help="autoscale floor (and the starting fleet when "
                         "--replicas is smaller)")
    ap.add_argument("--max-replicas", type=int, default=3,
                    help="autoscale ceiling")
    ap.add_argument("--canary", action="store_true",
                    help="after the burst, deploy the weights bumped by "
                         "0.01 through the controller's canary (needs "
                         "--autoscale)")
    ap.add_argument("--canary-bake", type=float, default=1.0,
                    help="canary bake window in seconds")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="a TTFT p99 SLO at this many ms, its burn rates "
                         "printed at the end (0: none)")
    ap.add_argument("--health", action="store_true",
                    help="continuous telemetry: sampled series, the "
                         "standard detectors and a health verdict per "
                         "replica, printed at the end")
    ap.add_argument("--ts-cadence", type=float, default=0.05,
                    help="collector sampling cadence in seconds")
    ap.add_argument("--trace", type=int, default=1, metavar="N",
                    help="trace every Nth request (span tree: queue -> "
                         "admit -> prefill -> decode -> retire; "
                         "shed/errored requests are always kept). "
                         "0 disables tracing")
    ap.add_argument("--trace-out", default="",
                    help="write retained traces as Chrome trace-event "
                         "JSON to this path (chrome://tracing or "
                         "ui.perfetto.dev)")
    ap.add_argument("--http-port", type=int, default=-1,
                    help="serve the monitor scrape endpoints on this port "
                         "for the burst (0: a free port; -1: off)")
    ap.add_argument("--reshard-from", default="",
                    help="restore the weights from a ShardedCheckpointer "
                         "snapshot (train_lm.py --snapshot-to) through "
                         "deploy.elastic_restore, at this run's TP degree")
    ap.add_argument("--tensor-parallel", action="store_true",
                    help="shard the heads over every rank; rank 0 serves, "
                         "the others replay its programs")
    ap.add_argument("--prometheus", action="store_true",
                    help="print the Prometheus text exposition of the "
                         "process metrics registry at the end")
    return ap


def _check_flags(args) -> None:
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
    if args.tensor_parallel and (args.replicas > 1 or args.prefill_replicas
                                 or args.decode_replicas or args.autoscale
                                 or args.share_prefixes or args.rebalance):
        raise SystemExit("--tensor-parallel serves one engine over all the "
                         "ranks; the fleet flags do not combine with it "
                         "here")
    if args.canary and not args.autoscale:
        raise SystemExit("--canary deploys through the controller; add "
                         "--autoscale")
    tiered = bool(args.prefill_replicas or args.decode_replicas)
    if tiered:
        if not (args.prefill_replicas and args.decode_replicas):
            raise SystemExit("disaggregated tiers need BOTH "
                             "--prefill-replicas and --decode-replicas")
        if not args.paged_kv:
            raise SystemExit("KV migration moves block-store rows; the "
                             "tiers need --paged-kv")
        if args.autoscale:
            raise SystemExit("--autoscale resizes a symmetric fleet; "
                             "static tiers don't mix with it")
    if args.share_prefixes or args.rebalance:
        if not args.paged_kv:
            raise SystemExit("--share-prefixes/--rebalance move "
                             "block-store rows; add --paged-kv")
        if not (args.replicas > 1 or tiered or args.autoscale):
            raise SystemExit("--share-prefixes/--rebalance need a fleet; "
                             "add --replicas 2 (or more)")
        if args.share_prefixes and not args.affinity:
            raise SystemExit("--share-prefixes finds holders through the "
                             "affinity trie; drop --no-affinity")


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


def _reshard(args, model, tp) -> dict:
    """``--reshard-from``: the snapshot's parameters into ``model`` through
    ``elastic_restore`` (the qkv columns permuted from the snapshot's TP
    degree to this run's)."""
    from chainermn_torch.deploy import elastic_restore
    from chainermn_torch.extensions import ShardedCheckpointer

    is_tp = model.tensor_axis is not None
    with ShardedCheckpointer(args.reshard_from) as cp:
        mf = cp.manifest() or {}
        if bool(mf.get("tensor_parallel", is_tp)) != is_tp:
            raise SystemExit(
                f"--reshard-from {args.reshard_from}: the snapshot's blocks "
                f"are {'tensor-parallel' if not is_tp else 'dense'}; serve "
                f"it {'with' if not is_tp else 'without'} --tensor-parallel")
        restored, step = elastic_restore(cp, {"params": model.state_dict()},
                                         comm=tp, model=model)
    if restored is None:
        raise SystemExit(f"--reshard-from {args.reshard_from}: no snapshot "
                         "found")
    rec = {"step": step, "save_tp_degree": int(mf.get("tp_degree", 1)),
           "serve_tp_degree": tp.axis_size("tp") if tp is not None else 1}
    if tp is None or tp.rank == 0:
        print(f"resharded snapshot step {step}: save-time tp_degree="
              f"{rec['save_tp_degree']} -> serving tp_degree="
              f"{rec['serve_tp_degree']}", flush=True)
    return rec


def _dense_twin(model, n_tp: int):
    """The dense LM holding a tensor-parallel ``model``'s weights (qkv
    columns in the dense order): the solo reference of
    ``--verify-parity``, run on rank 0 alone."""
    from chainermn_torch.parallel.tensor import reshard_tp_qkv

    sd = reshard_tp_qkv(model.state_dict(), model.n_heads,
                        model.d_model // model.n_heads, n_tp, 1)
    dense = TransformerLM(model.vocab_size, model.d_model, model.n_heads,
                          model.n_layers, model.d_ff, model.max_len,
                          model.compute_dtype, device=model.device)
    dense.load_state_dict({k.replace("attn.", "").replace("mlp.", ""): v
                           for k, v in sd.items()})
    return dense


def main(argv=None) -> dict:
    """Run the demo with ``argv`` (``sys.argv[1:]`` when ``None``); returns
    the served count, the metrics report, the engine's speculative,
    prefix and paged-store statistics, the brownout episode, the parity
    check and, for a fleet, its report (a ``--tensor-parallel`` follower
    rank: the programs it replayed)."""
    args = _parser().parse_args(argv)
    _check_flags(args)
    device = resolve_device(args.device)
    tp, closers = None, []
    if args.tensor_parallel:
        import chainermn_torch
        from chainermn_torch.parallel.mesh import make_3d_mesh

        base = chainermn_torch.create_communicator("tpu", device=device)
        tp = chainermn_torch.MeshCommunicator(
            make_3d_mesh(shape=(1, 1, base.size)), device=device)
        closers += [tp.finalize, base.finalize]
    try:
        return _serve(args, device, tp, closers)
    finally:
        for close in closers:
            close()


def _serve(args, device, tp, closers) -> dict:
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    max_len = args.prefill_len + args.max_new

    def new_model():
        return TransformerLM(args.vocab, args.d_model, args.heads,
                             args.layers, max_len=max_len,
                             compute_dtype=dtype,
                             tensor_axis="tp" if tp is not None else None,
                             device=device, seed=0)

    model = new_model()
    reshard = _reshard(args, model, tp) if args.reshard_from else None
    ref_model = model
    if tp is not None and args.verify_parity and tp.rank == 0:
        ref_model = _dense_twin(model, tp.axis_size("tp"))
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
    def new_engine(m):
        return ServingEngine(
            m, n_slots=args.slots, prefill_len=args.prefill_len,
            prefill_buckets=buckets, prefill_batch=args.prefill_batch,
            prefix_cache_blocks=args.prefix_blocks,
            prefix_block_size=args.prefix_block_size, paged=args.paged_kv,
            speculative=spec_cfg, temperature=args.temperature,
            watchdog=args.watchdog or None, comm=tp, device=device,
            **paged_kw)

    engine = new_engine(model)
    if not engine.tp_leader:
        return {"follower": True, "programs": engine.follow(),
                "reshard": reshard}
    closers.insert(0, engine.close)      # release the followers first
    sched_kw, brownout = _scheduler_kw(args)
    eos = None if args.eos_id < 0 else args.eos_id
    tiered = bool(args.prefill_replicas)
    n_engines = (args.prefill_replicas + args.decode_replicas if tiered
                 else max(args.replicas, args.min_replicas)
                 if args.autoscale else args.replicas)
    fleet_mode = n_engines > 1 or args.autoscale
    if fleet_mode:
        # each replica on weights of its own (the same seed): a weight
        # swap writes an engine's parameters in place
        engines = [engine] + [new_engine(new_model())
                              for _ in range(n_engines - 1)]
        tier_kw = (dict(prefill_replicas=args.prefill_replicas,
                        decode_replicas=args.decode_replicas)
                   if tiered else {})
        front = FleetRouter(engines, eos_id=eos, affinity=args.affinity,
                            share_prefixes=args.share_prefixes,
                            **tier_kw, **sched_kw)
        front.wait_ready(600)     # every replica warm, off the burst clock
    else:
        engines = [engine]
        engine.warmup()      # first-call costs off the burst's clock
        front = ServingClient(engine, eos_id=eos, **sched_kw)
    collector = (_health(args, front, fleet_mode)
                 if args.health or args.autoscale else None)
    controller = None
    if args.autoscale:
        from chainermn_torch.fleet import (
            AutoscalePolicy,
            CanaryPolicy,
            FleetController,
        )

        controller = FleetController(
            front, collector,
            engine_factory=lambda: new_engine(new_model()),
            autoscale=AutoscalePolicy(
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas, queue_high=1.0,
                idle_low=0.25, up_after_s=0.2, down_after_s=1.0,
                cooldown_s=0.3),
            canary=CanaryPolicy(bake_s=args.canary_bake), cadence_s=0.05,
            sensor_kw=dict(stall_timeout_s=30.0))
        controller.start()
    get_tracer().configure(sample=args.trace)
    slo_engine = None
    if args.slo_ttft_ms:
        from chainermn_torch.monitor import LatencyObjective, SLOEngine

        slo_engine = SLOEngine().add(LatencyObjective(
            "ttft_p99", "serving_ttft_seconds",
            threshold_s=args.slo_ttft_ms / 1e3, windows=(30.0, 120.0)))
    server = None
    if args.http_port >= 0:
        server = monitor.http.serve(
            port=args.http_port, slo=slo_engine,
            fleet=front if fleet_mode else None, timeseries=collector,
            health=collector.health if collector is not None else None,
            controller=controller,
            costs=None if fleet_mode else front.metrics.costs)
        closers.insert(0, server.close)
        print(f"monitor endpoints at {server.url} (/metrics /traces /slo "
              "/events /fleet /timeseries /health /control /costs)")
    shared = (rng.randint(2, args.vocab, args.shared_prefix)
              .astype(np.int32) if args.shared_prefix
              else np.zeros((0,), np.int32))
    t0 = time.time()
    rejected = shed_or_failed = 0
    jobs = []
    rebalanced = canary = control = health = None
    with front as client:
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
        if args.rebalance:
            # the probe: move one live decode off the busiest replica
            # while the burst is in flight (False: nothing was mid-decode
            # to move when the handshake ran)
            snaps = [r.snapshot() for r in client.replicas]
            busy = [sn for sn in snaps if sn.active_slots > 0]
            src = max(busy or snaps, key=lambda sn: sn.active_slots)
            ticket = client.rebalance_decode(src.replica_id)
            rebalanced = (bool(ticket.wait(30)) if ticket is not None
                          else False)
        for h in handles + [streamed]:
            try:
                h.wait(timeout=600)
            except Exception as e:  # noqa: BLE001 — shed past a deadline
                shed_or_failed += 1
                print(f"request {h.id}: {type(e).__name__}: {e}")
        # before a canary can swap the weights the parity reads
        parity = (_parity(ref_model, jobs, args, eos) if args.verify_parity
                  else None)
        if controller is not None:
            if args.canary:
                canary = _canary(controller, model)
            control = _control_summary(controller)
        if collector is not None:
            # read while the replicas still serve (a closed router's
            # replicas are stopped, which scores critical)
            collector.stop()
            health = dict(collector.health.report(),
                          series=len(collector.store.names()),
                          ticks=collector.ticks)
        if fleet_mode:
            fleet_rep = client.fleet_report()
            ttft = fleet_rep["pooled"]["histograms"].get(
                "serving_ttft_seconds", {})
            report = {
                "fleet_requests_total": fleet_rep["requests_total"],
                "fleet_reroutes_total": fleet_rep["reroutes_total"],
                "fleet_shed_total": fleet_rep["shed_total"],
                "fleet_capacity": fleet_rep["capacity"],
                "affinity_hit_rate": fleet_rep["affinity"]["hit_rate"],
                "ttft_p50_s": ttft.get("p50_s"),
                "ttft_p99_s": ttft.get("p99_s"),
                "tokens_generated": fleet_rep["pooled"]["counters"].get(
                    "serving_tokens_total", 0)}
            cost_rep = fleet_rep["costs"]
        else:
            report = client.metrics.report()
            # printed as its own table below
            cost_rep = report.pop("costs", None)
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
    if cost_rep:
        _print_costs(cost_rep)
    summary = {"served": done, "requests": args.requests,
               "rejected": rejected, "shed_or_failed": shed_or_failed,
               "wall_s": wall, "report": report,
               "streamed_tokens": len(stream_toks),
               "compute_dtype": str(dtype).split(".")[-1],
               "spec": engine.spec_stats(), "prefix": engine.prefix_stats(),
               "kv": engine.kv_stats(),
               "tensor_parallel": tp.axis_size("tp") if tp is not None
               else 1, "reshard": reshard, "costs": cost_rep}
    if brownout is not None:
        bj = brownout.to_json()
        summary["brownout"] = bj
        print(f"brownout episode: steps={bj['steps']} "
              f"final_level={bj['level']} ({bj['action']}) "
              f"last_reason={bj['last_reason']}")
    if args.verify_parity:
        summary["parity"] = parity
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
    if fleet_mode:
        summary["fleet"] = _fleet_summary(client, fleet_rep, rebalanced)
    if controller is not None:
        summary["control"] = dict(control, canary=canary)
    if slo_engine is not None:
        summary["slo"] = slo_engine.evaluate()
        for name, entry in summary["slo"].items():
            print(f"SLO {name}: compliant={entry['compliant']} "
                  f"max_burn_rate={entry['max_burn_rate']} "
                  f"windows={entry['windows']}")
    tracer = get_tracer()
    summary["traces_retained"] = len(tracer.finished())
    if args.trace_out:
        tracer.export_chrome(args.trace_out)
        print(f"wrote {summary['traces_retained']} trace(s) to "
              f"{args.trace_out} (load in chrome://tracing or "
              "ui.perfetto.dev)")
    if health is not None:
        summary["health"] = health
        print(f"health: worst={health['worst']} over "
              f"{health['n_watched']} replica(s), {health['series']} "
              f"series, {health['ticks']} ticks")
        for key, score in sorted(health["replicas"].items()):
            print(f"  replica {key}: {score['state']} "
                  f"(contributing: {score['contributing'] or 'none'})")
    if server is not None:
        summary["http"] = _scrape(server)
        server.close()
    if args.prometheus:
        summary["exposition"] = monitor.exposition()
        print("\n# process metrics registry (Prometheus exposition)")
        print(summary["exposition"], end="")
    return summary


def _print_costs(cost_rep: dict) -> None:
    """The tenant bill: who consumed the device, and how much of the
    measured time did useful work (the goodput split)."""
    dt, gp = cost_rep["device_time"], cost_rep["goodput"]
    print(f"cost accounting: measured={dt['measured_s']}s "
          f"attributed={dt['attributed_s']}s over {dt['dispatches']} "
          f"dispatches (conservation_error={dt['conservation_error']})")
    print("  goodput: " + ", ".join(f"{k}={v}" for k, v in gp.items()))
    for tenant, row in sorted(cost_rep["tenants"].items()):
        print(f"  tenant {tenant}: device={row['device_total_s']}s "
              f"{row['device_s']} kv_block_s={row['kv_block_s']} "
              f"queue_wait_s={row['queue_wait_s']}")


def _scrape(server) -> dict:
    """Scrape this run's own ``/costs`` and ``/metrics`` over the socket,
    as any outside prober would (10 s timeout each)."""
    import json
    from urllib.request import urlopen

    with urlopen(f"{server.url}/costs", timeout=10) as r:
        costs = json.loads(r.read())
    with urlopen(f"{server.url}/metrics", timeout=10) as r:
        metrics_lines = r.read().decode().count("\n")
    if costs:
        print(f"scraped /costs: {len(costs['tenants'])} tenant(s), "
              "conservation_error="
              f"{costs['device_time']['conservation_error']}")
    return {"url": server.url, "costs": costs,
            "metrics_lines": metrics_lines}


def _health(args, front, fleet_mode):
    """The continuous telemetry, started: per-replica sensors, probes and
    the routing penalty for a fleet (``fleet_health``), or the standard
    sensors of the one engine under key ``"0"``."""
    from chainermn_torch.monitor import (
        Collector,
        HealthMonitor,
        fleet_health,
        standard_replica_sensors,
    )

    if fleet_mode:
        collector = fleet_health(front, cadence_s=args.ts_cadence,
                                 stall_timeout_s=30.0)
    else:
        collector = Collector(cadence_s=args.ts_cadence)
        sigs, dets = standard_replica_sensors(
            front.metrics.instance, stall_timeout_s=30.0, tag="0")
        for sig in sigs:
            collector.add_signal(sig)
        for det in dets:
            collector.add_detector(det)
        monitor = HealthMonitor(store=collector.store)
        monitor.watch("0", detectors=dets)
        collector.attach_health(monitor)
        front.metrics.attach_health(lambda m=monitor: m.score_json("0"))
    return collector.start()


def _canary(controller, model) -> dict:
    """The canary end to end, driven by the controller's own thread:
    every float tensor bumped by 0.01 onto one replica, baked, then
    promoted or rolled back. Returns the outcome."""
    with torch.no_grad():
        bumped = {k: v + 0.01 if v.is_floating_point() else v
                  for k, v in model.state_dict().items()}
    controller.deploy(bumped, step=1)
    deadline = time.time() + 120
    while time.time() < deadline:
        rep = controller.report()
        outcome = rep["canary"]["last_outcome"]
        if outcome is not None and rep["phase"] == "idle":
            print(f"canary deploy: {outcome['action']} (replica "
                  f"{outcome['replica']}, version "
                  f"{outcome.get('version')})")
            return outcome
        time.sleep(0.05)
    raise AssertionError("canary deploy never resolved")


def _control_summary(controller) -> dict:
    """The controller's capacity, scale actions, decisions and version
    history, printed as the reference prints them; stops its thread."""
    rep = controller.report()
    controller.stop()
    cur = rep["versions"]["current"]
    print(f"controller: capacity={rep['capacity']} "
          f"target={rep['target_replicas']} "
          f"scale_ups={rep['autoscale']['scale_ups']} "
          f"scale_downs={rep['autoscale']['scale_downs']}")
    for d in rep["decisions"]:
        print(f"  decision: {d}")
    history = [(h["version"], h["source"])
               for h in rep["versions"]["history"]]
    print(f"weights: version={cur['version']} ({cur['source']}) "
          f"history={history}")
    return {"capacity": rep["capacity"],
            "scale_ups": rep["autoscale"]["scale_ups"],
            "scale_downs": rep["autoscale"]["scale_downs"],
            "decisions": rep["decisions"], "history": history}


def _fleet_summary(router, rep: dict, rebalanced) -> dict:
    """The fleet's per-replica states, programs and recompiles, affinity,
    KV reuse, tiers and migrations, printed as the reference prints
    them."""
    out = {"replicas": {}, "affinity": rep["affinity"],
           "kv_reuse": rep["kv_reuse"], "tiers": rep["tiers"],
           "rebalanced": rebalanced,
           "kv_migrations_total": sum(
               v for k, v in get_registry().snapshot()["counters"].items()
               if k.startswith("kv_migrations_total"))}
    for r in router.replicas:
        out["replicas"][r.replica_id] = {
            "state": r.state.value,
            "served": r.metrics.requests_completed,
            "executables": r.engine.compile_counts_detailed(),
            "recompiles": r.engine.recompiles}
        print(f"replica {r.replica_id}: state={r.state.value} "
              f"served={r.metrics.requests_completed} "
              f"recompiles={r.engine.recompiles}")
    print("fleet: " + ", ".join(f"{k}={v}"
                                for k, v in rep["affinity"].items()))
    kr = rep["kv_reuse"]
    pc = kr.get("payload_cache") or {}
    print(f"kv reuse: share_enabled={kr['share_enabled']} "
          f"shares={kr['shares']} rebalances={kr['rebalances']} "
          f"payload_cache_hits={pc.get('hits', 0)} "
          f"payload_cache_imports={pc.get('imports', 0)}")
    if rebalanced is not None:
        print(f"rebalance probe: moved={rebalanced}")
    if rep["tiers"]:
        print(f"tiers: prefill={rep['tiers']['prefill']} "
              f"decode={rep['tiers']['decode']} "
              f"kv_migrations_total={out['kv_migrations_total']}")
    return out


if __name__ == "__main__":
    main()
