#!/usr/bin/env python
"""Language-model training — the long-context / MoE workload, on the port.

The port's twin of ``examples/lm/train_lm.py``: the same flags with the
same defaults and guards, the same synthetic Markov token stream and the
same printed lines, over the port's pieces — ``TransformerLM`` with any
attention kind, ``lm_train_step`` for plain data parallelism,
``--seq-parallel`` (context parallelism), ``--tensor-parallel`` (Megatron,
with ``--vocab-parallel-head``), ``--moe-experts``/``--moe-top-k``
(expert parallelism over the ranks), ``--remat`` and ``--fused-ce``;
``--gspmd`` (the Megatron layout with weights at rest,
:mod:`chainermn_torch.parallel.gspmd`) and ``--pipeline`` (GPipe, one
block a rank, :mod:`chainermn_torch.ops.pipeline`).

One process runs one rank (the reference runs one process over all its
chips): ``--batchsize`` is per rank in the data-parallel modes, each rank
takes its slice of the global batch; ``--device cpu`` runs a rank on the
CPU over gloo. Weights are random from seed 0, the same on every rank.

``--serve-samples N`` serves N shared-context continuations of the
trained model through the dense serving engine with its prefix store
(bucketed, batched prefill), as the reference does.

Not ported yet — each raises ``NotImplementedError`` naming its
ROADMAP.md item: ``--resume``/``--inject-fault`` (``resilient_fit``),
``--prefetch-depth``/``--fetch-every`` (``fit``), ``--publish-to``
(deploy), ``--snapshot-to`` (sharded checkpoints), ``--trace-out``
(``monitor/trace``).

Run one rank on the card::

    python -m chainermn_torch.examples.lm.train_lm --iterations 30 \\
        --moe-experts 8 --moe-top-k 2 --attention flash

Several ranks: one process each, with ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` set.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

import chainermn_torch
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel.moe import MoeStatsAccumulator
from chainermn_torch.training import lm_train_step

_SEQUENCE_KINDS = ("ring", "ring_flash", "zigzag", "zigzag_flash", "ulysses",
                   "ulysses_flash")


def markov_stream(n_tokens: int, vocab: int, order: int = 2, seed: int = 0):
    """Deterministic k-th order Markov chain over ``vocab`` symbols (the
    reference's generator, draw for draw)."""
    rng = np.random.RandomState(seed)
    table = rng.randint(0, vocab, (vocab,) * order)
    out = np.zeros(n_tokens, np.int32)
    out[:order] = rng.randint(0, vocab, order)
    for i in range(order, n_tokens):
        ctx = tuple(out[i - order:i])
        # mostly-deterministic transitions with a little noise
        out[i] = table[ctx] if rng.rand() < 0.9 else rng.randint(0, vocab)
    return out


def _stream_data(args):
    """(tokens, targets, n_seq) arrays from the Markov stream — shared by
    every mode's data prep."""
    stream = markov_stream(args.n_tokens, args.vocab)
    n_seq = (len(stream) - 1) // args.seq_len
    toks = stream[: n_seq * args.seq_len].reshape(n_seq, args.seq_len)
    tgts = stream[1: n_seq * args.seq_len + 1].reshape(n_seq, args.seq_len)
    return toks, tgts, n_seq


def _drop_suffix(acc) -> str:
    s = acc.summary()
    if not s["steps"]:
        return ""
    return (f"  moe_drop mean {s['moe_drop_frac_mean']:.1%} "
            f"max {s['moe_drop_frac_max']:.1%}")


def _compute_dtype(device) -> torch.dtype:
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def _sequential_train_loop(args, comm, step, toks, tgts, n_seq, batch):
    """The strided loop of the pipeline and gspmd modes (no shuffling);
    steps return a loss, or ``(loss, stats)``."""
    t0, seen, first, loss = time.time(), 0, None, None
    acc, losses = MoeStatsAccumulator(), []
    for it in range(1, args.iterations + 1):
        i = (it * batch) % max(1, n_seq - batch)
        out = step(toks[i:i + batch], tgts[i:i + batch])
        loss, stats = out if isinstance(out, tuple) else (out, {})
        acc.update(stats)
        losses.append(loss)
        if it == 1:
            first = float(loss)
            t0, seen = time.time(), 0
            if comm.rank == 0:
                print(f"compiled; first loss {first:.3f}", flush=True)
        seen += batch * args.seq_len
        if it % 20 == 0 and comm.rank == 0:
            print(f"iter {it:4d}  loss {float(loss):.3f}  "
                  f"{seen / (time.time() - t0):.0f} tok/s", flush=True)
    if comm.rank == 0 and loss is not None:
        print(f"done: loss {first:.3f} -> {float(loss):.3f}"
              f"{_drop_suffix(acc)}", flush=True)
    return {"losses": [float(x) for x in losses],
            "tokens_per_sec": seen / max(time.time() - t0, 1e-9),
            "moe_drop": acc.summary()}


def run_gspmd(args, comm) -> dict:
    """Megatron weights at rest: the DENSE TransformerLM with each rank
    storing ~1/n of the parameters and optimizer state
    (parallel.gspmd); MoE uses the gshard einsum-dispatch twin."""
    from chainermn_torch.parallel import gspmd

    model = TransformerLM(
        args.vocab, args.d_model, args.n_heads, args.n_layers,
        max_len=args.max_len or max(args.seq_len, 512),
        compute_dtype=_compute_dtype(comm.device),
        attention=args.attention, moe_experts=args.moe_experts,
        moe_impl="gshard", moe_top_k=args.moe_top_k, remat=args.remat,
        device=comm.device, seed=0)
    toks, tgts, n_seq = _stream_data(args)
    batch = args.batchsize
    if n_seq < batch:
        raise SystemExit(f"need >= {batch} sequences, have {n_seq}")
    gspmd.megatron_shard(model, comm)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    step = gspmd.gspmd_lm_train_step(model, optimizer, comm)
    out = _sequential_train_loop(args, comm, step, toks, tgts, n_seq, batch)
    frac = gspmd.stored_fraction(model, optimizer)
    n_params = frac["n_elements"]
    if comm.rank == 0:
        print(f"{n_params / 1e6:.2f}M params  gspmd megatron layout  "
              f"per-device fraction: params {frac['params']:.3f}, "
              f"opt {frac['opt']:.3f} (1/n = {1 / comm.size:.3f})",
              flush=True)
    return dict(out, n_params=n_params, stored_fraction=frac)


def run_pipeline(args, comm) -> dict:
    """Pipeline-parallel LM: n_stages = the number of ranks, one causal
    transformer block resident a rank; the GPipe fill-drain schedule
    microbatches each step (ops.pipeline)."""
    from chainermn_torch.ops import (
        init_pipeline_lm,
        jit_pp_lm_train_step,
        make_pipeline_lm,
        pp_lm_opt_init,
    )

    n_stages = comm.size
    mods = make_pipeline_lm(
        args.vocab, args.d_model, args.n_heads, n_stages,
        max_len=args.max_len or max(args.seq_len, 512),
        compute_dtype=_compute_dtype(comm.device), device=comm.device)
    init_pipeline_lm(mods, 0, comm.rank)
    toks, tgts, n_seq = _stream_data(args)
    batch = args.batchsize * args.microbatches
    if n_seq < batch:
        raise SystemExit(f"need >= {batch} sequences, have {n_seq}")
    optimizer = pp_lm_opt_init(
        lambda ps: torch.optim.Adam(ps, lr=args.lr), mods)
    step = jit_pp_lm_train_step(mods, optimizer, comm,
                                n_microbatches=args.microbatches)
    mine = sum(p.numel() for m in mods for p in m.parameters())
    block = sum(p.numel() for p in mods[1].parameters())
    n_params = mine + (n_stages - 1) * block
    bubble = (n_stages - 1) / (args.microbatches + n_stages - 1)
    if comm.rank == 0:
        print(f"{n_params / 1e6:.2f}M params  pipeline stages={n_stages} "
              f"microbatches={args.microbatches} "
              f"(bubble fraction {bubble:.1%})", flush=True)
    out = _sequential_train_loop(args, comm, step, toks, tgts, n_seq, batch)
    return dict(out, n_params=n_params, bubble=bubble)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ChainerMN port example: LM")
    parser.add_argument("--vocab", type=int, default=64)
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--batchsize", "-b", type=int, default=4,
                        help="per-rank batch (DP mode) / global batch "
                             "(SP mode)")
    parser.add_argument("--iterations", type=int, default=100)
    parser.add_argument("--attention", default="full",
                        choices=["full", "ring", "ring_flash", "zigzag",
                                 "zigzag_flash", "ulysses", "ulysses_flash",
                                 "flash"])
    parser.add_argument("--seq-parallel", action="store_true",
                        help="shard the SEQUENCE axis over the ranks "
                             "(context parallelism); needs ring/zigzag/"
                             "ulysses (zigzag data is permuted on the host)")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="expert-parallel MoE FFN every 2nd block")
    parser.add_argument("--fused-ce", action="store_true",
                        help="fused chunked head+loss: never builds the "
                             "[B,T,vocab] f32 logits (ops/losses.py)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute block forwards in the backward "
                             "(torch.utils.checkpoint)")
    parser.add_argument("--moe-top-k", type=int, default=1, choices=[1, 2],
                        help="1 = Switch routing, 2 = GShard top-2")
    parser.add_argument("--tensor-parallel", action="store_true",
                        help="Megatron-style TP: heads + FFN width sharded "
                             "over the ranks, batch replicated")
    parser.add_argument("--gspmd", action="store_true",
                        help="Megatron weights at rest: params+opt ~1/n a "
                             "rank (parallel.gspmd); combines with "
                             "--moe-experts via the gshard MoE")
    parser.add_argument("--pipeline", action="store_true",
                        help="pipeline parallelism: one transformer block "
                             "a rank (GPipe fill-drain; ops.pipeline)")
    parser.add_argument("--microbatches", type=int, default=8,
                        help="with --pipeline: microbatches a step "
                             "(bubble fraction = (S-1)/(M+S-1))")
    parser.add_argument("--vocab-parallel-head", action="store_true",
                        help="with --tensor-parallel: shard the LM head "
                             "over the vocab")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--checkpoint-dir", default="./lm_checkpoints")
    parser.add_argument("--save-every", type=int, default=20)
    parser.add_argument("--async-save", action="store_true")
    parser.add_argument("--prefetch-depth", type=int, default=0)
    parser.add_argument("--fetch-every", type=int, default=1)
    parser.add_argument("--inject-fault", type=int, default=0)
    parser.add_argument("--serve-samples", type=int, default=0)
    parser.add_argument("--publish-to", default="")
    parser.add_argument("--publish-every", type=int, default=0)
    parser.add_argument("--snapshot-to", default="")
    parser.add_argument("--trace-out", default="")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--n-tokens", type=int, default=200_000)
    parser.add_argument("--max-len", type=int, default=None,
                        help="positional-embedding table size "
                             "(default: just enough for --seq-len)")
    parser.add_argument("--device", default=None,
                        help="this rank's device (default: the current CUDA "
                             "card; 'cpu' runs over gloo)")
    return parser


def _check_flags(args) -> None:
    """The reference's guards (``train_lm.py:520-573``), then the flags
    whose machinery is not ported yet."""
    if args.pipeline and (args.seq_parallel or args.moe_experts
                          or args.tensor_parallel):
        raise SystemExit("--pipeline uses the whole mesh axis for stages; "
                         "it does not combine with the other parallel "
                         "flags in this example")
    if args.pipeline and args.remat:
        raise SystemExit("--pipeline builds its blocks via make_pipeline_lm, "
                         "which does not thread --remat; the flag would be "
                         "silently ignored (pipeline microbatching already "
                         "bounds live activations to one microbatch per "
                         "stage)")
    if args.fused_ce and (args.pipeline or args.gspmd
                          or args.tensor_parallel):
        raise SystemExit("--fused-ce is the plain/sequence-parallel step's "
                         "fused head+loss; the pipeline/gspmd/TP paths "
                         "build their own steps and would silently ignore "
                         "it (TP's vocab-parallel head already avoids full "
                         "logits)")
    if args.gspmd and (args.seq_parallel or args.tensor_parallel
                       or args.pipeline):
        raise SystemExit("--gspmd is its own layout (plain jit, partitioner "
                         "collectives); it does not combine with "
                         "--seq-parallel/--tensor-parallel/--pipeline")
    if args.gspmd and args.attention not in ("full", "flash"):
        raise SystemExit("--gspmd runs the dense model; --attention must be "
                         "full or flash (sequence-sharded kinds need the "
                         "shard_map step)")
    if args.resume and (args.gspmd or args.pipeline):
        raise SystemExit("--resume wraps the plain/SP/TP/MoE train loop in "
                         "resilient_fit; the gspmd/pipeline modes build "
                         "their own loops and would silently ignore it")
    if (args.prefetch_depth or args.fetch_every > 1) and (
            args.gspmd or args.pipeline or args.resume):
        raise SystemExit("--prefetch-depth/--fetch-every drive the plain "
                         "loop through training.fit; the gspmd/pipeline/"
                         "resume modes build their own loops and would "
                         "silently ignore them")
    if args.publish_to and args.publish_to != "engine":
        raise SystemExit("--publish-to: only the in-process 'engine' "
                         "target exists (a network front would take an "
                         "address here)")
    if args.publish_to and (
            args.gspmd or args.pipeline or args.seq_parallel
            or args.tensor_parallel or args.resume
            or args.prefetch_depth or args.fetch_every > 1):
        raise SystemExit("--publish-to rides the plain synchronous train "
                         "loop (like --serve-samples): it does not "
                         "combine with the sharded-model, resume, or "
                         "async-loop flags")
    if args.snapshot_to and (args.gspmd or args.pipeline or args.resume):
        raise SystemExit("--snapshot-to snapshots the plain/SP/TP loop's "
                         "params; the gspmd/pipeline/resume modes own "
                         "their state layouts and would silently ignore "
                         "it")
    unported = (
        (args.resume or args.inject_fault,
         "--resume/--inject-fault need resilience.resilient_fit"),
        (args.prefetch_depth or args.fetch_every > 1,
         "--prefetch-depth/--fetch-every need training.fit and LossWindow"),
        (args.publish_to, "--publish-to needs deploy's WeightPublisher"),
        (args.snapshot_to,
         "--snapshot-to needs extensions.sharded_checkpoint"),
        (args.trace_out, "--trace-out needs monitor.trace"))
    for flag_set, what in unported:
        if flag_set:
            raise NotImplementedError(
                f"{what}, which is not ported yet (ROADMAP.md, Queue A)")


def main(argv=None) -> dict:
    """Run the example with ``argv`` (``sys.argv[1:]`` when ``None``);
    returns a summary: the mode, the per-step losses, tokens/s after the
    first step, the MoE drop summary, the parameter count and, per mode,
    the stored fraction (gspmd) or the bubble fraction (pipeline)."""
    parser = _parser()
    args = parser.parse_args(argv)
    _check_flags(args)

    chainermn_torch.add_global_except_hook()
    comm = chainermn_torch.create_communicator("tpu", device=args.device)
    try:
        return _run(args, parser, comm)
    finally:
        comm.finalize()


def _run(args, parser, comm) -> dict:
    if args.gspmd:
        return dict(run_gspmd(args, comm), mode="gspmd")
    if args.pipeline:
        if args.n_layers != parser.get_default("n_layers") and (
                args.n_layers != comm.size):
            raise SystemExit(
                f"--pipeline pins the layer count to one block per rank "
                f"({comm.size} here); --n-layers {args.n_layers} would be "
                "silently ignored")
        return dict(run_pipeline(args, comm), mode="pipeline")
    if args.seq_parallel and args.attention not in _SEQUENCE_KINDS:
        raise SystemExit("--seq-parallel needs --attention "
                         "ring|zigzag|ulysses (or a _flash variant)")
    if args.tensor_parallel and (args.seq_parallel or args.moe_experts):
        raise SystemExit("--tensor-parallel uses the whole flat mesh axis; "
                         "it does not combine with --seq-parallel or "
                         "--moe-experts in this example")
    if args.tensor_parallel and args.n_heads % comm.size:
        raise SystemExit(f"--tensor-parallel needs n_heads divisible by the "
                         f"{comm.size}-way mesh axis")
    if args.vocab_parallel_head and not args.tensor_parallel:
        raise SystemExit("--vocab-parallel-head needs --tensor-parallel")

    step_comm = comm
    if args.tensor_parallel:
        from chainermn_torch.parallel.mesh import make_3d_mesh

        step_comm = chainermn_torch.MeshCommunicator(
            make_3d_mesh(shape=(1, 1, comm.size)), device=comm.device)
    try:
        return _run_steps(args, comm, step_comm)
    finally:
        if step_comm is not comm:
            step_comm.finalize()


def _run_steps(args, comm, step_comm) -> dict:
    model = TransformerLM(
        args.vocab, args.d_model, args.n_heads, args.n_layers,
        max_len=args.max_len or max(args.seq_len, 512),
        compute_dtype=_compute_dtype(comm.device), attention=args.attention,
        sequence_axis=comm if args.seq_parallel else None,
        moe_experts=args.moe_experts,
        moe_axis=comm if args.moe_experts else None,
        moe_top_k=args.moe_top_k,
        tensor_axis="tp" if args.tensor_parallel else None,
        vocab_parallel_head=args.vocab_parallel_head, remat=args.remat,
        device=comm.device, seed=0)

    tokens_all, targets_all, n_seq = _stream_data(args)
    n, r = comm.size, comm.rank
    layout = np.arange(args.seq_len)
    if args.seq_parallel and args.attention.startswith("zigzag"):
        # zigzag shards hold (early, late) chunk pairs: permute the data
        # once on the host; the mean loss is permutation-invariant
        from chainermn_torch.parallel.sequence import zigzag_permutation

        layout = zigzag_permutation(args.seq_len, n).numpy()
    if args.seq_parallel or args.tensor_parallel:
        # SP: the sequence shards over the ranks; TP: the weights do and
        # the batch is replicated. Either way --batchsize is global.
        batch = args.batchsize
    else:
        batch = args.batchsize * n
    if n_seq < batch:
        raise SystemExit(
            f"only {n_seq} sequences of length {args.seq_len} in "
            f"{args.n_tokens} tokens but the global batch is {batch}; "
            "raise --n-tokens or lower --batchsize/--seq-len")

    def mine(a):
        """This rank's part of a global batch."""
        if args.seq_parallel:
            t = args.seq_len // n
            return a[:, layout[r * t:(r + 1) * t]]
        if args.tensor_parallel:
            return a
        return a[r * args.batchsize:(r + 1) * args.batchsize]

    def batches():
        epoch = 0
        while True:
            order = np.random.RandomState(1 + epoch).permutation(n_seq)
            epoch += 1
            for i in range(0, n_seq - batch + 1, batch):
                sel = order[i:i + batch]
                yield mine(tokens_all[sel]), mine(targets_all[sel])

    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    if not args.tensor_parallel:
        # the TP step assembles the exact global gradient itself; a
        # multi-node wrapper's extra mean would shrink it by the axis size
        optimizer = chainermn_torch.create_multi_node_optimizer(optimizer,
                                                                comm)
    step = lm_train_step(model, optimizer, step_comm,
                         shard_sequence=args.seq_parallel,
                         fused_ce=args.fused_ce)
    n_params = sum(p.numel() for p in model.parameters())
    if r == 0:
        print(f"{n_params / 1e6:.2f}M params  attention={args.attention} "
              f"seq_parallel={args.seq_parallel} moe={args.moe_experts} "
              f"tensor_parallel={args.tensor_parallel} devices={n}",
              flush=True)

    gen = batches()
    t0, toks = time.time(), 0
    first = None
    acc, losses = MoeStatsAccumulator(), []
    for it in range(1, args.iterations + 1):
        tok, tgt = next(gen)
        loss, stats = step(tok, tgt)
        acc.update(stats)
        losses.append(loss)
        if it == 1:
            first = float(loss)
            t0, toks = time.time(), 0
            if r == 0:
                print(f"compiled; first loss {first:.3f} "
                      f"(uniform = {np.log(args.vocab):.3f})", flush=True)
        toks += batch * args.seq_len
        if it % 20 == 0 and r == 0:
            drop = (f"  moe_drop {float(stats['moe_drop_frac']):.1%}"
                    if stats else "")
            print(f"iter {it:4d}  loss {float(loss):.3f}  "
                  f"{toks / (time.time() - t0):.0f} tok/s{drop}", flush=True)
    last = float(loss)
    if r == 0:
        print(f"done: {args.iterations} iterations, "
              f"loss {first:.3f} -> {last:.3f}{_drop_suffix(acc)}",
              flush=True)
    out = {"mode": "plain", "losses": [float(x) for x in losses],
           "tokens_per_sec": toks / max(time.time() - t0, 1e-9),
           "moe_drop": acc.summary(), "n_params": n_params}
    if args.serve_samples:
        out["serve_samples"] = _serve_samples(args, comm, model, tokens_all)
    return out


def _serve_samples(args, comm, model, tokens_all) -> Optional[dict]:
    """Training to serving in one script: ``--serve-samples`` continuations
    of the trained model through the dense engine's fast path (bucketed
    batched prefill + the prefix store). Every prompt shares the stream's
    opening context, so after the first admission each later one hits the
    prefix cache and prefills only its ragged tail. Rank 0 only; skipped
    for sequence- or tensor-sharded models (rebuild dense to serve, see
    ``serve_lm.py``). An expert-parallel model serves through a
    ``moe_impl='gshard'`` copy of its weights. Returns the samples and
    the prefix statistics."""
    from chainermn_torch.serving import ServingClient, ServingEngine

    if comm.rank != 0:
        return None
    if args.seq_parallel or args.tensor_parallel:
        print("serve-samples: skipped (sequence/tensor-sharded training "
              "model; rebuild dense for inference — see serve_lm.py)")
        return None
    infer = model
    if model.moe_experts:
        infer = TransformerLM(
            model.vocab_size, model.d_model, model.n_heads, model.n_layers,
            d_ff=model.d_ff, max_len=model.max_len,
            compute_dtype=model.compute_dtype, moe_experts=model.moe_experts,
            moe_top_k=model.moe_top_k, moe_impl="gshard",
            device=model.device)
        infer.load_state_dict(model.state_dict())
    ctx_len = min(args.seq_len // 2, 24)
    ctx = np.asarray(tokens_all[0][:ctx_len], np.int32)
    tail_src = np.asarray(tokens_all[1], np.int32)
    bucket_small = 8
    prefill_len = ctx_len + bucket_small
    engine = ServingEngine(
        infer, n_slots=4, prefill_buckets=(bucket_small, prefill_len),
        prefill_batch=4, prefix_cache_blocks=32, prefix_block_size=4,
        cache_len=prefill_len + 16, paged=False, device=model.device)
    engine.warmup()
    n = args.serve_samples
    print(f"serving {n} shared-context continuations "
          f"(ctx={ctx_len} tokens, prefix-cached, bucketed prefill):")
    samples = []
    with ServingClient(engine) as client:
        reqs = [client.submit(
            np.concatenate([ctx, tail_src[:1 + i % bucket_small]]), 12,
            seed=i) for i in range(n)]
        for i, req in enumerate(reqs):
            req.wait(timeout=300)
            samples.append([int(t) for t in req.output])
            print(f"  sample {i}: ...{samples[-1][-8:]}")
    stats = engine.prefix_stats()
    print(f"prefix cache: hit_rate={stats['hit_rate']} "
          f"hits={stats['hits']} inserted_blocks={stats['inserted_blocks']}")
    return {"samples": samples, "prefix": stats}


if __name__ == "__main__":
    main()
