#!/usr/bin/env python
"""Seq2seq model-parallel training — encoder and decoder on different
ranks, on the port.

The twin of ``examples/seq2seq/seq2seq.py``: the same flags, defaults,
task and printed lines. The task is synthetic sequence reversal (source:
random tokens in ``[1, vocab)``, target: its reverse, decoder input: the
BOS-shifted target). Every rank of a pair declares the same
:class:`~chainermn_torch.MultiNodeChainList`: the GRU :class:`Encoder` on
the pair's even rank sends its final state and the decoder inputs to the
:class:`Decoder` on the odd rank; the state's gradient comes back by the
backward transfer, the integer decoder inputs carry none.

``--hybrid`` (an even number of ranks, at least 4) is data x model
parallelism: ranks ``{2g, 2g+1}`` form pair ``g``, each pair trains the
whole chain on its own shard of every batch, and each role's gradients
are averaged across the pairs by a multi-node optimizer over
``comm.split(rank % 2)`` — the split-by-role topology of the reference's
hybrid example.

Run two ranks (``--device cpu`` for gloo on the CPU)::

    for r in 0 1; do RANK=$r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 \\
      MASTER_PORT=29513 python -m chainermn_torch.examples.seq2seq.seq2seq \\
      & done; wait
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

import chainermn_torch
from chainermn_torch.interop import gru_params_from_flax
from chainermn_torch.models.resnet import _lecun_normal_

BOS = 0  # decoder start token; task vocabulary occupies [1, vocab)


def _no_rz_hidden_bias(grad):
    """flax's ``GRUCell`` has no hidden bias on the r and z gates: their
    blocks of ``bias_hh`` get no gradient, so they stay at zero."""
    grad = grad.clone()
    grad[:2 * grad.shape[0] // 3] = 0
    return grad


def _init_gru(gru: nn.GRU, gen) -> None:
    """flax ``GRUCell``'s initialisers (lecun-normal input kernels,
    orthogonal recurrent kernels, zero biases) and its parameters: the r
    and z blocks of the hidden bias are held at zero."""
    gru.bias_hh_l0.register_hook(_no_rz_hidden_bias)
    with torch.no_grad():
        for g in gru.weight_ih_l0.chunk(3):
            _lecun_normal_(g, gru.input_size, gen)
        for g in gru.weight_hh_l0.chunk(3):
            g.copy_(nn.init.orthogonal_(torch.empty(g.shape), generator=gen))
        gru.bias_ih_l0.zero_()
        gru.bias_hh_l0.zero_()


def _embedding(vocab: int, units: int, gen) -> nn.Embedding:
    """flax ``Embed``'s initialiser: normal with variance 1/units."""
    emb = nn.Embedding(vocab, units)
    with torch.no_grad():
        emb.weight.copy_(torch.randn(vocab, units, generator=gen)
                         / math.sqrt(units))
    return emb


class Encoder(nn.Module):
    """Stage 0: embed the source tokens, run a GRU, emit the final state,
    and pass the decoder inputs through (the boundary payload carries
    everything the next stage consumes)."""

    def __init__(self, vocab: int, units: int, seed: int = 0) -> None:
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.embed = _embedding(vocab, units, gen)
        self.gru = nn.GRU(units, units, batch_first=True)
        _init_gru(self.gru, gen)

    def forward(self, src, tgt_in):
        _, state = self.gru(self.embed(src))
        return state[0], tgt_in


class Decoder(nn.Module):
    """Stage 1: a teacher-forced GRU started from the encoder's state,
    projecting to logits."""

    def __init__(self, vocab: int, units: int, seed: int = 1) -> None:
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.embed = _embedding(vocab, units, gen)
        self.gru = nn.GRU(units, units, batch_first=True)
        _init_gru(self.gru, gen)
        self.head = nn.Linear(units, vocab)
        with torch.no_grad():
            _lecun_normal_(self.head.weight, units, gen)
            self.head.bias.zero_()

    def forward(self, inputs):
        state, tgt_in = inputs
        ys, _ = self.gru(self.embed(tgt_in), state[None].contiguous())
        return self.head(ys)


def encoder_params_from_flax(variables) -> dict:
    """The JAX example's ``Encoder`` variables as :class:`Encoder`'s
    ``state_dict``."""
    p = variables.get("params", variables)
    return {"embed.weight": torch.from_numpy(
                np.array(p["Embed_0"]["embedding"], np.float32)),
            **gru_params_from_flax(p["GRUCell_0"], "gru")}


def decoder_params_from_flax(variables) -> dict:
    """The JAX example's ``Decoder`` variables as :class:`Decoder`'s
    ``state_dict``."""
    p = variables.get("params", variables)
    head = p["Dense_0"]
    return {**encoder_params_from_flax(p),
            "head.weight": torch.from_numpy(
                np.array(head["kernel"], np.float32).T.copy()),
            "head.bias": torch.from_numpy(np.array(head["bias"], np.float32))}


def make_reversal_batch(rng, n, seq_len, vocab):
    """source: random tokens in [1, vocab); target: reversed source.
    Decoder input is the BOS-shifted target (teacher forcing)."""
    src = rng.randint(1, vocab, size=(n, seq_len)).astype(np.int32)
    tgt = src[:, ::-1].copy()
    tgt_in = np.concatenate([np.full((n, 1), BOS, np.int32), tgt[:, :-1]],
                            axis=1)
    return src, tgt_in, tgt


def build_chain(comm, vocab, units, rank_enc, rank_dec):
    chain = chainermn_torch.MultiNodeChainList(comm)
    chain.add_link(Encoder(vocab, units), rank=rank_enc, rank_in=None,
                   rank_out=rank_dec)
    chain.add_link(Decoder(vocab, units), rank=rank_dec, rank_in=rank_enc,
                   rank_out=None)
    return chain


def sequence_loss(logits, tgt):
    """Token-mean softmax cross entropy."""
    tgt = torch.as_tensor(tgt, device=logits.device).long()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1))


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ChainerMN-torch example: seq2seq model parallelism")
    parser.add_argument("--batchsize", "-b", type=int, default=64)
    parser.add_argument("--epoch", "-e", type=int, default=20)
    parser.add_argument("--unit", "-u", type=int, default=64)
    parser.add_argument("--vocab", type=int, default=16)
    parser.add_argument("--seq-len", type=int, default=8)
    parser.add_argument("--n-train", type=int, default=2048)
    parser.add_argument("--n-test", type=int, default=256)
    parser.add_argument("--hybrid", action="store_true",
                        help="data x model parallel over >= 4 ranks "
                             "(comm.split by role, reference seq2seq_mp1)")
    parser.add_argument("--device", default=None,
                        help="this rank's device (default: the current CUDA "
                             "card; 'cpu' runs over gloo)")
    return parser


def main(argv=None) -> dict:
    """Run the example with ``argv`` (``sys.argv[1:]`` when ``None``).
    Returns this rank's summary: each epoch's mean training loss (over the
    pairs) and validation token accuracy (pair 0), the steps, the
    training seconds (evaluations excluded) and the devices of this rank's
    parameters."""
    args = _parser().parse_args(argv)

    chainermn_torch.add_global_except_hook()
    comm = chainermn_torch.create_communicator("naive", device=args.device)
    if comm.size < 2:
        raise SystemExit("seq2seq model-parallel example needs >= 2 ranks")
    if args.hybrid and (comm.size < 4 or comm.size % 2):
        raise SystemExit(f"--hybrid needs an even rank count >= 4 (2 per MP "
                         f"pair); got {comm.size}")

    rng = np.random.RandomState(0)
    train = make_reversal_batch(rng, args.n_train, args.seq_len, args.vocab)
    test = make_reversal_batch(rng, args.n_test, args.seq_len, args.vocab)

    n_pairs = comm.size // 2 if args.hybrid else 1
    pair = comm.rank // 2
    in_chain = pair < n_pairs
    is_decoder = in_chain and comm.rank % 2 == 1
    # every pair's chain starts from the same seeded weights (the
    # reference's bcast_data-at-start contract)
    chain = build_chain(comm, args.vocab, args.unit,
                        2 * pair if in_chain else 0,
                        2 * pair + 1 if in_chain else 1)
    dp_comm = comm.split(comm.rank % 2) if args.hybrid else None

    def make_optimizer(params):
        adam = torch.optim.Adam(params, lr=2e-3)
        if dp_comm is None:
            return adam
        # each role's gradients averaged across the pairs
        return chainermn_torch.create_multi_node_optimizer(adam, dp_comm)

    optimizer = (chainermn_torch.create_component_wise_optimizer(
        make_optimizer, chain) if in_chain else None)

    @torch.no_grad()
    def token_accuracy():
        acc = None
        if pair == 0:
            src, tgt_in, tgt = test
            logits = chain(torch.as_tensor(src), torch.as_tensor(tgt_in))
            if is_decoder:
                pred = logits.argmax(-1).cpu().numpy()
                acc = float((pred == tgt).mean())
        return comm.bcast_obj(acc, root=1)

    steps_per_epoch = max(1, args.n_train // args.batchsize)
    epochs = []
    steps = 0
    train_s = 0.0
    t0 = time.time()
    for epoch in range(1, args.epoch + 1):
        t_epoch = time.time()
        perm = rng.permutation(args.n_train)
        losses = []
        for it in range(steps_per_epoch):
            idx = perm[it * args.batchsize:(it + 1) * args.batchsize]
            if not in_chain:
                continue
            shard = np.array_split(idx, n_pairs)[pair]
            src, tgt_in, tgt = (a[shard] for a in train)
            optimizer.zero_grad()
            out = chain(torch.as_tensor(src), torch.as_tensor(tgt_in))
            if is_decoder:
                loss = sequence_loss(out, tgt)
                loss.backward()
                losses.append(loss.detach())
            else:
                out.backward()   # the delegate of the encoder's send
            optimizer.step()
            steps += 1
        mine = float(torch.stack(losses).mean()) if losses else None
        pair_losses = [v for v in comm.allgather_obj(mine) if v is not None]
        train_s += time.time() - t_epoch
        acc = token_accuracy()
        epochs.append({"epoch": epoch, "loss": float(np.mean(pair_losses)),
                       "token_accuracy": acc})
        if comm.rank == 0:
            print(f"epoch {epoch:3d}  train/loss {np.mean(pair_losses):.4f}  "
                  f"val/token_acc {acc:.4f}", flush=True)
    if comm.rank == 0:
        print(f"done in {time.time() - t0:.1f}s  "
              f"(pairs={n_pairs}, hybrid={args.hybrid})", flush=True)
    summary = {"rank": comm.rank, "epochs": epochs, "steps": steps,
               "train_seconds": train_s, "pairs": n_pairs,
               "param_devices": sorted({p.device.type
                                        for p in chain.parameters()})}
    if dp_comm is not None:
        dp_comm.finalize()
    comm.finalize()
    return summary


if __name__ == "__main__":
    main()
