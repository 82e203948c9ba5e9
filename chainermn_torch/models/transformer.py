"""Decoder-only Transformer LM: the dense blocks of
``chainermn_tpu/models/transformer.py`` as ``nn.Module``s, its dense and
paged KV cache constructors, its sampler and its ``generate`` (cached and
cacheless).

Numerics follow the flax model so converted weights give the same
logits: LayerNorm eps 1e-6 with float32 statistics, the tanh form of
GELU, matmuls and embeddings in ``compute_dtype`` (bf16 by default) over
float32 parameters, attention scores and softmax in float32, logits cast
to float32. ``attention`` picks the cacheless forward's attention by
name (``'full'``, ``'flash'`` — the flash kernels — or a
sequence-parallel kind over ``sequence_axis``); the KV-cache path does
not depend on it. ``tensor_axis`` makes every block Megatron's
(:mod:`chainermn_torch.parallel.tensor`), and ``vocab_parallel_head``
shards the head over the vocabulary. ``moe_experts`` routes every
``moe_every``-th block's FFN through experts
(:mod:`chainermn_torch.parallel.moe`), and ``remat`` recomputes each
block's forward in the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from chainermn_torch._device import resolve_device
from chainermn_torch.parallel import tensor as tp
from chainermn_torch.parallel.moe import ExpertParallelMLP, GShardMoE
from chainermn_torch.parallel.sequence import (
    sequence_parallel_attention,
    update_cache_and_attend,
)

_LN_EPS = 1e-6     # flax nn.LayerNorm's default (torch's is 1e-5)
_GENERATE_BLOCK = 16   # block size of generate()'s private paged store


def _layer_norm(ln: nn.LayerNorm, x, dt):
    """flax LayerNorm(dtype=dt): statistics and affine in float32, the
    result cast to ``dt``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dt)


def _dense(lin: nn.Linear, x, dt):
    """flax Dense(dtype=dt): input, kernel and bias cast to ``dt``."""
    return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + proj(attn(LN(x)))`` then ``x + MLP(LN(x))``.
    ``qkv`` is flax's ``DenseGeneral((3, H, Dh))`` flattened to one
    ``Linear(d, 3*H*Dh)`` with outputs in ``(3, H, Dh)`` order; ``proj``
    takes its inputs in ``(H, Dh)`` order. ``attention`` names the
    cacheless forward's attention (see
    :func:`~chainermn_torch.parallel.sequence.sequence_parallel_attention`).

    ``moe_experts > 0`` replaces the dense FFN by routed experts
    (``transformer.py:122-144``): ``moe_impl='ep'`` is
    :class:`~chainermn_torch.parallel.moe.ExpertParallelMLP` over
    ``moe_axis``, ``'gshard'`` the einsum-dispatch
    :class:`~chainermn_torch.parallel.moe.GShardMoE`. Such a block returns
    ``(x, aux_loss)`` without a KV cache; dense blocks return ``x``."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 attention: str = "full", sequence_axis=None,
                 tensor_axis=None, moe_experts: int = 0, moe_axis=None,
                 moe_capacity_factor: float = 1.25, moe_top_k: int = 1,
                 moe_impl: str = "ep", device=None) -> None:
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads "
                             f"{n_heads}")
        if tensor_axis is not None and moe_experts:
            raise ValueError("tensor_axis and moe_experts are mutually "
                             "exclusive on a TransformerBlock")
        if moe_experts and moe_impl not in ("ep", "gshard"):
            raise ValueError(f"moe_impl must be 'ep' or 'gshard', got "
                             f"{moe_impl!r}")
        self.moe_experts, self.moe_impl = moe_experts, moe_impl
        self.d_model, self.n_heads = d_model, n_heads
        self.compute_dtype = compute_dtype
        self.attention = attention
        self.sequence_axis, self.tensor_axis = sequence_axis, tensor_axis
        self._attend = sequence_parallel_attention(attention, sequence_axis,
                                                   causal=True)
        self.ln1 = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        self.ln2 = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        if tensor_axis is not None:
            kw = dict(compute_dtype=compute_dtype, device=device)
            self.attn = tp.TensorParallelAttention(
                d_model, n_heads, tensor_axis, attention=attention,
                sequence_axis=sequence_axis, **kw)
            self.mlp = tp.TensorParallelMLP(d_model, d_ff, tensor_axis, **kw)
            return
        self.qkv = nn.Linear(d_model, 3 * d_model, device=device)
        self.proj = nn.Linear(d_model, d_model, device=device)
        if moe_experts:
            kw = dict(capacity_factor=moe_capacity_factor, top_k=moe_top_k,
                      compute_dtype=compute_dtype, device=device)
            self.moe = (GShardMoE(moe_experts, d_model, d_ff, **kw)
                        if moe_impl == "gshard" else
                        ExpertParallelMLP(moe_experts, d_model, d_ff,
                                          moe_axis, **kw))
            return
        self.fc1 = nn.Linear(d_model, d_ff, device=device)
        self.fc2 = nn.Linear(d_ff, d_model, device=device)

    def forward(self, x, pos_offset=0, kv_cache: Optional[dict] = None):
        """``x [B,T,d]`` in ``compute_dtype``. With ``kv_cache`` (a paged
        layer dict) the block writes its K/V rows into the store in place
        at ``pos_offset`` (int or ``[B]``) and attends through it;
        without, it runs causal attention of the block's ``attention``
        kind (across ``sequence_axis`` for the sequence-parallel kinds).
        A ``tensor_axis`` block is Megatron's: this rank's heads and FFN
        columns, one all-reduce each."""
        dt = self.compute_dtype
        if kv_cache is not None and self.sequence_axis is not None:
            raise ValueError(
                "kv_cache decoding does not support sequence-sharded "
                "blocks — rebuild with sequence_axis=None for inference")
        if kv_cache is not None and self.moe_experts and \
                self.moe_impl != "gshard":
            raise ValueError(
                "kv_cache decoding supports MoE only via moe_impl='gshard' "
                "(the 'ep' experts exchange tokens across the expert axis)")
        if self.tensor_axis is not None:
            if kv_cache is not None:
                raise NotImplementedError(
                    "tensor-parallel decoding (the head-sharded KV store) is "
                    "not ported yet (ROADMAP.md, Queue A: serving)")
            x = x + self.attn(_layer_norm(self.ln1, x, dt))
            return x + self.mlp(_layer_norm(self.ln2, x, dt))
        b, t, _ = x.shape
        dh = self.d_model // self.n_heads
        h = _layer_norm(self.ln1, x, dt)
        qkv = _dense(self.qkv, h, dt).view(b, t, 3, self.n_heads, dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if kv_cache is not None:
            o = update_cache_and_attend(kv_cache, q, k, v, pos_offset)
        else:
            o = self._attend(q, k, v)
        x = x + _dense(self.proj, o.reshape(b, t, self.d_model), dt)
        h = _layer_norm(self.ln2, x, dt)
        if self.moe_experts:
            y, aux = self.moe(h)
            return x + y if kv_cache is not None else (x + y, aux)
        h = F.gelu(_dense(self.fc1, h, dt), approximate="tanh")
        return x + _dense(self.fc2, h, dt)


class TransformerLM(nn.Module):
    """Decoder-only LM. ``forward(tokens [B,T], pos_offset)`` returns
    float32 logits ``[B,T,vocab]``.

    ``pos_offset`` is an int base, a ``[T]`` tensor of positions, or a
    ``[B,T]`` tensor of per-row positions (continuous batching); blocks on
    the cache path take each row's base, column 0 of the ``[B,T]`` form.

    Parameters are created float32 on ``device`` (the current CUDA card
    when ``None``; raises when there is none — pass ``device="cpu"`` for
    the CPU). ``seed`` initialises them from a ``torch.Generator``.
    ``attention`` is every block's cacheless attention; parameters stay
    float32 for training, while serving may store them in
    ``compute_dtype`` with :meth:`cast_weights_`.

    Sequence parallelism: with ``sequence_axis`` (a communicator or a
    mesh axis name) and a sequence-parallel ``attention`` kind, ``tokens``
    is this rank's shard of the sequence and ``pos_offset`` its global
    positions — a scalar base, or zigzag's ``[T_local]`` vector
    (:func:`chainermn_torch.training.lm_train_step` passes them). Tensor
    parallelism: ``tensor_axis`` makes every block Megatron's, and
    ``vocab_parallel_head`` shards the head too, so ``forward`` returns
    this rank's ``[B, T, vocab/n]`` slice of the logits.

    Mixture of experts (``transformer.py:175-186``): with
    ``moe_experts > 0`` block ``i`` is an MoE block when ``i % moe_every
    == moe_every - 1``; ``moe_impl='ep'`` shards the experts over
    ``moe_axis`` (a communicator or a bound axis name), ``'gshard'`` runs
    the einsum dispatch in one process (or at rest over a tensor axis,
    :mod:`chainermn_torch.parallel.gspmd`). ``forward(...,
    return_aux=True)`` also returns the blocks' summed aux loss, and
    :meth:`moe_stats` the last forward's routing records.
    ``forward(..., return_hidden=True)`` stops before the head and returns
    the final LayerNorm's output, for the fused head and loss
    (:func:`~chainermn_torch.ops.losses.chunked_softmax_cross_entropy`).
    ``remat=True`` wraps each block in ``torch.utils.checkpoint``
    (non-reentrant) when gradients are recorded, never on the KV-cache
    path: only block boundaries stay alive for the backward, which runs
    each block's forward again (its collectives and kernels included).

    The reference's guards hold: no KV cache with ``sequence_axis`` or
    with ``moe_impl='ep'``, ``tensor_axis`` excludes ``moe_experts``,
    ``vocab_parallel_head`` needs ``tensor_axis`` and excludes
    ``return_hidden``."""

    def __init__(self, vocab_size: int, d_model: int = 512,
                 n_heads: int = 8, n_layers: int = 6,
                 d_ff: Optional[int] = None, max_len: int = 65536,
                 compute_dtype: torch.dtype = torch.bfloat16, *,
                 attention: str = "full", sequence_axis=None,
                 tensor_axis=None, vocab_parallel_head: bool = False,
                 moe_experts: int = 0, moe_axis=None, moe_every: int = 2,
                 moe_capacity_factor: float = 1.25, moe_top_k: int = 1,
                 moe_impl: str = "ep", remat: bool = False, device=None,
                 seed: Optional[int] = None) -> None:
        super().__init__()
        if tensor_axis is not None and moe_experts:
            raise ValueError(
                "tensor_axis and moe_experts are mutually exclusive: the MoE "
                "blocks' expert axis and the TP axis would need a combined "
                "gradient pattern this model does not define")
        if vocab_parallel_head and tensor_axis is None:
            raise ValueError("vocab_parallel_head needs tensor_axis")
        device = resolve_device(device)
        self.sequence_axis, self.tensor_axis = sequence_axis, tensor_axis
        self.vocab_parallel_head = vocab_parallel_head
        self.vocab_size, self.d_model = vocab_size, d_model
        self.n_heads, self.n_layers = n_heads, n_layers
        self.d_ff = d_ff or 4 * d_model
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.attention = attention
        self.moe_experts, self.moe_axis = moe_experts, moe_axis
        self.moe_every, self.moe_top_k = moe_every, moe_top_k
        self.moe_capacity_factor, self.moe_impl = moe_capacity_factor, moe_impl
        self.remat = remat
        self.embed = nn.Embedding(vocab_size, d_model, device=device)
        self.pos_embed = nn.Embedding(max_len, d_model, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, n_heads, self.d_ff,
                             compute_dtype=compute_dtype,
                             attention=attention,
                             sequence_axis=sequence_axis,
                             tensor_axis=tensor_axis,
                             moe_experts=moe_experts if self._is_moe(i)
                             else 0,
                             moe_axis=moe_axis,
                             moe_capacity_factor=moe_capacity_factor,
                             moe_top_k=moe_top_k, moe_impl=moe_impl,
                             device=device)
            for i in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        if vocab_parallel_head:
            self.lm_head = tp.ColumnParallelDense(
                d_model, vocab_size, tensor_axis,
                compute_dtype=compute_dtype, device=device)
        else:
            self.lm_head = nn.Linear(d_model, vocab_size, device=device)
        if seed is not None:
            self.reset_parameters(seed)

    def _is_moe(self, i: int) -> bool:
        return bool(self.moe_experts) and \
            i % self.moe_every == self.moe_every - 1

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def moe_stats(self) -> list:
        """The MoE blocks' routing records of the last forward (each a
        ``{'drop_frac', 'frac_routed'}`` dict; ``[]`` for a dense model)."""
        return [blk.moe.stats for i, blk in enumerate(self.blocks)
                if self._is_moe(i)]

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Random weights from ``torch.Generator().manual_seed(seed)``
        (drawn on the CPU, so the same seed gives the same weights on
        every device): normal(0, 0.02) matrices, expert stacks and
        embeddings, zero biases (the experts' ``b1``/``b2`` too), unit
        LayerNorm scales."""
        gen = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith(("bias", "moe.b1", "moe.b2")):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)

    @torch.no_grad()
    def cast_weights_(self) -> "TransformerLM":
        """Store every matmul weight, bias and embedding table in
        ``compute_dtype``, in place (LayerNorm parameters stay float32).
        The forward casts them to ``compute_dtype`` at every call anyway,
        as flax does, so the logits do not change; serving calls this once
        so a decode step reads bf16 weights instead of converting float32
        ones."""
        dt = self.compute_dtype
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.to(dt)
        return self

    def forward(self, tokens, pos_offset=0,
                kv_caches: Optional[Sequence[dict]] = None, *,
                return_aux: bool = False, return_hidden: bool = False):
        dt = self.compute_dtype
        if getattr(self, "_megatron_axis", None) is not None:
            raise ValueError(
                "this model holds Megatron shards (parallel.gspmd."
                "megatron_shard): run it with gspmd.sharded_forward or "
                "gspmd_lm_train_step")
        if kv_caches is not None and self.sequence_axis is not None:
            raise ValueError(
                "kv_caches decoding does not support sequence-sharded "
                "models — rebuild with sequence_axis=None for inference")
        if kv_caches is not None and self.moe_experts and \
                self.moe_impl != "gshard":
            raise ValueError(
                "kv_caches decoding supports MoE only via moe_impl='gshard' "
                "— rebuild the model with moe_impl='gshard' for inference "
                "(same parameters: the expert stacks are identical)")
        if return_hidden and self.vocab_parallel_head:
            raise ValueError(
                "return_hidden composes with the replicated lm_head (the "
                "fused CE applies it itself); the vocab-parallel head "
                "already avoids full logits — use "
                "vocab_parallel_cross_entropy instead")
        if return_hidden and kv_caches is not None:
            raise ValueError("return_hidden is a training-loss path; decode "
                             "wants logits")
        tokens = tokens.to(self.device)
        t = tokens.shape[1]
        x = F.embedding(tokens, self.embed.weight).to(dt)
        if isinstance(pos_offset, torch.Tensor) and pos_offset.dim() > 0:
            pos = pos_offset.to(self.device).long()
        else:
            pos = int(pos_offset) + torch.arange(t, device=self.device)
        pe = F.embedding(pos, self.pos_embed.weight).to(dt)
        x = x + (pe if pe.dim() == 3 else pe[None])
        block_pos = pos[:, 0] if pos.dim() == 2 else pos_offset
        remat = self.remat and kv_caches is None and torch.is_grad_enabled()
        aux = torch.zeros((), device=self.device)
        for i, block in enumerate(self.blocks):
            if kv_caches is not None:
                x = block(x, block_pos, kv_cache=kv_caches[i])
                continue
            out = (checkpoint(block, x, block_pos, use_reentrant=False)
                   if remat else block(x, block_pos))
            if self._is_moe(i):
                x, a = out
                aux = aux + a
            else:
                x = out
        x = _layer_norm(self.ln_f, x, dt)
        if return_hidden:
            return (x, aux) if return_aux else x
        if self.vocab_parallel_head:
            logits = self.lm_head(x).float()
        else:
            logits = _dense(self.lm_head, x, dt).float()
        return (logits, aux) if return_aux else logits


def init_kv_caches(model: TransformerLM, batch: int, cache_len: int, *,
                   device=None) -> list[dict]:
    """Zeroed per-layer dense KV buffers for the ``kv_caches`` argument: a
    list of ``{'k','v'}`` dicts shaped ``[batch, cache_len, heads,
    d_head]`` in the model's compute dtype, written in place by the
    blocks (:func:`~chainermn_torch.parallel.sequence.
    dense_update_cache_and_attend`)."""
    device = model.device if device is None else torch.device(device)
    h, dh = model.n_heads, model.d_model // model.n_heads

    def z():
        return torch.zeros((batch, cache_len, h, dh),
                           dtype=model.compute_dtype, device=device)

    return [{"k": z(), "v": z()} for _ in range(model.n_layers)]


def init_paged_kv_caches(model: TransformerLM, n_blocks: int,
                         block_size: int, *, quant: str = "none",
                         device=None) -> list[dict]:
    """Zeroed per-layer paged KV block stores: a list of ``{'k','v'}``
    dicts shaped ``[n_blocks, block_size, heads, d_head]`` in the model's
    compute dtype, shared by every sequence through block tables.
    ``quant='int8'`` stores int8 rows plus per-row-per-head f32
    ``'k_scale'``/``'v_scale'`` ``[n_blocks, block_size, heads]``."""
    if quant not in ("none", "int8"):
        raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
    device = model.device if device is None else torch.device(device)
    h, dh = model.n_heads, model.d_model // model.n_heads
    dt = torch.int8 if quant == "int8" else model.compute_dtype

    def layer():
        d = {kk: torch.zeros((n_blocks, block_size, h, dh), dtype=dt,
                             device=device) for kk in ("k", "v")}
        if quant == "int8":
            for kk in ("k_scale", "v_scale"):
                d[kk] = torch.zeros((n_blocks, block_size, h),
                                    dtype=torch.float32, device=device)
        return d

    return [layer() for _ in range(model.n_layers)]


def filter_logits(lg, temperature: float, top_k: int = 0,
                  top_p: float = 1.0):
    """The sampler's masks on logits ``[B, V]``, in the reference's order:
    temperature scaling, then top-k (entries below the k-th largest ->
    -inf), then nucleus top-p over what remains (keeps entries whose
    cumulative probability before them is < p, so the most probable token
    always stays)."""
    lg = lg / temperature
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -torch.inf), lg)
    if top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        cutoff = torch.where(keep, srt, torch.full_like(srt, torch.inf)
                             ).amin(dim=-1, keepdim=True)
        lg = torch.where(lg < cutoff, torch.full_like(lg, -torch.inf), lg)
    return lg


def _sampler(temperature: float, top_k: int = 0, top_p: float = 1.0):
    """``sample(logits [B,V], gens) -> tokens [B]``. ``temperature=0`` is
    greedy (argmax, first index on ties). Otherwise row ``i`` draws from
    the filtered softmax with its own ``gens[i]`` ``torch.Generator``, so
    a request's draws do not depend on which others share the batch."""

    def sample(lg, gens=None):
        if not temperature:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(filter_logits(lg, temperature, top_k, top_p),
                              dim=-1)
        return torch.cat([
            torch.multinomial(probs[i:i + 1], 1, generator=gens[i])[:, 0]
            for i in range(lg.shape[0])])

    return sample


def _check_sampler(model, temperature, top_k, top_p) -> None:
    if (top_k or top_p < 1.0) and not temperature:
        raise ValueError(
            "top_k/top_p filter the sampling distribution; with "
            "temperature=0 (greedy) they have no effect — pass a "
            "temperature > 0")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if not 0 <= top_k <= model.vocab_size:
        raise ValueError(f"top_k must be in [0, vocab_size="
                         f"{model.vocab_size}], got {top_k}")


@torch.no_grad()
def generate(model: TransformerLM, prompt, n_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             seed: int = 0, eos_id: Optional[int] = None,
             use_cache: bool = True) -> torch.Tensor:
    """KV-cached autoregressive decoding (the reference's cached path):
    one prefill over ``prompt [B, T0]`` writes a paged store in which row
    ``b`` owns its own contiguous run of blocks, then one token per step
    against it. Returns ``[B, T0 + n_tokens]`` int64 on the model's device.

    ``temperature=0`` is greedy; otherwise each row samples with its own
    generator seeded ``seed + b`` (``torch`` bits, not ``jax.random``'s,
    so only greedy output is comparable with the JAX package). ``eos_id``:
    once a row samples it, later positions of that row are written as pad
    (0) while the loop keeps its shape, as in the reference.

    ``use_cache=False`` is the reference's cacheless decode
    (``_generate_fn``): every token re-runs the whole ``[B, T0 +
    n_tokens]`` buffer through the model and reads the logits one
    position back — the independent check of the cached path."""
    _check_sampler(model, temperature, top_k, top_p)
    dev = model.device
    prompt = torch.as_tensor(np.asarray(prompt), device=dev).long()
    b, t0 = prompt.shape
    total = t0 + n_tokens
    if total > model.max_len:
        raise ValueError(f"{total} tokens exceed max_len={model.max_len}")
    sample = _sampler(float(temperature), int(top_k), float(top_p))
    gens = None
    if temperature:
        gens = [torch.Generator(device=dev).manual_seed(seed + i)
                for i in range(b)]
    buf = torch.zeros((b, total), dtype=torch.long, device=dev)
    buf[:, :t0] = prompt
    if not use_cache:
        return _generate_cacheless(model, buf, t0, sample, gens, eos_id)
    n_max = -(-total // _GENERATE_BLOCK)
    store = init_paged_kv_caches(model, b * n_max + 1, _GENERATE_BLOCK)
    table = (1 + torch.arange(b * n_max, device=dev,
                              dtype=torch.int32)).view(b, n_max)
    caches = [dict(layer, table=table) for layer in store]
    nxt = sample(model(prompt, 0, kv_caches=caches)[:, -1], gens)
    buf[:, t0] = nxt
    done = (nxt == eos_id) if eos_id is not None else None
    for i in range(t0, total - 1):
        lg = model(buf[:, i:i + 1], i, kv_caches=caches)[:, 0]
        nxt = sample(lg, gens)
        if done is not None:
            nxt = torch.where(done, torch.zeros_like(nxt), nxt)
            done = done | (nxt == eos_id)
        buf[:, i + 1] = nxt
    return buf


def _generate_cacheless(model, buf, t0: int, sample, gens, eos_id):
    """The token at position ``i`` is sampled from the logits at ``i - 1``
    of a full forward over the whole buffer (causal, so the zeros past
    ``i`` do not reach them)."""
    b, total = buf.shape
    done = torch.zeros((b,), dtype=torch.bool, device=buf.device)
    for i in range(t0, total):
        nxt = sample(model(buf)[:, i - 1], gens)
        if eos_id is not None:
            nxt = torch.where(done, torch.zeros_like(nxt), nxt)
            done = done | (nxt == eos_id)
        buf[:, i] = nxt
    return buf


__all__ = ["TransformerBlock", "TransformerLM", "filter_logits", "generate",
           "init_kv_caches", "init_paged_kv_caches"]
