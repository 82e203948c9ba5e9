"""Local attention, sequence-parallel attention (ring, zigzag and
Ulysses, each plain and on the flash kernels), the attention dispatch by
name, and the paged KV-cache path (the port of
``chainermn_tpu/parallel/sequence.py``).

Layout is the JAX package's ``[batch, seq, heads, head_dim]`` at every
public function, so the tests compare like with like. Scores, softmax and
the PV product run in float32; outputs come back in ``q.dtype``. Masked
scores take the ``-1e30`` sentinel, as in the reference: a masked entry's
probability is exactly 0 in float32, so padding, stale rows and scratch
rows never contribute.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from chainermn_torch.functions.collective_communication import (
    all_to_all,
    ppermute,
)
from chainermn_torch.ops.flash_attention import (
    flash_attention,
    flash_block_grads,
    flash_fwd_with_lse,
)
from chainermn_torch.parallel.mesh import resolve_axis

_NEG_BIG = -1e30
_SEQUENCE_KINDS = ("ring", "ring_flash", "zigzag", "zigzag_flash", "ulysses",
                   "ulysses_flash")


def chunk_spans(start: int, total: int, chunk_len: int
                ) -> list[tuple[int, int]]:
    """Partition ``[start, total)`` into consecutive ``(offset, length)``
    spans of at most ``chunk_len`` tokens: every span non-empty, the spans
    tile the range, only the last may be short. Host arithmetic, shared by
    sequence sharding plans and the serving engine's chunked prefill."""
    start, total, chunk_len = int(start), int(total), int(chunk_len)
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    spans = []
    frontier = start
    while frontier < total:
        clen = min(chunk_len, total - frontier)
        spans.append((frontier, clen))
        frontier += clen
    return spans


def _softmax_attend(s, v, p_scale=None):
    """Masked scores ``s [B,H,S,T]`` (f32) -> softmax -> optional per-key
    ``p_scale [B,H,1,T]`` -> PV against f32-upcast ``v [B,T,H,D]``."""
    p = torch.softmax(s, dim=-1)
    if p_scale is not None:
        p = p * p_scale
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def _position_mask(pos_offset, s_len: int, t_len: int, device):
    """Causal mask of ``S`` queries at ``pos_offset + i`` against keys at
    ``0..T-1``: ``[1,1,S,T]`` for a host int or a 0-dim tensor base (read
    on the device, never on the host), ``[B,1,S,T]`` for a ``[B]`` vector
    of per-row bases."""
    k_pos = torch.arange(t_len, device=device)
    if not isinstance(pos_offset, torch.Tensor) or pos_offset.dim() == 0:
        q_pos = pos_offset + torch.arange(s_len, device=device)
        return (k_pos[None, :] <= q_pos[:, None])[None, None]
    q_pos = pos_offset.to(device)[:, None] + torch.arange(
        s_len, device=device)[None]
    return (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]


def cached_attention(q, kbuf, vbuf, pos_offset, *,
                     scale: Optional[float] = None):
    """Decode-time attention: ``S`` new queries ``q [B,S,H,D]`` at global
    positions ``pos_offset .. pos_offset+S-1`` against a KV buffer
    ``kbuf/vbuf [B,Tc,H,D]`` whose first ``pos_offset+S`` rows are valid;
    later rows are masked by position. ``pos_offset`` is an int or a
    ``[B]`` tensor of per-row bases (continuous batching)."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kbuf.float()) * scale
    mask = _position_mask(pos_offset, q.shape[1], kbuf.shape[1], q.device)
    s = torch.where(mask, s, torch.full_like(s, _NEG_BIG))
    return _softmax_attend(s, vbuf).to(q.dtype)


def _dequant_cached_attention(q, k8, k_sc, v8, v_sc, pos_offset, *,
                              scale: Optional[float] = None):
    """:func:`cached_attention` over an int8 K/V view with the dequant
    scales folded into the contractions: the f32 scores are multiplied by
    ``k_sc`` per key after the QK product, the probabilities by ``v_sc``
    per key before the PV product. ``k8``/``v8`` are ``[B,T,H,D]`` int8,
    ``k_sc``/``v_sc`` their ``[B,T,H]`` f32 scales."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k8.float()) * scale
    s = s * k_sc.permute(0, 2, 1)[:, :, None, :]
    mask = _position_mask(pos_offset, q.shape[1], k8.shape[1], q.device)
    s = torch.where(mask, s, torch.full_like(s, _NEG_BIG))
    return _softmax_attend(s, v8,
                           v_sc.permute(0, 2, 1)[:, :, None, :]).to(q.dtype)


def _quantize_rows(r32):
    """Symmetric per-row-per-head int8: ``x ≈ q8 * scale`` with the scale
    floored at 1e-8 (all-zero rows from warmup or padding never divide by
    zero). ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    sc = torch.clamp_min(r32.abs().amax(dim=-1) / 127.0, 1e-8)
    q8 = torch.clamp(torch.round(r32 / sc[..., None]), -127, 127)
    return q8.to(torch.int8), sc


def paged_update_cache_and_attend(kv_cache, q, k, v, pos_offset, *,
                                  scale: Optional[float] = None):
    """Write ``S`` new K/V rows into the shared paged block store through
    each row's block table, then attend ``q`` against the row's table
    span. Returns the attention output ``[B,S,H,D]`` in ``q.dtype``.

    Unlike the JAX reference, which returns a new store, the port updates
    ``kv_cache``'s store tensors **in place** (``index_put_``): the store
    is the largest tensor of a serving process and is never copied.

    ``kv_cache`` is a dict with:

    - ``'k'``/``'v'``: the store ``[n_blocks, block_size, H, D]``;
    - ``'table'``: ``[B, max_blocks]`` int32 — row ``b``'s ``j``-th entry
      is the block holding positions ``[j*bs, (j+1)*bs)``; unused entries
      point at the scratch block 0;
    - optional ``'k_scale'``/``'v_scale'``: ``[n_blocks, block_size, H]``
      f32, present iff the store is int8;
    - optional ``'valid'``: ``[B]`` — rows ``j >= valid[b]`` write into
      the scratch block instead of the table;
    - optional ``'max_blocks'``: a host int capping the table span read
      (``None`` or absent: the whole table, which is what the serving
      engine's fixed programs read);
    - optional ``'use_kernel'``: route the read side through the
      hand-written paged-decode kernel
      (:func:`chainermn_torch.parallel.paged_kernel.paged_attend`);
      otherwise it runs the kernel's plain version
      (``paged_attend_reference``: gather the table span, then
      :func:`cached_attention`). The write side is plain torch on every
      path.

    Writes at positions past the table's span land in the scratch block.
    """
    store_k, store_v = kv_cache["k"], kv_cache["v"]
    table = kv_cache["table"]
    quant = "k_scale" in kv_cache
    n_j = table.shape[1]
    bs = store_k.shape[1]
    b, s = q.shape[0], q.shape[1]
    dev = q.device
    if not isinstance(pos_offset, torch.Tensor):
        pos_offset = torch.full((b,), int(pos_offset), dtype=torch.int64,
                                device=dev)
    pos_offset = pos_offset.to(device=dev, dtype=torch.int64).expand(b)
    pos = pos_offset[:, None] + torch.arange(s, device=dev)[None, :]
    in_span = pos < n_j * bs
    blk = torch.gather(table.long(), 1, torch.clamp(pos // bs, max=n_j - 1))
    off = pos % bs
    keep = in_span
    valid = kv_cache.get("valid")
    if valid is not None:
        keep = keep & (torch.arange(s, device=dev)[None, :]
                       < valid.to(dev)[:, None])
    blk = torch.where(keep, blk, torch.zeros_like(blk)).reshape(-1)
    off = torch.where(keep, off, torch.zeros_like(off)).reshape(-1)

    def write(store, scales, rows):
        rows = rows.reshape((b * s,) + tuple(rows.shape[2:]))   # [B*S,H,D]
        if not quant:
            store.index_put_((blk, off), rows.to(store.dtype))
            return
        q8, sc = _quantize_rows(rows.float())
        store.index_put_((blk, off), q8)
        scales.index_put_((blk, off), sc)

    write(store_k, kv_cache.get("k_scale"), k)
    write(store_v, kv_cache.get("v_scale"), v)

    m_used = kv_cache.get("max_blocks")
    m_used = n_j if m_used is None else max(1, min(n_j, int(m_used)))
    from chainermn_torch.parallel import paged_kernel

    attend = (paged_kernel.paged_attend if kv_cache.get("use_kernel")
              else paged_kernel.paged_attend_reference)
    # q is a strided slice of the fused qkv projection; the kernel takes
    # a contiguous [B, S, H, D]
    return attend(q.contiguous(), store_k, store_v, table, pos_offset + s,
                  k_scale=kv_cache.get("k_scale"),
                  v_scale=kv_cache.get("v_scale"), scale=scale,
                  max_blocks=m_used)


def dense_update_cache_and_attend(kv_cache, q, k, v, pos_offset, *,
                                  scale: Optional[float] = None):
    """The dense per-slot cache path: write ``S`` new K/V rows into
    ``kv_cache['k'/'v'] [B, Tc, H, D]`` at ``pos_offset`` (an int, or a
    ``[B]`` tensor writing each row at its own position), in place, then
    attend ``q`` against the buffers with the position mask. A write that
    would run past ``Tc`` starts at ``Tc - S`` instead, as
    ``lax.dynamic_update_slice`` clamps it in the reference. A 0-dim tensor
    base is read on the device like a ``[B]`` one (no host sync). The
    attention reads the whole buffer; the position mask hides the rows
    past each query."""
    kbuf, vbuf = kv_cache["k"], kv_cache["v"]
    b, s = q.shape[0], q.shape[1]
    tc = kbuf.shape[1]
    if not isinstance(pos_offset, torch.Tensor):
        start = min(max(int(pos_offset), 0), tc - s)
        kbuf[:, start:start + s] = k.to(kbuf.dtype)
        vbuf[:, start:start + s] = v.to(vbuf.dtype)
    else:
        dev = q.device
        start = pos_offset.to(device=dev, dtype=torch.int64).clamp(
            0, tc - s).expand(b)
        rows = start[:, None] + torch.arange(s, device=dev)[None, :]
        bidx = torch.arange(b, device=dev)[:, None].expand(b, s)
        kbuf.index_put_((bidx, rows), k.to(kbuf.dtype))
        vbuf.index_put_((bidx, rows), v.to(vbuf.dtype))
    return cached_attention(q, kbuf, vbuf, pos_offset, scale=scale)


def update_cache_and_attend(kv_cache, q, k, v, pos_offset, *,
                            scale: Optional[float] = None):
    """Write ``S`` new K/V rows and attend — the one cache entry the model
    blocks call. A ``kv_cache`` carrying a ``'table'`` takes the paged
    path (:func:`paged_update_cache_and_attend`); one without is a dense
    per-slot buffer (:func:`dense_update_cache_and_attend`). Both write in
    place and return the attention output."""
    if "table" in kv_cache:
        return paged_update_cache_and_attend(kv_cache, q, k, v, pos_offset,
                                             scale=scale)
    return dense_update_cache_and_attend(kv_cache, q, k, v, pos_offset,
                                         scale=scale)


def full_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None):
    """Single-device exact attention over ``[B,T,H,D]`` — the cacheless
    forward's attention. f32 scores and PV, output in ``q.dtype``."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t, tk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_BIG))
    return _softmax_attend(s, v).to(q.dtype)


# --------------------------------------------------------------------------- #
# Sequence parallelism: ring, zigzag and Ulysses                              #
# --------------------------------------------------------------------------- #
# Each rank holds the [B, T_local, H, D] shard of q, k and v of its place on
# the sequence axis; the axis is a communicator (its rank is the shard's
# index, a Python int). K/V blocks travel the ring in one tensor, so every
# rank posts the same transfers in the same order, backward included.

def _axis(axis, who: str):
    comm = resolve_axis(axis)
    if comm is None:
        raise ValueError(f"{who} needs a sequence axis that a live mesh "
                         f"binds (or its communicator), got {axis!r}")
    return comm


def _ring(n: int) -> list:
    return [(i, (i + 1) % n) for i in range(n)]


def _attend_lse(q, k, v, *, scale, mask=None):
    """One block of exact attention: the normalised float32 output
    ``[B, Tq, H, D]`` and its float32 log-sum-exp ``[B, H, Tq]``. Every
    row must see a key (callers skip fully masked blocks)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_BIG)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()), lse


def _zz_merge(o, lse, ob, lse_b):
    """The lse-weighted merge of a block's partial ``(ob, lse_b)`` into
    the running ``(o [B,T,H,D], lse [B,H,T])``, both float32 — the one
    merge of every ring kind. A block a row does not see (``lse_b`` at
    the ``-1e30`` sentinel) gets weight 0."""
    lse_new = torch.logaddexp(lse, lse_b)
    w1 = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w2 = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
    return o * w1 + ob * w2, lse_new


class _Anchor(torch.autograd.Function):
    """``x`` unchanged, with ``block`` kept in the autograd graph at a zero
    gradient: a skipped block's ring transfer must still run its backward
    on this rank, since its peers run theirs."""

    @staticmethod
    def forward(ctx, x, block):
        ctx.block = (block.shape, block.dtype)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.block
        return g, g.new_zeros(shape, dtype=dtype)


def _merge_into(acc, part):
    return part if acc is None else _zz_merge(*acc, *part)


def ring_attention(q, k, v, axis_name, *, causal: bool = False,
                   scale: Optional[float] = None):
    """Exact attention over a sequence sharded along ``axis_name``
    (``chainermn_tpu/parallel/sequence.py:112``): shard ``i`` holds
    global positions ``[i*T, (i+1)*T)``; the K/V blocks rotate around
    the ring (``n - 1`` differentiable ``ppermute``s) while q stays, and
    the partial results merge by their log-sum-exp. Under ``causal`` the
    blocks of later ranks are fully masked and skipped. Differentiable
    through autograd; output in ``q.dtype``."""
    comm = _axis(axis_name, "ring_attention")
    n, my = comm.size, comm.rank
    t = q.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    q_pos = my * t + torch.arange(t, device=q.device)
    kv = torch.stack([k, v])
    acc = None
    for step in range(n):
        src = (my - step) % n
        if step:
            kv = ppermute(kv, comm, _ring(n))
        if causal and src > my:
            acc = (_Anchor.apply(acc[0], kv), acc[1])
            continue
        mask = None
        if causal:
            k_pos = src * t + torch.arange(t, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        acc = _merge_into(acc, _attend_lse(q, kv[0], kv[1], scale=scale,
                                           mask=mask))
    return acc[0].to(q.dtype)


def zigzag_permutation(t_global: int, n_shards: int) -> torch.Tensor:
    """Index ``perm`` of length ``t_global`` such that ``x[:, perm]``
    split contiguously over ``n_shards`` gives shard ``i`` the chunks
    ``(i, 2n-1-i)`` of ``2n`` (``sequence.py:555``). Apply it to tokens
    and targets alike; ``torch.argsort(perm)`` undoes it."""
    if t_global % (2 * n_shards):
        raise ValueError(f"sequence length {t_global} must divide into "
                         f"2*{n_shards} chunks")
    c = t_global // (2 * n_shards)
    idx = []
    for i in range(n_shards):
        j = 2 * n_shards - 1 - i
        idx += [torch.arange(i * c, (i + 1) * c),
                torch.arange(j * c, (j + 1) * c)]
    return torch.cat(idx)


def zigzag_positions(rank: int, n_shards: int, t_local: int,
                     device=None) -> torch.Tensor:
    """Global positions ``[t_local]`` of shard ``rank``'s tokens under the
    zigzag layout (``sequence.py:583``), for the position embedding."""
    c = t_local // 2
    early = rank * c + torch.arange(c, device=device)
    late = (2 * n_shards - 1 - rank) * c + torch.arange(c, device=device)
    return torch.cat([early, late])


def zigzag_ring_attention(q, k, v, axis_name, *, causal: bool = True,
                          scale: Optional[float] = None):
    """Causal ring attention over a zigzag-sharded sequence
    (``sequence.py:594``; lay data out with :func:`zigzag_permutation`):
    the local block with its masked diagonal, then per step either both
    halves of q against the early half of an earlier rank's block, or the
    late half of q against the whole block of a later rank — equal work
    on every rank. ``causal=False`` is :func:`ring_attention`."""
    if not causal:
        return ring_attention(q, k, v, axis_name, causal=False, scale=scale)
    comm = _axis(axis_name, "zigzag_ring_attention")
    n, my = comm.size, comm.rank
    t = q.shape[1]
    if t % 2:
        raise ValueError(f"local sequence length {t} must be even "
                         "(chunk pair)")
    c = t // 2
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    pos = zigzag_positions(my, n, t, device=q.device)
    o, lse = _attend_lse(q, k, v, scale=scale,
                         mask=(pos[:, None] >= pos[None, :])[None, None])
    early, late = (o[:, :c], lse[..., :c]), (o[:, c:], lse[..., c:])
    kv = torch.stack([k, v])
    for step in range(1, n):
        kv = ppermute(kv, comm, _ring(n))
        ke, ve = kv[0][:, :c], kv[1][:, :c]
        if my >= step:      # the block came from an earlier rank
            early = _zz_merge(*early, *_attend_lse(q[:, :c], ke, ve,
                                                   scale=scale))
            late = _zz_merge(*late, *_attend_lse(q[:, c:], ke, ve,
                                                 scale=scale))
        else:               # a later rank's: only the late half sees it
            late = _zz_merge(*late, *_attend_lse(q[:, c:], kv[0], kv[1],
                                                 scale=scale))
    return torch.cat([early[0], late[0]], dim=1).to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """:func:`ring_flash_attention`: one forward-kernel call per incoming
    block, every block (a later rank's block under ``causal`` is fully
    masked, and the kernel gives it out 0 and lse -1e30); the backward is
    a second rotation with the dq and dk/dv kernels on the final lse and
    delta, the dk/dv accumulators travelling with their block."""

    @staticmethod
    def forward(ctx, q, k, v, comm, causal, scale):
        n, my = comm.size, comm.rank
        t = q.shape[1]
        kw = dict(causal=causal, scale=scale, q_offset=my * t)
        kb, vb, acc = k, v, None
        for step in range(n):
            if step:
                kb, vb = comm.ppermute(torch.stack([kb, vb]), _ring(n))
            acc = _merge_into(acc, flash_fwd_with_lse(
                q, kb, vb, k_offset=((my - step) % n) * t,
                out_dtype=torch.float32, **kw))
        out = acc[0].to(q.dtype)
        ctx.save_for_backward(q, k, v, out, acc[1])
        ctx.comm, ctx.kw = comm, kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        comm = ctx.comm
        n, my = comm.size, comm.rank
        t = q.shape[1]
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        kb, vb, dq, dkv = k, v, None, None
        for step in range(n):
            if step:
                kb, vb = comm.ppermute(torch.stack([kb, vb]), _ring(n))
                dkv = comm.ppermute(dkv, _ring(n))
            dqb, dkb, dvb = flash_block_grads(
                q, kb, vb, do, lse, delta, k_offset=((my - step) % n) * t,
                **ctx.kw)
            dq = dqb if dq is None else dq + dqb
            part = torch.stack([dkb, dvb])
            dkv = part if dkv is None else dkv + part
        if n > 1:           # the last block's accumulator goes home
            dkv = comm.ppermute(dkv, _ring(n))
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_flash_attention(q, k, v, axis_name, *, causal: bool = False,
                         scale: Optional[float] = None):
    """:func:`ring_attention` on the flash kernels
    (``sequence.py:241-340``): O(T) memory within each block as across
    the ring; differentiable through its own backward rotation."""
    comm = _axis(axis_name, "ring_flash_attention")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _RingFlash.apply(q, k, v, comm, bool(causal), scale)


class _ZigzagFlash(torch.autograd.Function):
    """:func:`zigzag_flash_attention`: the diagonal step as three kernel
    calls (early and late chunks causal at their offsets, the late chunk
    against the early one in full), then two fully visible ``c x c``
    calls a ring step; the backward repeats the pattern with the dq and
    dk/dv kernels on the final lse and delta."""

    @staticmethod
    def forward(ctx, q, k, v, comm, scale):
        n, my = comm.size, comm.rank
        t = q.shape[1]
        if t % 2:
            raise ValueError(f"local sequence length {t} must be even")
        c = t // 2
        off_e, off_l = my * c, (2 * n - 1 - my) * c
        q_e, q_l = q[:, :c], q[:, c:]

        def block(qc, kc, vc, causal=False, off=0):
            return flash_fwd_with_lse(qc, kc, vc, causal=causal, scale=scale,
                                      q_offset=off, k_offset=off,
                                      out_dtype=torch.float32)

        early = block(q_e, k[:, :c], v[:, :c], True, off_e)
        late = _zz_merge(*block(q_l, k[:, c:], v[:, c:], True, off_l),
                         *block(q_l, k[:, :c], v[:, :c]))
        kb, vb = k, v
        for step in range(1, n):
            kb, vb = comm.ppermute(torch.stack([kb, vb]), _ring(n))
            ke, ve, kl, vl = kb[:, :c], vb[:, :c], kb[:, c:], vb[:, c:]
            if my >= step:
                early = _zz_merge(*early, *block(q_e, ke, ve))
                late = _zz_merge(*late, *block(q_l, ke, ve))
            else:
                late = _zz_merge(*late, *block(q_l, ke, ve))
                late = _zz_merge(*late, *block(q_l, kl, vl))
        out = torch.cat([early[0], late[0]], dim=1).to(q.dtype)
        lse = torch.cat([early[1], late[1]], dim=2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.comm, ctx.scale = comm, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        comm, scale = ctx.comm, ctx.scale
        n, my = comm.size, comm.rank
        c = q.shape[1] // 2
        off_e, off_l = my * c, (2 * n - 1 - my) * c
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        # (q, do, lse, delta) of the early and the late half
        e = (q[:, :c], do[:, :c], lse[..., :c].contiguous(),
             delta[..., :c].contiguous())
        l = (q[:, c:], do[:, c:], lse[..., c:].contiguous(),
             delta[..., c:].contiguous())

        def grads(half, kc, vc, causal=False, off=0):
            qs, dos, lses, ds = half
            return flash_block_grads(qs, kc, vc, dos, lses, ds,
                                     causal=causal, scale=scale,
                                     q_offset=off, k_offset=off)

        dq_e, dke, dve = grads(e, k[:, :c], v[:, :c], True, off_e)
        dq_l, dkl, dvl = grads(l, k[:, c:], v[:, c:], True, off_l)
        dq2, dke2, dve2 = grads(l, k[:, :c], v[:, :c])
        dq_l = dq_l + dq2
        dkv = torch.stack([torch.cat([dke + dke2, dkl], dim=1),
                           torch.cat([dve + dve2, dvl], dim=1)])
        kb, vb = k, v
        for step in range(1, n):
            kb, vb = comm.ppermute(torch.stack([kb, vb]), _ring(n))
            dkv = comm.ppermute(dkv, _ring(n))
            ke, ve, kl, vl = kb[:, :c], vb[:, :c], kb[:, c:], vb[:, c:]
            if my >= step:
                dq1, dk1, dv1 = grads(e, ke, ve)
                dq2, dk2, dv2 = grads(l, ke, ve)
                dq_e = dq_e + dq1
                dq_l = dq_l + dq2
                dkv[0, :, :c] += dk1 + dk2
                dkv[1, :, :c] += dv1 + dv2
            else:
                dq1, dk1, dv1 = grads(l, ke, ve)
                dq2, dk2, dv2 = grads(l, kl, vl)
                dq_l = dq_l + dq1 + dq2
                dkv[0, :, :c] += dk1
                dkv[1, :, :c] += dv1
                dkv[0, :, c:] += dk2
                dkv[1, :, c:] += dv2
        if n > 1:
            dkv = comm.ppermute(dkv, _ring(n))
        dq = torch.cat([dq_e, dq_l], dim=1)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def zigzag_flash_attention(q, k, v, axis_name, *, causal: bool = True,
                           scale: Optional[float] = None):
    """:func:`zigzag_ring_attention` on the flash kernels
    (``sequence.py:356-552``); ``causal=False`` is
    :func:`ring_flash_attention`."""
    if not causal:
        return ring_flash_attention(q, k, v, axis_name, causal=False,
                                    scale=scale)
    comm = _axis(axis_name, "zigzag_flash_attention")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _ZigzagFlash.apply(q, k, v, comm, scale)


def ulysses_attention(q, k, v, axis_name, *, causal: bool = False,
                      scale: Optional[float] = None, block_impl: str = "xla"):
    """Exact attention by head re-sharding (``sequence.py:705``): a tiled
    all-to-all gives each rank the whole sequence for ``H/n`` heads, it
    attends locally (``block_impl='flash'``: the flash kernels; ``'xla'``:
    :func:`full_attention`), and a second all-to-all brings the sequence
    shards back. The backward is the swapped exchanges."""
    comm = _axis(axis_name, "ulysses_attention")
    if block_impl not in ("xla", "flash"):
        raise ValueError(
            f"block_impl must be 'xla' or 'flash', got {block_impl!r}")
    n = comm.size
    h = q.shape[2]
    if h % n:
        raise ValueError(f"heads ({h}) must be divisible by axis size ({n})")
    attend = flash_attention if block_impl == "flash" else full_attention
    heads = [all_to_all(x, comm, 2, 1) for x in (q, k, v)]
    return all_to_all(attend(*heads, causal=causal, scale=scale), comm, 1, 2)


def ulysses_flash_attention(q, k, v, axis_name, *, causal: bool = False,
                            scale: Optional[float] = None):
    """:func:`ulysses_attention` with the flash kernels as the local
    attention (``sequence.py:787``)."""
    return ulysses_attention(q, k, v, axis_name, causal=causal, scale=scale,
                             block_impl="flash")


def sequence_parallel_attention(kind: str, axis_name=None, *,
                                causal: bool = False,
                                scale: Optional[float] = None):
    """Pick an attention implementation by name; returns ``f(q, k, v) ->
    o`` over ``[B, T, H, D]``. ``'full'`` is :func:`full_attention`;
    ``'flash'`` the flash kernels' local attention, for an unsharded
    sequence only; ``'ring'``, ``'ring_flash'``, ``'zigzag'``,
    ``'zigzag_flash'``, ``'ulysses'`` and ``'ulysses_flash'`` attend
    across the sequence sharded over ``axis_name`` (a communicator, or
    an axis name a live :class:`~chainermn_torch.communicators.
    MeshCommunicator` binds). As in the reference, with no axis, or an
    axis name that no mesh binds when ``f`` is called, the whole sequence
    is local (zigzag data must then be un-permuted first): the ``_flash``
    kinds are then :func:`flash_attention`, which launches the kernels on
    CUDA tensors, and the others :func:`full_attention`."""
    if kind == "flash":
        if axis_name is not None:
            raise ValueError(
                "attention='flash' is local (unsharded-sequence) attention; "
                "it cannot attend across a sharded sequence axis "
                f"({axis_name!r}) — use 'ring' or 'ulysses' there")
        return functools.partial(flash_attention, causal=causal, scale=scale)
    if kind not in ("full",) + _SEQUENCE_KINDS:
        raise ValueError(f"unknown attention kind {kind!r}; use "
                         "ring|ring_flash|zigzag|zigzag_flash|ulysses|"
                         "ulysses_flash|full|flash")
    local = functools.partial(
        flash_attention if kind.endswith("_flash") else full_attention,
        causal=causal, scale=scale)
    if kind == "full" or axis_name is None:
        return local
    impl = {"ring": ring_attention, "ring_flash": ring_flash_attention,
            "zigzag": zigzag_ring_attention,
            "zigzag_flash": zigzag_flash_attention,
            "ulysses": ulysses_attention,
            "ulysses_flash": ulysses_flash_attention}[kind]

    def f(q, k, v):
        comm = resolve_axis(axis_name)
        if comm is None:
            return local(q, k, v)
        return impl(q, k, v, comm, causal=causal, scale=scale)

    return f


__all__ = ["cached_attention", "chunk_spans",
           "dense_update_cache_and_attend", "full_attention",
           "paged_update_cache_and_attend", "ring_attention",
           "ring_flash_attention", "sequence_parallel_attention",
           "ulysses_attention", "ulysses_flash_attention",
           "update_cache_and_attend", "zigzag_flash_attention",
           "zigzag_permutation", "zigzag_positions", "zigzag_ring_attention"]
