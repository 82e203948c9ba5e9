"""Local attention, the attention dispatch by name, and the paged
KV-cache path (the port's subset of ``chainermn_tpu/parallel/sequence.py``).

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

from chainermn_torch.ops.flash_attention import flash_attention

_NEG_BIG = -1e30
_SEQUENCE_KINDS = ("ring", "ring_flash", "zigzag", "zigzag_flash", "ulysses",
                   "ulysses_flash")


def _softmax_attend(s, v, p_scale=None):
    """Masked scores ``s [B,H,S,T]`` (f32) -> softmax -> optional per-key
    ``p_scale [B,H,1,T]`` -> PV against f32-upcast ``v [B,T,H,D]``."""
    p = torch.softmax(s, dim=-1)
    if p_scale is not None:
        p = p * p_scale
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def _position_mask(pos_offset, s_len: int, t_len: int, device):
    """Causal mask of ``S`` queries at ``pos_offset + i`` against keys at
    ``0..T-1``: ``[1,1,S,T]`` for a scalar base, ``[B,1,S,T]`` for a
    ``[B]`` vector of per-row bases."""
    k_pos = torch.arange(t_len, device=device)
    if not isinstance(pos_offset, torch.Tensor) or pos_offset.dim() == 0:
        q_pos = int(pos_offset) + torch.arange(s_len, device=device)
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
    - optional ``'max_blocks'``: a host int capping the table span read.
      The caller holds host mirrors of the positions and passes it, so
      the read side never syncs the host to tighten the span;
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
    if not isinstance(pos_offset, torch.Tensor) or pos_offset.dim() == 0:
        pos_offset = torch.full((b,), int(pos_offset), dtype=torch.int64,
                                device=dev)
    pos_offset = pos_offset.to(device=dev, dtype=torch.int64)
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


def update_cache_and_attend(kv_cache, q, k, v, pos_offset, *,
                            scale: Optional[float] = None):
    """Write ``S`` new K/V rows and attend — the one cache entry the model
    blocks call. A ``kv_cache`` carrying a ``'table'`` takes the paged
    path (:func:`paged_update_cache_and_attend`); the dense per-slot cache
    of the reference is not part of the port yet and raises."""
    if "table" not in kv_cache:
        raise ValueError(
            "kv_cache has no 'table': the port serves from the paged block "
            "store only (build it with init_paged_kv_caches)")
    return paged_update_cache_and_attend(kv_cache, q, k, v, pos_offset,
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


def sequence_parallel_attention(kind: str, axis_name: Optional[str], *,
                                causal: bool = False,
                                scale: Optional[float] = None):
    """Pick an attention implementation by name; returns ``f(q, k, v) ->
    o`` over ``[B, T, H, D]``. ``'full'`` is :func:`full_attention`;
    ``'flash'`` is the flash kernels' local attention
    (:func:`chainermn_torch.ops.flash_attention.flash_attention`), the same
    function in O(T) memory, for an unsharded sequence only. The
    sequence-parallel kinds (ring, zigzag, Ulysses and their ``_flash``
    variants) are not ported yet."""
    if kind == "flash":
        if axis_name is not None:
            raise ValueError(
                "attention='flash' is local (unsharded-sequence) attention; "
                "it cannot attend across a sharded sequence axis "
                f"({axis_name!r}) — use 'ring' or 'ulysses' there")
        return functools.partial(flash_attention, causal=causal, scale=scale)
    if kind == "full":
        return functools.partial(full_attention, causal=causal, scale=scale)
    if kind in _SEQUENCE_KINDS:
        raise NotImplementedError(
            f"attention={kind!r} is sequence-parallel attention, which the "
            "port does not have yet (ROADMAP.md, Queue A: parallel "
            "strategies)")
    raise ValueError(f"unknown attention kind {kind!r}; use 'full' or "
                     "'flash'")


__all__ = ["cached_attention", "full_attention",
           "paged_update_cache_and_attend", "sequence_parallel_attention",
           "update_cache_and_attend"]
