"""Paged-attention decode over the shared block store: the hand-written
Hopper kernel (``csrc/paged_decode.cu``), its plain PyTorch version, and
the bytes-read cost model.

Port of ``chainermn_tpu/parallel/paged_kernel.py``. :func:`paged_attend`
keeps the reference's signature and ``[B, S, H, D]`` layout. It launches
the CUDA kernel for CUDA tensors; for CPU tensors it runs
:func:`paged_attend_reference`. There is no fallback on the card and no
switch to turn the kernel off. On the card it takes every head dim (up
to 256 in one tile whose lanes past ``D`` are masked, past 256 in
256-column slices of the output, one CTA each; the store is never
copied), float32, bfloat16 and float16 queries over float32, bfloat16,
float16 or int8 stores (the pairs the kernel is not built for,
``_PAIRS``, run with q widened to float32: exact), any ``B`` and ``H``,
and any number of queries
per row: the kernel holds at most 8 in registers, so
:func:`chunk_queries` runs longer windows as chunks of 8, each with its
rows' lengths cut to the chunk's last query.

The kernel library is compiled with ``nvcc`` at first use from the source
in this checkout into ``build/`` at the repository root and loaded with
``ctypes``; nothing about CUDA is touched while this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from chainermn_torch._build import load_library
from chainermn_torch.parallel.sequence import (
    _dequant_cached_attention,
    cached_attention,
)

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "paged_decode.cu"
_MAX_QUERIES = 8          # kMaxQueries in the CUDA source
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float16: 3}
# the store dtypes each query dtype's kernels read (paged_decode.cu's
# launch_kv); float32 queries read every store dtype
_PAIRS = {torch.float32: tuple(_KV_CODES),
          torch.bfloat16: (torch.float32, torch.bfloat16, torch.int8),
          torch.float16: (torch.float16, torch.int8)}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"paged_decode_launch": (
    [_P] * 9 + [_I] * 9 + [ctypes.c_float, _I, _I, _P], _I)}
# the split-K choice (split_plan)
_SPLIT_CTAS = 1024        # CTAs that fill the card: ~8 per SM on 132 SMs
_SPLIT_MIN_KEYS = 128     # fewest keys worth a CTA of their own
_SPLIT_MAX_BLOCKS = 4096  # kMaxSplitBlocks: table entries a CTA stages


def build_library() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library
    through :func:`chainermn_torch._build.load_library`. Raises
    ``RuntimeError`` with the compiler's output when ``nvcc`` fails.
    ``build_library.log`` holds this process's build output (``-Xptxas
    -v`` register and shared-memory report)."""
    lib, log = load_library(_SRC, _SIGNATURES)
    build_library.log = log
    return lib


build_library.log = ""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attend: {msg}")


def chunk_queries(attend, q, store_k, store_v, table, lengths, **kw):
    """``attend(q, store_k, store_v, table, lengths, **kw)`` over a query
    window of any length S, as launches of at most ``_MAX_QUERIES``
    queries. Query ``s`` of a row sits at position ``lengths[b] - S + s``,
    so the chunk of queries ``[c0, c1)`` is exactly the last ``c1 - c0``
    queries of the same row with its length cut to ``lengths[b] - S +
    c1``. ``attend`` is :func:`paged_attend` or its plain version."""
    s_len = q.shape[1]
    if s_len <= _MAX_QUERIES:
        return attend(q, store_k, store_v, table, lengths, **kw)
    outs = []
    for c0 in range(0, s_len, _MAX_QUERIES):
        c1 = min(s_len, c0 + _MAX_QUERIES)
        outs.append(attend(q[:, c0:c1].contiguous(), store_k, store_v,
                           table, lengths - (s_len - c1), **kw))
    return torch.cat(outs, 1)


def split_plan(batch: int, heads: int, n_j: int, bs: int) -> tuple:
    """How the kernel splits each row's table span ``[0, n_j * bs)``
    across CTAs: ``(n_split, split_keys)``, split ``i`` taking keys
    ``[i * split_keys, (i + 1) * split_keys)`` (clipped by the kernel to
    the row's length). ``split_keys`` is a whole number of ``bs``-key
    blocks, every split starts inside the span, and together they cover
    it. Host values only: ``lengths`` lives on the card, and reading it
    would wait for the device. Enough splits that ``batch * heads *
    n_split`` fills the card, but at most one per ``_SPLIT_MIN_KEYS``
    keys of the span."""
    want = min(-(-_SPLIT_CTAS // (batch * heads)),
               -(-n_j * bs // _SPLIT_MIN_KEYS))
    want = max(want, -(-n_j // _SPLIT_MAX_BLOCKS), 1)
    blocks = -(-n_j // want)
    return -(-n_j // blocks), blocks * bs


def _check_args(q, store_k, store_v, table, lengths, *, k_scale=None,
                v_scale=None) -> None:
    """Raise ``ValueError`` unless the kernel takes these inputs: q in
    f32/bf16/f16 ``[B, S, H, D]``, a ``[n_blocks, bs, H, D]`` store of a
    dtype ``_PAIRS`` gives q's (int8 with f32 ``[n_blocks, bs, H]``
    scales), a ``[B, max_blocks]`` table and ``[B]`` lengths, all on q's
    device, q, store and scales contiguous, the store 16-byte aligned.
    :func:`paged_attend` calls it before every launch; it reads shapes,
    dtypes and pointers only, so it runs on tensors anywhere."""
    b, s_len, h, d = q.shape
    n_blocks, bs = store_k.shape[0], store_k.shape[1]
    quant = store_k.dtype == torch.int8
    dev = q.device
    _check(q.dtype in _Q_CODES, f"q dtype {q.dtype} (want f32, bf16 or "
           f"f16)")
    _check(store_k.dtype in _PAIRS[q.dtype]
           and store_v.dtype == store_k.dtype,
           f"store dtypes {store_k.dtype}/{store_v.dtype} for q "
           f"{q.dtype} (want one of {_PAIRS[q.dtype]})")
    _check(d >= 1 and -(-d // 256) <= 65535, f"head dim {d}")
    _check(s_len >= 1, "no queries")
    _check(tuple(store_k.shape) == (n_blocks, bs, h, d)
           and store_v.shape == store_k.shape,
           f"store shapes {tuple(store_k.shape)}/{tuple(store_v.shape)} "
           f"vs q {tuple(q.shape)}")
    _check(table.dim() == 2 and table.shape[0] == b
           and tuple(lengths.shape) == (b,),
           f"table {tuple(table.shape)} / lengths {tuple(lengths.shape)} "
           f"for batch {b}")
    _check(quant == (k_scale is not None) == (v_scale is not None),
           "k_scale/v_scale must be given iff the store is int8")
    tensors = [q, store_k, store_v, table, lengths]
    if quant:
        _check(k_scale.dtype == torch.float32 == v_scale.dtype
               and tuple(k_scale.shape) == (n_blocks, bs, h)
               and v_scale.shape == k_scale.shape,
               "scales must be f32 [n_blocks, bs, H]")
        tensors += [k_scale, v_scale]
    _check(all(t.device == dev for t in tensors),
           "all tensors must be on q's device")
    _check(all(t.is_contiguous() for t in tensors if t is not table
               and t is not lengths), "q, store and scales must be contiguous")
    _check(store_k.data_ptr() % 16 == 0 == store_v.data_ptr() % 16,
           "the store must be 16-byte aligned")


def paged_attend(q, store_k, store_v, table, lengths, *,
                 k_scale=None, v_scale=None, scale: Optional[float] = None,
                 max_blocks: Optional[int] = None):
    """Paged-attention decode over the shared block store.

    - ``q``: ``[B, S, H, D]`` queries for positions ``lengths[b]-S ..
      lengths[b]-1`` of each row;
    - ``store_k``/``store_v``: ``[n_blocks, bs, H, D]``, already holding
      this step's writes;
    - ``table``: ``[B, max_blocks]`` integer block table;
    - ``lengths``: ``[B]`` valid KV rows per row after the write;
    - ``k_scale``/``v_scale``: ``[n_blocks, bs, H]`` f32, present iff the
      store is int8;
    - ``max_blocks``: optional cap on the table entries read.

    Returns ``[B, S, H, D]`` in ``q.dtype``. On CUDA tensors this launches
    the hand-written kernel (adding one to ``paged_attend.launches`` for
    each launch; more than 8 queries a row take one launch per chunk of
    8, :func:`chunk_queries`; a CUDA graph that captured launches adds
    them on every replay, :mod:`chainermn_torch.serving._programs`) and
    raises ``ValueError`` for inputs it does
    not take: q and store in other dtypes than f32/bf16/f16 (and int8
    stores), non-contiguous tensors, tensors on several devices, a store
    not 16-byte aligned. A (q, store) dtype pair the kernel is not built
    for (``_PAIRS``) runs with q widened to float32 and the output
    rounded back to q's dtype: the kernel widens q to float32 and rounds
    the output once anyway, so the result is the same. Long rows are
    split
    across CTAs as :func:`split_plan` says; with more than one split the
    kernel's partials go to a float32 workspace allocated here, and a
    second kernel combines them (both count as one launch). On CPU
    tensors it runs :func:`paged_attend_reference`."""
    if not q.is_cuda:
        return paged_attend_reference(q, store_k, store_v, table, lengths,
                                      k_scale=k_scale, v_scale=v_scale,
                                      scale=scale, max_blocks=max_blocks)
    kw = dict(k_scale=k_scale, v_scale=v_scale, scale=scale,
              max_blocks=max_blocks)
    if q.dtype in _Q_CODES and store_k.dtype not in _PAIRS[q.dtype] \
            and store_k.dtype in _KV_CODES:
        return paged_attend(q.float(), store_k, store_v, table, lengths,
                            **kw).to(q.dtype)
    if q.shape[1] > _MAX_QUERIES:
        return chunk_queries(paged_attend, q, store_k, store_v, table,
                             lengths, **kw)
    _check_args(q, store_k, store_v, table, lengths, k_scale=k_scale,
                v_scale=v_scale)
    b, s_len, h, d = q.shape
    bs = store_k.shape[1]
    quant = store_k.dtype == torch.int8
    dev = q.device
    # an int32 contiguous table (the serving engine's static one) is
    # used as it is: a CUDA graph keeps reading the same buffer
    table32 = table.to(torch.int32).contiguous()
    lengths32 = lengths.to(torch.int32).contiguous()
    n_j = table.shape[1]
    if max_blocks is not None:
        n_j = max(1, min(n_j, int(max_blocks)))
    if scale is None:
        scale = d ** -0.5
    n_split, split_keys = split_plan(b, h, n_j, bs)
    out = torch.empty_like(q)
    # per split: m and l of each query, then its unnormalised output
    partial = (torch.empty((b * h * n_split, s_len * (d + 2)),
                           dtype=torch.float32, device=dev)
               if n_split > 1 else None)
    lib = build_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_decode_launch(
        q.data_ptr(), store_k.data_ptr(), store_v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        table32.data_ptr(), lengths32.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        b, s_len, h, d, bs, table32.shape[1], n_j, n_split, split_keys,
        float(scale), _Q_CODES[q.dtype], _KV_CODES[store_k.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: "
                           f"cudaError {err}")
    paged_attend.launches += 1
    return out


paged_attend.launches = 0


def paged_attend_reference(q, store_k, store_v, table, lengths, *,
                           k_scale=None, v_scale=None,
                           scale: Optional[float] = None,
                           max_blocks: Optional[int] = None):
    """The plain PyTorch version of :func:`paged_attend`: gather each
    row's table span into a dense view and run the position-masked
    :func:`~chainermn_torch.parallel.sequence.cached_attention` (int8:
    ``_dequant_cached_attention``) with each row's base
    ``lengths[b] - S``."""
    b, s_len = q.shape[0], q.shape[1]
    n_j = table.shape[1]
    if max_blocks is not None:
        n_j = max(1, min(n_j, int(max_blocks)))
    flat = table[:, :n_j].reshape(-1).long()

    def gather(store):
        rows = store.index_select(0, flat)
        return rows.reshape((b, -1) + tuple(rows.shape[2:]))

    pos0 = lengths.long() - s_len
    if k_scale is not None:
        return _dequant_cached_attention(
            q, gather(store_k), gather(k_scale), gather(store_v),
            gather(v_scale), pos0, scale=scale)
    return cached_attention(q, gather(store_k), gather(store_v), pos0,
                            scale=scale)


def bytes_read_model(lengths, *, block_size: int, max_blocks: int,
                     n_heads: int, head_dim: int, n_layers: int = 1,
                     kv_quant: str = "none") -> dict:
    """Per-decode-step KV bytes-read model (host arithmetic on host
    values, copied from the reference): what one step's attention streams
    from the store, gather path vs kernel, summed over rows and layers.
    The gather path reads every row's full ``max_blocks`` table span and,
    for int8, builds a dequantized f32 dense view (counted as its write
    and read back); the kernel reads ``ceil(len/bs)`` blocks per row in
    the storage type. Elements count 4 bytes unless int8."""
    lengths = np.asarray(lengths, np.int64)
    row_elems = n_heads * head_dim
    esize = 1 if kv_quant == "int8" else 4
    kv_rows_xla = int(lengths.size) * max_blocks * block_size
    kv_rows_kern = int(
        np.sum(-(-np.maximum(lengths, 0) // block_size)) * block_size)
    per_row_scale = n_heads * 4 if kv_quant == "int8" else 0
    xla = 2 * kv_rows_xla * (row_elems * esize + per_row_scale)
    kern = 2 * kv_rows_kern * (row_elems * esize + per_row_scale)
    if kv_quant == "int8":
        xla += 2 * 2 * kv_rows_xla * row_elems * 4
    return {
        "xla_bytes": int(xla * n_layers),
        "kernel_bytes": int(kern * n_layers),
        "read_amplification": round(xla / max(kern, 1), 3),
    }


__all__ = ["build_library", "bytes_read_model", "chunk_queries",
           "paged_attend", "paged_attend_reference", "split_plan"]
