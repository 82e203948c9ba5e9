"""Flash attention: the hand-written Hopper kernels
(``csrc/flash_attention.cu``), their plain PyTorch versions, and the
differentiable entry the LM calls.

Port of ``chainermn_tpu/ops/flash_attention.py``. Every public function
takes the reference's ``[B, T, H, D]`` layout, with ``lse`` and ``delta``
as float32 ``[B, H, Tq]``:

- :func:`flash_attention`: differentiable attention (a
  ``torch.autograd.Function`` whose forward is the forward kernel and whose
  backward is the dq and dk/dv kernels);
- :func:`flash_fwd_with_lse`: the forward kernel, ``(out, lse)``;
- :func:`flash_dq` and :func:`flash_dkv`: the two backward kernels, given
  the final ``lse`` and ``delta = rowsum(do * out)``;
- :func:`flash_block_grads`: both, ``(dq, dk, dv)`` — the primal entry
  the ring layer builds its own backward on.

Each kernel wrapper launches its CUDA kernel for CUDA tensors (adding one
to its ``launches`` count, and to ``launches_f32`` as well for float32
inputs); for CPU tensors it runs the plain version
(:func:`flash_fwd_reference`, :func:`flash_dq_reference`,
:func:`flash_dkv_reference`), which materialises the scores and repeats
the kernel's casts. There is no fallback on the card and no switch to
turn the kernels off. On the card they take what the reference takes:
float32, bfloat16 or float16 inputs of one dtype, any ``Tq``/``Tk``, any
``B * H``, and any head dim ``D``. The kernels are built for ``D`` of 64,
128 and 256, and past 256 for every multiple of 64 (``csrc/flash_wide.cuh``:
each CTA owns 256 columns of the output, so nothing it holds grows with
``D``; up to ``D`` = 2048 the slices of a tile run as one thread-block
cluster that shares the score products through distributed shared
memory, in every dtype but the float32 forward, which, like every kernel
past 2048, streams the products that reduce over ``D`` in 64-column
chunks); float32 runs register-tiled FMA products
(``csrc/flash_f32_sm90.cuh``). :func:`pad_head_dim` runs any other ``D``
on the next of these widths (:func:`kernel_head_dim`) with zero lanes
(exact; it costs one padded copy of the inputs). The
reference's
``full_attention`` fallback for untileable lengths has no counterpart;
its ``block_q``/``block_k`` tuning knobs have none either.

Masked scores take ``-1e30``; a masked probability is exactly 0; a row
that sees no key gets ``out = 0``, ``lse = -1e30`` and zero gradients.
PV multiplies ``p`` rounded to v's type, dv ``p`` rounded to do's type,
dq ``ds`` rounded to k's type and dk ``ds`` rounded to q's type, each
with float32 accumulation. The kernel library is compiled with ``nvcc``
at first launch (:mod:`chainermn_torch._build`); nothing about CUDA is
touched while this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from chainermn_torch._build import load_library

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
_NEG_BIG = -1e30
_HEAD_DIMS = (64, 128, 256)  # the widths of the one-tile kernels
_WIDE_STEP = 64  # past 256 the kernels take every multiple of this
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the output dtypes each input dtype's kernels write; any other output
# dtype is written as float32 and cast, which rounds the same f32 value once
_OUT_DTYPES = {torch.float32: (torch.float32, torch.bfloat16),
               torch.bfloat16: (torch.bfloat16, torch.float32),
               torch.float16: (torch.float16, torch.float32)}


class _FlashArgs(ctypes.Structure):
    """``FlashArgs`` of the CUDA source: every field is 8 bytes."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "dout", "lse", "delta", "out", "lse_out", "dq",
            "dk", "dv")]
        + [(n, ctypes.c_int64) for n in (
            "q_sb", "q_st", "q_sh", "k_sb", "k_st", "k_sh", "v_sb", "v_st",
            "v_sh", "do_sb", "do_st", "do_sh", "batch", "heads", "tq", "tk",
            "head_dim", "q_offset", "k_offset", "causal", "in_dtype",
            "out_dtype")]
        + [("scale", ctypes.c_double)])


_SIGNATURES = {name: ([ctypes.POINTER(_FlashArgs), ctypes.c_void_p],
                      ctypes.c_int)
               for name in ("flash_fwd_launch", "flash_dq_launch",
                            "flash_dkv_launch")}


def build_library() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library.
    ``build_library.log`` holds this process's build output (``-Xptxas
    -v`` registers, shared memory and spills of each kernel)."""
    lib, log = load_library(_SRC, _SIGNATURES)
    build_library.log = log
    return lib


build_library.log = ""


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run ``d`` at: the least of ``_HEAD_DIMS``
    that holds it, and past 256 the next multiple of 64 (257 runs at
    320)."""
    _check(d >= 1, f"head dim {d}")
    if d > _HEAD_DIMS[-1]:
        return -(-d // _WIDE_STEP) * _WIDE_STEP
    return next(w for w in _HEAD_DIMS if w >= d)


def pad_head_dim(attend, q, k, v, *rest, scale: Optional[float] = None,
                 **kw):
    """``attend(q, k, v, *rest, scale=..., **kw)`` run at the kernels' head
    dim (:func:`kernel_head_dim`): every ``[B, T, H, D]`` argument is
    padded with zero lanes up to it, the softmax scale stays the true
    ``D ** -0.5`` unless given, and every ``[B, T, H, D]`` result is cut
    back to ``D`` (``lse``-shaped results pass through). Exact: a zero
    lane adds nothing to ``q k^T`` and gives zero columns of out, dq, dk
    and dv. ``attend`` is any of the wrappers or their plain versions."""
    d = q.shape[-1]
    width = kernel_head_dim(d)
    scale = _scale(q, scale)
    if width == d:
        return attend(q, k, v, *rest, scale=scale, **kw)

    def pad(t):
        if isinstance(t, torch.Tensor) and t.dim() == 4 and t.shape[-1] == d:
            return torch.nn.functional.pad(t, (0, width - d))
        return t

    def cut(t):
        return t[..., :d] if t.dim() == 4 else t

    out = attend(*map(pad, (q, k, v, *rest)), scale=scale, **kw)
    return tuple(map(cut, out)) if isinstance(out, tuple) else cut(out)


def _kernel_view(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` as the kernel reads it: unit stride on D, a 16-byte-aligned
    base and batch/time/head strides in whole 16-byte pieces (the fused
    qkv projection's q, k and v slices qualify as they are); anything
    else is copied to a contiguous tensor."""
    vec = 16 // x.element_size()

    def ok(t):
        return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
                and all(s % vec == 0 for s in t.stride()[:3]))

    if not ok(x):
        x = x.contiguous()
    _check(ok(x), f"{name} is not 16-byte aligned")
    return x


def _prepare(q, k, v, do=None, lse=None, delta=None):
    """Check what the kernels take; returns the kernel views and the args
    struct with the inputs, strides and geometry filled in."""
    dev = q.device
    ins = {"q": q, "k": k, "v": v}
    if do is not None:
        ins["do"] = do
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "q, k and v must be [B, T, H, D]")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    _check(q.dtype in _CODES,
           f"dtype {q.dtype} (want float32, bfloat16 or float16)")
    _check(all(t.dtype == q.dtype for t in ins.values()),
           "q, k, v and do must share one dtype")
    _check(d == kernel_head_dim(d),
           f"head dim {d} (want one of {_HEAD_DIMS} or a multiple of "
           f"{_WIDE_STEP} past {_HEAD_DIMS[-1]})")
    _check(tuple(k.shape) == (b, tk, h, d) and v.shape == k.shape,
           f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} vs q "
           f"{tuple(q.shape)}")
    _check(do is None or do.shape == q.shape,
           f"do shape {tuple(do.shape) if do is not None else ()} vs q")
    _check(tq >= 1 and tk >= 1 and b * h <= 65535 ** 2,
           f"sequence lengths {tq}/{tk} and batch*heads {b * h}")
    stats = [t for t in (lse, delta) if t is not None]
    _check(all(t.dtype == torch.float32 and tuple(t.shape) == (b, h, tq)
               for t in stats), "lse and delta must be float32 [B, H, Tq]")
    _check(all(t.device == dev for t in list(ins.values()) + stats),
           "all tensors must be on q's device")
    ins = {n: _kernel_view(t, n) for n, t in ins.items()}
    args = _FlashArgs(batch=b, heads=h, tq=tq, tk=tk, head_dim=d,
                      in_dtype=_CODES[q.dtype])
    for n, t in ins.items():
        setattr(args, "dout" if n == "do" else n, t.data_ptr())
        sb, st, sh, _ = t.stride()
        setattr(args, f"{n}_sb", sb)
        setattr(args, f"{n}_st", st)
        setattr(args, f"{n}_sh", sh)
    if lse is not None:
        lse, delta = lse.contiguous(), delta.contiguous()
        args.lse, args.delta = lse.data_ptr(), delta.data_ptr()
    return ins, (lse, delta), args


def _out_dtype(in_dtype, want):
    """The dtype the kernel writes for output dtype ``want``: ``want``
    itself where the kernels write it, else float32 (cast after)."""
    return want if want in _OUT_DTYPES[in_dtype] else torch.float32


def _launch(name: str, args: _FlashArgs, dtype, *, causal, scale, q_offset,
            k_offset, device) -> None:
    args.out_dtype = _CODES[dtype]
    args.causal = int(bool(causal))
    args.q_offset, args.k_offset = int(q_offset), int(k_offset)
    args.scale = float(scale)
    lib = build_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def flash_fwd_with_lse(q, k, v, *, causal: bool = False,
                       scale: Optional[float] = None, q_offset: int = 0,
                       k_offset: int = 0, out_dtype=None):
    """Flash forward, ``(out [B, Tq, H, D], lse [B, H, Tq])``: ``out`` in
    ``out_dtype`` (default ``q.dtype``), ``lse`` float32 with ``-1e30``
    for rows that see no key. ``q_offset``/``k_offset`` are the global
    positions of ``q[:, 0]``/``k[:, 0]`` for causal masking. On CUDA
    tensors this launches the forward kernel; it takes float32, bfloat16
    or float16 inputs of one dtype, any ``D``, any lengths."""
    scale = _scale(q, scale)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset, out_dtype=out_dtype)
    if not q.is_cuda:
        return flash_fwd_reference(q, k, v, **kw)
    if q.shape[-1] != kernel_head_dim(q.shape[-1]):
        return pad_head_dim(flash_fwd_with_lse, q, k, v, **kw)
    views, _, args = _prepare(q, k, v)   # held until the launch is queued
    b, tq, h, d = q.shape
    want = out_dtype or q.dtype
    out = torch.empty((b, tq, h, d), dtype=_out_dtype(q.dtype, want),
                      device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    args.out, args.lse_out = out.data_ptr(), lse.data_ptr()
    _launch("flash_fwd_launch", args, out.dtype, causal=causal, scale=scale,
            q_offset=q_offset, k_offset=k_offset, device=q.device)
    flash_fwd_with_lse.launches += 1
    flash_fwd_with_lse.launches_f32 += q.dtype == torch.float32
    return out.to(want), lse


flash_fwd_with_lse.launches = 0
flash_fwd_with_lse.launches_f32 = 0


def flash_dq(q, k, v, do, lse, delta, *, causal: bool = False,
             scale: Optional[float] = None, q_offset: int = 0,
             k_offset: int = 0, grad_dtype=torch.float32):
    """dq ``[B, Tq, H, D]`` in ``grad_dtype`` from the final ``lse`` and
    ``delta`` (float32 ``[B, H, Tq]``). On CUDA tensors this launches the
    dq kernel."""
    scale = _scale(q, scale)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset, grad_dtype=grad_dtype)
    if not q.is_cuda:
        return flash_dq_reference(q, k, v, do, lse, delta, **kw)
    if q.shape[-1] != kernel_head_dim(q.shape[-1]):
        return pad_head_dim(flash_dq, q, k, v, do, lse, delta, **kw)
    views, stats, args = _prepare(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=_out_dtype(q.dtype, grad_dtype),
                     device=q.device)
    args.dq = dq.data_ptr()
    _launch("flash_dq_launch", args, dq.dtype, causal=causal, scale=scale,
            q_offset=q_offset, k_offset=k_offset, device=q.device)
    flash_dq.launches += 1
    flash_dq.launches_f32 += q.dtype == torch.float32
    return dq.to(grad_dtype)


flash_dq.launches = 0
flash_dq.launches_f32 = 0


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
              scale: Optional[float] = None, q_offset: int = 0,
              k_offset: int = 0, grad_dtype=torch.float32):
    """``(dk, dv)``, each ``[B, Tk, H, D]`` in ``grad_dtype``, from the
    final ``lse`` and ``delta``. On CUDA tensors this launches the dk/dv
    kernel."""
    scale = _scale(q, scale)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset, grad_dtype=grad_dtype)
    if not q.is_cuda:
        return flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    if q.shape[-1] != kernel_head_dim(q.shape[-1]):
        return pad_head_dim(flash_dkv, q, k, v, do, lse, delta, **kw)
    views, stats, args = _prepare(q, k, v, do, lse, delta)
    kernel_dtype = _out_dtype(q.dtype, grad_dtype)
    dk = torch.empty(k.shape, dtype=kernel_dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=kernel_dtype, device=q.device)
    args.dk, args.dv = dk.data_ptr(), dv.data_ptr()
    _launch("flash_dkv_launch", args, kernel_dtype, causal=causal,
            scale=scale, q_offset=q_offset, k_offset=k_offset,
            device=q.device)
    flash_dkv.launches += 1
    flash_dkv.launches_f32 += q.dtype == torch.float32
    return dk.to(grad_dtype), dv.to(grad_dtype)


flash_dkv.launches = 0
flash_dkv.launches_f32 = 0


def flash_block_grads(q, k, v, do, lse, delta, *, causal: bool = False,
                      scale: Optional[float] = None, q_offset: int = 0,
                      k_offset: int = 0, grad_dtype=torch.float32):
    """One block's gradient contributions ``(dq, dk, dv)`` given the final
    (globally merged) ``lse`` and ``delta = rowsum(do * out)``, both
    float32 ``[B, H, Tq]``; gradients in ``grad_dtype`` (default float32,
    for callers that accumulate across blocks)."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset, grad_dtype=grad_dtype)
    dq = flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel forward; dq and dk/dv kernels backward, with
    ``delta = rowsum(do * out)`` in float32 as the reference's ``_bwd``
    computes it. Gradients come back in the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, k_offset):
        kw = dict(causal=causal, scale=scale, q_offset=q_offset,
                  k_offset=k_offset)
        out, lse = flash_fwd_with_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        dq = flash_dq(q, k, v, do, lse, delta, grad_dtype=q.dtype, **ctx.kw)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, grad_dtype=k.dtype,
                           **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, q_offset: int = 0,
                    k_offset: int = 0):
    """Blockwise (flash) attention over ``[B, T, H, D]``, differentiable,
    with the semantics of
    :func:`chainermn_torch.parallel.sequence.full_attention` (plus p
    rounded to v's type before PV). Output in ``q.dtype``."""
    return _FlashAttention.apply(q, k, v, bool(causal), _scale(q, scale),
                                 int(q_offset), int(k_offset))


# --------------------------------------------------------------------------- #
# Plain versions                                                              #
# --------------------------------------------------------------------------- #

def _scores(q, k, *, causal, scale, q_offset, k_offset):
    """Masked float32 scores ``[B, H, Tq, Tk]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_BIG)
    return s


def _probs(s, lse):
    """``exp(s - lse)`` with masked entries exactly 0 (also where ``lse``
    is the sentinel and ``exp`` would give 1)."""
    return torch.exp(s - lse[..., None]).masked_fill(s <= _NEG_BIG / 2, 0.0)


def flash_fwd_reference(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None, q_offset: int = 0,
                        k_offset: int = 0, out_dtype=None):
    """The plain version of :func:`flash_fwd_with_lse`."""
    s = _scores(q, k, causal=causal, scale=_scale(q, scale),
                q_offset=q_offset, k_offset=k_offset)
    m = s.amax(-1)
    p = _probs(s, m)
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    empty = l == 0
    l_safe = l.masked_fill(empty, 1.0)
    out = o / l_safe.transpose(1, 2)[..., None]
    lse = (m + torch.log(l_safe)).masked_fill(empty, _NEG_BIG)
    return out.to(out_dtype or q.dtype), lse


def _ds(q, k, v, do, lse, delta, *, causal, scale, q_offset, k_offset):
    s = _scores(q, k, causal=causal, scale=scale, q_offset=q_offset,
                k_offset=k_offset)
    p = _probs(s, lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_dq_reference(q, k, v, do, lse, delta, *, causal: bool = False,
                       scale: Optional[float] = None, q_offset: int = 0,
                       k_offset: int = 0, grad_dtype=torch.float32):
    """The plain version of :func:`flash_dq`."""
    scale = _scale(q, scale)
    _, ds = _ds(q, k, v, do, lse, delta, causal=causal, scale=scale,
                q_offset=q_offset, k_offset=k_offset)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (dq * scale).to(grad_dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, *, causal: bool = False,
                        scale: Optional[float] = None, q_offset: int = 0,
                        k_offset: int = 0, grad_dtype=torch.float32):
    """The plain version of :func:`flash_dkv`."""
    scale = _scale(q, scale)
    p, ds = _ds(q, k, v, do, lse, delta, causal=causal, scale=scale,
                q_offset=q_offset, k_offset=k_offset)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (dk * scale).to(grad_dtype), dv.to(grad_dtype)


__all__ = ["build_library", "flash_attention", "flash_block_grads",
           "flash_dkv", "flash_dkv_reference", "flash_dq",
           "flash_dq_reference", "flash_fwd_reference",
           "flash_fwd_with_lse", "kernel_head_dim", "pad_head_dim"]
