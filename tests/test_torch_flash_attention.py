"""The port's flash attention (``chainermn_torch.ops.flash_attention``)
against the JAX package's Pallas flash kernels, on the CPU.

On CPU tensors the port's kernel wrappers run their plain PyTorch
versions, and ``flash_attention``'s ``torch.autograd.Function`` wires them
together as it wires the kernels on the card. The JAX side runs its Pallas
kernels in interpret mode with ``block_q = block_k = 8``, so several
blocks and the online-softmax carry run, as the JAX package's own flash
tests do. Inputs come from numpy with a fixed seed.

Tolerances: f32 atol 1e-5 (the two sides sum in different orders: one
softmax over all keys against an online softmax over 8-key blocks); bf16
atol 2e-2 (p is rounded to bf16 before PV on both sides, but relative to
the global row max on one and the running max on the other, so a few
values land one bf16 ulp apart); float16 atol 2e-2 as bf16 (a 16-bit
type with the same casts). Head dims other than the kernels' 64 and 128
(8, 32, 96) and float16 are held to the JAX kernels too, and the
wrapper's zero-lane padding (``pad_head_dim``) to the plain versions at
the true head dim. The CUDA kernels are held against the same plain
versions on the card by ``chip_smoke.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
    flash_block_grads as jax_block_grads,
    flash_fwd_with_lse as jax_fwd,
)
from chainermn_torch.ops import flash_attention as tfa
from chainermn_torch.parallel.sequence import full_attention

torch.set_float32_matmul_precision("highest")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores that timing-sensitive tests share
torch.set_num_threads(1)

H, D = 2, 16
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
BLOCKS = dict(block_q=8, block_k=8)

# (tq, tk, causal, q_offset, k_offset)
CASES = {
    "full": (32, 32, False, 0, 0),
    "causal": (32, 32, True, 0, 0),
    "rect_full": (16, 32, False, 0, 0),
    "rect_causal_offset": (16, 32, True, 16, 0),
    # rows 0..11 of q see no key: lse sentinel, zero out and grads
    "masked_rows": (24, 16, True, 0, 12),
    # the whole q slice is before every key
    "all_masked": (16, 16, True, 0, 100),
    # Tq past one 128-row tile of the bf16 kernels, Tk past one 64-key
    # stage, the diagonal crossing both edges (q_offset) or rows that see
    # no key (k_offset)
    "tile_edges_causal_q_offset": (136, 72, True, 8, 0),
    "tile_edges_causal_k_offset": (136, 80, True, 0, 64),
    "tile_edges_full": (136, 72, False, 0, 0),
}


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkv(tq, tk, seed=0, b=2):
    return _arrays([(b, tq, H, D), (b, tk, H, D), (b, tk, H, D)], seed)


def _pair(xs, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(x, jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_fwd_with_lse_matches_jax(case, dtype):
    tq, tk, causal, qo, ko = CASES[case]
    (jq, jk, jv), (tq_, tk_, tv) = _pair(_qkv(tq, tk), dtype)
    kw = dict(causal=causal, q_offset=qo, k_offset=ko)
    j_out, j_lse = jax_fwd(jq, jk, jv, **kw, **BLOCKS)
    t_out, t_lse = tfa.flash_fwd_with_lse(tq_, tk_, tv, **kw)
    atol = DTYPES[dtype][2]
    assert t_out.dtype == DTYPES[dtype][1] and t_lse.dtype == torch.float32
    assert tuple(t_lse.shape) == (2, H, tq)
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(t_lse), _np(j_lse), atol=atol, rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_block_grads_match_jax(case, dtype):
    """dq/dk/dv from the same final lse and delta: the primal backward
    entries the ring layer builds on (f32 gradients on both sides)."""
    tq, tk, causal, qo, ko = CASES[case]
    xs = _qkv(tq, tk) + _arrays([(2, tq, H, D)], 1)
    (jq, jk, jv, jdo), (tq_, tk_, tv, tdo) = _pair(xs, dtype)
    kw = dict(causal=causal, q_offset=qo, k_offset=ko)
    out, lse = tfa.flash_fwd_reference(tq_, tk_, tv, **kw)
    delta = (tdo.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    want = jax_block_grads(jq, jk, jv, jdo, jnp.asarray(lse.numpy()),
                           jnp.asarray(delta.numpy()), **kw, **BLOCKS)
    got = tfa.flash_block_grads(tq_, tk_, tv, tdo, lse, delta, **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(_np(g), _np(w), atol=DTYPES[dtype][2],
                                   rtol=0, err_msg=name)


def _jax_value_and_grads(q, k, v, g, **kw):
    def loss(q, k, v):
        o = jax_flash(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * g), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    return o, grads


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["full", "causal", "rect_causal_offset",
                                  "masked_rows", "ragged_full",
                                  "ragged_causal"])
def test_flash_attention_values_and_grads_match_jax(case, dtype):
    """The differentiable entry. ``ragged_*`` is T = 20, which no 8-row
    block divides: JAX takes its XLA ``full_attention`` path there, while
    the port's kernels take any length."""
    if case.startswith("ragged"):
        tq, tk, causal, qo, ko = 20, 20, case == "ragged_causal", 0, 0
        blocks = {}
    else:
        tq, tk, causal, qo, ko = CASES[case]
        blocks = BLOCKS
    xs = _qkv(tq, tk, seed=2)
    g = _arrays([(2, tq, H, D)], 3)[0]
    (jq, jk, jv), tqkv = _pair(xs, dtype)
    kw = dict(causal=causal, q_offset=qo, k_offset=ko)
    j_out, j_grads = _jax_value_and_grads(jq, jk, jv, jnp.asarray(g),
                                          **kw, **blocks)
    tqkv = [t.requires_grad_() for t in tqkv]
    t_out = tfa.flash_attention(*tqkv, **kw)
    t_grads = torch.autograd.grad(t_out.float(), tqkv, torch.from_numpy(g))
    atol = DTYPES[dtype][2]
    assert t_out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=atol, rtol=0)
    for got, want, name in zip(t_grads, j_grads, "qkv"):
        assert got.dtype == DTYPES[dtype][1], name
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_full_attention(causal):
    """The autograd.Function's backward (delta, dq, dk/dv entries) against
    autograd through the port's own full_attention, f32."""
    xs = [torch.from_numpy(x).requires_grad_()
          for x in _qkv(24, 24, seed=4)]
    g = torch.from_numpy(_arrays([(2, 24, H, D)], 5)[0])
    got = tfa.flash_attention(*xs, causal=causal)
    want = full_attention(*xs, causal=causal)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for a, b in zip(torch.autograd.grad(got, xs, g),
                    torch.autograd.grad(want, xs, g)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_rows_that_see_no_key_are_exact_zeros():
    """``out == 0``, ``lse == -1e30`` and zero gradients for the rows
    before the first key, bit for bit."""
    xs = [torch.from_numpy(x).requires_grad_() for x in _qkv(24, 16)]
    out = tfa.flash_attention(*xs, causal=True, q_offset=0, k_offset=12)
    _, lse = tfa.flash_fwd_with_lse(*xs, causal=True, q_offset=0,
                                    k_offset=12)
    dq, dk, dv = torch.autograd.grad(out.square().sum(), xs)
    assert (out[:, :12] == 0).all() and (out[:, 12:] != 0).any()
    assert (lse[:, :, :12] == -1e30).all() and (lse[:, :, 12:] > -1e29).all()
    assert (dq[:, :12] == 0).all()
    full = tfa.flash_attention(*xs, causal=True, q_offset=0, k_offset=100)
    grads = torch.autograd.grad(full.square().sum(), xs)
    assert (full == 0).all() and all((t == 0).all() for t in grads)
    assert dk.abs().sum() > 0 and dv.abs().sum() > 0


def test_out_dtype_and_grad_dtype():
    xs = [torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(16, 16)]
    out, _ = tfa.flash_fwd_with_lse(*xs, causal=True,
                                    out_dtype=torch.float32)
    assert out.dtype == torch.float32
    ref, _ = tfa.flash_fwd_with_lse(*xs, causal=True)
    torch.testing.assert_close(out.to(torch.bfloat16), ref, atol=0, rtol=0)


def test_launch_counters_stay_zero_on_the_cpu():
    counters = (tfa.flash_fwd_with_lse, tfa.flash_dq, tfa.flash_dkv)
    before = [f.launches for f in counters]
    xs = [torch.from_numpy(x).requires_grad_() for x in _qkv(16, 16)]
    out = tfa.flash_attention(*xs, causal=True)
    torch.autograd.grad(out.sum(), xs)
    assert [f.launches for f in counters] == before == [0, 0, 0]


def test_kernel_args_read_the_fused_qkv_slices_in_place():
    """The launch struct the kernels get: q, k and v sliced from one fused
    [B, T, 3, H, D] projection go in by pointer and stride, uncopied; an
    expanded (stride-0) gradient is copied to a contiguous tensor."""
    b, t, h, d = 2, 5, 3, 64
    qkv = torch.zeros((b, t, 3, h, d), dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.ones((), dtype=torch.bfloat16).expand(b, t, h, d)
    lse = torch.zeros((b, h, t))
    views, _, args = tfa._prepare(q, k, v, do, lse, lse)
    assert views["q"] is q and views["k"] is k and views["v"] is v
    assert views["do"].is_contiguous() and args.dout != do.data_ptr()
    assert (args.q, args.k, args.v) == (q.data_ptr(), k.data_ptr(),
                                        v.data_ptr())
    assert (args.q_sb, args.q_st, args.q_sh) == (t * 3 * h * d, 3 * h * d, d)
    assert (args.do_sb, args.do_st, args.do_sh) == (t * h * d, h * d, d)
    assert (args.batch, args.heads, args.tq, args.tk, args.head_dim,
            args.in_dtype) == (b, h, t, t, d, 1)


@pytest.mark.parametrize("bad", ["head_dim", "float64", "mixed", "stats"])
def test_kernel_args_reject_what_the_kernels_do_not_take(bad):
    """The launch struct takes the kernels' own widths only (the public
    wrappers pad other head dims first, :func:`pad_head_dim`), one of
    float32, bfloat16 or float16 for all inputs, and ``[B, H, Tq]``
    statistics."""
    shape = {"head_dim": (1, 4, 2, 32)}.get(bad, (1, 4, 2, 64))
    dtype = torch.float64 if bad == "float64" else torch.float32
    q = torch.zeros(shape, dtype=dtype)
    k = q.to(torch.bfloat16) if bad == "mixed" else q
    lse = torch.zeros((1, 2, 3 if bad == "stats" else 4))
    with pytest.raises(ValueError, match="flash attention kernel"):
        tfa._prepare(q, k, q, q, lse, lse)


def test_build_error_carries_the_compiler_output(tmp_path, monkeypatch):
    from chainermn_torch import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    nvcc.chmod(0o755)
    src = tmp_path / "kernel.cu"
    src.write_text("// empty\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*no sm_90a"):
        _build.load_library(src, {})
    assert not list((tmp_path / "build").iterdir())


def test_flash_library_hash_covers_both_hopper_headers():
    """The bf16 forward and backward kernels live in headers that
    ``flash_attention.cu`` includes: both count in the library's name."""
    from chainermn_torch import _build

    names = [p.name for p in _build._included(tfa._SRC)]
    assert names == ["flash_bwd_sm90.cuh", "flash_fwd_sm90.cuh"]


def test_edited_header_changes_the_library_name(tmp_path, monkeypatch):
    """The library is named by a hash of its source and of the headers it
    includes (also through another header), so an edited header is never
    served from a stale build. The fake nvcc fails and prints the output
    path it was given."""
    from chainermn_torch import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@" >&2\nexit 3\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "inc").mkdir()
    src = tmp_path / "kernel.cu"
    src.write_text('#include "inc/outer.cuh"\n')
    (tmp_path / "inc" / "outer.cuh").write_text('#include "inner.cuh"\n')
    inner = tmp_path / "inc" / "inner.cuh"

    def built_name():
        with pytest.raises(RuntimeError) as err:
            _build.load_library(src, {})
        return re.search(r"kernel_[0-9a-f]{12}\.so", str(err.value)).group()

    inner.write_text("// one\n")
    first = built_name()
    assert built_name() == first == _build.library_path(src).name
    inner.write_text("// two\n")
    assert built_name() != first


# --------------------------------------------------------------------- #
# What the reference takes beyond the kernels' own widths and types      #
# --------------------------------------------------------------------- #

# head dims the kernels run padded (D -> 64 or 128), and float16
WIDE = {"D8": (8, "f32"), "D32": (32, "f32"), "D96": (96, "f32"),
        "D32_f16": (32, "f16"), "D64_f16": (64, "f16")}
WIDE_DTYPES = dict(DTYPES, f16=(jnp.float16, torch.float16, 2e-2))


def _wide_inputs(d, dtype, tq=24, tk=24, seed=6):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((2, t, H, d)).astype(np.float32)
          for t in (tq, tk, tk, tq)]
    jdt, tdt, _ = WIDE_DTYPES[dtype]
    return ([jnp.asarray(x, jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


@pytest.mark.parametrize("case", list(WIDE))
def test_plain_versions_match_jax_at_any_head_dim_and_float16(case):
    """The forward and both backward plain versions against the Pallas
    kernels (interpret mode, 8-row blocks) at head dims the CUDA kernels
    run padded, and in float16 (p and ds rounded to float16 on both
    sides, float32 accumulation)."""
    d, dtype = WIDE[case]
    (jq, jk, jv, jdo), (q, k, v, do) = _wide_inputs(d, dtype)
    kw = dict(causal=True, q_offset=4, k_offset=0)
    j_out, j_lse = jax_fwd(jq, jk, jv, **kw, **BLOCKS)
    out, lse = tfa.flash_fwd_with_lse(q, k, v, **kw)
    atol = WIDE_DTYPES[dtype][2]
    assert out.dtype == WIDE_DTYPES[dtype][1]
    np.testing.assert_allclose(_np(out), _np(j_out), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(lse), _np(j_lse), atol=atol, rtol=1e-6)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    want = jax_block_grads(jq, jk, jv, jdo, jnp.asarray(lse.numpy()),
                           jnp.asarray(delta.numpy()), **kw, **BLOCKS)
    got = tfa.flash_block_grads(q, k, v, do, lse, delta, **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("d", [1, 8, 32, 65, 96])
def test_pad_head_dim_is_exact(d):
    """The wrapper-side padding, run over the plain versions: out, lse,
    dq, dk and dv at the padded width, cut back to D, equal the plain
    versions at the true D (the softmax scale stays D ** -0.5)."""
    (_, _, _, _), (q, k, v, do) = _wide_inputs(d, "f32", seed=7)
    kw = dict(causal=True, q_offset=0, k_offset=3)
    out, lse = tfa.pad_head_dim(tfa.flash_fwd_reference, q, k, v, **kw)
    r_out, r_lse = tfa.flash_fwd_reference(q, k, v, **kw)
    assert out.shape == q.shape
    torch.testing.assert_close(out, r_out, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse, r_lse, atol=1e-6, rtol=0)
    delta = (do * r_out).sum(-1).transpose(1, 2).contiguous()
    dq = tfa.pad_head_dim(tfa.flash_dq_reference, q, k, v, do, r_lse,
                          delta, **kw)
    dk, dv = tfa.pad_head_dim(tfa.flash_dkv_reference, q, k, v, do, r_lse,
                              delta, **kw)
    r_dk, r_dv = tfa.flash_dkv_reference(q, k, v, do, r_lse, delta, **kw)
    torch.testing.assert_close(
        dq, tfa.flash_dq_reference(q, k, v, do, r_lse, delta, **kw),
        atol=1e-6, rtol=0)
    torch.testing.assert_close(dk, r_dk, atol=1e-6, rtol=0)
    torch.testing.assert_close(dv, r_dv, atol=1e-6, rtol=0)


def test_kernel_head_dim_rounds_up_and_stops_at_128():
    assert [tfa.kernel_head_dim(d) for d in (1, 8, 63, 64, 65, 96, 128)] == \
        [64, 64, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="head dim 160"):
        tfa.kernel_head_dim(160)


def test_float16_autograd_matches_jax():
    """The differentiable entry in float16 against ``jax_flash``: values
    and gradients come back in float16."""
    (jq, jk, jv, jg), tqkvg = _wide_inputs(32, "f16", seed=8)
    g = np.asarray(jg, np.float32)
    j_out, j_grads = _jax_value_and_grads(jq, jk, jv, jnp.asarray(g),
                                          causal=True, **BLOCKS)
    tqkv = [t.requires_grad_() for t in tqkvg[:3]]
    t_out = tfa.flash_attention(*tqkv, causal=True)
    t_grads = torch.autograd.grad(t_out.float(), tqkv, torch.from_numpy(g))
    assert t_out.dtype == torch.float16
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=2e-2, rtol=0)
    for got, want, name in zip(t_grads, j_grads, "qkv"):
        assert got.dtype == torch.float16, name
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=0,
                                   err_msg=f"d{name}")
