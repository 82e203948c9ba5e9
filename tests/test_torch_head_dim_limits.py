"""The head dims the port's kernels take on the card, checked without one.

The four Hopper kernels run every head dim ``D`` up to 256 (the flash
wrappers pad to 64, 128 or 256; the paged kernel masks lanes past ``D``)
and refuse 257. Their wrappers' argument checks run on CPU tensors here.
The CUDA tile structs size each kernel's dynamic shared memory; their
formulas are mirrored below, pinned to the source lines they copy, and
every instance must fit the 232,448 B a CTA may use on an H100, with its
f32 accumulators inside the 255 registers a thread may hold. ``nvcc``
checks the same limits with ``static_assert`` when it builds the card's
library (``csrc/flash_bwd_sm90.cuh``, ``csrc/flash_attention.cu``).
"""

import importlib
import re
from pathlib import Path

import pytest
import torch

from chainermn_torch.parallel import paged_kernel as tpk

tfa = importlib.import_module("chainermn_torch.ops.flash_attention")

CSRC = Path(tfa.__file__).resolve().parents[1] / "csrc"
SMEM_LIMIT = 232_448      # kSmemLimit: dynamic shared memory a CTA may use
REG_LIMIT = 255           # registers a thread may hold
SM90_ROWS, STAGES = 128, 3


def _up(n, to):
    return -(-n // to) * to


# the 16-bit (wgmma) kernels: FwdTiles, DqTiles, DkvTiles; 64-row f32
# accumulators over a warpgroup's 128 threads hold cols / 2 floats a thread
def fwd_sm90(d):
    bk = 32 if d > 128 else 64
    smem = SM90_ROWS * d * 2 + STAGES * 2 * bk * d * 2 + 1024
    return smem, d // 2 + bk // 2 + bk // 4     # O, S, T(P)


def dq_sm90(d):
    bk = 32 if d > 128 else 64
    smem = 2 * SM90_ROWS * d * 2 + STAGES * 2 * bk * d * 2 + 1024
    return smem, d // 2 + bk + bk // 4          # dQ, S and dP, T(dS)


def dkv_sm90(d):
    rows = 64 if d > 128 else SM90_ROWS
    cols = d // 2 if d > 128 else d
    bq = 64 if d == 64 else 32
    stage = _up(2 * bq * d * 2 + 2 * bq * 4, 1024)
    smem = 2 * rows * d * 2 + STAGES * stage + 1024
    return smem, cols + bq + bq // 2            # dK and dV, S and dP, T(P), T(dS)


# the f32 kernels: Layout<D>, scores and accumulators in shared memory
def _f32_layout(d):
    tile, pad = 32, 1
    r = (lambda n: _up(4 * n, 128))
    t, sc, p, acc, st = (r(tile * (d + pad)), r(tile * (tile + 4)),
                         r(tile * (tile + pad)), r(tile * (d + 4)), r(tile))
    return {"fwd": 3 * t + sc + p + acc + 2 * st,
            "dq": 4 * t + 2 * sc + p + acc + 2 * st,
            "dkv": 4 * t + 2 * sc + 2 * p + 2 * acc + 2 * st}


TILES = {"fwd_sm90": fwd_sm90, "dq_sm90": dq_sm90, "dkv_sm90": dkv_sm90,
         "fwd_f32": lambda d: (_f32_layout(d)["fwd"], 0),
         "dq_f32": lambda d: (_f32_layout(d)["dq"], 0),
         "dkv_f32": lambda d: (_f32_layout(d)["dkv"], 0)}

# the source lines the formulas above copy (whitespace-normalised)
PINNED = {
    "flash_fwd_sm90.cuh": [
        "static constexpr int kBk = D > 128 ? 32 : 64;",
        "static constexpr uint32_t kQ = kSm90Rows * D * 2;",
        "static constexpr uint32_t kStage = 2 * kK;",
        "static constexpr size_t kSmem = kQ + kStages * kStage + 1024;"],
    "flash_bwd_sm90.cuh": [
        "constexpr int kSm90Rows = 128;",
        "constexpr int kStages = 3;",
        "constexpr size_t kSmemLimit = 232448;",
        "static constexpr int kBk = D > 128 ? 32 : 64;",
        "static constexpr size_t kSmem = 2 * kQ + kStages * kStage + 1024;",
        "static constexpr bool kColSplit = D > 128;",
        "static constexpr int kRows = kColSplit ? 64 : kSm90Rows;",
        "static constexpr int kCols = kColSplit ? D / 2 : D;",
        "static constexpr int kBq = D == 64 ? 64 : 32;",
        "static constexpr uint32_t kKv = kRows * D * 2;",
        "static constexpr uint32_t kStage = (2 * kQ + 2 * kBq * 4 + 1023) "
        "/ 1024 * 1024;",
        "static constexpr size_t kSmem = 2 * kKv + kStages * kStage + 1024;"],
    "flash_attention.cu": [
        "constexpr int kTile = 32;",
        "constexpr int kPad = 1;",
        "static constexpr size_t kFwd = 3 * kTileBytes + kScoreBytes + "
        "kPBytes + kAccBytes + 2 * kStatBytes;",
        "static constexpr size_t kDkv = 4 * kTileBytes + 2 * kScoreBytes + "
        "2 * kPBytes + 2 * kAccBytes + 2 * kStatBytes;",
        "else if (a->head_dim == 256) err = dispatch_types<KIND, 256>(*a, st);"],
    "paged_decode.cu": [
        "if (D <= 128) return launch_s<QT, KVT, 128, QUANT>(D, c);",
        "return launch_s<QT, KVT, 256, QUANT>(D, c);",
        "D < 1 || D > 256 || S < 1 || S > kMaxQueries ||"],
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_mirrored_formulas_are_the_sources(name):
    text = " ".join((CSRC / name).read_text().split())
    for line in PINNED[name]:
        assert " ".join(line.split()) in text, (name, line)


@pytest.mark.parametrize("d", tfa._HEAD_DIMS)
@pytest.mark.parametrize("kernel", sorted(TILES))
def test_every_instance_fits_a_cta(kernel, d):
    smem, regs = TILES[kernel](d)
    assert smem <= SMEM_LIMIT, (kernel, d, smem)
    assert regs < REG_LIMIT, (kernel, d, regs)


def test_d256_figures():
    """The sizes PERF.md and the sources quote for D = 256."""
    assert [TILES[k](256)[0] for k in ("fwd_sm90", "dq_sm90", "dkv_sm90")] \
        == [164_864, 230_400, 167_936]
    assert _f32_layout(256) == {"fwd": 141_056, "dq": 178_560,
                                "dkv": 216_064}
    # 128-row tiles at D = 256 would not fit: why the tiles changed
    assert SM90_ROWS * 256 * 2 + STAGES * 2 * 64 * 256 * 2 + 1024 > SMEM_LIMIT
    assert 2 * (64 * 256 // 128) > REG_LIMIT      # dK + dV of 64 full rows


def test_head_dims_are_64_128_256():
    assert tfa._HEAD_DIMS == (64, 128, 256) and tpk._MAX_HEAD_DIM == 256


@pytest.mark.parametrize("d", [256, 257])
def test_flash_kernel_args_take_256_and_refuse_257(d):
    """``_prepare`` fills the launch struct at D = 256 and refuses 257;
    the wrappers' padding refuses 257 before it pads."""
    q = torch.zeros((1, 8, 2, d), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    if d == 256:
        _, _, args = tfa._prepare(q, q, q, q, lse, lse)
        assert args.head_dim == 256
        assert tfa.kernel_head_dim(d) == 256
        return
    with pytest.raises(ValueError, match="head dim 257"):
        tfa._prepare(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match=r"head dim 257 .*1 \.\. 256"):
        tfa.pad_head_dim(tfa.flash_fwd_reference, q, q, q)


@pytest.mark.parametrize("d", [1, 160, 256, 257])
@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
def test_paged_kernel_args_take_up_to_256(store, d):
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}[store]
    b, h, n_blocks, bs = 2, 4, 5, 16
    q = torch.zeros((b, 1, h, d), dtype=torch.bfloat16)
    kv = torch.zeros((n_blocks, bs, h, d), dtype=dtype)
    scales = {}
    if store == "int8":
        sc = torch.ones((n_blocks, bs, h))
        scales = dict(k_scale=sc, v_scale=sc)
    table = torch.zeros((b, 2), dtype=torch.int32)
    lengths = torch.tensor([3, 20], dtype=torch.int32)
    if d <= 256:
        tpk._check_args(q, kv, kv, table, lengths, **scales)
        return
    with pytest.raises(ValueError, match=re.escape(
            "head dim 257 (the kernel takes 1 .. 256)")):
        tpk._check_args(q, kv, kv, table, lengths, **scales)
