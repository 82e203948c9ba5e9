"""The head dims and dtypes the port's kernels take on the card, checked
without one.

The four Hopper kernels run every head dim ``D``: the flash wrappers pad
``D`` up to 64, 128 or 256, and past 256 up to the next multiple of 64,
which the wide kernels (``csrc/flash_wide.cuh``) run as 256-column
slices of the output, one CTA each. The 16-bit forward, dq and dk/dv and
the f32 dq and dk/dv run the slices of a tile as one thread-block cluster
up to the portable cluster size (8 slices, D <= 2048), each CTA
contracting the score products over its own columns and summing the
cluster's partials through distributed shared memory; the f32 forward
and wider D stream the products that reduce over ``D`` in 64-column
chunks. The paged kernel
masks lanes past ``D`` up to 256 and splits wider outputs into
256-column slices too. The paged kernel takes float16 queries over
float16 and int8 stores beside float32 and bfloat16 queries over
float32, bfloat16 and int8 stores.
The wrappers' argument checks run on CPU tensors here.

The CUDA tile structs size each kernel's dynamic shared memory; their
formulas are mirrored below, pinned to the source lines they copy, and
every instance must fit the 232,448 B a CTA may use on an H100, with its
f32 accumulators inside the 255 registers a thread may hold. Past 256
neither grows with ``D`` along one route. ``nvcc`` checks the same limits with
``static_assert`` when it builds the card's library
(``csrc/flash_bwd_sm90.cuh``, ``csrc/flash_f32_sm90.cuh``,
``csrc/flash_wide.cuh``, ``csrc/flash_attention.cu``).
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from chainermn_torch.parallel import paged_kernel as tpk

tfa = importlib.import_module("chainermn_torch.ops.flash_attention")

CSRC = Path(tfa.__file__).resolve().parents[1] / "csrc"
SMEM_LIMIT = 232_448      # kSmemLimit: dynamic shared memory a CTA may use
REG_LIMIT = 255           # registers a thread may hold
SM90_ROWS, STAGES = 128, 3
RING = 4                    # kRing: the cluster kernels' stages
WIDE_COLS, CHUNK = 256, 64  # kWideCols, kChunk of flash_wide.cuh
PART = 64 * 32 * 4          # kPartBytes: a warpgroup's partial scores
MAX_CLUSTER = 8             # kMaxCluster: the portable cluster size
HEAD_DIMS = (64, 128, 256, 320, 512, 1024, 2112)


def _up(n, to):
    return -(-n // to) * to


def wide_cluster(kind, dtype, d):
    """The cluster size ``launch_wide`` launches kernel ``kind`` with
    (1: no cluster): its pinned ``cluster`` line over ``wide_slices``."""
    ns = -(-d // WIDE_COLS)
    cluster = (dtype != "f32" or kind != "fwd") and ns <= MAX_CLUSTER
    return ns if d > 256 and cluster else 1


# the 16-bit (wgmma) kernels: FwdTiles, DqTiles, DkvTiles up to 256,
# FwdCluster, DqCluster and DkvCluster past it up to the cluster limit, and
# FwdWide, DqWide, DkvWide past that; 64-row f32 accumulators over a
# warpgroup's 128 threads hold cols / 2 floats a thread
def fwd_sm90(d):
    if d > 256 and wide_cluster("fwd", "bf16", d) > 1:
        # Q's slice, K and V slices of 32 keys in each of the 4 stages,
        # two buffers of both warpgroups' partial S; O, S and the next
        # tile's partial, T(P)
        bk = 32
        smem = (SM90_ROWS * WIDE_COLS * 2 + RING * 2 * bk * WIDE_COLS * 2
                + 2 * 2 * PART + 1024)
        return smem, WIDE_COLS // 2 + bk + bk // 4
    if d > 256:     # Q and K chunks, or V's slice, a stage
        bk = 32
        stage = _up(max(SM90_ROWS * CHUNK * 2 + bk * CHUNK * 2,
                        bk * WIDE_COLS * 2), 1024)
        return STAGES * stage + 1024, WIDE_COLS // 2 + bk // 2 + bk // 4
    bk = 32 if d > 128 else 64
    smem = SM90_ROWS * d * 2 + STAGES * 2 * bk * d * 2 + 1024
    return smem, d // 2 + bk // 2 + bk // 4     # O, S, T(P)


def dq_sm90(d):
    if d > 256 and wide_cluster("dq", "bf16", d) > 1:
        # the CTA's 64 rows of Q's and dO's slices, K and V slices of 32
        # keys in each of the 4 stages, two buffers of the partial S and
        # dP; dQ of 128 columns, S, dP and the next tile's partial, T(dS)
        bk = 32
        smem = (2 * 64 * WIDE_COLS * 2 + RING * 2 * bk * WIDE_COLS * 2
                + 2 * 2 * PART + 1024)
        return smem, WIDE_COLS // 4 + 3 * (bk // 2) + bk // 4
    if d > 256:     # Q, dO, K and V chunks, or K's slice, a stage
        bk = 32
        stage = _up(max(2 * SM90_ROWS * CHUNK * 2 + 2 * bk * CHUNK * 2,
                        bk * WIDE_COLS * 2), 1024)
        return STAGES * stage + 1024, WIDE_COLS // 2 + bk + bk // 4
    bk = 32 if d > 128 else 64
    smem = 2 * SM90_ROWS * d * 2 + STAGES * 2 * bk * d * 2 + 1024
    return smem, d // 2 + bk + bk // 4          # dQ, S and dP, T(dS)


def dkv_sm90(d):
    bq = 64 if d == 64 else 32
    if d > 256 and wide_cluster("dkv", "bf16", d) > 1:
        # K's and V's slices, Q and dO slices of 32 rows in each of the
        # 4 stages with their lse and delta, two buffers of the partial
        # S^T and dP^T; dK and dV, S^T, dP^T and the next tile's partial,
        # T(P), T(dS)
        stage = 2 * bq * WIDE_COLS * 2 + 2 * bq * 4
        smem = 2 * 64 * WIDE_COLS * 2 + RING * stage + 2 * 2 * PART + 1024
        return smem, WIDE_COLS // 2 + 3 * (bq // 2) + bq // 2
    if d > 256:     # K, V, Q and dO chunks, or Q's and dO's slices, a stage
        stage = _up(max(2 * 64 * CHUNK * 2 + 2 * bq * CHUNK * 2,
                        2 * bq * WIDE_COLS * 2 + 2 * bq * 4), 1024)
        return STAGES * stage + 1024, WIDE_COLS // 2 + bq + bq // 2
    rows = 64 if d > 128 else SM90_ROWS
    cols = d // 2 if d > 128 else d
    stage = _up(2 * bq * d * 2 + 2 * bq * 4, 1024)
    smem = 2 * rows * d * 2 + STAGES * stage + 1024
    # dK and dV, S and dP, T(P), T(dS)
    return smem, cols + bq + bq // 2


F32_THREADS, F32_GROUP, F32_PAD, F32_STAGES = 256, 128, 4, 2  # kF32*


def f32_tiles(kind, d):
    """The f32 forward, dq and dk/dv kernels' tiles up to D = 256
    (``FwdF32Tiles``, ``DqF32Tiles``, ``DkvF32Tiles``): rows a CTA and
    rows a ring stage."""
    if kind == "fwd":
        return 128 if d == 128 else 64, (64 if d == 64 else 32)
    if kind == "dq":
        return (128 if d == 64 else 32 if d > 128 else 64,
                32 if d > 128 else 64)
    return 32 if d > 128 else 64, (64 if d == 64 else 32)


def f32_fwd_row_threads(d):
    """``kTn``: the threads of one row in the f32 forward's layout (one
    warp holds 32 / kTn rows); 16 in the wide forward."""
    return 8 if d == 128 else 16


# FwdWideF32: 64 query rows, 64-key tiles, 3 ring stages
WIDE_F32_ROWS, WIDE_F32_BK, WIDE_F32_STAGES = 64, 64, 3
# DqWideF32 and DkvWideF32: 64 query rows (32 keys) a CTA, 32-key
# (query) tiles, 2 ring stages, 64-column chunks
WIDE_F32_DQ, WIDE_F32_DKV, WIDE_F32_STAGES_BWD = (64, 32), (32, 32), 2


def _f32_wide_bwd(kind, d):
    """Shared memory of the f32 dq or dk/dv past 256 (``DqWideF32``,
    ``DkvWideF32``): a ring whose stages hold the larger of a score tile's
    64-column chunks of Q, dO, K and V and a gradient item (K's slice; Q's
    and dO's slices), this CTA's exchanged tiles of two steps (dS; P^T
    and dS^T), and a work area for the score tile's products or, in a
    cluster, every rank's exchanged tiles of a step."""
    r = (lambda n: _up(4 * n, 128))
    rows, tile = WIDE_F32_DQ if kind == "dq" else WIDE_F32_DKV
    ranks = MAX_CLUSTER if wide_cluster(kind, "f32", d) > 1 else 1
    sl = WIDE_COLS + F32_PAD
    x = r(rows * (tile + F32_PAD))
    chunks = 2 * r(rows * (CHUNK + F32_PAD)) + 2 * r(tile * (CHUNK + F32_PAD))
    if kind == "dq":
        stage, exchanged = max(chunks, r(tile * sl)), 2 * x
        work = ranks * x if ranks > 1 else 2 * x
    else:
        stage, exchanged = max(chunks, 2 * r(tile * sl)), 4 * x
        work = ranks * 2 * x
    return WIDE_F32_STAGES_BWD * stage + exchanged + work


# the f32 kernels: the register-tiled forward, dq and dk/dv of
# flash_f32_sm90.cuh up to 256; past it the register-tiled wide forward
# (FwdWideF32), dq and dk/dv (DqWideF32, DkvWideF32)
def _f32_layout(d):
    r = (lambda n: _up(4 * n, 128))
    if d > 256:
        rows, bk, tn = WIDE_F32_ROWS, WIDE_F32_BK, f32_fwd_row_threads(d)
        stage = max(r(rows * (CHUNK + F32_PAD)) + r(bk * (CHUNK + F32_PAD)),
                    r(bk * (WIDE_COLS + F32_PAD)))
        return {"fwd": WIDE_F32_STAGES * stage + r(rows * (bk + tn)),
                "dq": _f32_wide_bwd("dq", d), "dkv": _f32_wide_bwd("dkv", d)}
    rows, bk = f32_tiles("fwd", d)
    fwd = (r(rows * (d + F32_PAD)) + F32_STAGES * 2 * r(bk * (d + F32_PAD))
           + r(rows * (bk + f32_fwd_row_threads(d))))
    rows, bk = f32_tiles("dq", d)
    dq = (2 * r(rows * (d + F32_PAD)) + F32_STAGES * 2 * r(bk * (d + F32_PAD))
          + r(rows * (bk + F32_PAD)))
    rows, bq = f32_tiles("dkv", d)
    stage = 2 * r(bq * (d + F32_PAD)) + 2 * r(bq)
    dkv = (2 * r(rows * (d + F32_PAD)) + F32_STAGES * stage
           + 2 * r(rows * (bq + F32_PAD)))
    return {"fwd": fwd, "dq": dq, "dkv": dkv}


def _f32_regs(kind, d):
    """f32 accumulators a thread holds: the forward's O and S over the
    CTA's 256 threads (past 256 the slice's O and S); dq's dQ, S and dP
    over the 256 threads, dk/dv's dV and S^T over one group of 128, dK and
    dP^T over the other (past 256 the slice's: each group dQ of half the
    rows and one partial product, or dV or dK and one partial)."""
    if kind == "fwd" and d > 256:
        return (WIDE_F32_ROWS * WIDE_COLS
                + WIDE_F32_ROWS * WIDE_F32_BK) // F32_THREADS
    if d > 256:
        rows, tile = WIDE_F32_DQ if kind == "dq" else WIDE_F32_DKV
        out = rows // 2 if kind == "dq" else rows
        return (out * WIDE_COLS + rows * tile) // F32_GROUP
    rows, tile = f32_tiles(kind, d)
    if kind == "fwd":
        return (rows * d + rows * tile) // F32_THREADS
    if kind == "dq":
        return (rows * d + 2 * rows * tile) // F32_THREADS
    return (rows * d + rows * tile) // F32_GROUP


TILES = {"fwd_sm90": fwd_sm90, "dq_sm90": dq_sm90, "dkv_sm90": dkv_sm90,
         **{f"{k}_f32": (lambda d, k=k: (_f32_layout(d)[k], _f32_regs(k, d)))
            for k in ("fwd", "dq", "dkv")}}

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
    "flash_wide.cuh": [
        "constexpr int kWideCols = 256;",
        "constexpr int kChunk = 64;",
        "constexpr int kMaxCluster = 8;",
        "constexpr int kRing = 4;",
        "constexpr uint32_t kPartBytes = 64 * 32 * 4;",
        "const bool cluster = (k16 || KIND != kFwd) && ns <= kMaxCluster;",
        # FwdCluster
        "static constexpr uint32_t kQ = kSm90Rows * kWideCols * 2;",
        "static constexpr uint32_t kKv = kBk * kWideCols * 2;",
        "static constexpr uint32_t kStage = 2 * kKv;",
        "static constexpr uint32_t kX = 2 * kPartBytes;",
        "static constexpr size_t kSmem = kQ + kRing * kStage + 2 * kX + "
        "1024;",
        # DkvCluster
        "static constexpr uint32_t kKv = kRows * kWideCols * 2;",
        "static constexpr uint32_t kQ = kBq * kWideCols * 2;",
        "static constexpr uint32_t kStage = 2 * kQ;",
        "static constexpr uint32_t kStat = 2 * kBq * 4;",
        "static constexpr size_t kSmem = 2 * kKv + kRing * (kStage + "
        "kStat) + 2 * kX + 1024;",
        # DqCluster
        "static constexpr uint32_t kQ = kRows * kWideCols * 2;",
        "static constexpr uint32_t kStage = 2 * kK;",
        "static constexpr size_t kSmem = 2 * kQ + kRing * kStage + 2 * kX + "
        "1024;",
        "tile = DqCluster::kRows;",
        # FwdWide and DqWide
        "static constexpr int kBk = 32;",
        "static constexpr uint32_t kQc = kSm90Rows * kChunk * 2;",
        "static constexpr uint32_t kV = kBk * kWideCols * 2;",
        "static constexpr uint32_t kStage = round1024(kQc + kKc > kV ? "
        "kQc + kKc : kV);",
        "static constexpr size_t kSmem = kStages * kStage + 1024;",
        "static constexpr uint32_t kK = kBk * kWideCols * 2;",
        "static constexpr uint32_t kStage = round1024(2 * kQc + 2 * kKc > "
        "kK ? 2 * kQc + 2 * kKc : kK);",
        # DkvWide
        "static constexpr int kRows = 64;",
        "static constexpr int kBq = 32;",
        "static constexpr uint32_t kSlice = 2 * kQs + 2 * kBq * 4;",
        "static constexpr uint32_t kStage = round1024(2 * kKc + 2 * kQc > "
        "kSlice ? 2 * kKc + 2 * kQc : kSlice);",
        # FwdWideF32 and its route
        "static constexpr int kBk = 64;",
        "static constexpr int kTn = 16;",
        "static constexpr int kStages = 3;",
        "static constexpr size_t kQc = round128(sizeof(float) * kRows * "
        "kLdc);",
        "static constexpr size_t kKc = round128(sizeof(float) * kBk * kLdc);",
        "static constexpr size_t kV = round128(sizeof(float) * kBk * kLdv);",
        "static constexpr size_t kStage = kQc + kKc > kV ? kQc + kKc : kV;",
        "static constexpr size_t kP = round128(sizeof(float) * kRows * kLdp);",
        "static constexpr size_t kSmem = kStages * kStage + kP;",
        "kern = flash_fwd_wide_f32_sm90<OT>; smem = FwdWideF32::kSmem; "
        "tile = FwdWideF32::kRows;",
        # DqWideF32, DkvWideF32 and their routes
        "static constexpr int kBk = 32; // keys a tile",
        "static constexpr int kRows = 32; // keys a CTA",
        "static constexpr int kBq = 32; // queries a tile",
        "static constexpr int kRows = 64; // query rows a CTA",
        "static constexpr int kStages = 2; // ring depth",
        "static constexpr int kCols = 64; // columns of a chunk",
        "static constexpr int kLdx = kBk + kF32Pad;",
        "static constexpr int kLdx = kBq + kF32Pad;",
        "static constexpr size_t kStage = 2 * kQc + 2 * kKc > kK ? 2 * kQc + "
        "2 * kKc : kK;",
        "static constexpr size_t kSmem = kStages * kStage + 2 * kX + "
        "(CLUSTER ? kMaxCluster : 2) * kX;",
        "static constexpr size_t kStage = 2 * kKc + 2 * kQc > 2 * kQ ? 2 * "
        "kKc + 2 * kQc : 2 * kQ;",
        "static constexpr size_t kSmem = kStages * kStage + 4 * kX + "
        "(CLUSTER ? kMaxCluster : 1) * 2 * kX;",
        "constexpr int SM = R / 16, SN = BK / 8;",
        "constexpr int QM = R / 8, NV = kWideCols / 128;",
        "float dq[QM][4 * NV];",
        "constexpr int SM = R / 16, SN = BQ / 8;",
        "constexpr int KM = R / 8, KTM = R / KM, KTN = kF32Group / KTM, "
        "NV = kWideCols / (4 * KTN);",
        "kern = flash_dq_cluster_f32_sm90<OT>; smem = DqWideF32<true>::kSmem;",
        "kern = flash_dq_wide_f32_sm90<OT>; smem = DqWideF32<false>::kSmem;",
        "tile = DqWideF32<true>::kRows;",
        "kern = flash_dkv_cluster_f32_sm90<OT>; smem = "
        "DkvWideF32<true>::kSmem;",
        "kern = flash_dkv_wide_f32_sm90<OT>; smem = DkvWideF32<false>::kSmem;",
        "tile = DkvWideF32<true>::kRows;",
        # the tile ranges the cluster's CTAs share
        "const int q0 = (gridDim.x / ns - 1 - blockIdx.x / ns) * R;",
        "const int k0 = blockIdx.x / ns * R;"],
    "flash_attention.cu": [
        "else if constexpr (KIND == kDq) "
        "return launch_dq_f32_sm90<OT, D>(a, stream);",
        "else if constexpr (KIND == kDkv) "
        "return launch_dkv_f32_sm90<OT, D>(a, stream); "
        "else return launch_fwd_f32_sm90<OT, D>(a, stream);",
        "else if (a->head_dim == 256) err = dispatch_types<KIND, 256>(*a, st);",
        "else if (a->head_dim > 256 && a->head_dim % kChunk == 0) "
        "err = dispatch_types<KIND, kWide>(*a, st);"],
    "flash_f32_sm90.cuh": [
        "constexpr int kF32Threads = 256;",
        "constexpr int kF32Group = 128;",
        "constexpr int kF32Pad = 4;",
        "constexpr int kF32Stages = 2;",
        # FwdF32Tiles
        "static constexpr int kRows = D == 128 ? 128 : 64;",
        "static constexpr int kBk = D == 64 ? 64 : 32;",
        "static constexpr int kTn = D == 128 ? 8 : 16;",
        "static constexpr int kLdp = kBk + kTn;",
        "static constexpr size_t kP = round128(sizeof(float) * kRows * kLdp);",
        "static constexpr size_t kSmem = kQ + kF32Stages * 2 * kK + kP;",
        "constexpr int RS = kF32Threads / TN, SM = R / RS, SN = BK / TN, "
        "NV = D / (4 * TN);",
        "float o[SM][4 * NV], m[SM], l[SM];",
        "return launch_sm90(flash_fwd_f32_sm90<OT, D>, FwdF32Tiles<D>::kSmem, "
        "a.tq, FwdF32Tiles<D>::kRows, a, stream);",
        # DqF32Tiles
        "static constexpr int kRows = D == 64 ? 128 : D > 128 ? 32 : 64;",
        "static constexpr int kBk = D > 128 ? 32 : 64;",
        "static constexpr size_t kSmem = 2 * kQ + kF32Stages * 2 * kK + kDs;",
        "constexpr int QTM = R / 4, QTN = kF32Threads / QTM, "
        "NV = D / (4 * QTN);",
        "float dq[4][4 * NV];",
        "constexpr int SM = R / 16, SN = BK / 16;",
        "float s[SM][SN], dp[SM][SN];",
        # DkvF32Tiles
        "static constexpr int kRows = D > 128 ? 32 : 64;",
        "static constexpr int kBq = D == 64 ? 64 : 32;",
        "static constexpr size_t kStage = 2 * kQ + 2 * kStat;",
        "static constexpr size_t kSmem = 2 * kKv + kF32Stages * kStage + "
        "2 * kP;",
        "constexpr int KM = R / 8, KTM = R / KM, KTN = kF32Group / KTM, "
        "NV = D / (4 * KTN);",
        "float acc[KM][4 * NV];",
        "constexpr int SM = R / 16, SN = BQ / 8;",
        "float x[SM][SN];",
        # the tile ranges (test_f32_tile_ranges_skip_only_masked_tiles)
        "const int q0 = (gridDim.x - 1 - blockIdx.x) * R;",
        "const int q_last = min(q0 + R, g.tq) - 1;",
        "g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1)) "
        ": g.tk;",
        "const int n_tiles = (k_end + BK - 1) / BK;",
        "const int k0 = blockIdx.x * R;",
        "g.causal ? max(0, k0 + g.k_offset - g.q_offset) / BQ * BQ : 0;",
        "const int n_tiles = q_begin < g.tq ? (g.tq - q_begin + BQ - 1) / BQ "
        ": 0;",
        "return launch_sm90(flash_dq_f32_sm90<OT, D>, DqF32Tiles<D>::kSmem, "
        "a.tq, DqF32Tiles<D>::kRows, a, stream);",
        "return launch_sm90(flash_dkv_f32_sm90<OT, D>, DkvF32Tiles<D>::kSmem, "
        "a.tk, DkvF32Tiles<D>::kRows, a, stream);"],
    "paged_decode.cu": [
        "if (D <= 128) return launch_s<QT, KVT, 128, QUANT>(D, c);",
        "if (D <= 256) return launch_s<QT, KVT, 256, QUANT>(D, c);",
        "return launch_s<QT, KVT, 256, QUANT, true>(D, c);",
        "D < 1 || (D + 255) / 256 > 65535 ||",
        "if (kv_dtype == 2) return launch_d<QT, int8_t, true>(D, c);",
        "if constexpr (!std::is_same<QT, bf16>::value) {",
        "if (kv_dtype == 3) return launch_d<QT, half, false>(D, c);",
        "if (kv_dtype == 0) return launch_d<QT, float, false>(D, c);",
        "if (kv_dtype == 1) return launch_d<QT, bf16, false>(D, c);"],
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_mirrored_formulas_are_the_sources(name):
    text = " ".join((CSRC / name).read_text().split())
    for line in PINNED[name]:
        assert " ".join(line.split()) in text, (name, line)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("kernel", sorted(TILES))
def test_every_instance_fits_a_cta(kernel, d):
    """Every instance fits a CTA; past 256 the wide kernels' shared
    memory and registers are the same at every D of one route (the
    clusters up to 2048, the unclustered kernels past it)."""
    smem, regs = TILES[kernel](d)
    assert smem <= SMEM_LIMIT, (kernel, d, smem)
    assert regs < REG_LIMIT, (kernel, d, regs)
    if d > 256:
        same_route = 2048 if d <= 2048 else 4096
        assert (smem, regs) == TILES[kernel](same_route), (kernel, d)


def test_d256_figures():
    """The sizes PERF.md and the sources quote for D = 256, and the f32
    forward, dq and dk/dv sizes ``flash_f32_sm90.cuh`` quotes at 64 and
    128."""
    assert [TILES[k](256)[0] for k in ("fwd_sm90", "dq_sm90", "dkv_sm90")] \
        == [164_864, 230_400, 167_936]
    assert _f32_layout(256) == {"fwd": 211_968, "dq": 204_288,
                                "dkv": 209_408}
    assert [TILES[k](256)[1] for k in ("fwd_f32", "dq_f32", "dkv_f32")] \
        == [72, 40, 72]
    # the f32 forward at 64 and 128: O and S a thread; at 64 two CTAs
    # share an SM's 228 KiB of shared memory
    assert [_f32_layout(d)["fwd"] for d in (64, 128)] == [107_520, 155_648]
    assert [TILES["fwd_f32"](d)[1] for d in (64, 128)] == [32, 80]
    assert 2 * (_f32_layout(64)["fwd"] + 1024) <= 228 * 1024
    # the f32 dq and dk/dv at 64 and 128 (flash_f32_sm90.cuh's header)
    assert [(_f32_layout(d)["dq"], _f32_layout(d)["dkv"]) for d in (64, 128)] \
        == [(174_080, 140_288), (220_160, 154_112)]
    assert [TILES[k](d)[1] for d in (64, 128) for k in ("dq_f32", "dkv_f32")] \
        == [96, 64, 64, 80]
    # 128-row tiles at D = 256 would not fit: why the tiles changed
    assert SM90_ROWS * 256 * 2 + STAGES * 2 * 64 * 256 * 2 + 1024 > SMEM_LIMIT
    assert 2 * (64 * 256 // 128) > REG_LIMIT      # dK + dV of 64 full rows


def _smoke_flash_cases():
    """``chip_smoke.py``'s ``FLASH_CASES`` (read, not imported)."""
    tree = ast.parse((CSRC.parents[1] / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "FLASH_CASES"):
            return ast.literal_eval(node.value)
    raise AssertionError("no FLASH_CASES in chip_smoke.py")


def f32_visited(kind, d, tq, tk, causal, q_offset, k_offset):
    """The (query, key) pairs the f32 forward, dq or dk/dv kernel visits at
    D <= 256, by the pinned tile-range lines of ``flash_f32_sm90.cuh``:
    the forward's and dq's CTA ``bx`` takes query rows from ``q0``,
    longest first, and key tiles up to ``k_end``; dk/dv's takes keys from
    ``k0`` and query tiles from ``q_begin``. Returns the visited mask and,
    for each CTA, the tiles of its row range it skips, as (query slice,
    key slice)."""
    rows, tile = f32_tiles(kind, d)
    visited = np.zeros((tq, tk), dtype=bool)
    skipped = []
    if kind in ("fwd", "dq"):
        grid = -(-tq // rows)
        for bx in range(grid):
            q0 = (grid - 1 - bx) * rows
            q_last = min(q0 + rows, tq) - 1
            k_end = (max(0, min(tk, q_offset + q_last - k_offset + 1))
                     if causal else tk)
            n_tiles = (k_end + tile - 1) // tile
            visited[q0:q0 + rows, :n_tiles * tile] = True
            skipped += [(slice(q0, q0 + rows), slice(t, t + tile))
                        for t in range(n_tiles * tile, tk, tile)]
    else:
        for bx in range(-(-tk // rows)):
            k0 = bx * rows
            q_begin = (max(0, k0 + k_offset - q_offset) // tile * tile
                       if causal else 0)
            n_tiles = (tq - q_begin + tile - 1) // tile if q_begin < tq else 0
            visited[q_begin:q_begin + n_tiles * tile, k0:k0 + rows] = True
            skipped += [(slice(t, t + tile), slice(k0, k0 + rows))
                        for t in range(0, min(q_begin, tq), tile)]
    return visited, skipped


@pytest.mark.parametrize("kind", ["dq", "dkv", "fwd"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", _smoke_flash_cases(), ids=lambda c: c[0])
def test_f32_tile_ranges_skip_only_masked_tiles(case, d, kind):
    """For every ``FLASH_CASES`` shape and offset the f32 kernels' tile
    ranges visit every visible (q, k) pair and skip only tiles in which
    no pair is visible, although dq's key tiles and dk/dv's query tiles
    differ in size from the CTA's own rows at some D (the forward's
    key tiles too)."""
    _, tq, tk, causal, q_offset, k_offset = case
    q_pos = q_offset + np.arange(tq)[:, None]
    k_pos = k_offset + np.arange(tk)[None, :]
    visible = q_pos >= k_pos if causal else np.ones((tq, tk), dtype=bool)
    visited, skipped = f32_visited(kind, d, tq, tk, causal, q_offset,
                                   k_offset)
    assert not (visible & ~visited).any()
    assert all(not visible[qs, ks].any() for qs, ks in skipped)
    if causal and q_offset + tq - 1 < k_offset:    # no row sees a key
        assert not visited.any()


def test_wide_figures():
    """The sizes PERF.md and ``flash_wide.cuh`` quote past 256 (the
    cluster kernels at 512, the unclustered ones at 2112), and why the
    D <= 256 tiles could not simply widen: at D = 512 a 128-row Q tile
    alone takes 131,072 B and three K/V stages of 32 keys 196,608 B, and
    the f32 dq's resident Q and dO with its ring of K and V would not
    fit."""
    assert [TILES[k](512) for k in ("fwd_sm90", "dq_sm90", "dkv_sm90")] \
        == [(230_400, 168), (230_400, 120), (231_424, 192)]
    assert [TILES[k](2112) for k in ("fwd_sm90", "dq_sm90", "dkv_sm90")] \
        == [(62_464, 152), (123_904, 168), (102_400, 176)]
    assert _f32_layout(512) == {"fwd": 220_160, "dq": 196_608,
                                "dkv": 225_280}
    assert TILES["fwd_f32"](512)[1] == 80   # the slice's O and S
    assert SM90_ROWS * 512 * 2 == 131_072
    assert STAGES * 2 * 32 * 512 * 2 == 196_608
    rows, bk = f32_tiles("dq", 256)         # DqF32Tiles<256> at D = 512
    assert (2 * _up(4 * rows * 516, 128)
            + F32_STAGES * 2 * _up(4 * bk * 516, 128)) > SMEM_LIMIT


def test_f32_wide_bwd_figures():
    """The sizes ``flash_wide.cuh`` quotes for the f32 dq and dk/dv past
    256: as clusters 196,608 and 225,280 B (the rings 104,448 and 133,120
    B, their own exchanged tiles of two steps 18,432 B each, eight ranks'
    tiles 73,728 B each), unclustered (past 2048) 141,312 and 160,768 B;
    dq's 64 rows hold twice the D = 256 kernel's accumulators a thread
    (80), dk/dv as many (72)."""
    assert [_f32_layout(d)["dq"] for d in (320, 2048, 2112, 4096)] \
        == [196_608, 196_608, 141_312, 141_312]
    assert [_f32_layout(d)["dkv"] for d in (320, 2048, 2112, 4096)] \
        == [225_280, 225_280, 160_768, 160_768]
    assert 2 * _up(4 * (2 * 64 + 2 * 32) * (CHUNK + F32_PAD), 128) \
        == 104_448
    assert 2 * 2 * _up(4 * 32 * (WIDE_COLS + F32_PAD), 128) == 133_120
    assert MAX_CLUSTER * _up(4 * 64 * (32 + F32_PAD), 128) == 73_728
    assert [TILES[k](d)[1] for k in ("dq_f32", "dkv_f32")
            for d in (512, 2112)] == [80, 80, 72, 72]
    assert [TILES[k](256)[1] for k in ("dq_f32", "dkv_f32")] == [40, 72]


def f32_cta_work(kind, d):
    """(rows a CTA, rows a tile, FMAs a CTA does a tile) of the f32 dq or
    dk/dv at head dim ``d``: the two score products reduce over all of
    ``d``, once a tile in a cluster, whose ``ns`` CTAs take every
    ``ns``-th tile each, and again in every unclustered slice; the
    gradient products (dQ; dV and dK) write the CTA's columns (all of
    ``d`` up to 256, past it a 256-column slice)."""
    if d <= 256:
        rows, tile = f32_tiles(kind, d)
        cols, sharing = d, 1
    else:
        rows, tile = WIDE_F32_DQ if kind == "dq" else WIDE_F32_DKV
        cols, sharing = WIDE_COLS, wide_cluster(kind, "f32", d)
    grads = 1 if kind == "dq" else 2
    return (rows, tile,
            2 * rows * tile * d // sharing + grads * rows * tile * cols)


@pytest.mark.parametrize("d", [512, 1024, 2048])
@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_f32_cluster_cta_does_the_d256_work(kind, d):
    """A CTA of the f32 dq or dk/dv cluster at D = 512 .. 2048 does the D
    = 256 kernel's FLOPs for each (query, key) pair of its tiles (it
    reduces the scores of every ns-th tile over all of D: the pinned step
    and chunk lines), with its tiles (dk/dv) or twice its rows (dq: 64
    rows a CTA, which ``kernel_variants.py`` found faster), so the launch
    at H = 2, D = 512 or H = 1, D = 1024 does the FLOPs of H = 4, D = 256
    on as many CTAs (dq: half as many); past 2048 the unclustered CTA
    repeats the score products over all of D."""
    def per_pair(k, dd):
        rows, tile, fmas = f32_cta_work(k, dd)
        return fmas / (rows * tile)

    assert per_pair(kind, d) == per_pair(kind, 256)
    assert f32_cta_work(kind, d)[:2] == (
        (64, 32) if kind == "dq" else f32_tiles(kind, 256))
    rows = f32_cta_work(kind, d)[0]
    ns = -(-d // WIDE_COLS)
    b, t, heads = 8, 2048, 1024 // d
    if heads:
        r256 = f32_tiles(kind, 256)[0]
        ctas = b * heads * -(-t // rows) * ns
        assert ctas * rows == b * 4 * -(-t // r256) * r256
    assert per_pair(kind, 2112) > per_pair(kind, 256)
    text = " ".join((CSRC / "flash_wide.cuh").read_text().split())
    for line in ("const int nr = CLUSTER ? ns : 1, rank = CLUSTER ? "
                 "cluster_rank() : 0;",
                 "auto n_score = [&](int s) { return rank < step_tiles(s) ? "
                 "nc : 0; };",
                 "mm_rows<SM, SN, KC, 16, 8, LDC, LDC, true>(",
                 "for (int c = 0; c < nc; ++c) {"):
        assert line in text, line


def test_dq_cluster_figures():
    """The cluster dq's layout (``DqCluster``): the CTA's 64 rows of Q and
    dO resident (65,536 B), a 4-stage ring of 32-key K and V slices
    (131,072 B) and two exchange buffers (32,768 B) make 230,400 B with
    the 1,024 B of alignment; keeping the D = 256 kernel's 128 rows with
    32-key tiles would not fit, while 128 rows with 16-key tiles (the
    fallback layout) would fill the same 230,400 B."""
    assert 2 * 64 * WIDE_COLS * 2 == 65_536
    assert RING * 2 * 32 * WIDE_COLS * 2 == 131_072
    assert 2 * 2 * PART == 32_768
    assert dq_sm90(512)[0] == 230_400 <= SMEM_LIMIT
    assert 2 * SM90_ROWS * WIDE_COLS * 2 + RING * 2 * 32 * WIDE_COLS * 2 \
        > SMEM_LIMIT
    assert (2 * SM90_ROWS * WIDE_COLS * 2 + RING * 2 * 16 * WIDE_COLS * 2
            + 2 * 2 * PART + 1024) == 230_400
    # one 128-column accumulator a warpgroup, against dk/dv's two
    assert dq_sm90(512)[1] == 120 < dkv_sm90(512)[1]


@pytest.mark.parametrize("d", [320, 512, 1024, 2048, 2112, 4096])
def test_cluster_rule_pinned_to_launch_wide(d):
    """``launch_wide``'s route (the pinned ``cluster`` line): ceil(D /
    256) slices; the 16-bit forward, dq and dk/dv run them as one
    cluster up to ``kMaxCluster`` (8), so D = 2112 (9 slices) takes the
    unclustered kernels; so do the f32 dq and dk/dv, while the f32
    forward never clusters."""
    ns = {320: 2, 512: 2, 1024: 4, 2048: 8, 2112: 9, 4096: 16}[d]
    want = ns if ns <= 8 else 1
    assert [wide_cluster(k, "bf16", d) for k in ("fwd", "dq", "dkv")] \
        == [want, want, want]
    assert [wide_cluster(k, "f16", d) for k in ("fwd", "dq", "dkv")] \
        == [want, want, want]
    assert [wide_cluster(k, "f32", d) for k in ("fwd", "dq", "dkv")] \
        == [1, want, want]
    text = " ".join((CSRC / "flash_wide.cuh").read_text().split())
    assert "return static_cast<int>((d + kWideCols - 1) / kWideCols);" \
        in text
    assert ("const bool cluster = (k16 || KIND != kFwd) && ns <= "
            "kMaxCluster;") in text \
        and f"constexpr int kMaxCluster = {MAX_CLUSTER};" in text


def test_head_dims_are_64_128_256():
    """The plan: one-tile kernels at 64, 128 and 256, every multiple of
    64 past 256 (``kernel_head_dim`` pads up to them), and no head-dim
    limit in the paged kernel."""
    assert tfa._HEAD_DIMS == (64, 128, 256) and tfa._WIDE_STEP == CHUNK
    assert not hasattr(tpk, "_MAX_HEAD_DIM")
    assert [tfa.kernel_head_dim(d) for d in (257, 320, 384, 512, 1024)] \
        == [320, 320, 384, 512, 1024]


@pytest.mark.parametrize("d", [256, 257, 512, 1024])
def test_flash_kernel_args_take_256_and_refuse_257(d):
    """``_prepare`` fills the launch struct at the kernels' widths (256,
    512, 1024); 257 is not one of them, so the wrappers pad it to 320
    (:func:`pad_head_dim`), which ``_prepare`` takes."""
    q = torch.zeros((1, 8, 2, d), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    width = tfa.kernel_head_dim(d)
    if d == 257:
        with pytest.raises(ValueError, match="head dim 257"):
            tfa._prepare(q, q, q, q, lse, lse)
        out, got_lse = tfa.pad_head_dim(tfa.flash_fwd_reference, q, q, q)
        assert out.shape == q.shape and got_lse.shape == (1, 2, 8)
        q = torch.zeros((1, 8, 2, width), dtype=torch.bfloat16)
    _, _, args = tfa._prepare(q, q, q, q, lse, lse)
    assert args.head_dim == width == (320 if d == 257 else d)


@pytest.mark.parametrize("d", [1, 160, 256, 257, 512, 1024])
@pytest.mark.parametrize("store", ["f32", "bf16", "int8", "f16"])
def test_paged_kernel_args_take_up_to_256(store, d):
    """``_check_args`` takes every head dim, and a float16 store read by
    float16 queries."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8, "f16": torch.float16}[store]
    b, h, n_blocks, bs = 2, 4, 5, 16
    q_dtype = torch.float16 if store == "f16" else torch.bfloat16
    q = torch.zeros((b, 1, h, d), dtype=q_dtype)
    kv = torch.zeros((n_blocks, bs, h, d), dtype=dtype)
    scales = {}
    if store == "int8":
        sc = torch.ones((n_blocks, bs, h))
        scales = dict(k_scale=sc, v_scale=sc)
    table = torch.zeros((b, 2), dtype=torch.int32)
    lengths = torch.tensor([3, 20], dtype=torch.int32)
    tpk._check_args(q, kv, kv, table, lengths, **scales)


@pytest.mark.parametrize("q_dtype,store,ok", [
    (torch.float16, torch.float16, True), (torch.float16, torch.int8, True),
    (torch.float16, torch.bfloat16, False),
    (torch.float16, torch.float32, False),
    (torch.bfloat16, torch.float16, False),
    (torch.float32, torch.float16, True),
    (torch.float64, torch.float32, False)])
def test_paged_kernel_args_pair_query_and_store_dtypes(q_dtype, store, ok):
    """The (query, store) dtype pairs the kernel is built for
    (``_PAIRS``, paged_decode.cu's ``launch_kv``): float32 queries read
    every store dtype, float16 queries float16 or int8 stores, bfloat16
    queries float32, bfloat16 or int8 stores. ``paged_attend`` runs the
    other float pairs with q widened to float32."""
    q = torch.zeros((1, 1, 2, 64), dtype=q_dtype)
    kv = torch.zeros((3, 4, 2, 64), dtype=store)
    scales = {}
    if store == torch.int8:
        sc = torch.ones((3, 4, 2))
        scales = dict(k_scale=sc, v_scale=sc)
    args = (q, kv, kv, torch.zeros((1, 2), dtype=torch.int32),
            torch.tensor([3], dtype=torch.int32))
    if ok:
        tpk._check_args(*args, **scales)
    else:
        with pytest.raises(ValueError, match="dtype"):
            tpk._check_args(*args, **scales)
