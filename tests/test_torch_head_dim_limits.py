"""The head dims and dtypes the port's kernels take on the card, checked
without one.

The four Hopper kernels run every head dim ``D``: the flash wrappers pad
``D`` up to 64, 128 or 256, and past 256 up to the next multiple of 64,
which the wide kernels (``csrc/flash_wide.cuh``) run as 256-column
slices of the output, one CTA each. The 16-bit forward and dk/dv run the
slices of a tile as one thread-block cluster up to the portable cluster
size (8 slices, D <= 2048), each CTA contracting the score products over
its own columns and summing the cluster's partials through distributed
shared memory; dq, the f32 kernels and wider D stream the products that
reduce over ``D`` in 64-column chunks. The paged kernel masks lanes past
``D`` up to 256 and splits wider outputs into 256-column slices too. The
paged kernel takes float16 queries over float16 and int8 stores beside
float32 and bfloat16 queries over float32, bfloat16 and int8 stores.
The wrappers' argument checks run on CPU tensors here.

The CUDA tile structs size each kernel's dynamic shared memory; their
formulas are mirrored below, pinned to the source lines they copy, and
every instance must fit the 232,448 B a CTA may use on an H100, with its
f32 accumulators inside the 255 registers a thread may hold. Past 256
neither grows with ``D`` along one route. ``nvcc`` checks the same limits with
``static_assert`` when it builds the card's library
(``csrc/flash_bwd_sm90.cuh``, ``csrc/flash_wide.cuh``,
``csrc/flash_attention.cu``).
"""

import importlib
from pathlib import Path

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
    cluster = dtype != "f32" and kind != "dq" and ns <= MAX_CLUSTER
    return ns if d > 256 and cluster else 1


# the 16-bit (wgmma) kernels: FwdTiles, DqTiles, DkvTiles up to 256,
# FwdCluster and DkvCluster past it up to the cluster limit, and FwdWide,
# DqWide, DkvWide past that (dq: past 256); 64-row f32 accumulators over a
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


# the f32 kernels: Layout<D> up to 256, WideLayout past it; scores and
# accumulators in shared memory
def _f32_layout(d):
    tile, pad = 32, 1
    r = (lambda n: _up(4 * n, 128))
    sc, p, st = r(tile * (tile + 4)), r(tile * (tile + pad)), r(tile)
    if d > 256:
        c, w, acc = (r(tile * (CHUNK + pad)), r(tile * (WIDE_COLS + pad)),
                     r(tile * (WIDE_COLS + 4)))
        return {"fwd": 2 * c + w + sc + p + acc + 2 * st,
                "dq": 4 * c + w + 2 * sc + p + acc + 2 * st,
                "dkv": 4 * c + 2 * w + 2 * sc + 2 * p + 2 * acc + 2 * st}
    t, acc = r(tile * (d + pad)), r(tile * (d + 4))
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
    "flash_wide.cuh": [
        "constexpr int kWideCols = 256;",
        "constexpr int kChunk = 64;",
        "constexpr int kMaxCluster = 8;",
        "constexpr int kRing = 4;",
        "constexpr uint32_t kPartBytes = 64 * 32 * 4;",
        "const bool cluster = k16 && KIND != kDq && ns <= kMaxCluster;",
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
        # WideLayout
        "static constexpr size_t kFwd = 2 * kChunkBytes + kSliceBytes + "
        "kScoreBytes + kPBytes + kAccBytes + 2 * kStatBytes;",
        "static constexpr size_t kDq = 4 * kChunkBytes + kSliceBytes + "
        "2 * kScoreBytes + kPBytes + kAccBytes + 2 * kStatBytes;",
        "static constexpr size_t kDkv = 4 * kChunkBytes + 2 * kSliceBytes + "
        "2 * kScoreBytes + 2 * kPBytes + 2 * kAccBytes + 2 * kStatBytes;"],
    "flash_attention.cu": [
        "constexpr int kTile = 32;",
        "constexpr int kPad = 1;",
        "static constexpr size_t kFwd = 3 * kTileBytes + kScoreBytes + "
        "kPBytes + kAccBytes + 2 * kStatBytes;",
        "static constexpr size_t kDkv = 4 * kTileBytes + 2 * kScoreBytes + "
        "2 * kPBytes + 2 * kAccBytes + 2 * kStatBytes;",
        "else if (a->head_dim == 256) err = dispatch_types<KIND, 256>(*a, st);",
        "else if (a->head_dim > 256 && a->head_dim % kChunk == 0) "
        "err = dispatch_types<KIND, kWide>(*a, st);"],
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
    """The sizes PERF.md and the sources quote for D = 256."""
    assert [TILES[k](256)[0] for k in ("fwd_sm90", "dq_sm90", "dkv_sm90")] \
        == [164_864, 230_400, 167_936]
    assert _f32_layout(256) == {"fwd": 141_056, "dq": 178_560,
                                "dkv": 216_064}
    # 128-row tiles at D = 256 would not fit: why the tiles changed
    assert SM90_ROWS * 256 * 2 + STAGES * 2 * 64 * 256 * 2 + 1024 > SMEM_LIMIT
    assert 2 * (64 * 256 // 128) > REG_LIMIT      # dK + dV of 64 full rows


def test_wide_figures():
    """The sizes PERF.md and ``flash_wide.cuh`` quote past 256 (the
    cluster kernels at 512, the unclustered ones at 2112), and why the
    D <= 256 tiles could not simply widen: at D = 512 a 128-row Q tile
    alone takes 131,072 B and three K/V stages of 32 keys 196,608 B, and
    the f32 dk/dv layout would not fit."""
    assert [TILES[k](512) for k in ("fwd_sm90", "dq_sm90", "dkv_sm90")] \
        == [(230_400, 168), (123_904, 168), (231_424, 192)]
    assert [TILES[k](2112) for k in ("fwd_sm90", "dq_sm90", "dkv_sm90")] \
        == [(62_464, 152), (123_904, 168), (102_400, 176)]
    assert _f32_layout(512) == {"fwd": 91_904, "dq": 113_152,
                                "dkv": 183_552}
    assert SM90_ROWS * 512 * 2 == 131_072
    assert STAGES * 2 * 32 * 512 * 2 == 196_608
    assert 4 * _up(4 * 32 * 513, 128) > SMEM_LIMIT  # f32 Layout<512> tiles


@pytest.mark.parametrize("d", [320, 512, 1024, 2048, 2112, 4096])
def test_cluster_rule_pinned_to_launch_wide(d):
    """``launch_wide``'s route (the pinned ``cluster`` line): ceil(D /
    256) slices; the 16-bit forward and dk/dv run them as one cluster up
    to ``kMaxCluster`` (8), so D = 2112 (9 slices) takes the unclustered
    kernels; dq and the f32 kernels never cluster."""
    ns = {320: 2, 512: 2, 1024: 4, 2048: 8, 2112: 9, 4096: 16}[d]
    want = ns if ns <= 8 else 1
    assert [wide_cluster(k, "bf16", d) for k in ("fwd", "dq", "dkv")] \
        == [want, 1, want]
    assert wide_cluster("fwd", "f16", d) == wide_cluster("dkv", "f16", d) \
        == want
    assert {wide_cluster(k, "f32", d) for k in ("fwd", "dq", "dkv")} == {1}
    text = " ".join((CSRC / "flash_wide.cuh").read_text().split())
    assert "return static_cast<int>((d + kWideCols - 1) / kWideCols);" \
        in text
    assert "const bool cluster = k16 && KIND != kDq && ns <= kMaxCluster;" \
        in text and f"constexpr int kMaxCluster = {MAX_CLUSTER};" in text


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
