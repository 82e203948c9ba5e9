// Flash forward, dq and dk/dv at head dims past 256: D any multiple of 64
// (the wrapper pads other widths up to the next one with zero lanes), in
// bf16/f16 (wgmma, *_wide_sm90) and f32 (plain FMA, *_wide_kernel).
//
// Included by flash_attention.cu inside its anonymous namespace, after
// flash_bwd_sm90.cuh and flash_fwd_sm90.cuh, whose PTX helpers, swizzled
// tiles, gemm_ss / gemm_rs, softmax_step, frag_row / frag_col and store2
// it uses, and after the f32 kernels' Carver, block_mm, load_stat and warp
// reductions. It includes nothing itself. The kernels compute the same
// functions under the same contract as the D <= 256 kernels
// (flash_attention.cu's header): the -1e30 sentinel, a masked p exactly 0,
// p and ds rounded to the operand's type, f32 softmax state and
// accumulators, every output written once with no atomics.
//
// Design: nothing a CTA holds grows with D.
//   - Output columns are split across CTAs. A CTA owns one slice of
//     kWideCols (256) columns of its output (O, dQ, or dK and dV): the
//     slices of a row tile sit next to each other on grid x (tile * ns +
//     slice, ns = ceil(D / 256)); the last slice of a D that is not a
//     multiple of 256 computes zero columns past D and does not write them.
//   - The 16-bit forward and dk/dv, for ns <= kMaxCluster (8, the portable
//     cluster size: D <= 2048), run the ns slices of a row (or key) tile as
//     one thread-block cluster (*_cluster_sm90, launched with
//     cudaLaunchKernelEx and a {ns, 1, 1} cluster; launch_wide checks at an
//     instance's first launch that such a cluster fits on the card and
//     returns the error if it does not). Each CTA loads only its own
//     256-column slice of every operand and keeps the D = 256 kernels'
//     tiles (flash_fwd_sm90.cuh / flash_bwd_sm90.cuh), but the products
//     that reduce over D (S = Q K^T, and dP = dO V^T in dk/dv) run over
//     the CTA's own columns into f32 registers, each CTA writes
//     that partial to its shared memory, and after a cluster barrier
//     every CTA reads all ns partials through distributed shared memory
//     (mapa + ld.shared::cluster) and adds them in rank order 0 .. ns-1.
//     So every CTA of the cluster holds a bitwise-equal S (and dP), the
//     same m, l, P and dS, and the score work runs once in all.
//   - The exchange is double-buffered with one cluster barrier a tile: a
//     CTA arrives (release) once it has read tile j - 1's partials and
//     written tile j's; in step j it issues tile j + 1's partial wgmma,
//     then waits (acquire) for tile j's partials. A buffer is rewritten
//     only after the barrier that every peer reached after reading it.
//     The last step issues one more partial product on a stale stage and
//     drops it, so no branch sits around an in-flight wgmma; a final wait
//     keeps a CTA from leaving while a peer still reads its partials.
//     Every loop bound, and the early return of the last z-slice's spare
//     CTAs, depends only on what the cluster's CTAs share (the row tile
//     and bh), so every CTA meets every barrier.
//   - The tensor cores stay busy across the exchange: in step j the
//     previous tile's output product (P V, or dK and dV) and the next
//     tile's partial run while tile j's partials are read and its softmax
//     (P^T and dS^T) runs; the step waits for the partial (wgmma_wait<1>)
//     and then for the product, so no wgmma is in flight across the
//     loop's back edge (ptxas would serialise them). A tile's stage is
//     read one step after its partial, so the rings hold kRing = 4
//     stages: the product's, the current tile's, the next partial's and
//     the one loading. A step issues its copies only after its CTA
//     barrier, which every thread reaches past its wait for the previous
//     step's products, so no copy lands on a stage a wgmma still reads.
//   - Forward: the 128 x 256 Q slice resident (65,536 B), K and V slices
//     of 32 keys through the ring, each warpgroup's 64 x 32 partial S a
//     buffer (2 x 16,384 B); 230,400 B. dk/dv: the 64 x 256 K and V slices
//     resident, Q and dO slices of 32 rows through the ring (lse and
//     delta beside it); warpgroup 0 contracts the partial S^T = K Q^T
//     while warpgroup 1 contracts dP^T = V dO^T (no product is repeated,
//     unlike the D = 256 kernel's), each sums its own product over the
//     cluster and hands the sum to the other through shared memory, so
//     each reads a peer's partials once; 231,424 B. Each warpgroup then
//     holds dK and dV of 128 of the slice's columns, as at D = 256. That
//     is 255 registers a thread with no spill: the operand pointers are
//     rebuilt in the loader, and lse and delta are read after the
//     exchange, so neither holds registers across it.
//   - Past D = 2048, and for dq (flash_dq_wide_sm90) at every wide D, the
//     first wide kernels run: every CTA of a row tile recomputes the
//     tile's scores, streaming the operands that reduce over D through
//     shared memory in kChunk-column (64) chunks into the same f32
//     accumulators, then applies P (or dS) to its own columns of V, K, or
//     Q and dO. The score products run ns times (at D = 512, 5/3x dq's
//     FLOPs). They keep the D <= 256 kernels' two consumer warpgroups,
//     128 query rows (forward, dq) or 64 keys (dk/dv), the 3-stage
//     cp.async ring walking "items" (for each tile of the other sequence,
//     the D / 64 chunks, then the slice's operand of the output product),
//     and 32-key tiles: 64-key tiles would add 24 registers to the
//     forward's 128-register O and spill.
//   - The f32 kernels keep the D <= 256 f32 kernels' 32-row tiles, 4
//     warps and shared-memory products, with the same chunking and
//     slicing; one CTA an SM is what their shared memory allows anyway,
//     and saying so (__launch_bounds__(kThreads, 1)) lets the compiler
//     keep the chunk loops' pointers and strides in registers.

#pragma once

constexpr int kWideCols = 256;  // output columns a CTA owns
constexpr int kChunk = 64;      // columns of a reduction chunk

__host__ __device__ __forceinline__ int wide_slices(int64_t d) {
  return static_cast<int>((d + kWideCols - 1) / kWideCols);
}

__host__ __device__ constexpr uint32_t round1024(uint32_t bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

// The grid of a wide kernel: flash_grid's, with the ns column slices of
// each row tile beside each other on x.
inline dim3 wide_grid(int64_t rows, int tile, const FlashArgs& a) {
  dim3 grid = flash_grid(rows, tile, a);
  grid.x *= wide_slices(a.head_dim);
  return grid;
}

// Rows row0 .. row0+R-1, columns col0 .. col0+W-1 of one (batch, head)
// slice of a [B, T, H, D] 16-bit input into a swizzled [R, W] tile, zero
// past n_rows and at or past n_cols, issued as cp.async by the whole CTA.
template <int R, int W, typename T>
__device__ __forceinline__ void load_cols(uint32_t dst, const T* src,
                                          int64_t st, int row0, int n_rows,
                                          int col0, int n_cols) {
  constexpr int kPieces = W / 8;
  static_assert(R * kPieces % kSm90Threads == 0, "tile / thread mismatch");
#pragma unroll
  for (int j = 0; j < R * kPieces / kSm90Threads; ++j) {
    const int i = threadIdx.x + j * kSm90Threads;
    const int r = i / kPieces, c = i % kPieces, t = row0 + r;
    const int col = col0 + c * 8;
    const bool ok = t < n_rows && col < n_cols;
    cp_async16(dst + swz<R>(r, c), ok ? src + t * st + col : src, ok);
  }
}

// ---------------------------------------------------- cluster exchange --

constexpr int kMaxCluster = 8;  // the portable cluster size: D <= 2048

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every CTA of the cluster arrives once and waits once a
// phase. Arrive orders this thread's earlier shared-memory reads and
// writes before the phase's end; wait orders its later accesses, peers'
// included, after it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A 64 x 32 f32 accumulator fragment of a warpgroup (16 floats a thread)
// in an exchange tile of 8,192 B: float4 j of the warpgroup's thread lt at
// (j * 128 + lt) * 16, so a quarter warp's 16-byte accesses are
// consecutive.
constexpr uint32_t kPartBytes = 64 * 32 * 4;

__device__ __forceinline__ void put_part(uint32_t tile, const float (&p)[16]) {
  const uint32_t lt = threadIdx.x % 128;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     tile + (j * 128 + lt) * 16),
                 "f"(p[4 * j]), "f"(p[4 * j + 1]), "f"(p[4 * j + 2]),
                 "f"(p[4 * j + 3])
                 : "memory");
}

// st[c] = the f32 row statistic at `stats` of the c-th of the 8 columns
// a thread's 32-column accumulator fragment holds (frag_col(i) for i =
// c / 2 * 4 + c % 2), read in program order.
__device__ __forceinline__ void stats_of_cols(float (&st)[8], uint32_t stats) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(st[c])
                 : "r"(stats + 4 * (c / 2 * 8 + 2 * (threadIdx.x % 4) + c % 2))
                 : "memory");
}

// x = the exchange tile at `tile` (an offset in this CTA's shared memory)
// of the cluster's CTA `rank`, read through distributed shared memory.
__device__ __forceinline__ void load_part(float (&x)[16], uint32_t tile,
                                          int rank) {
  const uint32_t lt = threadIdx.x % 128;
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(peer)
               : "r"(tile), "r"(rank));
#pragma unroll
  for (int j = 0; j < 4; ++j)
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x[4 * j]), "=f"(x[4 * j + 1]), "=f"(x[4 * j + 2]),
                   "=f"(x[4 * j + 3])
                 : "r"(peer + (j * 128 + lt) * 16)
                 : "memory");
}

// s = the sum of the exchange tiles at `tile` in the cluster's ns CTAs,
// added in rank order 0 .. ns-1 in every CTA, so every CTA gets the same
// bits. NB = 2: rank r + 1's tile is in flight while rank r's is added
// (16 more registers).
template <int NB>
__device__ __forceinline__ void sum_parts(float (&s)[16], uint32_t tile,
                                          int ns) {
  float x[NB][16];
  load_part(x[0], tile, 0);
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r < ns) {
      if (NB == 1 && r > 0) load_part(x[0], tile, r);
      if (NB == 2 && r + 1 < ns) load_part(x[(r + 1) % NB], tile, r + 1);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        s[i] = r == 0 ? x[r % NB][i] : s[i] + x[r % NB][i];
    }
  }
}

// The cluster kernels run a tile's output product in the next tile's loop
// step, so their rings hold one stage more than kStages.
constexpr int kRing = 4;

struct FwdCluster {
  static constexpr int kBk = 32;                             // keys a tile
  static constexpr uint32_t kQ = kSm90Rows * kWideCols * 2;  // Q's slice
  static constexpr uint32_t kKv = kBk * kWideCols * 2;  // K's or V's slice
  static constexpr uint32_t kStage = 2 * kKv;
  static constexpr uint32_t kX = 2 * kPartBytes;  // a buffer: both wgs' S
  static constexpr size_t kSmem = kQ + kRing * kStage + 2 * kX + 1024;
  static_assert(kSmem <= kSmemLimit, "cluster forward exceeds shared memory");
};

template <typename T, typename OT>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_fwd_cluster_sm90(const FlashArgs a) {
  using L = FwdCluster;
  constexpr int BK = L::kBk, NO = kWideCols / 2;  // O's floats a thread
  extern __shared__ __align__(128) unsigned char smem90[];
  const uint32_t qs = (smem_addr(smem90) + 1023) & ~1023u, ring = qs + L::kQ,
                 xch = ring + kRing * L::kStage;

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  // the last z-slice's spare CTAs: bh is the cluster's, so all its CTAs
  // leave and none waits for a peer at a cluster barrier
  if (bh >= a.batch * a.heads) return;
  const int ns = wide_slices(D), col0 = cluster_rank() * kWideCols;
  const int q0 = (gridDim.x / ns - 1 - blockIdx.x / ns) * kSm90Rows;
  const int wg = threadIdx.x / 128, qw0 = q0 + wg * 64;
  const float sl2 = static_cast<float>(a.scale) * kLog2e;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  // the row tile's key tiles, the same in every CTA of the cluster; a
  // warpgroup whose rows see fewer keys computes the rest masked (p = 0,
  // m and l unchanged, O times 1 plus 0: the same bits)
  const int q_last = min(q0 + kSm90Rows, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto stage = [&](int it) { return ring + (it % kRing) * L::kStage; };
  auto part = [&](int it) { return xch + (it % 2) * L::kX + wg * kPartBytes; };
  auto load_stage = [&](int it) {
    load_cols<BK, kWideCols>(stage(it), kb, a.k_st, it * BK, g.tk, col0, D);
    load_cols<BK, kWideCols>(stage(it) + L::kKv, vb, a.v_st, it * BK, g.tk,
                             col0, D);
  };

  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, corr[2];
  float o[NO], s[BK / 2], sn[BK / 2];  // sn: the next tile's partial S
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  uint32_t pa[BK / 16][4];  // T(P) of the tile whose P V is next
  // The loads and the next tile's partial S of step it. Tile it + 2 goes
  // to tile it - 2's stage, whose P V both warpgroups issued in step
  // it - 1: the copies start only after the CTA barrier, which every
  // thread reaches past that step's wgmma_wait<0>. Past the last tile the
  // partial runs on a stale stage and is dropped.
  auto begin_step = [&](int it) {
    cp_async_wait<0>();  // this thread's copies of tile it + 1
    fence_async_smem();
    __syncthreads();     // everyone's, and every wgmma of step it - 1 done
    if (it + 2 < n_tiles) load_stage(it + 2);
    cp_async_commit();
    wgmma_fence();
    gemm_ss<T, kSm90Rows, BK, kWideCols / 16>(sn, qs, wg * 64,
                                              stage(it + 1));
    wgmma_commit();
  };
  // Tile it's scores: every CTA's partial S summed, then the softmax.
  auto scores = [&](int it) {
    cluster_wait();  // every CTA's partial S of tile it is in place
    sum_parts<2>(s, part(it), ns);
    softmax_step<BK>(s, m, l, corr, g, qw0, it * BK, sl2);
  };
  // Tile it + 1's partial S, once it lands, for the peers.
  auto end_step = [&](int it) {
    reg_fence(sn);
    if (it + 1 < n_tiles) put_part(part(it + 1), sn);
    cluster_arrive();  // read tile it's partials, wrote tile it + 1's
  };
  if (n_tiles > 0) {
    // tile 0's partial S, then tile 0's step without a P V
    load_cols<kSm90Rows, kWideCols>(qs, qb, a.q_st, q0, g.tq, col0, D);
    load_stage(0);
    cp_async_commit();
    if (n_tiles > 1) load_stage(1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
    gemm_ss<T, kSm90Rows, BK, kWideCols / 16>(sn, qs, wg * 64, stage(0));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sn);
    put_part(part(0), sn);
    cluster_arrive();
    begin_step(0);
    scores(0);
    wgmma_wait<0>();
    end_step(0);
    to_a_frags<T, BK / 16>(pa, s);  // p rounded to v's type
  }
  // step it: tile it - 1's P V and tile it + 1's partial S run while tile
  // it's partials are summed and its softmax runs
  for (int it = 1; it < n_tiles; ++it) {
    begin_step(it);
    gemm_rs<T, BK, BK / 16>(o, pa, stage(it - 1) + L::kKv);  // O += T(P) V
    wgmma_commit();
    scores(it);
    wgmma_wait<1>();  // tile it + 1's partial S
    end_step(it);
    wgmma_wait<0>();  // tile it - 1's P V
    reg_fence(o);
    reg_fence(pa);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i / 2) % 2];
    to_a_frags<T, BK / 16>(pa, s);
  }
  if (n_tiles > 0) {  // the last tile's P V
    wgmma_fence();
    gemm_rs<T, BK, BK / 16>(o, pa, stage(n_tiles - 1) + L::kKv);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    cluster_wait();  // no peer reads this CTA's partials now
  }
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
  }
  OT* out = static_cast<OT*>(a.out);
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int qi = qw0 + frag_row(i), col = col0 + frag_col(i);
    if (qi >= g.tq || col >= D) continue;
    const float li = l[(i / 2) % 2] == 0.f ? 1.f : l[(i / 2) % 2];
    const int64_t off =
        ((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + col;
    store2(out + off, o[i] / li, o[i + 1] / li);
  }
  if (col0 == 0 && threadIdx.x % 4 == 0) {  // slice 0 writes lse
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = qw0 + frag_row(2 * e);
      if (qi < g.tq)
        a.lse_out[static_cast<int64_t>(bh) * g.tq + qi] =
            l[e] == 0.f ? kNegBig : m[e] * kLn2 + logf(l[e]);
    }
  }
}

// ----------------------------------- 16-bit dk/dv, a cluster of slices --

struct DkvCluster {
  static constexpr int kRows = 64;                          // keys a CTA
  static constexpr int kBq = 32;                            // rows a tile
  static constexpr uint32_t kKv = kRows * kWideCols * 2;   // K's or V's slice
  static constexpr uint32_t kQ = kBq * kWideCols * 2;      // Q's or dO's slice
  static constexpr uint32_t kStage = 2 * kQ;
  static constexpr uint32_t kStat = 2 * kBq * 4;           // lse and delta
  static constexpr uint32_t kX = 2 * kPartBytes;  // a buffer: S^T and dP^T
  static constexpr size_t kSmem =
      2 * kKv + kRing * (kStage + kStat) + 2 * kX + 1024;
  static_assert(kSmem <= kSmemLimit, "cluster dk/dv exceeds shared memory");
};

template <typename T, typename OT>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dkv_cluster_sm90(const FlashArgs a) {
  using L = DkvCluster;
  constexpr int BQ = L::kBq, NC = kWideCols / 2;  // dK/dV columns a wg
  extern __shared__ __align__(128) unsigned char smem90[];
  const uint32_t raw = smem_addr(smem90);
  const uint32_t ks = (raw + 1023) & ~1023u, vs = ks + L::kKv,
                 ring = vs + L::kKv, stats = ring + kRing * L::kStage,
                 xch = stats + kRing * L::kStat;

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // as the forward's: the cluster's
  const int ns = wide_slices(D), col0 = cluster_rank() * kWideCols;
  const int k0 = blockIdx.x / ns * L::kRows;  // low keys: most causal work
  const int wg = threadIdx.x / 128;
  // the warpgroup's dK/dV columns c0 .. c0 + NC - 1 of the slice (their
  // panels' offset in a Q/dO slice tile); warpgroup 0 contracts the
  // partial S^T = K Q^T, warpgroup 1 the partial dP^T = V dO^T
  const int c0 = wg * NC;
  const uint32_t c_off = (c0 / 64) * BQ * 128;
  const uint32_t a_tile = wg == 0 ? ks : vs, b_off = wg == 0 ? 0 : L::kQ;
  const float scale = static_cast<float>(a.scale), sl2 = scale * kLog2e;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  // causal: query rows before the first that sees key k0 see none of them;
  // a tile of rows that all miss the keys (a ragged edge) computes p = 0
  const int q_begin =
      g.causal ? max(0, k0 + g.k_offset - g.q_offset) / BQ * BQ : 0;
  const int n_tiles = q_begin < g.tq ? (g.tq - q_begin + BQ - 1) / BQ : 0;
  auto stage = [&](int it) { return ring + (it % kRing) * L::kStage; };
  auto stat = [&](int it) { return stats + (it % kRing) * L::kStat; };
  auto xbuf = [&](int it) { return xch + (it % 2) * L::kX; };
  // (the operands' pointers made here from the arguments, not kept in
  // registers across the loop)
  auto load_stage = [&](int it) {
    const int q0 = q_begin + it * BQ;
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
    const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;
    load_cols<BQ, kWideCols>(stage(it), qb, a.q_st, q0, g.tq, col0, D);
    load_cols<BQ, kWideCols>(stage(it) + L::kQ, dob, a.do_st, q0, g.tq, col0,
                             D);
    load_stat_async<BQ>(stat(it), lse, q0, g.tq);
    load_stat_async<BQ>(stat(it) + 4 * BQ, delta, q0, g.tq);
  };

  float dk[NC / 2], dv[NC / 2], s[BQ / 2], dp[BQ / 2], pn[BQ / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // of the tile whose dK, dV next
  // The loads and the next tile's partial of step it, ordered as the
  // forward's: tile it + 2's copies into tile it - 2's stage start after
  // the CTA barrier that follows every thread's wait for step it - 1's
  // dK and dV products on that stage.
  auto begin_step = [&](int it) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (it + 2 < n_tiles) load_stage(it + 2);
    cp_async_commit();
    wgmma_fence();
    gemm_ss<T, L::kRows, BQ, kWideCols / 16>(pn, a_tile, 0,
                                             stage(it + 1) + b_off);
    wgmma_commit();
  };
  // Tile it's P^T and dS^T. Each warpgroup sums its own product's
  // partials over the cluster and hands the sum to the other through
  // tile it + 1's buffer, which no peer reads before this CTA's next
  // arrive; each thread later overwrites only the slot it read there.
  auto scores = [&](int it) {
    const int q0 = q_begin + it * BQ;
    cluster_wait();  // every CTA's partial S^T and dP^T of tile it
    float own[BQ / 2];
    sum_parts<1>(own, xbuf(it) + wg * kPartBytes, ns);
    put_part(xbuf(it + 1) + (1 - wg) * kPartBytes, own);
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) s[i] = own[i];
      load_part(dp, xbuf(it + 1), cluster_rank());
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) dp[i] = own[i];
      load_part(s, xbuf(it + 1) + kPartBytes, cluster_rank());
    }
    const bool interior = q0 + BQ <= g.tq && k0 + 64 <= g.tk &&
                          (!g.causal || g.q_offset + q0 >= g.k_offset +
                                                               k0 + 63);
    // the 8 columns' lse and delta, read only now (not hoisted above the
    // exchange, where the registers are scarce)
    float st[BQ / 4];
    stats_of_cols(st, stat(it));
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i)
      s[i] = exp2f(fmaf(s[i], sl2, -st[i / 4 * 2 + i % 2] * kLog2e));
    // masked p is exactly 0, also when lse is the -1e30 sentinel
    if (!interior) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        if (!g.visible(q0 + frag_col(i), k0 + frag_row(i))) s[i] = 0.f;
    }
    stats_of_cols(st, stat(it) + 4 * BQ);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i)
      dp[i] = s[i] * (dp[i] - st[i / 4 * 2 + i % 2]);
  };
  auto end_step = [&](int it) {
    reg_fence(pn);
    if (it + 1 < n_tiles) put_part(xbuf(it + 1) + wg * kPartBytes, pn);
    cluster_arrive();
  };
  // dV += T(P^T) dO and dK += T(dS^T) Q on tile it's stage
  auto products = [&](int it) {
    const uint32_t qst = stage(it), dost = qst + L::kQ;
    gemm_rs<T, BQ, BQ / 16>(dv, pa, dost + c_off);
    gemm_rs<T, BQ, BQ / 16>(dk, da, qst + c_off);
    wgmma_commit();
  };
  if (n_tiles > 0) {
    // tile 0's partials, then tile 0's step without products
    load_cols<L::kRows, kWideCols>(ks, kb, a.k_st, k0, g.tk, col0, D);
    load_cols<L::kRows, kWideCols>(vs, vb, a.v_st, k0, g.tk, col0, D);
    load_stage(0);
    cp_async_commit();
    if (n_tiles > 1) load_stage(1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
    gemm_ss<T, L::kRows, BQ, kWideCols / 16>(pn, a_tile, 0, stage(0) + b_off);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(pn);
    put_part(xbuf(0) + wg * kPartBytes, pn);
    cluster_arrive();
    begin_step(0);
    scores(0);
    wgmma_wait<0>();
    end_step(0);
    to_a_frags<T, BQ / 16>(pa, s);   // p rounded to do's type
    to_a_frags<T, BQ / 16>(da, dp);  // ds rounded to q's type
  }
  // step it: tile it - 1's dK and dV products and tile it + 1's partial
  // run while tile it's partials are summed and P^T and dS^T computed
  for (int it = 1; it < n_tiles; ++it) {
    begin_step(it);
    products(it - 1);
    scores(it);
    wgmma_wait<1>();  // tile it + 1's partial
    end_step(it);
    wgmma_wait<0>();  // tile it - 1's products
    reg_fence(dk);
    reg_fence(dv);
    reg_fence(pa);
    reg_fence(da);
    to_a_frags<T, BQ / 16>(pa, s);
    to_a_frags<T, BQ / 16>(da, dp);
  }
  if (n_tiles > 0) {  // the last tile's products
    wgmma_fence();
    products(n_tiles - 1);
    wgmma_wait<0>();
    reg_fence(dk);
    reg_fence(dv);
    cluster_wait();
  }
  cp_async_wait<0>();

  OT* dkp = static_cast<OT*>(a.dk);
  OT* dvp = static_cast<OT*>(a.dv);
#pragma unroll
  for (int i = 0; i < NC / 2; i += 2) {
    const int kj = k0 + frag_row(i), col = col0 + c0 + frag_col(i);
    if (kj >= g.tk || col >= D) continue;
    const int64_t o =
        ((static_cast<int64_t>(b) * g.tk + kj) * H + h) * D + col;
    store2(dkp + o, dk[i] * scale, dk[i + 1] * scale);
    store2(dvp + o, dv[i], dv[i + 1]);
  }
}

// ------------------------------------------------- 16-bit forward (wide) --

struct FwdWide {
  static constexpr int kBk = 32;                          // keys a tile
  static constexpr uint32_t kQc = kSm90Rows * kChunk * 2;  // a Q chunk
  static constexpr uint32_t kKc = kBk * kChunk * 2;        // a K chunk
  static constexpr uint32_t kV = kBk * kWideCols * 2;      // V's slice
  static constexpr uint32_t kStage =
      round1024(kQc + kKc > kV ? kQc + kKc : kV);
  static constexpr size_t kSmem = kStages * kStage + 1024;
  static_assert(kSmem <= kSmemLimit, "wide forward exceeds shared memory");
};

template <typename T, typename OT>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_fwd_wide_sm90(const FlashArgs a) {
  using L = FwdWide;
  constexpr int BK = L::kBk;
  extern __shared__ __align__(128) unsigned char smem90[];
  const uint32_t ring = (smem_addr(smem90) + 1023) & ~1023u;

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int ns = wide_slices(D), nc = D / kChunk, n_parts = nc + 1;
  const int tile = blockIdx.x / ns, col0 = (blockIdx.x % ns) * kWideCols;
  const int q0 = (gridDim.x / ns - 1 - tile) * kSm90Rows;  // longest first
  const int wg = threadIdx.x / 128, qw0 = q0 + wg * 64;
  const float sl2 = static_cast<float>(a.scale) * kLog2e;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  const int q_last = min(q0 + kSm90Rows, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  // the key tiles this warpgroup's rows see: a prefix of the CTA's
  const int wg_end =
      g.causal ? g.q_offset + min(qw0 + 64, g.tq) - 1 - g.k_offset + 1
               : g.tk;
  const int n_act = qw0 >= g.tq || wg_end <= 0
                        ? 0
                        : min(n_tiles, (min(wg_end, g.tk) + BK - 1) / BK);
  const int n_items = n_tiles * n_parts;
  auto stage = [&](int it) { return ring + (it % kStages) * L::kStage; };
  // item it: key tile it / n_parts; part c < nc is chunk c of Q and K,
  // part nc is V's slice
  auto load_item = [&](int it) {
    const int j = it / n_parts, c = it % n_parts;
    if (c < nc) {
      load_cols<kSm90Rows, kChunk>(stage(it), qb, a.q_st, q0, g.tq,
                                   c * kChunk, D);
      load_cols<BK, kChunk>(stage(it) + L::kQc, kb, a.k_st, j * BK, g.tk,
                            c * kChunk, D);
    } else {
      load_cols<BK, kWideCols>(stage(it), vb, a.v_st, j * BK, g.tk, col0, D);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_items) load_item(s);
    cp_async_commit();
  }

  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, corr[2];
  float o[kWideCols / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < kWideCols / 2; ++i) o[i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    if (it + kStages - 1 < n_items) load_item(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of item it
    fence_async_smem();
    __syncthreads();               // everyone's
    const int j = it / n_parts, c = it % n_parts;
    if (j < n_act && c < nc) {     // S (+)= Q_c K_c^T
      wgmma_fence();
      gemm_ss<T, kSm90Rows, BK, kChunk / 16>(s, stage(it), wg * 64,
                                             stage(it) + L::kQc, c > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
    } else if (j < n_act) {        // the softmax, then O += T(P) V_slice
      softmax_step<BK>(s, m, l, corr, g, qw0, j * BK, sl2);
#pragma unroll
      for (int i = 0; i < kWideCols / 2; ++i) o[i] *= corr[(i / 2) % 2];
      uint32_t pa[BK / 16][4];
      to_a_frags<T, BK / 16>(pa, s);  // p rounded to v's type
      wgmma_fence();
      gemm_rs<T, BK, BK / 16>(o, pa, stage(it));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
    }
    __syncthreads();  // item it's stage is free for the copies of it + 3
  }
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
  }
  OT* out = static_cast<OT*>(a.out);
#pragma unroll
  for (int i = 0; i < kWideCols / 2; i += 2) {
    const int qi = qw0 + frag_row(i), col = col0 + frag_col(i);
    if (qi >= g.tq || col >= D) continue;
    const float li = l[(i / 2) % 2] == 0.f ? 1.f : l[(i / 2) % 2];
    const int64_t off =
        ((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + col;
    store2(out + off, o[i] / li, o[i + 1] / li);
  }
  if (col0 == 0 && threadIdx.x % 4 == 0) {  // slice 0 writes lse
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = qw0 + frag_row(2 * e);
      if (qi < g.tq)
        a.lse_out[static_cast<int64_t>(bh) * g.tq + qi] =
            l[e] == 0.f ? kNegBig : m[e] * kLn2 + logf(l[e]);
    }
  }
}

// ------------------------------------------------------ 16-bit dq (wide) --

struct DqWide {
  static constexpr int kBk = 32;                           // keys a tile
  static constexpr uint32_t kQc = kSm90Rows * kChunk * 2;  // Q or dO chunk
  static constexpr uint32_t kKc = kBk * kChunk * 2;        // K or V chunk
  static constexpr uint32_t kK = kBk * kWideCols * 2;      // K's slice
  static constexpr uint32_t kStage =
      round1024(2 * kQc + 2 * kKc > kK ? 2 * kQc + 2 * kKc : kK);
  static constexpr size_t kSmem = kStages * kStage + 1024;
  static_assert(kSmem <= kSmemLimit, "wide dq exceeds shared memory");
};

template <typename T, typename OT>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dq_wide_sm90(const FlashArgs a) {
  using L = DqWide;
  constexpr int BK = L::kBk;
  extern __shared__ __align__(128) unsigned char smem90[];
  const uint32_t ring = (smem_addr(smem90) + 1023) & ~1023u;

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int ns = wide_slices(D), nc = D / kChunk, n_parts = nc + 1;
  const int tile = blockIdx.x / ns, col0 = (blockIdx.x % ns) * kWideCols;
  const int q0 = (gridDim.x / ns - 1 - tile) * kSm90Rows;  // longest first
  const int wg = threadIdx.x / 128, qw0 = q0 + wg * 64;
  const float scale = static_cast<float>(a.scale), sl2 = scale * kLog2e;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;

  const int q_last = min(q0 + kSm90Rows, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  const int n_items = (k_end + BK - 1) / BK * n_parts;
  auto stage = [&](int it) { return ring + (it % kStages) * L::kStage; };
  // item it: key tile it / n_parts; part c < nc is chunk c of Q, dO, K and
  // V, part nc is K's slice
  auto load_item = [&](int it) {
    const int j = it / n_parts, c = it % n_parts;
    const uint32_t st = stage(it);
    if (c < nc) {
      load_cols<kSm90Rows, kChunk>(st, qb, a.q_st, q0, g.tq, c * kChunk, D);
      load_cols<kSm90Rows, kChunk>(st + L::kQc, dob, a.do_st, q0, g.tq,
                                   c * kChunk, D);
      load_cols<BK, kChunk>(st + 2 * L::kQc, kb, a.k_st, j * BK, g.tk,
                            c * kChunk, D);
      load_cols<BK, kChunk>(st + 2 * L::kQc + L::kKc, vb, a.v_st, j * BK,
                            g.tk, c * kChunk, D);
    } else {
      load_cols<BK, kWideCols>(st, kb, a.k_st, j * BK, g.tk, col0, D);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_items) load_item(s);
    cp_async_commit();
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qi = qw0 + frag_row(2 * e);
    lse2[e] = qi < g.tq ? lse[qi] * kLog2e : 0.f;
    dl[e] = qi < g.tq ? delta[qi] : 0.f;
  }

  float dq[kWideCols / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < kWideCols / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    if (it + kStages - 1 < n_items) load_item(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    fence_async_smem();
    __syncthreads();
    const int j = it / n_parts, c = it % n_parts, k0 = j * BK;
    const uint32_t st = stage(it);
    const bool active =
        qw0 < g.tq && (!g.causal || g.q_offset + min(qw0 + 64, g.tq) - 1 >=
                                        g.k_offset + k0);
    if (active && c < nc) {  // S (+)= Q_c K_c^T, dP (+)= dO_c V_c^T
      wgmma_fence();
      gemm_ss<T, kSm90Rows, BK, kChunk / 16>(s, st, wg * 64, st + 2 * L::kQc,
                                             c > 0);
      gemm_ss<T, kSm90Rows, BK, kChunk / 16>(dp, st + L::kQc, wg * 64,
                                             st + 2 * L::kQc + L::kKc, c > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
    } else if (active) {     // dS, then dQ += T(dS) K_slice
      const bool interior = qw0 + 64 <= g.tq && k0 + BK <= g.tk &&
                            (!g.causal || g.q_offset + qw0 >= g.k_offset +
                                                                  k0 + BK - 1);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] = exp2f(fmaf(s[i], sl2, -lse2[(i / 2) % 2]));
      if (!interior) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (!g.visible(qw0 + frag_row(i), k0 + frag_col(i))) s[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);
      uint32_t da[BK / 16][4];
      to_a_frags<T, BK / 16>(da, dp);  // ds rounded to k's type
      wgmma_fence();
      gemm_rs<T, BK, BK / 16>(dq, da, st);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq);
      reg_fence(da);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  OT* dqp = static_cast<OT*>(a.dq);
#pragma unroll
  for (int i = 0; i < kWideCols / 2; i += 2) {
    const int qi = qw0 + frag_row(i), col = col0 + frag_col(i);
    if (qi >= g.tq || col >= D) continue;
    const int64_t o =
        ((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + col;
    store2(dqp + o, dq[i] * scale, dq[i + 1] * scale);
  }
}

// ---------------------------------------------------- 16-bit dk/dv (wide) --

struct DkvWide {
  static constexpr int kRows = 64;                     // keys a CTA
  static constexpr int kBq = 32;                       // query rows a tile
  static constexpr uint32_t kKc = kRows * kChunk * 2;  // K or V chunk
  static constexpr uint32_t kQc = kBq * kChunk * 2;    // Q or dO chunk
  static constexpr uint32_t kQs = kBq * kWideCols * 2;  // Q's or dO's slice
  static constexpr uint32_t kSlice = 2 * kQs + 2 * kBq * 4;  // + lse, delta
  static constexpr uint32_t kStage =
      round1024(2 * kKc + 2 * kQc > kSlice ? 2 * kKc + 2 * kQc : kSlice);
  static constexpr size_t kSmem = kStages * kStage + 1024;
  static_assert(kSmem <= kSmemLimit, "wide dk/dv exceeds shared memory");
};

template <typename T, typename OT>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dkv_wide_sm90(const FlashArgs a) {
  using L = DkvWide;
  constexpr int BQ = L::kBq, NC = kWideCols / 2;  // dK/dV columns a wg
  extern __shared__ __align__(128) unsigned char smem90[];
  const uint32_t raw = smem_addr(smem90);
  const uint32_t ring = (raw + 1023) & ~1023u;

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int ns = wide_slices(D), nc = D / kChunk, n_parts = nc + 1;
  const int k0 = blockIdx.x / ns * L::kRows;  // low keys: most causal work
  const int col0 = (blockIdx.x % ns) * kWideCols;
  const int wg = threadIdx.x / 128;
  // the warpgroup's dK/dV columns c0 .. c0 + NC - 1 of the slice (their
  // panels' offset in a Q/dO slice tile)
  const int c0 = wg * NC;
  const uint32_t c_off = (c0 / 64) * BQ * 128;
  const float scale = static_cast<float>(a.scale), sl2 = scale * kLog2e;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;

  const int q_begin =
      g.causal ? max(0, k0 + g.k_offset - g.q_offset) / BQ * BQ : 0;
  const int n_tiles = q_begin < g.tq ? (g.tq - q_begin + BQ - 1) / BQ : 0;
  const int n_items = n_tiles * n_parts;
  auto stage = [&](int it) { return ring + (it % kStages) * L::kStage; };
  // item it: query tile it / n_parts; part c < nc is chunk c of K, V, Q and
  // dO, part nc is the slices of Q and dO with the tile's lse and delta
  auto load_item = [&](int it) {
    const int q0 = q_begin + it / n_parts * BQ, c = it % n_parts;
    const uint32_t st = stage(it);
    if (c < nc) {
      load_cols<L::kRows, kChunk>(st, kb, a.k_st, k0, g.tk, c * kChunk, D);
      load_cols<L::kRows, kChunk>(st + L::kKc, vb, a.v_st, k0, g.tk,
                                  c * kChunk, D);
      load_cols<BQ, kChunk>(st + 2 * L::kKc, qb, a.q_st, q0, g.tq,
                            c * kChunk, D);
      load_cols<BQ, kChunk>(st + 2 * L::kKc + L::kQc, dob, a.do_st, q0,
                            g.tq, c * kChunk, D);
    } else {
      load_cols<BQ, kWideCols>(st, qb, a.q_st, q0, g.tq, col0, D);
      load_cols<BQ, kWideCols>(st + L::kQs, dob, a.do_st, q0, g.tq, col0, D);
      load_stat_async<BQ>(st + 2 * L::kQs, lse, q0, g.tq);
      load_stat_async<BQ>(st + 2 * L::kQs + 4 * BQ, delta, q0, g.tq);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_items) load_item(s);
    cp_async_commit();
  }

  float dk[NC / 2], dv[NC / 2], s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    if (it + kStages - 1 < n_items) load_item(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    fence_async_smem();
    __syncthreads();
    const int q0 = q_begin + it / n_parts * BQ, c = it % n_parts;
    const uint32_t st = stage(it);
    // CTA-uniform: does any row of the tile see one of the keys?
    const bool active =
        k0 < g.tk && (!g.causal || g.q_offset + min(q0 + BQ, g.tq) - 1 >=
                                       g.k_offset + k0);
    if (active && c < nc) {  // S^T (+)= K_c Q_c^T, dP^T (+)= V_c dO_c^T
      wgmma_fence();
      gemm_ss<T, L::kRows, BQ, kChunk / 16>(s, st, 0, st + 2 * L::kKc,
                                            c > 0);
      gemm_ss<T, L::kRows, BQ, kChunk / 16>(
          dp, st + L::kKc, 0, st + 2 * L::kKc + L::kQc, c > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
    } else if (active) {  // P^T, dS^T; dV += T(P^T) dO, dK += T(dS^T) Q
      const float* lse_s =
          reinterpret_cast<const float*>(smem90 + (st + 2 * L::kQs - raw));
      const float* dl_s = lse_s + BQ;
      const bool interior = q0 + BQ <= g.tq && k0 + 64 <= g.tk &&
                            (!g.causal || g.q_offset + q0 >= g.k_offset +
                                                                 k0 + 63);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        s[i] = exp2f(fmaf(s[i], sl2, -lse_s[frag_col(i)] * kLog2e));
      if (!interior) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i)
          if (!g.visible(q0 + frag_col(i), k0 + frag_row(i))) s[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        dp[i] = s[i] * (dp[i] - dl_s[frag_col(i)]);
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_a_frags<T, BQ / 16>(pa, s);   // p rounded to do's type
      to_a_frags<T, BQ / 16>(da, dp);  // ds rounded to q's type
      wgmma_fence();
      gemm_rs<T, BQ, BQ / 16>(dv, pa, st + L::kQs + c_off);  // dV += P^T dO
      gemm_rs<T, BQ, BQ / 16>(dk, da, st + c_off);           // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
      reg_fence(pa);
      reg_fence(da);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  OT* dkp = static_cast<OT*>(a.dk);
  OT* dvp = static_cast<OT*>(a.dv);
#pragma unroll
  for (int i = 0; i < NC / 2; i += 2) {
    const int kj = k0 + frag_row(i), col = col0 + c0 + frag_col(i);
    if (kj >= g.tk || col >= D) continue;
    const int64_t o =
        ((static_cast<int64_t>(b) * g.tk + kj) * H + h) * D + col;
    store2(dkp + o, dk[i] * scale, dk[i + 1] * scale);
    store2(dvp + o, dv[i], dv[i + 1]);
  }
}

// ------------------------------------------------------ f32 kernels (wide) --

// Rows row0 .. row0+R-1, columns col0 .. col0+W-1 of one (batch, head)
// slice of a [B, T, H, D] f32 input into a shared tile of pitch W + kPad;
// zero past n_rows and at or past n_cols (D is a multiple of 64, so a
// 16-byte piece is all inside or all past it).
template <int W, int R>
__device__ __forceinline__ void load_rows_cols(float* dst, const float* src,
                                               int64_t st, int row0,
                                               int n_rows, int col0,
                                               int n_cols) {
  constexpr int kLd = W + kPad;
  constexpr int kPerRow = W / 4;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const int t = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < n_rows && col0 + c < n_cols)
      x = *reinterpret_cast<const float4*>(src + t * st + col0 + c);
    float* d = dst + r * kLd + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// Shared-memory pitches and sizes of the f32 wide kernels.
struct WideLayout {
  static constexpr int kB = kTile;               // rows of every tile
  static constexpr int kLdc = kChunk + kPad;     // reduction chunks
  static constexpr int kLdw = kWideCols + kPad;  // slice tiles
  static constexpr int kLds = kB + 4;            // scores
  static constexpr int kLdp = kB + kPad;         // p / ds
  static constexpr int kLdo = kWideCols + 4;     // accumulators
  static constexpr size_t kChunkBytes = round128(sizeof(float) * kB * kLdc);
  static constexpr size_t kSliceBytes = round128(sizeof(float) * kB * kLdw);
  static constexpr size_t kScoreBytes = round128(sizeof(float) * kB * kLds);
  static constexpr size_t kPBytes = round128(sizeof(float) * kB * kLdp);
  static constexpr size_t kAccBytes = round128(sizeof(float) * kB * kLdo);
  static constexpr size_t kStatBytes = round128(sizeof(float) * kB);
  static constexpr size_t kFwd = 2 * kChunkBytes + kSliceBytes +
                                 kScoreBytes + kPBytes + kAccBytes +
                                 2 * kStatBytes;
  static constexpr size_t kDq = 4 * kChunkBytes + kSliceBytes +
                                2 * kScoreBytes + kPBytes + kAccBytes +
                                2 * kStatBytes;
  static constexpr size_t kDkv = 4 * kChunkBytes + 2 * kSliceBytes +
                                 2 * kScoreBytes + 2 * kPBytes +
                                 2 * kAccBytes + 2 * kStatBytes;
  static_assert(kDkv <= 232448, "f32 wide dk/dv exceeds shared memory");
};

// S[B x B] += A B^T over all D columns, the operands streamed through two
// chunk tiles (rows ra0 of a, rows rb0 of b). The whole block calls it;
// it leaves synced.
template <int B>
__device__ __forceinline__ void scores_over_d(float* S, float* ta, float* tb,
                                              const float* a, int64_t sta,
                                              int ra0, int na,
                                              const float* b, int64_t stb,
                                              int rb0, int nb, int D) {
  using L = WideLayout;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    load_rows_cols<kChunk, B>(ta, a, sta, ra0, na, c0, D);
    load_rows_cols<kChunk, B>(tb, b, stb, rb0, nb, c0, D);
    __syncthreads();
    block_mm<B, B, kChunk, false, true, true>(ta, L::kLdc, tb, L::kLdc, S,
                                              L::kLds);
    __syncthreads();
  }
}

template <int B>
__device__ __forceinline__ void zero_tile(float* t, int ld) {
  for (int i = threadIdx.x; i < B * B; i += kThreads)
    t[(i / B) * ld + i % B] = 0.f;
}

template <typename OT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide_kernel(const FlashArgs a) {
  using L = WideLayout;
  constexpr int B = L::kB, W = kWideCols;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qc = cv.take<float>(B * L::kLdc);
  float* kc = cv.take<float>(B * L::kLdc);
  float* vs = cv.take<float>(B * L::kLdw);
  float* S = cv.take<float>(B * L::kLds);
  float* P = cv.take<float>(B * L::kLdp);
  float* O = cv.take<float>(B * L::kLdo);
  float* m_s = cv.take<float>(B);
  float* l_s = cv.take<float>(B);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int ns = wide_slices(D);
  const int q0 = (gridDim.x / ns - 1 - blockIdx.x / ns) * B;
  const int col0 = (blockIdx.x % ns) * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  for (int i = threadIdx.x; i < B * W; i += kThreads)
    O[(i / W) * L::kLdo + i % W] = 0.f;
  for (int r = threadIdx.x; r < B; r += kThreads) {
    m_s[r] = kNegBig;
    l_s[r] = 0.f;
  }
  const int q_last = min(q0 + B, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;

  for (int k0 = 0; k0 < k_end; k0 += B) {
    zero_tile<B>(S, L::kLds);
    __syncthreads();
    scores_over_d<B>(S, qc, kc, qb, a.q_st, q0, g.tq, kb, a.k_st, k0, g.tk,
                     D);
    load_rows_cols<W, B>(vs, vb, a.v_st, k0, g.tk, col0, D);
    for (int r = warp; r < B; r += kWarps) {  // as flash_fwd_kernel's
      const int qi = q0 + r;
      const float m_old = m_s[r];
      float s[B / 32];
      float mx = m_old;
#pragma unroll
      for (int c = 0; c < B / 32; ++c) {
        const int j = lane + 32 * c;
        const float x = S[r * L::kLds + j] * scale;
        s[c] = g.visible(qi, k0 + j) ? x : kNegBig;
        mx = fmaxf(mx, s[c]);
      }
      mx = warp_max(mx);
      float p_sum = 0.f;
#pragma unroll
      for (int c = 0; c < B / 32; ++c) {
        const float p = s[c] <= 0.5f * kNegBig ? 0.f : expf(s[c] - mx);
        p_sum += p;
        P[r * L::kLdp + lane + 32 * c] = p;
      }
      p_sum = warp_sum(p_sum);
      const float corr = expf(m_old - mx);
      for (int d = lane; d < W; d += 32) O[r * L::kLdo + d] *= corr;
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + p_sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();
    block_mm<B, W, B, false, false, true>(P, L::kLdp, vs, L::kLdw, O,
                                          L::kLdo);
    __syncthreads();
  }

  OT* out = static_cast<OT*>(a.out);
  for (int i = threadIdx.x; i < B * W; i += kThreads) {
    const int r = i / W, d = i % W, qi = q0 + r;
    if (qi >= g.tq || col0 + d >= D) continue;
    const float l = l_s[r];
    out[((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + col0 + d] =
        from_f32<OT>(O[r * L::kLdo + d] / (l == 0.f ? 1.f : l));
  }
  if (col0 == 0) {
    for (int r = threadIdx.x; r < B; r += kThreads) {
      const int qi = q0 + r;
      if (qi >= g.tq) continue;
      const float l = l_s[r];
      a.lse_out[static_cast<int64_t>(bh) * g.tq + qi] =
          l == 0.f ? kNegBig : m_s[r] + logf(l);
    }
  }
}

template <typename OT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_wide_kernel(const FlashArgs a) {
  using L = WideLayout;
  constexpr int B = L::kB, W = kWideCols;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qc = cv.take<float>(B * L::kLdc);
  float* doc = cv.take<float>(B * L::kLdc);
  float* kc = cv.take<float>(B * L::kLdc);
  float* vc = cv.take<float>(B * L::kLdc);
  float* ks = cv.take<float>(B * L::kLdw);
  float* S = cv.take<float>(B * L::kLds);
  float* dP = cv.take<float>(B * L::kLds);
  float* dS = cv.take<float>(B * L::kLdp);
  float* dQ = cv.take<float>(B * L::kLdo);
  float* lse_s = cv.take<float>(B);
  float* dl_s = cv.take<float>(B);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int ns = wide_slices(D);
  const int q0 = (gridDim.x / ns - 1 - blockIdx.x / ns) * B;
  const int col0 = (blockIdx.x % ns) * W;
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;

  load_stat<B>(lse_s, a.lse + static_cast<int64_t>(bh) * g.tq, q0, g.tq);
  load_stat<B>(dl_s, a.delta + static_cast<int64_t>(bh) * g.tq, q0, g.tq);
  for (int i = threadIdx.x; i < B * W; i += kThreads)
    dQ[(i / W) * L::kLdo + i % W] = 0.f;
  const int q_last = min(q0 + B, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;

  for (int k0 = 0; k0 < k_end; k0 += B) {
    zero_tile<B>(S, L::kLds);
    zero_tile<B>(dP, L::kLds);
    __syncthreads();
    scores_over_d<B>(S, qc, kc, qb, a.q_st, q0, g.tq, kb, a.k_st, k0, g.tk,
                     D);
    scores_over_d<B>(dP, doc, vc, dob, a.do_st, q0, g.tq, vb, a.v_st, k0,
                     g.tk, D);
    load_rows_cols<W, B>(ks, kb, a.k_st, k0, g.tk, col0, D);
    for (int i = threadIdx.x; i < B * B; i += kThreads) {
      const int r = i / B, j = i % B;
      const float s = S[r * L::kLds + j] * scale;
      const float p = g.visible(q0 + r, k0 + j) ? expf(s - lse_s[r]) : 0.f;
      dS[r * L::kLdp + j] = p * (dP[r * L::kLds + j] - dl_s[r]);
    }
    __syncthreads();
    block_mm<B, W, B, false, false, true>(dS, L::kLdp, ks, L::kLdw, dQ,
                                          L::kLdo);
    __syncthreads();
  }

  OT* dq = static_cast<OT*>(a.dq);
  for (int i = threadIdx.x; i < B * W; i += kThreads) {
    const int r = i / W, d = i % W, qi = q0 + r;
    if (qi >= g.tq || col0 + d >= D) continue;
    dq[((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + col0 + d] =
        from_f32<OT>(dQ[r * L::kLdo + d] * scale);
  }
}

template <typename OT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_wide_kernel(const FlashArgs a) {
  using L = WideLayout;
  constexpr int B = L::kB, W = kWideCols;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* kc = cv.take<float>(B * L::kLdc);
  float* vc = cv.take<float>(B * L::kLdc);
  float* qc = cv.take<float>(B * L::kLdc);
  float* doc = cv.take<float>(B * L::kLdc);
  float* qs = cv.take<float>(B * L::kLdw);
  float* dos = cv.take<float>(B * L::kLdw);
  float* S = cv.take<float>(B * L::kLds);
  float* dP = cv.take<float>(B * L::kLds);
  float* P = cv.take<float>(B * L::kLdp);
  float* dS = cv.take<float>(B * L::kLdp);
  float* dK = cv.take<float>(B * L::kLdo);
  float* dV = cv.take<float>(B * L::kLdo);
  float* lse_s = cv.take<float>(B);
  float* dl_s = cv.take<float>(B);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int ns = wide_slices(D);
  const int k0 = (gridDim.x / ns - 1 - blockIdx.x / ns) * B;
  const int col0 = (blockIdx.x % ns) * W;
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;

  for (int i = threadIdx.x; i < B * W; i += kThreads) {
    dK[(i / W) * L::kLdo + i % W] = 0.f;
    dV[(i / W) * L::kLdo + i % W] = 0.f;
  }
  const int q_begin =
      g.causal ? max(0, k0 + g.k_offset - g.q_offset) / B * B : 0;

  for (int q0 = q_begin; q0 < g.tq; q0 += B) {
    __syncthreads();  // the previous products are done with qs, dos, P, dS
    zero_tile<B>(S, L::kLds);
    zero_tile<B>(dP, L::kLds);
    load_stat<B>(lse_s, lse, q0, g.tq);
    load_stat<B>(dl_s, delta, q0, g.tq);
    __syncthreads();
    scores_over_d<B>(S, qc, kc, qb, a.q_st, q0, g.tq, kb, a.k_st, k0, g.tk,
                     D);
    scores_over_d<B>(dP, doc, vc, dob, a.do_st, q0, g.tq, vb, a.v_st, k0,
                     g.tk, D);
    load_rows_cols<W, B>(qs, qb, a.q_st, q0, g.tq, col0, D);
    load_rows_cols<W, B>(dos, dob, a.do_st, q0, g.tq, col0, D);
    for (int i = threadIdx.x; i < B * B; i += kThreads) {
      const int r = i / B, j = i % B;
      const float s = S[r * L::kLds + j] * scale;
      const float p = g.visible(q0 + r, k0 + j) ? expf(s - lse_s[r]) : 0.f;
      P[r * L::kLdp + j] = p;
      dS[r * L::kLdp + j] = p * (dP[r * L::kLds + j] - dl_s[r]);
    }
    __syncthreads();
    block_mm<B, W, B, true, false, true>(P, L::kLdp, dos, L::kLdw, dV,
                                         L::kLdo);
    block_mm<B, W, B, true, false, true>(dS, L::kLdp, qs, L::kLdw, dK,
                                         L::kLdo);
  }
  __syncthreads();

  OT* dk = static_cast<OT*>(a.dk);
  OT* dv = static_cast<OT*>(a.dv);
  for (int i = threadIdx.x; i < B * W; i += kThreads) {
    const int r = i / W, d = i % W, kj = k0 + r;
    if (kj >= g.tk || col0 + d >= D) continue;
    const int64_t o =
        ((static_cast<int64_t>(b) * g.tk + kj) * H + h) * D + col0 + d;
    dk[o] = from_f32<OT>(dK[r * L::kLdo + d] * scale);
    dv[o] = from_f32<OT>(dV[r * L::kLdo + d]);
  }
}

// ------------------------------------------------------------ launchers --

// The cluster size of the library's last successful launch (1: none);
// dispatch resets it, launch_cluster sets it once the launch went in.
int last_cluster = 1;

// Launches a cluster kernel with the ns slices of each tile as one
// cluster. fits[ns] records that the card can hold one such cluster at
// all (cudaOccupancyMaxActiveClusters, asked at the first launch of each
// size); when it cannot, the error goes back to the wrapper, which raises.
inline cudaError_t launch_cluster(void (*kern)(const FlashArgs), dim3 grid,
                                  size_t smem, int ns,
                                  bool (&fits)[kMaxCluster + 1],
                                  const FlashArgs& a, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ns);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSm90Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (!fits[ns]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidClusterSize;
    fits[ns] = true;
  }
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) last_cluster = ns;
  return err;
}

// The route is chosen by the input type and D alone: the 16-bit forward
// and dk/dv run as clusters while the slices fit a portable cluster
// (D <= 2048); dq, the f32 kernels and wider D take the first wide kernels.
template <int KIND, typename T, typename OT>
cudaError_t launch_wide(const FlashArgs& a, cudaStream_t stream) {
  constexpr bool k16 = !std::is_same<T, float>::value;
  static_assert(DkvCluster::kRows == DkvWide::kRows, "one dk/dv key tile");
  static bool fits[kMaxCluster + 1] = {};  // this instance's cluster sizes
  const int ns = wide_slices(a.head_dim);
  const bool cluster = k16 && KIND != kDq && ns <= kMaxCluster;
  void (*kern)(const FlashArgs);
  size_t smem;
  int tile, threads = k16 ? kSm90Threads : kThreads;
  const int64_t rows = KIND == kDkv ? a.tk : a.tq;  // dk/dv: key tiles
  if constexpr (k16 && KIND == kFwd) {
    kern = flash_fwd_wide_sm90<T, OT>;
    smem = FwdWide::kSmem;
    if (cluster) {
      kern = flash_fwd_cluster_sm90<T, OT>;
      smem = FwdCluster::kSmem;
    }
    tile = kSm90Rows;
  } else if constexpr (k16 && KIND == kDq) {
    kern = flash_dq_wide_sm90<T, OT>;
    smem = DqWide::kSmem;
    tile = kSm90Rows;
  } else if constexpr (k16) {
    kern = flash_dkv_wide_sm90<T, OT>;
    smem = DkvWide::kSmem;
    if (cluster) {
      kern = flash_dkv_cluster_sm90<T, OT>;
      smem = DkvCluster::kSmem;
    }
    tile = DkvWide::kRows;  // = DkvCluster::kRows
  } else if constexpr (KIND == kFwd) {
    kern = flash_fwd_wide_kernel<OT>;
    smem = WideLayout::kFwd;
    tile = kTile;
  } else if constexpr (KIND == kDq) {
    kern = flash_dq_wide_kernel<OT>;
    smem = WideLayout::kDq;
    tile = kTile;
  } else {
    kern = flash_dkv_wide_kernel<OT>;
    smem = WideLayout::kDkv;
    tile = kTile;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid = wide_grid(rows, tile, a);
  if (cluster) return launch_cluster(kern, grid, smem, ns, fits, a, stream);
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}
