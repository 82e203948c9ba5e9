// Flash forward, dq and dk/dv at head dims past 256: D any multiple of 64
// (the wrapper pads other widths up to the next one with zero lanes), in
// bf16/f16 (wgmma, *_cluster_sm90 and *_wide_sm90) and f32 (plain FMA:
// flash_fwd_wide_f32_sm90, flash_dq_cluster_f32_sm90 and
// flash_dkv_cluster_f32_sm90, and past D = 2048 flash_dq_wide_f32_sm90 and
// flash_dkv_wide_f32_sm90).
//
// Included by flash_attention.cu inside its anonymous namespace, after
// flash_bwd_sm90.cuh and flash_fwd_sm90.cuh, whose PTX helpers, swizzled
// tiles, gemm_ss / gemm_rs, softmax_step, frag_row / frag_col and store2
// it uses, and after the f32 kernels' Carver and flash_f32_sm90.cuh's
// register-tiled products, loaders and forward softmax. It includes
// nothing itself. The kernels compute the same
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
//   - The 16-bit kernels, for ns <= kMaxCluster (8, the portable cluster
//     size: D <= 2048), run the ns slices of a row (or key) tile as
//     one thread-block cluster (*_cluster_sm90, launched with
//     cudaLaunchKernelEx and a {ns, 1, 1} cluster; launch_wide checks at an
//     instance's first launch that such a cluster fits on the card and
//     returns the error if it does not). Each CTA loads only its own
//     256-column slice of every operand and keeps the D = 256 kernels'
//     tiles (flash_fwd_sm90.cuh / flash_bwd_sm90.cuh), but the products
//     that reduce over D (S = Q K^T, and dP = dO V^T in dq and dk/dv)
//     run over the CTA's own columns into f32 registers, each CTA writes
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
//     previous tile's output product (P V, dQ, or dK and dV) and the next
//     tile's partial run while tile j's partials are read and its softmax
//     (P and dS) runs; the step waits for the partial (wgmma_wait<1>)
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
//     exchange, so neither holds registers across it. dq mirrors dk/dv
//     with query rows for keys: the 64 x 256 Q and dO slices resident, K
//     and V slices of 32 keys through the ring; warpgroup 0 contracts the
//     partial S = Q K^T, warpgroup 1 dP = dO V^T, each sums its own over
//     the cluster and hands it to the other, and each holds dQ of the
//     CTA's 64 rows and 128 of the slice's columns (64 registers); lse
//     and delta of the fixed rows are read once; 230,400 B. (128 rows
//     with 32-key tiles would need 262,144 B before the exchange.)
//   - Past D = 2048 the first wide kernels run: every CTA of a row tile
//     recomputes the tile's scores, streaming the operands that reduce
//     over D through shared memory in kChunk-column (64) chunks into the
//     same f32 accumulators, then applies P (or dS) to its own columns of
//     V, K, or Q and dO. The score products run ns times (at D = 512,
//     5/3x dq's FLOPs). They keep the D <= 256 kernels' two consumer
//     warpgroups, 128 query rows (forward, dq) or 64 keys (dk/dv), the
//     3-stage cp.async ring walking "items" (for each tile of the other
//     sequence, the D / 64 chunks, then the slice's operand of the output
//     product), and 32-key tiles: 64-key tiles would add 24 registers to
//     the forward's 128-register O and spill.
//   - The f32 forward (flash_fwd_wide_f32_sm90, FwdWideF32) runs
//     flash_fwd_f32_sm90's register tiles on one slice: 64 query rows a
//     CTA, 64-key tiles, S reduced over D in register tiles from Q and K
//     chunks and V's slice streamed through a 3-stage cp.async ring, the
//     online softmax and the slice of O in registers (64 floats a thread);
//     220,160 B. It repeats the score product in every slice (at D = 512
//     1.5x the needed FLOPs, at 1024 2.5x).
//   - The f32 dq and dk/dv (DqWideF32, DkvWideF32) run flash_dq_f32_sm90's
//     and flash_dkv_f32_sm90's register tiles on one slice and, up to D =
//     2048, run a tile's slices as one cluster
//     like the 16-bit kernels, but share the score work by tiles, not by
//     columns: in step s the CTA of rank r reduces S and dP (S^T and dP^T)
//     of tile s ns + r of the other sequence over all of D, streaming
//     64-column chunks of the four operands through the ring, and forms
//     its dS (P^T and dS^T); after one cluster barrier every CTA copies
//     the step's tiles through distributed shared memory and applies them
//     to its slice (dQ += dS K; dV += P^T dO, dK += dS^T Q) in tile order.
//     Each score element is then one ascending FMA chain over D, the
//     order of the plain version's f32 products (partials over column
//     slices would differ from them by up to 2e-5 at D = 1024 and 2048);
//     dq 64 rows a CTA (196,608 B), dk/dv 32 keys (225,280 B), 32-key
//     (query) tiles, 2 ring stages. Past 2048 a CTA reduces every tile's
//     scores itself and repeats them in every slice.

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

// -------------------------------------- 16-bit dq, a cluster of slices --

struct DqCluster {
  static constexpr int kRows = 64;                          // rows a CTA
  static constexpr int kBk = 32;                            // keys a tile
  static constexpr uint32_t kQ = kRows * kWideCols * 2;    // Q's or dO's slice
  static constexpr uint32_t kK = kBk * kWideCols * 2;      // K's or V's slice
  static constexpr uint32_t kStage = 2 * kK;
  static constexpr uint32_t kX = 2 * kPartBytes;  // a buffer: S and dP
  static constexpr size_t kSmem = 2 * kQ + kRing * kStage + 2 * kX + 1024;
  static_assert(kSmem <= kSmemLimit, "cluster dq exceeds shared memory");
};

template <typename T, typename OT>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dq_cluster_sm90(const FlashArgs a) {
  using L = DqCluster;
  constexpr int BK = L::kBk, NC = kWideCols / 2;  // dQ columns a wg
  extern __shared__ __align__(128) unsigned char smem90[];
  const uint32_t qs = (smem_addr(smem90) + 1023) & ~1023u, dos = qs + L::kQ,
                 ring = dos + L::kQ, xch = ring + kRing * L::kStage;

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // as the forward's: the cluster's
  const int ns = wide_slices(D), col0 = cluster_rank() * kWideCols;
  const int q0 = (gridDim.x / ns - 1 - blockIdx.x / ns) * L::kRows;
  const int wg = threadIdx.x / 128;
  // both warpgroups own the CTA's 64 rows; warpgroup 0 contracts the
  // partial S = Q K^T, warpgroup 1 the partial dP = dO V^T, and each
  // holds dQ of the slice's columns c0 .. c0 + NC - 1 (their panels'
  // offset in a K slice tile)
  const int c0 = wg * NC;
  const uint32_t c_off = (c0 / 64) * BK * 128;
  const uint32_t a_tile = wg == 0 ? qs : dos, b_off = wg == 0 ? 0 : L::kK;
  const float scale = static_cast<float>(a.scale), sl2 = scale * kLog2e;

  // the row tile's key tiles, the same in every CTA of the cluster
  const int q_last = min(q0 + L::kRows, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto stage = [&](int it) { return ring + (it % kRing) * L::kStage; };
  auto xbuf = [&](int it) { return xch + (it % 2) * L::kX; };
  auto load_stage = [&](int it) {
    const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
    load_cols<BK, kWideCols>(stage(it), kb, a.k_st, it * BK, g.tk, col0, D);
    load_cols<BK, kWideCols>(stage(it) + L::kK, vb, a.v_st, it * BK, g.tk,
                             col0, D);
  };

  float dq[NC / 2], s[BK / 2], dp[BK / 2], pn[BK / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dq[i] = 0.f;
  uint32_t da[BK / 16][4];  // T(dS) of the tile whose dQ product is next
  float lse2[2], dl[2];     // this thread's two rows' statistics
  // The loads and the next tile's partial of step it, ordered as the
  // forward's: tile it + 2's copies into tile it - 2's stage start after
  // the CTA barrier that follows every thread's wait for step it - 1's
  // dQ product on that stage.
  auto begin_step = [&](int it) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (it + 2 < n_tiles) load_stage(it + 2);
    cp_async_commit();
    wgmma_fence();
    gemm_ss<T, L::kRows, BK, kWideCols / 16>(pn, a_tile, 0,
                                             stage(it + 1) + b_off);
    wgmma_commit();
  };
  // Tile it's P and dS. Each warpgroup sums its own product's partials
  // over the cluster and hands the sum to the other through tile it + 1's
  // buffer, as dk/dv's scores do.
  auto scores = [&](int it) {
    const int k0 = it * BK;
    cluster_wait();  // every CTA's partial S and dP of tile it
    float own[BK / 2];
    sum_parts<2>(own, xbuf(it) + wg * kPartBytes, ns);
    put_part(xbuf(it + 1) + (1 - wg) * kPartBytes, own);
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = own[i];
      load_part(dp, xbuf(it + 1), cluster_rank());
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dp[i] = own[i];
      load_part(s, xbuf(it + 1) + kPartBytes, cluster_rank());
    }
    const bool interior = q0 + L::kRows <= g.tq && k0 + BK <= g.tk &&
                          (!g.causal || g.q_offset + q0 >= g.k_offset +
                                                               k0 + BK - 1);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      s[i] = exp2f(fmaf(s[i], sl2, -lse2[(i / 2) % 2]));
    // masked p is exactly 0, also when lse is the -1e30 sentinel
    if (!interior) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (!g.visible(q0 + frag_row(i), k0 + frag_col(i))) s[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);
  };
  auto end_step = [&](int it) {
    reg_fence(pn);
    if (it + 1 < n_tiles) put_part(xbuf(it + 1) + wg * kPartBytes, pn);
    cluster_arrive();
  };
  // dQ += T(dS) K on tile it's stage (the warpgroup's columns of K)
  auto product = [&](int it) {
    gemm_rs<T, BK, BK / 16>(dq, da, stage(it) + c_off);
    wgmma_commit();
  };
  if (n_tiles > 0) {
    // tile 0's partials, then tile 0's step without a product
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    load_cols<L::kRows, kWideCols>(qs, qb, a.q_st, q0, g.tq, col0, D);
    load_cols<L::kRows, kWideCols>(dos, dob, a.do_st, q0, g.tq, col0, D);
    load_stage(0);
    cp_async_commit();
    if (n_tiles > 1) load_stage(1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
    gemm_ss<T, L::kRows, BK, kWideCols / 16>(pn, a_tile, 0, stage(0) + b_off);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(pn);
    put_part(xbuf(0) + wg * kPartBytes, pn);
    cluster_arrive();
    // lse and delta of the CTA's fixed rows, read once (0 past Tq)
    const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
    const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = q0 + frag_row(2 * e);
      lse2[e] = qi < g.tq ? lse[qi] * kLog2e : 0.f;
      dl[e] = qi < g.tq ? delta[qi] : 0.f;
    }
    begin_step(0);
    scores(0);
    wgmma_wait<0>();
    end_step(0);
    to_a_frags<T, BK / 16>(da, dp);  // ds rounded to k's type
  }
  // step it: tile it - 1's dQ product and tile it + 1's partial run while
  // tile it's partials are summed and its P and dS computed
  for (int it = 1; it < n_tiles; ++it) {
    begin_step(it);
    product(it - 1);
    scores(it);
    wgmma_wait<1>();  // tile it + 1's partial
    end_step(it);
    wgmma_wait<0>();  // tile it - 1's product
    reg_fence(dq);
    reg_fence(da);
    to_a_frags<T, BK / 16>(da, dp);
  }
  if (n_tiles > 0) {  // the last tile's product
    wgmma_fence();
    product(n_tiles - 1);
    wgmma_wait<0>();
    reg_fence(dq);
    cluster_wait();  // no peer reads this CTA's partials now
  }
  cp_async_wait<0>();

  OT* dqp = static_cast<OT*>(a.dq);
#pragma unroll
  for (int i = 0; i < NC / 2; i += 2) {
    const int qi = q0 + frag_row(i), col = col0 + c0 + frag_col(i);
    if (qi >= g.tq || col >= D) continue;
    const int64_t o =
        ((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + col;
    store2(dqp + o, dq[i] * scale, dq[i + 1] * scale);
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

// The f32 forward past 256: flash_fwd_f32_sm90's register tiles on one
// 256-column slice of O a CTA, unclustered. Q is not resident: S = Q K^T
// is reduced over D in kChunk-column chunks of Q and K that stream through
// a 3-stage cp.async ring of "items" (for each key tile, its D / 64
// chunks, then the tile's V slice), one CTA barrier an item, the copies of
// item i + 2 in flight while item i is computed. Every slice of a row tile
// repeats the score product (ns times the score FLOPs).
struct FwdWideF32 {
  static constexpr int kRows = 64;  // query rows a CTA
  static constexpr int kBk = 64;    // keys a tile
  static constexpr int kTn = 16;    // threads of a row
  static constexpr int kStages = 3;
  static constexpr int kLdc = kChunk + kF32Pad;     // Q and K chunks
  static constexpr int kLdv = kWideCols + kF32Pad;  // V slices
  static constexpr int kLdp = kBk + kTn;            // P rows
  static constexpr size_t kQc = round128(sizeof(float) * kRows * kLdc);
  static constexpr size_t kKc = round128(sizeof(float) * kBk * kLdc);
  static constexpr size_t kV = round128(sizeof(float) * kBk * kLdv);
  static constexpr size_t kStage = kQc + kKc > kV ? kQc + kKc : kV;
  static constexpr size_t kP = round128(sizeof(float) * kRows * kLdp);
  static constexpr size_t kSmem = kStages * kStage + kP;
  static_assert(kSmem <= kSmemLimit, "f32 wide forward exceeds shared memory");
};

template <typename OT>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_fwd_wide_f32_sm90(const FlashArgs a) {
  using L = FwdWideF32;
  constexpr int R = L::kRows, BK = L::kBk, TN = L::kTn, W = kWideCols,
                LDC = L::kLdc, LDP = L::kLdp, NS = L::kStages;
  constexpr int RS = kF32Threads / TN, SM = R / RS, SN = BK / TN,
                NV = W / (4 * TN);
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  // an item's stage: Q's chunk, K's kQcf floats on; or V's slice
  constexpr int kQcf = L::kQc / sizeof(float),
                kStage = L::kStage / sizeof(float);
  float* ring = cv.take<float>(NS * kStage);
  float* ps = cv.take<float>(R * LDP);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int ns = wide_slices(D), nc = D / kChunk;
  const int q0 = (gridDim.x / ns - 1 - blockIdx.x / ns) * R;  // longest first
  const int col0 = (blockIdx.x % ns) * W;
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  const int q_last = min(q0 + R, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  const int n_tiles = (k_end + BK - 1) / BK, n_items = n_tiles * (nc + 1);
  auto load_item = [&](int i) {
    float* st = ring + (i % NS) * kStage;
    const int k0 = i / (nc + 1) * BK, c = i % (nc + 1);
    if (c < nc) {
      load_cols_async<R, kChunk>(st, qb, a.q_st, q0, g.tq, c * kChunk, D);
      load_cols_async<BK, kChunk>(st + kQcf, kb, a.k_st, k0, g.tk,
                                  c * kChunk, D);
    } else {
      load_cols_async<BK, W>(st, vb, a.v_st, k0, g.tk, col0, D);
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_items) load_item(i);
    cp_async_commit();
  }
  int item = 0;
  // waits for item `item`, whose stage it returns; past the barrier every
  // warp is done with the item before it, whose stage takes item + 2
  auto next_item = [&]() -> const float* {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (item + NS - 1 < n_items) load_item(item + NS - 1);
    cp_async_commit();
    return ring + (item++ % NS) * kStage;
  };

  const int sr = threadIdx.x / TN, sc = threadIdx.x % TN;
  float o[SM][4 * NV], m[SM], l[SM];
#pragma unroll
  for (int u = 0; u < SM; ++u) {
    m[u] = kNegBig;
    l[u] = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * NV; ++i) o[u][i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    float s[SM][SN];
#pragma unroll
    for (int u = 0; u < SM; ++u)
#pragma unroll
      for (int v = 0; v < SN; ++v) s[u][v] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float* st = next_item();
      mm_rows<SM, SN, kChunk, RS, TN, LDC, LDC, true>(s, st + sr * LDC,
                                                      st + kQcf + sc * LDC);
    }
    const float* vt = next_item();
    const bool interior =
        q0 + R <= g.tq && k0 + BK <= g.tk &&
        (!g.causal || g.q_offset + q0 >= g.k_offset + k0 + BK - 1);
    fwd_softmax<TN, SM, SN, 4 * NV, LDP>(s, o, m, l, ps + sr * LDP + sc,
                                         interior, g, q0 + sr, k0 + sc,
                                         scale);
    mm_acc<SM, NV, BK, RS, 4 * TN, LDP, L::kLdv>(o, ps + sr * LDP,
                                                 vt + 4 * sc);
  }

  fwd_store<TN, SM, NV>(
      o, m, l,
      static_cast<OT*>(a.out) + (static_cast<int64_t>(b) * g.tq * H + h) * D +
          col0,
      static_cast<int64_t>(H) * D,
      col0 == 0 ? a.lse_out + static_cast<int64_t>(bh) * g.tq : nullptr,
      q0 + sr, g.tq, sc, D - col0);
}

// ----------------------------- f32 dq and dk/dv, a cluster of slices --

// flash_dq_f32_sm90's and flash_dkv_f32_sm90's register tiles on one
// 256-column slice of dQ (or dK and dV) a CTA. The score products (S = Q
// K^T and dP = dO V^T; S^T and dP^T for dk/dv) reduce over all of D in
// one ascending FMA chain an element, streamed in kCols-column chunks
// through the ring, so they give the bits of the plain version's
// f32 products (which sum in that order); partials over column slices
// summed afterwards would not (up to 2e-5 apart at D = 1024 and 2048).
// Up to kMaxCluster slices (D <= 2048) the ns CTAs of a row (or key) tile
// run as one thread-block cluster and share the score work: in step s the
// CTA of rank r reduces the scores of tile s ns + r of the other sequence
// alone (group 0 S or S^T, group 1 dP or dP^T; dq a 4 x 4 micro-tile a
// thread, dk/dv 2 x 4), forms its dS (and P^T) tile in its shared
// memory, and after one cluster barrier every CTA copies the step's ns
// tiles through distributed shared memory and applies them, in tile
// order, to its own slice. So the score work runs once in all, and every
// output is the unclustered kernel's to the bit. Past kMaxCluster
// (CLUSTER false) a CTA reduces every tile's scores itself: right, not
// fast (every slice repeats them).

// The float4 at shared offset `off` of the cluster's CTA `rank`.
__device__ __forceinline__ float4 ld_rank4(uint32_t off, int rank) {
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(peer)
               : "r"(off), "r"(rank));
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(peer)
               : "memory");
  return x;
}

// Tiles j < n of the cluster (its CTA j's tile at `src`, R x LD floats
// with the first W columns used) into dst + j * stride of this CTA: every
// rank's reads in flight before the first write.
template <int R, int W, int LD>
__device__ __forceinline__ void copy_ranks(float* dst, int stride,
                                           const float* src, int n) {
  constexpr int NQ = R * W / (4 * kF32Threads);
  static_assert(NQ * 4 * kF32Threads == R * W, "tile / thread mismatch");
  float4 y[kMaxCluster][NQ];
#pragma unroll
  for (int j = 0; j < kMaxCluster; ++j)
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int i = threadIdx.x + kF32Threads * u;
      const int off = i / (W / 4) * LD + 4 * (i % (W / 4));
      if (j < n) y[j][u] = ld_rank4(smem_addr(src + off), j);
    }
#pragma unroll
  for (int j = 0; j < kMaxCluster; ++j)
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int i = threadIdx.x + kF32Threads * u;
      const int off = i / (W / 4) * LD + 4 * (i % (W / 4));
      if (j < n) *reinterpret_cast<float4*>(dst + j * stride + off) = y[j][u];
    }
}

// A product group's micro-tiles of a score product, x[u][v] (rows sr +
// 16u, columns sc + 8v), into the tile at t (pitch LD).
template <int SM, int SN, int LD>
__device__ __forceinline__ void put_scores(float* t, const float (&x)[SM][SN],
                                           int sr, int sc) {
#pragma unroll
  for (int u = 0; u < SM; ++u)
#pragma unroll
    for (int v = 0; v < SN; ++v) t[(sr + 16 * u) * LD + sc + 8 * v] = x[u][v];
}

// The f32 dq past 256: the CTA's R query rows, BK-key tiles. A step's
// items: the D / kCols chunks of Q, dO, K and V of the CTA's own score
// tile (if it has one), then the K slices of the step's tiles.
template <bool CLUSTER>
struct DqWideF32 {
  static constexpr int kRows = 64;                  // query rows a CTA
  static constexpr int kBk = 32;                    // keys a tile
  static constexpr int kStages = 2;                 // ring depth
  static constexpr int kCols = 64;                  // columns of a chunk
  static constexpr int kLd = kWideCols + kF32Pad;   // slice rows
  static constexpr int kLdc = kCols + kF32Pad;      // chunk rows
  static constexpr int kLdx = kBk + kF32Pad;        // score tiles
  static constexpr size_t kK = round128(sizeof(float) * kBk * kLd);
  static constexpr size_t kQc = round128(sizeof(float) * kRows * kLdc);
  static constexpr size_t kKc = round128(sizeof(float) * kBk * kLdc);
  static constexpr size_t kX = round128(sizeof(float) * kRows * kLdx);
  static constexpr size_t kStage =
      2 * kQc + 2 * kKc > kK ? 2 * kQc + 2 * kKc : kK;
  // the ring, this CTA's dS of two steps, then S and dP of its score tile
  // or the step's dS tiles
  static constexpr size_t kSmem =
      kStages * kStage + 2 * kX + (CLUSTER ? kMaxCluster : 2) * kX;
  static_assert(kSmem <= kSmemLimit, "f32 wide dq exceeds shared memory");
};

template <typename OT, bool CLUSTER>
__device__ __forceinline__ void dq_wide_f32(const FlashArgs& a) {
  using L = DqWideF32<CLUSTER>;
  constexpr int R = L::kRows, BK = L::kBk, NS = L::kStages, KC = L::kCols,
                LD = L::kLd, LDC = L::kLdc, LDX = L::kLdx;
  // S (group 0) or dP (group 1): a 16 x 8 grid of the group's threads,
  // rows sr + 16u and keys sc + 8v
  constexpr int SM = R / 16, SN = BK / 8;
  // dS: NQ quads of 4 keys a thread
  constexpr int NQ = R * BK / (4 * kF32Threads);
  static_assert(NQ * 4 * kF32Threads == R * BK && R % 16 == 0 && BK % 8 == 0,
                "f32 wide dq tiles / threads mismatch");
  // dQ: the group's rows row0 + qr + 4u, columns qc + 128v + f
  constexpr int QM = R / 8, NV = kWideCols / 128;
  constexpr int kStagef = L::kStage / sizeof(float), kQcf = L::kQc / sizeof(float),
                kKcf = L::kKc / sizeof(float), kXf = L::kX / sizeof(float);
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* ring = cv.take<float>(NS * kStagef);
  float* own = cv.take<float>(2 * kXf);  // this CTA's dS, step s at s % 2
  float* work = cv.take<float>((CLUSTER ? kMaxCluster : 2) * kXf);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  // the last z-slice's spare CTAs: bh is the cluster's, so all its CTAs
  // leave and none waits for a peer at a cluster barrier
  if (bh >= a.batch * a.heads) return;
  const int ns = wide_slices(D), nc = (D + KC - 1) / KC;
  // the CTAs that share the score tiles, and this one's place among them
  const int nr = CLUSTER ? ns : 1, rank = CLUSTER ? cluster_rank() : 0;
  const int col0 = (blockIdx.x % ns) * kWideCols;
  const int q0 = (gridDim.x / ns - 1 - blockIdx.x / ns) * R;  // longest first
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;

  // the row tile's key tiles, the same in every CTA of the cluster; step
  // s takes tiles s nr .. s nr + nr - 1
  const int q_last = min(q0 + R, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  const int n_tiles = (k_end + BK - 1) / BK, n_steps = (n_tiles + nr - 1) / nr;
  auto step_tiles = [&](int s) { return min(nr, n_tiles - s * nr); };
  auto n_score = [&](int s) { return rank < step_tiles(s) ? nc : 0; };
  const int full = nc + nr;  // the items of every step but the last
  const int n_items =
      n_steps ? (n_steps - 1) * full + n_score(n_steps - 1) +
                    step_tiles(n_steps - 1)
              : 0;
  auto load_item = [&](int i) {
    float* st = ring + (i % NS) * kStagef;
    const int s = i / full, j = i - s * full, c = n_score(s);
    if (j < c) {  // chunk j of the score tile
      const int k0 = (s * nr + rank) * BK;
      load_cols_async<R, KC>(st, qb, a.q_st, q0, g.tq, j * KC, D);
      load_cols_async<R, KC>(st + kQcf, dob, a.do_st, q0, g.tq, j * KC, D);
      load_cols_async<BK, KC>(st + 2 * kQcf, kb, a.k_st, k0, g.tk, j * KC, D);
      load_cols_async<BK, KC>(st + 2 * kQcf + kKcf, vb, a.v_st, k0, g.tk,
                              j * KC, D);
    } else {  // K's slice of the step's tile j - c
      load_cols_async<BK, kWideCols>(st, kb, a.k_st, (s * nr + j - c) * BK,
                                     g.tk, col0, D);
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_items) load_item(i);
    cp_async_commit();
  }
  int item = 0;
  // waits for item `item`, whose stage it returns; past the CTA barrier
  // every warp is done with the item before it, whose stage takes the
  // copies of item + NS - 1
  auto next_item = [&]() -> const float* {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (item + NS - 1 < n_items) load_item(item + NS - 1);
    cp_async_commit();
    return ring + (item++ % NS) * kStagef;
  };

  const int grp = threadIdx.x / kF32Group, gt = threadIdx.x % kF32Group;
  const int sr = grid_row<16>(gt), sc = grid_col<16>(gt);
  const int row0 = grp * (R / 2), qr = gt / 32, qc = 4 * (gt % 32);
  const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;
  float lse_r[NQ], dl_r[NQ];  // the statistics of the thread's quads' rows
#pragma unroll
  for (int u = 0; u < NQ; ++u) {
    const int qi = q0 + (threadIdx.x + kF32Threads * u) / (BK / 4);
    lse_r[u] = qi < g.tq ? lse[qi] : 0.f;
    dl_r[u] = qi < g.tq ? delta[qi] : 0.f;
  }
  float dq[QM][4 * NV];
#pragma unroll
  for (int u = 0; u < QM; ++u)
#pragma unroll
    for (int i = 0; i < 4 * NV; ++i) dq[u][i] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    const int nt = step_tiles(s);
    float* ds_own = own + (s % 2) * kXf;
    if (rank < nt) {  // this CTA's score tile: S and dP over all of D
      const int k0 = (s * nr + rank) * BK;
      float x[SM][SN];
#pragma unroll
      for (int u = 0; u < SM; ++u)
#pragma unroll
        for (int v = 0; v < SN; ++v) x[u][v] = 0.f;
      for (int c = 0; c < nc; ++c) {
        const float* st = next_item();
        mm_rows<SM, SN, KC, 16, 8, LDC, LDC, true>(
            x, st + grp * kQcf + sr * LDC,
            st + 2 * kQcf + grp * kKcf + sc * LDC);
      }
      put_scores<SM, SN, LDX>(work + grp * kXf, x, sr, sc);
      __syncthreads();
      // dS = P (dP - delta), P = exp(S scale - lse)
      const bool interior =
          q0 + R <= g.tq && k0 + BK <= g.tk &&
          (!g.causal || g.q_offset + q0 >= g.k_offset + k0 + BK - 1);
#pragma unroll
      for (int u = 0; u < NQ; ++u) {
        const int i = threadIdx.x + kF32Threads * u, r = i / (BK / 4),
                  c = 4 * (i % (BK / 4));
        const float4 sv = *reinterpret_cast<const float4*>(work + r * LDX + c);
        const float4 dp =
            *reinterpret_cast<const float4*>(work + kXf + r * LDX + c);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked p is exactly 0, also when lse is the -1e30 sentinel
          const float p = interior || g.visible(q0 + r, k0 + c + e)
                              ? expf(part(sv, e) * scale - lse_r[u])
                              : 0.f;
          ds[e] = p * (part(dp, e) - dl_r[u]);
        }
        *reinterpret_cast<float4*>(ds_own + r * LDX + c) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
    }
    // the step's dS tiles, tile j at dsl + j kXf
    const float* dsl = ds_own;
    if constexpr (CLUSTER) {
      cluster_arrive();  // wrote step s's dS, read step s - 1's
      cluster_wait();    // every CTA's dS of step s is in place
      copy_ranks<R, BK, LDX>(work, kXf, ds_own, nt);
      dsl = work;
    }
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      const float* kt = next_item();  // K's slice of tile s nr + j
      mm_acc<QM, NV, BK, 4, 128, LDX, LD>(
          dq, dsl + j * kXf + (row0 + qr) * LDX, kt + qc);
    }
  }
  if constexpr (CLUSTER) {  // no peer reads this CTA's dS after it
    cluster_arrive();
    cluster_wait();
  }
  cp_async_wait<0>();

  OT* dqp = static_cast<OT*>(a.dq);
#pragma unroll
  for (int u = 0; u < QM; ++u) {
    const int qi = q0 + row0 + qr + 4 * u;
    if (qi >= g.tq) continue;
    OT* row = dqp + ((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D +
              col0 + qc;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (col0 + qc + 128 * v < D)
        store4(row + 128 * v, dq[u][4 * v] * scale, dq[u][4 * v + 1] * scale,
               dq[u][4 * v + 2] * scale, dq[u][4 * v + 3] * scale);
  }
}

template <typename OT>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_dq_cluster_f32_sm90(const FlashArgs a) {
  dq_wide_f32<OT, true>(a);
}

template <typename OT>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_dq_wide_f32_sm90(const FlashArgs a) {
  dq_wide_f32<OT, false>(a);
}

// The f32 dk/dv past 256: the CTA's R keys, BQ-query tiles. A step's
// items: the D / kCols chunks of K, V, Q and dO of the CTA's own score
// tile (if it has one), then the Q and dO slices of the step's tiles.
template <bool CLUSTER>
struct DkvWideF32 {
  static constexpr int kRows = 32;                  // keys a CTA
  static constexpr int kBq = 32;                    // queries a tile
  static constexpr int kStages = 2;                 // ring depth
  static constexpr int kCols = 64;                  // columns of a chunk
  static constexpr int kLd = kWideCols + kF32Pad;   // slice rows
  static constexpr int kLdc = kCols + kF32Pad;      // chunk rows
  static constexpr int kLdx = kBq + kF32Pad;        // score tiles
  static constexpr size_t kQ = round128(sizeof(float) * kBq * kLd);
  static constexpr size_t kKc = round128(sizeof(float) * kRows * kLdc);
  static constexpr size_t kQc = round128(sizeof(float) * kBq * kLdc);
  static constexpr size_t kX = round128(sizeof(float) * kRows * kLdx);
  static constexpr size_t kStage =
      2 * kKc + 2 * kQc > 2 * kQ ? 2 * kKc + 2 * kQc : 2 * kQ;
  // the ring, this CTA's P^T and dS^T of two steps, then S^T and dP^T of
  // its score tile or the step's P^T and dS^T tiles
  static constexpr size_t kSmem =
      kStages * kStage + 4 * kX + (CLUSTER ? kMaxCluster : 1) * 2 * kX;
  static_assert(kSmem <= kSmemLimit, "f32 wide dk/dv exceeds shared memory");
};

template <typename OT, bool CLUSTER>
__device__ __forceinline__ void dkv_wide_f32(const FlashArgs& a) {
  using L = DkvWideF32<CLUSTER>;
  constexpr int R = L::kRows, BQ = L::kBq, NS = L::kStages, KC = L::kCols,
                LD = L::kLd, LDC = L::kLdc, LDX = L::kLdx;
  // S^T (group 0) or dP^T (group 1): a 16 x 8 grid of the group's
  // threads, keys sr + 16u and queries sc + 8v
  constexpr int SM = R / 16, SN = BQ / 8;
  // P^T and dS^T: NQ quads of 4 queries a thread
  constexpr int NQ = R * BQ / (4 * kF32Threads);
  static_assert(NQ * 4 * kF32Threads == R * BQ && R % 16 == 0 && BQ % 8 == 0,
                "f32 wide dk/dv tiles / threads mismatch");
  // dV (group 0) or dK (group 1): a KTM x KTN grid of the group's
  // threads, KM keys kr + KTM u and columns kc + 4 KTN v + f each
  constexpr int KM = R / 8, KTM = R / KM, KTN = kF32Group / KTM,
                NV = kWideCols / (4 * KTN);
  constexpr int kStagef = L::kStage / sizeof(float), kQf = L::kQ / sizeof(float),
                kKcf = L::kKc / sizeof(float), kQcf = L::kQc / sizeof(float),
                kXf = L::kX / sizeof(float);
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* ring = cv.take<float>(NS * kStagef);
  // this CTA's P^T and dS^T (kXf on), step s at s % 2
  float* own = cv.take<float>(4 * kXf);
  float* work = cv.take<float>((CLUSTER ? kMaxCluster : 1) * 2 * kXf);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads), D = static_cast<int>(a.head_dim);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // as dq's: the cluster's
  const int ns = wide_slices(D), nc = (D + KC - 1) / KC;
  const int nr = CLUSTER ? ns : 1, rank = CLUSTER ? cluster_rank() : 0;
  const int col0 = (blockIdx.x % ns) * kWideCols;
  const int k0 = blockIdx.x / ns * R;  // low keys: most causal work
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;

  // causal: query rows before the first that sees key k0 see none of the
  // CTA's keys; round down to the query tile (the same in every CTA of
  // the cluster); step s takes tiles s nr .. s nr + nr - 1
  const int q_begin =
      g.causal ? max(0, k0 + g.k_offset - g.q_offset) / BQ * BQ : 0;
  const int n_tiles = q_begin < g.tq ? (g.tq - q_begin + BQ - 1) / BQ : 0;
  const int n_steps = (n_tiles + nr - 1) / nr;
  auto step_tiles = [&](int s) { return min(nr, n_tiles - s * nr); };
  auto n_score = [&](int s) { return rank < step_tiles(s) ? nc : 0; };
  const int full = nc + nr;  // the items of every step but the last
  const int n_items =
      n_steps ? (n_steps - 1) * full + n_score(n_steps - 1) +
                    step_tiles(n_steps - 1)
              : 0;
  auto load_item = [&](int i) {
    float* st = ring + (i % NS) * kStagef;
    const int s = i / full, j = i - s * full, c = n_score(s);
    if (j < c) {  // chunk j of the score tile
      const int q0 = q_begin + (s * nr + rank) * BQ;
      load_cols_async<R, KC>(st, kb, a.k_st, k0, g.tk, j * KC, D);
      load_cols_async<R, KC>(st + kKcf, vb, a.v_st, k0, g.tk, j * KC, D);
      load_cols_async<BQ, KC>(st + 2 * kKcf, qb, a.q_st, q0, g.tq, j * KC, D);
      load_cols_async<BQ, KC>(st + 2 * kKcf + kQcf, dob, a.do_st, q0, g.tq,
                              j * KC, D);
    } else {  // Q's and dO's slices of the step's tile j - c
      const int q0 = q_begin + (s * nr + j - c) * BQ;
      load_cols_async<BQ, kWideCols>(st, qb, a.q_st, q0, g.tq, col0, D);
      load_cols_async<BQ, kWideCols>(st + kQf, dob, a.do_st, q0, g.tq, col0,
                                     D);
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_items) load_item(i);
    cp_async_commit();
  }
  int item = 0;
  auto next_item = [&]() -> const float* {  // as dq's
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (item + NS - 1 < n_items) load_item(item + NS - 1);
    cp_async_commit();
    return ring + (item++ % NS) * kStagef;
  };

  const int grp = threadIdx.x / kF32Group, gt = threadIdx.x % kF32Group;
  const int sr = grid_row<16>(gt), sc = grid_col<16>(gt);
  const int kr = grid_row<KTM>(gt), kc = 4 * grid_col<KTM>(gt);
  float acc[KM][4 * NV];  // dV (group 0) or dK (group 1)
#pragma unroll
  for (int u = 0; u < KM; ++u)
#pragma unroll
    for (int i = 0; i < 4 * NV; ++i) acc[u][i] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    const int nt = step_tiles(s);
    float* p_own = own + (s % 2) * 2 * kXf;  // P^T, then dS^T
    if (rank < nt) {  // this CTA's score tile: S^T and dP^T over all of D
      const int q0 = q_begin + (s * nr + rank) * BQ;
      float x[SM][SN];
#pragma unroll
      for (int u = 0; u < SM; ++u)
#pragma unroll
        for (int v = 0; v < SN; ++v) x[u][v] = 0.f;
      for (int c = 0; c < nc; ++c) {
        const float* st = next_item();
        mm_rows<SM, SN, KC, 16, 8, LDC, LDC, true>(
            x, st + grp * kKcf + sr * LDC,
            st + 2 * kKcf + grp * kQcf + sc * LDC);
      }
      put_scores<SM, SN, LDX>(work + grp * kXf, x, sr, sc);
      __syncthreads();
      // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta)
      const bool interior =
          q0 + BQ <= g.tq && k0 + R <= g.tk &&
          (!g.causal || g.q_offset + q0 >= g.k_offset + k0 + R - 1);
#pragma unroll
      for (int u = 0; u < NQ; ++u) {
        const int i = threadIdx.x + kF32Threads * u, r = i / (BQ / 4),
                  c = 4 * (i % (BQ / 4));
        const float4 sv = *reinterpret_cast<const float4*>(work + r * LDX + c);
        const float4 dp =
            *reinterpret_cast<const float4*>(work + kXf + r * LDX + c);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + c + e;
          const float ls = qi < g.tq ? lse[qi] : 0.f;
          const float dl = qi < g.tq ? delta[qi] : 0.f;
          // masked p is exactly 0, also when lse is the -1e30 sentinel
          p[e] = interior || g.visible(qi, k0 + r)
                     ? expf(part(sv, e) * scale - ls)
                     : 0.f;
          ds[e] = p[e] * (part(dp, e) - dl);
        }
        *reinterpret_cast<float4*>(p_own + r * LDX + c) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(p_own + kXf + r * LDX + c) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
    }
    // the step's P^T and dS^T tiles, tile j's at pl + 2 j kXf
    const float* pl = p_own;
    if constexpr (CLUSTER) {
      cluster_arrive();  // wrote step s's tiles, read step s - 1's
      cluster_wait();    // every CTA's tiles of step s are in place
      copy_ranks<R, BQ, LDX>(work, 2 * kXf, p_own, nt);
      copy_ranks<R, BQ, LDX>(work + kXf, 2 * kXf, p_own + kXf, nt);
      pl = work;
    }
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      const float* qt = next_item();  // Q's, then dO's, slice of tile j
      // group 0: dV += P^T dO; group 1: dK += dS^T Q
      mm_acc<KM, NV, BQ, KTM, 4 * KTN, LDX, LD>(
          acc, pl + (2 * j + grp) * kXf + kr * LDX,
          (grp ? qt : qt + kQf) + kc);
    }
  }
  if constexpr (CLUSTER) {  // no peer reads this CTA's tiles after it
    cluster_arrive();
    cluster_wait();
  }
  cp_async_wait<0>();

  // group 0 writes dV, group 1 dK (scaled)
  OT* out = static_cast<OT*>(grp ? a.dk : a.dv);
  const float f = grp ? scale : 1.f;
#pragma unroll
  for (int u = 0; u < KM; ++u) {
    const int kj = k0 + kr + KTM * u;
    if (kj >= g.tk) continue;
    OT* row = out + ((static_cast<int64_t>(b) * g.tk + kj) * H + h) * D +
              col0 + kc;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (col0 + kc + 4 * KTN * v < D)
        store4(row + 4 * KTN * v, acc[u][4 * v] * f, acc[u][4 * v + 1] * f,
               acc[u][4 * v + 2] * f, acc[u][4 * v + 3] * f);
  }
}

template <typename OT>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_dkv_cluster_f32_sm90(const FlashArgs a) {
  dkv_wide_f32<OT, true>(a);
}

template <typename OT>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_dkv_wide_f32_sm90(const FlashArgs a) {
  dkv_wide_f32<OT, false>(a);
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

// The route is chosen by the input type and D alone: the 16-bit kernels
// and the f32 dq and dk/dv run as clusters while the slices fit a
// portable cluster (D <= 2048) and take the unclustered wide kernels past
// it; the f32 forward takes flash_fwd_wide_f32_sm90 at every D.
template <int KIND, typename T, typename OT>
cudaError_t launch_wide(const FlashArgs& a, cudaStream_t stream) {
  constexpr bool k16 = !std::is_same<T, float>::value;
  static_assert(DkvCluster::kRows == DkvWide::kRows, "one dk/dv key tile");
  static_assert(kF32Threads == kSm90Threads, "one block size");
  static bool fits[kMaxCluster + 1] = {};  // this instance's cluster sizes
  const int ns = wide_slices(a.head_dim);
  const bool cluster = (k16 || KIND != kFwd) && ns <= kMaxCluster;
  void (*kern)(const FlashArgs);
  size_t smem;
  int tile;
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
    if (cluster) {
      kern = flash_dq_cluster_sm90<T, OT>;
      smem = DqCluster::kSmem;
      tile = DqCluster::kRows;
    }
  } else if constexpr (k16) {
    kern = flash_dkv_wide_sm90<T, OT>;
    smem = DkvWide::kSmem;
    if (cluster) {
      kern = flash_dkv_cluster_sm90<T, OT>;
      smem = DkvCluster::kSmem;
    }
    tile = DkvWide::kRows;  // = DkvCluster::kRows
  } else if constexpr (KIND == kFwd) {
    kern = flash_fwd_wide_f32_sm90<OT>;
    smem = FwdWideF32::kSmem;
    tile = FwdWideF32::kRows;
  } else if constexpr (KIND == kDq) {
    static_assert(DqWideF32<true>::kRows == DqWideF32<false>::kRows,
                  "one f32 dq row tile");
    kern = flash_dq_wide_f32_sm90<OT>;
    smem = DqWideF32<false>::kSmem;
    if (cluster) {
      kern = flash_dq_cluster_f32_sm90<OT>;
      smem = DqWideF32<true>::kSmem;
    }
    tile = DqWideF32<true>::kRows;
  } else {
    static_assert(DkvWideF32<true>::kRows == DkvWideF32<false>::kRows,
                  "one f32 dk/dv key tile");
    kern = flash_dkv_wide_f32_sm90<OT>;
    smem = DkvWideF32<false>::kSmem;
    if (cluster) {
      kern = flash_dkv_cluster_f32_sm90<OT>;
      smem = DkvWideF32<true>::kSmem;
    }
    tile = DkvWideF32<true>::kRows;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid = wide_grid(rows, tile, a);
  if (cluster) return launch_cluster(kern, grid, smem, ns, fits, a, stream);
  kern<<<grid, kSm90Threads, smem, stream>>>(a);
  return cudaGetLastError();
}
