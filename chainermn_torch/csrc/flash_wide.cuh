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
//   - The products that reduce over D (S = Q K^T, and dP = dO V^T in the
//     backward) stream their operands through shared memory in
//     kChunk-column (64) chunks into the same f32 accumulators. Each slice
//     then applies P (or dS) to its own columns of V, K, or Q and dO.
//   - So every CTA of a row tile recomputes the tile's scores: the score
//     products run ns times. At D = 512 (two slices) that is 1.5x the
//     forward's FLOPs (S twice, P V once), 5/3x dq's and 1.5x dk/dv's; the
//     operands that reduce over D are re-read from L2 by every slice, and
//     Q (forward, dq) or K and V (dk/dv) once per tile of the other
//     sequence as well, since a whole row of them no longer fits.
//   - The 16-bit kernels keep the D <= 256 kernels' shapes: two consumer
//     warpgroups, 128 query rows (forward, dq) or 64 keys (dk/dv, each
//     warpgroup dK and dV of 128 of the slice's columns), the 3-stage
//     cp.async ring in the 128-byte swizzle, S / P / dP / dS in registers.
//     The ring walks "items": for each tile of the other sequence, the D /
//     64 chunks of the reduction's operands, then the slice's operand of
//     the output product. Each item's products complete before the item's
//     stage is reused. A thread's accumulators are those of the D = 256
//     kernels (128 registers for the output slice).
//   - 32-key tiles in the forward and dq, as at D = 256: 64-key tiles
//     would add 24 registers to the forward's 128-register O and spill.
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

// ------------------------------------------------------------- launcher --

template <int KIND, typename T, typename OT>
cudaError_t launch_wide(const FlashArgs& a, cudaStream_t stream) {
  constexpr bool k16 = !std::is_same<T, float>::value;
  void (*kern)(const FlashArgs);
  size_t smem;
  int tile, threads = k16 ? kSm90Threads : kThreads;
  const int64_t rows = KIND == kDkv ? a.tk : a.tq;  // dk/dv: key tiles
  if constexpr (k16 && KIND == kFwd) {
    kern = flash_fwd_wide_sm90<T, OT>;
    smem = FwdWide::kSmem;
    tile = kSm90Rows;
  } else if constexpr (k16 && KIND == kDq) {
    kern = flash_dq_wide_sm90<T, OT>;
    smem = DqWide::kSmem;
    tile = kSm90Rows;
  } else if constexpr (k16) {
    kern = flash_dkv_wide_sm90<T, OT>;
    smem = DkvWide::kSmem;
    tile = DkvWide::kRows;
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
  kern<<<wide_grid(rows, tile, a), threads, smem, stream>>>(a);
  return cudaGetLastError();
}
