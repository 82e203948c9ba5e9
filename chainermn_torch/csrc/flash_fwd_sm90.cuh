// The 16-bit (bf16 and f16) flash forward for Hopper: wgmma products with
// register
// accumulators, fed by the asynchronous multi-stage ring of
// flash_bwd_sm90.cuh.
//
// Included by flash_attention.cu inside its anonymous namespace, after
// flash_bwd_sm90.cuh, whose PTX helpers, swizzled tile loads, descriptors,
// gemm_ss / gemm_rs, to_a_frags, frag_row / frag_col and launch_sm90 it
// uses; it includes nothing itself. It is the forward for bf16 and f16
// inputs, the element type T a template parameter (TPU: _fwd_kernel of
// chainermn_tpu/ops/flash_attention.py; f32 inputs take
// flash_fwd_f32_sm90 of flash_f32_sm90.cuh)
// and computes the same function under the same contract
// (flash_attention.cu's header).
//
// Design (two consumer warpgroups, 256 threads; a CTA per (batch*head,
// 128-query tile), longest causal tiles first, each warpgroup 64 rows):
//   - Q is loaded once into the swizzled tile; K and V tiles of 64 keys
//     stream through the 3-stage cp.async ring up to the causal end.
//   - S = Q K^T (wgmma, both operands in shared memory) lands in registers.
//     The online softmax runs there: each thread holds two rows
//     (frag_row(0) and frag_row(2)), a row's max is taken over the four
//     threads of a quad, p = exp2(s * scale * log2e - m) with m kept in
//     that domain, and O and l are rescaled in registers.
//   - T(P) is packed from the accumulator in place (to_a_frags: the
//     reference's rounding of p to v's type), then O += T(P) V (wgmma,
//     A in registers, V read MN-major). O stays in registers for the whole
//     loop and is written once; l sums the f32 p and is reduced over the
//     quad at the end.
//   - Tile j + 1's S = Q K^T is issued together with tile j's P V, and its
//     softmax runs while P V is in flight; O is rescaled once P V lands.
//     The ring holds tiles j and j + 1 while tile j + 2 loads.
//   - Interior tiles take no mask. Diagonal and ragged-tail tiles set the
//     masked scores to -inf in one branch after a straight-line scaling
//     loop, before the max, so the max sees only visible keys and a masked
//     p is exactly 0: exp2(-inf - m) with m finite (m starts at the -1e30
//     sentinel, so a row that has seen no visible key yet gets p = 0 too).
//   - Every output is written once, with no atomics: deterministic.
//   - D = 256 keeps 128 query rows and the 3-stage ring with 32-key
//     stages: Q (64 KB) and three 32 KB K/V stages take 164,864 B of shared
//     memory (64-key stages would take 263,168), and a thread holds its
//     128-register O, 16 scores and 8 registers of T(P) (64-key stages
//     would add 24 more). O += T(P) V runs as two N = 128 wgmmas
//     (gemm_rs), Q K^T as an N = 32 one.

#pragma once

template <int D>
struct FwdTiles {
  static constexpr int kBk = D > 128 ? 32 : 64;      // key rows a stage
  static constexpr uint32_t kQ = kSm90Rows * D * 2;  // bytes of Q
  static constexpr uint32_t kK = kBk * D * 2;        // of K or V
  static constexpr uint32_t kStage = 2 * kK;
  static constexpr size_t kSmem = kQ + kStages * kStage + 1024;
  static_assert(kSmem <= kSmemLimit, "forward tiles exceed shared memory");
};

constexpr float kLn2 = 0.6931471805599453f;

// The online-softmax step of one warpgroup for one key tile: s holds the
// tile's scores Q K^T (rows qw0.., keys k0..) and leaves with p, f32; m and
// l (this thread's two rows) move on, and corr is the factor that O must
// be rescaled by before this tile's P V is added.
template <int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const Geo& g,
                                             int qw0, int k0, float sl2) {
  const bool interior =
      qw0 + 64 <= g.tq && k0 + BK <= g.tk &&
      (!g.causal || g.q_offset + qw0 >= g.k_offset + k0 + BK - 1);
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] *= sl2;
  if (!interior) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (!g.visible(qw0 + frag_row(i), k0 + frag_col(i))) s[i] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    // the quad's four threads hold the row's columns: all of them end
    // with the same max
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    corr[e] = exp2f(m[e] - mx[e]);  // 0 when m leaves the sentinel
    m[e] = mx[e];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = exp2f(s[i] - mx[(i / 2) % 2]);
    sum[(i / 2) % 2] += s[i];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = l[e] * corr[e] + sum[e];
}

template <typename T, typename OT, int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_fwd_kernel_sm90(const FlashArgs a) {
  using L = FwdTiles<D>;
  constexpr int BK = L::kBk;
  extern __shared__ __align__(128) unsigned char smem90[];
  const uint32_t qs = (smem_addr(smem90) + 1023) & ~1023u, ring = qs + L::kQ;

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kSm90Rows;  // longest first
  const int wg = threadIdx.x / 128, qw0 = q0 + wg * 64;
  const float sl2 = static_cast<float>(a.scale) * kLog2e;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  // causal: keys past the tile's last query position are never visible
  const int q_last = min(q0 + kSm90Rows, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  // the tiles this warpgroup computes: a prefix of the CTA's (its rows'
  // causal end comes no later than the CTA's)
  const int wg_end =
      g.causal ? g.q_offset + min(qw0 + 64, g.tq) - 1 - g.k_offset + 1
               : g.tk;
  const int n_act = qw0 >= g.tq || wg_end <= 0
                        ? 0
                        : min(n_tiles, (min(wg_end, g.tk) + BK - 1) / BK);
  // stage of tile it: its K tile, then its V tile
  auto k_stage = [&](int it) { return ring + (it % kStages) * L::kStage; };
  auto load_stage = [&](int it) {
    load_tile<BK, D>(k_stage(it), kb, a.k_st, it * BK, g.tk);
    load_tile<BK, D>(k_stage(it) + L::kK, vb, a.v_st, it * BK, g.tk);
  };
  if (n_tiles > 0) load_tile<kSm90Rows, D>(qs, qb, a.q_st, q0, g.tq);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage(s);
    cp_async_commit();
  }

  // softmax state of this thread's two rows (element i's row is row
  // (i / 2) % 2 of the two): m in units of s * scale * log2e, l this
  // thread's share of the row sum (the quad's four shares add up at the end)
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, corr[2];
  float o[D / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t pa[BK / 16][4];  // T(P) of the tile whose P V is next

  // tile 0: S and its softmax; P V waits for the loop
  if (n_tiles > 0) {
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();
    if (n_act > 0) {
      wgmma_fence();
      gemm_ss<T, kSm90Rows, BK, D / 16>(s, qs, wg * 64, k_stage(0));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      softmax_step<BK>(s, m, l, corr, g, qw0, 0, sl2);
      to_a_frags<T, BK / 16>(pa, s);  // p rounded to v's type
    }
  }
  // tile j: O += T(P_j) V_j in flight while tile j + 1's S = Q K^T
  // lands and its softmax runs
  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) load_stage(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 2>();  // this thread's copies of tile it + 1
    fence_async_smem();
    __syncthreads();               // everyone's
    // each branch holds its products from issue to wait (a wgmma in
    // flight across branches makes ptxas serialise them); the active tiles
    // are a prefix, so tile it + 1 active means tile it is too
    if (it + 1 < n_act) {
      wgmma_fence();
      gemm_ss<T, kSm90Rows, BK, D / 16>(s, qs, wg * 64, k_stage(it + 1));
      wgmma_commit();
      gemm_rs<T, BK, BK / 16>(o, pa, k_stage(it) + L::kK);  // O += T(P) V
      wgmma_commit();
      wgmma_wait<1>();  // S of tile it + 1; P V of tile it still running
      reg_fence(s);
      softmax_step<BK>(s, m, l, corr, g, qw0, (it + 1) * BK, sl2);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];
      to_a_frags<T, BK / 16>(pa, s);
    } else if (it < n_act) {
      wgmma_fence();
      gemm_rs<T, BK, BK / 16>(o, pa, k_stage(it) + L::kK);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
    }
    __syncthreads();  // tile it's stage is free for the copies of it + 3
  }
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
  }
  OT* out = static_cast<OT*>(a.out);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int qi = qw0 + frag_row(i);
    if (qi >= g.tq) continue;
    const float li = l[(i / 2) % 2] == 0.f ? 1.f : l[(i / 2) % 2];
    const int64_t off =
        ((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + frag_col(i);
    store2(out + off, o[i] / li, o[i + 1] / li);
  }
  if (threadIdx.x % 4 == 0) {  // one lane of each quad writes its two rows
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = qw0 + frag_row(2 * e);
      if (qi < g.tq)
        a.lse_out[static_cast<int64_t>(bh) * g.tq + qi] =
            l[e] == 0.f ? kNegBig : m[e] * kLn2 + logf(l[e]);
    }
  }
}

template <typename T, typename OT, int D>
cudaError_t launch_fwd_sm90(const FlashArgs& a, cudaStream_t stream) {
  return launch_sm90(flash_fwd_kernel_sm90<T, OT, D>, FwdTiles<D>::kSmem,
                     a.tq, kSm90Rows, a, stream);
}
