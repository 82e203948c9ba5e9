// Paged-attention decode for Hopper (sm_90a), bound to Python with ctypes
// by chainermn_torch/parallel/paged_kernel.py.
//
// Replaces the Pallas TPU kernel
// chainermn_tpu/parallel/paged_kernel.py::_decode_kernel (launched by
// paged_attend). It computes the same function: for each batch row b and
// head h, the S queries at positions lengths[b]-S .. lengths[b]-1 attend,
// causally, to the row's KV rows 0 .. lengths[b]-1, which live in a shared
// block store [n_blocks, bs, H, D] addressed through the row's block table
// [B, table_stride] (only the first n_j entries are read). int8 stores
// carry f32 per-row-per-head scales [n_blocks, bs, H]: the k-scale
// multiplies the logits after QK, the v-scale multiplies p before PV, and
// l sums the unscaled p. QK, the softmax state (m, l, acc) and the PV
// product are f32 (p is never rounded to a narrower type: greedy decoding
// must give the plain path's tokens), a masked p is exactly 0, and a row
// with l == 0 writes 0.
//
// What bounds it: decode attention does ~2 flops per byte of KV it reads,
// far below the H100's ~295 flops/byte ridge, so the time floor is the KV
// bytes of each row's live blocks over the memory rate
// (bytes_read_model's "kernel_bytes"). The design keeps many loads in
// flight and no thread waiting on another:
//   - a CTA (4 warps) per ((row b, head h), split), the B * H pairs on
//     grid x and the splits on grid y: the host splits each
//     row's table span into n_split ranges of whole bs-key blocks
//     (split_plan in the wrapper, from host values only), so a long row is
//     read by several CTAs at once (flash-decoding) and the longest row
//     does not set the kernel's time. Keys past the row's length are never
//     read; a split that starts past it writes l = 0;
//   - the CTA stages its range's table entries in shared memory once, so
//     each entry is read once per CTA, not once per element;
//   - inside the key loop there is no CTA barrier: each warp walks its own
//     chunks of the range (interleaved with the other warps') and keeps its
//     own online-softmax state (m, l and the accumulator, for all S <= 8
//     queries) in registers; the wrapper runs longer query windows as
//     chunks of 8;
//   - a group of G lanes covers one key row with 16-byte loads (8 bf16 or
//     f16, 4 f32 or 16 int8 elements a lane; 8 int8 when S > 1, so that q
//     and the accumulator stay in registers; two 16-byte loads, 8 f32
//     elements, for an f32 store at DP = 256, so that a row still takes at
//     most 32 lanes), so one warp load covers 32 / G keys (one key for
//     bf16, f16 and f32 at DP = 256, and int8 when S > 1). The head dim D
//     is any of 1 .. 256 in one tile, and any D past 256 in slices
//     (below): the lanes are laid out for the tile width DP (16, 32, 64,
//     128 or 256, the least that holds D), lanes
//     whose elements lie at or past D load nothing and hold zeros, and
//     when D is not a whole number of a lane's elements every lane loads
//     element by element (the store is never padded or copied),
//     and each lane has kUnroll loads of K and of V in flight before the
//     first is used. Scores are the lane's q (f32 registers) times its K
//     elements, reduced over the group by shuffles; each lane accumulates
//     p * v for its own dimensions;
//   - D > 256 (WIDE): the output's columns are split into 256-column
//     slices, one CTA each on grid z, so a lane's accumulator and the
//     warps' partials stay those of the 256-wide tile. Each CTA computes
//     the whole scores: for each piece of 256 columns of the row it has
//     its U key loads in flight, then multiplies them by q's elements of
//     the piece (read from global memory, L1-resident: q is S x D), and
//     reduces over the group once per key; then it reads V's row in its
//     own slice only. So K is read once per slice and V once: at D = 512
//     (two slices) 1.5x the K and V bytes of one read. Every slice
//     computes the same m and l; slice 0 writes them to the workspace;
//   - at the end the key groups of a warp combine by shuffles and the
//     warps through shared memory, in a fixed order; with several splits
//     each CTA writes its (m, l, acc) to an f32 workspace and a second
//     small kernel combines the splits in split order. No atomics: the
//     results are bitwise reproducible.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQueries = 8;
constexpr int kMaxSplitBlocks = 4096;  // table entries a CTA stages
constexpr float kNegBig = -1e30f;

using bf16 = __nv_bfloat16;
using half = __half;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(half x) { return __half2float(x); }

__device__ __forceinline__ void store_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f32(float x, bf16* p) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_f32(float x, half* p) {
  *p = __float2half(x);
}

// A lane's two 16-byte loads (8 f32 elements of an f32 store at DP = 256).
struct alignas(16) Raw32 {
  uint4 lo, hi;
};

// How the lanes of a warp cover key rows of a KVT store with a tile width
// of DP dimensions when NQ query registers are live (NQ = 1 for S = 1,
// else kMaxQueries).
template <typename KVT, int DP, int NQ>
struct Lanes {
  static constexpr int kBytes = sizeof(KVT) == 1 && NQ > 1   ? 8
                                : sizeof(KVT) == 4 && DP > 128 ? 32
                                                               : 16;
  static constexpr int kElems = kBytes / static_cast<int>(sizeof(KVT));
  static constexpr int kGroup = DP / kElems;        // lanes per key row
  static constexpr int kKeysPerLoad = 32 / kGroup;  // keys a warp load covers
  static constexpr int kUnroll = NQ == 1 ? 4 : 1;   // loads in flight
  static constexpr int kKeysPerStep = kKeysPerLoad * kUnroll;
  using Raw = typename std::conditional<
      kBytes == 32, Raw32,
      typename std::conditional<kBytes == 16, uint4, uint2>::type>::type;
  static_assert(kGroup >= 1 && kGroup <= 32 && 32 % kGroup == 0,
                "lane group");
};

// One lane's E elements of a key row at src (element d0 of the row, D
// elements long): one Raw load when `vec` (D a whole number of lanes'
// elements, so the load is aligned), else element by element; elements
// at or past D read as 0.
template <typename KVT, int E, typename Raw>
__device__ __forceinline__ Raw load_lane(const KVT* src, int d0, int D,
                                         bool vec) {
  Raw r{};
  if (vec) {
    if (d0 < D) r = *reinterpret_cast<const Raw*>(src);
  } else {
    KVT* e = reinterpret_cast<KVT*>(&r);
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (d0 + i < D) e[i] = src[i];
  }
  return r;
}

// The E elements of one lane's raw load, widened to f32.
template <typename KVT, int E, typename Raw>
__device__ __forceinline__ void widen(const Raw& r, float (&f)[E]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&r);
  if constexpr (std::is_same<KVT, float>::value) {
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = __uint_as_float(w[e]);
  } else if constexpr (std::is_same<KVT, bf16>::value) {
#pragma unroll
    for (int j = 0; j < E / 2; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else if constexpr (std::is_same<KVT, half>::value) {
#pragma unroll
    for (int j = 0; j < E / 2; ++j) {
      f[2 * j] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[j] & 0xffffu)));
      f[2 * j + 1] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[j] >> 16)));
    }
  } else {
#pragma unroll
    for (int j = 0; j < E / 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        f[4 * j + c] = static_cast<float>(
            static_cast<int8_t>((w[j] >> (8 * c)) & 0xffu));
  }
}

template <typename QT, typename KVT, int DP, int NQ, bool QUANT, bool WIDE>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
                    const KVT* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, QT* __restrict__ out,
                    float* __restrict__ partial, int S, int H, int D, int bs,
                    int table_stride, int n_j, int split_keys, float scale) {
  using Ln = Lanes<KVT, DP, NQ>;
  using Raw = typename Ln::Raw;
  constexpr int E = Ln::kElems, G = Ln::kGroup, KPL = Ln::kKeysPerLoad;
  constexpr int U = Ln::kUnroll, KPS = Ln::kKeysPerStep;
  __shared__ float w_m[kWarps][NQ], w_l[kWarps][NQ];
  __shared__ float w_acc[kWarps][NQ][DP];
  extern __shared__ int blk[];  // the range's table entries

  const int h = blockIdx.x % H, b = blockIdx.x / H, split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / G, d0 = (lane % G) * E;
  const bool vec = D % E == 0;
  // WIDE (D > DP = 256): the CTA's slice of output columns col0 .. col0 +
  // DP - 1; the scores run over the row's n_pc pieces of DP columns
  const int col0 = WIDE ? blockIdx.z * DP : 0;
  const int n_pc = WIDE ? (D + DP - 1) / DP : 1;
  const int64_t q_row = (static_cast<int64_t>(b) * S * H + h) * D;

  // the range's table entries do not depend on the row's length, so they
  // load while the length does
  const int lo = split * split_keys, r_end = min(n_j * bs, lo + split_keys);
  const int* trow = table + static_cast<int64_t>(b) * table_stride + lo / bs;
  for (int j = threadIdx.x; j * bs < r_end - lo; j += kThreads)
    blk[j] = trow[j];
  const int len = lengths[b];
  const int hi = min(max(len, 0), r_end);
  const int q_pos0 = len - S;  // query sq sees keys 0 .. q_pos0 + sq

  float qr[NQ][E];  // WIDE: q is read piece by piece in the key loop
#pragma unroll
  for (int sq = 0; sq < NQ; ++sq)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[sq][e] = !WIDE && sq < S && d0 + e < D
                      ? to_f32(q[((static_cast<int64_t>(b) * S + sq) * H +
                                  h) * D + d0 + e])
                      : 0.f;
  float m[NQ], l[NQ], acc[NQ][E];
#pragma unroll
  for (int sq = 0; sq < NQ; ++sq) {
    m[sq] = kNegBig;
    l[sq] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[sq][e] = 0.f;
  }
  __syncthreads();  // blk

  for (int base = lo + warp * KPS; base < hi; base += kWarps * KPS) {
    Raw kr[U], vr[U];
    float ksc[U], vsc[U];
    int t[U];
    int64_t roff[U];  // the key row's element offset in the store
#pragma unroll
    for (int u = 0; u < U; ++u) {
      t[u] = base + u * KPL + grp;
      kr[u] = vr[u] = Raw{};
      ksc[u] = vsc[u] = 0.f;
      roff[u] = 0;
      if (t[u] < hi) {
        const int j = (t[u] - lo) / bs;
        const int64_t row =
            static_cast<int64_t>(blk[j]) * bs + (t[u] - lo - j * bs);
        roff[u] = (row * H + h) * D;
        const int64_t off = roff[u] + col0 + d0;
        if (!WIDE) kr[u] = load_lane<KVT, E, Raw>(k + off, d0, D, vec);
        vr[u] = load_lane<KVT, E, Raw>(v + off, col0 + d0, D, vec);
        if (QUANT) {
          ksc[u] = k_scale[row * H + h];
          vsc[u] = v_scale[row * H + h];
        }
      }
    }
    // WIDE: this lane's share of each score, piece by piece: U key loads
    // of the piece in flight, then q's elements of the piece (L1-resident)
    float wdot[WIDE ? NQ : 1][WIDE ? U : 1];
    if constexpr (WIDE) {
#pragma unroll
      for (int sq = 0; sq < NQ; ++sq)
#pragma unroll
        for (int u = 0; u < U; ++u) wdot[sq][u] = 0.f;
      for (int pc = 0; pc < n_pc; ++pc) {
        const int c = pc * DP + d0;
        float kf[U][E];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const Raw r = t[u] < hi
                            ? load_lane<KVT, E, Raw>(k + roff[u] + c, c, D, vec)
                            : Raw{};
          widen<KVT, E>(r, kf[u]);
        }
#pragma unroll
        for (int sq = 0; sq < NQ; ++sq) {
          if (sq >= S) break;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float qv =
                c + e < D ? to_f32(q[q_row + sq * int64_t{H} * D + c + e])
                          : 0.f;
#pragma unroll
            for (int u = 0; u < U; ++u)
              wdot[sq][u] = fmaf(qv, kf[u][e], wdot[sq][u]);
          }
        }
      }
    }
    float s[NQ][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      if (!WIDE) widen<KVT, E>(kr[u], kf);
#pragma unroll
      for (int sq = 0; sq < NQ; ++sq) {
        float dot = 0.f;
        if constexpr (WIDE) {
          dot = wdot[sq][u];
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[sq][e], kf[e], dot);
        }
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        float x = dot * scale;
        if (QUANT) x *= ksc[u];
        // masked: -inf, so p = exp(-inf - m) is exactly 0 (m is finite)
        s[sq][u] = t[u] < hi && t[u] <= q_pos0 + sq ? x : -INFINITY;
      }
    }
#pragma unroll
    for (int sq = 0; sq < NQ; ++sq) {
      float mx = m[sq];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[sq][u]);
      const float corr = expf(m[sq] - mx);
      m[sq] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[sq][u] = expf(s[sq][u] - mx);
        sum += s[sq][u];
      }
      l[sq] = l[sq] * corr + sum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[sq][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      widen<KVT, E>(vr[u], vf);
#pragma unroll
      for (int sq = 0; sq < NQ; ++sq) {
        const float p = QUANT ? s[sq][u] * vsc[u] : s[sq][u];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[sq][e] = fmaf(p, vf[e], acc[sq][e]);
      }
    }
  }

  // the warp's key groups (lanes grp * G + c, one c per dimension slice)
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int sq = 0; sq < NQ; ++sq) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[sq], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[sq], o);
      const float mn = fmaxf(m[sq], mo);
      const float ca = expf(m[sq] - mn), cb = expf(mo - mn);
      l[sq] = l[sq] * ca + lo_ * cb;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[sq][e] =
            acc[sq][e] * ca + __shfl_xor_sync(0xffffffffu, acc[sq][e], o) * cb;
      m[sq] = mn;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int sq = 0; sq < NQ; ++sq) {
#pragma unroll
      for (int e = 0; e < E; ++e) w_acc[warp][sq][d0 + e] = acc[sq][e];
      if (lane == 0) {
        w_m[warp][sq] = m[sq];
        w_l[warp][sq] = l[sq];
      }
    }
  }
  __syncthreads();

  // the warps, in order (WIDE: over the slice's columns)
  const int n_split = gridDim.y;
  const int DW = WIDE ? DP : D;
  for (int i = threadIdx.x; i < S * DW; i += kThreads) {
    const int sq = i / DW, dd = i % DW, d = col0 + dd;
    if (WIDE && d >= D) continue;
    float mx = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w][sq]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(w_m[w][sq] - mx);
      sum += w_l[w][sq] * c;
      a += w_acc[w][sq][dd] * c;
    }
    if (n_split == 1) {
      store_f32(a / (sum == 0.f ? 1.f : sum),
                out + ((static_cast<int64_t>(b) * S + sq) * H + h) * D + d);
    } else {
      // [m (S), l (S), acc (S x D)]; acc only where the split saw a key;
      // m and l from column 0 (the slices' scores are the same)
      float* part = partial + ((static_cast<int64_t>(b) * H + h) * n_split +
                               split) * S * (D + 2);
      if (d == 0) {
        part[sq] = mx;
        part[S + sq] = sum;
      }
      if (sum != 0.f) part[2 * S + sq * D + d] = a;
    }
  }
}

// Combines the n_split partials of each (row, head), in split order.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ partial,
                            QT* __restrict__ out, int S, int H, int D,
                            int n_split) {
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int stride = S * (D + 2);
  const float* base =
      partial + (static_cast<int64_t>(b) * H + h) * n_split * stride;
  for (int i = threadIdx.x; i < S * D; i += kThreads) {
    const int sq = i / D, d = i % D;
    float mx = kNegBig;
    for (int sp = 0; sp < n_split; ++sp)
      mx = fmaxf(mx, base[sp * stride + sq]);
    float sum = 0.f, a = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float* p = base + sp * stride;
      const float ls = p[S + sq];
      if (ls != 0.f) {
        const float c = expf(p[sq] - mx);
        sum += ls * c;
        a += p[2 * S + i] * c;
      }
    }
    store_f32(a / (sum == 0.f ? 1.f : sum),
              out + ((static_cast<int64_t>(b) * S + sq) * H + h) * D + d);
  }
}

struct Call {
  const void *q, *k, *v, *k_scale, *v_scale, *table, *lengths;
  void *out, *partial;
  int B, S, H, bs, table_stride, n_j, n_split, split_keys;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename KVT, int DP, int NQ, bool QUANT, bool WIDE>
cudaError_t launch(int D, const Call& c) {
  const unsigned bh = static_cast<unsigned>(c.B) * static_cast<unsigned>(c.H);
  // WIDE: one CTA per DP-column slice of the output on grid z
  const dim3 grid(bh, c.n_split, WIDE ? (D + DP - 1) / DP : 1);
  const size_t smem = sizeof(int) * (c.split_keys / c.bs);
  // the warps' partials are static shared memory (33,024 B at DP = 256,
  // NQ = 8); past 48 KB with the table entries the kernel must ask for it
  constexpr size_t kStatic = sizeof(float) * kWarps * NQ * (DP + 2);
  if (kStatic + smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<QT, KVT, DP, NQ, QUANT, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  paged_decode_kernel<QT, KVT, DP, NQ, QUANT, WIDE>
      <<<grid, kThreads, smem, c.stream>>>(
          static_cast<const QT*>(c.q), static_cast<const KVT*>(c.k),
          static_cast<const KVT*>(c.v), static_cast<const float*>(c.k_scale),
          static_cast<const float*>(c.v_scale),
          static_cast<const int*>(c.table),
          static_cast<const int*>(c.lengths), static_cast<QT*>(c.out),
          static_cast<float*>(c.partial), c.S, c.H, D, c.bs, c.table_stride,
          c.n_j, c.split_keys, c.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || c.n_split == 1) return err;
  paged_decode_combine_kernel<QT><<<bh, kThreads, 0, c.stream>>>(
      static_cast<const float*>(c.partial), static_cast<QT*>(c.out), c.S,
      c.H, D, c.n_split);
  return cudaGetLastError();
}

template <typename QT, typename KVT, int DP, bool QUANT, bool WIDE = false>
cudaError_t launch_s(int D, const Call& c) {
  return c.S == 1 ? launch<QT, KVT, DP, 1, QUANT, WIDE>(D, c)
                  : launch<QT, KVT, DP, kMaxQueries, QUANT, WIDE>(D, c);
}

// The tile width: the least of 16, 32, 64, 128 and 256 that holds D; past
// 256, 256-column slices of the output (WIDE).
template <typename QT, typename KVT, bool QUANT>
cudaError_t launch_d(int D, const Call& c) {
  if (D <= 16) return launch_s<QT, KVT, 16, QUANT>(D, c);
  if (D <= 32) return launch_s<QT, KVT, 32, QUANT>(D, c);
  if (D <= 64) return launch_s<QT, KVT, 64, QUANT>(D, c);
  if (D <= 128) return launch_s<QT, KVT, 128, QUANT>(D, c);
  if (D <= 256) return launch_s<QT, KVT, 256, QUANT>(D, c);
  return launch_s<QT, KVT, 256, QUANT, true>(D, c);
}

// Store types by query type: f32 queries read every store type, bf16
// queries f32, bf16 or int8 stores, f16 queries f16 or int8 stores (the
// wrapper runs other pairs with q widened to f32, which is exact: q is
// widened to f32 here anyway, and the output is rounded once either way).
template <typename QT>
cudaError_t launch_kv(int kv_dtype, int D, const Call& c) {
  constexpr bool kHalfQ = std::is_same<QT, half>::value;
  if (kv_dtype == 2) return launch_d<QT, int8_t, true>(D, c);
  if constexpr (!std::is_same<QT, bf16>::value) {
    if (kv_dtype == 3) return launch_d<QT, half, false>(D, c);
  }
  if constexpr (!kHalfQ) {
    if (kv_dtype == 0) return launch_d<QT, float, false>(D, c);
    if (kv_dtype == 1) return launch_d<QT, bf16, false>(D, c);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (stores only), 3 =
// float16 (q code 2); the pairs launch_kv takes. D is any of 1 ..
// 65535 * 256; S at most kMaxQueries (8). With
// n_split > 1, `partial` is an f32 workspace of B * H * n_split * S * (D + 2)
// floats; split i covers keys [i * split_keys, (i + 1) * split_keys).
// Returns 0 on a successful launch, else the cudaError_t of the launch.
extern "C" int paged_decode_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths, void* out,
    void* partial, int B, int S, int H, int D, int bs, int table_stride,
    int n_j, int n_split, int split_keys, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  if (B < 1 || H < 1 ||
      static_cast<int64_t>(B) * H > 0x7fffffff ||  // grid x
      D < 1 || (D + 255) / 256 > 65535 ||  // grid z of the slices
      S < 1 || S > kMaxQueries ||
      bs < 1 || n_j < 1 || n_split < 1 || n_split > 65535 ||
      split_keys < bs || split_keys % bs != 0 ||
      split_keys / bs > kMaxSplitBlocks ||
      static_cast<int64_t>(n_split - 1) * split_keys >=
          static_cast<int64_t>(n_j) * bs ||
      static_cast<int64_t>(n_split) * split_keys <
          static_cast<int64_t>(n_j) * bs ||
      (n_split > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{q, k, v, k_scale, v_scale, table, lengths, out, partial, B, S,
               H, bs, table_stride, n_j, n_split, split_keys, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (q_dtype == 0)
    err = launch_kv<float>(kv_dtype, D, c);
  else if (q_dtype == 1)
    err = launch_kv<bf16>(kv_dtype, D, c);
  else if (q_dtype == 2)
    err = launch_kv<half>(kv_dtype, D, c);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
