// Flash attention for Hopper (sm_90a): the forward, dq and dk/dv kernels,
// bound to Python with ctypes by chainermn_torch/ops/flash_attention.py.
//
// Replaces the Pallas TPU kernels of chainermn_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel      (launched by _fwd)
//   flash_dq_kernel   <- _bwd_dq_kernel   (launched by _dq_call)
//   flash_dkv_kernel  <- _bwd_dkv_kernel  (launched by _dkv_call)
// and computes the same functions, in the model layout [B, T, H, D] read
// through strides (no fold copies), with lse and delta as f32 [B, H, Tq]:
//   fwd: out = softmax(scale * q k^T, masked) v and lse = m + log(l);
//   dq:  dq = scale * (p * (do v^T - delta)) k,   p = exp(s - lse);
//   dkv: dv = p^T do,  dk = scale * (p * (do v^T - delta))^T q.
// Causal masking compares global positions q_offset + i >= k_offset + j;
// the offsets are runtime ints. The numerical contract is the reference's:
//   - masked scores take -1e30 and a masked p is exactly 0;
//   - a row that sees no key writes out = 0 and lse = -1e30 (and so gets
//     zero gradients);
//   - softmax state (m, l) and every accumulator are f32; l sums the f32 p;
//   - PV multiplies p rounded to v's type; dv uses p rounded to do's type;
//     dq uses ds rounded to k's type and dk ds rounded to q's type (all four
//     inputs share one type here), each with f32 accumulation;
//   - f32 inputs use plain f32 FMA (never TF32).
//
// What it takes: f32, bf16 or f16 inputs (one type for all four), outputs
// in that type or f32 (f32 inputs may also write bf16), D = 64 or 128
// (the wrapper pads other head dims up to 128 with zero lanes), any Tq and
// Tk, and any B * H: the (batch, head) pairs run on grid y and, past
// 65535 of them, on grid z as well (flash_grid).
//
// What bounds it: causal attention does about T / 3 flops per byte it must
// move (~680 at the LM's T = 2048), above the H100's ridge of ~295, so the
// floor is the tensor-core rate. The bf16 kernels, which do a training
// step's attention work, are built for that floor: the forward in
// flash_fwd_sm90.cuh (flash_fwd_kernel_sm90), dq and dk/dv in
// flash_bwd_sm90.cuh (flash_dq_kernel_sm90, flash_dkv_kernel_sm90). Each
// runs wgmma products whose f32 accumulators stay in registers (S, P, dP,
// dS never reach shared memory, and O, dQ, dK, dV are written once), two
// warpgroups a CTA, and a 3-stage cp.async ring that loads the next tiles
// while the current one is computed. The f32 kernels below keep the first,
// simple design:
//   - one thread block (4 warps) per (batch*head, 32-row tile); the TPU's
//     sequential grid axis becomes a loop inside the block over the other
//     sequence's tiles, so no state crosses blocks and every gradient is
//     written once, with no atomics (deterministic);
//   - causal blocks stop at the last key tile a query tile can see (fwd,
//     dq) or start at the first query tile that sees the key tile (dkv):
//     fully masked tiles are neither read nor computed;
//   - ragged Tq / Tk are masked in the tail tile, so any length works;
//   - tiles live in shared memory; products run on plain f32 FMA, with
//     scores, softmax and the f32 accumulators staged in shared memory
//     between the products;
//   - blocks with the most causal work are issued first (fwd, dq).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Field order and types match _FlashArgs in ops/flash_attention.py: every
// field is 8 bytes, so the two layouts agree without padding rules.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Tq] (dq, dkv)
  const float* delta;  // [B, H, Tq] (dq, dkv)
  void* out;           // [B, Tq, H, D] (fwd)
  float* lse_out;      // [B, H, Tq] (fwd)
  void* dq;            // [B, Tq, H, D]
  void* dk;            // [B, Tk, H, D]
  void* dv;            // [B, Tk, H, D]
  int64_t q_sb, q_st, q_sh;  // element strides of batch, time, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t do_sb, do_st, do_sh;
  int64_t batch, heads, tq, tk, head_dim;
  int64_t q_offset, k_offset, causal;
  int64_t in_dtype, out_dtype;  // 0 = float32, 1 = bfloat16, 2 = float16
  double scale;
};

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -1e30f;

using bf16 = __nv_bfloat16;

// Tile rows and shared-memory row padding of the f32 kernels: an odd pitch
// lets the scalar products read columns without bank conflicts, and 32-row
// tiles keep the dk/dv block inside shared memory at D = 128.
constexpr int kTile = 32;
constexpr int kPad = 1;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr size_t round128(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

// Hands out 128-byte-aligned pieces of the dynamic shared memory.
struct Carver {
  unsigned char* p;
  template <typename U>
  __device__ U* take(int n) {
    U* r = reinterpret_cast<U*>(p);
    p += round128(sizeof(U) * n);
    return r;
  }
};

// The grid of a kernel whose CTAs each own `tile` rows of `rows`, one row
// of CTAs per (batch, head) pair: the pairs fill grid y up to its limit
// of 65535 and spill over onto grid z; a kernel finds its pair at
// blockIdx.z * gridDim.y + blockIdx.y and the spare CTAs of the last
// z-slice return at once.
inline dim3 flash_grid(int64_t rows, int tile, const FlashArgs& a) {
  const int64_t bh = a.batch * a.heads;
  const int64_t y = bh < 65535 ? bh : 65535;
  return dim3(static_cast<unsigned>((rows + tile - 1) / tile),
              static_cast<unsigned>(y), static_cast<unsigned>((bh + y - 1) / y));
}

// Geometry of one call, in ints.
struct Geo {
  int tq, tk, q_offset, k_offset;
  bool causal;
  __device__ __forceinline__ bool visible(int qi, int kj) const {
    return qi < tq && kj < tk && (!causal || q_offset + qi >= k_offset + kj);
  }
};

__device__ __forceinline__ Geo make_geo(const FlashArgs& a) {
  return Geo{static_cast<int>(a.tq), static_cast<int>(a.tk),
             static_cast<int>(a.q_offset), static_cast<int>(a.k_offset),
             a.causal != 0};
}

// Rows row0 .. row0+R-1 of one (batch, head) slice of a [B, T, H, D] f32
// input into a shared tile of pitch D + kPad; rows at or past n_rows read
// as 0. 16-byte loads: neighbouring threads read neighbouring pieces of a
// row.
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t st, int row0, int n_rows) {
  constexpr int kLd = D + kPad;
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const int t = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < n_rows) x = *reinterpret_cast<const float4*>(src + t * st + c);
    float* d = dst + r * kLd + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// Rows row0 .. row0+R-1 of a [B, H, Tq] row statistic (0 past n_rows).
template <int R>
__device__ __forceinline__ void load_stat(float* dst, const float* src,
                                          int row0, int n_rows) {
  for (int r = threadIdx.x; r < R; r += kThreads)
    dst[r] = row0 + r < n_rows ? src[row0 + r] : 0.f;
}

// C[M x N] (pitch ldc) = or += op(A)[M x K] op(B)[K x N], all f32 in
// shared memory, plain FMA (never TF32), one thread per output element.
// A[m][k] is a[m * lda + k], or a[k * lda + m] when TA; B[k][n] is
// b[k * ldb + n], or b[n * ldb + k] when TB. The whole block calls it; the
// caller syncs.
template <int M, int N, int K, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void block_mm(const float* a, int lda,
                                         const float* b, int ldb, float* c,
                                         int ldc) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N, n = i % N;
    float s = ACC ? c[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      s = fmaf(TA ? a[k * lda + m] : a[m * lda + k],
               TB ? b[n * ldb + k] : b[k * ldb + n], s);
    c[m * ldc + n] = s;
  }
}

// Shared-memory pitches and sizes, one place for kernels and launchers.
template <int D>
struct Layout {
  static constexpr int kB = kTile;        // rows of every tile
  static constexpr int kLd = D + kPad;    // q, k, v, do tiles
  static constexpr int kLds = kB + 4;     // scores
  static constexpr int kLdp = kB + kPad;  // p / ds
  static constexpr int kLdo = D + 4;      // accumulators
  static constexpr size_t kTileBytes = round128(sizeof(float) * kB * kLd);
  static constexpr size_t kScoreBytes = round128(sizeof(float) * kB * kLds);
  static constexpr size_t kPBytes = round128(sizeof(float) * kB * kLdp);
  static constexpr size_t kAccBytes = round128(sizeof(float) * kB * kLdo);
  static constexpr size_t kStatBytes = round128(sizeof(float) * kB);
  static constexpr size_t kFwd =
      3 * kTileBytes + kScoreBytes + kPBytes + kAccBytes + 2 * kStatBytes;
  static constexpr size_t kDq =
      4 * kTileBytes + 2 * kScoreBytes + kPBytes + kAccBytes + 2 * kStatBytes;
  static constexpr size_t kDkv = 4 * kTileBytes + 2 * kScoreBytes +
                                 2 * kPBytes + 2 * kAccBytes + 2 * kStatBytes;
};

// ---------------------------------------------------------------- forward --

template <typename OT, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashArgs a) {
  using L = Layout<D>;
  constexpr int B = L::kB;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qs = cv.take<float>(B * L::kLd);
  float* ks = cv.take<float>(B * L::kLd);
  float* vs = cv.take<float>(B * L::kLd);
  float* S = cv.take<float>(B * L::kLds);
  float* P = cv.take<float>(B * L::kLdp);
  float* O = cv.take<float>(B * L::kLdo);
  float* m_s = cv.take<float>(B);
  float* l_s = cv.take<float>(B);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int q0 = (gridDim.x - 1 - blockIdx.x) * B;  // longest blocks first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  load_rows<D, B>(qs, qb, a.q_st, q0, g.tq);
  for (int i = threadIdx.x; i < B * D; i += kThreads)
    O[(i / D) * L::kLdo + i % D] = 0.f;
  for (int r = threadIdx.x; r < B; r += kThreads) {
    m_s[r] = kNegBig;
    l_s[r] = 0.f;
  }
  // causal: keys past the tile's last query position are never visible
  const int q_last = min(q0 + B, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += B) {
    load_rows<D, B>(ks, kb, a.k_st, k0, g.tk);
    load_rows<D, B>(vs, vb, a.v_st, k0, g.tk);
    __syncthreads();
    block_mm<B, B, D, false, true, false>(qs, L::kLd, ks, L::kLd, S,
                                             L::kLds);
    __syncthreads();
    // online softmax: one warp per row, B / 32 keys per lane
    for (int r = warp; r < B; r += kWarps) {
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
        // explicit 0: in a row with no visible key so far s == mx == the
        // sentinel, and exp(s - mx) would be 1
        const float p = s[c] <= 0.5f * kNegBig ? 0.f : expf(s[c] - mx);
        p_sum += p;
        P[r * L::kLdp + lane + 32 * c] = p;
      }
      p_sum = warp_sum(p_sum);
      const float corr = expf(m_old - mx);
      for (int d = lane; d < D; d += 32) O[r * L::kLdo + d] *= corr;
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + p_sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();
    block_mm<B, D, B, false, false, true>(P, L::kLdp, vs, L::kLd, O,
                                             L::kLdo);
    __syncthreads();
  }

  OT* out = static_cast<OT*>(a.out);
  for (int i = threadIdx.x; i < B * D; i += kThreads) {
    const int r = i / D, d = i % D, qi = q0 + r;
    if (qi >= g.tq) continue;
    const float l = l_s[r];
    out[((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + d] =
        from_f32<OT>(O[r * L::kLdo + d] / (l == 0.f ? 1.f : l));
  }
  for (int r = threadIdx.x; r < B; r += kThreads) {
    const int qi = q0 + r;
    if (qi >= g.tq) continue;
    const float l = l_s[r];
    a.lse_out[static_cast<int64_t>(bh) * g.tq + qi] =
        l == 0.f ? kNegBig : m_s[r] + logf(l);
  }
}

// --------------------------------------------------------------------- dq --

template <typename OT, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const FlashArgs a) {
  using L = Layout<D>;
  constexpr int B = L::kB;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qs = cv.take<float>(B * L::kLd);
  float* dos = cv.take<float>(B * L::kLd);
  float* ks = cv.take<float>(B * L::kLd);
  float* vs = cv.take<float>(B * L::kLd);
  float* S = cv.take<float>(B * L::kLds);
  float* dP = cv.take<float>(B * L::kLds);
  float* dS = cv.take<float>(B * L::kLdp);
  float* dQ = cv.take<float>(B * L::kLdo);
  float* lse_s = cv.take<float>(B);
  float* dl_s = cv.take<float>(B);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int q0 = (gridDim.x - 1 - blockIdx.x) * B;
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;

  load_rows<D, B>(qs, qb, a.q_st, q0, g.tq);
  load_rows<D, B>(dos, dob, a.do_st, q0, g.tq);
  load_stat<B>(lse_s, a.lse + static_cast<int64_t>(bh) * g.tq, q0, g.tq);
  load_stat<B>(dl_s, a.delta + static_cast<int64_t>(bh) * g.tq, q0, g.tq);
  for (int i = threadIdx.x; i < B * D; i += kThreads)
    dQ[(i / D) * L::kLdo + i % D] = 0.f;
  const int q_last = min(q0 + B, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += B) {
    load_rows<D, B>(ks, kb, a.k_st, k0, g.tk);
    load_rows<D, B>(vs, vb, a.v_st, k0, g.tk);
    __syncthreads();
    block_mm<B, B, D, false, true, false>(qs, L::kLd, ks, L::kLd, S,
                                             L::kLds);
    block_mm<B, B, D, false, true, false>(dos, L::kLd, vs, L::kLd, dP,
                                             L::kLds);
    __syncthreads();
    for (int i = threadIdx.x; i < B * B; i += kThreads) {
      const int r = i / B, j = i % B;
      const float s = S[r * L::kLds + j] * scale;
      // masked p is exactly 0, also when lse is the -1e30 sentinel
      const float p = g.visible(q0 + r, k0 + j) ? expf(s - lse_s[r]) : 0.f;
      dS[r * L::kLdp + j] = p * (dP[r * L::kLds + j] - dl_s[r]);
    }
    __syncthreads();
    block_mm<B, D, B, false, false, true>(dS, L::kLdp, ks, L::kLd, dQ,
                                             L::kLdo);
    __syncthreads();
  }

  OT* dq = static_cast<OT*>(a.dq);
  for (int i = threadIdx.x; i < B * D; i += kThreads) {
    const int r = i / D, d = i % D, qi = q0 + r;
    if (qi >= g.tq) continue;
    dq[((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + d] =
        from_f32<OT>(dQ[r * L::kLdo + d] * scale);
  }
}

// -------------------------------------------------------------------- dkv --

template <typename OT, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const FlashArgs a) {
  using L = Layout<D>;
  constexpr int B = L::kB;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* ks = cv.take<float>(B * L::kLd);
  float* vs = cv.take<float>(B * L::kLd);
  float* qs = cv.take<float>(B * L::kLd);
  float* dos = cv.take<float>(B * L::kLd);
  float* S = cv.take<float>(B * L::kLds);
  float* dP = cv.take<float>(B * L::kLds);
  float* P = cv.take<float>(B * L::kLdp);
  float* dS = cv.take<float>(B * L::kLdp);
  float* dK = cv.take<float>(B * L::kLdo);
  float* dV = cv.take<float>(B * L::kLdo);
  float* lse_s = cv.take<float>(B);
  float* dl_s = cv.take<float>(B);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int k0 = (gridDim.x - 1 - blockIdx.x) * B;
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;

  load_rows<D, B>(ks, kb, a.k_st, k0, g.tk);
  load_rows<D, B>(vs, vb, a.v_st, k0, g.tk);
  for (int i = threadIdx.x; i < B * D; i += kThreads) {
    dK[(i / D) * L::kLdo + i % D] = 0.f;
    dV[(i / D) * L::kLdo + i % D] = 0.f;
  }
  // causal: query rows before the first that sees key k0 see none of the
  // tile
  const int q_begin =
      g.causal ? max(0, k0 + g.k_offset - g.q_offset) / B * B : 0;

  for (int q0 = q_begin; q0 < g.tq; q0 += B) {
    __syncthreads();  // the previous products are done with qs, dos, P, dS
    load_rows<D, B>(qs, qb, a.q_st, q0, g.tq);
    load_rows<D, B>(dos, dob, a.do_st, q0, g.tq);
    load_stat<B>(lse_s, lse, q0, g.tq);
    load_stat<B>(dl_s, delta, q0, g.tq);
    __syncthreads();
    block_mm<B, B, D, false, true, false>(qs, L::kLd, ks, L::kLd, S,
                                             L::kLds);
    block_mm<B, B, D, false, true, false>(dos, L::kLd, vs, L::kLd, dP,
                                             L::kLds);
    __syncthreads();
    for (int i = threadIdx.x; i < B * B; i += kThreads) {
      const int r = i / B, j = i % B;
      const float s = S[r * L::kLds + j] * scale;
      const float p = g.visible(q0 + r, k0 + j) ? expf(s - lse_s[r]) : 0.f;
      P[r * L::kLdp + j] = p;
      dS[r * L::kLdp + j] = p * (dP[r * L::kLds + j] - dl_s[r]);
    }
    __syncthreads();
    block_mm<B, D, B, true, false, true>(P, L::kLdp, dos, L::kLd, dV,
                                            L::kLdo);
    block_mm<B, D, B, true, false, true>(dS, L::kLdp, qs, L::kLd, dK,
                                            L::kLdo);
  }
  __syncthreads();

  OT* dk = static_cast<OT*>(a.dk);
  OT* dv = static_cast<OT*>(a.dv);
  for (int i = threadIdx.x; i < B * D; i += kThreads) {
    const int r = i / D, d = i % D, kj = k0 + r;
    if (kj >= g.tk) continue;
    const int64_t o = ((static_cast<int64_t>(b) * g.tk + kj) * H + h) * D + d;
    dk[o] = from_f32<OT>(dK[r * L::kLdo + d] * scale);
    dv[o] = from_f32<OT>(dV[r * L::kLdo + d]);
  }
}

// ------------------------ bf16 / f16 forward, dq and dk/dv (Hopper) --

#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"

// --------------------------------------------------------------- launchers --

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// The f32 forward, dq and dk/dv kernels.
template <int KIND, typename OT, int D>
cudaError_t launch_simple(const FlashArgs& a, cudaStream_t stream) {
  using L = Layout<D>;
  void (*kern)(const FlashArgs);
  size_t smem;
  int64_t rows;
  if constexpr (KIND == kFwd) {
    kern = flash_fwd_kernel<OT, D>;
    smem = L::kFwd;
    rows = a.tq;
  } else if constexpr (KIND == kDq) {
    kern = flash_dq_kernel<OT, D>;
    smem = L::kDq;
    rows = a.tq;
  } else {
    kern = flash_dkv_kernel<OT, D>;
    smem = L::kDkv;
    rows = a.tk;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<flash_grid(rows, L::kB, a), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND, typename T, typename OT, int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr bool k16 = !std::is_same<T, float>::value;
  if constexpr (k16 && KIND == kFwd)
    return launch_fwd_sm90<T, OT, D>(a, stream);
  else if constexpr (k16 && KIND == kDq)
    return launch_dq_sm90<T, OT, D>(a, stream);
  else if constexpr (k16 && KIND == kDkv)
    return launch_dkv_sm90<T, OT, D>(a, stream);
  else
    return launch_simple<KIND, OT, D>(a, stream);
}

// (input, output) type codes: f32 -> f32 or bf16; bf16 -> bf16 or f32;
// f16 -> f16 or f32.
template <int KIND, int D>
cudaError_t dispatch_types(const FlashArgs& a, cudaStream_t st) {
  const int in = static_cast<int>(a.in_dtype), out = static_cast<int>(a.out_dtype);
  if (in == 1 && out == 1) return launch<KIND, bf16, bf16, D>(a, st);
  if (in == 1 && out == 0) return launch<KIND, bf16, float, D>(a, st);
  if (in == 2 && out == 2) return launch<KIND, half, half, D>(a, st);
  if (in == 2 && out == 0) return launch<KIND, half, float, D>(a, st);
  if (in == 0 && out == 1) return launch<KIND, float, bf16, D>(a, st);
  if (in == 0 && out == 0) return launch<KIND, float, float, D>(a, st);
  return cudaErrorInvalidValue;
}

template <int KIND>
int dispatch(const FlashArgs* a, void* stream) {
  // grid z holds ceil(B * H / 65535) slices of (batch, head) pairs
  if (a->batch < 1 || a->heads < 1 || a->tq < 1 || a->tk < 1 ||
      a->batch * a->heads > int64_t{65535} * 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a->head_dim == 64)
    err = dispatch_types<KIND, 64>(*a, st);
  else if (a->head_dim == 128)
    err = dispatch_types<KIND, 128>(*a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Each returns 0 on a successful launch, else the cudaError_t of the launch.
extern "C" int flash_fwd_launch(const FlashArgs* a, void* stream) {
  return dispatch<kFwd>(a, stream);
}

extern "C" int flash_dq_launch(const FlashArgs* a, void* stream) {
  return dispatch<kDq>(a, stream);
}

extern "C" int flash_dkv_launch(const FlashArgs* a, void* stream) {
  return dispatch<kDkv>(a, stream);
}
