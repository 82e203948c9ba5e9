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
// l sums the unscaled p. Softmax state (m, l, acc) and the PV product are
// f32 (p is never rounded to a narrower type), masked p is exactly 0, and
// a row with l == 0 writes 0.
//
// What bounds it: decode attention does ~2 flops per byte of KV it reads,
// far below the H100's ~295 flops/byte ridge, so the time floor is the KV
// bytes of each row's live blocks over the memory rate
// (bytes_read_model's "kernel_bytes"). The design reads only those bytes:
//   - one thread block per (row b, head h) -- not the TPU kernel's heads
//     folded into rows, which Mosaic forced and which costs H x the work;
//   - a loop inside the block walks positions 0 .. min(len, n_j*bs)-1 in
//     tiles of 32 keys and reads table[b, p / bs] itself, so blocks past
//     the row's length are never touched (this replaces the TPU kernel's
//     scalar-prefetched index map and its clamp);
//   - K and V are read once from device memory in their storage type
//     (int8 stays int8 on the wire) and widened to f32 in shared memory;
//   - all S queries of the row share each tile, so S = 1 decode and S > 1
//     windows run the same kernel.
// It is a simple first kernel: no TMA, wgmma or split-K yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileKeys = 32;  // one warp lane per key in the softmax step
constexpr int kMaxQueries = 8;
constexpr float kNegBig = -1e30f;

static_assert(kTileKeys == 32, "the softmax step maps one lane to a key");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
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

// Floats of dynamic shared memory one block needs for S queries.
__host__ __device__ constexpr int smem_floats(int s, int d) {
  return 2 * s * d                     // qs, acc
         + kTileKeys * (d + 1)         // ks (padded rows: no bank conflicts)
         + kTileKeys * d               // vs
         + s * kTileKeys               // scores, then p
         + 3 * s                       // m, l, correction
         + 2 * kTileKeys;              // k and v scales of the tile
}

template <typename QT, typename KVT, int D, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
                    const KVT* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, QT* __restrict__ out,
                    int S, int H, int bs, int table_stride, int n_j,
                    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* acc = qs + S * D;
  float* ks = acc + S * D;
  float* vs = ks + kTileKeys * (D + 1);
  float* ps = vs + kTileKeys * D;
  float* m_s = ps + S * kTileKeys;
  float* l_s = m_s + S;
  float* c_s = l_s + S;
  float* ksc = c_s + S;
  float* vsc = ksc + kTileKeys;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int len = lengths[b];
  const int n_live = min((max(len, 0) + bs - 1) / bs, n_j);
  const int kv_end = min(len, n_live * bs);
  const int q_pos0 = len - S;
  const int* trow = table + static_cast<int64_t>(b) * table_stride;

  for (int i = tid; i < S * D; i += kThreads) {
    const int sq = i / D, d = i % D;
    qs[i] = to_f32(q[((static_cast<int64_t>(b) * S + sq) * H + h) * D + d]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < S; i += kThreads) {
    m_s[i] = kNegBig;
    l_s[i] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < kv_end; t0 += kTileKeys) {
    const int nt = min(kTileKeys, kv_end - t0);
    // K/V tile: neighbouring threads read neighbouring d of one row
    for (int i = tid; i < nt * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const int p = t0 + t;
      const int64_t row = static_cast<int64_t>(trow[p / bs]) * bs + p % bs;
      const int64_t idx = (row * H + h) * D + d;
      ks[t * (D + 1) + d] = to_f32(k[idx]);
      vs[t * D + d] = to_f32(v[idx]);
    }
    if (QUANT) {
      for (int t = tid; t < nt; t += kThreads) {
        const int p = t0 + t;
        const int64_t row =
            static_cast<int64_t>(trow[p / bs]) * bs + p % bs;
        ksc[t] = k_scale[row * H + h];
        vsc[t] = v_scale[row * H + h];
      }
    }
    __syncthreads();

    // scores: one thread per (query, key)
    for (int i = tid; i < S * nt; i += kThreads) {
      const int sq = i / nt, t = i % nt;
      const float* qr = qs + sq * D;
      const float* kr = ks + t * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float s = dot * scale;
      if (QUANT) s *= ksc[t];
      if (t0 + t > q_pos0 + sq) s = kNegBig;  // causal mask
      ps[sq * kTileKeys + t] = s;
    }
    __syncthreads();

    // online softmax: one warp per query row, one lane per key
    for (int sq = warp; sq < S; sq += kThreads / 32) {
      const float s = lane < nt ? ps[sq * kTileKeys + lane] : kNegBig;
      const float m_old = m_s[sq];
      const float m_new = fmaxf(m_old, warp_max(s));
      float p = (lane < nt && s > 0.5f * kNegBig) ? expf(s - m_new) : 0.f;
      const float p_sum = warp_sum(p);
      if (QUANT) p *= vsc[lane];
      if (lane < nt) ps[sq * kTileKeys + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[sq] = corr;
        l_s[sq] = l_s[sq] * corr + p_sum;
        m_s[sq] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V, f32 throughout
    for (int i = tid; i < S * D; i += kThreads) {
      const int sq = i / D, d = i % D;
      const float* pr = ps + sq * kTileKeys;
      float a = acc[i] * c_s[sq];
      for (int t = 0; t < nt; ++t) a = fmaf(pr[t], vs[t * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < S * D; i += kThreads) {
    const int sq = i / D, d = i % D;
    const float l = l_s[sq];
    store_f32(acc[i] / (l == 0.f ? 1.f : l),
              out + ((static_cast<int64_t>(b) * S + sq) * H + h) * D + d);
  }
}

template <typename QT, typename KVT, int D, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* table, const void* lengths, void* out, int B,
                   int S, int H, int bs, int table_stride, int n_j,
                   float scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  const size_t smem = sizeof(float) * smem_floats(S, D);
  paged_decode_kernel<QT, KVT, D, QUANT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<QT*>(out), S, H, bs,
      table_stride, n_j, scale);
  return cudaGetLastError();
}

template <typename QT, typename KVT, bool QUANT>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* k_scale, const void* v_scale,
                     const void* table, const void* lengths, void* out,
                     int B, int S, int H, int bs, int table_stride, int n_j,
                     float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<QT, KVT, 64, QUANT>(q, k, v, k_scale, v_scale, table,
                                      lengths, out, B, S, H, bs,
                                      table_stride, n_j, scale, stream);
  if (D == 128)
    return launch<QT, KVT, 128, QUANT>(q, k, v, k_scale, v_scale, table,
                                       lengths, out, B, S, H, bs,
                                       table_stride, n_j, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, int D, const void* q, const void* k,
                      const void* v, const void* k_scale,
                      const void* v_scale, const void* table,
                      const void* lengths, void* out, int B, int S, int H,
                      int bs, int table_stride, int n_j, float scale,
                      cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_d<QT, float, false>(D, q, k, v, k_scale, v_scale, table,
                                        lengths, out, B, S, H, bs,
                                        table_stride, n_j, scale, stream);
    case 1:
      return launch_d<QT, __nv_bfloat16, false>(
          D, q, k, v, k_scale, v_scale, table, lengths, out, B, S, H, bs,
          table_stride, n_j, scale, stream);
    case 2:
      return launch_d<QT, int8_t, true>(D, q, k, v, k_scale, v_scale, table,
                                        lengths, out, B, S, H, bs,
                                        table_stride, n_j, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (stores only).
// Returns 0 on a successful launch, else the cudaError_t of the launch.
extern "C" int paged_decode_launch(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* table,
                                   const void* lengths, void* out, int B,
                                   int S, int H, int D, int bs,
                                   int table_stride, int n_j, float scale,
                                   int q_dtype, int kv_dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || S > kMaxQueries || bs < 1 || n_j < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0)
    err = launch_kv<float>(kv_dtype, D, q, k, v, k_scale, v_scale, table,
                           lengths, out, B, S, H, bs, table_stride, n_j,
                           scale, st);
  else if (q_dtype == 1)
    err = launch_kv<__nv_bfloat16>(kv_dtype, D, q, k, v, k_scale, v_scale,
                                   table, lengths, out, B, S, H, bs,
                                   table_stride, n_j, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int paged_decode_max_queries() { return kMaxQueries; }
