// Flash attention for Hopper (sm_90a): the forward, dq and dk/dv kernels,
// bound to Python with ctypes by chainermn_torch/ops/flash_attention.py.
//
// Replaces the Pallas TPU kernels of chainermn_tpu/ops/flash_attention.py
// (f32 kernels named; the bf16 and f16 ones in the headers below):
//   flash_fwd_f32_sm90  <- _fwd_kernel      (launched by _fwd)
//   flash_dq_f32_sm90   <- _bwd_dq_kernel   (launched by _dq_call)
//   flash_dkv_f32_sm90  <- _bwd_dkv_kernel  (launched by _dkv_call)
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
// in that type or f32 (f32 inputs may also write bf16), D = 64, 128, 256 or
// any multiple of 64 past 256 (flash_wide.cuh; the wrapper pads every
// other head dim up to the next of these with zero lanes), any Tq and Tk,
// and any B * H: the (batch, head) pairs run on grid y and, past 65535 of
// them, on grid z as well (flash_grid).
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
// while the current one is computed. f32 has no tensor-core path, so its
// floor is the FMA units' rate: the f32 forward, dq and dk/dv
// (flash_f32_sm90.cuh: flash_fwd_f32_sm90, flash_dq_f32_sm90,
// flash_dkv_f32_sm90) run register-tiled FMA products fed by a 2-stage
// cp.async ring, with S (and dP) in registers, the forward's online
// softmax in registers and O there for the whole key loop; past D = 256
// the f32 forward (flash_wide.cuh: flash_fwd_wide_f32_sm90) runs the same
// tiles on 256-column slices of O, and the f32 dq and dk/dv
// (flash_dq_cluster_f32_sm90, flash_dkv_cluster_f32_sm90) run them on
// 256-column slices as thread-block clusters whose CTAs share the score
// tiles and exchange dS through distributed shared memory. Every kernel is
// one thread block per (batch*head, row or key tile, and past 256 column
// slice) with the TPU's sequential grid axis as a loop inside it, so no
// state crosses blocks (past a cluster's exchange of score tiles)
// and every output is written once, with no atomics (deterministic);
// causal blocks stop at the last key tile a query tile can see, ragged Tq
// / Tk are masked in the tail tiles, and the blocks with the most causal
// work are issued first.

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

constexpr float kNegBig = -1e30f;

using bf16 = __nv_bfloat16;

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

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// ------------------------ bf16 / f16 forward, dq and dk/dv (Hopper) --

#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"

// ------------------------ f32 forward, dq and dk/dv up to D = 256 (Hopper) --

#include "flash_f32_sm90.cuh"

// ------------------ head dims past 256, every input type (flash_wide.cuh) --

#include "flash_wide.cuh"

// --------------------------------------------------------------- launchers --

// D = kWide: any multiple of 64 past 256 (flash_wide.cuh).
constexpr int kWide = 0;

template <int KIND, typename T, typename OT, int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr bool k16 = !std::is_same<T, float>::value;
  if constexpr (D == kWide)
    return launch_wide<KIND, T, OT>(a, stream);
  else if constexpr (k16 && KIND == kFwd)
    return launch_fwd_sm90<T, OT, D>(a, stream);
  else if constexpr (k16 && KIND == kDq)
    return launch_dq_sm90<T, OT, D>(a, stream);
  else if constexpr (k16 && KIND == kDkv)
    return launch_dkv_sm90<T, OT, D>(a, stream);
  else if constexpr (KIND == kDq)
    return launch_dq_f32_sm90<OT, D>(a, stream);
  else if constexpr (KIND == kDkv)
    return launch_dkv_f32_sm90<OT, D>(a, stream);
  else
    return launch_fwd_f32_sm90<OT, D>(a, stream);
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
  last_cluster = 1;
  cudaError_t err;
  if (a->head_dim == 64)
    err = dispatch_types<KIND, 64>(*a, st);
  else if (a->head_dim == 128)
    err = dispatch_types<KIND, 128>(*a, st);
  else if (a->head_dim == 256)
    err = dispatch_types<KIND, 256>(*a, st);
  else if (a->head_dim > 256 && a->head_dim % kChunk == 0)
    err = dispatch_types<KIND, kWide>(*a, st);
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

// The thread-block cluster size of the last successful launch above (1:
// the kernel ran without a cluster).
extern "C" int flash_last_cluster() { return last_cluster; }
