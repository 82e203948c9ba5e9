// The 16-bit (bf16 and f16) dq and dk/dv kernels for Hopper: wgmma
// products with register accumulators, fed by an asynchronous multi-stage
// shared-memory ring.
//
// Included by flash_attention.cu inside its anonymous namespace, after
// FlashArgs, Geo, make_geo, flash_grid, bf16 and half; it includes nothing
// itself. They are the dq and dk/dv kernels for bf16 and f16 inputs, the
// element type T a template parameter (wgmma has the f16 form of every
// bf16 shape used here) (TPU: _bwd_dq_kernel /
// _bwd_dkv_kernel of chainermn_tpu/ops/flash_attention.py; f32 inputs take
// flash_dq_kernel / flash_dkv_kernel) and compute the same functions under
// the same contract (flash_attention.cu's header).
//
// Design (two consumer warpgroups, 256 threads; a CTA owns 128 rows of its
// sequence, each warpgroup 64 of them; D = 256 differs as noted):
//   - dk/dv: a CTA per (batch*head, 128-key tile). K and V are loaded once.
//     Q, dO, lse and delta tiles stream through a 3-stage ring, starting at
//     the first query tile that sees the keys. Each warpgroup computes
//     S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in shared memory),
//     then P^T and dS^T = P^T (dP^T - delta) in the accumulator registers,
//     then dV += T(P^T) dO and dK += T(dS^T) Q (wgmma with A in
//     registers, B read through the MN-major flag). dK and dV stay in
//     registers for the whole loop and are written once.
//   - dq: a CTA per (batch*head, 128-query tile). Q, dO, lse and delta are
//     loaded once; K and V tiles of 64 keys stream through the ring up to
//     the causal end. S = Q K^T, dP = dO V^T, P and dS in registers, then
//     dQ += T(dS) K; dQ stays in registers and is written once.
//   - S, P, dP and dS never touch shared memory. The f32 fragment of a
//     product is the A operand of the next: its layout matches wgmma's
//     register-A layout, and rounding it to T is the reference's cast.
//   - Tiles sit in shared memory in the 128-byte swizzle wgmma reads (16-
//     byte chunk c of row r at chunk c ^ (r % 8), 64-column panels).
//     cp.async copies 16 bytes a thread straight into that layout and
//     zero-fills rows past a ragged tail; the copies of the tile
//     STAGES - 1 ahead are in flight while the current tile is computed.
//   - Interior tiles take no mask; the diagonal and tail tiles zero p by
//     predicate from each accumulator element's (row, col).
//   - Every gradient is written once, with no atomics: deterministic.
//   - D = 256 (bf16/f16). The register file, not shared memory, sets the
//     tiles: a warpgroup's 64 x 256 f32 accumulator is 128 registers a
//     thread, and dK plus dV of the same 64 rows would be 256, past the
//     255 a thread may hold. So dk/dv takes 64 keys a CTA, and each
//     warpgroup holds dK and dV for 128 of the 256 columns (128 registers);
//     both warpgroups compute the whole S^T and dP^T of the 64 keys (their
//     products are a third of the kernel's, so half of them are repeated),
//     then multiply by their own column half of Q and dO. dq keeps 128
//     query rows and its 128-register dQ, with 32-key K/V stages so that
//     Q, dO and the 3-stage ring fit in 230,400 B of shared memory. An
//     N = 256 product with A in registers runs as two N = 128 wgmmas on
//     the two column halves (gemm_rs).

#pragma once

constexpr int kSm90Threads = 256;  // two warpgroups
constexpr int kSm90Rows = 128;     // rows of its own sequence a CTA owns
constexpr int kStages = 3;         // depth of the load ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a CTA may use

// ------------------------------------------------------------ PTX helpers --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when !ok (nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's finished cp.async writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// m64nNk16 wgmma on 16-bit inputs (bf16 or f16, spelled TY in the PTX),
// f32 accumulators (N / 2 registers a thread).
// mma_ss: d = A B (+ d when acc), A and B K-major in shared memory.
// mma_rs: d += A B, A in registers, B MN-major in shared memory.
#define CMN_MMA_SS_N32(TY)                                                \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      " %8, %9, %10, %11, %12, %13, %14, %15}, "                          \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                \
      : "l"(a), "l"(b), "r"(acc))

#define CMN_MMA_SS_N64(TY)                                                \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                           \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                         \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                         \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                \
      : "l"(a), "l"(b), "r"(acc))

#define CMN_MMA_RS_N64(TY)                                                \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                           \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                         \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                         \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                \
      : "r"(f[0]), "r"(f[1]), "r"(f[2]), "r"(f[3]), "l"(b), "r"(1))

#define CMN_MMA_RS_N128(TY)                                               \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                           \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                         \
      " %24, %25, %26, %27, %28, %29, %30, %31, "                         \
      " %32, %33, %34, %35, %36, %37, %38, %39, "                         \
      " %40, %41, %42, %43, %44, %45, %46, %47, "                         \
      " %48, %49, %50, %51, %52, %53, %54, %55, "                         \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                        \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                       \
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),   \
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),   \
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]), \
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]), \
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]), \
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]), \
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), \
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]), \
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]), \
        "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]), \
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]), \
        "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]), \
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]), \
        "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]), \
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]), \
        "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63]) \
      : "r"(f[0]), "r"(f[1]), "r"(f[2]), "r"(f[3]), "l"(b), "r"(1))

template <typename T>
constexpr bool kIsHalf = std::is_same<T, half>::value;

template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a,
                                       uint64_t b, int acc) {
  if constexpr (kIsHalf<T>)
    CMN_MMA_SS_N32("f16");
  else
    CMN_MMA_SS_N32("bf16");
}

template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int acc) {
  if constexpr (kIsHalf<T>)
    CMN_MMA_SS_N64("f16");
  else
    CMN_MMA_SS_N64("bf16");
}

template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&f)[4],
                                       uint64_t b) {
  if constexpr (kIsHalf<T>)
    CMN_MMA_RS_N64("f16");
  else
    CMN_MMA_RS_N64("bf16");
}

// N = 128 into the accumulator's elements O .. O + 63 (O = 64: the second
// column half of an N = 256 accumulator, gemm_rs).
template <typename T, int O, int NR>
__device__ __forceinline__ void mma_rs128(float (&d)[NR],
                                          const uint32_t (&f)[4],
                                          uint64_t b) {
  static_assert(O + 64 <= NR, "accumulator half");
  if constexpr (kIsHalf<T>)
    CMN_MMA_RS_N128("f16");
  else
    CMN_MMA_RS_N128("bf16");
}

template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[64],
                                       const uint32_t (&f)[4],
                                       uint64_t b) {
  mma_rs128<T, 0>(d, f, b);
}

// ------------------------------------------------------------ tile layout --

// Byte offset of 16-byte chunk c of row r in an [R, D] 16-bit tile held as
// D / 64 panels of R rows x 128 bytes, swizzled (panels 1024-aligned).
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Rows row0 .. row0+R-1 of one (batch, head) slice of a [B, T, H, D]
// input, zero past n_rows, issued as cp.async by the whole CTA.
template <int R, int D, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          int64_t st, int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  static_assert(R * kChunks % kSm90Threads == 0, "tile / thread mismatch");
#pragma unroll
  for (int j = 0; j < R * kChunks / kSm90Threads; ++j) {
    const int i = threadIdx.x + j * kSm90Threads;
    const int r = i / kChunks, c = i % kChunks, t = row0 + r;
    const bool ok = t < n_rows;
    cp_async16(dst + swz<R>(r, c), ok ? src + t * st + c * 8 : src, ok);
  }
}

// R entries of a [B, H, Tq] row statistic from row0 (0 past n_rows).
template <int R>
__device__ __forceinline__ void load_stat_async(uint32_t dst,
                                                const float* src, int row0,
                                                int n_rows) {
  for (int r = threadIdx.x; r < R; r += kSm90Threads) {
    const bool ok = row0 + r < n_rows;
    cp_async4(dst + 4 * r, ok ? src + row0 + r : src, ok);
  }
}

// Operand A or B, K-major (R rows x D, D contiguous): rows row0 .. +63 (A)
// or all N rows (B), k-step kk = D columns 16kk .. 16kk+15.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  return gmma_desc(tile + (kk >> 2) * (R * 128) + row0 * 128 + (kk & 3) * 32,
                   16, 1024);
}

// Operand B, MN-major: the tile's rows are the product's K, its D columns
// the product's N; k-step kk = rows 16kk .. 16kk+15.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 2048, R * 128, 1024);
}

// Two f32 values rounded to T (bf16 or f16) and packed in one register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// d = A B (d += A B when acc) over K = 16 * KS: A = rows a_row0 .. +63 of
// an R_A-row tile, B all rows of an R_B-row tile, both K-major. Issues;
// the caller commits.
template <typename T, int R_A, int R_B, int KS, int NR>
__device__ __forceinline__ void gemm_ss(float (&d)[NR], uint32_t a_tile,
                                        int a_row0, uint32_t b_tile,
                                        bool acc = false) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    mma_ss<T>(d, desc_k<R_A>(a_tile, a_row0, kk), desc_k<R_B>(b_tile, 0, kk),
           kk > 0 || acc);
}

// The A fragments of p rounded to T: p is an f32 accumulator fragment
// [64, 8 KS]; k-step kk takes its columns 16kk .. 16kk+15.
template <typename T, int KS>
__device__ __forceinline__ void to_a_frags(uint32_t (&f)[KS][4],
                                           const float (&p)[KS * 8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[kk][j] = pack2<T>(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
}

// d += A B: A the register fragments, B an R_B-row tile read MN-major.
// N = 256 (NR = 128) runs as two N = 128 products, one on each column
// half: B's panels 0-1 and 2-3, d's elements 0..63 and 64..127 (element i
// of an N = 256 fragment is element i - 64 of the second half's, 128
// columns on: frag_col(i) = 128 + frag_col(i - 64)).
template <typename T, int R_B, int KS, int NR>
__device__ __forceinline__ void gemm_rs(float (&d)[NR],
                                        const uint32_t (&f)[KS][4],
                                        uint32_t b_tile) {
  if constexpr (NR == 128) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mma_rs128<T, 0>(d, f[kk], desc_mn<R_B>(b_tile, kk));
      mma_rs128<T, 64>(d, f[kk], desc_mn<R_B>(b_tile + 2 * R_B * 128, kk));
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma_rs<T>(d, f[kk], desc_mn<R_B>(b_tile, kk));
  }
}

// Accumulator element i of a thread: row (within the warpgroup's 64) and
// column, per the wgmma m64nNk16 f32 layout.
__device__ __forceinline__ int frag_row(int i) {
  const int lt = threadIdx.x % 128;
  return (lt / 32) * 16 + (lt % 32) / 4 + 8 * ((i / 2) % 2);
}

__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + (i % 2);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store2(half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// -------------------------------------------------------------------- dkv --

template <int D>
struct DkvTiles {
  // D = 256: 64 keys a CTA, each warpgroup dK and dV of half the columns
  static constexpr bool kColSplit = D > 128;
  static constexpr int kRows = kColSplit ? 64 : kSm90Rows;  // keys a CTA
  static constexpr int kCols = kColSplit ? D / 2 : D;  // dK/dV columns a wg
  static constexpr int kBq = D == 64 ? 64 : 32;  // query rows a stage
  static constexpr uint32_t kKv = kRows * D * 2;      // bytes of K or V
  static constexpr uint32_t kQ = kBq * D * 2;         // of Q or dO
  static constexpr uint32_t kStage = (2 * kQ + 2 * kBq * 4 + 1023) / 1024 * 1024;
  static constexpr size_t kSmem = 2 * kKv + kStages * kStage + 1024;
  static_assert(kSmem <= kSmemLimit, "dk/dv tiles exceed shared memory");
};

template <typename T, typename OT, int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dkv_kernel_sm90(const FlashArgs a) {
  using L = DkvTiles<D>;
  constexpr int BQ = L::kBq, NC = L::kCols;
  extern __shared__ __align__(128) unsigned char smem90[];
  const uint32_t raw = smem_addr(smem90);
  const uint32_t ks = (raw + 1023) & ~1023u, vs = ks + L::kKv,
                 ring = vs + L::kKv;

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int k0 = blockIdx.x * L::kRows;  // low keys: most causal work
  const int wg = threadIdx.x / 128;
  // the warpgroup's 64 keys (their first row in the K/V tile) and its
  // dK/dV columns c0 .. c0 + NC - 1 (their panels' offset in a Q/dO stage)
  const int kr0 = L::kColSplit ? 0 : wg * 64, kw0 = k0 + kr0;
  const int c0 = L::kColSplit ? wg * NC : 0;
  const uint32_t c_off = (c0 / 64) * BQ * 128;
  const float scale = static_cast<float>(a.scale), sl2 = scale * kLog2e;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;

  // causal: query rows before the first that sees key k0 see none of them
  const int q_begin =
      g.causal ? max(0, k0 + g.k_offset - g.q_offset) / BQ * BQ : 0;
  const int n_tiles = q_begin < g.tq ? (g.tq - q_begin + BQ - 1) / BQ : 0;
  auto load_stage = [&](int it) {
    const int q0 = q_begin + it * BQ;
    const uint32_t st = ring + (it % kStages) * L::kStage;
    load_tile<BQ, D>(st, qb, a.q_st, q0, g.tq);
    load_tile<BQ, D>(st + L::kQ, dob, a.do_st, q0, g.tq);
    load_stat_async<BQ>(st + 2 * L::kQ, lse, q0, g.tq);
    load_stat_async<BQ>(st + 2 * L::kQ + 4 * BQ, delta, q0, g.tq);
  };
  if (n_tiles > 0) {
    load_tile<L::kRows, D>(ks, kb, a.k_st, k0, g.tk);
    load_tile<L::kRows, D>(vs, vb, a.v_st, k0, g.tk);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage(s);
    cp_async_commit();
  }

  float dk[NC / 2], dv[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) load_stage(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of tile it
    fence_async_smem();
    __syncthreads();               // everyone's
    const int q0 = q_begin + it * BQ;
    const uint32_t qs = ring + (it % kStages) * L::kStage, dos = qs + L::kQ;
    const float* lse_s =
        reinterpret_cast<const float*>(smem90 + (qs + 2 * L::kQ - raw));
    const float* dl_s = lse_s + BQ;
    // warpgroup-uniform: does any row of the tile see one of its keys?
    const bool active =
        kw0 < g.tk && (!g.causal || g.q_offset + min(q0 + BQ, g.tq) - 1 >=
                                        g.k_offset + kw0);
    if (active) {
      const bool interior = q0 + BQ <= g.tq && kw0 + 64 <= g.tk &&
                            (!g.causal || g.q_offset + q0 >= g.k_offset +
                                                                 kw0 + 63);
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
      gemm_ss<T, L::kRows, BQ, D / 16>(s, ks, kr0, qs);    // S^T = K Q^T
      wgmma_commit();
      gemm_ss<T, L::kRows, BQ, D / 16>(dp, vs, kr0, dos);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(s);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        s[i] = exp2f(fmaf(s[i], sl2, -lse_s[frag_col(i)] * kLog2e));
      // masked p is exactly 0, also when lse is the -1e30 sentinel; one
      // branch around the whole mask keeps the exp loop straight-line code
      if (!interior) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i)
          if (!g.visible(q0 + frag_col(i), kw0 + frag_row(i))) s[i] = 0.f;
      }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) dp[i] = s[i] * (dp[i] - dl_s[frag_col(i)]);
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_a_frags<T, BQ / 16>(pa, s);   // p rounded to do's type
      to_a_frags<T, BQ / 16>(da, dp);  // ds rounded to q's type
      wgmma_fence();
      gemm_rs<T, BQ, BQ / 16>(dv, pa, dos + c_off);  // dV += P^T dO
      gemm_rs<T, BQ, BQ / 16>(dk, da, qs + c_off);   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
      reg_fence(pa);
      reg_fence(da);
    }
    __syncthreads();  // the stage is free for the copies of tile it + 3
  }
  cp_async_wait<0>();

  OT* dkp = static_cast<OT*>(a.dk);
  OT* dvp = static_cast<OT*>(a.dv);
#pragma unroll
  for (int i = 0; i < NC / 2; i += 2) {
    const int kj = kw0 + frag_row(i);
    if (kj >= g.tk) continue;
    const int64_t o =
        ((static_cast<int64_t>(b) * g.tk + kj) * H + h) * D + c0 + frag_col(i);
    store2(dkp + o, dk[i] * scale, dk[i + 1] * scale);
    store2(dvp + o, dv[i], dv[i + 1]);
  }
}

// --------------------------------------------------------------------- dq --

template <int D>
struct DqTiles {
  static constexpr int kBk = D > 128 ? 32 : 64;      // key rows a stage
  static constexpr uint32_t kQ = kSm90Rows * D * 2;  // bytes of Q or dO
  static constexpr uint32_t kK = kBk * D * 2;        // of K or V
  static constexpr uint32_t kStage = 2 * kK;
  static constexpr size_t kSmem = 2 * kQ + kStages * kStage + 1024;
  static_assert(kSmem <= kSmemLimit, "dq tiles exceed shared memory");
};

template <typename T, typename OT, int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dq_kernel_sm90(const FlashArgs a) {
  using L = DqTiles<D>;
  constexpr int BK = L::kBk;
  extern __shared__ __align__(128) unsigned char smem90[];
  const uint32_t raw = smem_addr(smem90);
  const uint32_t qs = (raw + 1023) & ~1023u, dos = qs + L::kQ,
                 ring = dos + L::kQ;

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kSm90Rows;  // longest first
  const int wg = threadIdx.x / 128, qw0 = q0 + wg * 64;
  const float scale = static_cast<float>(a.scale), sl2 = scale * kLog2e;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;

  // causal: keys past the tile's last query position are never visible
  const int q_last = min(q0 + kSm90Rows, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto load_stage = [&](int it) {
    const uint32_t st = ring + (it % kStages) * L::kStage;
    load_tile<BK, D>(st, kb, a.k_st, it * BK, g.tk);
    load_tile<BK, D>(st + L::kK, vb, a.v_st, it * BK, g.tk);
  };
  if (n_tiles > 0) {
    load_tile<kSm90Rows, D>(qs, qb, a.q_st, q0, g.tq);
    load_tile<kSm90Rows, D>(dos, dob, a.do_st, q0, g.tq);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage(s);
    cp_async_commit();
  }
  // this thread's two rows' statistics (0 past Tq)
  float lse2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qi = qw0 + frag_row(2 * e);
    lse2[e] = qi < g.tq ? lse[qi] * kLog2e : 0.f;
    dl[e] = qi < g.tq ? delta[qi] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) load_stage(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    fence_async_smem();
    __syncthreads();
    const int k0 = it * BK;
    const uint32_t kst = ring + (it % kStages) * L::kStage, vst = kst + L::kK;
    const bool active =
        qw0 < g.tq && (!g.causal || g.q_offset + min(qw0 + 64, g.tq) - 1 >=
                                        g.k_offset + k0);
    if (active) {
      const bool interior = qw0 + 64 <= g.tq && k0 + BK <= g.tk &&
                            (!g.causal || g.q_offset + qw0 >= g.k_offset +
                                                                  k0 + BK - 1);
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
      gemm_ss<T, kSm90Rows, BK, D / 16>(s, qs, wg * 64, kst);  // S = Q K^T
      wgmma_commit();
      gemm_ss<T, kSm90Rows, BK, D / 16>(dp, dos, wg * 64, vst);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(s);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] = exp2f(fmaf(s[i], sl2, -lse2[(i / 2) % 2]));
      if (!interior) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (!g.visible(qw0 + frag_row(i), k0 + frag_col(i))) s[i] = 0.f;
      }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);
      uint32_t da[BK / 16][4];
      to_a_frags<T, BK / 16>(da, dp);  // ds rounded to k's type
      wgmma_fence();
      gemm_rs<T, BK, BK / 16>(dq, da, kst);  // dQ += dS K
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
  for (int i = 0; i < D / 2; i += 2) {
    const int qi = qw0 + frag_row(i);
    if (qi >= g.tq) continue;
    const int64_t o =
        ((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + frag_col(i);
    store2(dqp + o, dq[i] * scale, dq[i + 1] * scale);
  }
}

// -------------------------------------------------------------- launchers --

// Launches kern with `smem` bytes of dynamic shared memory (each
// instance's own size), a CTA per `tile` of the `rows`.
template <typename K>
cudaError_t launch_sm90(K kern, size_t smem, int64_t rows, int tile,
                        const FlashArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<flash_grid(rows, tile, a), kSm90Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename OT, int D>
cudaError_t launch_dq_sm90(const FlashArgs& a, cudaStream_t stream) {
  return launch_sm90(flash_dq_kernel_sm90<T, OT, D>, DqTiles<D>::kSmem, a.tq,
                     kSm90Rows, a, stream);
}

template <typename T, typename OT, int D>
cudaError_t launch_dkv_sm90(const FlashArgs& a, cudaStream_t stream) {
  return launch_sm90(flash_dkv_kernel_sm90<T, OT, D>, DkvTiles<D>::kSmem,
                     a.tk, DkvTiles<D>::kRows, a, stream);
}
