// The f32 forward, dq and dk/dv kernels for Hopper at D = 64, 128 and
// 256: register-tiled FMA products fed by a cp.async ring.
//
// Included by flash_attention.cu inside its anonymous namespace, after
// FlashArgs, Geo, make_geo, Carver and flash_bwd_sm90.cuh (whose
// cp.async helpers, store2 and launch_sm90 it uses); it includes nothing
// itself. They replace the TPU's _fwd_kernel / _bwd_dq_kernel /
// _bwd_dkv_kernel of chainermn_tpu/ops/flash_attention.py for f32 inputs
// (f32 or bf16 outputs) and compute the same functions under the same
// contract (flash_attention.cu's header): plain f32 FMA (never TF32),
// expf, the forward's p = expf(s * scale - m) and the backward's p =
// expf(s * scale - lse) with a masked p exactly 0, ds = p (dp - delta),
// dq and dk scaled once at the write, every output written once with no
// atomics (deterministic).
//
// What bounds them: f32 has no tensor-core path, so the floor is the FMA
// units' 67 TFLOP/s; causal attention at T = 2048 does far more FLOPs per
// byte than that rate needs. So the design keeps the FMA pipes fed:
//   - 256 threads (8 warps) a CTA, one CTA per (batch*head, row tile).
//   - Every product is register-tiled: a thread owns a micro-tile of the
//     output and reads both operands as 16-byte vectors, so it issues
//     (MT + NT) shared loads for 4 MT NT FMAs. A warp covers 8 rows x 4
//     columns of the thread grid: with a row pitch of D + 4 (or the tile
//     + 4) floats the 8 rows' vectors fall in different banks.
//   - The score products (S = Q K^T, dP = dO V^T; S^T and dP^T for dk/dv)
//     reduce over D with both operands read along D; the gradient
//     products (dQ += dS K, dV += P^T dO, dK += dS^T Q) read the score
//     operand along its reduction axis and the other along D. Each
//     output's FMA chain runs in ascending order of its reduction index.
//   - dq: every thread computes its micro-tiles of both S and dP (8 x 4
//     at D = 64, 4 x 4 at 128, 2 x 2 at 256) and forms dS in registers;
//     dS goes through shared memory once a tile to feed dQ += dS K (4 x 4
//     NV per thread). dk/dv: the two 4-warp groups split the work, so a
//     thread holds twice the outputs of one product at the same
//     registers: group 0 computes S^T, writes P^T and accumulates dV,
//     group 1 computes dP^T, reads P^T, writes dS^T and accumulates dK
//     (score micro-tiles 4 x 8, 4 x 4, 2 x 4 at D = 64, 128, 256;
//     gradient 8 x 4, 8 x 8, 4 x 16).
//   - The forward (flash_fwd_f32_sm90) lays S out so that a row's threads
//     (16 at D = 64 and 256, 8 at 128) sit in one warp: the row max and
//     sum are shuffles, m and l stay in registers, and a thread's O rows
//     are its S rows, so O is rescaled in registers and P, written to
//     shared memory for O += P V, is read back by its own warp only (no
//     CTA barrier). Score micro-tiles 4 x 4, 4 x 4, 4 x 2 and O 4 x 4,
//     4 x 16, 4 x 16 a thread at D = 64, 128, 256; one CTA barrier a key
//     tile; O written once, divided by l. At D = 64 two CTAs share an SM
//     (128 registers a thread), which hides more of each CTA's barrier
//     and softmax than larger tiles would.
//   - S and dP stay in registers; only P (forward), dS (dq) or P^T and
//     dS^T (dk/dv) go through shared memory. O, dQ, dK and dV stay in
//     registers for the whole loop and are written once.
//   - The resident tiles (Q for the forward; Q, dO for dq; K, V for
//     dk/dv) are loaded once. The streamed tiles (K, V; Q, dO, lse,
//     delta) come through a 2-stage ring of 16-byte cp.async copies,
//     zero-filled past the sequence: the next tile is in flight while
//     this one is computed. A tile starts with the CTA barrier behind its
//     own copies; only then does the stage the previous tile read take
//     the next tile's copies, so no stage is written while a warp may
//     still read it. A tile takes one CTA barrier in the forward, two in
//     dq and dk/dv (and one more of dk/dv's group 1).
//   - Causal tiles: the forward and dq stop at the last key tile their
//     rows can see, dk/dv starts at the query tile holding the first
//     query that sees its first key (rounded down to the query tile);
//     fully masked tiles are neither read nor computed, and tiles wholly
//     below the diagonal take no mask. The forward and dq issue their
//     longest row tiles first, dk/dv its lowest key tiles (the most
//     causal work) first.
//   - Tiles (the structs below): the forward 64 query rows a CTA with
//     64-key stages at D = 64, 128 with 32 at 128, 64 with 32 at 256
//     (107,520 / 155,648 / 211,968 B); dq 128 query rows a CTA at D = 64,
//     64 at 128, 32 at 256, with 64-key stages (32 at 256); dk/dv 64 keys
//     a CTA (32 at 256) with 64-query stages at 64 and 32 at 128 and 256.
//     Every instance but the forward at D = 64 takes one CTA an SM:
//     174,080 / 220,160 / 204,288 B (dq at 64 / 128 / 256) and 140,288 /
//     154,112 / 209,408 B (dk/dv).

#pragma once

constexpr int kF32Threads = 256;  // eight warps
constexpr int kF32Group = 128;    // the four warps of one product
constexpr int kF32Pad = 4;        // row pitch = width + 4 floats
constexpr int kF32Stages = 2;     // depth of the load ring

// ------------------------------------------------ register-tiled products --

// Thread t's row and column group in a TM x (N / TM) grid of N threads
// (TM a multiple of 8); a warp covers 8 rows x 4 columns of it.
template <int TM>
__device__ __forceinline__ int grid_row(int t) {
  return (t / 32) % (TM / 8) * 8 + t % 8;
}

template <int TM>
__device__ __forceinline__ int grid_col(int t) {
  return (t / 32) / (TM / 8) * 4 + (t % 32) / 8;
}

// Barrier of the 128 threads of product group g (ids 1 and 2; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kF32Group) : "memory");
}

__device__ __forceinline__ float part(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// c[u][v] = (or, when ACC, +=) sum over k = 0 .. K-1, ascending, of
// a[u RS LDA + k] * b[v CS LDB + k]: rows u RS of A and v CS of B, both
// read along k, the k loop unrolled UNROLL times.
template <int MT, int NT, int K, int RS, int CS, int LDA, int LDB,
          bool ACC = false, int UNROLL = 2>
__device__ __forceinline__ void mm_rows(float (&c)[MT][NT], const float* a,
                                        const float* b) {
  if (!ACC) {
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int v = 0; v < NT; ++v) c[u][v] = 0.f;
  }
#pragma unroll UNROLL
  for (int k = 0; k < K; k += 4) {
    float4 x[MT], y[NT];
#pragma unroll
    for (int u = 0; u < MT; ++u)
      x[u] = *reinterpret_cast<const float4*>(a + u * RS * LDA + k);
#pragma unroll
    for (int v = 0; v < NT; ++v)
      y[v] = *reinterpret_cast<const float4*>(b + v * CS * LDB + k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int u = 0; u < MT; ++u)
#pragma unroll
        for (int v = 0; v < NT; ++v)
          c[u][v] = fmaf(part(x[u], e), part(y[v], e), c[u][v]);
  }
}

// c[u][4 v + f] += sum over k = 0 .. K-1, ascending, of a[u RS LDA + k] *
// b[k LDB + v CS + f]: rows u RS of A read along k, B read along its
// columns in groups of 4 (CS apart).
template <int MT, int NV, int K, int RS, int CS, int LDA, int LDB>
__device__ __forceinline__ void mm_acc(float (&c)[MT][4 * NV],
                                       const float* a, const float* b) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 x[MT];
#pragma unroll
    for (int u = 0; u < MT; ++u)
      x[u] = *reinterpret_cast<const float4*>(a + u * RS * LDA + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 y[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        y[v] = *reinterpret_cast<const float4*>(b + (k + e) * LDB + v * CS);
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        const float xe = part(x[u], e);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          c[u][4 * v + 0] = fmaf(xe, y[v].x, c[u][4 * v + 0]);
          c[u][4 * v + 1] = fmaf(xe, y[v].y, c[u][4 * v + 1]);
          c[u][4 * v + 2] = fmaf(xe, y[v].z, c[u][4 * v + 2]);
          c[u][4 * v + 3] = fmaf(xe, y[v].w, c[u][4 * v + 3]);
        }
      }
    }
  }
}

// Rows row0 .. row0+R-1, columns col0 .. col0+W-1 of one (batch, head)
// slice of a [B, T, H, D] f32 input into a shared tile of pitch W +
// kF32Pad, as 16-byte cp.async copies issued by the whole CTA; rows at or
// past n_rows and columns at or past n_cols (a multiple of 4) are
// zero-filled.
template <int R, int W>
__device__ __forceinline__ void load_cols_async(float* dst, const float* src,
                                                int64_t st, int row0,
                                                int n_rows, int col0,
                                                int n_cols) {
  constexpr int kPerRow = W / 4;
  static_assert(R * kPerRow % kF32Threads == 0, "tile / thread mismatch");
#pragma unroll
  for (int j = 0; j < R * kPerRow / kF32Threads; ++j) {
    const int i = threadIdx.x + j * kF32Threads;
    const int r = i / kPerRow, c = (i % kPerRow) * 4, t = row0 + r;
    const bool ok = t < n_rows && col0 + c < n_cols;
    cp_async16(smem_addr(dst + r * (W + kF32Pad) + c),
               ok ? src + t * st + col0 + c : src, ok);
  }
}

// All D columns of rows row0 .. row0+R-1 (pitch D + kF32Pad).
template <int R, int D>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src,
                                                int64_t st, int row0,
                                                int n_rows) {
  load_cols_async<R, D>(dst, src, st, row0, n_rows, 0, D);
}

// Four f32 values of one row, rounded to OT, at p (16-byte aligned for
// f32, 8 for bf16).
template <typename OT>
__device__ __forceinline__ void store4(OT* p, float x, float y, float z,
                                       float w) {
  store2(p, x, y);
  store2(p + 2, z, w);
}

// ---------------------------------------------------------------- forward --

// The forward's thread layout: the TN threads of a row sit in one warp
// (32 / TN rows a warp), so a row's max and sum are shuffles. Thread t
// holds rows t / TN + (kF32Threads / TN) u of S and O, score columns
// t % TN + TN v and O columns 4 (t % TN) + 4 TN v + f. A quarter warp reads
// one row of Q or P (a broadcast) and eight rows of K (pitch D + 4: eight
// bank groups) or 128 contiguous bytes of V, so no read conflicts; P's
// pitch of BK + TN puts a warp's scalar writes in 32 banks.

// x = the max (or sum) of x over the TN lanes of this thread's row.
template <int TN>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < TN; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int TN>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TN; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One key tile of the online softmax, in registers: s holds the thread's
// raw scores (query qi0 + RS u, key kj0 + TN v), masked here unless the
// tile is interior; each row's m and l (identical in the row's TN
// threads) and O rows are rescaled by exp(m_old - m), and p is written
// to the row's P (pw = P + its row * LDP + its first column) for the
// warp's own O += P V, so P needs no CTA barrier.
template <int TN, int SM, int SN, int OW, int LDP>
__device__ __forceinline__ void fwd_softmax(float (&s)[SM][SN],
                                            float (&o)[SM][OW],
                                            float (&m)[SM], float (&l)[SM],
                                            float* pw, bool interior,
                                            const Geo& g, int qi0, int kj0,
                                            float scale) {
  constexpr int RS = kF32Threads / TN;
#pragma unroll
  for (int u = 0; u < SM; ++u) {
    float mx = m[u];
#pragma unroll
    for (int v = 0; v < SN; ++v) {
      const float x = s[u][v] * scale;
      s[u][v] = interior || g.visible(qi0 + RS * u, kj0 + TN * v) ? x
                                                                   : kNegBig;
      mx = fmaxf(mx, s[u][v]);
    }
    mx = row_max<TN>(mx);
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < SN; ++v) {
      // explicit 0: in a row with no visible key so far s == mx == the
      // sentinel, and exp(s - mx) would be 1
      const float p = s[u][v] <= 0.5f * kNegBig ? 0.f : expf(s[u][v] - mx);
      sum += p;
      pw[u * RS * LDP + TN * v] = p;
    }
    sum = row_sum<TN>(sum);
    const float corr = expf(m[u] - mx);
    l[u] = l[u] * corr + sum;
    m[u] = mx;
#pragma unroll
    for (int i = 0; i < OW; ++i) o[u][i] *= corr;
  }
  __syncwarp();
}

// O / l rounded to OT for the thread's rows (columns 4 c + 4 TN v + f of
// row pointers out + row * rs), and lse = m + log(l) from the row's first
// thread (lse != nullptr); a row that saw no key writes 0 and -1e30.
template <int TN, int SM, int NV, typename OT>
__device__ __forceinline__ void fwd_store(const float (&o)[SM][4 * NV],
                                          const float (&m)[SM],
                                          const float (&l)[SM], OT* out,
                                          int64_t rs, float* lse, int qi0,
                                          int tq, int c, int n_cols) {
  constexpr int RS = kF32Threads / TN;
#pragma unroll
  for (int u = 0; u < SM; ++u) {
    const int qi = qi0 + RS * u;
    if (qi >= tq) continue;
    const float d = l[u] == 0.f ? 1.f : l[u];
    OT* row = out + qi * rs;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (4 * c + 4 * TN * v < n_cols)
        store4(row + 4 * c + 4 * TN * v, o[u][4 * v] / d, o[u][4 * v + 1] / d,
               o[u][4 * v + 2] / d, o[u][4 * v + 3] / d);
    if (lse && c == 0) lse[qi] = l[u] == 0.f ? kNegBig : m[u] + logf(l[u]);
  }
}

template <int D>
struct FwdF32Tiles {
  static constexpr int kRows = D == 128 ? 128 : 64;  // query rows a CTA
  static constexpr int kBk = D == 64 ? 64 : 32;      // keys a ring stage
  static constexpr int kTn = D == 128 ? 8 : 16;      // threads of a row
  // D = 64: two CTAs an SM, in 128 registers a thread with the score
  // product's k loop not unrolled
  static constexpr int kCtas = D == 64 ? 2 : 1;
  static constexpr int kUnroll = D == 64 ? 1 : 2;
  static constexpr int kLd = D + kF32Pad;            // q, k, v rows
  static constexpr int kLdp = kBk + kTn;             // P rows
  static constexpr size_t kQ = round128(sizeof(float) * kRows * kLd);
  static constexpr size_t kK = round128(sizeof(float) * kBk * kLd);
  static constexpr size_t kP = round128(sizeof(float) * kRows * kLdp);
  static constexpr size_t kSmem = kQ + kF32Stages * 2 * kK + kP;
  static_assert(kSmem <= kSmemLimit, "f32 forward tiles exceed shared memory");
};

template <typename OT, int D>
__global__ void __launch_bounds__(kF32Threads, FwdF32Tiles<D>::kCtas)
    flash_fwd_f32_sm90(const FlashArgs a) {
  using L = FwdF32Tiles<D>;
  constexpr int R = L::kRows, BK = L::kBk, TN = L::kTn, LD = L::kLd,
                LDP = L::kLdp;
  // S: SM x SN scores a thread; O: SM rows x 4 NV columns
  constexpr int RS = kF32Threads / TN, SM = R / RS, SN = BK / TN,
                NV = D / (4 * TN);
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qs = cv.take<float>(R * LD);
  // stage s: K at ring + s * kStage, V kKf floats on
  constexpr int kKf = L::kK / sizeof(float), kStage = 2 * kKf;
  float* ring = cv.take<float>(kF32Stages * kStage);
  float* ps = cv.take<float>(R * LDP);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;  // longest first
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  // causal: keys past the tile's last query position are never visible
  const int q_last = min(q0 + R, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto load_stage = [&](int it) {
    float* st = ring + (it % kF32Stages) * kStage;
    load_rows_async<BK, D>(st, kb, a.k_st, it * BK, g.tk);
    load_rows_async<BK, D>(st + kKf, vb, a.v_st, it * BK, g.tk);
  };
  if (n_tiles > 0) {
    load_rows_async<R, D>(qs, qb, a.q_st, q0, g.tq);
    load_stage(0);
  }
  cp_async_commit();

  const int sr = threadIdx.x / TN, sc = threadIdx.x % TN;
  float o[SM][4 * NV], m[SM], l[SM];
#pragma unroll
  for (int u = 0; u < SM; ++u) {
    m[u] = kNegBig;
    l[u] = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * NV; ++i) o[u][i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();  // this thread's copies of tile it
    __syncthreads();     // everyone's; every warp is done with tile it - 1
    // the stage tile it - 1 read is free: tile it + 1's copies run while
    // tile it is computed
    if (it + 1 < n_tiles) load_stage(it + 1);
    cp_async_commit();
    const int k0 = it * BK;
    const float* kt = ring + (it % kF32Stages) * kStage;
    // the tile is inside the sequences and wholly below the diagonal
    const bool interior =
        q0 + R <= g.tq && k0 + BK <= g.tk &&
        (!g.causal || g.q_offset + q0 >= g.k_offset + k0 + BK - 1);
    float s[SM][SN];
    mm_rows<SM, SN, D, RS, TN, LD, LD, false, L::kUnroll>(s, qs + sr * LD,
                                                          kt + sc * LD);
    fwd_softmax<TN, SM, SN, 4 * NV, LDP>(s, o, m, l, ps + sr * LDP + sc,
                                         interior, g, q0 + sr, k0 + sc,
                                         scale);
    mm_acc<SM, NV, BK, RS, 4 * TN, LDP, LD>(o, ps + sr * LDP,
                                            kt + kKf + 4 * sc);
  }

  OT* out = static_cast<OT*>(a.out) +
            (static_cast<int64_t>(b) * g.tq * H + h) * D;
  fwd_store<TN, SM, NV>(o, m, l, out, static_cast<int64_t>(H) * D,
                        a.lse_out + static_cast<int64_t>(bh) * g.tq, q0 + sr,
                        g.tq, sc, D);
}

// --------------------------------------------------------------------- dq --

template <int D>
struct DqF32Tiles {
  // query rows a CTA: 128 at D = 64 halves the tiles, and so the
  // barriers, a row's keys take
  static constexpr int kRows = D == 64 ? 128 : D > 128 ? 32 : 64;
  static constexpr int kBk = D > 128 ? 32 : 64;  // keys a ring stage
  static constexpr int kLd = D + kF32Pad;          // q, do, k, v rows
  static constexpr int kLds = kBk + kF32Pad;       // dS rows
  static constexpr size_t kQ = round128(sizeof(float) * kRows * kLd);
  static constexpr size_t kK = round128(sizeof(float) * kBk * kLd);
  static constexpr size_t kDs = round128(sizeof(float) * kRows * kLds);
  static constexpr size_t kSmem = 2 * kQ + kF32Stages * 2 * kK + kDs;
  static_assert(kSmem <= kSmemLimit, "f32 dq tiles exceed shared memory");
};

template <typename OT, int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_dq_f32_sm90(const FlashArgs a) {
  using L = DqF32Tiles<D>;
  constexpr int R = L::kRows, BK = L::kBk, LD = L::kLd, LDS = L::kLds;
  // S and dP: a 16 x 16 thread grid, rows sr + 16u and keys sc + 16v
  constexpr int SM = R / 16, SN = BK / 16;
  // dQ: a QTM x QTN grid, rows qr + QTM u, columns qc + 4 QTN v + f
  constexpr int QTM = R / 4, QTN = kF32Threads / QTM, NV = D / (4 * QTN);
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qs = cv.take<float>(R * LD);
  float* dos = cv.take<float>(R * LD);
  // stage s: K at ring + s * kStage, V kKf floats on
  constexpr int kKf = L::kK / sizeof(float), kStage = 2 * kKf;
  float* ring = cv.take<float>(kF32Stages * kStage);
  float* dss = cv.take<float>(R * LDS);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;  // longest first
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;

  // causal: keys past the tile's last query position are never visible
  const int q_last = min(q0 + R, g.tq) - 1;
  const int k_end =
      g.causal ? max(0, min(g.tk, g.q_offset + q_last - g.k_offset + 1))
               : g.tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto load_stage = [&](int it) {
    float* st = ring + (it % kF32Stages) * kStage;
    load_rows_async<BK, D>(st, kb, a.k_st, it * BK, g.tk);
    load_rows_async<BK, D>(st + kKf, vb, a.v_st, it * BK, g.tk);
  };
  if (n_tiles > 0) {
    load_rows_async<R, D>(qs, qb, a.q_st, q0, g.tq);
    load_rows_async<R, D>(dos, dob, a.do_st, q0, g.tq);
    load_stage(0);
  }
  cp_async_commit();

  const int sr = grid_row<16>(threadIdx.x), sc = grid_col<16>(threadIdx.x);
  const int qr = grid_row<QTM>(threadIdx.x);
  const int qc = 4 * grid_col<QTM>(threadIdx.x);
  float lse_r[SM], dl_r[SM];  // the thread's score rows' statistics
#pragma unroll
  for (int u = 0; u < SM; ++u) {
    const int qi = q0 + sr + 16 * u;
    lse_r[u] = qi < g.tq ? lse[qi] : 0.f;
    dl_r[u] = qi < g.tq ? delta[qi] : 0.f;
  }
  float dq[4][4 * NV];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int i = 0; i < 4 * NV; ++i) dq[u][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();  // this thread's copies of tile it
    __syncthreads();     // everyone's; every warp is done with tile it - 1
    // the stage tile it - 1 read, and dS, are free: tile it + 1's copies
    // run while tile it is computed
    if (it + 1 < n_tiles) load_stage(it + 1);
    cp_async_commit();
    const int k0 = it * BK;
    const float* kt = ring + (it % kF32Stages) * kStage;
    const float* vt = kt + kKf;
    // the tile is inside the sequences and wholly below the diagonal
    const bool interior =
        q0 + R <= g.tq && k0 + BK <= g.tk &&
        (!g.causal || g.q_offset + q0 >= g.k_offset + k0 + BK - 1);
    float s[SM][SN], dp[SM][SN];
    mm_rows<SM, SN, D, 16, 16, LD, LD>(s, qs + sr * LD, kt + sc * LD);
    mm_rows<SM, SN, D, 16, 16, LD, LD>(dp, dos + sr * LD, vt + sc * LD);
#pragma unroll
    for (int u = 0; u < SM; ++u)
#pragma unroll
      for (int v = 0; v < SN; ++v) {
        const int r = sr + 16 * u, j = sc + 16 * v;
        // masked p is exactly 0, also when lse is the -1e30 sentinel
        const float p = interior || g.visible(q0 + r, k0 + j)
                            ? expf(s[u][v] * scale - lse_r[u])
                            : 0.f;
        dss[r * LDS + j] = p * (dp[u][v] - dl_r[u]);
      }
    __syncthreads();
    mm_acc<4, NV, BK, QTM, 4 * QTN, LDS, LD>(dq, dss + qr * LDS, kt + qc);
  }

  OT* dqp = static_cast<OT*>(a.dq);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int qi = q0 + qr + QTM * u;
    if (qi >= g.tq) continue;
    OT* row = dqp + ((static_cast<int64_t>(b) * g.tq + qi) * H + h) * D + qc;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      store4(row + 4 * QTN * v, dq[u][4 * v] * scale,
             dq[u][4 * v + 1] * scale, dq[u][4 * v + 2] * scale,
             dq[u][4 * v + 3] * scale);
  }
}

// -------------------------------------------------------------------- dkv --

template <int D>
struct DkvF32Tiles {
  static constexpr int kRows = D > 128 ? 32 : 64;  // keys a CTA
  static constexpr int kBq = D == 64 ? 64 : 32;    // queries a ring stage
  static constexpr int kLd = D + kF32Pad;          // k, v, q, do rows
  static constexpr int kLdp = kBq + kF32Pad;       // P^T and dS^T rows
  static constexpr size_t kKv = round128(sizeof(float) * kRows * kLd);
  static constexpr size_t kQ = round128(sizeof(float) * kBq * kLd);
  static constexpr size_t kStat = round128(sizeof(float) * kBq);
  static constexpr size_t kP = round128(sizeof(float) * kRows * kLdp);
  static constexpr size_t kStage = 2 * kQ + 2 * kStat;
  static constexpr size_t kSmem = 2 * kKv + kF32Stages * kStage + 2 * kP;
  static_assert(kSmem <= kSmemLimit, "f32 dk/dv tiles exceed shared memory");
};

template <typename OT, int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_dkv_f32_sm90(const FlashArgs a) {
  using L = DkvF32Tiles<D>;
  constexpr int R = L::kRows, BQ = L::kBq, LD = L::kLd, LDP = L::kLdp;
  // S^T (group 0) or dP^T (group 1): a 16 x 8 grid of the group's
  // threads, keys sr + 16u and queries sc + 8v
  constexpr int SM = R / 16, SN = BQ / 8;
  // dV (group 0) or dK (group 1): a KTM x KTN grid of the group's
  // threads, KM keys kr + KTM u and columns kc + 4 KTN v + f each
  constexpr int KM = R / 8, KTM = R / KM, KTN = kF32Group / KTM,
                NV = D / (4 * KTN);
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* ks = cv.take<float>(R * LD);
  float* vs = cv.take<float>(R * LD);
  // stage s at ring + s * kStage: Q, then dO, lse and delta, each
  // 128-byte aligned
  constexpr int kQf = L::kQ / sizeof(float), kStatf = L::kStat / sizeof(float);
  constexpr int kStage = L::kStage / sizeof(float);
  float* ring = cv.take<float>(kF32Stages * kStage);
  float* pts = cv.take<float>(R * LDP);
  float* dsts = cv.take<float>(R * LDP);

  const Geo g = make_geo(a);
  const int H = static_cast<int>(a.heads);
  const int bh = blockIdx.z * gridDim.y + blockIdx.y, b = bh / H, h = bh % H;
  if (bh >= a.batch * a.heads) return;  // the last z-slice's spare CTAs
  const int k0 = blockIdx.x * R;  // low keys: most causal work
  const float scale = static_cast<float>(a.scale);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * g.tq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * g.tq;

  // causal: query rows before the first that sees key k0 see none of the
  // CTA's keys; round down to the query tile
  const int q_begin =
      g.causal ? max(0, k0 + g.k_offset - g.q_offset) / BQ * BQ : 0;
  const int n_tiles = q_begin < g.tq ? (g.tq - q_begin + BQ - 1) / BQ : 0;
  auto load_stage = [&](int it) {
    const int q0 = q_begin + it * BQ;
    float* st = ring + (it % kF32Stages) * kStage;
    load_rows_async<BQ, D>(st, qb, a.q_st, q0, g.tq);
    load_rows_async<BQ, D>(st + kQf, dob, a.do_st, q0, g.tq);
    load_stat_async<BQ>(smem_addr(st + 2 * kQf), lse, q0, g.tq);
    load_stat_async<BQ>(smem_addr(st + 2 * kQf + kStatf), delta, q0, g.tq);
  };
  if (n_tiles > 0) {
    load_rows_async<R, D>(ks, kb, a.k_st, k0, g.tk);
    load_rows_async<R, D>(vs, vb, a.v_st, k0, g.tk);
    load_stage(0);
  }
  cp_async_commit();

  const int grp = threadIdx.x / kF32Group, gt = threadIdx.x % kF32Group;
  const int sr = grid_row<16>(gt), sc = grid_col<16>(gt);
  const int kr = grid_row<KTM>(gt), kc = 4 * grid_col<KTM>(gt);
  float acc[KM][4 * NV];  // dV (group 0) or dK (group 1)
#pragma unroll
  for (int u = 0; u < KM; ++u)
#pragma unroll
    for (int i = 0; i < 4 * NV; ++i) acc[u][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();  // this thread's copies of tile it
    __syncthreads();     // everyone's; every warp is done with tile it - 1
    // the stage tile it - 1 read, P^T and dS^T are free: tile it + 1's
    // copies run while tile it is computed
    if (it + 1 < n_tiles) load_stage(it + 1);
    cp_async_commit();
    const int q0 = q_begin + it * BQ;
    // the tile is inside the sequences and wholly below the diagonal
    const bool interior =
        q0 + BQ <= g.tq && k0 + R <= g.tk &&
        (!g.causal || g.q_offset + q0 >= g.k_offset + k0 + R - 1);
    const float* qt = ring + (it % kF32Stages) * kStage;
    const float* dot = qt + kQf;
    const float* lse_t = qt + 2 * kQf;
    // group 0: S^T = K Q^T; group 1: dP^T = V dO^T
    float x[SM][SN];
    mm_rows<SM, SN, D, 16, 8, LD, LD>(x, (grp ? vs : ks) + sr * LD,
                                      (grp ? dot : qt) + sc * LD);
    if (grp == 0) {
#pragma unroll
      for (int v = 0; v < SN; ++v) {
        const int i = sc + 8 * v;
        const float lse_i = lse_t[i];
#pragma unroll
        for (int u = 0; u < SM; ++u) {
          const int r = sr + 16 * u;
          // masked p is exactly 0, also when lse is the -1e30 sentinel
          pts[r * LDP + i] = interior || g.visible(q0 + i, k0 + r)
                                 ? expf(x[u][v] * scale - lse_i)
                                 : 0.f;
        }
      }
    }
    __syncthreads();
    if (grp == 1) {  // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int v = 0; v < SN; ++v) {
        const int i = sc + 8 * v;
        const float dl_i = lse_t[kStatf + i];
#pragma unroll
        for (int u = 0; u < SM; ++u) {
          const int r = sr + 16 * u;
          dsts[r * LDP + i] = pts[r * LDP + i] * (x[u][v] - dl_i);
        }
      }
      group_sync(1);
    }
    // group 0: dV += P^T dO; group 1: dK += dS^T Q
    mm_acc<KM, NV, BQ, KTM, 4 * KTN, LDP, LD>(
        acc, (grp ? dsts : pts) + kr * LDP, (grp ? qt : dot) + kc);
  }

  // group 0 writes dV, group 1 dK (scaled)
  OT* out = static_cast<OT*>(grp ? a.dk : a.dv);
  const float f = grp ? scale : 1.f;
#pragma unroll
  for (int u = 0; u < KM; ++u) {
    const int kj = k0 + kr + KTM * u;
    if (kj >= g.tk) continue;
    OT* row = out + ((static_cast<int64_t>(b) * g.tk + kj) * H + h) * D + kc;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      store4(row + 4 * KTN * v, acc[u][4 * v] * f, acc[u][4 * v + 1] * f,
             acc[u][4 * v + 2] * f, acc[u][4 * v + 3] * f);
  }
}

// -------------------------------------------------------------- launchers --

template <typename OT, int D>
cudaError_t launch_fwd_f32_sm90(const FlashArgs& a, cudaStream_t stream) {
  return launch_sm90(flash_fwd_f32_sm90<OT, D>, FwdF32Tiles<D>::kSmem, a.tq,
                     FwdF32Tiles<D>::kRows, a, stream);
}

template <typename OT, int D>
cudaError_t launch_dq_f32_sm90(const FlashArgs& a, cudaStream_t stream) {
  return launch_sm90(flash_dq_f32_sm90<OT, D>, DqF32Tiles<D>::kSmem, a.tq,
                     DqF32Tiles<D>::kRows, a, stream);
}

template <typename OT, int D>
cudaError_t launch_dkv_f32_sm90(const FlashArgs& a, cudaStream_t stream) {
  return launch_sm90(flash_dkv_f32_sm90<OT, D>, DkvF32Tiles<D>::kSmem, a.tk,
                     DkvF32Tiles<D>::kRows, a, stream);
}
