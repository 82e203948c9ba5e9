// Native batch assembly for the input pipeline.
//
// The reference feeds its ImageNet example through Chainer's
// MultiprocessIterator (worker processes doing decode + batch assembly,
// SURVEY.md S2.15); the TPU rebuild's equivalent offloads the per-batch
// gather + uint8->float normalize to C++ threads with the GIL released
// (ctypes releases it around foreign calls), so the Python training loop
// only hands out indices and receives ready float batches. See
// dataloader.py for the prefetching iterator built on top.
//
// C ABI (all plain pointers; caller owns every buffer):
//   dl_gather_f32(base, rec_elems, channels, idx, n, mean, stdinv, out,
//                 n_threads)
//     out[i*rec_elems + e] = ((float)base[idx[i]*rec_elems + e] / 255.f
//                             - mean[e % channels]) * stdinv[e % channels]
//   dl_gather_u8(base, rec_elems, idx, n, out, n_threads)
//     raw record gather (no conversion).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void gather_f32_range(const uint8_t* base, uint64_t rec_elems,
                      uint64_t channels, const int64_t* idx,
                      const float* mean, const float* stdinv, float* out,
                      uint64_t lo, uint64_t hi) {
  for (uint64_t i = lo; i < hi; ++i) {
    const uint8_t* src = base + (uint64_t)idx[i] * rec_elems;
    float* dst = out + i * rec_elems;
    for (uint64_t e = 0; e < rec_elems; ++e) {
      uint64_t c = e % channels;
      dst[e] = ((float)src[e] * (1.0f / 255.0f) - mean[c]) * stdinv[c];
    }
  }
}

void gather_u8_range(const uint8_t* base, uint64_t rec_elems,
                     const int64_t* idx, uint8_t* out, uint64_t lo,
                     uint64_t hi) {
  for (uint64_t i = lo; i < hi; ++i) {
    std::memcpy(out + i * rec_elems, base + (uint64_t)idx[i] * rec_elems,
                rec_elems);
  }
}

template <typename Fn>
void run_threaded(uint64_t n, int n_threads, Fn fn) {
  if (n_threads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  uint64_t nt = (uint64_t)n_threads < n ? (uint64_t)n_threads : n;
  std::vector<std::thread> ts;
  ts.reserve(nt);
  uint64_t chunk = (n + nt - 1) / nt;
  for (uint64_t t = 0; t < nt; ++t) {
    uint64_t lo = t * chunk;
    uint64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

void dl_gather_f32(const uint8_t* base, uint64_t rec_elems, uint64_t channels,
                   const int64_t* idx, uint64_t n, const float* mean,
                   const float* stdinv, float* out, int n_threads) {
  run_threaded(n, n_threads, [=](uint64_t lo, uint64_t hi) {
    gather_f32_range(base, rec_elems, channels, idx, mean, stdinv, out, lo,
                     hi);
  });
}

void dl_gather_u8(const uint8_t* base, uint64_t rec_elems, const int64_t* idx,
                  uint64_t n, uint8_t* out, int n_threads) {
  run_threaded(n, n_threads, [=](uint64_t lo, uint64_t hi) {
    gather_u8_range(base, rec_elems, idx, out, lo, hi);
  });
}

}  // extern "C"
