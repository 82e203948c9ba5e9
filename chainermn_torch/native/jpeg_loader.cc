// Native JPEG decode for the input pipeline (libjpeg + fused resize +
// normalize): the port's own copy of chainermn_tpu/native/jpeg_loader.cc.
// ChainerMN's ImageNet example decodes JPEGs in MultiprocessIterator
// worker processes; this does the same work on C++ threads.
//
// Per image, on a C++ thread with the GIL released (ctypes):
//   1. libjpeg decompress with DCT scaling (largest 1/2^k reduction that
//      keeps both dims >= target — decode work scales down ~4x per step);
//   2. bilinear resize (half-pixel centers) to (out_h, out_w);
//   3. fused uint8 -> float32 (x/255 - mean[c]) * stdinv[c] normalize.
//
// C ABI:
//   int dl_decode_jpegs(blob, offsets, sizes, n, out_h, out_w, mean,
//                       stdinv, out, n_threads)
//     blob: concatenated JPEG byte streams; image i is
//       blob[offsets[i] .. offsets[i]+sizes[i]).
//     out: [n, out_h, out_w, 3] float32. Returns the number of images
//     that FAILED to decode (their rows are zeroed); 0 = all good.

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_longjmp(j_common_ptr cinfo) {
  ErrMgr* m = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(m->jb, 1);
}

// Decode one JPEG to tightly-packed RGB u8; returns false on any decode
// error (the default libjpeg handler would exit() the process).
bool decode_one(const uint8_t* data, uint64_t size, uint64_t tgt_h,
                uint64_t tgt_w, std::vector<uint8_t>& pix, uint64_t* w,
                uint64_t* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_longjmp;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale/CMYK -> RGB
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (unsigned d = 2; d <= 8; d *= 2) {
    if (cinfo.image_width / d >= tgt_w && cinfo.image_height / d >= tgt_h) {
      cinfo.scale_denom = d;
    } else {
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {  // should not happen after JCS_RGB
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  pix.resize(*w * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pix.data() + uint64_t(cinfo.output_scanline) * *w * 3;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize (half-pixel centers, edges clamped) + fused normalize.
// The numpy fallback in jpeg.py mirrors this formula exactly.
void resize_normalize(const uint8_t* src, uint64_t sw, uint64_t sh,
                      uint64_t ow, uint64_t oh, const float* mean,
                      const float* stdinv, float* dst) {
  const float sx = float(sw) / float(ow);
  const float sy = float(sh) / float(oh);
  for (uint64_t y = 0; y < oh; ++y) {
    float fy = (float(y) + 0.5f) * sy - 0.5f;
    if (fy < 0.f) fy = 0.f;
    if (fy > float(sh - 1)) fy = float(sh - 1);
    const uint64_t y0 = uint64_t(fy);
    const uint64_t y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = fy - float(y0);
    for (uint64_t x = 0; x < ow; ++x) {
      float fx = (float(x) + 0.5f) * sx - 0.5f;
      if (fx < 0.f) fx = 0.f;
      if (fx > float(sw - 1)) fx = float(sw - 1);
      const uint64_t x0 = uint64_t(fx);
      const uint64_t x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      const float wx = fx - float(x0);
      const uint8_t* p00 = src + (y0 * sw + x0) * 3;
      const uint8_t* p01 = src + (y0 * sw + x1) * 3;
      const uint8_t* p10 = src + (y1 * sw + x0) * 3;
      const uint8_t* p11 = src + (y1 * sw + x1) * 3;
      float* o = dst + (y * ow + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = float(p00[c]) * (1.f - wx) + float(p01[c]) * wx;
        const float bot = float(p10[c]) * (1.f - wx) + float(p11[c]) * wx;
        const float v = (top * (1.f - wy) + bot * wy) * (1.0f / 255.0f);
        o[c] = (v - mean[c]) * stdinv[c];
      }
    }
  }
}

}  // namespace

extern "C" {

int dl_decode_jpegs(const uint8_t* blob, const uint64_t* offsets,
                    const uint64_t* sizes, uint64_t n, uint64_t out_h,
                    uint64_t out_w, const float* mean, const float* stdinv,
                    float* out, int n_threads) {
  const uint64_t rec = out_h * out_w * 3;
  std::vector<int> failed(n, 0);
  auto work = [&](uint64_t lo, uint64_t hi) {
    std::vector<uint8_t> pix;  // reused decode buffer per thread
    for (uint64_t i = lo; i < hi; ++i) {
      uint64_t w = 0, h = 0;
      if (decode_one(blob + offsets[i], sizes[i], out_h, out_w, pix, &w,
                     &h)) {
        resize_normalize(pix.data(), w, h, out_w, out_h, mean, stdinv,
                         out + i * rec);
      } else {
        std::memset(out + i * rec, 0, rec * sizeof(float));
        failed[i] = 1;
      }
    }
  };
  if (n_threads <= 1 || n < 2) {
    work(0, n);
  } else {
    uint64_t nt = uint64_t(n_threads) < n ? uint64_t(n_threads) : n;
    std::vector<std::thread> ts;
    ts.reserve(nt);
    const uint64_t chunk = (n + nt - 1) / nt;
    for (uint64_t t = 0; t < nt; ++t) {
      const uint64_t lo = t * chunk;
      const uint64_t hi = lo + chunk < n ? lo + chunk : n;
      if (lo >= hi) break;
      ts.emplace_back([&work, lo, hi] { work(lo, hi); });
    }
    for (auto& th : ts) th.join();
  }
  int nfail = 0;
  for (uint64_t i = 0; i < n; ++i) nfail += failed[i];
  return nfail;
}

}  // extern "C"
