// Batch JPEG decoder for the image input pipeline.
//
// The port's own copy of the JAX package's decoder (the same entry points
// and the same libjpeg calls, so equal inputs decode to equal pixels).
// Pillow's decoders hold the GIL, so Python thread workers cannot spread
// JPEG decode across cores; these entry points run libjpeg(-turbo) with
// the GIL released (ctypes calls drop it) and fan a batch across a thread
// pool, the same shape as the zstd batch codec (codec.cpp).
//
// Decode policy: grayscale JPEGs decode to 1 channel, everything else to
// RGB (libjpeg converts YCbCr; exotic spaces like CMYK fail the item and
// the Python wrapper falls back to PIL for it).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 jpegdec.cpp -o libtfjpeg.so -lpthread -ljpeg
// (tpuframe_torch.core.native compiles it at first use into
// build/tpuframe_torch/, named by a hash of this source).

#include <cstddef>  // jpeglib.h uses size_t/FILE without including them
#include <cstdio>

// jpeglib.h first: it pulls jconfig.h, whose D_ARITH_CODING_SUPPORTED
// gates whether jerror.h's enum even contains JWRN_ARITH_BAD_CODE
#include <jpeglib.h>

#include <jerror.h>

#include <atomic>
#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrJmp {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrJmp* e = reinterpret_cast<ErrJmp*>(cinfo->err);
  longjmp(e->jb, 1);
}

void silent_emit(j_common_ptr cinfo, int msg_level) {
  // Keep quiet but keep COUNTING — and count only CORRUPTION-class
  // warnings as failures: truncation (premature EOF / hit marker /
  // resync) and corrupt entropy-coded data (bad Huffman/arithmetic
  // codes — libjpeg "recovers" from those by emitting garbage pixels
  // with rc=0, so they must fail the item to reach the PIL fallback).
  // Benign warnings (extraneous bytes, spec quirks common in scraped
  // data) must not fail the item: that would silently
  // decode twice (full native scan, then the PIL fallback), inverting
  // the fast path's advantage.
  if (msg_level < 0) {
    int code = cinfo->err->msg_code;
    if (code == JWRN_JPEG_EOF || code == JWRN_HIT_MARKER ||
        code == JWRN_MUST_RESYNC || code == JWRN_HUFF_BAD_CODE
#ifdef D_ARITH_CODING_SUPPORTED
        // the enum member only exists when jconfig.h enables arithmetic
        // decoding — an unguarded use would break the build (and thus
        // the whole native fast path) on arith-less libjpeg builds
        || code == JWRN_ARITH_BAD_CODE
#endif
    )
      cinfo->err->num_warnings++;
  }
}
void silent_output(j_common_ptr) {}

// Pick the smallest DCT scale M/8 (M in 1..8) whose output still covers
// (min_h, min_w).  min_h/min_w <= 0 means full size (M = 8).  libjpeg
// applies ceil(dim * M / 8).
int pick_scale(uint32_t h, uint32_t w, int32_t min_h, int32_t min_w) {
  if (min_h <= 0 || min_w <= 0) return 8;
  for (int m = 1; m < 8; ++m) {
    uint64_t sh = ((uint64_t)h * m + 7) / 8;
    uint64_t sw = ((uint64_t)w * m + 7) / 8;
    if (sh >= (uint64_t)min_h && sw >= (uint64_t)min_w) return m;
  }
  return 8;
}

// Parse one header; fills h, w, out_channels (post-policy: 1 or 3) at
// the chosen M/8 DCT scale covering (min_h, min_w).  Returns 0 on
// success.
int parse_header(const uint8_t* src, size_t size, int32_t min_h,
                 int32_t min_w, int32_t* h, int32_t* w, int32_t* c) {
  jpeg_decompress_struct cinfo;
  ErrJmp err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = err_exit;
  err.mgr.emit_message = silent_emit;
  err.mgr.output_message = silent_output;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(src), size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.scale_num =
      (unsigned)pick_scale(cinfo.image_height, cinfo.image_width, min_h, min_w);
  cinfo.scale_denom = 8;
  jpeg_calc_output_dimensions(&cinfo);
  *h = (int32_t)cinfo.output_height;
  *w = (int32_t)cinfo.output_width;
  *c = (cinfo.jpeg_color_space == JCS_GRAYSCALE) ? 1 : 3;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode one image into dst (capacity dims h*w*c from tfj_dims), at the
// same M/8 scale tfj_dims chose for (min_h, min_w).  Returns 0 on
// success.
int decode_one(const uint8_t* src, size_t size, uint8_t* dst, int32_t min_h,
               int32_t min_w, int32_t exp_h, int32_t exp_w, int32_t exp_c) {
  jpeg_decompress_struct cinfo;
  ErrJmp err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = err_exit;
  err.mgr.emit_message = silent_emit;
  err.mgr.output_message = silent_output;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(src), size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space =
      (cinfo.jpeg_color_space == JCS_GRAYSCALE) ? JCS_GRAYSCALE : JCS_RGB;
  cinfo.scale_num =
      (unsigned)pick_scale(cinfo.image_height, cinfo.image_width, min_h, min_w);
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  // the caller allocated from tfj_dims; a mismatch (corrupt/substituted
  // bytes) must never overflow the buffer
  if ((int32_t)cinfo.output_height != exp_h ||
      (int32_t)cinfo.output_width != exp_w ||
      (int32_t)cinfo.output_components != exp_c) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const size_t stride = (size_t)exp_w * (size_t)exp_c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  // libjpeg treats truncated streams as WARNINGS and silently pads the
  // image with dummy data; strict mode (PIL parity: truncated images
  // raise) fails the item when silent_emit counted a truncation-class
  // warning
  const long warnings = cinfo.err->num_warnings;
  jpeg_destroy_decompress(&cinfo);
  return warnings > 0 ? -1 : 0;
}

}  // namespace

extern "C" {

// Header pass: dims[i*3 + 0/1/2] = height, width, channels (1 or 3) at
// the M/8 DCT scale covering (min_h, min_w); min_h/min_w <= 0 = full
// size.  Returns 0 on success; otherwise (1 + index) of the first bad
// item.
int tfj_dims(const uint8_t** srcs, const size_t* sizes, int n,
             int32_t min_h, int32_t min_w, int32_t* dims) {
  for (int i = 0; i < n; ++i) {
    if (parse_header(srcs[i], sizes[i], min_h, min_w, &dims[i * 3],
                     &dims[i * 3 + 1], &dims[i * 3 + 2]) != 0)
      return 1 + i;
  }
  return 0;
}

// Decode n images on a thread pool into caller-allocated buffers sized
// from tfj_dims (same min_h/min_w!).  Returns 0 on success; otherwise
// (1 + index) of the first failing item (remaining items may be
// skipped).
int tfj_decode_batch(const uint8_t** srcs, const size_t* sizes,
                     uint8_t** dsts, const int32_t* dims, int n,
                     int32_t min_h, int32_t min_w, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  std::atomic<int> failed(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load() != 0) return;
      if (decode_one(srcs[i], sizes[i], dsts[i], min_h, min_w, dims[i * 3],
                     dims[i * 3 + 1], dims[i * 3 + 2]) != 0) {
        int expect = 0;
        failed.compare_exchange_strong(expect, 1 + i);
        return;
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

}  // extern "C"
