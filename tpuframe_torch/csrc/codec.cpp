// Batch zstd codec for the TFS and MDS shard formats.
//
// The port's own copy of the JAX package's codec (the same entry points,
// the same calls into libzstd, so equal inputs compress to equal bytes).
// Whole shard blocks decompress in parallel threads with the GIL released
// (ctypes calls drop it), which keeps the host input pipeline ahead of the
// card.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 codec.cpp -o libtfscodec.so -lpthread -lzstd
// (or -l:libzstd.so.1 where only the runtime library is installed;
// tpuframe_torch.core.native compiles it at first use into
// build/tpuframe_torch/, named by a hash of this source and the flags).

#if __has_include(<zstd.h>)
#include <zstd.h>
#else
// Where libzstd's runtime library is installed without its development
// header, the five entry points and two sentinels used below are declared
// from libzstd's stable ABI (zstd.h, v1.3 on), and the build links the
// runtime library by its soname (core/native.py).
#include <cstddef>
extern "C" {
size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);
unsigned long long ZSTD_getFrameContentSize(const void* src, size_t srcSize);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src, size_t srcSize,
                     int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
}
#define ZSTD_CONTENTSIZE_UNKNOWN (0ULL - 1)
#define ZSTD_CONTENTSIZE_ERROR (0ULL - 2)
#endif

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Upper bound for compress output.
size_t tfs_compress_bound(size_t n) { return ZSTD_compressBound(n); }

// Decompressed size recorded in a zstd frame header; 0 if unknown/error.
// UINT64_MAX = unknown/error sentinel; 0 is a valid (empty) content size.
uint64_t tfs_frame_content_size(const uint8_t* src, size_t src_size) {
  unsigned long long r = ZSTD_getFrameContentSize(src, src_size);
  if (r == ZSTD_CONTENTSIZE_UNKNOWN || r == ZSTD_CONTENTSIZE_ERROR)
    return UINT64_MAX;
  return (uint64_t)r;
}

// One-shot compress. Returns 0 on success.
int tfs_compress(const uint8_t* src, size_t src_size, uint8_t* dst,
                 size_t dst_cap, size_t* out_size, int level) {
  size_t r = ZSTD_compress(dst, dst_cap, src, src_size, level);
  if (ZSTD_isError(r)) return -1;
  *out_size = r;
  return 0;
}

// Decompress n independent buffers on a thread pool.
// Returns 0 on success; otherwise (1 + index) of the first failing buffer.
int tfs_batch_decompress(const uint8_t** srcs, const size_t* src_sizes,
                         uint8_t** dsts, const size_t* dst_caps,
                         size_t* dst_sizes, int n, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  std::atomic<int> failed(0);  // 0 = ok, else 1 + index

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load() != 0) return;
      size_t r = ZSTD_decompress(dsts[i], dst_caps[i], srcs[i], src_sizes[i]);
      if (ZSTD_isError(r)) {
        int expect = 0;
        failed.compare_exchange_strong(expect, 1 + i);
        return;
      }
      dst_sizes[i] = r;
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
