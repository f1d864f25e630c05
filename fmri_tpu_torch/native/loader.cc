// Native data-loader routines of the port's host input pipeline.
//
// The port's own copy of the JAX package's loader (fmri_tpu/native/loader.cc,
// ABI 1): the same three entry points, built and loaded by
// fmri_tpu_torch/native/ and used by fmri_tpu_torch/data/pipeline.py on the
// packed/mmap store (fmri_tpu_torch/data/packed.py):
//
//   1. ft_gather_rows      - shuffled row gather (memcpy per row), the per-
//                            batch indexing work of `Batches.__iter__`;
//   2. ft_gather_u8_f32    - the same gather fused with uint8->float32
//                            dequantization (x * scale) in one pass, with no
//                            intermediate uint8 batch;
//   3. ft_prefetch_rows    - posix_madvise(WILLNEED) on the pages of an
//                            upcoming batch's rows, so the kernel's readahead
//                            overlaps disk IO with the step on the card.
//
// All entry points are plain C symbols called through ctypes, which drops
// the GIL for the duration of the call: the pipeline's producer thread
// gathers concurrently with the Python main thread. Parallelism is
// fork-join std::thread over row ranges; the thread count comes from the
// Python wrapper (1 on single-core hosts -> inline, no spawn).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__unix__) || defined(__APPLE__)
#include <sys/mman.h>
#include <unistd.h>
#define FT_HAVE_MADVISE 1
#endif

namespace {

// Run fn(begin, end) over [0, n) split across `threads` fork-join workers.
// threads <= 1 runs inline (no spawn cost on single-core hosts).
template <typename Fn>
void parallel_rows(int64_t n, int threads, Fn fn) {
  if (threads <= 1 || n < 2 * threads) {
    fn(int64_t{0}, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  const int64_t chunk = (n + threads - 1) / threads;
  for (int t = 1; t < threads; ++t) {
    const int64_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    pool.emplace_back([=] { fn(b, e); });
  }
  fn(int64_t{0}, std::min(n, chunk));
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// ABI/version handshake for the ctypes wrapper.
int64_t ft_abi_version() { return 1; }

// dst[i, :] = src[idx[i], :] for i in [0, n_idx); rows are row_bytes wide.
void ft_gather_rows(const void* src, int64_t row_bytes, const int64_t* idx,
                    int64_t n_idx, void* dst, int threads) {
  const auto* s = static_cast<const uint8_t*>(src);
  auto* d = static_cast<uint8_t*>(dst);
  parallel_rows(n_idx, threads, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i)
      std::memcpy(d + i * row_bytes, s + idx[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
  });
}

// dst[i, :] = float32(src[idx[i], :]) * scale — the packed store's uint8
// codec decoded in the same pass as the gather (scale = 1/255).
void ft_gather_u8_f32(const uint8_t* src, int64_t row_elems,
                      const int64_t* idx, int64_t n_idx, float* dst,
                      float scale, int threads) {
  parallel_rows(n_idx, threads, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      const uint8_t* s = src + idx[i] * row_elems;
      float* d = dst + i * row_elems;
      for (int64_t j = 0; j < row_elems; ++j)
        d[j] = static_cast<float>(s[j]) * scale;
    }
  });
}

// Advise the kernel that the pages holding rows idx[0..n_idx) of a mapped
// array will be needed soon (async readahead).  Page-aligns each range
// downward; errors (e.g. an address below the mapping base for row 0 of a
// .npy whose data starts mid-page) are ignored — madvise is a hint.
void ft_prefetch_rows(const void* base, int64_t row_bytes, const int64_t* idx,
                      int64_t n_idx) {
#ifdef FT_HAVE_MADVISE
  static const uintptr_t page = static_cast<uintptr_t>(sysconf(_SC_PAGESIZE));
  const auto* s = static_cast<const uint8_t*>(base);
  for (int64_t i = 0; i < n_idx; ++i) {
    auto addr = reinterpret_cast<uintptr_t>(s + idx[i] * row_bytes);
    const uintptr_t aligned = addr & ~(page - 1);
    const size_t len = static_cast<size_t>(row_bytes) + (addr - aligned);
    (void)posix_madvise(reinterpret_cast<void*>(aligned), len,
                        POSIX_MADV_WILLNEED);
  }
#else
  (void)base; (void)row_bytes; (void)idx; (void)n_idx;
#endif
}

}  // extern "C"
