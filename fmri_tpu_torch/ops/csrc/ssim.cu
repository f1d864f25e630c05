// Windowed SSIM for NVIDIA Hopper (sm_90a): per-(image, channel, band) sums
// of the SSIM map.
//
// Replaces the Pallas TPU kernel fmri_tpu/ops/pallas_ssim.py::ssim_pallas
// (body _ssim_kernel). Same function: five Gaussian moments (x, y, x^2, y^2,
// xy) by a separable k-tap blur (sigma 1.5, k = min(11, H, W)) over the input
// zero-padded by `pad` (= window // 2, so for H < 11 the output is larger
// than the input), then the SSIM map with C1 = 1e-4 and C2 = 9e-4. Where the
// TPU kernel writes the whole [B, C, H', W'] map and takes the mean outside,
// this kernel writes one fp32 sum per (image, channel, band of output rows);
// the wrapper (fmri_tpu_torch/ops/ssim.py) adds the bands in a fixed order
// in float64 and takes the global or per-image mean.
//
// What bounds it on the H100: fp32 arithmetic on the CUDA cores (67
// TFLOP/s). Per output pixel and channel the blur costs 5 moments x 2
// passes x k taps x 2 FLOP (~220 at k = 11) plus ~20 for the products and
// the formula, against 8 bytes of input: ~30 FLOP per byte, above the
// card's ridge of 67 TFLOP/s / 3.35 TB/s = 20 (chip_smoke.py::ssim_bound
// counts only the taps that land on the image). Next in line is shared
// memory, 32 words per clock per SM against 128 FMA, so the design keeps
// shared loads per FMA well below one.
//
// Design. A block takes one image and one band of output rows, all C
// channels, and needs no other block:
//   1. It copies the band's input rows (output rows + the k - 1 halo rows,
//      clipped to the image) of x and y from NHWC into shared memory as
//      they lie, a flat run of W * C floats per row, by 16-byte cp.async
//      copies that are all in flight at once. Each input byte leaves device
//      memory once; the halo rows two bands share come from L2.
//   Then for each channel:
//   2. it de-interleaves the channel (2-D thread mapping: row by warp,
//      column by lane; a stride-C read, conflict-free for odd C) into a
//      float4 plane (x, y, x^2, y^2) and a float plane xy: the products are
//      formed once per input pixel;
//   3. vertical pass first, over the staged rows: a thread walks one column
//      over kRun output rows with all five moments in registers; it reads
//      each input of its window once (one 16-byte and one 4-byte load) and
//      adds it into every output whose taps cover it (kRun + k - 1 loads
//      for kRun * k * 5 FMA). Blurring vertically first means the k - 1
//      halo rows are staged but never blurred;
//   4. horizontal pass over the band's rows the same way along a row, then
//      the SSIM formula, the scores added into a per-thread sum. The next
//      channel's step 2 runs beside it.
// The zero padding lives in shared memory: staged rows that fall outside
// the image and the pad columns of the vertical pass's output are zeros, so
// neither pass tests a bound per tap. The taps are compile-time: the kernel
// is a template on k (one instance per k in 1..11); for k = 11 the Gaussian
// is a table of immediates, which the entry holds against the taps the
// wrapper passes. Loops run over 2-D indices or advance a (line, segment)
// pair by carry: no integer division per element. Every sum runs in a fixed
// order (taps in order, each thread's items in order, a fixed warp-shuffle
// tree, warp sums in order): two runs give the same bits. fp32 throughout,
// no fast-math: the variances are the cancellation E[x^2] - E[x]^2.
//
// Shared memory per block: the staged planes, ceil(band / kRun) * kRun +
// k - 1 rows of stride W | 1; the vertical pass's output, ceil(band / kRun)
// * kRun rows of stride (W + 2 pad) | 1; 20 bytes per element of each; the
// raw rows, 8 W C bytes each. The odd strides keep the column walks of step
// 3 and the row walks of step 4 free of bank conflicts. ops/ssim.py::plan
// sizes the band so that two blocks fit on an SM (16 output rows at 64 px),
// or one where two cannot.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 11;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;  // outputs per thread in either blur pass
constexpr float kC1 = 1e-4f;  // 0.01^2
constexpr float kC2 = 9e-4f;  // 0.03^2

struct Taps {
  float g[kMaxTaps];
};

// gaussian_window(11) of ops/ssim.py rounded to fp32, symmetric about tap 5
__host__ __device__ constexpr float gauss11(int t) {
  switch (t < 5 ? t : 10 - t) {
    case 0: return 0x1.0d956cp-10f;
    case 1: return 0x1.f1fe02p-8f;
    case 2: return 0x1.26eb18p-5f;
    case 3: return 0x1.bff0fep-4f;
    case 4: return 0x1.b43c40p-3f;
    default: return 0x1.106560p-2f;
  }
}

template <int K>
__device__ __forceinline__ float tap(int t, const Taps& taps) {
  if constexpr (K == 11) {
    return gauss11(t);  // t is a constant once the tap loops unroll
  } else {
    return taps.g[t];
  }
}

// Item `i + s * n` of a loop over n * segments items, thread t starting at
// item t, advanced by kThreads with a carry instead of a division per item.
struct Walk {
  int i, s, di, ds, n;
  __device__ explicit Walk(int n_) : n(n_) {
    s = threadIdx.x / n;
    i = threadIdx.x - s * n;
    ds = kThreads / n;
    di = kThreads - ds * n;
  }
  __device__ void next() {
    i += di;
    s += ds;
    if (i >= n) {
      i -= n;
      ++s;
    }
  }
};

// One register-blocked pass of the k-tap blur: outputs o = 0 .. kRun - 1
// read inputs u = o .. o + K - 1 of a line whose input u holds (x, y, x^2,
// y^2) at s4[u * step] and xy at s1[u * step], zeros on the padding. Each
// input is read once and added into every output whose tap covers it, taps
// in order.
template <int K>
__device__ __forceinline__ void blur_run(const float4* s4, const float* s1, int step,
                                         const Taps& taps, float (&acc)[5][kRun]) {
#pragma unroll
  for (int o = 0; o < kRun; ++o) {
#pragma unroll
    for (int m = 0; m < 5; ++m) acc[m][o] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < kRun + K - 1; ++u) {
    const float4 q = s4[u * step];
    const float v[5] = {q.x, q.y, q.z, q.w, s1[u * step]};
#pragma unroll
    for (int o = 0; o < kRun; ++o) {
      const int t = u - o;
      if (t >= 0 && t < K) {
        const float g = tap<K>(t, taps);
#pragma unroll
        for (int m = 0; m < 5; ++m) acc[m][o] = fmaf(g, v[m], acc[m][o]);
      }
    }
  }
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
ssim_band_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int C, int H, int W, int pad,
                 int Ho, int Wo, int band_rows, int bands, int raw_rows,
                 int vec4, Taps taps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int image = blockIdx.x / bands;  // once per block
  const int band = blockIdx.x - image * bands;
  const int WC = W * C;
  const int band_alloc = (band_rows + kRun - 1) / kRun * kRun;
  const int rows = band_alloc + K - 1;  // staged rows, padding included
  const int PW = W | 1;                 // stride of the staged planes
  const int PV = (W + 2 * pad) | 1;     // stride of the vertical output
  const int F = rows * PW + band_alloc * PV;
  float4* prod4 = smem4;                         // [rows, PW]
  float4* vert4 = prod4 + rows * PW;             // [band_alloc, PV]
  float* prod1 = smem + 4 * F;                   // [rows, PW]
  float* vert1 = prod1 + rows * PW;              // [band_alloc, PV]
  float* raw_x = smem + 4 * F + ((F + 3) & ~3);  // [raw_rows, W * C]
  float* raw_y = raw_x + raw_rows * WC;          // [raw_rows, W * C]
  float* warp_sums = raw_y + raw_rows * WC;      // [C, kWarps]

  // output rows [r0, r_end) of the padded grid; staged row ri is image row
  // r0 - pad + ri, of which [ih_lo, ih_hi) lie in the image
  const int r0 = band * band_rows;
  const int r_end = min(r0 + band_rows, Ho);
  const int n_out = r_end - r0;
  const int ih_lo = max(0, r0 - pad);
  const int ih_hi = min(H, r_end - 1 - pad + K);
  const int n_in = max(0, ih_hi - ih_lo);
  const int ri_lo = ih_lo - (r0 - pad);

  // 1. the band's input rows, all channels, as they lie in memory
  {
    const size_t base = ((size_t)image * H + ih_lo) * WC;
    const int n = n_in * WC;
    if (vec4) {
      for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
        copy16(raw_x + i, x + base + i);
        copy16(raw_y + i, y + base + i);
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        raw_x[i] = __ldg(x + base + i);
        raw_y[i] = __ldg(y + base + i);
      }
    }
  }
  // the zero padding: staged rows outside the image, pad columns of the
  // vertical output (never written again)
  for (int ri = threadIdx.x >> 5; ri < rows; ri += kWarps) {
    if (ri >= ri_lo && ri < ri_lo + n_in) continue;
    for (int w = threadIdx.x & 31; w < W; w += 32) {
      prod4[ri * PW + w] = make_float4(0.f, 0.f, 0.f, 0.f);
      prod1[ri * PW + w] = 0.f;
    }
  }
  for (int r = threadIdx.x >> 5; r < band_alloc; r += kWarps) {
    for (int j = threadIdx.x & 31; j < PV; j += 32) {
      if (j < pad || j >= pad + W) {
        vert4[r * PV + j] = make_float4(0.f, 0.f, 0.f, 0.f);
        vert1[r * PV + j] = 0.f;
      }
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // 2. de-interleave channel c; x^2, y^2 and xy once per input pixel
  auto deinterleave = [&](int c) {
    for (int ri = warp; ri < n_in; ri += kWarps) {
      for (int w = lane; w < W; w += 32) {
        const float a = raw_x[ri * WC + w * C + c];
        const float e = raw_y[ri * WC + w * C + c];
        const int at = (ri_lo + ri) * PW + w;
        prod4[at] = make_float4(a, e, a * a, e * e);
        prod1[at] = a * e;
      }
    }
  };
  deinterleave(0);
  __syncthreads();

  const int vsegs = (n_out + kRun - 1) / kRun;
  const int hsegs = (Wo + kRun - 1) / kRun;
  for (int c = 0; c < C; ++c) {
    // 3. vertical pass: item (column w, segment s) makes output rows
    //    r0 + s * kRun + o of column w from staged rows s * kRun + o + t
    for (Walk it(W); it.s < vsegs; it.next()) {
      const int rb = it.s * kRun;
      float acc[5][kRun];
      blur_run<K>(prod4 + rb * PW + it.i, prod1 + rb * PW + it.i, PW, taps, acc);
      const int at = rb * PV + pad + it.i;
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        vert4[at + o * PV] = make_float4(acc[0][o], acc[1][o], acc[2][o], acc[3][o]);
        vert1[at + o * PV] = acc[4][o];
      }
    }
    __syncthreads();

    // 4. horizontal pass + SSIM: item (output row rr, segment s) makes
    //    outputs j0 + o of row rr from padded columns j0 + o + t, and adds
    //    their scores into a per-thread sum. The next channel's step 2 runs
    //    meanwhile: the staged planes are free once step 3 is done.
    float score_sum = 0.f;
    for (Walk it(n_out); it.s < hsegs; it.next()) {
      const int j0 = it.s * kRun;
      float acc[5][kRun];
      blur_run<K>(vert4 + it.i * PV + j0, vert1 + it.i * PV + j0, 1, taps, acc);
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        if (j0 + o < Wo) {
          const float mu1 = acc[0][o], mu2 = acc[1][o];
          const float mu1_sq = mu1 * mu1;
          const float mu2_sq = mu2 * mu2;
          const float mu12 = mu1 * mu2;
          const float s1 = acc[2][o] - mu1_sq;
          const float s2 = acc[3][o] - mu2_sq;
          const float s12 = acc[4][o] - mu12;
          score_sum += ((2.f * mu12 + kC1) * (2.f * s12 + kC2)) /
                       ((mu1_sq + mu2_sq + kC1) * (s1 + s2 + kC2));
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      score_sum += __shfl_down_sync(0xffffffffu, score_sum, off);
    if (lane == 0) warp_sums[c * kWarps + warp] = score_sum;
    if (c + 1 < C) deinterleave(c + 1);
    __syncthreads();
  }

  // one thread per channel adds the warp sums in order
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[c * kWarps + w];
    out[((size_t)image * C + c) * bands + band] = s;
  }
}

template <int K>
int launch(const float* x, const float* y, float* out, int B, int C, int H,
           int W, int pad, int band_rows, int bands, int raw_rows,
           long long smem_bytes, int vec4, const Taps& taps,
           cudaStream_t stream) {
  // opt in above the default 48 KB once per instance and size, so a call
  // captured into a CUDA graph sets no attribute
  static long long opted = 48 * 1024;
  if (smem_bytes > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssim_band_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    opted = smem_bytes;
  }
  const int Ho = H + 2 * pad - (K - 1);
  const int Wo = W + 2 * pad - (K - 1);
  ssim_band_kernel<K><<<(unsigned)((long long)B * bands), kThreads,
                        (size_t)smem_bytes, stream>>>(
      x, y, out, C, H, W, pad, Ho, Wo, band_rows, bands, raw_rows, vec4, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// out[(b * C + c) * bands + band] = sum of the SSIM map of plane (b, c) over
// output rows [band * band_rows, (band + 1) * band_rows). x and y are
// contiguous NHWC fp32; vec4 = 1 when both start on 16 bytes and W * C is a
// multiple of 4. raw_rows = min(band_rows + k - 1, H). `taps` is a host
// array of k floats (for k = 11 it must equal the built-in table). Returns
// the launch's CUDA error code (0 on success): a launch refused for its
// shared memory never runs, and a later synchronize would not report it.
extern "C" int ssim_band_sums(const void* x, const void* y, void* out, int B,
                              int C, int H, int W, int k, int pad,
                              const float* taps, int band_rows, int bands,
                              int raw_rows, long long smem_bytes, int vec4,
                              void* stream) {
  if (k < 1 || k > kMaxTaps || band_rows < 1 || bands < 1 || B < 1 || C < 1 ||
      raw_rows < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Taps t = {};
  for (int i = 0; i < k; ++i) t.g[i] = taps[i];
  if (k == 11) {
    for (int i = 0; i < 11; ++i) {
      if (t.g[i] != gauss11(i)) return (int)cudaErrorInvalidValue;
    }
  }
  const float* px = static_cast<const float*>(x);
  const float* py = static_cast<const float*>(y);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define SSIM_CASE(K)                                                          \
  case K:                                                                     \
    return launch<K>(px, py, po, B, C, H, W, pad, band_rows, bands, raw_rows, \
                     smem_bytes, vec4, t, st);
    SSIM_CASE(1) SSIM_CASE(2) SSIM_CASE(3) SSIM_CASE(4) SSIM_CASE(5)
    SSIM_CASE(6) SSIM_CASE(7) SSIM_CASE(8) SSIM_CASE(9) SSIM_CASE(10)
    SSIM_CASE(11)
#undef SSIM_CASE
  }
  return (int)cudaErrorInvalidValue;
}
