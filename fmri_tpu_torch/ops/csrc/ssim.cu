// Windowed SSIM for NVIDIA Hopper (sm_90a): per-(image, channel) sums of the
// SSIM map.
//
// Replaces the Pallas TPU kernel fmri_tpu/ops/pallas_ssim.py::ssim_pallas
// (body _ssim_kernel). Same function: five Gaussian moments (x, y, x^2, y^2,
// xy) by a separable k-tap blur (sigma 1.5, k = min(11, H, W)) over the input
// zero-padded by `pad` (= window // 2, so for H < 11 the output is larger
// than the input), then the SSIM map with C1 = 1e-4 and C2 = 9e-4. Where the
// TPU kernel writes the whole [B, C, H', W'] map and takes the mean outside,
// this kernel writes one fp32 sum per (image, channel) plane; the wrapper
// (fmri_tpu_torch/ops/ssim.py) turns those into the global or per-image mean.
//
// What bounds it on the H100: arithmetic. Per output pixel and channel the
// separable blur costs 5 moments x 2 passes x k taps x 2 FLOP (~220 at k=11,
// a little more for the halo rows) plus ~20 for the products and the
// formula, against 8 bytes of input read once: ~30 FLOP/byte, above the
// card's fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte.
//
// Design. One block per plane, so no cross-block reduction is needed and the
// result is deterministic. The block walks the plane in tiles of output
// rows; for each tile it
//   1. stages the tile's input rows (plus the k-1 halo rows) of x and y in
//      shared memory straight from the NHWC tensors, by their strides, with
//      the zero padding applied by bounds checks on that load (no pad or
//      transpose pass in device memory);
//   2. runs the horizontal k-tap pass for all five moments into shared
//      memory, so each input value is read from device memory once and the
//      products x^2, y^2, xy never touch it;
//   3. runs the vertical pass and the SSIM formula per output pixel and adds
//      the score to a per-thread fp32 sum.
// The block then reduces the per-thread sums in a fixed tree (warp shuffles,
// then one warp over the warp sums). Everything is fp32 with no fast-math:
// the variances are the cancellation E[x^2] - E[x]^2.
// Shared memory per block: 4 * R * (2 * (W + 2 pad) + 5 * W') bytes with
// R = tile_rows + k - 1; the wrapper picks tile_rows to keep two blocks per
// SM, and this file opts in above the default 48 KB.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 16;
constexpr int kThreads = 256;
constexpr float kC1 = 1e-4f;  // 0.01^2
constexpr float kC2 = 9e-4f;  // 0.03^2

struct Taps {
  float g[kMaxTaps];
};

__global__ void __launch_bounds__(kThreads)
ssim_plane_sums_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       float* __restrict__ out, int C, int H, int W,
                       long long xb, long long xh, long long xw, long long xc,
                       long long yb, long long yh, long long yw, long long yc,
                       int k, int pad, int Ho, int Wo, int tile_rows, Taps taps) {
  extern __shared__ float smem[];
  __shared__ float sg[kMaxTaps];
  __shared__ float warp_sums[kThreads / 32];

  const int plane = blockIdx.x;
  const int b = plane / C;
  const int c = plane - b * C;
  const int Wp = W + 2 * pad;           // padded row width
  const int R = tile_rows + k - 1;      // input rows a full tile needs
  float* sx = smem;                     // [R, Wp]
  float* sy = sx + R * Wp;              // [R, Wp]
  float* h0 = sy + R * Wp;              // five horizontal moments, [R, Wo] each
  const int hs = R * Wo;
  const float* xp = x + b * xb + c * xc;
  const float* yp = y + b * yb + c * yc;

  if (threadIdx.x < k) sg[threadIdx.x] = taps.g[threadIdx.x];

  float acc = 0.f;
  for (int r0 = 0; r0 < Ho; r0 += tile_rows) {
    const int tr = min(tile_rows, Ho - r0);
    const int rows = tr + k - 1;

    // 1. zero-padded input rows r0 .. r0 + rows - 1 (padded coordinates)
    for (int i = threadIdx.x; i < rows * Wp; i += blockDim.x) {
      const int rr = i / Wp;
      const int cc = i - rr * Wp;
      const int ih = r0 + rr - pad;
      const int iw = cc - pad;
      float vx = 0.f, vy = 0.f;
      if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
        vx = xp[ih * xh + iw * xw];
        vy = yp[ih * yh + iw * yw];
      }
      sx[i] = vx;
      sy[i] = vy;
    }
    __syncthreads();

    // 2. horizontal pass: rows x Wo outputs for each of the five moments
    for (int i = threadIdx.x; i < rows * Wo; i += blockDim.x) {
      const int rr = i / Wo;
      const int j = i - rr * Wo;
      const float* px = sx + rr * Wp + j;
      const float* py = sy + rr * Wp + j;
      float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f, m4 = 0.f;
      for (int t = 0; t < k; ++t) {
        const float g = sg[t];
        const float a = px[t];
        const float e = py[t];
        m0 += g * a;
        m1 += g * e;
        m2 += g * (a * a);
        m3 += g * (e * e);
        m4 += g * (a * e);
      }
      h0[i] = m0;
      h0[hs + i] = m1;
      h0[2 * hs + i] = m2;
      h0[3 * hs + i] = m3;
      h0[4 * hs + i] = m4;
    }
    __syncthreads();

    // 3. vertical pass + SSIM map, summed per thread
    for (int i = threadIdx.x; i < tr * Wo; i += blockDim.x) {
      const int r = i / Wo;
      const int j = i - r * Wo;
      float mu1 = 0.f, mu2 = 0.f, exx = 0.f, eyy = 0.f, exy = 0.f;
      for (int t = 0; t < k; ++t) {
        const float g = sg[t];
        const int o = (r + t) * Wo + j;
        mu1 += g * h0[o];
        mu2 += g * h0[hs + o];
        exx += g * h0[2 * hs + o];
        eyy += g * h0[3 * hs + o];
        exy += g * h0[4 * hs + o];
      }
      const float mu1_sq = mu1 * mu1;
      const float mu2_sq = mu2 * mu2;
      const float mu12 = mu1 * mu2;
      const float s1 = exx - mu1_sq;
      const float s2 = eyy - mu2_sq;
      const float s12 = exy - mu12;
      acc += ((2.f * mu12 + kC1) * (2.f * s12 + kC2)) /
             ((mu1_sq + mu2_sq + kC1) * (s1 + s2 + kC2));
    }
    __syncthreads();  // the next tile overwrites the staged rows
  }

  // fixed-order block reduction: deterministic from run to run
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) out[plane] = v;
  }
}

}  // namespace

// out[b * C + c] = sum of the SSIM map of plane (b, c). Strides are in
// elements. `taps` is a host array of k floats. Returns the launch's CUDA
// error code (0 on success): a launch refused for its shared memory never
// runs, and a later synchronize would not report it.
extern "C" int ssim_plane_sums(const void* x, const void* y, void* out, int B,
                               int C, int H, int W, long long xb, long long xh,
                               long long xw, long long xc, long long yb,
                               long long yh, long long yw, long long yc, int k,
                               int pad, const float* taps, int tile_rows,
                               long long smem_bytes, void* stream) {
  if (k < 1 || k > kMaxTaps || tile_rows < 1 || B < 1 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int Ho = H + 2 * pad - (k - 1);
  const int Wo = W + 2 * pad - (k - 1);
  Taps t = {};
  for (int i = 0; i < k; ++i) t.g[i] = taps[i];
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssim_plane_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ssim_plane_sums_kernel<<<B * C, kThreads, (size_t)smem_bytes,
                           (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), C, H, W, xb, xh, xw, xc, yb, yh, yw, yc, k, pad,
      Ho, Wo, tile_rows, t);
  return (int)cudaGetLastError();
}
