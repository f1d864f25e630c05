// Convolution weight gradient for NVIDIA Hopper (sm_90a): the port of
// fmri_tpu/ops/pallas_dw.py::_tap_matmul, as used by conv2d_dw and
// conv2d_transpose_dw.
//
// Both weight grads are one product over the reduction index
// r = (b, ph, pw) of a "shifted" operand S [B, Cs, Hs, Ws] and a "direct"
// operand U [B, Cu, PH, PW] (NCHW, contiguous):
//
//   out[cu, cs, kh, kw] = sum_r S[b, cs, ph*stride - pad + kh,
//                                       pw*stride - pad + kw] * U[b, cu, ph, pw]
//
// with S read as zero outside [0, Hs) x [0, Ws).
//   * Conv2d (OIHW dW):           S = x, U = dy, grid = the output.
//   * ConvTranspose2d (IOHW dW,
//     torch's scatter convention): S = dy, U = x, grid = the input.
// So the result lands in the port's weight layout with no transpose, and
// the zero padding and the TPU kernel's parity planes are never built in
// device memory: the loads are strided and bounds-checked.
//
// As a matrix product: D[n = cu][m = cs*K*K + tap] = sum_r A[r][m] * B[r][n].
// A block owns a TM x TN tile of D and a contiguous range of r; it stages
// RK rows of A and B in shared memory and each of its 256 threads keeps an
// MM x MN fp32 micro-tile in registers. Bound: operations at the shapes of
// the VAE/GAN (up to 80 GFLOP per weight against at most ~100 MB of
// operands); this first version runs on the CUDA cores in fp32 FMA, with
// `wgmma`/TMA left for later work. The reduction length reaches 786,432
// (the discriminator's first conv at batch 192) while D has only 2,400
// values, so r is split across `splits` blocks per tile; each writes its own
// partial tile and a second launch adds the partials in split order. No
// atomics: two runs give the same bits. Operands are float32 or bfloat16;
// products and sums are float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int RK = 32;

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Geometry {
  int B, Cs, Hs, Ws, Cu, PH, PW, K, stride, pad;
  int M, N, R;   // M = Cs*K*K, N = Cu, R = B*PH*PW
  int chunk;     // reduction rows per split, a multiple of RK
};

// grid (ceil(M/TM), ceil(N/TN), splits); writes out[split][n][m].
template <int TM, int TN, int MM, int MN, typename T>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ S, const T* __restrict__ U,
          float* __restrict__ out, Geometry g) {
  static_assert((TM / MM) * (TN / MN) == kThreads, "one micro-tile per thread");
  __shared__ float As[RK][TM + 1];
  __shared__ float Bs[RK][TN + 1];
  __shared__ int m_off[TM];   // cs * Hs * Ws, or -1 past M
  __shared__ int m_dh[TM];    // kh - pad
  __shared__ int m_dw[TM];    // kw - pad

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int kk = g.K * g.K, hws = g.Hs * g.Ws, phw = g.PH * g.PW;
  for (int i = tid; i < TM; i += kThreads) {
    const int m = m0 + i;
    if (m < g.M) {
      const int cs = m / kk, t = m - cs * kk, kh = t / g.K;
      m_off[i] = cs * hws;
      m_dh[i] = kh - g.pad;
      m_dw[i] = t - kh * g.K - g.pad;
    } else {
      m_off[i] = -1;
      m_dh[i] = 0;
      m_dw[i] = 0;
    }
  }
  __syncthreads();

  const int tx = tid % (TN / MN), ty = tid / (TN / MN);
  float acc[MM][MN];
#pragma unroll
  for (int i = 0; i < MM; ++i)
#pragma unroll
    for (int j = 0; j < MN; ++j) acc[i][j] = 0.f;

  const int r_lo = blockIdx.z * g.chunk;
  const int r_hi = min(g.R, r_lo + g.chunk);
  const int rl = tid % RK;  // this thread's row of every staged chunk
  for (int r0 = r_lo; r0 < r_hi; r0 += RK) {
    const int r = r0 + rl;
    const bool live = r < r_hi;
    int b = 0, ph = 0, pw = 0;
    if (live) {
      b = r / phw;
      const int rem = r - b * phw;
      ph = rem / g.PW;
      pw = rem - ph * g.PW;
    }
    const long long s_base = (long long)b * g.Cs * hws;
    for (int e = tid; e < RK * TM; e += kThreads) {
      const int i = e / RK;  // e % RK == rl
      float v = 0.f;
      const int off = m_off[i];
      if (live && off >= 0) {
        const int h = ph * g.stride + m_dh[i];
        const int w = pw * g.stride + m_dw[i];
        if (h >= 0 && h < g.Hs && w >= 0 && w < g.Ws)
          v = to_float(S[s_base + off + h * g.Ws + w]);
      }
      As[rl][i] = v;
    }
    const long long u_base = (long long)b * g.Cu * phw + ph * g.PW + pw;
    for (int e = tid; e < RK * TN; e += kThreads) {
      const int j = e / RK;
      const int n = n0 + j;
      Bs[rl][j] = (live && n < g.N) ? to_float(U[u_base + (long long)n * phw]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < RK; ++k) {
      float a[MM], bv[MN];
#pragma unroll
      for (int i = 0; i < MM; ++i) a[i] = As[k][ty + i * (TM / MM)];
#pragma unroll
      for (int j = 0; j < MN; ++j) bv[j] = Bs[k][tx + j * (TN / MN)];
#pragma unroll
      for (int i = 0; i < MM; ++i)
#pragma unroll
        for (int j = 0; j < MN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = out + (long long)blockIdx.z * g.N * g.M;
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    const int m = m0 + ty + i * (TM / MM);
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < MN; ++j) {
      const int n = n0 + tx + j * (TN / MN);
      if (n < g.N) dst[(long long)n * g.M + m] = acc[i][j];
    }
  }
}

// out[i] = sum over s in order of partial[s][i], i < count.
__global__ void dw_finish(const float* __restrict__ partial,
                          float* __restrict__ out, long long count, int splits) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += step) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[k * count + i];
    out[i] = s;
  }
}

template <int TM, int TN, int MM, int MN, typename T>
cudaError_t launch(const void* S, const void* U, float* dst, const Geometry& g,
                   int splits, cudaStream_t st) {
  dim3 grid((g.M + TM - 1) / TM, (g.N + TN - 1) / TN, splits);
  dw_kernel<TM, TN, MM, MN, T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(S), static_cast<const T*>(U), dst, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int tile, const void* S, const void* U, float* dst,
                     const Geometry& g, int splits, cudaStream_t st) {
  switch (tile) {
    case 0: return launch<64, 64, 4, 4, T>(S, U, dst, g, splits, st);
    case 1: return launch<64, 32, 4, 2, T>(S, U, dst, g, splits, st);
    case 2: return launch<256, 4, 4, 1, T>(S, U, dst, g, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. tile: 0 (64 x 64), 1 (64 x 32), 2 (256 x 4),
// the TM x TN tile of D, picked by the wrapper from N. With splits > 1,
// partial is scratch of splits * N * M floats; with splits == 1 the blocks
// write out directly and partial is unused. out is [Cu, Cs, K, K] float32.
extern "C" int tap_matmul(const void* S, const void* U, float* partial,
                          float* out, int dtype, int tile, int B, int Cs, int Hs,
                          int Ws, int Cu, int PH, int PW, int K, int stride,
                          int pad, int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geometry g{B, Cs, Hs, Ws, Cu, PH, PW, K, stride, pad,
             Cs * K * K, Cu, B * PH * PW, chunk};
  float* dst = splits > 1 ? partial : out;
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(tile, S, U, dst, g, splits, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(tile, S, U, dst, g, splits, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long count = (long long)g.N * g.M;
  const int blocks = (int)min((count + 255) / 256, 4096LL);
  dw_finish<<<blocks, 256, 0, st>>>(partial, out, count, splits);
  return (int)cudaGetLastError();
}
