// Train-mode BatchNorm backward for NVIDIA Hopper (sm_90a): the two passes
// that replace fmri_tpu/ops/pallas_bn.py::bn_bwd_reduce and ::bn_bwd_apply.
//
//   reduce: sums[0, c] = sum dy,  sums[1, c] = sum dy * xhat
//   apply:  dx = coef[c] * (M * dy - sums[0, c] - xhat * sums[1, c])
//                + a0[c] + a1[c] * xhat,        xhat = (x - mu[c]) * inv[c]
//
// over the M = B * S elements of each channel of a contiguous [B, C, S]
// tensor (NCHW with S = H * W, or [N, C] with S = 1). Channel c is B strided
// runs of S contiguous values; the kernels read them by index, with no
// transpose copy. x and dy are float32 or bfloat16 (same type); every sum and
// the output are float32.
//
// Bound: bytes. Both passes read x and dy once (the apply pass also writes
// dx); the arithmetic is a few FLOP per element. The TPU kernels tiled rows
// into VMEM over a sequential grid that carried the sums from step to step;
// here blocks run in no order, so the reduce splits each channel into
// `splits` chunks, one block each, writes per-chunk partials, and a second
// launch adds them in chunk order. Inside a block the tree is fixed too: no
// atomics, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum of one value per thread over the block, in a fixed order; valid in
// thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) s += scratch[w];
  }
  __syncthreads();
  return s;
}

// grid (C, splits): block (c, k) sums elements [k * chunk, (k+1) * chunk) of
// channel c and writes partial[(c * splits + k) * 2 + {0, 1}].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ mu, const float* __restrict__ inv,
                 float* __restrict__ partial, int C, long long S, long long M,
                 long long chunk) {
  __shared__ float scratch[2][kThreads / 32];
  const int c = blockIdx.x, k = blockIdx.y, splits = gridDim.y;
  const float m = mu[c], iv = inv[c];
  const long long lo = (long long)k * chunk;
  const long long hi = min(M, lo + chunk);
  float s_dy = 0.f, s_dyx = 0.f;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const long long b = i / S, s = i - b * S;
    const long long at = (b * C + c) * S + s;
    const float d = to_float(dy[at]);
    s_dy += d;
    s_dyx += d * ((to_float(x[at]) - m) * iv);
  }
  s_dy = block_sum(s_dy, scratch[0]);
  s_dyx = block_sum(s_dyx, scratch[1]);
  if (threadIdx.x == 0) {
    partial[((long long)c * splits + k) * 2 + 0] = s_dy;
    partial[((long long)c * splits + k) * 2 + 1] = s_dyx;
  }
}

// One thread per channel: sums[r, c] = sum over k in order of partial[c, k, r].
__global__ void bn_reduce_finish(const float* __restrict__ partial,
                                 float* __restrict__ sums, int C, int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < splits; ++k) {
    a += partial[((long long)c * splits + k) * 2 + 0];
    b += partial[((long long)c * splits + k) * 2 + 1];
  }
  sums[c] = a;
  sums[C + c] = b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ mu, const float* __restrict__ inv,
                const float* __restrict__ coef, const float* __restrict__ sums,
                const float* __restrict__ a0, const float* __restrict__ a1,
                float* __restrict__ dx, int C, long long S, long long total,
                float mf) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += step) {
    const int c = (int)((i / S) % C);
    const float xhat = (to_float(x[i]) - mu[c]) * inv[c];
    const float d = to_float(dy[i]);
    dx[i] = coef[c] * (mf * d - sums[c] - xhat * sums[C + c]) + a0[c] + a1[c] * xhat;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. partial is scratch of C * splits * 2 floats;
// sums is the [2, C] result. Returns the first CUDA error of the two launches.
extern "C" int bn_bwd_reduce(const void* x, const void* dy, const float* mu,
                             const float* inv, float* partial, float* sums,
                             int dtype, int C, long long S, long long M,
                             int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunk = (M + splits - 1) / splits;
  dim3 grid(C, splits);
  if (dtype == 0) {
    bn_reduce_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), mu, inv,
        partial, C, S, M, chunk);
  } else if (dtype == 1) {
    bn_reduce_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        mu, inv, partial, C, S, M, chunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_reduce_finish<<<(C + 127) / 128, 128, 0, st>>>(partial, sums, C, splits);
  return (int)cudaGetLastError();
}

extern "C" int bn_bwd_apply(const void* x, const void* dy, const float* mu,
                            const float* inv, const float* coef,
                            const float* sums, const float* a0, const float* a1,
                            float* dx, int dtype, int C, long long S,
                            long long total, float mf, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    bn_apply_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), mu, inv,
        coef, sums, a0, a1, dx, C, S, total, mf);
  } else if (dtype == 1) {
    bn_apply_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        mu, inv, coef, sums, a0, a1, dx, C, S, total, mf);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
