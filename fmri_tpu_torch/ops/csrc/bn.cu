// Train-mode BatchNorm backward for NVIDIA Hopper (sm_90a): the two passes
// that replace fmri_tpu/ops/pallas_bn.py::bn_bwd_reduce and ::bn_bwd_apply.
//
//   reduce: sums[0, c] = sum dy,  sums[1, c] = sum dy * xhat
//   apply:  dx = coef[c] * (M * dy - sums[0, c] - xhat * sums[1, c])
//                + a0[c] + a1[c] * xhat,
//           xhat = (x - mu[c]) * inv[c],  coef[c] = gamma[c] * inv[c] / M
//
// over the M = B * S elements of each channel of a contiguous [B, C, S]
// tensor (NCHW with S = H * W, or [N, C] with S = 1). Channel c is B strided
// runs of S contiguous values; the kernels read them in place, with no
// transpose copy. x and dy are float32 or bfloat16 (same type); every sum and
// the output are float32. Both passes are bound by bytes: they read x and dy
// once (the apply pass also writes dx) and do a few FLOP per element.
//
// Reduce. The TPU kernel tiled rows into VMEM over a sequential grid that
// carried the sums from step to step; here blocks run in no order, so the
// reduce splits each channel into `splits` chunks, one block each, writes
// per-chunk partials, and a second launch adds them in chunk order. Inside
// a block the tree is fixed too: no atomics, so two runs give the same bits.
//
// Apply. The tensor is B * C runs of S contiguous elements, one channel
// each. A block row of `tpr` threads (a power of two the wrapper picks, so
// that each thread makes about four vectors of its run) walks one run: the
// channel is computed once per run, and coef (formed here from gamma, in
// the wrapper's fp32 order gamma * inv / M) and the other five per-channel
// constants sit in registers for the whole run. x and dy are read as
// 16-byte vectors (4 fp32 or 8 bf16) from the first 16-byte boundary of the
// run, with scalar heads and tails where S is not a multiple of the vector;
// dx is written as float4 with streaming stores (it is not read again
// here). A grid of at most 1,056 blocks (8 of 256 threads per SM) strides
// over the runs. For S = 1 ([N, C]) a run is one element, so the apply
// kernel maps the C axis instead: a thread keeps one vector of channels and
// its constants and walks the N rows. The formula stays the TPU kernel's
// (xhat first, then the bracket): folding it into p * dy + q * x + r would
// move the cancellation in x - mu. No integer division per element: the
// channel is (run % C), once per run.

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

// VEC elements of T from 16-byte aligned p (VEC = 1: one element).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_float(__ldg(p));
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "fp32 vectors are float4");
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    static_assert(VEC == 8, "bf16 vectors are 8 values");
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 t = __bfloat1622float2(h[q]);
      f[2 * q] = t.x;
      f[2 * q + 1] = t.y;
    }
  }
}

// VEC floats to 16-byte aligned p with streaming stores.
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    __stcs(p, f[0]);
  } else {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      __stcs(reinterpret_cast<float4*>(p) + q,
             make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]));
    }
  }
}

// The per-channel constants of the apply formula.
struct ApplyCoef {
  float m, iv, cf, s0, s1, b0, b1, mf;
  ApplyCoef() = default;
  __device__ __forceinline__ ApplyCoef(int c, int C, const float* __restrict__ mu,
                                       const float* __restrict__ inv,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ sums,
                                       const float* __restrict__ a0,
                                       const float* __restrict__ a1, float mf_)
      : m(mu[c]), iv(inv[c]), cf(gamma[c] * inv[c] / mf_), s0(sums[c]),
        s1(sums[C + c]), b0(a0[c]), b1(a1[c]), mf(mf_) {}
  __device__ __forceinline__ float operator()(float xv, float d) const {
    const float xhat = (xv - m) * iv;
    return cf * (mf * d - s0 - xhat * s1) + b0 + b1 * xhat;
  }
};

// S > 1: a block row of tpr = 1 << tpr_log2 threads per run of S elements,
// kThreads / tpr runs at a time, grid-stride over the B * C runs.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_apply_runs_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ mu, const float* __restrict__ inv,
                     const float* __restrict__ gamma, const float* __restrict__ sums,
                     const float* __restrict__ a0, const float* __restrict__ a1,
                     float* __restrict__ dx, int C, long long S, long long runs,
                     float mf, int tpr_log2) {
  const int tpr = 1 << tpr_log2;
  const int tx = threadIdx.x & (tpr - 1);
  const int per_block = kThreads >> tpr_log2;
  const long long step = (long long)gridDim.x * per_block;
  for (long long run = (long long)blockIdx.x * per_block + (threadIdx.x >> tpr_log2);
       run < runs; run += step) {
    const ApplyCoef f((int)(run % C), C, mu, inv, gamma, sums, a0, a1, mf);
    const long long start = run * S;
    // scalars up to the first VEC boundary, then vectors, then the tail
    const long long head = min(S, (long long)((VEC - (start & (VEC - 1))) & (VEC - 1)));
    const long long nvec = (S - head) / VEC;
    const long long body = start + head;
    const long long tail = body + nvec * VEC;
    const long long end = start + S;
    for (long long i = start + tx; i < body; i += tpr) {
      dx[i] = f(to_float(x[i]), to_float(dy[i]));
    }
#pragma unroll 4
    for (long long v = tx; v < nvec; v += tpr) {
      float xv[VEC], dv[VEC], out[VEC];
      load_vec<T, VEC>(x + body + v * VEC, xv);
      load_vec<T, VEC>(dy + body + v * VEC, dv);
#pragma unroll
      for (int q = 0; q < VEC; ++q) out[q] = f(xv[q], dv[q]);
      store_vec<VEC>(dx + body + v * VEC, out);
    }
    for (long long i = tail + tx; i < end; i += tpr) {
      dx[i] = f(to_float(x[i]), to_float(dy[i]));
    }
  }
}

// S = 1, [N, C]: thread (blockIdx.x, threadIdx.x) keeps VEC channels and
// their constants and walks rows blockIdx.y, blockIdx.y + gridDim.y, ...
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_apply_channels_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ mu, const float* __restrict__ inv,
                         const float* __restrict__ gamma,
                         const float* __restrict__ sums,
                         const float* __restrict__ a0, const float* __restrict__ a1,
                         float* __restrict__ dx, int C, long long N, float mf) {
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (c0 >= C) return;
  ApplyCoef f[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) f[q] = ApplyCoef(c0 + q, C, mu, inv, gamma, sums, a0, a1, mf);
  for (long long n = blockIdx.y; n < N; n += gridDim.y) {
    const long long at = n * C + c0;
    float xv[VEC], dv[VEC], out[VEC];
    load_vec<T, VEC>(x + at, xv);
    load_vec<T, VEC>(dy + at, dv);
#pragma unroll
    for (int q = 0; q < VEC; ++q) out[q] = f[q](xv[q], dv[q]);
    store_vec<VEC>(dx + at, out);
  }
}

template <typename T, int VEC>
int launch_apply(const void* x, const void* dy, const float* mu, const float* inv,
                 const float* gamma, const float* sums, const float* a0,
                 const float* a1, float* dx, int C, long long S, long long runs,
                 float mf, int tpr_log2, int blocks_x, int blocks_y,
                 cudaStream_t st) {
  const T* px = static_cast<const T*>(x);
  const T* pd = static_cast<const T*>(dy);
  if (S == 1) {
    bn_apply_channels_kernel<T, VEC><<<dim3(blocks_x, blocks_y), kThreads, 0, st>>>(
        px, pd, mu, inv, gamma, sums, a0, a1, dx, C, runs / C, mf);
  } else {
    bn_apply_runs_kernel<T, VEC><<<blocks_x, kThreads, 0, st>>>(
        px, pd, mu, inv, gamma, sums, a0, a1, dx, C, S, runs, mf, tpr_log2);
  }
  return (int)cudaGetLastError();
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

// dtype: 0 float32, 1 bfloat16; vec: 1 for 16-byte vectors (x, dy and dx
// start on 16 bytes and, for S = 1, C is a multiple of the vector), else 0.
// runs = B * C. S > 1: blocks_x blocks of runs of 1 << tpr_log2 threads;
// S = 1: a (blocks_x, blocks_y) grid over channel vectors and rows.
extern "C" int bn_bwd_apply(const void* x, const void* dy, const float* mu,
                            const float* inv, const float* gamma,
                            const float* sums, const float* a0, const float* a1,
                            float* dx, int dtype, int C, long long S,
                            long long runs, float mf, int vec, int tpr_log2,
                            int blocks_x, int blocks_y, void* stream) {
  if (tpr_log2 < 0 || tpr_log2 > 8 || blocks_x < 1 || blocks_y < 1 || C < 1 ||
      S < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch_apply<float, 4>(x, dy, mu, inv, gamma, sums, a0, a1, dx, C, S,
                                        runs, mf, tpr_log2, blocks_x, blocks_y, st)
               : launch_apply<float, 1>(x, dy, mu, inv, gamma, sums, a0, a1, dx, C, S,
                                        runs, mf, tpr_log2, blocks_x, blocks_y, st);
  }
  if (dtype == 1) {
    return vec ? launch_apply<__nv_bfloat16, 8>(x, dy, mu, inv, gamma, sums, a0, a1,
                                                dx, C, S, runs, mf, tpr_log2,
                                                blocks_x, blocks_y, st)
               : launch_apply<__nv_bfloat16, 1>(x, dy, mu, inv, gamma, sums, a0, a1,
                                                dx, C, S, runs, mf, tpr_log2,
                                                blocks_x, blocks_y, st);
  }
  return (int)cudaErrorInvalidValue;
}
