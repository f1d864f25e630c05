// Convolution weight gradient for NVIDIA Hopper (sm_90a) on the tensor
// cores: the port of fmri_tpu/ops/pallas_dw.py::_tap_matmul, as used by
// conv2d_dw and conv2d_transpose_dw.
//
// What it computes. Both weight grads are one product over the reduction
// index r = (b, ph, pw) of a "shifted" operand S [B, Cs, Hs, Ws] and a
// "direct" operand U [B, Cu, PH, PW] (NCHW, contiguous):
//
//   out[cu, cs, kh, kw] = sum_r S[b, cs, ph*stride - pad + kh,
//                                       pw*stride - pad + kw] * U[b, cu, ph, pw]
//
// with S read as zero outside [0, Hs) x [0, Ws).
//   * Conv2d (OIHW dW):           S = x, U = dy, grid = the output.
//   * ConvTranspose2d (IOHW dW,
//     torch's scatter convention): S = dy, U = x, grid = the input.
// The result lands in the port's weight layout with no transpose; the zero
// padding and the TPU kernel's parity planes never exist in device memory.
//
// What bounds it. As a matrix product D[m][n] = sum_r A[m][r] * B[n][r],
// with m = cs*K*K + tap (75 to 6,400 on the res64 step) and n = cu (3 to
// 256), over r up to 786,432: 2 to 80 GFLOP per call against at most ~100 MB
// of operands, so tensor-core operations bound it. fp32 operands run as
// 3xTF32 (a = hi + lo, hi = tf32(a), lo = tf32(a - hi), both rounded to
// nearest with ties away; D += hi*hi + hi*lo + lo*hi in fp32): three TF32
// passes, ~165 TFLOP/s of the H100's 495, with ~21 bits kept per operand, so
// fp32 parity holds (single-pass TF32 is never used). bf16 operands run one
// bf16 pass (989 TFLOP/s), whose products are exact in fp32.
//
// What the design does about it.
//   * wgmma (m64nNk8 tf32, m64nNk16 bf16): m on the 64-row M side, one or
//     two consumer warpgroups per block (MT = 64 or 128 rows of D); n on the
//     N side, NT = 8, 32, 64 or 128 (the 3-channel out conv is a 64 x 8
//     tile). A comes from registers: each thread loads its fragment of the
//     staged S tile and, for fp32, splits it into hi and lo there. B comes
//     from shared memory through a 128-byte-swizzled K-major descriptor; for
//     fp32 the staged U tile is split once per stage into hi (in place) and
//     lo (one of two buffers), shared by both warpgroups. Each stage's
//     product lands in a register tile that is then added, in fp32 with
//     round-to-nearest, into the block's sum: the tensor core does not
//     round to nearest as it accumulates, and over the ~200 stages of a
//     split that bias would reach ~1e-4 of the result.
//   * A ring of 4 shared-memory stages (8 for NT <= 32), each one reduction
//     tile of RK positions of one image (RK = 128 bytes of a row: 32 fp32 or
//     64 bf16), filled by TMA: one thread, one mbarrier per stage. Tiles
//     k+1 .. k+2 (k+6) are in flight while tile k is split and issued, and
//     tile k-1 still multiplies on the tensor cores (wgmma is asynchronous:
//     a stage is waited for only before the next one is issued).
//   * U is a plain box of the [B, Cu, PH*PW] view, [RK positions x NT
//     channels], landing in the 128-byte swizzle the descriptor reads.
//   * S is not gathered element by element: a stage's (tap, position) pairs
//     all read one box of S, [Cp channels x Hp rows x Wp columns] (the
//     channels of the tile's m rows; the K + (rows - 1) * stride input rows
//     under the tile's output rows; its columns, with the zero padding
//     supplied by TMA's out-of-bounds fill). Each thread finds its fragment
//     in that patch as row offset (channel, kh, kw: fixed per thread) plus
//     position offset (ph, pw: a per-stage table of RK entries), so the
//     (b, ph, pw) decode happens once per staged row and no tap is fetched
//     from device memory twice. A 4-byte-per-element gather of the same
//     data took 70% of the kernel's time at the widest calls.
//   * The reduction is tiled per image (tiles of RK positions of one
//     b, zero past PH*PW) and split across blocks; each block writes
//     its partial tile and a second launch adds the partials in split order.
//     No atomics: two runs give the same bits. The tile, the patch and the
//     split count come from ops/dw.py::plan, which models waves of blocks
//     on 132 SMs; the C entry checks that the patch holds every tap.
//   * Every call takes this one asynchronous path. TMA describes an operand
//     only if its base and its row strides are whole 16-byte units, and the
//     res100 step's rows are not: 100, 50, 25, 13 and 7 columns (and U's
//     2,500, 625, 169 and 49 positions) of bf16 are never, of fp32 below 100
//     columns not. Such an operand is first re-laid, by dw_pitch_rows on
//     the same stream, into scratch whose rows start every `pitch` elements
//     (the row rounded up to 16 bytes); the tensor map keeps the true
//     extents with the padded strides, so TMA's out-of-bounds fill still
//     supplies the convolution's zero padding and the pad columns are never
//     read as data. The copy reads and writes each staged operand once (at
//     res100 bf16, batch 256: ~2 ms of HBM traffic a step against the ~87 ms
//     that filling the ring with synchronous element-by-element loads, the
//     path it replaces, lost). A patch side over 256 (TMA's limit for a box;
//     no preset gives one) is refused, not loaded another way.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Ring depth: 4 stages for the wide tiles; 8 for the narrow ones, whose
// stages are short, so more tiles must be in flight to cover the latency.
template <int NT>
__host__ __device__ constexpr int ring_stages() {
  return NT >= 64 ? 4 : 8;
}
constexpr int kRowBytes = 128;  // bytes of one staged reduction run: RK elements

struct Geometry {
  int B, Cs, Hs, Ws, Cu, PH, PW, K, stride, pad;
  int M, N;             // M = Cs*K*K, N = Cu
  int tiles_per_image;  // ceil(PH*PW / RK)
  int tiles;            // B * tiles_per_image
  int chunk;            // reduction tiles per split
  int within_row;       // a tile's positions lie in one output row (PW % RK == 0)
  int Cp, Hp, Wp;       // S patch of one stage: channels, rows, columns
  int patch_stride;     // bytes between the patches of two stages
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// K-major operand in 128-byte-swizzled rows of 128 bytes: 8-row atoms of
// 1,024 bytes (stride byte offset 64 x 16 B); the leading offset is unused.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64 x N x k8 (tf32) and m64 x N x k16 (bf16) products, A from registers
// (4 x 32 bits a thread), B by descriptor, D += A * B in fp32.
template <int N> struct Wgmma;

template <> struct Wgmma<8> {
  static __device__ __forceinline__ void tf32(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void tf32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void tf32(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void tf32(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// grid (ceil(M / MT), ceil(N / NT), splits), MT * 2 threads (one warpgroup
// per 64 rows of D); writes out[split][n][m]. Dynamic shared memory, from a
// 1,024-byte boundary: the U ring, the fp32 lo buffers, the S patches, the
// position offsets, the barriers (sized by `launch`).
template <typename T, int MT, int NT>
__global__ void __launch_bounds__(MT * 2, 1)
dw_wgmma(float* __restrict__ out, const __grid_constant__ CUtensorMap umap,
         const __grid_constant__ CUtensorMap smap, Geometry g) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kThreads = MT * 2;
  constexpr int RK = kRowBytes / static_cast<int>(sizeof(T));
  constexpr int kBStage = NT * kRowBytes;
  constexpr int kKSteps = 4;  // RK / 8 (tf32) or RK / 16 (bf16)
  constexpr int kStages = ring_stages<NT>();
  constexpr int kAhead = kStages - 2;  // tiles in flight ahead of the one multiplied
  constexpr int kUnit = 16 / static_cast<int>(sizeof(T));  // a TMA box starts on 16 bytes

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* b_ring = base;
  uint8_t* b_lo = b_ring + kStages * kBStage;  // fp32: three lo buffers, stage % 3
  uint8_t* patches = b_lo + (kF32 ? 3 * kBStage : 0);
  int* ro_tab = reinterpret_cast<int*>(patches + kStages * g.patch_stride);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ro_tab + kStages * RK);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * NT;
  const int kk = g.K * g.K, phw = g.PH * g.PW;
  const int cs_lo = m0 / kk;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int t_lo = blockIdx.z * g.chunk;
  const int ntiles = min(g.tiles, t_lo + g.chunk) - t_lo;
  const int patch_bytes = g.Cp * g.Hp * g.Wp * static_cast<int>(sizeof(T));

  // Stage reduction tile t (RK positions of one image) into ring slot s: the
  // U box [RK positions x NT channels], the S patch [Cp channels x Hp rows x
  // Wp columns] that every (tap, position) pair of the tile reads, and the
  // offset of each position in that patch.
  auto load = [&](int t, int s) {
    const int b = t / g.tiles_per_image;
    const int pos0 = (t - b * g.tiles_per_image) * RK;
    const int ph0 = pos0 / g.PW;
    const int pw0 = g.within_row ? pos0 - ph0 * g.PW : 0;
    // The patch starts at input row h0 and at column w0 rounded down to 16
    // bytes (TMA's rule for the innermost coordinate); shift is the rest.
    const int h0 = ph0 * g.stride - g.pad, w0 = (pw0 * g.stride - g.pad) & ~(kUnit - 1);
    const int shift = pw0 * g.stride - g.pad - w0;
    for (int k = tid; k < RK; k += kThreads) {
      const int pos = pos0 + k;
      int ro = shift;
      if (pos < phw) {
        const int ph = pos / g.PW;
        ro += (ph - ph0) * g.stride * g.Wp + (pos - ph * g.PW - pw0) * g.stride;
      }
      ro_tab[s * RK + k] = ro;
    }
    if (tid == 0) {
      fence_proxy_async();
      mbar_expect_tx(&bars[s], kBStage + patch_bytes);
      tma_load_3d(b_ring + s * kBStage, &umap, &bars[s], pos0, n0, b);
      tma_load_4d(patches + s * g.patch_stride, &smap, &bars[s], w0, h0, cs_lo, b);
    }
  };

  // Make stage j ready for the tensor cores once its tiles have landed: for
  // fp32, split the U tile into hi (in place) and lo (buffer j % 3), then
  // order these generic-proxy writes before wgmma's reads of them.
  auto prepare = [&](int j) {
    const int s = j % kStages;
    mbar_wait(&bars[s], (j / kStages) & 1);
    if constexpr (kF32) {
      float4* hi = reinterpret_cast<float4*>(b_ring + s * kBStage);
      float4* lo = reinterpret_cast<float4*>(b_lo + (j % 3) * kBStage);
      for (int e = tid; e < kBStage / 16; e += kThreads) {
        const float4 v = hi[e];
        const uint32_t hx = tf32_rna(v.x), hy = tf32_rna(v.y), hz = tf32_rna(v.z),
                       hw = tf32_rna(v.w);
        hi[e] = make_float4(__uint_as_float(hx), __uint_as_float(hy), __uint_as_float(hz),
                            __uint_as_float(hw));
        lo[e] = make_float4(__uint_as_float(tf32_rna(v.x - __uint_as_float(hx))),
                            __uint_as_float(tf32_rna(v.y - __uint_as_float(hy))),
                            __uint_as_float(tf32_rna(v.z - __uint_as_float(hz))),
                            __uint_as_float(tf32_rna(v.w - __uint_as_float(hw))));
      }
    }
    fence_proxy_async();
  };

  for (int i = 0; i < kAhead; ++i)
    if (i < ntiles) load(t_lo + i, i);
  if (ntiles > 0) prepare(0);

  // acc: the stage on the tensor cores; sum: the block's total, to which
  // each landed stage is added in fp32 with round-to-nearest (the tensor
  // core's own accumulation does not round to nearest, and a split adds
  // up to ~200 stages).
  float acc[NT / 2], sum[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = sum[i] = 0.f;

  // This thread's fragment rows (warpgroup wg owns rows 64 wg .. 64 wg + 63)
  // and where their (channel, tap) sits in a patch. Rows past M read a real
  // patch value; their sums are never written.
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = (tid >> 7) * 64 + (warp & 3) * 16 + gq;
  int mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = min(m0 + row0 + 8 * i, g.M - 1);
    const int cs = m / kk, tap = m - cs * kk, kh = tap / g.K;
    mb[i] = ((cs - cs_lo) * g.Hp + kh) * g.Wp + tap - kh * g.K;
  }

  // One barrier a stage. Stage kt - 1 multiplies on the tensor cores while
  // stage kt is issued and stage kt + 1 is prepared; tiles up to kt + kAhead
  // are in flight.
  for (int kt = 0; kt < ntiles; ++kt) {
    const int s = kt % kStages;
    // Stage kt is prepared by every thread, and every warpgroup has waited
    // for stage kt - 2, so its ring slot takes tile kt + kAhead.
    __syncthreads();
    if (kt + kAhead < ntiles) load(t_lo + kt + kAhead, (kt + kAhead) % kStages);

    wgmma_wait_all();  // stage kt - 1 has landed in acc
    fence_operands(acc);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) sum[i] += acc[i];

    uint8_t* bsrc = b_ring + s * kBStage;
    uint8_t* blo = b_lo + (kt % 3) * kBStage;
    const T* patch = reinterpret_cast<const T*>(patches + s * g.patch_stride);
    const int* ro = ro_tab + s * RK;
    const uint64_t desc = sw128_desc(bsrc);
    if constexpr (kF32) {
      const uint64_t desc_lo = sw128_desc(blo);
      uint32_t ahi[kKSteps][4], alo[kKSteps][4];
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const int r0 = ro[ks * 8 + tq], r1 = ro[ks * 8 + tq + 4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {  // (row, k) = (g, t), (g+8, t), (g, t+4), (g+8, t+4)
          const float x = patch[mb[v & 1] + (v >> 1 ? r1 : r0)];
          ahi[ks][v] = tf32_rna(x);
          alo[ks][v] = tf32_rna(x - __uint_as_float(ahi[ks][v]));
        }
      }
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {  // the small terms first; the first overwrites acc
        Wgmma<NT>::tf32(acc, alo[ks], desc + 2 * ks, ks > 0);
        Wgmma<NT>::tf32(acc, ahi[ks], desc_lo + 2 * ks, 1);
        Wgmma<NT>::tf32(acc, ahi[ks], desc + 2 * ks, 1);
      }
    } else {
      const uint16_t* p16 = reinterpret_cast<const uint16_t*>(patch);
      uint32_t af[kKSteps][4];
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {  // rows g, g+8; k pairs 2t, 2t+1 and 2t+8, 2t+9
          const int k = ks * 16 + 2 * tq + 8 * (v >> 1);
          af[ks][v] = uint32_t(p16[mb[v & 1] + ro[k]]) | (uint32_t(p16[mb[v & 1] + ro[k + 1]]) << 16);
        }
      }
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) Wgmma<NT>::bf16(acc, af[ks], desc + 2 * ks, ks > 0);
    }
    wgmma_commit();
    if (kt + 1 < ntiles) prepare(kt + 1);
  }
  wgmma_wait_all();
  fence_operands(acc);
  if (ntiles > 0) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) sum[i] += acc[i];
  }

  float* dst = out + (long long)blockIdx.z * g.N * g.M;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int m = m0 + row0 + 8 * (v >> 1), n = n0 + 8 * j + 2 * tq + (v & 1);
      if (m < g.M && n < g.N) dst[(long long)n * g.M + m] = sum[4 * j + v];
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

// dst[r * pitch + c] = src[r * width + c] for c < width, zero for width <= c
// < pitch, r < rows: an operand whose rows are not whole 16-byte units,
// re-laid on rows that are, for TMA. W is the element's bits (uint16_t for
// bf16, uint32_t for fp32): the copy is exact. One thread per 16 bytes of
// dst: the stores are whole and coalesced, the loads element by element,
// neighbouring threads on neighbouring addresses.
template <typename W>
__global__ void dw_pitch_rows(const W* __restrict__ src, W* __restrict__ dst, long long rows,
                              int width, int pitch) {
  constexpr int kUnit = 16 / static_cast<int>(sizeof(W));
  const int units = pitch / kUnit;
  const long long n = rows * units, step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const long long r = i / units;
    const int c0 = (int)(i - r * units) * kUnit;
    const W* from = src + r * width + c0;
    alignas(16) W v[kUnit];
#pragma unroll
    for (int j = 0; j < kUnit; ++j) v[j] = c0 + j < width ? from[j] : W(0);
    *reinterpret_cast<uint4*>(dst + r * pitch + c0) = *reinterpret_cast<const uint4*>(v);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kEncodeFailed = 1000;  // a TMA map could not be made
constexpr int kTooLarge = 1001;      // the S patch does not fit in shared memory
constexpr int kPatchShort = 1002;    // the S patch misses a tap the kernel reads
constexpr int kBoxTooLarge = 1003;   // a patch side over 256, TMA's limit for a box
constexpr int kMisaligned = 1004;    // an operand's base or row pitch not on 16 bytes

// An operand as its tensor map sees it: its base and the pitch, in
// elements, between the starts of its rows (its innermost extent).
struct Operand {
  const void* base;
  long long pitch;
};

template <typename T, int MT, int NT>
int launch(Operand S, Operand U, float* dst, const Geometry& g, int splits, cudaStream_t st) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int RK = kRowBytes / static_cast<int>(sizeof(T));
  constexpr int kMaxBytes = 232448;
  constexpr int kStages = ring_stages<NT>();
  const long long bytes = 1024  // alignment slack
      + kStages * NT * kRowBytes + (kF32 ? 3 * NT * kRowBytes : 0)  // U ring, lo
      + (long long)kStages * g.patch_stride                        // S patches
      + kStages * RK * 4 + kStages * 8;                            // offsets, barriers
  if (bytes > kMaxBytes) return kTooLarge;
  auto kernel = dw_wgmma<T, MT, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBytes);
  if (err != cudaSuccess) return (int)err;
  // U as [B, Cu, PH*PW] and S as [B, Cs, Hs, Ws]: the true extents (TMA
  // fills what lies past them with zeros) over the pitched row strides.
  const CUtensorMapDataType type =
      kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t esz = sizeof(T), phw = (cuuint64_t)g.PH * g.PW;
  const cuuint64_t udims[3] = {phw, (cuuint64_t)g.Cu, (cuuint64_t)g.B};
  const cuuint64_t ustrides[2] = {U.pitch * esz, U.pitch * g.Cu * esz};
  const cuuint32_t ubox[3] = {(cuuint32_t)RK, (cuuint32_t)NT, 1};
  const cuuint64_t sdims[4] = {(cuuint64_t)g.Ws, (cuuint64_t)g.Hs, (cuuint64_t)g.Cs,
                               (cuuint64_t)g.B};
  const cuuint64_t sstrides[3] = {S.pitch * esz, S.pitch * g.Hs * esz,
                                  S.pitch * g.Hs * g.Cs * esz};
  const cuuint32_t sbox[4] = {(cuuint32_t)g.Wp, (cuuint32_t)g.Hp, (cuuint32_t)g.Cp, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  EncodeTiled encode = encode_tiled();
  CUtensorMap umap = {}, smap = {};
  if (encode == nullptr ||
      encode(&umap, type, 3, const_cast<void*>(U.base), udims, ustrides, ubox, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&smap, type, 4, const_cast<void*>(S.base), sdims, sstrides, sbox, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kEncodeFailed;
  dim3 grid((g.M + MT - 1) / MT, (g.N + NT - 1) / NT, splits);
  kernel<<<grid, MT * 2, (size_t)bytes, st>>>(dst, umap, smap, g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int mt, int nt, Operand S, Operand U, float* dst, const Geometry& g, int splits,
             cudaStream_t st) {
  if (mt == 64) {
    switch (nt) {
      case 8: return launch<T, 64, 8>(S, U, dst, g, splits, st);
      case 32: return launch<T, 64, 32>(S, U, dst, g, splits, st);
      case 64: return launch<T, 64, 64>(S, U, dst, g, splits, st);
      case 128: return launch<T, 64, 128>(S, U, dst, g, splits, st);
    }
  } else if (mt == 128 && nt == 128) {
    return launch<T, 128, 128>(S, U, dst, g, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The operand `src` of `rows` rows of `width` elements, as TMA will read
// it: itself where its base and rows lie on 16 bytes (pitch == width), else
// copied into `stage` on rows of `pitch` elements (dw_pitch_rows).
template <typename T>
int place(const void* src, void* stage, long long rows, int width, int pitch, Operand* op,
          cudaStream_t st) {
  constexpr int kUnit = 16 / static_cast<int>(sizeof(T));
  if (pitch < width || pitch % kUnit != 0) return kMisaligned;
  if (stage == nullptr) {
    if (pitch != width || reinterpret_cast<uintptr_t>(src) % 16 != 0) return kMisaligned;
    *op = Operand{src, pitch};
    return 0;
  }
  if (reinterpret_cast<uintptr_t>(stage) % 16 != 0) return kMisaligned;
  const long long units = rows * (pitch / kUnit);
  const int blocks = (int)min((units + 255) / 256, 8192LL);
  using W = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
  if (blocks > 0)
    dw_pitch_rows<W><<<blocks, 256, 0, st>>>(static_cast<const W*>(src), static_cast<W*>(stage),
                                             rows, width, pitch);
  *op = Operand{stage, pitch};
  return (int)cudaGetLastError();
}

template <typename T>
int run(int mt, int nt, const void* S, void* s_stage, int s_pitch, const void* U, void* u_stage,
        int u_pitch, float* dst, const Geometry& g, int splits, cudaStream_t st) {
  Operand s_op, u_op;
  int err = place<T>(S, s_stage, (long long)g.B * g.Cs * g.Hs, g.Ws, s_pitch, &s_op, st);
  if (err == 0)
    err = place<T>(U, u_stage, (long long)g.B * g.Cu, g.PH * g.PW, u_pitch, &u_op, st);
  return err != 0 ? err : dispatch<T>(mt, nt, s_op, u_op, dst, g, splits, st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. mt x nt: the tile of D one block owns (64 x
// 8, 32, 64 or 128, or 128 x 128); Cp x Hp x Wp: the S patch one stage holds,
// within_row: a tile's positions lie in one output row. S_pitch and U_pitch:
// the row pitches, in elements, that TMA reads S's rows (Ws) and U's rows
// (PH*PW) on, whole 16-byte units; where one differs from its row, or the
// operand's base is not on 16 bytes, `S_stage` / `U_stage` is scratch of
// rows * pitch elements that the operand is first copied into (else null).
// The wrapper picks all of them (ops/dw.py::plan); this entry only checks
// that the patch holds every (tap, position) pair of a tile. The reduction
// is `tiles_per_image` tiles of RK positions per image, `chunk` tiles per
// split. With splits > 1, partial is scratch of splits * N * M floats; with
// splits == 1 the blocks write out directly. out is [Cu, Cs, K, K] float32.
// Returns 0, a CUDA error code, 1000 when a TMA map cannot be encoded, 1001
// when the S patches do not fit in shared memory, 1002 when the patch is too
// small, 1003 when a patch side is over 256, or 1004 when an operand TMA
// would read is not on 16 bytes.
extern "C" int tap_matmul(const void* S, void* S_stage, int S_pitch, const void* U,
                          void* U_stage, int U_pitch, float* partial, float* out, int dtype,
                          int mt, int nt, int B, int Cs, int Hs, int Ws, int Cu, int PH,
                          int PW, int K, int stride, int pad, int splits, int chunk, int Cp,
                          int Hp, int Wp, int within_row, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int esz = dtype == 0 ? 4 : 2, rk = kRowBytes / esz, phw = PH * PW;
  const int per_image = (phw + rk - 1) / rk;
  // A tile spans one output row (within_row) or up to `rows` of them; its
  // taps reach K + (rows - 1) * stride input rows and, from a start up to
  // unit - 1 columns early (TMA boxes start on 16 bytes), `cols` columns.
  const int unit = 16 / esz;
  const int rows = within_row ? 1 : (rk % PW == 0 ? rk / PW : (rk - 1) / PW + 2);
  const int cols = (within_row ? rk - 1 : PW - 1) * stride + K + unit - 1;
  if ((within_row && PW % rk != 0) || Wp % unit != 0 || Wp < cols ||
      Hp < (rows - 1) * stride + K || Cp < min(Cs, (mt - 1) / (K * K) + 2))
    return kPatchShort;
  if (Wp > 256 || Hp > 256 || Cp > 256) return kBoxTooLarge;
  const long long patch = (long long)Cp * Hp * Wp * esz;
  const int patch_stride = (int)((patch + 1023) / 1024 * 1024);
  Geometry g{B, Cs, Hs, Ws, Cu, PH, PW, K, stride, pad, Cs * K * K, Cu,
             per_image, B * per_image, chunk, within_row, Cp, Hp, Wp, patch_stride};
  float* dst = splits > 1 ? partial : out;
  const int err = dtype == 0 ? run<float>(mt, nt, S, S_stage, S_pitch, U, U_stage, U_pitch, dst,
                                          g, splits, st)
                             : run<__nv_bfloat16>(mt, nt, S, S_stage, S_pitch, U, U_stage,
                                                  U_pitch, dst, g, splits, st);
  if (err != 0 || splits == 1) return err;
  const long long count = (long long)g.N * g.M;
  const int blocks = (int)min((count + 255) / 256, 4096LL);
  dw_finish<<<blocks, 256, 0, st>>>(partial, out, count, splits);
  return (int)cudaGetLastError();
}
