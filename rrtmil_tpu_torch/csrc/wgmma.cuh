// The bf16 product on Hopper's warpgroup tensor cores (wgmma), fed by a
// TMA ring: K2's four products with bf16 products (region_layer_bwd.cu,
// rb_gemm_tc), the weight gradients o^T gm and z^T round(dqkv) and the data
// gradients gm Wp^T and round(dqkv) Wqkv^T.
//
// What bounds them on an H100: operations.  At c16_r50, B = 8 (73,728
// tokens, C = 512) the four take ~309 GFLOP, 0.31 ms at the bf16 peak,
// against ~0.4 ms of bytes (the bf16 operands read once, the f32 outputs and
// partials written once).  The SIMT product of common.cuh ran them at ~21
// TFLOP/s (14.5 ms).
//
// Design (one block of three warpgroups per 128 x 128 output tile):
//  * one thread of warpgroup 0 (the producer) walks the tile's k steps of
//    64 and asks TMA for the A and B tiles of each, into a ring of STAGES
//    stages in shared memory; a `full` mbarrier per stage counts the bytes
//    in, an `empty` one the eight consumer warps done with it;
//  * warpgroups 1 and 2 (the consumers) each own 64 rows of the tile and run
//    wgmma m64n128k16 (bf16 in, fp32 sums in 64 registers a thread) on the
//    stage, four k16 slices a stage, one wgmma group in flight, and release
//    the stage the group before read;
//  * operands are read where they lie, in the layout wgmma takes as it is:
//    the weight gradients A^T B read A (tokens, M) and B (tokens, N) as
//    MN-major operands (the transpose flags of wgmma), the data gradients
//    A B^T read A (M, K) and B (N, K) as K-major ones; TMA writes each box
//    with the 128-byte swizzle the descriptors name, and fills rows past
//    the matrix with zeros, so a ragged edge adds nothing;
//  * the weight gradients split the token axis into chunks of kchunk (a
//    multiple of the 64-row k step, so no k step crosses two chunks): chunk
//    z writes its fp32 partial tile at out + z * zstride and a second pass
//    (rb_reduce) adds the partials in a fixed order.  No atomics: every
//    call gives the same bits.
// Tensor maps are encoded on the host with libcuda's cuTensorMapEncodeTiled,
// found in the loaded libcuda.so.1 at first use, and passed to the kernel
// by value (__grid_constant__).
//
// Folds (fold-parallel cross-validation, F folds in one launch): every
// tensor map is 3-D, (columns, rows of one fold, fold), so a box never
// reaches into the next fold's rows (TMA fills rows past the fold's end
// with zeros, as past a matrix's).  The weight gradients split each fold's
// token rows into chunks of their own (fold f's partials are chunks f kcpf
// .. f kcpf + kcpf - 1); the data gradients give each fold's rows its own
// B, b_fs elements past fold 0's.  F = 1 is the product as it was.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "tc.cuh"

namespace rrt {
namespace wg {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 5;
constexpr int THREADS = 384;                 // producer + two consumer warpgroups
constexpr int TILE_BYTES = BM * BK * 2;      // one operand's stage: 16 KB
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // A and B
constexpr int BOX_BYTES = 64 * BK * 2;       // one 64 x 64 box (MN-major halves)
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of `map` at (c0 inner, c1 rows, c2 fold) into shared memory at
// dst, completing `bar`'s transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: lbo / sbo in bytes
// (K-major: sbo = 1024, the stride of 8-row groups, lbo unused; MN-major:
// lbo = the stride of 64-wide MN blocks, sbo = 1024, the stride of 8-deep
// k groups)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) += A (64 x 16) B (16 x 128), both bf16 in shared memory;
// TA / TB = 1 read A / B as MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_64x128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// out[M, N] (+ z * zstride) = A B over the k rows of chunk z = blockIdx.z:
// MN: A stored (K, M), B stored (K, N) (A^T B), the K rows in F folds of
// K / F, each split into chunks of its own; else A stored (M, K), B stored
// (N, K) per fold (A B^T), the M rows in F folds of M / F.  TO float or
// bf16.
template <bool MN, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  TO* __restrict__ out, int ldc, int M, int N, int K, int kchunk,
                  long long zstride, int F) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' alignment
  const uint32_t full0 = base + STAGES * STAGE_BYTES, empty0 = full0 + STAGES * 8;
  // MN: fold f of the token rows, chunk kb .. of it; else fold f of the
  // output rows, tile m0 .. of it, stored from row f * M / F on
  const int Kf = MN ? K / F : K, kcpf = (Kf + kchunk - 1) / kchunk;
  const int Mf = MN ? M : M / F, tpf = (Mf + BM - 1) / BM;
  const int f = MN ? blockIdx.z / kcpf : blockIdx.y / tpf;
  const int m0 = (MN ? blockIdx.y : blockIdx.y % tpf) * BM, n0 = blockIdx.x * BN;
  const int kb = (MN ? blockIdx.z % kcpf : 0) * kchunk;
  const int nk = (min(Kf, kb + kchunk) - kb + BK - 1) / BK;
  out += MN ? 0 : (long long)f * Mf * ldc;
  M = Mf;
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {  // producer
    if (t == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&ta) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&tb) : "memory");
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, STAGE_BYTES);
        const uint32_t sa = base + s * STAGE_BYTES, sb = sa + TILE_BYTES;
        const int k0 = kb + kt * BK;
        if (MN) {  // 64-wide boxes of (k rows, MN columns)
          tma_load(sa, &ta, m0, k0, f, full);
          tma_load(sa + BOX_BYTES, &ta, m0 + 64, k0, f, full);
          tma_load(sb, &tb, n0, k0, f, full);
          tma_load(sb + BOX_BYTES, &tb, n0 + 64, k0, f, full);
        } else {   // (128 rows, 64 k) boxes
          tma_load(sa, &ta, k0, m0, f, full);
          tma_load(sb, &tb, k0, n0, f, full);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64 c .. 64 c + 63 of the tile
  const int c = wgi - 1;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const uint32_t a_off = MN ? c * BOX_BYTES : c * 64 * 128;
  const uint32_t lbo = MN ? BOX_BYTES : 16, step = MN ? 16 * 128 : 32;
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full0 + 8 * s, (kt / STAGES) & 1);
    const uint32_t sa = base + s * STAGE_BYTES + a_off, sb = base + s * STAGE_BYTES + TILE_BYTES;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_64x128<MN ? 1 : 0, MN ? 1 : 0>(d, desc(sa + kk * step, lbo, 1024),
                                         desc(sb + kk * step, lbo, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(d);
    if (prev >= 0 && (threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * prev);
    prev = s;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);

  // d[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  const int warp = t >> 5, lane = t & 31;
  const int row0 = m0 + 64 * c + 16 * warp + (lane >> 2), col0 = n0 + 2 * (lane & 3);
  TO* o = out + (long long)blockIdx.z * zstride;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < M && col < N) store2(o + (long long)row * ldc + col, d[4 * j + 2 * h],
                                     d[4 * j + 2 * h + 1]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled (PyTorch has loaded libcuda.so.1)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr) fn = (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// F (rows, cols) bf16 matrices with row stride ld and fold stride fs
// (elements), read in boxes of (box_rows, box_cols) of one fold, 128-byte
// swizzle, zeros past each fold's edges
inline bool tensor_map(CUtensorMap* map, EncodeTiled enc, const void* p, long long rows,
                       long long cols, long long ld, int F, long long fs, int box_rows,
                       int box_cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)F};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)(F > 1 ? fs : rows * ld) * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// MN: out = A^T B with A (K, M), B (K, N), chunk z of kchunk k rows at
// out + z * zstride; else out = A B^T with A (M, K), B (N, K), one chunk.
// bf16 operands with row strides lda / ldb (multiples of 8, 16-byte aligned
// bases), out (M, N) with row stride ldc, N a multiple of 8.  F folds: MN,
// the K rows in F folds of K / F, fold f's partials chunks f kcpf .. (kcpf
// = ceil(K / F / kchunk)); else the M rows in F folds of M / F, fold f's B
// b_fs elements past fold 0's (a multiple of 8).
template <bool MN, typename TO>
cudaError_t launch_gemm_wgmma(const void* A, int lda, const void* B, int ldb, void* out,
                              int ldc, int M, int N, int K, int kchunk, long long zstride,
                              int F, long long b_fs, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || kchunk <= 0 || kchunk % BK != 0 || N % 8 != 0 ||
      lda % 8 != 0 || ldb % 8 != 0 || ldc % 2 != 0 || ((uintptr_t)A & 15) != 0 ||
      ((uintptr_t)B & 15) != 0 || F < 1 || (MN ? K % F : M % F) != 0 || b_fs % 8 != 0)
    return cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap ta, tb;
  const int Kf = MN ? K / F : K, Mf = MN ? M : M / F;
  const bool ok = MN ? tensor_map(&ta, enc, A, Kf, M, lda, F, (long long)Kf * lda, BK, 64) &&
                           tensor_map(&tb, enc, B, Kf, N, ldb, F, (long long)Kf * ldb, BK, 64)
                     : tensor_map(&ta, enc, A, Mf, K, lda, F, (long long)Mf * lda, BM, BK) &&
                           tensor_map(&tb, enc, B, N, K, ldb, F, b_fs, BN, BK);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_wgmma_kernel<MN, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int kcpf = (Kf + kchunk - 1) / kchunk;
  const dim3 grid((N + BN - 1) / BN, (MN ? 1 : F) * ((Mf + BM - 1) / BM), (MN ? F : 1) * kcpf);
  gemm_wgmma_kernel<MN, TO><<<grid, THREADS, SMEM_BYTES, stream>>>(ta, tb, (TO*)out, ldc, M, N,
                                                                     K, kchunk, zstride, F);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace rrt
