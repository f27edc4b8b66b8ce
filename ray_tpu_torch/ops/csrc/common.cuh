// Helpers shared by the port's hand-written kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtt {

// dtype codes passed from Python (ray_tpu_torch/ops/_build.py DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr float kLog2e = 1.4426950408889634f;

// batch, sequence and head strides of a [B, T, H, D] tensor, in elements
// (the last axis is contiguous)
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte vector load of VEC<T> elements, widened to float.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks (sm_80 and later; used by the bf16 kernels).
//
// mma.sync m16n8k16, bf16 operands, f32 accumulators. Fragment layouts, with
// lane = 4 * g + t (g = lane >> 2, t = lane & 3):
//   A (16 x 16, row-major), 4 registers of two bf16 each:
//     a0 = (row g, cols 2t, 2t+1)    a1 = (row g+8, cols 2t, 2t+1)
//     a2 = (row g, cols 2t+8, 2t+9)  a3 = (row g+8, cols 2t+8, 2t+9)
//   B (16 x 8, k x n, "col": stored n-major), 2 registers:
//     b0 = (k 2t, 2t+1; n g)         b1 = (k 2t+8, 2t+9; n g)
//   C (16 x 8) f32: c0, c1 = (row g, cols 2t, 2t+1); c2, c3 = (row g+8, same)
// Two C tiles side by side (cols 0-7 and 8-15), rounded to bf16 and packed
// in pairs, are an A fragment: {c[0]01, c[0]23, c[1]01, c[1]23}. That is how
// a softmax or gradient tile goes from one product into the next without a
// trip through shared memory.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats rounded to bf16 in one 32-bit register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses (16-byte aligned) of matrix i, and register i of lane 4g+t holds
// (row g, cols 2t, 2t+1) of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed: register i of lane 4g+t holds
// (rows 2t, 2t+1; col g) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Asynchronous 16-byte copy global -> shared, bypassing L1. With valid ==
// false nothing is read and the 16 bytes are zero-filled; `src` must still
// be a valid address, so callers clamp the row.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// The same for one 4-byte word (f32 row statistics, which need no alignment
// beyond their own).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [row0, row0 + ROWS) of a [n, D] bf16 matrix (row stride `ld`
// elements, last axis contiguous) into shared memory rows of LDS elements,
// 16 bytes per cp.async, spread over NT threads. Rows at or past n are
// zero-filled. `src` and `ld` must keep every row 16-byte aligned.
template <int ROWS, int D, int LDS, int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int row0, int n, long long ld, int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < ROWS * CHUNKS; c += NT) {
    const int r = c / CHUNKS, ch = c % CHUNKS;
    const int row = row0 + r;
    const bool valid = row < n;
    const __nv_bfloat16* p = src + (long long)(valid ? row : n - 1) * ld + ch * 8;
    cp_async_16(smem_addr(dst + r * LDS + ch * 8), p, valid);
  }
}

// ---------------------------------------------------------------------------
// Warpgroup products (wgmma; sm_90a only). A warpgroup is 4 consecutive
// warps; warp w of it holds rows 16w..16w+15 of the 64-row A and C tiles,
// each in the mma.sync A and C fragment layouts above (C: N/8 tiles of 8
// columns, registers 4j..4j+3 for columns 8j..8j+7).
//
// A shared-memory operand is a tile of rows of W = 32, 64 or 128 bytes (16,
// 32 or 64 bf16) with the XOR swizzle of that width, starting on a 1024-byte
// boundary; a matrix wider than 64 bf16 is stored as blocks of 64 columns,
// one after the other. K-major operands (the k axis along the row: Q and K
// of Q K^T) step through k by moving the start address 32 bytes (16 bf16)
// along the row; MN-major ones (V of P V, whose rows are the k axis) by 16
// rows. Shared memory written through the generic proxy (st.shared,
// cp.async) needs fence_async_shared() before a wgmma reads it.

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of W-byte rows
template <int W>
__device__ __forceinline__ uint32_t swizzle_offset(int row, int chunk) {
  const uint32_t off = row * W + chunk * 16;
  return off ^ (((off >> 7) & (W / 16 - 1)) << 4);
}

// Descriptor of the operand that starts at shared address `addr`: 8-row
// groups 8 W bytes apart, `lbo` bytes between 64-column blocks (MN-major
// operands wider than 64; ignored otherwise), the swizzle of W-byte rows.
template <int W>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo) {
  static_assert(W == 32 || W == 64 || W == 128, "swizzled rows are 32, 64 or 128 bytes");
  constexpr uint64_t mode = W == 128 ? 1 : W == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(8 * W >> 4) << 32) | (mode << 62);
}

// Copy rows [row0, row0 + ROWS) of a [n, D] bf16 matrix (row stride `ld`
// elements, last axis contiguous) into the swizzled tile at shared address
// `dst`, 16 bytes per cp.async, spread over NT threads; rows at or past n
// are zero-filled.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_swizzled(uint32_t dst, const __nv_bfloat16* src,
                                                   int row0, int n, long long ld, int tid) {
  constexpr int W = D >= 64 ? 128 : 2 * D;  // bytes per swizzled row
  constexpr int CW = W / 16;                // 16-byte chunks per swizzled row
  constexpr int CH = D / 8;                 // 16-byte chunks per matrix row
#pragma unroll
  for (int c = tid; c < ROWS * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    const int row = row0 + r;
    const bool valid = row < n;
    const __nv_bfloat16* p = src + (long long)(valid ? row : n - 1) * ld + ch * 8;
    cp_async_16(dst + (ch / CW) * ROWS * W + swizzle_offset<W>(r, ch % CW), p, valid);
  }
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulators across a
// wgmma_wait (the products write them asynchronously).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) += A (64 x 16, K-major) B (16 x 64, K-major), both from
// shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 0;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b));
}

// d (64 x N, f32) += A (64 x 16, registers) B (16 x N, MN-major, from shared
// memory)
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_rs_tb<16>(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<32>(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// The dynamic shared-memory cap of one kernel instantiation as raised so
// far on each device (48 KB by default). The attribute belongs to a
// device's context, so a process that launches on several cards raises it
// on each.
struct SmemCap {
  static constexpr int kMaxDevices = 64;
  size_t bytes[kMaxDevices];
  SmemCap() {
    for (size_t& b : bytes) b = 48 * 1024;
  }
};

// Raise the dynamic shared-memory cap of `kernel` on the current device when
// it needs more than it was allowed so far. `cap` is the caller's record for
// this one kernel instantiation, so the attribute is set once a device and
// not on every launch (which also keeps later launches legal under
// CUDA-graph capture).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, SmemCap& cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= SmemCap::kMaxDevices) return cudaErrorInvalidDevice;
  size_t& allowed = cap.bytes[dev];
  if (bytes <= allowed) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace rtt
