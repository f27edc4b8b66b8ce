// Flash-attention forward, CUDA C++ for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py::_fwd_kernel, the Pallas kernel
// that _flash_fwd launches (grid (B, H, nq, nk)). Same function: causal or
// full softmax(Q K^T * scale) V over [B, T, H, D] queries and [B, S, Kh, D]
// keys/values (GQA: kv head = h / G), online f32 softmax, and the f32
// logsumexp [B, H, T] that the backward kernels of the training slice read.
//
// Design. One CTA per (b, h, 64-row query tile). The TPU kernel carried its
// softmax state from one grid step to the next along the sequential nk
// axis; Hopper runs blocks in parallel with nothing carried between them,
// so the CTA loops over 64-key tiles itself, up to the causal diagonal
// (tiles above it are never loaded). Q, K^T and V tiles sit in shared
// memory as f32; 256 threads form a 16 x 16 grid and each owns a 4 x 4
// piece of the score tile (rows ty + 16 i, columns tx + 16 j) and a 4 x D/16
// piece of the output accumulator, so the row max and row sum reduce over
// 16 lanes of one warp with shuffles and the softmax never leaves
// registers. Products are scalar f32 FMAs. Rows and columns past T and S are
// masked in the kernel (rows past T are never stored), so any T runs here:
// there is no counterpart of the JAX wrapper's O(T^2) fallback for lengths
// that do not tile. Inputs are read through their strides: no transposes.
//
// Bound on the H100: at long T it is compute-bound (4 T^2 H D / 2 flops
// causal against 2 bytes per element moved once); at the serving shapes
// (T = 16..128 per prefill chunk) the whole call is a few microseconds of
// work and launch latency dominates. The simple design leaves for later:
// wgmma/mma.sync tensor-core products, TMA loads into a multi-stage ring,
// and warp specialisation. A CUDA core FMA pipe gives a small fraction of
// the tensor-core rate, so long-T prefill is far from its bound.

#include "common.cuh"

namespace {

using rtt::from_float;
using rtt::to_float;

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads: 16 x 16 grid (ty, tx)
constexpr int RPT = BQ / 16;  // score rows per thread: ty + 16 * i
constexpr int CPT = BK / 16;  // score columns per thread: tx + 16 * j
constexpr int LDK = BK + 1;   // K^T tile [D][LDK]: transposed stores stay conflict-free
constexpr int LDP = BK + 16;  // P tile [BQ][LDP]: the two row groups of a warp hit other banks

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + D * LDK + BK * D + BQ * LDP);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int seq_q, int seq_k, int n_heads,
                 int group, long long qsb, long long qst, long long qsh,
                 long long ksb, long long kst, long long ksh, long long vsb,
                 long long vst, long long vsh, long long osb, long long ost,
                 long long osh, float scale, int causal) {
  constexpr int LDQ = D + 1;
  constexpr int DPT = D / 16;  // output columns per thread: tx + 16 * c
  extern __shared__ float smem[];
  float* Qs = smem;           // [BQ][LDQ]
  float* Kt = Qs + BQ * LDQ;  // [D][LDK]
  float* Vs = Kt + D * LDK;   // [BK][D]
  float* Ps = Vs + BK * D;    // [BQ][LDP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int q0 = iq * BQ;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    Qs[r * LDQ + d] = (q0 + r < seq_q) ? to_float(qb[(long long)(q0 + r) * qst + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row.
  // The first tile always holds key 0, which every row may see, so the row
  // max is finite from the first tile on and exp() never meets -inf - -inf.
  const int kv_end = causal ? min(seq_k, q0 + BQ) : seq_k;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D;
      const bool ok = k0 + j < seq_k;
      Kt[d * LDK + j] = ok ? to_float(kb[(long long)(k0 + j) * kst + d]) : 0.f;
      Vs[j * D + d] = ok ? to_float(vb[(long long)(k0 + j) * vst + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Kt[d * LDK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < seq_k && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq_q) continue;
    const float inv = 1.f / l[i];
    T* o = out + b * osb + (long long)row * ost + h * osh;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[tx + 16 * c] = from_float<T>(acc[i][c] * inv);
    if (tx == 0) lse[((long long)b * n_heads + h) * seq_q + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Tq, int S, int H, int Kh,
                   long long qsb, long long qst, long long qsh, long long ksb,
                   long long kst, long long ksh, long long vsb, long long vst,
                   long long vsh, long long osb, long long ost, long long osh,
                   float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  static size_t allowed = 48 * 1024;  // per (T, D) instantiation
  cudaError_t err = rtt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Tq, S, H, H / Kh, qsb, qst,
      qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int Tq, int S, int H,
                       int Kh, long long qsb, long long qst, long long qsh,
                       long long ksb, long long kst, long long ksh,
                       long long vsb, long long vst, long long vsh,
                       long long osb, long long ost, long long osh,
                       float scale, int causal, cudaStream_t st) {
#define RTT_FLASH_CASE(DD)                                                       \
  case DD:                                                                       \
    return launch<T, DD>(q, k, v, out, lse, B, Tq, S, H, Kh, qsb, qst, qsh, ksb, \
                         kst, ksh, vsb, vst, vsh, osb, ost, osh, scale, causal, st);
  switch (D) {
    RTT_FLASH_CASE(16)
    RTT_FLASH_CASE(32)
    RTT_FLASH_CASE(64)
    RTT_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RTT_FLASH_CASE
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError(); 0 means the launch was accepted.
extern "C" int rtt_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* out, void* lse, int B, int Tq,
                             int S, int H, int Kh, int D, long long qsb,
                             long long qst, long long qsh, long long ksb,
                             long long kst, long long ksh, long long vsb,
                             long long vst, long long vsh, long long osb,
                             long long ost, long long osh, float scale,
                             int causal, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Kh <= 0 || H % Kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == rtt::kFloat32)
    err = dispatch_d<float>(D, q, k, v, out, lse, B, Tq, S, H, Kh, qsb, qst, qsh,
                            ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, scale,
                            causal, st);
  else if (dtype == rtt::kBFloat16)
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, Tq, S, H, Kh, qsb,
                                    qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb,
                                    ost, osh, scale, causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
