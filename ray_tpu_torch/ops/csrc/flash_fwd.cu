// Flash-attention forward, CUDA C++ for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py::_fwd_kernel, the Pallas kernel
// that _flash_fwd launches (grid (B, H, nq, nk)). Same function: causal or
// full softmax(Q K^T * scale) V over [B, T, H, D] queries and [B, S, Kh, D]
// keys/values (GQA: kv head = h / G), online f32 softmax, and the f32
// logsumexp [B, H, T] that the backward kernels of the training slice read.
// The TPU kernel carried its softmax state from one grid step to the next
// along the sequential nk axis; Hopper runs blocks in parallel with nothing
// carried between them, so each CTA loops over the key tiles itself, up to
// the causal diagonal (tiles above it are never loaded). Rows and columns
// past T and S are masked in the kernel (rows past T are never stored), so
// any T runs here: there is no counterpart of the JAX wrapper's O(T^2)
// fallback. Inputs are read through their strides: no transposes.
//
// Two routes, chosen by dtype alone:
//
// bf16 (flash_fwd_tc_kernel): tensor cores. One CTA, a warpgroup of 4
// warps, per (b, h, 64-row query tile), 16 query rows per warp. Q is copied
// once into shared memory; K and V tiles of 64 keys stream through a 2-stage
// cp.async ring (the next tile's copy runs under this tile's math), all in
// the swizzled layout wgmma reads without bank conflicts. S = Q K^T is a
// wgmma with both operands in shared memory (Q's fragments held in
// registers across the key loop were overwritten by ptxas's allocation for
// the second product's A operand); the online softmax runs on its
// f32 accumulators in registers (row max over the 4 lanes of a quad, the
// same alpha rescale as _fwd_kernel, exp2 of log2e-scaled scores); P is
// rounded to bf16 in registers and is the register A operand of the wgmma
// O += P V, with V MN-major in shared memory. That rounding is the one
// place the numbers differ from _fwd_kernel, which multiplies f32 P by f32
// V: the row sum l and lse use the f32 P, so lse, and the backward's
// recomputed P, do not move.
//
// f32 (flash_fwd_kernel): f32 is held to 1e-4, which TF32 tensor-core
// products cannot meet, so f32 keeps the scalar-FMA body: 256 threads as a
// 16 x 16 grid, each owning a 4 x 4 piece of the score tile and a 4 x D/16
// piece of the output, Q, K^T and V tiles in shared memory as f32.
//
// Bound on the H100: at long T it is compute-bound (4 T^2 H D / 2 flops
// causal against 2 bytes per element moved once); at the serving shapes
// (T = 16..128 per prefill chunk) the whole call is a few microseconds of
// work and launch latency dominates. Not done yet: TMA loads, a producer
// warp and two consumer warpgroups taking turns (softmax of one under the
// products of the other), which is the way to the card's full rate.

#include "common.cuh"

namespace {

using rtt::from_float;
using rtt::to_float;

// ---- f32 route: scalar FMAs
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

// instantiated for T = float only: bf16 takes flash_fwd_tc_kernel
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

// ---- bf16 route: tensor cores
using bf16 = __nv_bfloat16;
constexpr int TC_BQ = 64;   // query rows per CTA, 16 per warp
constexpr int TC_BK = 64;   // keys per tile
constexpr int TC_NT = 128;  // one warpgroup
constexpr float kLn2 = 0.6931471805599453f;
using rtt::kLog2e;
using rtt::Strides;

// Q tile + 2 stages of K and V (64 rows each), and room to start them on a
// 1024-byte boundary
template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (TC_BQ + 4 * TC_BK) * D + 1024;
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int seq_q, int seq_k, int n_heads, int group,
                    Strides qs, Strides ks, Strides vs, Strides os, float scale_log2,
                    int causal) {
  static_assert(TC_BQ == TC_BK, "Q, K and V tiles share one layout");
  constexpr int W = D >= 64 ? 128 : 2 * D;  // bytes per swizzled row
  constexpr int KSTEPS = W / 32;            // k16 steps per 64-column block
  constexpr int TILE = TC_BQ * D * 2;       // bytes of one 64-row tile
  constexpr int NKT = TC_BK / 8;            // score C tiles (8 keys each)
  constexpr int NDT = D / 8;                // output C tiles (8 columns each)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t qsm = (rtt::smem_addr(smem_raw) + 1023) & ~1023u;  // Q; K at +TILE, V at +3 TILE

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int q0 = iq * TC_BQ;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  // causal: keys past the tile's last query row are masked for every row.
  // The first tile always holds key 0, which every row may see, so the row
  // max is finite from the first tile on and exp2 never meets -inf - -inf.
  const int kv_end = causal ? min(seq_k, q0 + TC_BQ) : seq_k;
  const int n_tiles = (kv_end + TC_BK - 1) / TC_BK;

  rtt::load_tile_swizzled<TC_BQ, D, TC_NT>(qsm, qb, q0, seq_q, qs.t, tid);
  rtt::load_tile_swizzled<TC_BK, D, TC_NT>(qsm + TILE, kb, 0, seq_k, ks.t, tid);
  rtt::load_tile_swizzled<TC_BK, D, TC_NT>(qsm + 3 * TILE, vb, 0, seq_k, vs.t, tid);
  rtt::cp_async_commit();

  float o[D / 2];  // O: NDT C tiles
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // rows row0 (C registers 4j, 4j+1) and row0 + 8 (4j+2, 4j+3); m in
  // log2e-scaled units; l is this lane's part of the row sum (its quad's
  // four parts are added at the end)
  const int row0 = q0 + warp * 16 + g;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      const int nk0 = (it + 1) * TC_BK;
      rtt::load_tile_swizzled<TC_BK, D, TC_NT>(qsm + (1 + (st ^ 1)) * TILE, kb, nk0, seq_k,
                                               ks.t, tid);
      rtt::load_tile_swizzled<TC_BK, D, TC_NT>(qsm + (3 + (st ^ 1)) * TILE, vb, nk0, seq_k,
                                               vs.t, tid);
      rtt::cp_async_commit();
      rtt::cp_async_wait<1>();
    } else {
      rtt::cp_async_wait<0>();
    }
    rtt::fence_async_shared();  // the copies are visible to the products
    __syncthreads();
    const uint32_t ksm = qsm + (1 + st) * TILE;
    const uint32_t vsm = qsm + (3 + st) * TILE;

    // S = Q K^T: 64 rows x 64 keys, both operands K-major in shared memory
    float s[NKT * 4];
#pragma unroll
    for (int i = 0; i < NKT * 4; ++i) s[i] = 0.f;
    rtt::fence_operands(s);
    rtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / KSTEPS) * TC_BQ * W + (kk % KSTEPS) * 32;  // block, then k
      rtt::wgmma_ss_n64(s, rtt::wgmma_desc<W>(qsm + off, 16), rtt::wgmma_desc<W>(ksm + off, 16));
    }
    rtt::wgmma_commit();
    rtt::wgmma_wait<0>();
    rtt::fence_operands(s);

    // scale, mask (only the diagonal tile and the ragged last tile need
    // it), online softmax
    const int k0 = it * TC_BK;
    const bool edge = k0 + TC_BK > seq_k || (causal && k0 + TC_BK > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NKT * 4; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = row0 + ((i >> 1) & 1) * 8;
        if (col >= seq_k || (causal && col > row)) x = -INFINITY;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NKT * 4; ++i) {
      const float p = exp2f(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V: P's C tiles, rounded to bf16, are the A fragments; V is
    // MN-major in shared memory, 16 key rows per step
    uint32_t pa[TC_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = rtt::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    rtt::fence_operands(o);
    rtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
      rtt::wgmma_rs_tb<D>(o, pa[kk], rtt::wgmma_desc<W>(vsm + kk * 16 * W, TC_BK * W));
    rtt::wgmma_commit();
    rtt::wgmma_wait<0>();
    rtt::fence_operands(o);
    __syncthreads();  // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= seq_q) continue;
    const float inv = 1.f / l[r];
    bf16* orow = out + b * os.b + (long long)row * os.t + h * os.h;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
          rtt::pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (t4 == 0) lse[((long long)b * n_heads + h) * seq_q + row] = m[r] * kLn2 + logf(l[r]);
  }
}

struct Args {
  const void *q, *k, *v;
  void *out, *lse;
  int B, Tq, S, H, Kh;
  Strides qs, ks, vs, os;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_simt(const Args& a) {
  auto kernel = flash_fwd_kernel<float, D>;
  const size_t smem = smem_bytes<D>();
  static rtt::SmemCap allowed;  // per D instantiation
  cudaError_t err = rtt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), static_cast<float*>(a.lse),
      a.Tq, a.S, a.H, a.H / a.Kh, a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b,
      a.vs.t, a.vs.h, a.os.b, a.os.t, a.os.h, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const Args& a) {
  auto kernel = flash_fwd_tc_kernel<D>;
  const size_t smem = tc_smem_bytes<D>();
  static rtt::SmemCap allowed;  // per D instantiation
  cudaError_t err = rtt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + TC_BQ - 1) / TC_BQ, a.H, a.B);
  kernel<<<grid, TC_NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), static_cast<float*>(a.lse),
      a.Tq, a.S, a.H, a.H / a.Kh, a.qs, a.ks, a.vs, a.os, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <bool TC>
cudaError_t dispatch_d(int D, const Args& a) {
#define RTT_FLASH_CASE(DD) \
  case DD:                 \
    return TC ? launch_tc<DD>(a) : launch_simt<DD>(a);
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
// cudaGetLastError(); 0 means the launch was accepted. f32 takes the scalar
// route, bf16 the tensor-core route; a bf16 call needs 16-byte aligned q, k, v
// and sequence, head and batch strides that are multiples of 8 elements
// (ray_tpu_torch/ops/flash_attention.py checks both before it calls).
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
  const Args a{q, k, v, out, lse, B, Tq, S, H, Kh,
               {qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh}, {osb, ost, osh},
               scale, causal, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == rtt::kFloat32)
    err = dispatch_d<false>(D, a);
  else if (dtype == rtt::kBFloat16)
    err = dispatch_d<true>(D, a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
