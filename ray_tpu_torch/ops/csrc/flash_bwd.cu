// Flash-attention backward, CUDA C++ for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces, in ray_tpu/ops/flash_attention.py (both launched by _flash_bwd):
// - _bwd_dq_kernel (grid (B, H, nq, nk)): dQ summed over key tiles;
// - _bwd_dkv_kernel (grid (B, Kh, nk, G, nq)): dK and dV summed over query
//   tiles and over the G query heads of each kv head.
// Same arithmetic, with the same rounding points: S = Q K^T * scale and
// dP = dO V^T with f32 sums, P = exp(S - lse) in f32 (lse from the forward
// kernel), dS = P (dP - delta) scale cast to the input dtype, P cast to the
// input dtype before dV; dQ = dS K, dK = dS^T Q, dV = P^T dO with f32 sums,
// each cast to the input dtype once at the end. delta = rowsum(dO * O) in
// f32 is computed by the caller once per backward.
//
// The TPU kernels carry their f32 sums in scratch along sequential grid
// axes (nk for dQ; G and nq for dK/dV). Hopper runs blocks in parallel with
// nothing carried between them, so each sum is a loop inside one CTA and
// stays in registers: no atomics, and the sums are deterministic.
//
// dQ, bf16 (flash_bwd_dq_tc_kernel): tensor cores, wgmma. One CTA, a
// warpgroup of 4 warps, per (b, h, 64-row query tile), 16 query rows per
// warp; the heaviest causal tiles start first. The Q and dO tiles are
// copied once; K and V tiles of 64 keys stream through a 2-stage cp.async
// ring up to the causal diagonal, all in the swizzled layout wgmma reads.
// Each lane reads lse and delta for its two rows once. Per key tile:
// S = Q K^T and dP = dO V^T are two wgmma's with every operand in shared
// memory (an A operand held in registers across the key loop was
// overwritten by ptxas in the forward kernel, so only the fresh dS comes
// from registers); P = exp2(S scale log2e - lse log2e) in f32 on the
// accumulators, 0 where masked; dS = P (dP - delta) scale, rounded to bf16
// in registers (the TPU kernel's own cast), is the register A operand of
// dQ += dS K, whose B operand is the same swizzled K tile read MN-major
// (the layout the forward's P V reads V in), so one copy of K serves both
// products. P is never rounded, so the route computes _bwd_dq_kernel's
// function up to summation order; dQ sums in registers and is written as
// bf16 once.
//
// dK/dV, bf16 (flash_bwd_dkv_tc_kernel): tensor cores. One CTA of 4 warps
// per (b, kv head, 64-key tile); each warp owns 16 keys. K and V stay in
// shared memory for the whole CTA, while the CTA walks the G query heads
// and, for each, the query tiles from the diagonal down; Q, dO and each
// tile's lse and delta stream through a 2-stage cp.async ring. Per query
// tile and warp: S^T = K Q^T and dP^T = V dO^T on mma.sync m16n8k16 (K and
// V rows are the A operand, Q and dO rows the B operand through ldmatrix);
// P^T = exp(S^T scale - lse) masked, in f32 registers; P^T rounded to bf16
// is the A operand of dV += P^T dO, and dS^T = P^T (dP^T - delta) scale
// rounded to bf16 that of dK += dS^T Q (dO and Q through ldmatrix.trans).
// Both roundings are the TPU kernel's own, and every other operand is
// bf16 already, so the route computes _bwd_dkv_kernel's function up to
// summation order. The query tile is 64 rows at D <= 64 and 32 at D = 128,
// which keeps the f32 tiles and the dK/dV sums in registers. Key tile 0
// sees every query tile, so it is launched first.
//
// f32 dQ and dK/dV (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): scalar f32
// FMAs (f32 is held to 1e-5, which TF32 products cannot meet).
// - dQ: one CTA per (b, h, 64-row query tile); Q and dO tiles stay in shared
//   memory while the CTA walks 64-key tiles up to the causal diagonal.
// - dK/dV: one CTA per (b, kv head, 64-key tile), looping as above.
// Both use the forward kernel's thread layout: 256 threads as a 16 x 16
// grid, each owning a 4 x 4 piece of the 64 x 64 score tile and a
// 4 x D/16 piece of its f32 accumulators; the streamed tiles are stored
// transposed ([D][65]) so transposed stores and column reads are free of
// bank conflicts.
//
// All routes mask rows past T and keys past S in the kernel (P = 0; lse
// and delta of a row past T are never used) and read inputs through their
// strides.
//
// Bound on the H100: compute. Per (query, key) pair the dQ kernel does
// three D-long products and the dK/dV kernel four, against two bytes per
// element read once. Not done yet: TMA loads and a producer warp (dQ), and
// wgmma for dK/dV.

#include <type_traits>

#include "common.cuh"

namespace {

using rtt::from_float;
using rtt::to_float;

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads: 16 x 16 grid (ty, tx)
constexpr int RPT = 4;        // tile rows per thread: ty + 16 * i
constexpr int CPT = 4;        // tile columns per thread: tx + 16 * j
constexpr int LDT = 65;       // transposed tiles [D][LDT] (64 columns + 1)
constexpr int LDP = BK + 16;  // score tiles [64][LDP]: a warp's two row groups hit other banks
static_assert(BQ == 64 && BK == 64 && RPT * 16 == BQ && CPT * 16 == BK, "tile layout");

using rtt::Strides;

// x as the input dtype holds it: the cast before a product in the TPU kernels
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * D * LDT + BQ * LDP);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * D * LDT + 2 * BK * LDP);
}
// D = 128: dQ 153,088 bytes, dK/dV 173,568 bytes (of the 232,448 a block may use)
static_assert(dkv_smem_bytes<128>() <= 232448, "dK/dV tiles exceed shared memory");

// instantiated for T = float only: bf16 takes flash_bwd_dq_tc_kernel
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int seq_q, int seq_k, int n_heads, int group,
                    Strides qs, Strides ks, Strides vs, Strides os, Strides gs,
                    float scale, int causal) {
  constexpr int LDQ = D + 1;
  constexpr int DPT = D / 16;  // dQ columns per thread: tx + 16 * c
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LDQ]
  float* dOs = Qs + BQ * LDQ;   // [BQ][LDQ]
  float* Kt = dOs + BQ * LDQ;   // [D][LDT]
  float* Vt = Kt + D * LDT;     // [D][LDT]
  float* dSs = Vt + D * LDT;    // [BQ][LDP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int q0 = iq * BQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* ob = dout + b * os.b + h * os.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    const bool ok = q0 + r < seq_q;
    Qs[r * LDQ + d] = ok ? to_float(qb[(long long)(q0 + r) * qs.t + d]) : 0.f;
    dOs[r * LDQ + d] = ok ? to_float(ob[(long long)(q0 + r) * os.t + d]) : 0.f;
  }
  float row_lse[RPT], row_delta[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = ((long long)b * n_heads + h) * seq_q + row;
    row_lse[i] = row < seq_q ? lse[at] : 0.f;
    row_delta[i] = row < seq_q ? delta[at] : 0.f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(seq_k, q0 + BQ) : seq_k;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D;
      const bool ok = k0 + j < seq_k;
      Kt[d * LDT + j] = ok ? to_float(kb[(long long)(k0 + j) * ks.t + d]) : 0.f;
      Vt[d * LDT + j] = ok ? to_float(vb[(long long)(k0 + j) * vs.t + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LDQ + d];
        ov[i] = dOs[(ty + 16 * i) * LDQ + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = Kt[d * LDT + tx + 16 * j];
        vv[j] = Vt[d * LDT + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = row < seq_q && col < seq_k && (!causal || col <= row);
        const float p = keep ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - row_delta[i]) * scale);
      }
    }
    __syncthreads();

    // dQ += dS K: K's rows are Kt's columns
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sv[RPT], kc[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = dSs[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) kc[c] = Kt[(tx + 16 * c) * LDT + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(sv[i], kc[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq_q) continue;
    T* o = dq + b * gs.b + (long long)row * gs.t + h * gs.h;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[tx + 16 * c] = from_float<T>(acc[i][c]);
  }
}

// instantiated for T = float only: bf16 takes flash_bwd_dkv_tc_kernel
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int seq_q, int seq_k,
                     int n_heads, int group, Strides qs, Strides ks, Strides vs,
                     Strides os, Strides dks, Strides dvs, float scale, int causal) {
  constexpr int LDK = D + 1;
  constexpr int DPT = D / 16;  // dK/dV columns per thread: tx + 16 * c
  extern __shared__ float smem[];
  float* Ks = smem;             // [BK][LDK]
  float* Vs = Ks + BK * LDK;    // [BK][LDK]
  float* Qt = Vs + BK * LDK;    // [D][LDT]
  float* dOt = Qt + D * LDT;    // [D][LDT]
  float* Ps = dOt + D * LDT;    // [BK][LDP], P^T as the input dtype holds it
  float* dSs = Ps + BK * LDP;   // [BK][LDP], dS^T

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BK;  // key tile 0 sees every query tile: it starts first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int e = tid; e < BK * D; e += NT) {
    const int r = e / D, d = e % D;
    const bool ok = k0 + r < seq_k;
    Ks[r * LDK + d] = ok ? to_float(kb[(long long)(k0 + r) * ks.t + d]) : 0.f;
    Vs[r * LDK + d] = ok ? to_float(vb[(long long)(k0 + r) * vs.t + d]) : 0.f;
  }

  float acc_k[RPT][DPT], acc_v[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // causal: query rows before k0 see none of these keys (BQ == BK, so the
  // first tile that does is the diagonal one)
  const int q_begin = causal ? k0 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dout + b * os.b + h * os.h;
    const long long stat = ((long long)b * n_heads + h) * seq_q;
    for (int q0 = q_begin; q0 < seq_q; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done (and K, V are stored)
      for (int e = tid; e < BQ * D; e += NT) {
        const int r = e / D, d = e % D;
        const bool ok = q0 + r < seq_q;
        Qt[d * LDT + r] = ok ? to_float(qb[(long long)(q0 + r) * qs.t + d]) : 0.f;
        dOt[d * LDT + r] = ok ? to_float(ob[(long long)(q0 + r) * os.t + d]) : 0.f;
      }
      float col_lse[CPT], col_delta[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = q0 + tx + 16 * j;
        col_lse[j] = col < seq_q ? lse[stat + col] : 0.f;
        col_delta[j] = col < seq_q ? delta[stat + col] : 0.f;
      }
      __syncthreads();

      // transposed scores: rows are keys, columns are query rows
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kr[RPT], vr[RPT], qc[CPT], oc[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kr[i] = Ks[(ty + 16 * i) * LDK + d];
          vr[i] = Vs[(ty + 16 * i) * LDK + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qc[j] = Qt[d * LDT + tx + 16 * j];
          oc[j] = dOt[d * LDT + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], oc[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int row = q0 + tx + 16 * j;
          const bool keep = row < seq_q && key < seq_k && (!causal || key <= row);
          const float p = keep ? expf(s[i][j] * scale - col_lse[j]) : 0.f;
          Ps[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(p);
          dSs[(ty + 16 * i) * LDP + tx + 16 * j] =
              round_to<T>(p * (dp[i][j] - col_delta[j]) * scale);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: dO's and Q's rows are the columns of dOt, Qt
#pragma unroll 4
      for (int j = 0; j < BQ; ++j) {
        float pv[RPT], sv[RPT], oc[DPT], qc[DPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Ps[(ty + 16 * i) * LDP + j];
          sv[i] = dSs[(ty + 16 * i) * LDP + j];
        }
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          oc[c] = dOt[(tx + 16 * c) * LDT + j];
          qc[c] = Qt[(tx + 16 * c) * LDT + j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            acc_v[i][c] = fmaf(pv[i], oc[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(sv[i], qc[c], acc_k[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= seq_k) continue;
    T* ko = dk + b * dks.b + (long long)key * dks.t + kvh * dks.h;
    T* vo = dv + b * dvs.b + (long long)key * dvs.t + kvh * dvs.h;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      ko[tx + 16 * c] = from_float<T>(acc_k[i][c]);
      vo[tx + 16 * c] = from_float<T>(acc_v[i][c]);
    }
  }
}

// ---- dK/dV, bf16 route: tensor cores
using bf16 = __nv_bfloat16;
constexpr int TC_BK = 64;   // keys per CTA, 16 per warp
constexpr int TC_NT = 128;  // 4 warps
using rtt::kLog2e;

// query rows per streamed tile: the S^T and dP^T tiles (2 x BQ / 2 f32
// registers a thread) and the dK, dV sums (2 x D / 2) share the registers
template <int D>
__host__ __device__ constexpr int dkv_tc_bq() {
  return D <= 64 ? 64 : 32;
}

// K, V, then 2 stages of Q and dO (rows padded by 16 bytes), then 2 stages
// of lse and delta
template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return sizeof(bf16) * (2 * TC_BK + 4 * dkv_tc_bq<D>()) * (D + 8) +
         sizeof(float) * 4 * dkv_tc_bq<D>();
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int seq_q, int seq_k,
                        int n_heads, int group, Strides qs, Strides ks, Strides vs,
                        Strides os, Strides dks, Strides dvs, float scale, int causal) {
  constexpr int BQ = dkv_tc_bq<D>();
  constexpr int LDS = D + 8;     // shared row stride (elements)
  constexpr int NQT = BQ / 8;    // S^T / dP^T C tiles per warp (8 query rows each)
  constexpr int NDT = D / 8;     // dK / dV C tiles per warp (8 columns each)
  constexpr int KD = D / 16;     // k-steps of K Q^T and V dO^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LDS]
  bf16* Vs = Ks + TC_BK * LDS;                    // [BK][LDS]
  bf16* Qs = Vs + TC_BK * LDS;                    // [2][BQ][LDS]
  bf16* Os = Qs + 2 * BQ * LDS;                   // [2][BQ][LDS], dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * LDS);  // [2][BQ], lse
  float* Ds = Ls + 2 * BQ;                                    // [2][BQ], delta

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * TC_BK;  // key tile 0 sees every query tile: it starts first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  rtt::load_tile_async<TC_BK, D, LDS, TC_NT>(Ks, k + b * ks.b + kvh * ks.h, k0, seq_k, ks.t,
                                             tid);
  rtt::load_tile_async<TC_BK, D, LDS, TC_NT>(Vs, v + b * vs.b + kvh * vs.h, k0, seq_k, vs.t,
                                             tid);

  // causal: query rows before the first multiple of BQ at or below k0 see
  // none of these keys. The work is G x n_q query tiles, walked in order.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int n_q = q_begin < seq_q ? (seq_q - q_begin + BQ - 1) / BQ : 0;
  const int total = group * n_q;
  auto load_query_tile = [&](int it, int st) {
    const int h = kvh * group + it / n_q;
    const int q0 = q_begin + (it % n_q) * BQ;
    rtt::load_tile_async<BQ, D, LDS, TC_NT>(Qs + st * BQ * LDS, q + b * qs.b + h * qs.h, q0,
                                            seq_q, qs.t, tid);
    rtt::load_tile_async<BQ, D, LDS, TC_NT>(Os + st * BQ * LDS, dout + b * os.b + h * os.h,
                                            q0, seq_q, os.t, tid);
    if (tid < BQ) {
      const int row = q0 + tid;
      const bool valid = row < seq_q;
      const long long at = ((long long)b * n_heads + h) * seq_q + (valid ? row : seq_q - 1);
      rtt::cp_async_4(rtt::smem_addr(Ls + st * BQ + tid), lse + at, valid);
      rtt::cp_async_4(rtt::smem_addr(Ds + st * BQ + tid), delta + at, valid);
    }
  };
  if (total > 0) load_query_tile(0, 0);
  rtt::cp_async_commit();  // K, V and the first query tile

  // this lane's ldmatrix row addresses, as element offsets into a tile: A
  // operand (this warp's 16 K or V rows), B operand from Q or dO rows, and
  // B operand from Q or dO rows through the transposing load
  const int a_off = (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8;
  const int bt_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDS + (lane >> 4) * 8;
  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0 and key0 + 8
  const float scale_log2 = scale * kLog2e;

  float acc_k[NDT][4], acc_v[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    if (it + 1 < total) {
      load_query_tile(it + 1, st ^ 1);
      rtt::cp_async_commit();
      rtt::cp_async_wait<1>();
    } else {
      rtt::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = q_begin + (it % n_q) * BQ;
    const bf16* Qt = Qs + st * BQ * LDS;
    const bf16* Ot = Os + st * BQ * LDS;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ query rows per warp
    float s[NQT][4], dp[NQT][4];
#pragma unroll
    for (int j = 0; j < NQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kf[4], vf[4];
      rtt::ldmatrix_x4(kf, rtt::smem_addr(Ks + a_off + kk * 16));
      rtt::ldmatrix_x4(vf, rtt::smem_addr(Vs + a_off + kk * 16));
#pragma unroll
      for (int jj = 0; jj < NQT / 2; ++jj) {
        uint32_t qf[4], of[4];
        rtt::ldmatrix_x4(qf, rtt::smem_addr(Qt + b_off + jj * 16 * LDS + kk * 16));
        rtt::ldmatrix_x4(of, rtt::smem_addr(Ot + b_off + jj * 16 * LDS + kk * 16));
        rtt::mma_bf16(s[2 * jj], kf, qf[0], qf[1]);
        rtt::mma_bf16(s[2 * jj + 1], kf, qf[2], qf[3]);
        rtt::mma_bf16(dp[2 * jj], vf, of[0], of[1]);
        rtt::mma_bf16(dp[2 * jj + 1], vf, of[2], of[3]);
      }
    }

    // P^T = exp(S^T scale - lse) in f32, 0 where masked; then
    // dS^T = P^T (dP^T - delta) scale. Only tiles that cross the diagonal
    // or a ragged edge need the mask.
    const bool edge = q0 + BQ > seq_q || k0 + TC_BK > seq_k || (causal && k0 + TC_BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NQT; ++j) {
      const int c = 8 * j + 2 * t4;  // this lane's query rows in the tile: c, c + 1
      const float2 lz = *reinterpret_cast<const float2*>(Lt + c);
      const float2 dz = *reinterpret_cast<const float2*>(Dt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float row_lse = (e & 1) ? lz.y : lz.x;
        float p = exp2f(s[j][e] * scale_log2 - row_lse * kLog2e);
        if (edge) {
          const int row = q0 + c + (e & 1);
          const int key = key0 + (e >> 1) * 8;
          if (row >= seq_q || key >= seq_k || (causal && key > row)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? dz.y : dz.x)) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q: the bf16-rounded C tiles of P^T and
    // dS^T are the A fragments; the k dimension is the tile's query rows
#pragma unroll
    for (int kk = 0; kk < NQT / 2; ++kk) {
      const uint32_t pa[4] = {rtt::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              rtt::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              rtt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              rtt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {rtt::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              rtt::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              rtt::pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              rtt::pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t of[4], qf[4];
        rtt::ldmatrix_x4_trans(of, rtt::smem_addr(Ot + bt_off + kk * 16 * LDS + dd * 16));
        rtt::ldmatrix_x4_trans(qf, rtt::smem_addr(Qt + bt_off + kk * 16 * LDS + dd * 16));
        rtt::mma_bf16(acc_v[2 * dd], pa, of[0], of[1]);
        rtt::mma_bf16(acc_v[2 * dd + 1], pa, of[2], of[3]);
        rtt::mma_bf16(acc_k[2 * dd], da, qf[0], qf[1]);
        rtt::mma_bf16(acc_k[2 * dd + 1], da, qf[2], qf[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  rtt::cp_async_wait<0>();  // (a CTA with no query tile still loaded K and V)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= seq_k) continue;
    bf16* ko = dk + b * dks.b + (long long)key * dks.t + kvh * dks.h;
    bf16* vo = dv + b * dvs.b + (long long)key * dvs.t + kvh * dvs.h;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      *reinterpret_cast<uint32_t*>(ko + 8 * j + 2 * t4) =
          rtt::pack_bf16(acc_k[j][2 * r], acc_k[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vo + 8 * j + 2 * t4) =
          rtt::pack_bf16(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
    }
  }
}

// ---- dQ, bf16 route: tensor cores (wgmma)
constexpr int DQ_BQ = 64;  // query rows per CTA, 16 per warp
constexpr int DQ_BK = 64;  // keys per tile

// Q and dO tiles + 2 stages of K and V (64 rows each), and room to start
// them on a 1024-byte boundary
template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return sizeof(bf16) * (2 * DQ_BQ + 4 * DQ_BK) * D + 1024;
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int seq_q, int seq_k, int n_heads, int group,
                       Strides qs, Strides ks, Strides vs, Strides os, Strides gs,
                       float scale, int causal) {
  static_assert(DQ_BQ == DQ_BK, "Q, dO, K and V tiles share one layout");
  constexpr int W = D >= 64 ? 128 : 2 * D;  // bytes per swizzled row
  constexpr int KSTEPS = W / 32;            // k16 steps per 64-column block
  constexpr int TILE = DQ_BQ * D * 2;       // bytes of one 64-row tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Q; dO at +TILE; K stages at +2 TILE, +3 TILE; V stages at +4 TILE, +5 TILE
  const uint32_t qsm = (rtt::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t osm = qsm + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int q0 = iq * DQ_BQ;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* ob = dout + b * os.b + h * os.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(seq_k, q0 + DQ_BQ) : seq_k;
  const int n_tiles = (kv_end + DQ_BK - 1) / DQ_BK;

  rtt::load_tile_swizzled<DQ_BQ, D, TC_NT>(qsm, qb, q0, seq_q, qs.t, tid);
  rtt::load_tile_swizzled<DQ_BQ, D, TC_NT>(osm, ob, q0, seq_q, os.t, tid);
  rtt::load_tile_swizzled<DQ_BK, D, TC_NT>(qsm + 2 * TILE, kb, 0, seq_k, ks.t, tid);
  rtt::load_tile_swizzled<DQ_BK, D, TC_NT>(qsm + 4 * TILE, vb, 0, seq_k, vs.t, tid);
  rtt::cp_async_commit();

  // this lane's rows row0 (C registers 4j, 4j+1) and row0 + 8 (4j+2, 4j+3):
  // lse in log2e-scaled units and delta; a row past T reads the last row's
  // (finite) values and is never stored
  const int row0 = q0 + warp * 16 + g;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = ((long long)b * n_heads + h) * seq_q + min(row0 + 8 * r, seq_q - 1);
    lse2[r] = lse[at] * kLog2e;
    dlt[r] = delta[at];
  }
  const float scale_log2 = scale * kLog2e;

  float acc[D / 2];  // dQ: D/8 C tiles
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      const int nk0 = (it + 1) * DQ_BK;
      rtt::load_tile_swizzled<DQ_BK, D, TC_NT>(qsm + (2 + (st ^ 1)) * TILE, kb, nk0, seq_k,
                                               ks.t, tid);
      rtt::load_tile_swizzled<DQ_BK, D, TC_NT>(qsm + (4 + (st ^ 1)) * TILE, vb, nk0, seq_k,
                                               vs.t, tid);
      rtt::cp_async_commit();
      rtt::cp_async_wait<1>();
    } else {
      rtt::cp_async_wait<0>();
    }
    rtt::fence_async_shared();  // the copies are visible to the products
    __syncthreads();
    const uint32_t ksm = qsm + (2 + st) * TILE;
    const uint32_t vsm = qsm + (4 + st) * TILE;

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each, every operand
    // K-major in shared memory, issued together
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    rtt::fence_operands(s);
    rtt::fence_operands(dp);
    rtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / KSTEPS) * DQ_BQ * W + (kk % KSTEPS) * 32;  // block, then k
      rtt::wgmma_ss_n64(s, rtt::wgmma_desc<W>(qsm + off, 16), rtt::wgmma_desc<W>(ksm + off, 16));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / KSTEPS) * DQ_BQ * W + (kk % KSTEPS) * 32;
      rtt::wgmma_ss_n64(dp, rtt::wgmma_desc<W>(osm + off, 16), rtt::wgmma_desc<W>(vsm + off, 16));
    }
    rtt::wgmma_commit();
    rtt::wgmma_wait<0>();
    rtt::fence_operands(s);
    rtt::fence_operands(dp);

    // P = exp(S scale - lse) in f32, 0 where masked (only the diagonal tile
    // and the ragged last tile need the mask; keys past S are zero-filled,
    // and masking them keeps 0 * inf out of dQ); dS = P (dP - delta) scale
    const int k0 = it * DQ_BK;
    const bool edge = k0 + DQ_BK > seq_k || (causal && k0 + DQ_BK > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(s[i] * scale_log2 - lse2[r]);
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (col >= seq_k || (causal && col > row0 + 8 * r)) p = 0.f;
      }
      s[i] = p * (dp[i] - dlt[r]) * scale;
    }

    // dQ += dS K: dS's C tiles, rounded to bf16 (the TPU kernel's cast),
    // are the A fragments; the same K tile is the B operand read MN-major
    // (keys are the k axis), 16 keys per step
    uint32_t da[DQ_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) da[kk][r] = rtt::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    rtt::fence_operands(acc);
    rtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk)
      rtt::wgmma_rs_tb<D>(acc, da[kk], rtt::wgmma_desc<W>(ksm + kk * 16 * W, DQ_BK * W));
    rtt::wgmma_commit();
    rtt::wgmma_wait<0>();
    rtt::fence_operands(acc);
    __syncthreads();  // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= seq_q) continue;
    bf16* orow = dq + b * gs.b + (long long)row * gs.t + h * gs.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
          rtt::pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *g0, *g1;  // dq; or dk, dv
  int B, Tq, S, H, Kh;
  Strides qs, ks, vs, os, gs0, gs1;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<float, D>;
  const size_t smem = dq_smem_bytes<D>();
  static rtt::SmemCap allowed;  // per D instantiation
  cudaError_t err = rtt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.g0), a.Tq, a.S, a.H, a.H / a.Kh, a.qs, a.ks, a.vs, a.os, a.gs0,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tc(const Args& a) {
  auto kernel = flash_bwd_dq_tc_kernel<D>;
  const size_t smem = dq_tc_smem_bytes<D>();
  static rtt::SmemCap allowed;  // per D instantiation
  cudaError_t err = rtt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + DQ_BQ - 1) / DQ_BQ, a.H, a.B);
  kernel<<<grid, TC_NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.g0), a.Tq, a.S, a.H, a.H / a.Kh, a.qs, a.ks, a.vs, a.os, a.gs0,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<float, D>;
  const size_t smem = dkv_smem_bytes<D>();
  static rtt::SmemCap allowed;  // per D instantiation
  cudaError_t err = rtt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BK - 1) / BK, a.Kh, a.B);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.g0), static_cast<float*>(a.g1), a.Tq, a.S, a.H, a.H / a.Kh,
      a.qs, a.ks, a.vs, a.os, a.gs0, a.gs1, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const Args& a) {
  auto kernel = flash_bwd_dkv_tc_kernel<D>;
  const size_t smem = dkv_tc_smem_bytes<D>();
  static rtt::SmemCap allowed;  // per D instantiation
  cudaError_t err = rtt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + TC_BK - 1) / TC_BK, a.Kh, a.B);
  kernel<<<grid, TC_NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.g0), static_cast<bf16*>(a.g1), a.Tq, a.S, a.H, a.H / a.Kh, a.qs,
      a.ks, a.vs, a.os, a.gs0, a.gs1, a.scale, a.causal);
  return cudaGetLastError();
}

// the scalar bodies in f32, the tensor-core bodies in bf16
template <bool DQ, typename T, int D>
cudaError_t launch(const Args& a) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if constexpr (DQ && f32)
    return launch_dq<D>(a);
  else if constexpr (DQ)
    return launch_dq_tc<D>(a);
  else if constexpr (f32)
    return launch_dkv<D>(a);
  else
    return launch_dkv_tc<D>(a);
}

template <bool DQ, typename T>
cudaError_t dispatch_d(int D, const Args& a) {
#define RTT_BWD_CASE(DD) \
  case DD:               \
    return launch<DQ, T, DD>(a);
  switch (D) {
    RTT_BWD_CASE(16)
    RTT_BWD_CASE(32)
    RTT_BWD_CASE(64)
    RTT_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RTT_BWD_CASE
}

template <bool DQ>
int dispatch(int dtype, int D, const Args& a) {
  if (a.B <= 0 || a.Tq <= 0 || a.S <= 0 || a.Kh <= 0 || a.H % a.Kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == rtt::kFloat32)
    err = dispatch_d<DQ, float>(D, a);
  else if (dtype == rtt::kBFloat16)
    err = dispatch_d<DQ, __nv_bfloat16>(D, a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches one kernel on
// `stream` and returns cudaGetLastError(); 0 means the launch was accepted.
// q, dout, dq: [B, Tq, H, D]; k, v, dk, dv: [B, S, Kh, D], each with its own
// batch/sequence/head strides and a contiguous last axis; lse, delta:
// contiguous [B, H, Tq] f32.
extern "C" int rtt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int B, int Tq, int S, int H, int Kh, int D,
                                long long qsb, long long qst, long long qsh,
                                long long ksb, long long kst, long long ksh,
                                long long vsb, long long vst, long long vsh,
                                long long osb, long long ost, long long osh,
                                long long gsb, long long gst, long long gsh,
                                float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, B, Tq, S, H, Kh,
               {qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh}, {osb, ost, osh},
               {gsb, gst, gsh}, {0, 0, 0}, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, D, a);
}

extern "C" int rtt_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int B, int Tq, int S, int H, int Kh,
                                 int D, long long qsb, long long qst, long long qsh,
                                 long long ksb, long long kst, long long ksh,
                                 long long vsb, long long vst, long long vsh,
                                 long long osb, long long ost, long long osh,
                                 long long dksb, long long dkst, long long dksh,
                                 long long dvsb, long long dvst, long long dvsh,
                                 float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, B, Tq, S, H, Kh,
               {qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh}, {osb, ost, osh},
               {dksb, dkst, dksh}, {dvsb, dvst, dvsh}, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, D, a);
}
