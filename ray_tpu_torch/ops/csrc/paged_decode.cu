// Paged decode attention, CUDA C++ for Hopper (sm_90a): flash-decoding, a
// split pass over the pages and a combine pass.
//
// Replaces: ray_tpu/ops/paged_attention.py::_decode_kernel, the Pallas
// kernel that paged_attention launches (grid (B, max_pages), block table and
// lengths as scalar prefetch). Same function: one decode query per sequence
// attends over one layer's page pool [Kh, P, page, D] through its block
// table row, with an online f32 softmax; out is [B, H, D] in q's dtype.
//
// Split pass (paged_decode_split_kernel), grid (Kh, B, n_split). Each CTA
// holds one kv head's G query rows, so each K/V row is read from device
// memory once for the whole group (the point of the TPU kernel's batched
// dots), and walks a contiguous run of `pages_per_split` entries of its
// block-table row (read on the device, in place of scalar prefetch), up to
// the row's last token: pages past `len` are never loaded, so the TPU
// kernel's clamp of past-end pages is not needed. Tiles of up to 64 tokens
// (a page, or a 64-token part of a larger page) are double-buffered with
// 16-byte cp.async into shared memory in the pool's own dtype, so the next
// tile's copy runs under this tile's math; rows past `len` are zero-filled
// and masked. A row's 16-byte chunks are spread over CPR neighbouring
// lanes; each thread owns one column chunk of every query row for the rows
// of its lane group (every RPP-th row of a tile). Per row: the G scores
// (partial dots added with shuffles, q pre-scaled by scale * log2e), then
// the online softmax and the accumulator update in f32, both in the
// thread's registers, so a tile needs no shared score buffer and only the
// two barriers of the copy ring. After the last tile the lane groups'
// (m, l, acc) are merged by log-sum-exp through shared memory. The kernel
// is instantiated for G rounded up to a power of two, so a thread holds
// only that many query and accumulator chunks in registers and more CTAs
// fit on an SM (sized for G = 8 throughout, a G = 4 call held 196 registers
// a thread and two CTAs an SM on an NVIDIA H100 80GB HBM3, 700 W). The
// first page's pool slot is read together with the length. A CTA writes its
// partial (m, l, acc[G][D]) in f32 to a workspace, or, when the plan has a
// single split, the normalised output. A split that starts past the row's
// last token writes m = -inf, l = 0, acc = 0.
//
// Combine pass (paged_decode_combine_kernel), grid (Kh, B): merges the
// splits of each (b, kv head) by log-sum-exp and writes out. Split 0 always
// holds a token (lengths >= 1), so the running max is finite and an empty
// split weighs exp2(-inf) = 0.
//
// The split plan (n_split, pages_per_split) is chosen by the caller from
// shapes alone (B, Kh, max_pages and the SM count; never from `lengths`,
// which stays on the device), so a call needs no host sync and can be
// captured in a CUDA graph. Rows need lengths >= 1 (inactive serving slots
// reach here with length + 1); a length past max_pages * page counts as
// max_pages * page, as the gather reference reads it.
//
// Bound on the H100: device-memory bytes, 2 * B * len * Kh * D * 2 bytes of
// K and V per layer in bf16 (the flops are 4 * len * H * D, far below the
// machine balance). The split spreads a long row over several CTAs, so a
// small batch still fills the card; at the serving lengths (a few pages per
// row) launch latency and the first tile's load dominate. Pages smaller
// than 64 tokens fill one tile each, which leaves the tile's rest idle.

#include "common.cuh"

namespace {

using rtt::from_float;
using rtt::to_float;

constexpr int NT = 128;    // threads per CTA (4 warps)
constexpr int MAX_G = 8;   // query heads per kv head this kernel takes
constexpr int TB = 64;     // tokens per tile

// GM: the group G rounded up to a power of two, which sizes each thread's
// query and accumulator registers (the kernel is instantiated per GM)
template <typename T, int D, int GM>
struct Layout {
  static constexpr int RB = D * (int)sizeof(T);   // bytes per K/V row
  static constexpr int CPR = RB / 16;             // 16-byte chunks per row
  static constexpr int EPC = 16 / (int)sizeof(T); // elements per chunk
  static constexpr int RPP = NT / CPR;            // rows per pass of the CTA
  static constexpr size_t STAGE = 2 * TB * RB;    // the K and V rows of one tile
  // stages of the copy ring: a 4-stage ring was slower at long rows in a
  // trial on the H100, as it leaves fewer CTAs on an SM
  static constexpr int NS = 2;
  // the row groups' accumulators, merged after the last tile (aliases the stages)
  static constexpr size_t RED = sizeof(float) * RPP * GM * D;
  static constexpr size_t BUF = NS * STAGE > RED ? NS * STAGE : RED;
  static constexpr size_t BYTES = BUF + sizeof(float) * 2 * RPP * GM;  // + their m and l
  static_assert(CPR >= 2 && CPR <= 32 && NT % CPR == 0 && TB % RPP == 0, "row layout");
};

// 16 bytes of shared memory as EPC floats
__device__ __forceinline__ void smem16(const unsigned char* p, float* dst, const float*) {
  rtt::load16(reinterpret_cast<const float*>(p), dst);
}
__device__ __forceinline__ void smem16(const unsigned char* p, float* dst, const __nv_bfloat16*) {
  rtt::load16(reinterpret_cast<const __nv_bfloat16*>(p), dst);
}

struct PoolStrides {
  long long qsb, qsh, kh, kp, kt, vh, vp, vt, osb, osh;
};

template <typename T, int D, int GM>
__global__ void __launch_bounds__(NT)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages, const int* __restrict__ tables,
                          const int* __restrict__ lengths, T* __restrict__ out,
                          float* __restrict__ ws, int group, int page, int max_pages,
                          int pages_per_split, PoolStrides st, float scale_log2) {
  using L = Layout<T, D, GM>;
  constexpr int CPR = L::CPR, EPC = L::EPC, RPP = L::RPP, RB = L::RB, NS = L::NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const bool direct = gridDim.z == 1;  // one split: write the output itself
  const int tid = threadIdx.x;
  const int rg = tid / CPR, c = tid % CPR;  // row group, 16-byte column chunk
  const long long slot = ((long long)b * gridDim.x + kvh) * gridDim.z + split;
  const long long n_slots = (long long)gridDim.x * gridDim.y * gridDim.z;
  float* ws_acc = ws;                                   // [slots][G][D]
  float* ws_m = ws + n_slots * group * D;               // [slots][G]
  float* ws_l = ws_m + n_slots * group;                 // [slots][G]

  const int* table = tables + (long long)b * max_pages;
  const int p_begin = split * pages_per_split;
  // the first page's pool slot is read together with the length, not after it
  const int pid0 = p_begin < max_pages ? table[p_begin] : 0;
  const int len = min(lengths[b], max_pages * page);
  const int t_begin = p_begin * page;
  if (t_begin >= len) {  // an empty split (never split 0: lengths >= 1)
    if (direct) return;
    for (int o = tid; o < group * D; o += NT) ws_acc[slot * group * D + o] = 0.f;
    if (tid < group) {
      ws_m[slot * group + tid] = -INFINITY;
      ws_l[slot * group + tid] = 0.f;
    }
    return;
  }
  const int t_end = min(len, t_begin + pages_per_split * page);
  const int spp = (page + TB - 1) / TB;  // tiles per page
  const int last = (t_end - 1) / page;   // the split's last page
  const int n_tiles = (last - p_begin) * spp + (t_end - 1 - last * page) / TB + 1;
  const T* kbase = k_pages + kvh * st.kh;
  const T* vbase = v_pages + kvh * st.vh;

  // tile i: page p_begin + i / spp, rows from offset (i % spp) * TB
  auto tile_rows = [&](int i, int& p, int& o) {
    p = p_begin + i / spp;
    o = (i % spp) * TB;
    return min(min(TB, page - o), len - (p * page + o));
  };
  auto load_tile = [&](int i, int stage) {
    int p, o;
    const int valid = tile_rows(i, p, o);
    const long long pid = p == p_begin ? pid0 : table[p];
    const T* kp = kbase + pid * st.kp + (long long)o * st.kt;
    const T* vp = vbase + pid * st.vp + (long long)o * st.vt;
    unsigned char* kd = smem_raw + stage * L::STAGE;
    unsigned char* vd = kd + TB * RB;
#pragma unroll
    for (int e = tid; e < TB * CPR; e += NT) {
      const int r = e / CPR, ch = e % CPR;
      const bool ok = r < valid;
      const int rr = ok ? r : 0;  // zero-filled rows still name a valid source
      rtt::cp_async_16(rtt::smem_addr(kd + r * RB + ch * 16), kp + rr * st.kt + ch * EPC, ok);
      rtt::cp_async_16(rtt::smem_addr(vd + r * RB + ch * 16), vp + rr * st.vt + ch * EPC, ok);
    }
  };

  // the ring: tile i goes to stage i % NS; one commit group per tile, so
  // that waiting for all but the newest NS - 1 groups means tile i is in
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles) load_tile(i, i);
    rtt::cp_async_commit();
  }

  // this thread's column chunk of every query row, scaled so that scores
  // come out in log2 units
  float qr[GM][EPC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < EPC; ++e)
      qr[g][e] = g < group
                     ? to_float(q[b * st.qsb + (long long)(kvh * group + g) * st.qsh + c * EPC + e]) *
                           scale_log2
                     : 0.f;
  // online softmax over this thread's rows (the tile rows r with
  // r mod RPP = rg): running max m (log2 units), sum l, and the accumulator
  // of this thread's column chunk
  float m[GM], l[GM], acc[GM][EPC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % NS;
    // the stage of tile i - 1, free since the barrier that ended its tile
    if (i + NS - 1 < n_tiles) load_tile(i + NS - 1, (i + NS - 1) % NS);
    rtt::cp_async_commit();
    rtt::cp_async_wait<NS - 1>();
    __syncthreads();  // this tile's rows are visible
    int p, o;
    const int valid = tile_rows(i, p, o);
    const unsigned char* ks = smem_raw + stage * L::STAGE;
    const unsigned char* vs = ks + TB * RB;

#pragma unroll
    for (int r0 = 0; r0 < TB; r0 += RPP) {
      const int r = r0 + rg;
      const bool ok = r < valid;
      float kv[EPC], vv[EPC];
      smem16(ks + r * RB + c * 16, kv, k_pages);
      smem16(vs + r * RB + c * 16, vv, v_pages);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (GM == 1 || g < group) {
          // the score: the CPR lanes of the row each dot one chunk, then add up
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPC; ++e) s = fmaf(qr[g][e], kv[e], s);
#pragma unroll
          for (int off = CPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (ok) {
            const float m_new = fmaxf(m[g], s);
            const float alpha = exp2f(m[g] - m_new);  // 0 on the thread's first row
            const float pr = exp2f(s - m_new);
            l[g] = fmaf(l[g], alpha, pr);
#pragma unroll
            for (int e = 0; e < EPC; ++e) acc[g][e] = fmaf(pr, vv[e], acc[g][e] * alpha);
            m[g] = m_new;
          }
        }
      }
    }
    __syncthreads();  // this stage is free before it is refilled
  }

  // merge the row groups' (m, l, acc) by log-sum-exp; a row group that saw
  // no token has m = -inf and weighs 0, and some row group saw one
  float* red = reinterpret_cast<float*>(smem_raw);  // [RPP][GM][D]
  float* m_red = reinterpret_cast<float*>(smem_raw + L::BUF);  // [RPP][GM]
  float* l_red = m_red + RPP * GM;                              // [RPP][GM]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < group) {
#pragma unroll
      for (int e = 0; e < EPC; ++e) red[(rg * GM + g) * D + c * EPC + e] = acc[g][e];
      if (c == 0) {
        m_red[rg * GM + g] = m[g];
        l_red[rg * GM + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int o = tid; o < group * D; o += NT) {
    const int g = o / D, d = o % D;
    float mx = -INFINITY;
    for (int r = 0; r < RPP; ++r) mx = fmaxf(mx, m_red[r * GM + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll 8
    for (int r = 0; r < RPP; ++r) {
      const float w = exp2f(m_red[r * GM + g] - mx);
      lsum = fmaf(w, l_red[r * GM + g], lsum);
      a = fmaf(w, red[(r * GM + g) * D + d], a);
    }
    if (direct) {
      out[b * st.osb + (long long)(kvh * group + g) * st.osh + d] = from_float<T>(a / lsum);
    } else {
      ws_acc[slot * group * D + o] = a;
      if (d == 0) {
        ws_m[slot * group + g] = mx;
        ws_l[slot * group + g] = lsum;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
paged_decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int group,
                            int D, int n_split, long long osb, long long osh) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const long long slot0 = ((long long)b * gridDim.x + kvh) * n_split;
  const long long n_slots = (long long)gridDim.x * gridDim.y * n_split;
  const float* ws_acc = ws;
  const float* ws_m = ws + n_slots * group * D;
  const float* ws_l = ws_m + n_slots * group;
  for (int o = threadIdx.x; o < group * D; o += NT) {
    const int g = o / D, d = o % D;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ws_m[(slot0 + s) * group + g]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long long at = (slot0 + s) * group + g;
      const float w = exp2f(ws_m[at] - mx);  // 0 for an empty split
      l = fmaf(w, ws_l[at], l);
      a = fmaf(w, ws_acc[at * D + d], a);
    }
    out[b * osb + (long long)(kvh * group + g) * osh + d] = from_float<T>(a / l);
  }
}

struct SplitArgs {
  const void *q, *kp, *vp;
  const int *tables, *lengths;
  void* out;
  float* ws;
  int B, Kh, G, page, max_pages, n_split, pages_per_split;
  PoolStrides st;
  float scale_log2;
  cudaStream_t stream;
};

template <typename T, int D, int GM>
cudaError_t launch_split(const SplitArgs& a) {
  auto kernel = paged_decode_split_kernel<T, D, GM>;
  const size_t smem = Layout<T, D, GM>::BYTES;
  static rtt::SmemCap allowed;  // per (T, D, GM) instantiation
  cudaError_t err = rtt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Kh, a.B, a.n_split);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp), static_cast<const T*>(a.vp),
      a.tables, a.lengths, static_cast<T*>(a.out), a.ws, a.G, a.page, a.max_pages,
      a.pages_per_split, a.st, a.scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const SplitArgs& a) {
  if (a.G <= 1) return launch_split<T, D, 1>(a);
  if (a.G <= 2) return launch_split<T, D, 2>(a);
  if (a.G <= 4) return launch_split<T, D, 4>(a);
  return launch_split<T, D, MAX_G>(a);
}

template <typename T>
cudaError_t dispatch_d(int D, const SplitArgs& a) {
#define RTT_PAGED_CASE(DD) \
  case DD:                 \
    return dispatch_g<T, DD>(a);
  switch (D) {
    RTT_PAGED_CASE(16)
    RTT_PAGED_CASE(32)
    RTT_PAGED_CASE(64)
    RTT_PAGED_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RTT_PAGED_CASE
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches one kernel on
// `stream` and returns cudaGetLastError(); 0 means the launch was accepted.
// The split pass writes `out` when n_split == 1 and the workspace `ws` (f32,
// B * Kh * n_split * G * (D + 2) values) otherwise; the combine pass then
// reads `ws` and writes `out`. The pools' page, token and head strides and
// their base must keep every row 16-byte aligned.
extern "C" int rtt_paged_decode_split(int dtype, const void* q, const void* k_pages,
                                      const void* v_pages, const int* tables,
                                      const int* lengths, void* out, void* ws, int B, int H,
                                      int Kh, int D, int page, int max_pages, int n_split,
                                      int pages_per_split, long long qsb, long long qsh,
                                      long long kh_s, long long kp_s, long long kt_s,
                                      long long vh_s, long long vp_s, long long vt_s,
                                      long long osb, long long osh, float scale, void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || H / Kh > MAX_G || page <= 0 || max_pages <= 0 ||
      n_split <= 0 || pages_per_split <= 0 || (long long)n_split * pages_per_split < max_pages)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k_pages, v_pages, tables, lengths, out, static_cast<float*>(ws),
                    B, Kh, H / Kh, page, max_pages, n_split, pages_per_split,
                    {qsb, qsh, kh_s, kp_s, kt_s, vh_s, vp_s, vt_s, osb, osh},
                    scale * rtt::kLog2e, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == rtt::kFloat32)
    err = dispatch_d<float>(D, a);
  else if (dtype == rtt::kBFloat16)
    err = dispatch_d<__nv_bfloat16>(D, a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int rtt_paged_decode_combine(int dtype, const void* ws, void* out, int B, int H,
                                        int Kh, int D, int n_split, long long osb,
                                        long long osh, void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || H / Kh > MAX_G || D <= 0 || n_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Kh, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  if (dtype == rtt::kFloat32)
    paged_decode_combine_kernel<float><<<grid, NT, 0, st>>>(w, static_cast<float*>(out),
                                                           H / Kh, D, n_split, osb, osh);
  else if (dtype == rtt::kBFloat16)
    paged_decode_combine_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        w, static_cast<__nv_bfloat16*>(out), H / Kh, D, n_split, osb, osh);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned by the entry points above.
extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
