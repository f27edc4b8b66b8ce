// Paged decode attention, CUDA C++ for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/paged_attention.py::_decode_kernel, the Pallas
// kernel that paged_attention launches (grid (B, max_pages), block table and
// lengths as scalar prefetch). Same function: one decode query per sequence
// attends over one layer's page pool [Kh, P, page, D] through its block
// table row, with an online f32 softmax; out is [B, H, D] in q's dtype.
//
// Design. One CTA per (b, kv head). The CTA holds that head's G query rows,
// so each K/V page is read from device memory once for the whole group
// (the point of the TPU kernel's batched dots). The CTA reads
// block_tables[b] itself (in place of scalar prefetch) and walks only the
// ceil(len / page) pages that hold tokens, so the TPU kernel's clamp of
// past-end pages to the last valid one is not needed; columns past `len`
// in the last page are masked, and their V rows are zeroed in shared
// memory. Per page: 16-byte vector loads of K and V into shared memory as
// f32, G x page scores, one warp per query row for the softmax update, then
// the G x D accumulator update. Rows need lengths >= 1 (inactive serving
// slots reach here with length + 1).
//
// Bound on the H100: device-memory bytes, 2 * B * len * Kh * D * 2 bytes of
// K and V per layer in bf16 (the flops are 4 * len * H * D, far below the
// machine balance). The simple design leaves for later: B * Kh CTAs (64 at
// the serving batch) fill half the card and load one page at a time with no
// copy in flight while the page computes; a split over pages (split-K) with
// a second combine pass, and cp.async/TMA double buffering, are the next
// steps.

#include "common.cuh"

namespace {

using rtt::from_float;
using rtt::to_float;

constexpr int NT = 128;    // threads per CTA (4 warps)
constexpr int MAX_G = 8;   // query heads per kv head this kernel takes

template <int D>
size_t smem_bytes(int page) {
  return sizeof(float) * (MAX_G * D + 3 * MAX_G + (size_t)page * (D + 1) +
                          (size_t)page * D + (size_t)MAX_G * page);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int group, int page, int max_pages, long long qsb,
                    long long qsh, long long kh_stride, long long kp_stride,
                    long long kt_stride, long long vh_stride,
                    long long vp_stride, long long vt_stride, long long osb,
                    long long osh, float scale) {
  constexpr int LDK = D + 1;           // K page rows padded: score reads are conflict-free
  constexpr int ACC = MAX_G * D / NT;  // accumulator entries per thread
  constexpr int VN = rtt::Vec<T>::N;   // elements per 16-byte load
  extern __shared__ float smem[];
  float* Qs = smem;                  // [G][D]
  float* m_s = Qs + MAX_G * D;       // [G] running max
  float* l_s = m_s + MAX_G;          // [G] running sum
  float* a_s = l_s + MAX_G;          // [G] this page's rescale factor
  float* Ks = a_s + MAX_G;           // [page][LDK]
  float* Vs = Ks + page * LDK;       // [page][D]
  float* Ps = Vs + page * D;         // [G][page]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = lengths[b];
  const int n_pages = (len + page - 1) / page;
  const int* table = tables + (long long)b * max_pages;
  const T* kbase = k_pages + kvh * kh_stride;
  const T* vbase = v_pages + kvh * vh_stride;

  for (int e = tid; e < group * D; e += NT) {
    const int g = e / D, d = e % D;
    Qs[e] = to_float(q[b * qsb + (long long)(kvh * group + g) * qsh + d]);
  }
  if (tid < group) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int c = 0; c < ACC; ++c) acc[c] = 0.f;

  for (int p = 0; p < n_pages; ++p) {
    const long long pid = table[p];
    const T* kp = kbase + pid * kp_stride;
    const T* vp = vbase + pid * vp_stride;
    const int valid = min(page, len - p * page);
    __syncthreads();  // the previous page's readers are done
    for (int e = tid * VN; e < page * D; e += NT * VN) {
      const int t = e / D, d = e % D;  // VN divides D: a vector never straddles rows
      float x[VN];
      if (t < valid) {
        rtt::load16(kp + t * kt_stride + d, x);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) Ks[t * LDK + d + i] = x[i];
      if (t < valid) {
        rtt::load16(vp + t * vt_stride + d, x);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) Vs[t * D + d + i] = x[i];
    }
    __syncthreads();

    for (int e = tid; e < group * page; e += NT) {
      const int g = e / page, t = e % page;
      float s = -INFINITY;
      if (t < valid) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(Qs[g * D + d], Ks[t * LDK + d], dot);
        s = dot * scale;
      }
      Ps[g * page + t] = s;
    }
    __syncthreads();

    // one warp per query row: page 0 always holds a valid token, so the
    // running max is finite from the first page on
    for (int g = warp; g < group; g += NT / 32) {
      float mx = -INFINITY;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, Ps[g * page + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float pr = expf(Ps[g * page + t] - m_new);
        Ps[g * page + t] = pr;
        sum += pr;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < ACC; ++c) {
      const int o = tid + NT * c;
      if (o < group * D) {
        const int g = o / D, d = o % D;
        float a = acc[c] * a_s[g];
        for (int t = 0; t < valid; ++t) a = fmaf(Ps[g * page + t], Vs[t * D + d], a);
        acc[c] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < ACC; ++c) {
    const int o = tid + NT * c;
    if (o < group * D) {
      const int g = o / D, d = o % D;
      out[b * osb + (long long)(kvh * group + g) * osh + d] = from_float<T>(acc[c] / l_s[g]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* lengths, void* out, int B,
                   int Kh, int G, int page, int max_pages, long long qsb,
                   long long qsh, long long kh_s, long long kp_s, long long kt_s,
                   long long vh_s, long long vp_s, long long vt_s, long long osb,
                   long long osh, float scale, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, D>;
  const size_t smem = smem_bytes<D>(page);
  static size_t allowed = 48 * 1024;  // per (T, D) instantiation
  cudaError_t err = rtt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(Kh, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      tables, lengths, static_cast<T*>(out), G, page, max_pages, qsb, qsh, kh_s,
      kp_s, kt_s, vh_s, vp_s, vt_s, osb, osh, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp,
                       const int* tables, const int* lengths, void* out, int B,
                       int Kh, int G, int page, int max_pages, long long qsb,
                       long long qsh, long long kh_s, long long kp_s,
                       long long kt_s, long long vh_s, long long vp_s,
                       long long vt_s, long long osb, long long osh, float scale,
                       cudaStream_t st) {
#define RTT_PAGED_CASE(DD)                                                          \
  case DD:                                                                          \
    return launch<T, DD>(q, kp, vp, tables, lengths, out, B, Kh, G, page, max_pages, \
                         qsb, qsh, kh_s, kp_s, kt_s, vh_s, vp_s, vt_s, osb, osh,    \
                         scale, st);
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

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError(); 0 means the launch was accepted.
extern "C" int rtt_paged_decode(int dtype, const void* q, const void* k_pages,
                                const void* v_pages, const int* tables,
                                const int* lengths, void* out, int B, int H,
                                int Kh, int D, int page, int max_pages,
                                long long qsb, long long qsh, long long kh_s,
                                long long kp_s, long long kt_s, long long vh_s,
                                long long vp_s, long long vt_s, long long osb,
                                long long osh, float scale, void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || H / Kh > MAX_G || page <= 0 ||
      max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Kh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == rtt::kFloat32)
    err = dispatch_d<float>(D, q, k_pages, v_pages, tables, lengths, out, B, Kh, G,
                            page, max_pages, qsb, qsh, kh_s, kp_s, kt_s, vh_s, vp_s,
                            vt_s, osb, osh, scale, st);
  else if (dtype == rtt::kBFloat16)
    err = dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, tables, lengths, out, B,
                                    Kh, G, page, max_pages, qsb, qsh, kh_s, kp_s,
                                    kt_s, vh_s, vp_s, vt_s, osb, osh, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Message for an error code returned by the entry points above.
extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
