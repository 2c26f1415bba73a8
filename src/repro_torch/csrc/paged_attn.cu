// Paged attention kernels for Hopper (sm_90a): the scheduler's data plane.
//
//   K5 paged decode   replaces repro/kernels/paged_attn.py
//                     _make_paged_attn_kernel(lanes_per_step, quantized=False):
//                     one query token per request against the KV pool's page
//                     store, addressed by the request's page-index vector
//   K6 chunk prefill  replaces repro/kernels/paged_chunk_attn.py
//                     _make_chunk_attn_kernel(False): a right-aligned prompt
//                     chunk per request, causal at the chunk boundary, against
//                     the already-paged prefix and its own freshly written K/V
//   K7, K8            replace the same two Pallas kernels built with
//                     quantized=True (_paged_attn_quant_call,
//                     _chunk_attn_quant_call): K5 and K6 over the quantized
//                     page store, int8 pages with one float32 scale per
//                     (page, KV head), dequantized in the kernel
//
// Both compute, for each (request b, query column j, query head h), softmax
// attention over the KV positions t that are valid for it:
//   t < cache_len[b], t <= q_pos = cache_len[b] - S + j, and the lane
//   page_idx[b, t / ps] names a page of the store (a -1 lane is masked and
//   never read).
// A query column is real only if j >= S - new_lens[b] and q_pos >= 0; K5 is
// the case S = 1 with new_lens = 1, where the causal limit is t < cache_len.
// A query with no valid position writes zeros (the Pallas kernels floor the
// denominator at 1e-20; the accumulator is 0).  Query heads are grouped by
// KV head (GQA, g = H / KVH heads per KV head).
//
// What bounds them on this card: bytes.  A decode step reads each valid K/V
// row once per KV head, 2 * hd elements, and does about 4 * g * hd flops per
// row, far below the ~295 flops per byte where the tensor cores would start
// to matter.  So the design reads each K/V row from device memory once per
// CTA and shares it among the CTA's warps through shared memory:
// * one CTA per (request, block of qb query columns, KV head); one warp per
//   (column, query head) pair of that block, so the g heads (and, for K6, the
//   qb columns) that share a KV head read its rows once;
// * the TPU kernel's sequential grid over page lanes becomes a loop inside
//   the CTA over tiles of 32 positions: the CTA loads the tile's page indices,
//   stages the valid K/V rows in shared memory as float32, and each warp
//   scores the 32 positions (lane j takes position j), then updates its
//   running max, denominator and float32 accumulator (online softmax) and
//   folds the tile's V rows into the accumulator (hd / 32 elements a lane);
// * the loop stops at the last position any of the CTA's queries can see
//   (min(cache_len, q_pos + 1)), where the TPU kernel walked all P lanes and
//   masked; a -1 lane is skipped, not clamped to page 0 and read;
// * nothing crosses CTAs, so there is no second pass and no atomics.
// Scores use expf (not __expf); sums run in another order than the Pallas
// kernel's, so results agree to float32 rounding, not bit for bit.
//
// K7/K8 are the same kernel body instantiated for int8 pages.  Where the
// CTA loads a tile's page indices it also loads that page's K and V scale
// for its KV head, once per staged position, and the staging loop writes
// float(int8) * scale into the float32 tile: the order of ``repro``'s
// dequantization (cast, then one multiply), so the plain version and the
// kernel see the same float32 K/V.  An int8 row is a quarter of a float32
// one and half a bf16 one, so the bytes that bound the kernel halve against
// K5/K6 on the bf16 store.
//
// Types: q in {float32, bfloat16}, pages in {bfloat16, float32, int8 with
// scales}; all arithmetic in float32; the output has q's type.  Limits:
// hd <= 128, g * qb <= 16 warps.  Every entry point enqueues on the caller's stream,
// allocates nothing and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 32;        // positions staged per loop step: one per lane
constexpr int kMaxHd = 128;
constexpr int kMaxPerLane = kMaxHd / kWarp;
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Shape {
  int B, S, H, KVH, hd, ps, P, n_pages, qb;
};

// Shared memory: K tile [kTile][hd + 1] (the +1 keeps lane j's row reads on
// distinct banks), V tile [kTile][hd], the warps' queries [warps][hd], the
// tile's page per position [kTile] and, for int8 pages, its K and V scales
// [2][kTile].
__host__ __device__ inline size_t smem_bytes(int hd, int warps, bool quant) {
  return sizeof(float) * (size_t(kTile) * (hd + 1) + size_t(kTile) * hd +
                          size_t(warps) * hd + (quant ? 2 * kTile : 0)) +
         sizeof(int) * kTile;
}

// k_scale / v_scale: (n_pages, KVH) float32 for int8 pages, unused (null)
// otherwise.
template <typename TQ, typename TKV>
__global__ void paged_attn_kernel(const TQ* __restrict__ q,
                                  const TKV* __restrict__ k_pages,
                                  const TKV* __restrict__ v_pages,
                                  const float* __restrict__ k_scale,
                                  const float* __restrict__ v_scale,
                                  const int32_t* __restrict__ page_idx,
                                  const int32_t* __restrict__ cache_len,
                                  const int32_t* __restrict__ new_lens,
                                  TQ* __restrict__ out, Shape sh) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  extern __shared__ float smem[];
  const int g = sh.H / sh.KVH;
  const int hd = sh.hd;
  const int b = blockIdx.x;
  const int kh = blockIdx.z;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int c0 = blockIdx.y * sh.qb;
  const int col = c0 + warp / g;  // this warp's chunk column
  const int head = kh * g + warp % g;

  float* ks = smem;
  float* vs = ks + kTile * (hd + 1);
  float* qs = vs + kTile * hd;
  int* tpage = reinterpret_cast<int*>(qs + nwarps * hd);
  float* tks = reinterpret_cast<float*>(tpage + kTile);  // int8 pages only
  float* tvs = tks + kTile;

  const int clen = cache_len[b];
  const int nl = new_lens == nullptr ? 1 : new_lens[b];
  const int n_pos = min(clen, sh.P * sh.ps);  // positions the lanes can hold
  // the last position any query of this CTA may see, plus one
  const int last_col = min(c0 + sh.qb, sh.S) - 1;
  const int t_end = min(n_pos, clen - sh.S + last_col + 1);
  // this warp's own query and its limit (0: a padding column, no query)
  const int q_pos = clen - sh.S + col;
  const bool real = col < sh.S && col >= sh.S - nl && q_pos >= 0;
  const int t_lim = real ? min(n_pos, q_pos + 1) : 0;

  const size_t q_row =
      ((size_t(b) * sh.S + (col < sh.S ? col : 0)) * sh.H + head) * hd;
  for (int d = lane; d < hd; d += kWarp)
    qs[warp * hd + d] = real ? to_f32(q[q_row + d]) : 0.f;

  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  float m = -INFINITY;
  float l = 0.f;
  float acc[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < t_end; t0 += kTile) {
    if (threadIdx.x < kTile) {
      const int t = t0 + threadIdx.x;
      int pg = -1;
      if (t < t_end) {
        pg = page_idx[size_t(b) * sh.P + t / sh.ps];
        if (pg >= sh.n_pages) pg = -1;
      }
      tpage[threadIdx.x] = pg < 0 ? -1 : pg;
      if constexpr (kQuant) {
        if (pg >= 0) {
          tks[threadIdx.x] = k_scale[size_t(pg) * sh.KVH + kh];
          tvs[threadIdx.x] = v_scale[size_t(pg) * sh.KVH + kh];
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * hd; i += blockDim.x) {
      const int j = i / hd;
      const int d = i - j * hd;
      const int pg = tpage[j];
      if (pg >= 0) {
        const size_t off =
            ((size_t(pg) * sh.ps + (t0 + j) % sh.ps) * sh.KVH + kh) * hd + d;
        if constexpr (kQuant) {  // cast, then one multiply: repro's order
          ks[j * (hd + 1) + d] = to_f32(k_pages[off]) * tks[j];
          vs[j * hd + d] = to_f32(v_pages[off]) * tvs[j];
        } else {
          ks[j * (hd + 1) + d] = to_f32(k_pages[off]);
          vs[j * hd + d] = to_f32(v_pages[off]);
        }
      }
    }
    __syncthreads();

    // lane j scores position t0 + j for this warp's query
    const bool valid = tpage[lane] >= 0 && t0 + lane < t_lim;
    float s = -INFINITY;
    if (valid) {
      const float* kr = ks + lane * (hd + 1);
      const float* qr = qs + warp * hd;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      s = dot * scale;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float m_safe = isinf(m_new) ? 0.f : m_new;  // nothing valid yet
    const float p = valid ? expf(s - m_safe) : 0.f;
    const float corr = isinf(m) ? 0.f : expf(m - m_safe);
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) acc[i] *= corr;
    for (int j = 0; j < kTile; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
      if (pj == 0.f) continue;  // masked (or underflowed): adds nothing, and
                                // its V row may never have been staged
      const float* vr = vs + j * hd;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + i * kWarp;
        if (d < hd) acc[i] = fmaf(pj, vr[d], acc[i]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (col < sh.S) {
    const float den = fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + i * kWarp;
      if (d < hd) out[q_row + d] = from_f32<TQ>(acc[i] / den);
    }
  }
}

// The page store's element type, as the entry points name it.
enum KvType { kKvF32 = 0, kKvBf16 = 1, kKvInt8 = 2 };

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int32_t* page_idx, const int32_t* cache_len,
                   const int32_t* new_lens, void* out, Shape sh,
                   cudaStream_t stream) {
  const int g = sh.H / sh.KVH;
  const int warps = g * sh.qb;
  const size_t smem =
      smem_bytes(sh.hd, warps, std::is_same<TKV, int8_t>::value);
  const dim3 grid(sh.B, (sh.S + sh.qb - 1) / sh.qb, sh.KVH);
  paged_attn_kernel<TQ, TKV><<<grid, warps * kWarp, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), k_scale, v_scale, page_idx, cache_len,
      new_lens, static_cast<TQ*>(out), sh);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_q(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int32_t* page_idx, const int32_t* cache_len,
                     const int32_t* new_lens, void* out, Shape sh, int kv,
                     cudaStream_t st) {
  switch (kv) {
    case kKvBf16:
      return launch<TQ, __nv_bfloat16>(q, k, v, k_scale, v_scale, page_idx,
                                       cache_len, new_lens, out, sh, st);
    case kKvInt8:
      return launch<TQ, int8_t>(q, k, v, k_scale, v_scale, page_idx,
                                cache_len, new_lens, out, sh, st);
    default:
      return launch<TQ, float>(q, k, v, k_scale, v_scale, page_idx,
                               cache_len, new_lens, out, sh, st);
  }
}

cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int32_t* page_idx, const int32_t* cache_len,
                     const int32_t* new_lens, void* out, Shape sh,
                     int q_bf16, int kv, void* stream) {
  if (sh.B <= 0 || sh.S <= 0 || sh.KVH <= 0) return cudaSuccess;
  if (sh.H % sh.KVH != 0 || sh.hd <= 0 || sh.hd > kMaxHd || sh.ps <= 0 ||
      sh.qb <= 0 || (sh.H / sh.KVH) * sh.qb > kMaxWarps)
    return cudaErrorInvalidValue;
  if (kv == kKvInt8 && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return launch_q<__nv_bfloat16>(q, k, v, k_scale, v_scale, page_idx,
                                   cache_len, new_lens, out, sh, kv, st);
  return launch_q<float>(q, k, v, k_scale, v_scale, page_idx, cache_len,
                         new_lens, out, sh, kv, st);
}

}  // namespace

extern "C" {

// K5: q (B, H, hd); k/v pages (n_pages, ps, KVH, hd); page_idx (B, P) int32;
// cache_len (B,) int32; out (B, H, hd).  All contiguous.
int bravo_paged_attn(const void* q, const void* k_pages, const void* v_pages,
                     const int32_t* page_idx, const int32_t* cache_len,
                     void* out, int B, int H, int KVH, int hd, int ps, int P,
                     int n_pages, int q_bf16, int kv_bf16, void* stream) {
  const Shape sh{B, 1, H, KVH, hd, ps, P, n_pages, 1};
  return static_cast<int>(dispatch(q, k_pages, v_pages, nullptr, nullptr,
                                   page_idx, cache_len, nullptr, out, sh,
                                   q_bf16, kv_bf16 ? kKvBf16 : kKvF32,
                                   stream));
}

// K6: q (B, S, H, hd) right-aligned chunks; new_lens (B,) int32 valid
// trailing columns; cache_len the length after the chunk; qb query columns
// per CTA; out (B, S, H, hd).
int bravo_paged_chunk_attn(const void* q, const void* k_pages,
                           const void* v_pages, const int32_t* page_idx,
                           const int32_t* cache_len, const int32_t* new_lens,
                           void* out, int B, int S, int H, int KVH, int hd,
                           int ps, int P, int n_pages, int qb, int q_bf16,
                           int kv_bf16, void* stream) {
  const Shape sh{B, S, H, KVH, hd, ps, P, n_pages, qb};
  return static_cast<int>(dispatch(q, k_pages, v_pages, nullptr, nullptr,
                                   page_idx, cache_len, new_lens, out, sh,
                                   q_bf16, kv_bf16 ? kKvBf16 : kKvF32,
                                   stream));
}

// K7: K5 over int8 k/v pages (n_pages, ps, KVH, hd) with float32 k/v_scale
// (n_pages, KVH).
int bravo_paged_attn_quant(const void* q, const void* k_pages,
                           const void* v_pages, const float* k_scale,
                           const float* v_scale, const int32_t* page_idx,
                           const int32_t* cache_len, void* out, int B, int H,
                           int KVH, int hd, int ps, int P, int n_pages,
                           int q_bf16, void* stream) {
  const Shape sh{B, 1, H, KVH, hd, ps, P, n_pages, 1};
  return static_cast<int>(dispatch(q, k_pages, v_pages, k_scale, v_scale,
                                   page_idx, cache_len, nullptr, out, sh,
                                   q_bf16, kKvInt8, stream));
}

// K8: K6 over int8 k/v pages with float32 k/v_scale (n_pages, KVH).
int bravo_paged_chunk_attn_quant(const void* q, const void* k_pages,
                                 const void* v_pages, const float* k_scale,
                                 const float* v_scale,
                                 const int32_t* page_idx,
                                 const int32_t* cache_len,
                                 const int32_t* new_lens, void* out, int B,
                                 int S, int H, int KVH, int hd, int ps, int P,
                                 int n_pages, int qb, int q_bf16,
                                 void* stream) {
  const Shape sh{B, S, H, KVH, hd, ps, P, n_pages, qb};
  return static_cast<int>(dispatch(q, k_pages, v_pages, k_scale, v_scale,
                                   page_idx, cache_len, new_lens, out, sh,
                                   q_bf16, kKvInt8, stream));
}

const char* bravo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
