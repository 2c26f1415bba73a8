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
//   page_idx[b, t / ps] names a page of the store (a -1 lane, or a page past
//   the store, is masked and never read).
// A query column is real only if j >= S - new_lens[b] and q_pos >= 0; K5 is
// the case S = 1 with new_lens = 1, where the causal limit is t < cache_len.
// A query with no valid position writes zeros (the Pallas kernels floor the
// denominator at 1e-20; the accumulator is 0).  Query heads are grouped by
// KV head (GQA, g = H / KVH heads per KV head).
//
// What bounds them on this card: bytes.  A decode step reads each valid K/V
// row once per KV head, 2 * hd elements, and does about 4 * g * hd flops per
// row, far below the ~295 flops per byte where the tensor cores would start
// to matter.  Both kernels read each K/V row from device memory once per CTA
// and share it among the CTA's warps (the query heads of one KV head)
// through shared memory.  Scores use expf (not __expf); sums run in another
// order than the Pallas kernels', so results agree to float32 rounding, not
// bit for bit.  Types: q in {float32, bfloat16}, pages in {bfloat16,
// float32, int8 with scales}; all arithmetic in float32; the output has q's
// type.  Any hd from 1 to 256 runs: the kernels are instantiated for the
// widths 16, 32, 64, 128 and 256 and a call takes the smallest that holds
// its hd, the padding zero in q and in the staged K/V rows (so it adds
// exact zeros to every sum).  Every entry point enqueues on the caller's
// stream, allocates nothing and returns cudaGetLastError() after the
// launch.
//
// ---------------------------------------------------------------------------
// K5/K7, the decode kernel (paged_decode_kernel).  It is bound by the bytes
// of the valid K/V rows, so everything in it serves keeping device memory
// busy, with as few instructions a byte as the exact float32 result allows:
// 1. The width (hd padded) is a template argument, so every per-row loop
//    (the dot product, the V fold, the conversions) unrolls, and a lane's
//    accumulators are fixed register arrays.
// 2. Flash-decoding.  The KV positions are split over the grid: one CTA per
//    (split, request, KV head, group of 4 query heads); a split is a fixed
//    run of page lanes.  The wrapper picks the split count from host facts
//    alone (lanes, page size, B x KVH, the SM count and how many CTAs of
//    this kernel an SM holds, from the occupancy calculator), never from
//    cache_len's values, so a call stays free of host syncs and capturable
//    in a CUDA graph; the splits fill one wave of resident CTAs.  A split
//    with no valid position writes an empty partial (m = -inf, l = 0); a
//    second kernel combines the partials, gives exact zeros for a row with
//    none and never forms -inf - (-inf).  With one split (a decode tick's
//    short rows) the first pass writes the output itself.
// 3. 16-byte loads overlapped with compute.  The CTA copies each tile of
//    64 positions' K and V rows (32 for rows of 512 bytes or more, 128 for
//    int8 pages in the all-heads layout) into a ring of 2-3 shared-memory
//    stages with cp.async.cg, 16 bytes a thread, consecutive threads along
//    a row; the next tiles load while its warps score the current one.
//    Rows stay in the page's own type (bf16, float32, int8), unpadded,
//    their 16-byte chunks XOR-swizzled by row so that lanes reading one
//    chunk of 8 rows, or 8 chunks of one row, hit distinct banks.  Each
//    row's page offset (and int8 scales) is worked out once, a tile ahead,
//    with a multiply-shift in place of the division by the page size.  A
//    masked row, and a row's padding past hd, is zero-filled by the copy
//    (no read), so its V times a zero weight is zero.  Pages that are not
//    16-byte aligned, or rows whose hd x element size is not a multiple of
//    16 bytes, take a synchronous element-by-element copy into the same
//    layout: the same kernel, checked on the card too.
// 4. int8 pages are dequantized in registers after the load: the bytes are
//    turned into floats exactly (a byte-permute and one add), then each is
//    multiplied by its (page, KV head) scale, as repro does it (cast, then
//    one multiply), so the kernel and the plain version see the same
//    float32 K/V.
// 5. GQA without re-reading: the CTA's query heads share each staged tile.
//    Lane j scores position j of its warp's 32 rows; the weights go through
//    shared memory, and the V fold gives each lane one 16-byte chunk of a
//    row (a group of lanes per row), so V is read with vector loads and no
//    shuffle loop.  Two warp layouts (with_decode): for a decode tick,
//    one head a warp (four heads side by side, the shortest chain); for
//    int8 pages whose lanes hold 1024 positions or more, all four heads a
//    warp, so each int8 row is converted and dequantized once for the four
//    heads.  The warps sharing
//    a head merge their softmax states through shared memory at the end.
//    Past 4 query heads per KV head the heads form groups of 4, one CTA
//    each, and each group reads the KV head's rows itself (granite-20b's
//    48:1 runs as 12 groups); with fewer than 4 (one query head a KV head,
//    as in hubert-xlarge or phi-3-vision) the CTA's other head slots are
//    empty.
//
// Two build-time switches serve the timing sweep
// (repro_torch/benchmarks/decode_sweep.py) and are off in the wrappers'
// build: BRAVO_LONG_ROWS moves the lane capacity from which int8 pages
// take the all-heads layout, and BRAVO_DECODE_ABLATE=1 (copies only) or 2
// (arithmetic only) switches off half of the decode kernel's work.
//
// K6/K8, the chunk kernel (paged_attn_kernel).  One CTA per (request,
// block of qb query columns, KV head); its warps loop over the (column,
// query head) pairs of the block, at most 16 warps, so any g runs.  The
// CTA walks tiles of 32 positions: it loads the tile's page indices (and,
// for int8 pages, the page's K and V scale), stages the valid K/V rows in
// shared memory as float32 (float(int8) * scale for int8 pages), and each
// warp scores the 32 positions (lane j takes position j), then updates its
// running max, denominator and float32 accumulator (online softmax) and
// folds the tile's V rows into the accumulator.  The walk stops at the last
// position any of the CTA's queries can see.  Nothing crosses CTAs.  With
// more pairs than warps the CTA walks the positions once per pass of
// pairs.  Tiles above 48 KB of shared memory (hd 256) opt in to more.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef BRAVO_LONG_ROWS  // see the note above; the timing sweep moves it
#define BRAVO_LONG_ROWS 1024
#endif
#ifndef BRAVO_DECODE_ABLATE  // 0: the kernel; 1: copies only; 2: arithmetic
#define BRAVO_DECODE_ABLATE 0
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 32;        // positions a warp scores at once: one a lane
constexpr int kMaxWarps = 16;    // chunk kernel: warps per CTA
constexpr int kDecHeads = 4;     // decode kernel: query heads per CTA
constexpr int kMaxSplitPages = 512;   // page lanes of one decode split
constexpr int kMaxHd = 256;           // the widest instantiation
constexpr size_t kDefaultSmem = 48 * 1024;
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

// A kernel whose dynamic shared memory passes the default 48 KB must opt in.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ===========================================================================
// K6/K8: chunk prefill
// ===========================================================================

struct Shape {
  int B, S, H, KVH, hd, ps, P, n_pages, qb;
};

// HD is the padded width, sh.hd the rows' length in memory.
// Shared memory: K tile [kTile][HD + 1] (the +1 keeps lane j's row reads on
// distinct banks), V tile [kTile][HD], the warps' queries [warps][HD], the
// tile's page per position [kTile] and, for int8 pages, its K and V scales
// [2][kTile].
__host__ __device__ inline size_t chunk_smem_bytes(int hd, int warps,
                                                   bool quant) {
  return sizeof(float) * (size_t(kTile) * (hd + 1) + size_t(kTile) * hd +
                          size_t(warps) * hd + (quant ? 2 * kTile : 0)) +
         sizeof(int) * kTile;
}

// k_scale / v_scale: (n_pages, KVH) float32 for int8 pages, unused (null)
// otherwise.
template <typename TQ, typename TKV, int HD>
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
  constexpr int kPerLane = (HD + kWarp - 1) / kWarp;
  extern __shared__ float smem[];
  const int g = sh.H / sh.KVH;
  const int b = blockIdx.x;
  const int kh = blockIdx.z;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int c0 = blockIdx.y * sh.qb;
  const int pairs = g * sh.qb;  // (column, query head) pairs of this CTA

  float* ks = smem;
  float* vs = ks + kTile * (HD + 1);
  float* qs = vs + kTile * HD;
  int* tpage = reinterpret_cast<int*>(qs + nwarps * HD);
  float* tks = reinterpret_cast<float*>(tpage + kTile);  // int8 pages only
  float* tvs = tks + kTile;

  const int clen = cache_len[b];
  const int nl = new_lens == nullptr ? 1 : new_lens[b];
  const int n_pos = min(clen, sh.P * sh.ps);  // positions the lanes can hold
  // the last position any query of this CTA may see, plus one
  const int last_col = min(c0 + sh.qb, sh.S) - 1;
  const int t_end = min(n_pos, clen - sh.S + last_col + 1);
  const float scale = 1.0f / sqrtf(static_cast<float>(sh.hd));

  for (int p0 = 0; p0 < pairs; p0 += nwarps) {
    // this warp's (column, head) pair in this pass and its query's limit
    // (0: a padding column or no pair, no query)
    const int pair = p0 + warp;
    const int col = c0 + pair / g;
    const int head = kh * g + pair % g;
    const int q_pos = clen - sh.S + col;
    const bool mine = pair < pairs && col < sh.S;
    const bool real = mine && col >= sh.S - nl && q_pos >= 0;
    const int t_lim = real ? min(n_pos, q_pos + 1) : 0;

    const size_t q_row =
        ((size_t(b) * sh.S + (mine ? col : 0)) * sh.H + head) * sh.hd;
    for (int d = lane; d < HD; d += kWarp)
      qs[warp * HD + d] = real && d < sh.hd ? to_f32(q[q_row + d]) : 0.f;

    float m = -INFINITY;
    float l = 0.f;
    float acc[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;

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
      for (int i = threadIdx.x; i < kTile * HD; i += blockDim.x) {
        const int j = i / HD;
        const int d = i - j * HD;
        const int pg = tpage[j];
        if (pg >= 0) {
          float kx = 0.f, vx = 0.f;  // the padding past hd
          if (d < sh.hd) {
            const size_t off =
                ((size_t(pg) * sh.ps + (t0 + j) % sh.ps) * sh.KVH + kh) *
                    sh.hd + d;
            kx = to_f32(k_pages[off]);
            vx = to_f32(v_pages[off]);
            if constexpr (kQuant) {  // cast, then one multiply: repro's order
              kx *= tks[j];
              vx *= tvs[j];
            }
          }
          ks[j * (HD + 1) + d] = kx;
          vs[j * HD + d] = vx;
        }
      }
      __syncthreads();

      // lane j scores position t0 + j for this warp's query
      const bool valid = tpage[lane] >= 0 && t0 + lane < t_lim;
      float s = -INFINITY;
      if (valid) {
        const float* kr = ks + lane * (HD + 1);
        const float* qr = qs + warp * HD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float m_safe = isinf(m_new) ? 0.f : m_new;  // nothing valid yet
      const float p = valid ? expf(s - m_safe) : 0.f;
      const float corr = isinf(m) ? 0.f : expf(m - m_safe);
      l = l * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[i] *= corr;
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        if (pj == 0.f) continue;  // masked (or underflowed): adds nothing,
                                  // and its V row may never have been staged
        const float* vr = vs + j * HD;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int d = lane + i * kWarp;
          if (d < HD) acc[i] = fmaf(pj, vr[d], acc[i]);
        }
      }
      m = m_new;
      __syncthreads();
    }

    if (mine) {
      const float den = fmaxf(l, 1e-20f);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + i * kWarp;
        if (d < sh.hd) out[q_row + d] = from_f32<TQ>(acc[i] / den);
      }
    }
  }
}

// The operands of one call of either kernel.
struct Args {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int32_t *page_idx, *cache_len, *new_lens;
  void* out;
  float *part_acc, *part_ml;
};

template <typename TQ, typename TKV, int HD>
cudaError_t launch_chunk(const Args& a, const Shape& sh,
                         cudaStream_t stream) {
  const int pairs = (sh.H / sh.KVH) * sh.qb;
  const int warps = pairs < kMaxWarps ? pairs : kMaxWarps;
  const size_t smem =
      chunk_smem_bytes(HD, warps, std::is_same<TKV, int8_t>::value);
  auto kernel = paged_attn_kernel<TQ, TKV, HD>;
  // opt in once, for the most warps, before any launch is captured
  static const cudaError_t opted = opt_in(
      kernel, chunk_smem_bytes(HD, kMaxWarps,
                               std::is_same<TKV, int8_t>::value));
  if (opted != cudaSuccess) return opted;
  const dim3 grid(sh.B, (sh.S + sh.qb - 1) / sh.qb, sh.KVH);
  kernel<<<grid, warps * kWarp, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.k_scale, a.v_scale, a.page_idx,
      a.cache_len, a.new_lens, static_cast<TQ*>(a.out), sh);
  return cudaGetLastError();
}

// ===========================================================================
// K5/K7: decode with a KV split
// ===========================================================================

struct DecShape {
  int B, H, KVH, hd, ps, P, n_pages;
  int n_split, pps, groups;  // splits of pps page lanes; head groups of 4
  unsigned ps_mul;           // n / ps == (umulhi(n, ps_mul) + n) >> ps_shift
  int ps_shift;
};

// Multiply-shift constants of an unsigned division by d (d >= 1), exact for
// n < 2**31.
inline void fastdiv_magic(int d, unsigned* mul, int* shift) {
  int l = 0;
  while ((1u << l) < static_cast<unsigned>(d)) ++l;
  const uint64_t m =
      ((uint64_t(1) << 32) * ((uint64_t(1) << l) - uint64_t(d))) /
          uint64_t(d) + 1;
  *mul = static_cast<unsigned>(m);
  *shift = l;
}

__device__ __forceinline__ int fastdiv(int n, unsigned mul, int shift) {
  const unsigned u = static_cast<unsigned>(n);
  return static_cast<int>((__umulhi(u, mul) + u) >> shift);
}

// The decode kernel's tiling for one page type and width.  A row is
// kChunks 16-byte chunks of kElem elements, stored unpadded with its chunks
// XOR-swizzled by row (kSwzShift, kSwzMask), so that 8 lanes reading one
// chunk of 8 rows, or 8 chunks of one row, hit distinct banks.  In the V
// fold a lane owns kCPL chunks (kChunkLanes lanes per row) of the rows of
// its position group (kGroups groups of rows per tile).
template <typename TKV, int HD>
struct Dec {
  static constexpr int kElem = 16 / int(sizeof(TKV));
  static constexpr int kChunks = HD / kElem;
  static constexpr int kRowBytes = HD * int(sizeof(TKV));
  static constexpr int kSwzMask = kChunks >= 8 ? 7 : kChunks - 1;
  static constexpr int kSwzShift =
      kChunks >= 8 ? 0 : kChunks == 4 ? 1 : kChunks == 2 ? 2 : 3;
  static constexpr int kChunkLanes = kChunks < kWarp ? kChunks : kWarp;
  static constexpr int kGroups = kWarp / kChunkLanes;
  static constexpr int kCPL = kChunks / kChunkLanes;
  static constexpr int kAcc = kCPL * kElem;
  static_assert(HD % kElem == 0, "a row is whole 16-byte chunks");
  // byte offset of chunk c of row r of a stage (K rows, then V rows)
  static __device__ __forceinline__ int at(int r, int c) {
    return r * kRowBytes + ((c ^ ((r >> kSwzShift) & kSwzMask)) << 4);
  }
};

// 16 bytes of page elements -> floats, exactly.
template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ void run(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Cvt<int8_t> {
  // byte x (biased by 128) into the low mantissa of 2**23: the float
  // 2**23 + (x + 128), less 2**23 + 128, is x exactly
  static __device__ __forceinline__ void run(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        f[4 * i + k] =
            __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7440u | k)) -
            8388736.0f;
    }
  }
};

template <bool kQuant>
__device__ __forceinline__ float dequant(float x, float scale) {
  if constexpr (kQuant) return __fmul_rn(x, scale);  // cast, then multiply
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same 16 bytes element by element, the first n from src and the rest
// zero (pages not 16-byte aligned, or rows not a whole number of chunks).
template <typename TKV>
__device__ __forceinline__ void copy16(void* dst, const TKV* src, int n) {
  using T = std::conditional_t<sizeof(TKV) == 2, uint16_t, TKV>;
  T* d = static_cast<T*>(dst);
  const T* s = reinterpret_cast<const T*>(src);
#pragma unroll
  for (int e = 0; e < 16 / int(sizeof(TKV)); ++e) d[e] = e < n ? s[e] : T(0);
}

// The decode CTA's layout: PW x HW warps.  A CTA tile is PW x 32
// positions, staged for the whole CTA in a ring of kStages stages; warp
// (pw, hw) scores positions pw x 32 + lane of each tile for the HPW query
// heads hw x HPW, ..., and folds their V rows, so a row is converted (and
// dequantized) once for HPW heads.  The CTA serves HW x HPW query heads.
template <typename TKV, int HD, int PW, int HW, int HPW>
struct DecCfg {
  using D = Dec<TKV, HD>;
  static constexpr int kWarps = PW * HW;
  static constexpr int kThreads = kWarps * kWarp;
  static constexpr int kHeads = HW * HPW;
  static constexpr int kRows = PW * kTile;  // positions of a CTA tile
  static constexpr int kStageBytes = 2 * kRows * D::kRowBytes;
  static constexpr int kStages = 3 * kStageBytes <= 96 * 1024 ? 3 : 2;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kInfo = kStages + 1;  // tiles whose rows are known
  // everything but the split's page table and scales
  static constexpr size_t kSmem =
      kRing + size_t(kInfo) * kRows * (sizeof(long long) + 2 * sizeof(float)) +
      sizeof(float) * (kHeads * HD + kWarps * HPW * kTile);
};

// One CTA per (split, request, KV head x group of kHeads query heads).
// part_acc (B, H, n_split, hd) and part_ml (B, H, n_split, 2) float32 take
// the partials when n_split > 1; with one split the kernel writes `out`
// itself.
template <typename TQ, typename TKV, int HD, int PW, int HW, int HPW>
__global__ void __launch_bounds__(PW * HW * kWarp)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ page_idx,
                    const int32_t* __restrict__ cache_len,
                    TQ* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, DecShape sh, int vec) {
  using D = Dec<TKV, HD>;
  using C = DecCfg<TKV, HD, PW, HW, HPW>;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kQPer = (HD + kWarp - 1) / kWarp;
  constexpr int kPart = HPW == 1 ? 4 : HPW == 2 ? 2 : 1;  // partial dots
  constexpr int kAblate = BRAVO_DECODE_ABLATE;
  extern __shared__ __align__(16) unsigned char dsmem[];

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = blockIdx.z / sh.groups;
  const int g = sh.H / sh.KVH;
  const int h0 = kh * g + (blockIdx.z - kh * sh.groups) * C::kHeads;
  const int nh = min(C::kHeads, kh * g + g - h0);  // heads that exist
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int pwi = warp % PW;          // this warp's rows of a tile
  const int hb = (warp / PW) * HPW;   // and its first head of the CTA's

  unsigned char* ring = dsmem;
  // per row of the tiles in flight: its element offset in the pages (-1:
  // masked) and, for int8 pages, its K and V scales
  long long* roff = reinterpret_cast<long long*>(dsmem + C::kRing);
  float* rks = reinterpret_cast<float*>(roff + C::kInfo * C::kRows);
  float* rvs = rks + C::kInfo * C::kRows;
  float* qs = rvs + C::kInfo * C::kRows;
  float* pw = qs + C::kHeads * HD + warp * HPW * kTile;  // warp's weights
  int* spage =
      reinterpret_cast<int*>(qs + C::kHeads * HD + C::kWarps * HPW * kTile);
  float* sks = reinterpret_cast<float*>(spage + sh.pps);  // int8 pages only
  float* svs = sks + sh.pps;

  // the split's positions: [t_begin, t_stop)
  const int clen = cache_len[b];
  const int n_pos = min(clen, sh.P * sh.ps);
  const int lane0 = split * sh.pps;
  const int n_lanes = max(0, min(sh.pps, sh.P - lane0));
  const int t_begin = lane0 * sh.ps;
  const int t_stop = min(n_pos, t_begin + n_lanes * sh.ps);
  const int n_tiles =
      t_stop > t_begin ? (t_stop - t_begin + C::kRows - 1) / C::kRows : 0;

  // the CTA's queries (zero past hd), the split's pages (-1: masked) and
  // their scales
  for (int i = threadIdx.x; i < C::kHeads * HD; i += C::kThreads) {
    const int hh = i / HD;
    const int d = i % HD;
    qs[i] = hh < nh && d < sh.hd
                ? to_f32(q[(size_t(b) * sh.H + h0 + hh) * sh.hd + d])
                : 0.f;
  }
  for (int j = threadIdx.x; j < n_lanes; j += C::kThreads) {
    int pg = page_idx[size_t(b) * sh.P + lane0 + j];
    pg = pg < 0 || pg >= sh.n_pages ? -1 : pg;
    spage[j] = pg;
    if constexpr (kQuant) {
      sks[j] = pg >= 0 ? k_scale[size_t(pg) * sh.KVH + kh] : 0.f;
      svs[j] = pg >= 0 ? v_scale[size_t(pg) * sh.KVH + kh] : 0.f;
    }
  }
  __syncthreads();

  // a tile's rows, one thread each: offset and scales into the tile's slot
  auto rows = [&](int tile) {
    if (threadIdx.x >= C::kRows) return;
    const int r = threadIdx.x;
    const int j = tile * C::kRows + r;  // split-local position
    long long off = -1;
    float ks = 0.f, vs = 0.f;
    if (tile < n_tiles && t_begin + j < t_stop) {
      const int ln = fastdiv(j, sh.ps_mul, sh.ps_shift);
      const int pg = spage[ln];
      if (pg >= 0) {
        off = ((static_cast<long long>(pg) * sh.ps + (j - ln * sh.ps)) *
                   sh.KVH + kh) * sh.hd;
        if constexpr (kQuant) {
          ks = sks[ln];
          vs = svs[ln];
        }
      }
    }
    const int at = (tile % C::kInfo) * C::kRows + r;
    roff[at] = off;
    rks[at] = ks;
    rvs[at] = vs;
  };

  // tile -> its ring stage in 16-byte chunks, consecutive threads along a
  // row, K rows then V rows; a masked row, and the padding past hd, is
  // zero-filled, not read
  auto issue = [&](int tile) {
    if (tile >= n_tiles || kAblate == 2) return;
    unsigned char* st = ring + (tile % C::kStages) * C::kStageBytes;
    const long long* off = roff + (tile % C::kInfo) * C::kRows;
    constexpr int kTotal = 2 * C::kRows * D::kChunks;
#pragma unroll 4
    for (int i0 = 0; i0 < kTotal; i0 += C::kThreads) {
      const int i = i0 + threadIdx.x;
      if (kTotal % C::kThreads != 0 && i >= kTotal) break;
      const int kv = i / (C::kRows * D::kChunks);
      const int r = (i / D::kChunks) % C::kRows;
      const int c = i % D::kChunks;
      const long long o = off[r];
      const int n = o < 0 ? 0 : min(D::kElem, max(0, sh.hd - c * D::kElem));
      const TKV* src = (kv ? v_pages : k_pages) + (n ? o + c * D::kElem : 0);
      unsigned char* dst = st + D::at(kv * C::kRows + r, c);
      if (vec)  // n is 0 or the whole chunk
        cp_async16(dst, src, n > 0);
      else
        copy16<TKV>(dst, src, n);
    }
  };

#pragma unroll
  for (int t = 0; t < C::kStages; ++t) rows(t);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < C::kStages - 1; ++t) {
    issue(t);
    cp_async_commit();
  }

  // this lane's share of the V fold: chunk lane and position group
  const int c_lane = lane % D::kChunkLanes;
  const int r_lane = lane / D::kChunkLanes;
  const float sqrt_hd = sqrtf(static_cast<float>(sh.hd));
  float m[HPW], l[HPW];  // l: this lane's share of the denominator
  float acc[HPW][D::kAcc];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int a = 0; a < D::kAcc; ++a) acc[h][a] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // the tile landed; the stage to refill is free
    issue(tile + C::kStages - 1);
    cp_async_commit();
    rows(tile + C::kStages);
    if constexpr (kAblate == 1) continue;
    const unsigned char* st = ring + (tile % C::kStages) * C::kStageBytes;
    const int info = (tile % C::kInfo) * C::kRows;
    const int row0 = pwi * kTile;  // this warp's rows of the tile

    // lane j scores row row0 + j for each of the warp's heads
    const bool valid = roff[info + row0 + lane] >= 0;
    float s[HPW];
#pragma unroll
    for (int h = 0; h < HPW; ++h) s[h] = -INFINITY;
    if (valid) {
      const float ksc = rks[info + row0 + lane];
      float dot[HPW][kPart];
#pragma unroll
      for (int h = 0; h < HPW; ++h)
#pragma unroll
        for (int e = 0; e < kPart; ++e) dot[h][e] = 0.f;
#pragma unroll
      for (int c = 0; c < D::kChunks; ++c) {
        float kf[D::kElem];
        Cvt<TKV>::run(
            *reinterpret_cast<const uint4*>(st + D::at(row0 + lane, c)), kf);
#pragma unroll
        for (int e = 0; e < D::kElem; ++e) kf[e] = dequant<kQuant>(kf[e], ksc);
#pragma unroll
        for (int h = 0; h < HPW; ++h)
#pragma unroll
          for (int e = 0; e < D::kElem; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(
                qs + (hb + h) * HD + c * D::kElem + e);
            float& d0 = dot[h][e % kPart];
            float& d1 = dot[h][(e + 1) % kPart];
            float& d2 = dot[h][(e + 2) % kPart];
            float& d3 = dot[h][(e + 3) % kPart];
            d0 = fmaf(qq.x, kf[e], d0);
            d1 = fmaf(qq.y, kf[e + 1], d1);
            d2 = fmaf(qq.z, kf[e + 2], d2);
            d3 = fmaf(qq.w, kf[e + 3], d3);
          }
      }
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        float t = dot[h][0];
#pragma unroll
        for (int e = 1; e < kPart; ++e) t += dot[h][e];
        s[h] = __fdiv_rn(t, sqrt_hd);
      }
    }
    float corr[HPW];
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      const float m_new = fmaxf(m[h], warp_max(s[h]));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;  // none valid
      const float p = valid ? expf(s[h] - m_safe) : 0.f;
      corr[h] = m[h] == -INFINITY ? 0.f : expf(m[h] - m_safe);
      l[h] = l[h] * corr[h] + p;
      m[h] = m_new;
      pw[h * kTile + lane] = p;
    }
    __syncwarp();

    // the V fold: this lane's chunks of the rows of its position group,
    // each converted once for the warp's heads
#pragma unroll
    for (int h = 0; h < HPW; ++h)
#pragma unroll
      for (int a = 0; a < D::kAcc; ++a) acc[h][a] *= corr[h];
#pragma unroll 4
    for (int kk = 0; kk < kTile / D::kGroups; ++kk) {
      const int r = r_lane + kk * D::kGroups;
      float pr[HPW];
#pragma unroll
      for (int h = 0; h < HPW; ++h) pr[h] = pw[h * kTile + r];
      const float vsc = rvs[info + row0 + r];
#pragma unroll
      for (int cc = 0; cc < D::kCPL; ++cc) {
        float vf[D::kElem];
        Cvt<TKV>::run(*reinterpret_cast<const uint4*>(
                          st + D::at(C::kRows + row0 + r,
                                     c_lane + cc * D::kChunkLanes)),
                      vf);
#pragma unroll
        for (int e = 0; e < D::kElem; ++e) {
          const float v = dequant<kQuant>(vf[e], vsc);
#pragma unroll
          for (int h = 0; h < HPW; ++h)
            acc[h][cc * D::kElem + e] =
                fmaf(pr[h], v, acc[h][cc * D::kElem + e]);
        }
      }
    }
    __syncwarp();  // the weights are read before the next tile's
  }
  cp_async_wait<0>();

  // fold the position groups' accumulators and the lanes' denominators
#pragma unroll
  for (int o = D::kChunkLanes; o < kWarp; o <<= 1)
#pragma unroll
    for (int h = 0; h < HPW; ++h)
#pragma unroll
      for (int a = 0; a < D::kAcc; ++a)
        acc[h][a] += __shfl_xor_sync(kFull, acc[h][a], o);
#pragma unroll
  for (int h = 0; h < HPW; ++h) l[h] = warp_sum(l[h]);

  // merge, per head, the states of the PW warps that share it, through the
  // ring's memory
  __syncthreads();
  constexpr int kRow = HD + 2;  // acc, m, l
  float* mg = reinterpret_cast<float*>(dsmem);
  if (lane < D::kChunkLanes) {
#pragma unroll
    for (int h = 0; h < HPW; ++h)
#pragma unroll
      for (int cc = 0; cc < D::kCPL; ++cc)
#pragma unroll
        for (int e = 0; e < D::kElem; ++e)
          mg[(warp * HPW + h) * kRow +
             (c_lane + cc * D::kChunkLanes) * D::kElem + e] =
              acc[h][cc * D::kElem + e];
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      mg[(warp * HPW + h) * kRow + HD] = m[h];
      mg[(warp * HPW + h) * kRow + HD + 1] = l[h];
    }
  }
  __syncthreads();
  for (int hc = warp; hc < nh; hc += C::kWarps) {  // one warp per head
    // the warps (hc / HPW) * PW + p, p < PW, hold head hc as their
    // (hc % HPW)-th
    const float* st0 = mg + ((hc / HPW) * PW * HPW + hc % HPW) * kRow;
    float mx = -INFINITY;
#pragma unroll
    for (int p = 0; p < PW; ++p) mx = fmaxf(mx, st0[p * HPW * kRow + HD]);
    float wt[PW];
    float den = 0.f;
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      const float mp = st0[p * HPW * kRow + HD];
      wt[p] = mp == -INFINITY ? 0.f : expf(mp - mx);
      den = fmaf(wt[p], st0[p * HPW * kRow + HD + 1], den);
    }
    const size_t row = size_t(b) * sh.H + h0 + hc;
    const size_t part = row * sh.n_split + split;
#pragma unroll
    for (int i = 0; i < kQPer; ++i) {
      const int d = lane + i * kWarp;
      if (d >= sh.hd) continue;
      float a = 0.f;
#pragma unroll
      for (int p = 0; p < PW; ++p)
        a = fmaf(wt[p], st0[p * HPW * kRow + d], a);
      if (sh.n_split == 1)
        out[row * sh.hd + d] = from_f32<TQ>(a / fmaxf(den, 1e-20f));
      else
        part_acc[part * sh.hd + d] = a;
    }
    if (sh.n_split > 1 && lane == 0) {
      part_ml[2 * part] = mx;
      part_ml[2 * part + 1] = den;
    }
  }
}

// The second pass: one warp per (request, query head) merges the splits'
// (m, l, acc).  A split with m = -inf adds nothing, and a row whose splits
// all have it writes exact zeros; -inf - (-inf) is never formed.
template <typename TQ, int HD>
__global__ void __launch_bounds__(kWarp)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, TQ* __restrict__ out,
                      int n_split, int hd) {
  constexpr int kPer = (HD + kWarp - 1) / kWarp;
  const size_t row = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ml = part_ml + row * n_split * 2;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  float den = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      const float ms = ml[2 * s];
      if (ms == -INFINITY) continue;
      const float w = expf(ms - mx);
      den = fmaf(w, ml[2 * s + 1], den);
      const float* pa = part_acc + (row * n_split + s) * hd;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = lane + i * kWarp;
        if (d < hd) acc[i] = fmaf(w, pa[d], acc[i]);
      }
    }
  }
  den = fmaxf(den, 1e-20f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + i * kWarp;
    if (d < hd) out[row * hd + d] = from_f32<TQ>(acc[i] / den);
  }
}

// The decode kernel for one q type, page type, width and warp layout.
template <typename TQ, typename TKV, int HD, int PW, int HW, int HPW>
struct Decode {
  using C = DecCfg<TKV, HD, PW, HW, HPW>;

  static size_t smem(int pps) {
    constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
    return C::kSmem + sizeof(int) * pps +
           (kQuant ? 2 * sizeof(float) * pps : 0);
  }

  // opt in once, for the largest split, before any launch is captured
  static cudaError_t ready() {
    static const cudaError_t opted =
        opt_in(paged_decode_kernel<TQ, TKV, HD, PW, HW, HPW>,
               smem(kMaxSplitPages));
    return opted;
  }

  // CTAs of this kernel with splits of pps lanes that one SM holds
  static cudaError_t resident(int pps, int* n) {
    const cudaError_t err = ready();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, paged_decode_kernel<TQ, TKV, HD, PW, HW, HPW>, C::kThreads,
        smem(pps));
  }

  static cudaError_t launch(const Args& a, const DecShape& sh,
                            cudaStream_t stream) {
    cudaError_t err = ready();
    if (err != cudaSuccess) return err;
    // 16-byte copies need 16-byte aligned bases and rows of whole chunks
    const int vec = ((reinterpret_cast<uintptr_t>(a.k) |
                      reinterpret_cast<uintptr_t>(a.v)) % 16) == 0 &&
                    (sh.hd * sizeof(TKV)) % 16 == 0;
    const dim3 grid(sh.n_split, sh.B, sh.KVH * sh.groups);
    paged_decode_kernel<TQ, TKV, HD, PW, HW, HPW>
        <<<grid, C::kThreads, smem(sh.pps), stream>>>(
            static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
            static_cast<const TKV*>(a.v), a.k_scale, a.v_scale, a.page_idx,
            a.cache_len, static_cast<TQ*>(a.out), a.part_acc, a.part_ml, sh,
            vec);
    err = cudaGetLastError();
    if (err != cudaSuccess || sh.n_split == 1) return err;
    decode_combine_kernel<TQ, HD><<<sh.B * sh.H, kWarp, 0, stream>>>(
        a.part_acc, a.part_ml, static_cast<TQ*>(a.out), sh.n_split, sh.hd);
    return cudaGetLastError();
  }
};

// ===========================================================================
// Dispatch over q type, page type, width and warp layout
// ===========================================================================

// The page store's element type, as the entry points name it.
enum KvType { kKvF32 = 0, kKvBf16 = 1, kKvInt8 = 2 };

template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Width = std::integral_constant<int, N>;

// Calls f(Type<TQ>, Type<TKV>, Width<HD>) for a call's q type, page type and
// the smallest instantiated width that holds its hd.
template <typename F>
cudaError_t with_types(int q_bf16, int kv, int hd, F&& f) {
  if (hd <= 0 || hd > kMaxHd) return cudaErrorInvalidValue;
  auto by_hd = [&](auto tq, auto tkv) -> cudaError_t {
    if (hd <= 16) return f(tq, tkv, Width<16>{});
    if (hd <= 32) return f(tq, tkv, Width<32>{});
    if (hd <= 64) return f(tq, tkv, Width<64>{});
    if (hd <= 128) return f(tq, tkv, Width<128>{});
    return f(tq, tkv, Width<256>{});
  };
  auto by_kv = [&](auto tq) -> cudaError_t {
    switch (kv) {
      case kKvBf16: return by_hd(tq, Type<__nv_bfloat16>{});
      case kKvInt8: return by_hd(tq, Type<int8_t>{});
      default: return by_hd(tq, Type<float>{});
    }
  };
  if (q_bf16) return by_kv(Type<__nv_bfloat16>{});
  return by_kv(Type<float>{});
}

// The decode kernel's warp layout for a shape: calls f(Decode<...>{}).  Two
// warps of 32 rows a tile (one when rows are 512 bytes or more, to fit the
// ring), four query heads a CTA on four warps: the heads' scores and folds
// run side by side, the shortest chain for a decode tick.  For int8 pages
// whose lanes hold kLongRows positions or more, four warps of 32 rows and
// all four heads a warp: each int8 row is converted and dequantized once
// for the four heads (int8 conversion is 3 operations an element, bf16's
// 1).  The host cannot see the rows' lengths without a sync, so the choice
// goes by the lanes' capacity.  kLongRows from the timing sweep
// (decode_sweep, NVIDIA H100 80GB HBM3, 8 and 16 requests): one head a
// warp is faster at capacities of 128 and 256 positions (5.7 against 6.9
// us at the engine's tick, 8.4 against 9.7), split at 512 (10.6 against
// 11.9 us with 8 full rows, 14.0 against 13.3 with 16); all heads a warp
// is faster or level from 1024 on (14.0 against 14.5 us with 8 full rows,
// 19.7 against 22.7 with 16; rows of ~100 on 1024 and 4096 positions of
// lanes: 9.6 against 9.5 with 8, 11.1 against 14.0 with 16).
constexpr int kLongRows = BRAVO_LONG_ROWS;

template <typename F>
cudaError_t with_decode(int q_bf16, int kv, int hd, const DecShape& sh,
                        F&& f) {
  return with_types(q_bf16, kv, hd, [&](auto tq, auto tkv, auto w) {
    using TQ = typename decltype(tq)::type;
    using TKV = typename decltype(tkv)::type;
    constexpr int HD = decltype(w)::value;
    constexpr int kPW = HD * int(sizeof(TKV)) >= 512 ? 1 : 2;
    if constexpr (std::is_same<TKV, int8_t>::value) {
      if (sh.P * sh.ps >= kLongRows)
        return f(Decode<TQ, TKV, HD, 4, 1, kDecHeads>{});
    }
    return f(Decode<TQ, TKV, HD, kPW, kDecHeads, 1>{});
  });
}

// The decode shape of a call (B, H, KVH, hd, ps, P, n_pages, n_split
// splits of pps lanes), or false if it is not one the kernel runs.
bool decode_shape(int B, int H, int KVH, int hd, int ps, int P, int n_pages,
                  int n_split, int pps, DecShape* sh) {
  if (KVH <= 0 || H % KVH != 0 || hd <= 0 || hd > kMaxHd || ps <= 0 ||
      P < 0 || n_split <= 0 || pps < 0 || pps > kMaxSplitPages ||
      size_t(n_split) * pps < size_t(P))
    return false;
  *sh = DecShape{B, H, KVH, hd, ps, P, n_pages, n_split, pps,
                 (H / KVH + kDecHeads - 1) / kDecHeads, 0u, 0};
  fastdiv_magic(ps, &sh->ps_mul, &sh->ps_shift);
  return true;
}

int decode(const Args& a, int B, int H, int KVH, int hd, int ps, int P,
           int n_pages, int n_split, int pps, int q_bf16, int kv,
           void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  DecShape sh;
  if (!decode_shape(B, H, KVH, hd, ps, P, n_pages, n_split, pps, &sh) ||
      (n_split > 1 && (a.part_acc == nullptr || a.part_ml == nullptr)) ||
      (kv == kKvInt8 && (a.k_scale == nullptr || a.v_scale == nullptr)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_decode(
      q_bf16, kv, hd, sh, [&](auto k) { return k.launch(a, sh, st); }));
}

int chunk(const Args& a, int B, int S, int H, int KVH, int hd, int ps, int P,
          int n_pages, int qb, int q_bf16, int kv, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH != 0 || ps <= 0 || qb <= 0 ||
      (kv == kKvInt8 && (a.k_scale == nullptr || a.v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const Shape sh{B, S, H, KVH, hd, ps, P, n_pages, qb};
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      with_types(q_bf16, kv, hd, [&](auto tq, auto tkv, auto w) {
        return launch_chunk<typename decltype(tq)::type,
                            typename decltype(tkv)::type,
                            decltype(w)::value>(a, sh, st);
      }));
}

}  // namespace

extern "C" {

// K5: q (B, H, hd); k/v pages (n_pages, ps, KVH, hd); page_idx (B, P) int32;
// cache_len (B,) int32; out (B, H, hd); n_split splits of pps page lanes,
// whose partials go to part_acc (B, H, n_split, hd) and part_ml (B, H,
// n_split, 2) float32 when n_split > 1 (null otherwise).  All contiguous.
int bravo_paged_attn(const void* q, const void* k_pages, const void* v_pages,
                     const int32_t* page_idx, const int32_t* cache_len,
                     void* out, void* part_acc, void* part_ml, int B, int H,
                     int KVH, int hd, int ps, int P, int n_pages, int n_split,
                     int pps, int q_bf16, int kv_bf16, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, page_idx, cache_len,
               nullptr, out, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml)};
  return decode(a, B, H, KVH, hd, ps, P, n_pages, n_split, pps, q_bf16,
                kv_bf16 ? kKvBf16 : kKvF32, stream);
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
  const Args a{q, k_pages, v_pages, nullptr, nullptr, page_idx, cache_len,
               new_lens, out, nullptr, nullptr};
  return chunk(a, B, S, H, KVH, hd, ps, P, n_pages, qb, q_bf16,
               kv_bf16 ? kKvBf16 : kKvF32, stream);
}

// K7: K5 over int8 k/v pages (n_pages, ps, KVH, hd) with float32 k/v_scale
// (n_pages, KVH).
int bravo_paged_attn_quant(const void* q, const void* k_pages,
                           const void* v_pages, const float* k_scale,
                           const float* v_scale, const int32_t* page_idx,
                           const int32_t* cache_len, void* out,
                           void* part_acc, void* part_ml, int B, int H,
                           int KVH, int hd, int ps, int P, int n_pages,
                           int n_split, int pps, int q_bf16, void* stream) {
  const Args a{q, k_pages, v_pages, k_scale, v_scale, page_idx, cache_len,
               nullptr, out, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml)};
  return decode(a, B, H, KVH, hd, ps, P, n_pages, n_split, pps, q_bf16,
                kKvInt8, stream);
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
  const Args a{q, k_pages, v_pages, k_scale, v_scale, page_idx, cache_len,
               new_lens, out, nullptr, nullptr};
  return chunk(a, B, S, H, KVH, hd, ps, P, n_pages, qb, q_bf16, kKvInt8,
               stream);
}

// Resident CTAs an SM holds of the decode kernel (K5 for kv 0/1, K7 for
// kv 2) for this head shape, P page lanes of ps positions and pps lanes a
// split, written to *resident; launches nothing.  The wrappers size the KV
// split with it.
int bravo_paged_attn_residency(int q_bf16, int kv, int H, int KVH, int hd,
                               int ps, int P, int pps, int* resident) {
  DecShape sh;
  const int n_split = pps > 0 ? (P + pps - 1) / pps : 1;
  if (!decode_shape(1, H, KVH, hd, ps, P, 0, n_split, pps, &sh) ||
      resident == nullptr)
    return cudaErrorInvalidValue;
  return static_cast<int>(with_decode(
      q_bf16, kv, hd, sh, [&](auto k) { return k.resident(pps, resident); }));
}

const char* bravo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
