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
// What bounds the decode kernel on this card: bytes.  A decode step reads
// each valid K/V row once per KV head, 2 * hd elements, and does about
// 4 * g * hd flops per row, far below the ~295 flops per byte where the
// tensor cores would start to matter (the chunk kernel's case is below).
// Both kernels read each K/V row from device memory once per CTA and share
// it among the CTA's warps (the query heads, and for the chunk kernel the
// columns, of one KV head) through shared memory.  The decode kernel's
// scores use expf (not __expf); sums run in another order than the Pallas
// kernels', so results agree to float32 rounding, not bit for bit.  Types:
// q in {float32, bfloat16}, pages in {bfloat16, float32, int8 with
// scales}; float32 arithmetic (the chunk kernel's products on the tensor
// cores, split so that they give the float32 result); the output has q's
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
// K6/K8, the chunk kernel (chunk_attn_kernel).  A chunk is a matrix
// product: for each KV head, (columns x g) query rows against every K/V
// row, about 128 flops a bf16 K/V byte at a 32-column chunk, far above the
// 20 flops a byte where float32 arithmetic outside the tensor cores meets
// the memory rate.  So at long prefixes the bound is the tensor cores' (or
// the bytes'), and the design serves both:
// 1. Query tile = a block of (column, query head) pairs of one KV head,
//    pair = column * g + head, 16 pairs a warp (one m16 tile): 64 pairs on
//    4 warps, or at hd 64 128 pairs on 8 warps (two warpgroups) and, for
//    grids that would leave SMs idle, 16 pairs on 4 warps that split each
//    tile's positions (ChunkTile).  Each staged K/V tile serves every
//    column and head of the block once, and any g runs without a special
//    case.
// 2. A KV split over the grid, as in the decode kernel: one CTA per
//    (split, request, KV head, pair block), the split count from host
//    facts alone (lanes, page size, the grid of one split, the SM count
//    and the occupancy calculator), never from cache_len, so a call stays
//    free of host syncs.  A split wholly past its pair block's last
//    visible position writes an empty partial without touching K/V (the
//    causal walk stops there); the combine kernel merges the partials as
//    it does the decode kernel's, over (request, column, head) rows.
// 3. 16-byte cp.async.cg copies in the page's own type into a 2-stage
//    ring, with each row's page offset (and int8 scales) worked out a tile
//    ahead with the multiply-shift division; the same swizzled rows and
//    the same synchronous in-kernel copy for unaligned pages or rows of no
//    whole 16-byte chunks as the decode kernel.  int8 and float32 tiles
//    are turned into bf16 pieces in shared memory after they land (int8
//    exactly; float32 as three pieces, below); bf16 tiles are read where
//    they landed.  Fragments are read with ldmatrix (V transposed).
// 4. Tensor cores with the result of float32 arithmetic.  A float32 x is
//    hi + mid + lo exactly, three bf16 pieces (hi = x with its low 16 bits
//    cleared, mid likewise of x - hi, lo = x - hi - mid: 24 significand
//    bits in three pieces of at most 8), and the product of two bf16
//    values is exact in float32.  So q (float32) is split into three
//    pieces, P (in [0, 1]) too, and mma.sync.m16n8k16 with float32
//    accumulation sums piece x piece products: q.K and P.V to float32
//    rounding.  bf16 and int8 K/V are exact in bf16 (one piece); float32
//    pages are split into three pieces as well, and only the products of
//    order <= 2 (hi x hi, hi x mid, mid x hi, ...) are summed, the rest
//    lying below float32 rounding.  bf16 q is one piece, and so is its P
//    (rounded to nearest): its output is bf16.  int8 pages: the K scale
//    multiplies each position's score, the V scale is folded into P
//    before P is split.  The softmax runs in float32 registers on the
//    accumulator fragments (online, per pair row), each exponential one
//    FMA and ex2.approx (s log2 e - m log2 e: the rounding of m log2 e is
//    the same for a row's numerator and denominator); a tile that every
//    pair of a warp sees whole skips the masks.  The mma.sync products are
//    plain asm, so the compiler interleaves the independent accumulators;
//    each piece's products go over all of a tile's n-tiles in turn.
//
// 5. At hd 64 with 128 pairs a CTA (the serving width's long chunks) the
//    products are Hopper's warpgroup products (wgmma, m64n64k16): q's
//    pieces and the K/V tiles are read from shared memory through
//    descriptors (their rows already lie in the 128-byte swizzle), P's
//    pieces from registers; the other widths and layouts use mma.sync.
//
// Build-time switches for the timing sweep (repro_torch/benchmarks/
// chunk_sweep.py), both at their defaults in the wrappers' build:
// BRAVO_CHUNK_ABLATE=1 (copies only) or 2 (arithmetic only) switches off
// half of the chunk kernel's work; BRAVO_CHUNK_WGMMA=0 runs hd 64 on
// mma.sync too.
//
// The parent chunk design (paged_attn_kernel: one CTA per (request, block
// of columns, KV head), one element a thread staged as float32, SIMT
// arithmetic, no split) stays buildable for timing: built with
// BRAVO_CHUNK_PARENT=1 the chunk entry points run it instead (and the new
// kernel is not compiled); the wrappers' build never reaches it.

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
#ifndef BRAVO_CHUNK_PARENT  // 1: the chunk entry points run the parent design
#define BRAVO_CHUNK_PARENT 0
#endif
#ifndef BRAVO_CHUNK_ABLATE  // 0: the kernel; 1: copies only; 2: arithmetic
#define BRAVO_CHUNK_ABLATE 0
#endif
#ifndef BRAVO_CHUNK_WGMMA  // 1: hd 64 at 64 pairs a CTA on wgmma
#define BRAVO_CHUNK_WGMMA 1
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
// K6/K8, the parent design (built only with BRAVO_CHUNK_PARENT=1)
// ===========================================================================

struct Shape {
  int B, S, H, KVH, hd, ps, P, n_pages, qb;
};

// One CTA per (request, block of qb query columns, KV head); its warps loop
// over the (column, query head) pairs of the block, at most 16 warps.  The
// CTA walks tiles of 32 positions: it loads the tile's page indices (and,
// for int8 pages, the page's K and V scale), stages the valid K/V rows in
// shared memory as float32, and each warp scores the 32 positions (lane j
// takes position j), updates its online softmax and folds the tile's V
// rows into its float32 accumulator.  The walk stops at the last position
// any of the CTA's queries can see.
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

// The second pass of both kernels: one warp per output row (request and
// query head for the decode kernel; request, column and query head for the
// chunk kernel) merges the splits' (m, l, acc), stored row after row.  A
// split with m = -inf adds nothing, and a row whose splits all have it
// writes exact zeros; -inf - (-inf) is never formed.
template <typename TQ, int HD>
__global__ void __launch_bounds__(kWarp)
combine_kernel(const float* __restrict__ part_acc,
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
    combine_kernel<TQ, HD><<<sh.B * sh.H, kWarp, 0, stream>>>(
        a.part_acc, a.part_ml, static_cast<TQ*>(a.out), sh.n_split, sh.hd);
    return cudaGetLastError();
  }
};

// ===========================================================================
// K6/K8: chunk prefill on the tensor cores, with a KV split
// ===========================================================================

constexpr size_t kMaxChunkSmem = 227 * 1024;

struct ChunkShape {
  int B, S, H, KVH, hd, ps, P, n_pages;
  int n_split, pps, blocks;  // splits of pps page lanes; pair blocks a KV head
  unsigned ps_mul;           // the division by ps, as in DecShape
  int ps_shift;
};

// The chunk kernel's tiling for one q type, page type, width, KT positions
// a tile, WT warps along a tile's positions and NW warps a CTA.  The CTA's
// warps take NW / WT slices of 16 pairs (kPairs pairs a CTA) and, in each
// tile, WT runs of KT / WT positions.  The layouts: 64 pairs on 4 warps
// (WT = 1, each warp all of a tile); at hd 64, 128 pairs on 8 warps (two
// warpgroups sharing each staged tile, which halves the K/V a chunk
// stages, and each hiding the other's softmax), and, for grids that leave
// SMs idle such as the engine's prefill tick, 16 pairs on 4 warps (WT =
// 4, each warp a quarter of each tile, the four merged at the end), so
// that a tile's products spread over the SM's four schedulers.  The ring
// holds kStages stages of K then V rows in the page's type (Dec<TKV, HD>'s
// swizzled rows); int8 and float32 tiles are turned into kKP bf16 pieces
// (K then V rows of each piece, Dec<bf16, HD> rows) in `prep`; the CTA's
// queries are kQP bf16 pieces of kPairs rows.
template <typename TQ, typename TKV, int HD, int KT, int WT, int NW>
struct ChunkTile {
  using St = Dec<TKV, HD>;
  using Cm = Dec<__nv_bfloat16, HD>;
  static constexpr int kQP = std::is_same<TQ, float>::value ? 3 : 1;  // P too
  static constexpr int kKP = std::is_same<TKV, float>::value ? 3 : 1;
  static constexpr bool kPrep = !std::is_same<TKV, __nv_bfloat16>::value;
  static constexpr int kWarps = NW;
  static constexpr int kThreads = NW * kWarp;
  // two 8-warp CTAs an SM (at most 128 registers a thread) where shared
  // memory holds two: the int8 build would otherwise take more registers
  // and hold one
  static constexpr int kMinBlocks =
      NW == 8 && !std::is_same<TKV, float>::value ? 2 : 1;
  static constexpr int kSlices = NW / WT;
  static constexpr int kPairs = 16 * kSlices;
  static constexpr int KW = KT / WT;  // positions of a tile a warp takes
  // WT = 4 serves short grids of short rows: a third stage keeps a
  // second tile's copies in flight with the first's
  static constexpr int kStages = WT > 1 ? 3 : 2;
  static constexpr bool kWg = BRAVO_CHUNK_WGMMA && HD == 64 && WT == 1;
  static constexpr size_t kAlign = kWg ? 1024 : 0;  // the base's rounding
  static constexpr int kInfo = kStages + 1;  // tiles whose rows are known
  static constexpr size_t kStage = size_t(2) * KT * St::kRowBytes;
  static constexpr size_t kBlock = size_t(KT) * Cm::kRowBytes;  // K or V
  static constexpr size_t kPrepBytes = kPrep ? 2 * kKP * kBlock : 0;
  static constexpr size_t kQBlock = size_t(kPairs) * Cm::kRowBytes;
  static constexpr size_t kSmem =
      kAlign + kStages * kStage + kPrepBytes + kQP * kQBlock +
      size_t(kInfo) * KT * (sizeof(long long) + 2 * sizeof(float)) +
      size_t(kInfo) * 2 * sizeof(int);
  // the warps' states, merged and written through the ring, `prep` and
  // the queries' memory
  static constexpr size_t kMerge =
      sizeof(float) * NW * 16 * (HD + 2);
  static_assert(KT % 16 == 0 && KT <= kThreads, "tile of positions");
  static_assert(KW % 16 == 0, "a warp's run of positions: whole k-steps");
  static_assert(kMerge <= kStages * kStage + kPrepBytes + kQP * kQBlock,
                "merge fits");
};

// Positions a tile: 64 up to hd 64 (32 score registers a thread), else 32,
// or 16 where 32 would not fit in shared memory (float32 pages at hd 256).
template <typename TQ, typename TKV, int HD>
constexpr int chunk_rows() {
  return HD <= 64 ? 64
         : ChunkTile<TQ, TKV, HD, 32, 1, 4>::kSmem <= kMaxChunkSmem ? 32 : 16;
}

// x[0..7] -> N bf16 pieces, w[p][i] holding elements 2i (low half) and
// 2i + 1 of piece p.  N = 1 rounds to nearest even (exact for values that
// are bf16 already: bf16 q, int8 values); N = 3 cuts: each piece is what
// is left with its low 16 bits cleared (bf16 truncation), and the rest,
// exact in float32, goes on to the next piece; after three the rest is 0
// for any normal float32 (24 significand bits, at most 8 a piece), so the
// pieces sum to x exactly.
template <int N>
__device__ __forceinline__ void split_pack(const float* x, uint32_t (*w)[4]) {
  if constexpr (N == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[0][i] = *reinterpret_cast<const uint32_t*>(&v);
    }
  } else {
    float r[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = x[e];
#pragma unroll
    for (int p = 0; p < N; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned u0 = __float_as_uint(r[2 * i]) & 0xffff0000u;
        const unsigned u1 = __float_as_uint(r[2 * i + 1]) & 0xffff0000u;
        w[p][i] = __byte_perm(u0, u1, 0x7632);  // the two high halves
        r[2 * i] -= __uint_as_float(u0);
        r[2 * i + 1] -= __uint_as_float(u1);
      }
  }
}

// The pieces of x[0..7] into N rows of pieces, stride bytes apart.
template <int N>
__device__ __forceinline__ void put_pieces(unsigned char* base, size_t stride,
                                           int at, const float* x) {
  uint32_t w[N][4];
  split_pack<N>(x, w);
#pragma unroll
  for (int p = 0; p < N; ++p)
    *reinterpret_cast<uint4*>(base + p * stride + at) =
        make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
}

// Fragment loads read shared memory that other threads wrote, so they stay
// volatile (in program order with the barriers); the products are plain
// register arithmetic, which the compiler may interleave.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) x b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Hopper's warpgroup products (wgmma) for the chunk kernel at hd 64 with
// 128 pairs a CTA: each 4 warps of the CTA are one warpgroup and its 64
// pair rows one M tile.  B (K, or V transposed) is read from shared
// memory through a descriptor: rows of 128 bytes (64 bf16) in the
// 128-byte swizzle, which is
// exactly Dec<bf16, 64>'s layout (chunk c of row r at c ^ (r % 8)) on a
// 1024-byte aligned base; A is q (shared memory, the same layout) or P
// (registers, the mma.sync fragment layout of each warp's 16 rows).  The
// accumulators are the mma.sync fragments of 8 n-tiles.

// descriptor of a 128-byte-swizzled tile of 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return uint64_t((a & 0x3ffff) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void wg_hold(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, float32) += A (64 x 16, shared memory, K-major) x B (16 x 64,
// shared memory, K-major)
__device__ __forceinline__ void wg_ss(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, float32) += A (64 x 16, registers) x B (16 x 64, shared
// memory, MN-major: rows of the 16 along K, 64 contiguous along N)
__device__ __forceinline__ void wg_rs_t(float* d, const uint32_t* a,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2**x (max relative error 2**-22; -inf gives +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One CTA per (split, request, KV head x pair block).  part_acc (B, S, H,
// n_split, hd) and part_ml (B, S, H, n_split, 2) float32 take the partials
// when n_split > 1; with one split the kernel writes `out` itself.
template <typename TQ, typename TKV, int HD, int KT, int WT, int NW>
__global__ void __launch_bounds__(
    NW * kWarp, ChunkTile<TQ, TKV, HD, KT, WT, NW>::kMinBlocks)
chunk_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                  const TKV* __restrict__ v_pages,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int32_t* __restrict__ page_idx,
                  const int32_t* __restrict__ cache_len,
                  const int32_t* __restrict__ new_lens, TQ* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  ChunkShape sh, int vec) {
  using T = ChunkTile<TQ, TKV, HD, KT, WT, NW>;
  using St = typename T::St;
  using Cm = typename T::Cm;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kQP = T::kQP;  // pieces of q, and of P
  constexpr int kKP = T::kKP;  // pieces of K and V
  constexpr int kPairs = T::kPairs;
  constexpr int kThreads = T::kThreads;
  constexpr int KW = T::KW;
  constexpr int kAblate = BRAVO_CHUNK_ABLATE;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char csmem[];

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = blockIdx.z / sh.blocks;
  const int pair0 = (blockIdx.z - kh * sh.blocks) * kPairs;
  const int g = sh.H / sh.KVH;
  const int n_pairs = sh.S * g;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int grp = lane >> 2;  // the fragment's row (and row + 8)
  const int tig = lane & 3;   // its column pair
  const int wrow = (warp / WT) * 16;  // this warp's pairs in the block
  const int wpos = (warp % WT) * KW;  // and its positions in a tile

  // the tiles' base, 1024-byte aligned for the wgmma descriptors
  unsigned char* ring =
      csmem + ((T::kAlign - (static_cast<unsigned>(
                                 __cvta_generic_to_shared(csmem)) %
                             (T::kAlign ? T::kAlign : 1))) %
               (T::kAlign ? T::kAlign : 1));
  unsigned char* prep = ring + T::kStages * T::kStage;
  unsigned char* qs = prep + T::kPrepBytes;
  // per row of the tiles in flight: its element offset in the pages (-1:
  // masked) and, for int8 pages, its scores' scale (the K scale over
  // sqrt(hd)) and its V scale
  long long* roff = reinterpret_cast<long long*>(qs + kQP * T::kQBlock);
  float* rsc = reinterpret_cast<float*>(roff + T::kInfo * KT);
  float* rvs = rsc + T::kInfo * KT;
  // per tile in flight and warp of its rows: 1 if every row is valid
  int* rall = reinterpret_cast<int*>(rvs + T::kInfo * KT);

  // the split's positions, [t_begin, t_stop), up to the last one any pair
  // of the block can see
  const int clen = cache_len[b];
  const int nl = new_lens[b];
  const int n_pos = min(clen, sh.P * sh.ps);
  const int last_col = min((pair0 + kPairs - 1) / g, sh.S - 1);
  const int t_end = min(n_pos, clen - sh.S + last_col + 1);
  const int lane0 = split * sh.pps;
  const int n_lanes = max(0, min(sh.pps, sh.P - lane0));
  const int t_begin = lane0 * sh.ps;
  const int t_stop = min(t_end, t_begin + n_lanes * sh.ps);
  const int n_tiles = t_stop > t_begin ? (t_stop - t_begin + KT - 1) / KT : 0;
  const float inv_sqrt = 1.0f / sqrtf(static_cast<float>(sh.hd));

  // pair (block-local pr) -> its query's limit (0: padding or no pair)
  auto limit = [&](int pr) {
    const int pair = pair0 + pr;
    const int col = pair / g;
    const int q_pos = clen - sh.S + col;
    const bool real = pair < n_pairs && col >= sh.S - nl && q_pos >= 0;
    return real ? min(n_pos, q_pos + 1) : 0;
  };

  // a tile's rows, one thread each: offset and scales into the tile's
  // slot, and whether every row of the thread's warp is valid
  auto rows = [&](int tile) {
    if (threadIdx.x >= (KT + kWarp - 1) / kWarp * kWarp) return;
    const int r = threadIdx.x;
    long long off = -1;
    if (r < KT) {
      const int t = t_begin + tile * KT + r;
      float ks = inv_sqrt, vs = 0.f;
      if (tile < n_tiles && t < t_stop) {
        const int ln = fastdiv(t, sh.ps_mul, sh.ps_shift);
        const int pg = page_idx[size_t(b) * sh.P + ln];
        if (pg >= 0 && pg < sh.n_pages) {
          off = ((static_cast<long long>(pg) * sh.ps + (t - ln * sh.ps)) *
                     sh.KVH + kh) * sh.hd;
          if constexpr (kQuant) {
            ks = k_scale[size_t(pg) * sh.KVH + kh] * inv_sqrt;
            vs = v_scale[size_t(pg) * sh.KVH + kh];
          }
        }
      }
      const int at = (tile % T::kInfo) * KT + r;
      roff[at] = off;
      rsc[at] = ks;
      rvs[at] = vs;
    }
    const unsigned valid = __ballot_sync(kFull, r >= KT || off >= 0);
    if (r % kWarp == 0)
      rall[(tile % T::kInfo) * 2 + r / kWarp] = valid == kFull;
  };

  // tile -> its ring stage in 16-byte chunks, consecutive threads along a
  // row, K rows then V rows; a masked row, and the padding past hd, is
  // zero-filled, not read
  auto issue = [&](int tile) {
    if (tile >= n_tiles || kAblate == 2) return;
    unsigned char* st = ring + (tile % T::kStages) * T::kStage;
    const long long* off = roff + (tile % T::kInfo) * KT;
    constexpr int kTotal = 2 * KT * St::kChunks;
#pragma unroll 4
    for (int i0 = 0; i0 < kTotal; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      if (kTotal % kThreads != 0 && i >= kTotal) break;
      const int kv = i / (KT * St::kChunks);
      const int r = (i / St::kChunks) % KT;
      const int c = i % St::kChunks;
      const long long o = off[r];
      const int n = o < 0 ? 0 : min(St::kElem, max(0, sh.hd - c * St::kElem));
      const TKV* src = (kv ? v_pages : k_pages) + (n ? o + c * St::kElem : 0);
      unsigned char* dst = st + St::at(kv * KT + r, c);
      if (vec)  // n is 0 or the whole chunk
        cp_async16(dst, src, n > 0);
      else
        copy16<TKV>(dst, src, n);
    }
  };

  // a landed int8 or float32 tile -> its bf16 pieces in `prep`
  auto prepare = [&](int tile) {
    const unsigned char* st = ring + (tile % T::kStages) * T::kStage;
    if constexpr (kQuant) {  // 16 int8 -> 16 bf16, exactly
      constexpr int kTotal = 2 * KT * St::kChunks;
      for (int i = threadIdx.x; i < kTotal; i += kThreads) {
        const int kv = i / (KT * St::kChunks);
        const int r = (i / St::kChunks) % KT;
        const int c = i % St::kChunks;
        float f[16];
        Cvt<int8_t>::run(
            *reinterpret_cast<const uint4*>(st + St::at(kv * KT + r, c)), f);
        unsigned char* d = prep + kv * T::kBlock;
        put_pieces<1>(d, 0, Cm::at(r, 2 * c), f);
        put_pieces<1>(d, 0, Cm::at(r, 2 * c + 1), f + 8);
      }
    } else {  // 8 float32 -> three pieces of 8 bf16
      constexpr int kTotal = 2 * KT * Cm::kChunks;
      for (int i = threadIdx.x; i < kTotal; i += kThreads) {
        const int kv = i / (KT * Cm::kChunks);
        const int r = (i / Cm::kChunks) % KT;
        const int cc = i % Cm::kChunks;
        float f[8];
        Cvt<float>::run(*reinterpret_cast<const uint4*>(
                            st + St::at(kv * KT + r, 2 * cc)), f);
        Cvt<float>::run(*reinterpret_cast<const uint4*>(
                            st + St::at(kv * KT + r, 2 * cc + 1)), f + 4);
        put_pieces<kKP>(prep + kv * T::kBlock, 2 * T::kBlock, Cm::at(r, cc),
                        f);
      }
    }
  };

  // the first tiles' rows, and the first tile's copies in flight before
  // the queries load
#pragma unroll
  for (int t = 0; t < T::kStages; ++t) rows(t);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < T::kStages - 1; ++t) {
    issue(t);
    cp_async_commit();
  }

  // the block's queries as kQP bf16 pieces (zero for padding and past hd)
  if (n_tiles > 0) {
    constexpr int kQC = Cm::kChunks;
    for (int i = threadIdx.x; i < kPairs * kQC; i += kThreads) {
      const int pr = i / kQC;
      const int cc = i - pr * kQC;
      const int pair = pair0 + pr;
      const bool real = limit(pr) > 0;
      const size_t base =
          ((size_t(b) * sh.S + (real ? pair / g : 0)) * sh.H + kh * g +
           pair % g) * sh.hd;
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = cc * 8 + e;
        x[e] = real && d < sh.hd ? to_f32(q[base + d]) : 0.f;
      }
      put_pieces<kQP>(qs, T::kQBlock, Cm::at(pr, cc), x);
    }
  }

  const int tlim[2] = {limit(wrow + grp), limit(wrow + grp + 8)};
  // every pair of this warp sees the positions before this one
  const int tmin = __reduce_min_sync(kFull, min(tlim[0], tlim[1]));
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the denominators
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<T::kStages - 2>();
    if constexpr (T::kWg) fence_proxy_async();  // for wgmma's reads
    __syncthreads();  // the tile landed; the stage to refill is free
    issue(tile + T::kStages - 1);
    cp_async_commit();
    rows(tile + T::kStages);
    if constexpr (kAblate == 1) continue;
    const unsigned char* st = ring + (tile % T::kStages) * T::kStage;
    if constexpr (T::kPrep) {
      prepare(tile);
      if constexpr (T::kWg) fence_proxy_async();
      __syncthreads();
    }
    const unsigned char* kb = T::kPrep ? prep : st;  // piece j at + 2j blocks
    const unsigned char* vb = kb + T::kBlock;
    const int slot = tile % T::kInfo;
    const int info = slot * KT + wpos;  // this warp's rows
    const int t0 = t_begin + tile * KT + wpos;

    // S = Q K^T over the warp's positions of the tile: q pieces x K pieces
    // of order <= 2, the small products first, each product over all the
    // n-tiles in turn
    float sc[KW / 8][4];
#pragma unroll
    for (int n = 0; n < KW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    if constexpr (T::kWg) {
      const int wg_row = (warp / 4) * 64;  // this warpgroup's first pair
      wg_hold(&sc[0][0]);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
        for (int j = kKP - 1; j >= 0; --j)
#pragma unroll
          for (int i = kQP - 1; i >= 0; --i) {
            if (i + j > 2) continue;
            wg_ss(&sc[0][0],
                  wg_desc(qs + i * T::kQBlock + wg_row * Cm::kRowBytes +
                          ks * 32),
                  wg_desc(kb + 2 * j * T::kBlock + ks * 32));
          }
      wg_commit_wait();
      wg_hold(&sc[0][0]);
    } else
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[kQP][4];
      uint32_t bk[kKP][KW / 16][4];
#pragma unroll
      for (int p = 0; p < kQP; ++p)
        ldsm_x4(a[p], qs + p * T::kQBlock +
                          Cm::at(wrow + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 2 * ks + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < kKP; ++j)
#pragma unroll
        for (int np = 0; np < KW / 16; ++np)
          ldsm_x4(bk[j][np],
                  kb + 2 * j * T::kBlock +
                      Cm::at(wpos + np * 16 + (lane & 7) + (lane >> 4) * 8,
                             2 * ks + ((lane >> 3) & 1)));
#pragma unroll
      for (int j = kKP - 1; j >= 0; --j)
#pragma unroll
        for (int i = kQP - 1; i >= 0; --i) {
          if (i + j > 2) continue;
#pragma unroll
          for (int np = 0; np < KW / 16; ++np) {
            mma_bf16(sc[2 * np], a[i], bk[j][np][0], bk[j][np][1]);
            mma_bf16(sc[2 * np + 1], a[i], bk[j][np][2], bk[j][np][3]);
          }
        }
    }

    // the online softmax of this thread's two pair rows (R = 0: row grp,
    // R = 1: row grp + 8) over its columns of the tile, in log2 units: a
    // tile every position of which every pair of the warp sees (the
    // interior of a long walk) skips the masks
    const bool inside = rall[slot * 2] && (KT <= kWarp || rall[slot * 2 + 1]) &&
                        t0 + KW <= tmin;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pt = n * 8 + tig * 2 + e;
        const float scale = kQuant ? rsc[info + pt] : inv_sqrt;
        const bool ok = inside || roff[info + pt] >= 0;
#pragma unroll
        for (int R = 0; R < 2; ++R) {
          float& v = sc[n][R * 2 + e];
          v = inside || (ok && t0 + pt < tlim[R]) ? v * scale : -INFINITY;
          mx[R] = fmaxf(mx[R], v);
        }
      }
    float ms[2], corr[2];
#pragma unroll
    for (int R = 0; R < 2; ++R) {
      mx[R] = fmaxf(mx[R], __shfl_xor_sync(kFull, mx[R], 1));
      mx[R] = fmaxf(mx[R], __shfl_xor_sync(kFull, mx[R], 2));
      const float m_new = fmaxf(m[R], mx[R]);
      ms[R] = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;  // none valid: 0
      corr[R] = ex2(fmaf(m[R], kLog2e, -ms[R]));  // 0 while m is -inf
      m[R] = m_new;
      l[R] *= corr[R];
    }
    if (__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }
#pragma unroll
    for (int n = 0; n < KW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& v = sc[n][e];
        v = ex2(fmaf(v, kLog2e, -ms[e >> 1]));  // -inf: 0
        l[e >> 1] += v;
      }

    // O += P V: P's fragments are the score fragments of two n-tiles;
    // int8 pages fold each position's V scale into P before the split.
    // The width goes in groups of up to 4 pairs of n-tiles (V fragments
    // in registers).
    constexpr int kDG = HD / 16 < 4 ? HD / 16 : 4;
    if constexpr (T::kWg) {
      uint32_t pa[KW / 16][kQP][4];
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        float pv[8] = {sc[2 * kk][0],     sc[2 * kk][1],
                       sc[2 * kk][2],     sc[2 * kk][3],
                       sc[2 * kk + 1][0], sc[2 * kk + 1][1],
                       sc[2 * kk + 1][2], sc[2 * kk + 1][3]};
        if constexpr (kQuant) {
          const float* vs = rvs + info + kk * 16 + tig * 2;
          pv[0] *= vs[0];
          pv[1] *= vs[1];
          pv[2] *= vs[0];
          pv[3] *= vs[1];
          pv[4] *= vs[8];
          pv[5] *= vs[9];
          pv[6] *= vs[8];
          pv[7] *= vs[9];
        }
        split_pack<kQP>(pv, pa[kk]);
      }
      wg_hold(&o[0][0]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk)
#pragma unroll
        for (int j = kKP - 1; j >= 0; --j)
#pragma unroll
          for (int i = kQP - 1; i >= 0; --i) {
            if (i + j > 2) continue;
            wg_rs_t(&o[0][0], pa[kk][i],
                    wg_desc(vb + 2 * j * T::kBlock + kk * 16 * 128));
          }
      wg_commit_wait();
      wg_hold(&o[0][0]);
    } else
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      float pv[8] = {sc[2 * kk][0],     sc[2 * kk][1],     sc[2 * kk][2],
                     sc[2 * kk][3],     sc[2 * kk + 1][0], sc[2 * kk + 1][1],
                     sc[2 * kk + 1][2], sc[2 * kk + 1][3]};
      if constexpr (kQuant) {
        const float* vs = rvs + info + kk * 16 + tig * 2;
        pv[0] *= vs[0];
        pv[1] *= vs[1];
        pv[2] *= vs[0];
        pv[3] *= vs[1];
        pv[4] *= vs[8];
        pv[5] *= vs[9];
        pv[6] *= vs[8];
        pv[7] *= vs[9];
      }
      uint32_t a[kQP][4];
      split_pack<kQP>(pv, a);
#pragma unroll
      for (int d0 = 0; d0 < HD / 16; d0 += kDG) {
        uint32_t bv[kKP][kDG][4];
#pragma unroll
        for (int j = 0; j < kKP; ++j)
#pragma unroll
          for (int dn = 0; dn < kDG; ++dn)
            ldsm_x4_t(bv[j][dn],
                      vb + 2 * j * T::kBlock +
                          Cm::at(wpos + kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8,
                                 2 * (d0 + dn) + (lane >> 4)));
#pragma unroll
        for (int j = kKP - 1; j >= 0; --j)
#pragma unroll
          for (int i = kQP - 1; i >= 0; --i) {
            if (i + j > 2) continue;
#pragma unroll
            for (int dn = 0; dn < kDG; ++dn) {
              mma_bf16(o[2 * (d0 + dn)], a[i], bv[j][dn][0], bv[j][dn][1]);
              mma_bf16(o[2 * (d0 + dn) + 1], a[i], bv[j][dn][2],
                       bv[j][dn][3]);
            }
          }
      }
    }
  }
  cp_async_wait<0>();

  // the quad's shares of each denominator
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    l[R] += __shfl_xor_sync(kFull, l[R], 1);
    l[R] += __shfl_xor_sync(kFull, l[R], 2);
  }

  // the warps' states through the tiles' memory: per pair row, the WT
  // warps that share it are merged, then warp w writes rows w, w + 4, ...
  // with lanes along the row (out for one split, else the split's partial)
  constexpr int kRow = HD + 2;  // acc, m, l
  __syncthreads();
  float* mg = reinterpret_cast<float*>(csmem);
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    float* st = mg + (warp * 16 + grp + R * 8) * kRow;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(st + n * 8 + tig * 2) =
          make_float2(o[n][2 * R], o[n][2 * R + 1]);
    if (tig == 0) {
      st[HD] = m[R];
      st[HD + 1] = l[R];
    }
  }
  __syncthreads();
  for (int pr = warp; pr < kPairs; pr += NW) {
    const int pair = pair0 + pr;
    if (pair >= n_pairs) break;
    // warps (pr / 16) * WT + w, w < WT, hold row pr % 16 of the slice
    const float* s0 = mg + ((pr / 16) * WT * 16 + pr % 16) * kRow;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WT; ++w) mx = fmaxf(mx, s0[w * 16 * kRow + HD]);
    float wt[WT];
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < WT; ++w) {
      const float mw = s0[w * 16 * kRow + HD];
      wt[w] = mw == -INFINITY ? 0.f : exp2f((mw - mx) * kLog2e);
      den = fmaf(wt[w], s0[w * 16 * kRow + HD + 1], den);
    }
    const size_t row =
        (size_t(b) * sh.S + pair / g) * sh.H + kh * g + pair % g;
    const size_t part = row * sh.n_split + split;
    const float rden = 1.f / fmaxf(den, 1e-20f);
    for (int d = lane; d < sh.hd; d += kWarp) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WT; ++w) a = fmaf(wt[w], s0[w * 16 * kRow + d], a);
      if (sh.n_split == 1)
        out[row * sh.hd + d] = from_f32<TQ>(a * rden);
      else
        part_acc[part * sh.hd + d] = a;
    }
    if (sh.n_split > 1 && lane == 0) {
      part_ml[2 * part] = mx;
      part_ml[2 * part + 1] = den;
    }
  }
}

// The chunk kernel for one q type, page type, width and layout.
template <typename TQ, typename TKV, int HD, int WT, int NW>
struct Chunk {
  static constexpr int KT = chunk_rows<TQ, TKV, HD>();
  using T = ChunkTile<TQ, TKV, HD, KT, WT, NW>;
  static_assert(T::kSmem <= kMaxChunkSmem, "chunk tile fits");

  // opt in once, before any launch is captured
  static cudaError_t ready() {
    static const cudaError_t opted =
        opt_in(chunk_attn_kernel<TQ, TKV, HD, KT, WT, NW>, T::kSmem);
    return opted;
  }

  // CTAs of this kernel that one SM holds; its shared memory
  static cudaError_t resident(int* n, int* smem) {
    const cudaError_t err = ready();
    if (err != cudaSuccess) return err;
    *smem = static_cast<int>(T::kSmem);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, chunk_attn_kernel<TQ, TKV, HD, KT, WT, NW>, T::kThreads, T::kSmem);
  }

  static cudaError_t launch(const Args& a, ChunkShape sh,
                            cudaStream_t stream) {
    cudaError_t err = ready();
    if (err != cudaSuccess) return err;
    const int vec = ((reinterpret_cast<uintptr_t>(a.k) |
                      reinterpret_cast<uintptr_t>(a.v)) % 16) == 0 &&
                    (sh.hd * sizeof(TKV)) % 16 == 0;
    sh.blocks = (sh.S * (sh.H / sh.KVH) + T::kPairs - 1) / T::kPairs;
    const dim3 grid(sh.n_split, sh.B, sh.KVH * sh.blocks);
    chunk_attn_kernel<TQ, TKV, HD, KT, WT, NW>
        <<<grid, T::kThreads, T::kSmem, stream>>>(
            static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
            static_cast<const TKV*>(a.v), a.k_scale, a.v_scale, a.page_idx,
            a.cache_len, a.new_lens, static_cast<TQ*>(a.out), a.part_acc,
            a.part_ml, sh, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess || sh.n_split == 1) return err;
    combine_kernel<TQ, HD><<<sh.B * sh.S * sh.H, kWarp, 0, stream>>>(
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

// The chunk kernel's layout: pairs a CTA (64 on 4 warps for the widths
// other than 64; at the width 64, hd 33 to 64, 128 on 8 warps or 16 on 4
// warps along each tile).  Calls f(Chunk<...>{}) for a call's types, width
// and layout; an invalid value for a layout that is not built.
template <typename F>
cudaError_t with_chunk(int q_bf16, int kv, int hd, int pairs, F&& f) {
  return with_types(q_bf16, kv, hd, [&](auto tq, auto tkv, auto w) {
    using TQ = typename decltype(tq)::type;
    using TKV = typename decltype(tkv)::type;
    constexpr int HD = decltype(w)::value;
    if constexpr (HD == 64) {
      if (pairs == 128) return f(Chunk<TQ, TKV, HD, 1, 8>{});
      if (pairs == 16) return f(Chunk<TQ, TKV, HD, 4, 4>{});
    } else {
      if (pairs == 64) return f(Chunk<TQ, TKV, HD, 1, 4>{});
    }
    return cudaErrorInvalidValue;
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
          int n_pages, int n_split, int pps, int pairs, int q_bf16, int kv,
          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH != 0 || ps <= 0 || P < 0 || n_split <= 0 ||
      pps < 0 || size_t(n_split) * pps < size_t(P) ||
      a.new_lens == nullptr ||
      (n_split > 1 && (a.part_acc == nullptr || a.part_ml == nullptr)) ||
      (kv == kKvInt8 && (a.k_scale == nullptr || a.v_scale == nullptr)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#if BRAVO_CHUNK_PARENT
  // the parent design: as many columns a CTA as fit in 16 warps at one warp
  // per (column, query head), at least one; no split, no layout choice
  (void)pairs;
  const int qb = max(1, min(S, kMaxWarps / (H / KVH)));
  const Shape sh{B, S, H, KVH, hd, ps, P, n_pages, qb};
  return static_cast<int>(
      with_types(q_bf16, kv, hd, [&](auto tq, auto tkv, auto w) {
        return launch_chunk<typename decltype(tq)::type,
                            typename decltype(tkv)::type,
                            decltype(w)::value>(a, sh, st);
      }));
#else
  ChunkShape sh{B, S, H, KVH, hd, ps, P, n_pages, n_split, pps, 0, 0u, 0};
  fastdiv_magic(ps, &sh.ps_mul, &sh.ps_shift);
  return static_cast<int>(with_chunk(
      q_bf16, kv, hd, pairs, [&](auto k) { return k.launch(a, sh, st); }));
#endif
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
// trailing columns; cache_len the length after the chunk; out (B, S, H,
// hd); n_split splits of pps page lanes, whose partials go to part_acc (B,
// S, H, n_split, hd) and part_ml (B, S, H, n_split, 2) float32 when
// n_split > 1 (null otherwise); pairs (column, query head) pairs a CTA: 64
// for hd up to 32 or above 64; 128 or 16 (four warps along each tile's
// positions) for hd 33 to 64.
int bravo_paged_chunk_attn(const void* q, const void* k_pages,
                           const void* v_pages, const int32_t* page_idx,
                           const int32_t* cache_len, const int32_t* new_lens,
                           void* out, void* part_acc, void* part_ml, int B,
                           int S, int H, int KVH, int hd, int ps, int P,
                           int n_pages, int n_split, int pps, int pairs,
                           int q_bf16, int kv_bf16, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, page_idx, cache_len,
               new_lens, out, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml)};
  return chunk(a, B, S, H, KVH, hd, ps, P, n_pages, n_split, pps, pairs,
               q_bf16, kv_bf16 ? kKvBf16 : kKvF32, stream);
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
int bravo_paged_chunk_attn_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int32_t* page_idx,
    const int32_t* cache_len, const int32_t* new_lens, void* out,
    void* part_acc, void* part_ml, int B, int S, int H, int KVH, int hd,
    int ps, int P, int n_pages, int n_split, int pps, int pairs, int q_bf16,
    void* stream) {
  const Args a{q, k_pages, v_pages, k_scale, v_scale, page_idx, cache_len,
               new_lens, out, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml)};
  return chunk(a, B, S, H, KVH, hd, ps, P, n_pages, n_split, pps, pairs,
               q_bf16, kKvInt8, stream);
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

// Resident CTAs an SM holds of the chunk kernel (K6 for kv 0/1, K8 for
// kv 2) at this width and layout (pairs a CTA), written to *resident, and
// its shared memory a CTA, to *smem; launches nothing.  The wrappers size
// the KV split with it.  Not in the parent build.
int bravo_paged_chunk_attn_residency(int q_bf16, int kv, int hd, int pairs,
                                     int* resident, int* smem) {
#if BRAVO_CHUNK_PARENT
  return cudaErrorNotSupported;
#else
  if (resident == nullptr || smem == nullptr) return cudaErrorInvalidValue;
  return static_cast<int>(with_chunk(q_bf16, kv, hd, pairs, [&](auto k) {
    return k.resident(resident, smem);
  }));
#endif
}

const char* bravo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
