// Visible-readers-table kernels for Hopper (sm_90a): the BRAVO lease path.
//
// The table is one (rows, 128) int32 buffer of 4096 slots (16 KiB); a slot
// holds 0 or the value of the lock a reader published.  Six kernels:
//
//   K1 publish_multi  replaces repro/kernels/table_publish.py
//                     _fused_publish_multi_kernel (batched CAS 0 -> id, each
//                     request gated by its own lock's bias lane)
//   K2 publish        replaces repro/kernels/table_publish.py
//                     _fused_publish_kernel (one scalar bias; unconditional
//                     store = release)
//   K3 poll           replaces repro/kernels/table_scan.py _poll_kernel
//   K4 multi_poll     replaces repro/kernels/table_scan.py _multi_poll_kernel
//   K9 scan           replaces repro/kernels/table_scan.py _scan_kernel
//                     (int8 match mask plus exact count)
//   K10 publish_seq   replaces repro/kernels/table_publish.py _publish_kernel
//                     (the legacy one-request-at-a-time CAS loop, writing a
//                     new table)
//
// What bounds them on this card: nothing in the arithmetic.  Each call moves
// at most the 16 KiB table plus a few hundred bytes of request vectors, which
// is a few nanoseconds of HBM time at 3.35 TB/s; every call is bound by launch
// latency.  So each kernel is one CTA that holds all of its work: no grid-wide
// reduction, no second pass, no atomics in device memory, one launch per call.
//
// Design notes per kernel:
// * K1/K2 run one thread per request, in chunks of 1024 requests for a
//   larger batch.  The TPU kernel resolved in-batch collisions with one-hot
//   matmuls; here each thread scans the earlier requests' slots in shared
//   memory (O(M^2), M is a serving batch), chunk by chunk, so the LOWEST
//   index among attempting requests wins across the whole batch, exactly as
//   a sequential CAS loop would.  A bare atomicCAS race would pick a winner
//   in no fixed order.  Within a chunk all occupancy reads happen before the
//   barrier and the unique winners store after it; a later chunk reads a
//   slot only if no earlier request claimed it, so that no earlier store
//   touched it: every decision sees the table as it was before the batch,
//   as the TPU kernel's single table load did.
// * The hashed entries fold the registry's splitmix64 slot hash and the
//   lock-value gather (lock_vals[lock_idx]) into the same launch, in native
//   uint64, so a lease acquire or release is one launch.
// * A slot outside [0, n_slots) matches no table entry: it reads as free and
//   stores nothing, like the TPU kernel's one-hot selectors.  The sign is
//   tested before any division or indexing (-1 / 128 == 0 in C).
// * K3/K4 are one 1024-thread CTA over the table with a block reduction.  K3
//   returns the exact count, which meets the TPU kernel's contract (exact
//   when zero, a lower bound >= 1 otherwise); the TPU version stopped early
//   because its grid ran in order, which CTAs do not.  K4 keeps its K <= 128
//   counters in shared memory.
// * The hashed K2 entries are the single-lock lease table's acquire
//   (conditional, under the scalar bias, id = the lock value) and the
//   release (unconditional, id 0, denied readers masked to slot -1).  They
//   take 32-bit reader ids or 64-bit ones (host ids up to 2**64 - 1, hashed
//   over all 64 bits as repro's host limbs are).
// * K9 is K3 that also writes the int8 mask.  Its count is exact, as the
//   TPU kernel's was: that one scanned every block in order.
// * K10 keeps the TPU kernel's SEQUENTIAL semantics, which no parallel CAS
//   race reproduces: an unconditional store to one slot twice keeps the
//   LAST id, a conditional publish of id 0 leaves the slot free for a later
//   request, and every decision sees the stores of the requests before it.
//   So the CTA stages the table in shared memory (16 KiB at 4096 slots),
//   one thread walks the requests in order there, and the CTA writes the
//   whole table to a NEW output, as the TPU kernel copied its table block
//   input to output on every call.  A slot outside [0, n_slots) reads as
//   free and stores nothing, as in K1/K2.
//
// Every entry point enqueues on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRequests = 1024;
constexpr int kMaxLocks = 128;
constexpr int kScanThreads = 1024;
constexpr int kSeqChunk = 1024;   // K10 requests staged per pass
// K10's dynamic shared memory (the staged table) beyond which the kernel
// needs the opt-in attribute: 48 KiB per block less its static arrays
constexpr size_t kSeqDefaultSmem = 48 * 1024 - 2 * kSeqChunk * sizeof(int);

// splitmix64 finalizer over (lock, reader), as repro.core.table.mix_hash:
// the lock is a 32-bit value zero-extended to 64 bits, the reader a 64-bit
// id (a 32-bit one zero-extended).
__device__ __forceinline__ uint64_t mix_hash(uint32_t lock, uint64_t reader) {
  uint64_t x = static_cast<uint64_t>(lock) * 0x9E3779B97F4A7C15ull +
               reader * 0xBF58476D1CE4E5B9ull;
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x;
}

__device__ __forceinline__ bool in_table(int slot, int n_slots) {
  return slot >= 0 && slot < n_slots;
}

// Request i's lock lane, slot and published id.  Hashed mode derives slot
// and id from lock_vals[lane] and reader_ids[i] (int32 bits of a uint32
// id, or with `reader_wide` int64 bits of a uint64 id); explicit mode reads
// them.  `lane_ok` is false for a lane outside [0, n_locks).
template <bool kHashed>
__device__ __forceinline__ void load_request(
    int i, int n_slots, int n_locks, const int32_t* lock_vals,
    const int32_t* slots, const int32_t* lock_idx, int lidx_stride,
    const int32_t* ids, const void* reader_ids, int reader_wide, int* lane,
    bool* lane_ok, int* slot, int* id) {
  *lane = lock_idx == nullptr ? 0 : lock_idx[i * lidx_stride];
  *lane_ok = *lane >= 0 && *lane < n_locks;
  if (kHashed) {
    const int32_t val = *lane_ok ? lock_vals[*lane] : 0;
    const uint64_t reader =
        reader_wide
            ? static_cast<uint64_t>(static_cast<const int64_t*>(reader_ids)[i])
            : static_cast<uint64_t>(static_cast<uint32_t>(
                  static_cast<const int32_t*>(reader_ids)[i]));
    const uint64_t h = mix_hash(static_cast<uint32_t>(val), reader);
    *slot = *lane_ok ? static_cast<int>(h & static_cast<uint64_t>(n_slots - 1))
                     : -1;
    *id = val;
  } else {
    *slot = slots[i];
    *id = ids[i];
  }
}

// K1: batched CAS(0 -> id) where request i attempts only if
// rbias[lock_idx[i]] != 0; lowest attempting index wins per slot.
template <bool kHashed>
__global__ void __launch_bounds__(kMaxRequests)
publish_multi_kernel(int32_t* __restrict__ table, int n_slots,
                     const int32_t* __restrict__ rbias,
                     const int32_t* __restrict__ lock_vals, int n_locks,
                     const int32_t* __restrict__ slots,
                     const int32_t* __restrict__ lock_idx, int lidx_stride,
                     const int32_t* __restrict__ ids,
                     const void* __restrict__ reader_ids, int reader_wide,
                     bool* __restrict__ granted, int m) {
  __shared__ int s_slot[kMaxRequests];
  __shared__ int s_attempt[kMaxRequests];
  // request j's slot and id; -> whether it attempts
  auto request = [&](int j, int* slot, int* id) {
    int lane;
    bool lane_ok;
    load_request<kHashed>(j, n_slots, n_locks, lock_vals, slots, lock_idx,
                          lidx_stride, ids, reader_ids, reader_wide, &lane,
                          &lane_ok, slot, id);
    return lane_ok && rbias[lane] != 0;
  };
  for (int base = 0; base < m; base += kMaxRequests) {
    const int i = base + threadIdx.x;
    const bool active = i < m;
    int slot = -1, id = 0;
    const bool attempt = active && request(i, &slot, &id);
    // first among the attempting requests before i: every earlier chunk,
    // then this one up to i
    bool first = true;
    for (int b2 = 0; b2 <= base; b2 += kMaxRequests) {
      __syncthreads();  // the scans of the previous chunk are done
      const int j = b2 + threadIdx.x;
      if (j < m) {
        int sj, idj;
        s_attempt[threadIdx.x] = request(j, &sj, &idj);
        s_slot[threadIdx.x] = sj;
      }
      __syncthreads();
      if (attempt && first) {
        const int n = b2 < base ? kMaxRequests : static_cast<int>(threadIdx.x);
        for (int k = 0; k < n; ++k) {
          if (s_attempt[k] && s_slot[k] == slot) {
            first = false;
            break;
          }
        }
      }
    }
    bool win = false;
    if (attempt) {
      const int cur = in_table(slot, n_slots) ? table[slot] : 0;
      win = first && cur == 0;
    }
    __syncthreads();  // every occupancy read of the chunk lands before a store
    if (active) {
      if (win && in_table(slot, n_slots)) table[slot] = id;
      granted[i] = win;
    }
  }
}

// K2: batched publish against one scalar bias.  The first request per slot
// (over all requests) wins; unless `unconditional`, only into a free slot;
// with `check_rbias`, only while *rbias != 0.  Hashed mode publishes the
// lock value into each reader's slot or, when `unconditional`, is the
// release: id 0 into each reader's slot, or slot -1 where mask[i] is false.
template <bool kHashed>
__global__ void __launch_bounds__(kMaxRequests)
publish_kernel(int32_t* __restrict__ table, int n_slots,
               const int32_t* __restrict__ rbias, int check_rbias,
               int unconditional, const int32_t* __restrict__ slots,
               const int32_t* __restrict__ ids,
               const int32_t* __restrict__ lock_vals, int n_locks,
               const int32_t* __restrict__ lock_idx, int lidx_stride,
               const void* __restrict__ reader_ids, int reader_wide,
               const bool* __restrict__ mask, bool* __restrict__ granted,
               int m) {
  __shared__ int s_slot[kMaxRequests];
  auto request = [&](int j, int* slot, int* id) {
    int lane;
    bool lane_ok;
    load_request<kHashed>(j, n_slots, n_locks, lock_vals, slots, lock_idx,
                          lidx_stride, ids, reader_ids, reader_wide, &lane,
                          &lane_ok, slot, id);
    if (kHashed && unconditional) {   // the release: store 0, and never
      *id = 0;                         // into a denied reader's slot
      if (mask != nullptr && !mask[j]) *slot = -1;
    }
  };
  for (int base = 0; base < m; base += kMaxRequests) {
    const int i = base + threadIdx.x;
    const bool active = i < m;
    int slot = -1, id = 0;
    if (active) request(i, &slot, &id);
    bool first = true;
    for (int b2 = 0; b2 <= base; b2 += kMaxRequests) {
      __syncthreads();  // the scans of the previous chunk are done
      const int j = b2 + threadIdx.x;
      if (j < m) {
        int sj, idj;
        request(j, &sj, &idj);
        s_slot[threadIdx.x] = sj;
      }
      __syncthreads();
      if (active && first) {
        const int n = b2 < base ? kMaxRequests : static_cast<int>(threadIdx.x);
        for (int k = 0; k < n; ++k) {
          if (s_slot[k] == slot) {
            first = false;
            break;
          }
        }
      }
    }
    bool win = false;
    if (active) {
      win = first;
      if (!unconditional) {
        const int cur = in_table(slot, n_slots) ? table[slot] : 0;
        win = win && cur == 0;
      }
      if (check_rbias) win = win && *rbias != 0;
    }
    __syncthreads();  // every occupancy read of the chunk lands before a store
    if (active) {
      if (win && in_table(slot, n_slots)) table[slot] = id;
      if (granted != nullptr) granted[i] = win;
    }
  }
}

// Sum of one int per thread over a CTA of kScanThreads threads.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int s_warp[kScanThreads / 32];
  v = __reduce_add_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = threadIdx.x < kScanThreads / 32 ? s_warp[threadIdx.x] : 0;
  if (warp == 0) v = __reduce_add_sync(0xffffffffu, v);
  return v;  // valid in thread 0
}

// K3: exact count of slots publishing lock_id.
__global__ void __launch_bounds__(kScanThreads)
poll_kernel(const int32_t* __restrict__ table, int n_slots, int32_t lock_id,
            int32_t* __restrict__ count) {
  int local = 0;
  for (int s = threadIdx.x; s < n_slots; s += kScanThreads)
    local += table[s] == lock_id;
  const int total = block_sum(local);
  if (threadIdx.x == 0) *count = total;
}

// K4: exact counts for k lock values in one pass over the table.
__global__ void __launch_bounds__(kScanThreads)
multi_poll_kernel(const int32_t* __restrict__ table, int n_slots,
                  const int32_t* __restrict__ lock_ids, int k,
                  int32_t* __restrict__ counts) {
  __shared__ int s_locks[kMaxLocks];
  __shared__ int s_counts[kMaxLocks];
  for (int t = threadIdx.x; t < k; t += kScanThreads) {
    s_locks[t] = lock_ids[t];
    s_counts[t] = 0;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_slots; s += kScanThreads) {
    const int v = table[s];
    for (int j = 0; j < k; ++j)
      if (s_locks[j] == v) atomicAdd(&s_counts[j], 1);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < k; t += kScanThreads) counts[t] = s_counts[t];
}

// K9: int8 mask of the slots publishing lock_id, and their exact count.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int32_t* __restrict__ table, int n_slots, int32_t lock_id,
            int8_t* __restrict__ mask, int32_t* __restrict__ count) {
  int local = 0;
  for (int s = threadIdx.x; s < n_slots; s += kScanThreads) {
    const int hit = table[s] == lock_id;
    mask[s] = static_cast<int8_t>(hit);
    local += hit;
  }
  const int total = block_sum(local);
  if (threadIdx.x == 0) *count = total;
}

// K10: the requests in order, each `cur = t[slot]; ok = unconditional ||
// cur == 0; if (ok) t[slot] = id; granted[i] = ok`, on a copy of the table
// in shared memory, then the copy to `out`.
__global__ void __launch_bounds__(kScanThreads)
publish_seq_kernel(const int32_t* __restrict__ table, int n_slots,
                   int32_t* __restrict__ out,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ ids,
                   bool* __restrict__ granted, int m, int unconditional) {
  extern __shared__ int32_t s_table[];
  __shared__ int s_slot[kSeqChunk];
  __shared__ int s_id[kSeqChunk];
  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) s_table[s] = table[s];
  for (int base = 0; base < m; base += kSeqChunk) {
    const int n = min(kSeqChunk, m - base);
    __syncthreads();  // the table is staged; the previous chunk is walked
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      s_slot[j] = slots[base + j];
      s_id[j] = ids[base + j];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n; ++j) {
        const int slot = s_slot[j];
        const bool in = in_table(slot, n_slots);
        const int cur = in ? s_table[slot] : 0;
        const bool ok = unconditional || cur == 0;
        if (ok && in) s_table[slot] = s_id[j];
        granted[base + j] = ok;
      }
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) out[s] = s_table[s];
}

// One thread per request of a chunk: m rounded up to a warp, at most 1024.
inline int request_threads(int m) {
  return m < kMaxRequests ? ((m + 31) / 32) * 32 : kMaxRequests;
}

}  // namespace

extern "C" {

const char* bravo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bravo_publish_multi(void* table, int n_slots, const void* rbias,
                        int n_locks, const void* slots, const void* lock_idx,
                        const void* ids, void* granted, int m, void* stream) {
  publish_multi_kernel<false>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots,
          static_cast<const int32_t*>(rbias), nullptr, n_locks,
          static_cast<const int32_t*>(slots),
          static_cast<const int32_t*>(lock_idx), 1,
          static_cast<const int32_t*>(ids), nullptr, 0,
          static_cast<bool*>(granted), m);
  return static_cast<int>(cudaGetLastError());
}

int bravo_acquire_hashed(void* table, int n_slots, const void* rbias,
                         const void* lock_vals, int n_locks,
                         const void* lock_idx, int lidx_stride,
                         const void* reader_ids, void* granted, int m,
                         void* stream) {
  publish_multi_kernel<true>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots,
          static_cast<const int32_t*>(rbias),
          static_cast<const int32_t*>(lock_vals), n_locks, nullptr,
          static_cast<const int32_t*>(lock_idx), lidx_stride, nullptr,
          reader_ids, 0, static_cast<bool*>(granted), m);
  return static_cast<int>(cudaGetLastError());
}

int bravo_publish(void* table, int n_slots, const void* rbias,
                  int check_rbias, int unconditional, const void* slots,
                  const void* ids, void* granted, int m, void* stream) {
  publish_kernel<false>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots,
          static_cast<const int32_t*>(rbias), check_rbias, unconditional,
          static_cast<const int32_t*>(slots),
          static_cast<const int32_t*>(ids), nullptr, 0, nullptr, 0, nullptr,
          0, nullptr, static_cast<bool*>(granted), m);
  return static_cast<int>(cudaGetLastError());
}

int bravo_release_hashed(void* table, int n_slots, const void* lock_vals,
                         int n_locks, const void* lock_idx, int lidx_stride,
                         const void* reader_ids, int reader_wide,
                         const void* mask, int m, void* stream) {
  publish_kernel<true>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots, nullptr, 0, 1, nullptr,
          nullptr, static_cast<const int32_t*>(lock_vals), n_locks,
          static_cast<const int32_t*>(lock_idx), lidx_stride, reader_ids,
          reader_wide, static_cast<const bool*>(mask), nullptr, m);
  return static_cast<int>(cudaGetLastError());
}

int bravo_publish_hashed(void* table, int n_slots, const void* rbias,
                         const void* lock_vals, int n_locks,
                         const void* lock_idx, int lidx_stride,
                         const void* reader_ids, int reader_wide,
                         void* granted, int m, void* stream) {
  publish_kernel<true>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots,
          static_cast<const int32_t*>(rbias), 1, 0, nullptr, nullptr,
          static_cast<const int32_t*>(lock_vals), n_locks,
          static_cast<const int32_t*>(lock_idx), lidx_stride, reader_ids,
          reader_wide, nullptr, static_cast<bool*>(granted), m);
  return static_cast<int>(cudaGetLastError());
}

int bravo_poll(const void* table, int n_slots, int lock_id, void* count,
               void* stream) {
  poll_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), n_slots, lock_id,
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

int bravo_multi_poll(const void* table, int n_slots, const void* lock_ids,
                     int k, void* counts, void* stream) {
  multi_poll_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), n_slots,
      static_cast<const int32_t*>(lock_ids), k,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

int bravo_scan(const void* table, int n_slots, int lock_id, void* mask,
               void* count, void* stream) {
  scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), n_slots, lock_id,
      static_cast<int8_t*>(mask), static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

int bravo_publish_seq(const void* table, int n_slots, void* out,
                      const void* slots, const void* ids, void* granted,
                      int m, int unconditional, void* stream) {
  const size_t smem = static_cast<size_t>(n_slots) * sizeof(int32_t);
  if (smem > kSeqDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        publish_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  publish_seq_kernel<<<1, kScanThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), n_slots,
      static_cast<int32_t*>(out), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(ids), static_cast<bool*>(granted), m,
      unconditional);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
