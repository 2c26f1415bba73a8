// Visible-readers-table kernels for Hopper (sm_90a): the BRAVO lease path.
//
// The table is one (rows, 128) int32 buffer of 4096 slots (16 KiB); a slot
// holds 0 or the value of the lock a reader published.  Four kernels:
//
//   K1 publish_multi  replaces repro/kernels/table_publish.py
//                     _fused_publish_multi_kernel (batched CAS 0 -> id, each
//                     request gated by its own lock's bias lane)
//   K2 publish        replaces repro/kernels/table_publish.py
//                     _fused_publish_kernel (one scalar bias; unconditional
//                     store = release)
//   K3 poll           replaces repro/kernels/table_scan.py _poll_kernel
//   K4 multi_poll     replaces repro/kernels/table_scan.py _multi_poll_kernel
//
// What bounds them on this card: nothing in the arithmetic.  Each call moves
// at most the 16 KiB table plus a few hundred bytes of request vectors, which
// is a few nanoseconds of HBM time at 3.35 TB/s; every call is bound by launch
// latency.  So each kernel is one CTA that holds all of its work: no grid-wide
// reduction, no second pass, no atomics in device memory, one launch per call.
//
// Design notes per kernel:
// * K1/K2 run one thread per request (M <= 1024).  The TPU kernel resolved
//   in-batch collisions with one-hot matmuls; here each thread scans the
//   earlier requests' slots in shared memory (O(M^2), M is a serving batch)
//   so the LOWEST index among attempting requests wins, exactly as a
//   sequential CAS loop would.  A bare atomicCAS race would pick a winner in
//   no fixed order.  All occupancy reads happen before the barrier and the
//   unique winners store after it, so every decision sees the table as it
//   was before the batch, as the TPU kernel's single table load did.
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
//
// Every entry point enqueues on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRequests = 1024;
constexpr int kMaxLocks = 128;
constexpr int kScanThreads = 1024;

// splitmix64 finalizer over (lock, reader), as repro.core.table.mix_hash:
// both ids are 32-bit values zero-extended to 64 bits.
__device__ __forceinline__ uint64_t mix_hash(uint32_t lock, uint32_t reader) {
  uint64_t x = static_cast<uint64_t>(lock) * 0x9E3779B97F4A7C15ull +
               static_cast<uint64_t>(reader) * 0xBF58476D1CE4E5B9ull;
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
// and id from lock_vals[lane] and reader_ids[i]; explicit mode reads them.
// `lane_ok` is false for a lane outside [0, n_locks).
template <bool kHashed>
__device__ __forceinline__ void load_request(
    int i, int n_slots, int n_locks, const int32_t* lock_vals,
    const int32_t* slots, const int32_t* lock_idx, int lidx_stride,
    const int32_t* ids, const int32_t* reader_ids, int* lane, bool* lane_ok,
    int* slot, int* id) {
  *lane = lock_idx == nullptr ? 0 : lock_idx[i * lidx_stride];
  *lane_ok = *lane >= 0 && *lane < n_locks;
  if (kHashed) {
    const int32_t val = *lane_ok ? lock_vals[*lane] : 0;
    const uint64_t h = mix_hash(static_cast<uint32_t>(val),
                                static_cast<uint32_t>(reader_ids[i]));
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
                     const int32_t* __restrict__ reader_ids,
                     bool* __restrict__ granted, int m) {
  __shared__ int s_slot[kMaxRequests];
  __shared__ int s_attempt[kMaxRequests];
  const int i = threadIdx.x;
  const bool active = i < m;
  int slot = -1, id = 0;
  bool attempt = false;
  bool win = false;
  if (active) {
    int lane;
    bool lane_ok;
    load_request<kHashed>(i, n_slots, n_locks, lock_vals, slots, lock_idx,
                          lidx_stride, ids, reader_ids, &lane, &lane_ok,
                          &slot, &id);
    attempt = lane_ok && rbias[lane] != 0;
    s_slot[i] = slot;
    s_attempt[i] = attempt;
  }
  __syncthreads();
  if (active && attempt) {
    bool first = true;
    for (int j = 0; j < i; ++j) {
      if (s_attempt[j] && s_slot[j] == slot) {
        first = false;
        break;
      }
    }
    const int cur = in_table(slot, n_slots) ? table[slot] : 0;
    win = first && cur == 0;
  }
  __syncthreads();  // every occupancy read lands before any store
  if (active) {
    if (win && in_table(slot, n_slots)) table[slot] = id;
    granted[i] = win;
  }
}

// K2: batched publish against one scalar bias.  The first request per slot
// (over all requests) wins; unless `unconditional`, only into a free slot;
// with `check_rbias`, only while *rbias != 0.  Hashed mode is the release:
// id 0 into each reader's slot, or slot -1 where mask[i] is false.
template <bool kHashed>
__global__ void __launch_bounds__(kMaxRequests)
publish_kernel(int32_t* __restrict__ table, int n_slots,
               const int32_t* __restrict__ rbias, int check_rbias,
               int unconditional, const int32_t* __restrict__ slots,
               const int32_t* __restrict__ ids,
               const int32_t* __restrict__ lock_vals, int n_locks,
               const int32_t* __restrict__ lock_idx, int lidx_stride,
               const int32_t* __restrict__ reader_ids,
               const bool* __restrict__ mask, bool* __restrict__ granted,
               int m) {
  __shared__ int s_slot[kMaxRequests];
  const int i = threadIdx.x;
  const bool active = i < m;
  int slot = -1, id = 0;
  bool win = false;
  if (active) {
    int lane;
    bool lane_ok;
    load_request<kHashed>(i, n_slots, n_locks, lock_vals, slots, lock_idx,
                          lidx_stride, ids, reader_ids, &lane, &lane_ok,
                          &slot, &id);
    if (kHashed) {
      id = 0;
      if (mask != nullptr && !mask[i]) slot = -1;
    }
    s_slot[i] = slot;
  }
  __syncthreads();
  if (active) {
    bool first = true;
    for (int j = 0; j < i; ++j) {
      if (s_slot[j] == slot) {
        first = false;
        break;
      }
    }
    win = first;
    if (!unconditional) {
      const int cur = in_table(slot, n_slots) ? table[slot] : 0;
      win = win && cur == 0;
    }
    if (check_rbias) win = win && *rbias != 0;
  }
  __syncthreads();  // every occupancy read lands before any store
  if (active) {
    if (win && in_table(slot, n_slots)) table[slot] = id;
    if (granted != nullptr) granted[i] = win;
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

inline int request_threads(int m) { return ((m + 31) / 32) * 32; }

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
          static_cast<const int32_t*>(ids), nullptr,
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
          static_cast<const int32_t*>(reader_ids),
          static_cast<bool*>(granted), m);
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
          nullptr, static_cast<bool*>(granted), m);
  return static_cast<int>(cudaGetLastError());
}

int bravo_release_hashed(void* table, int n_slots, const void* lock_vals,
                         int n_locks, const void* lock_idx, int lidx_stride,
                         const void* reader_ids, const void* mask, int m,
                         void* stream) {
  publish_kernel<true>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots, nullptr, 0, 1, nullptr,
          nullptr, static_cast<const int32_t*>(lock_vals), n_locks,
          static_cast<const int32_t*>(lock_idx), lidx_stride,
          static_cast<const int32_t*>(reader_ids),
          static_cast<const bool*>(mask), nullptr, m);
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

}  // extern "C"
