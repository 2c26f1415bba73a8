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
// What bounds them on this card: nothing in the arithmetic, and not the
// bytes.  Each call moves at most the 16 KiB table plus a few hundred bytes
// of request vectors, a few nanoseconds of HBM time at 3.35 TB/s.  So each
// call is one launch with no grid-wide reduction, no second pass and no
// atomics in device memory: one CTA, or (K4, K10) CTAs that each write
// only their own outputs.
//
// K1/K2, the lease acquire and release, are bound by DEPENDENT ROUND TRIPS
// to memory, not by bytes.  A request's lane (lock_idx[i]) gives its lock
// value and bias (lock_vals[lane], rbias[lane]), the value and the reader id
// its slot (the splitmix64 hash), the slot its occupancy (table[slot]):
// loads that each wait for the one before, then the store.  The tick's
// batch is 4-16 requests, one warp, and each trip to L2 is a latency that
// no parallel work hides.  The design (lease_kernel):
// * The first trip carries every input of the request, loaded
//   unconditionally (a thread past the batch loads request 0's and ignores
//   them), so no lane diverges around a load; each thread computes its
//   lane, id and slot once and keeps them in registers.
// * The occupancy read, design (a): gathered after the hash and issued
//   before the collision checks, so that its trip overlaps them.
// * In-batch collisions without block barriers.  The LOWEST index among
//   attempting requests wins each slot across the whole batch, exactly as a
//   sequential CAS loop would (a bare atomicCAS race would pick a winner in
//   no fixed order).  Within a warp, __match_any_sync over the slots, masked
//   by the ballot of attempting lanes, names the first lane of each slot;
//   across warps each warp writes its first lanes' slots to one shared list
//   and one barrier publishes it; a batch past 1024 requests runs in chunks
//   of 1024 and each chunk checks the lists of the chunks before it.  A
//   batch of at most 32 requests (the tick) crosses no __syncthreads.  The
//   hashed release stores 0 and grants nothing, so which of two requests
//   for one slot stores does not matter: it checks no collision.
// * Only a request that is first for its slot over the whole batch uses
//   that slot's occupancy, and only it stores there.  So no store of the
//   batch touches a slot before its read, in any order of warps or chunks:
//   every decision sees the table as it was before the batch, as the TPU
//   kernel's single table load did, without a block barrier between the
//   reads and the stores (a __syncwarp orders each warp's reads before its
//   stores).  A denied (unbiased) request attempts nothing and so shadows
//   no later request.
// Two alternatives were built and timed on the card against this design
// and dropped (PERF.md section 6): the bias lanes and lock values staged in
// shared memory within the first trip instead of gathered by lane (no
// faster at the tick and slower at larger batches: the first trip, with
// the lanes' loads in flight beside the request's own, took about as long
// as the gather it removed), and design (b), the table copied into shared
// memory by one bulk copy (cp.async.bulk on an mbarrier) at kernel entry
// instead of each slot's occupancy gathered (slower than (a) at every shape
// timed).
// With -DBRAVO_TABLE_PARENT=1 every entry point runs the parent design
// instead, for timing only: K1/K2 one thread per request, the trips in a
// row, each thread loading its request twice, three __syncthreads a chunk;
// K3 and K9 1024 threads of 4-byte loads (K9 one byte store a slot) and a
// two-level block sum; K4 the same CTA comparing every slot with each of
// at most 128 lock values staged in shared memory, one shared atomicAdd a
// match (it refuses more values, which would overrun its arrays); K10 the
// table staged in shared memory and walked in order by one thread (it
// refuses a table past 56,064 slots, which does not fit).
//
// Other notes:
// * The hashed entries fold the registry's splitmix64 slot hash and the
//   lock-value gather (lock_vals[lock_idx]) into the same launch, in native
//   uint64, so a lease acquire or release is one launch.
// * A slot outside [0, n_slots) matches no table entry: it reads as free and
//   stores nothing, like the TPU kernel's one-hot selectors.  The sign is
//   tested before any division or indexing (-1 / 128 == 0 in C).
// * K3, the writer's drain poll, returns the exact count, which meets the
//   TPU kernel's contract (exact when zero, a lower bound >= 1 otherwise);
//   the TPU version stopped early because its grid ran in order, which CTAs
//   do not.  What bounds it is one trip over the table and the reduction
//   after it, not the bytes (16 KiB is ~5 ns of HBM time).  poll_kernel
//   reads 16-byte groups of four slots, every load of a thread issued
//   before any is compared (a compile-time count a thread that covers 4096
//   slots in one trip, a loop beyond), sums with __reduce_add_sync and
//   crosses warps through one barrier.  Three layouts were timed at 4096
//   slots (PERF.md section 6): 8 warps of 4 loads a thread was fastest and
//   ships; 32 warps of 1 (a larger CTA) came second; one warp of 32 loads
//   (one scheduler issues every load and compare) was slowest.  Past 4096
//   slots the launcher takes 32 warps of 1 load a trip, which ran fastest
//   at 65,536 slots (8 warps loop four times as often there).  A table
//   whose data pointer is not 16-byte aligned (a view at an odd storage
//   offset) loads each group as four 4-byte loads.
// * K4, the exact hold counts of K lock values (any K >= 1, duplicates
//   and every int32 value included; 0 counts the free slots), is bound as
//   K3 is: a trip over the table and a reduction, not bytes.  In one CTA
//   it is bound by instructions too, since each slot is compared with
//   each value, so the values go to many SMs: K3's kernel in a grid of K
//   CTAs, CTA j counting lock_ids[j] into counts[j] over the whole table,
//   which is 16 KiB and stays in L2.  No atomics, no cross-CTA sum, one
//   launch at any K.  PERF.md section 6 has what it beat: all the values
//   in each thread's registers in one CTA (bound by one SM's instruction
//   rate: ~0.18 us a value at 4096 slots); 2, 4 or 8 values a CTA (slower
//   up to 256 values, ~0.1 us faster at 1000); a thread block cluster of 8
//   CTAs that split the table and summed in distributed shared memory
//   (~0.45 us of cluster overhead); and a hash of the values in shared
//   memory, a CTA a chunk of 1024 values (slower up to 1000 values on 4096
//   slots; faster only at K and table sizes no caller polls).
// * K9, the int8 match mask and its exact count, is K3's kernel with the
//   mask: each group of four slots stores its four mask bytes as one
//   4-byte word (the mask comes from the wrapper's torch.empty, so it is
//   aligned even where the table view is not), and the count sums as K3's.
// * The hashed K2 entries are the single-lock lease table's acquire
//   (conditional, under the scalar bias, id = the lock value) and the
//   release (unconditional, id 0, denied readers masked to slot -1).  They
//   take 32-bit reader ids or 64-bit ones (host ids up to 2**64 - 1, hashed
//   over all 64 bits as repro's host limbs are).
// * K10 keeps the TPU kernel's SEQUENTIAL semantics (its fori_loop over the
//   requests), which no parallel CAS race reproduces, and writes a NEW
//   table, as the TPU kernel copied its table block on every call.  Only
//   requests for one slot depend on each other, and for a slot s with
//   value t0 before the batch the loop's outcome has a closed form.
//   Conditional: request i is granted iff t0 == 0 and no earlier request
//   for s has a nonzero id (a publish of id 0 leaves the slot free), and s
//   ends as t0, or the first nonzero id for s when t0 == 0.
//   Unconditional: every request is granted and s ends as the LAST id for
//   s.  A slot outside [0, n_slots) is granted and stores nothing, as in
//   K1/K2.  So publish_seq_kernel resolves every request at once, like
//   lease_kernel: in its first trip each thread loads its request and its
//   16-byte groups of the table -> out copy, then gathers t0 from the INPUT
//   table, which no store touches; __match_any_sync masked by a ballot
//   gives the earlier nonzero (or later) requests for the slot within a
//   warp, one list a warp and one barrier across warps, and chunks of 1024
//   scan the earlier (or later) chunks' lists.  Exactly one request stores
//   each slot that changes (the first nonzero id where t0 == 0, or the last
//   request), and no decision reads `out`, so the one barrier that
//   publishes the lists also orders the copy before those stores.  The
//   copy is cut into slices, one a CTA (four 16-byte groups a thread):
//   every CTA makes every decision, since they depend only on the requests
//   and the input, and stores only those whose slot lies in its own slice,
//   after its own barrier, so no store races the copy without a grid
//   barrier; CTA 0 writes the grants.  What bounds it is two dependent
//   trips (the request, then t0) and the barrier, not the bytes.  No table
//   is staged, so K10 takes any table the other kernels take, and a large
//   table's copy runs on as many SMs as it has slices.
// * Two floors, one warp each, for timing K1/K2 against: load_floor (each
//   thread one load and one store) and chain_floor (two dependent loads and
//   a store, the least a gathered acquire can do).
//
// Every entry point enqueues on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef BRAVO_TABLE_PARENT
#define BRAVO_TABLE_PARENT 0
#endif

namespace {

constexpr int kMaxRequests = 1024;
constexpr int kScanThreads = 1024;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallTable = 4096;   // slots: the table every caller uses

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

#if BRAVO_TABLE_PARENT   // the parent designs of every entry, timing only

constexpr int kMaxLocks = 128;   // the parent K4's shared arrays

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

constexpr int kSeqChunk = 1024;   // K10 requests staged per pass
// K10's dynamic shared memory (the staged table) beyond which the kernel
// needs the opt-in attribute: 48 KiB per block less its static arrays; and
// the most it can have, 227 KiB less the same
constexpr size_t kSeqDefaultSmem = 48 * 1024 - 2 * kSeqChunk * sizeof(int);
constexpr size_t kSeqMaxSmem = 232448 - 2 * kSeqChunk * sizeof(int);

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

#else  // the designs for Hopper (see the note at the head)

constexpr int kMaxWarps = kMaxRequests / kWarp;

// Every argument of the five K1/K2 entry points.  K1 (kMulti): rbias is
// the (n_locks,) bias lane vector; K2: the scalar bias, read when
// check_rbias.  Hashed entries read lock_vals, lock_idx (stride 0: one lane
// for all), reader_ids and, for the release, mask; explicit ones slots and
// ids (K1 also lock_idx).  granted may be null (the release).
struct LeaseArgs {
  int32_t* table;
  int n_slots;
  const int32_t* rbias;
  int check_rbias;
  int unconditional;
  const int32_t* lock_vals;
  int n_locks;
  const int32_t* slots;
  const int32_t* ids;
  const int32_t* lock_idx;
  int lidx_stride;
  const void* reader_ids;
  int reader_wide;
  const bool* mask;
  bool* granted;
  int m;
};

// What request i loads from its own vectors: independent of every other
// load of the kernel.  The reader id stays in the width it was loaded in
// until it is hashed, so that no instruction waits for it sooner.
struct Inputs {
  int lane = 0;
  int32_t reader32 = 0;
  int64_t reader64 = 0;
  int slot = -1;
  int id = 0;
  bool keep = true;
};

// A request once its lane is resolved: its slot, the id it stores, and
// whether it attempts at all (K1: its lane is biased; K2: always).
struct Lease {
  int slot;
  int id;
  bool attempt;
};

// Every load is unconditional (a thread past the batch loads request 0's
// inputs and ignores them; the branches are uniform), so that no lane
// diverges around a load.
template <bool kHashed>
__device__ __forceinline__ Inputs load_inputs(const LeaseArgs& a, int i) {
  Inputs in;
  const int j = i < a.m ? i : 0;
  if (a.lock_idx != nullptr) in.lane = a.lock_idx[j * a.lidx_stride];
  if (kHashed) {
    if (a.reader_wide)
      in.reader64 = static_cast<const int64_t*>(a.reader_ids)[j];
    else
      in.reader32 = static_cast<const int32_t*>(a.reader_ids)[j];
    if (a.mask != nullptr) in.keep = a.mask[j];
  } else {
    in.slot = a.slots[j];
    in.id = a.ids[j];
  }
  return in;
}

// The request's lock value and bias, gathered from device memory by its
// lane (a load that waits for the lane's).
template <bool kMulti, bool kHashed>
__device__ __forceinline__ Lease resolve(const LeaseArgs& a,
                                         const Inputs& in, bool active) {
  Lease r{in.slot, in.id, false};
  const bool lane_ok = in.lane >= 0 && in.lane < a.n_locks;
  if (kHashed) {
    const int32_t val = lane_ok ? a.lock_vals[in.lane] : 0;
    const uint64_t reader =
        a.reader_wide
            ? static_cast<uint64_t>(in.reader64)
            : static_cast<uint64_t>(static_cast<uint32_t>(in.reader32));
    const uint64_t h = mix_hash(static_cast<uint32_t>(val), reader);
    r.slot = lane_ok ? static_cast<int>(h & static_cast<uint64_t>(
                                                a.n_slots - 1))
                     : -1;
    r.id = val;
    if (!kMulti && a.unconditional) {   // the release: store 0, and never
      r.id = 0;                          // into a denied reader's slot
      if (!in.keep) r.slot = -1;
    }
  }
  if (kMulti) {
    const int rb = lane_ok ? a.rbias[in.lane] : 0;
    r.attempt = active && rb != 0;
  } else {
    r.attempt = active;
  }
  return r;
}

// The slots of this warp's lanes where `flag` is set, to the shared list:
// row s_list[warp * 32, +32) holds the s_count[warp] slots, padded with the
// first of them, so that a scan compares whole 16-byte rows.
__device__ __forceinline__ void list_row(int slot, bool flag, int lane,
                                         int warp, int* s_list,
                                         int* s_count) {
  const unsigned below = (1u << lane) - 1u;
  const unsigned flags = __ballot_sync(kFull, flag);
  const int n = __popc(flags);
  const int pad = __shfl_sync(kFull, slot, flags ? __ffs(flags) - 1 : 0);
  int* row = s_list + warp * kWarp;
  if (flag) row[__popc(flags & below)] = slot;
  if (lane >= n) row[lane] = pad;
  if (lane == 0) s_count[warp] = n;
}

// This warp's attempting slots, each once (its lowest attempting lane),
// to the shared list (when `write`).  -> whether this lane is the first
// attempting lane of its slot in the warp.
__device__ __forceinline__ bool warp_list(const Lease& r, int lane, int warp,
                                          bool write, int* s_list,
                                          int* s_count) {
  const unsigned below = (1u << lane) - 1u;
  const unsigned same =
      __match_any_sync(kFull, r.slot) & __ballot_sync(kFull, r.attempt);
  const bool lead = r.attempt && (same & below) == 0;
  if (write) list_row(r.slot, lead, lane, warp, s_list, s_count);
  return lead;
}

// Whether any list of the warps in [from, to) holds `slot`: per warp, its
// count and eight 16-byte rows, all independent loads; a hit ends it.
__device__ __forceinline__ bool listed(int slot, int from, int to,
                                       const int* s_list,
                                       const int* s_count) {
  for (int w = from; w < to; ++w) {
    const int4* row = reinterpret_cast<const int4*>(s_list + w * kWarp);
    bool h = false;
#pragma unroll
    for (int q = 0; q < kWarp / 4; ++q) {
      const int4 v = row[q];
      h |= (v.x == slot) | (v.y == slot) | (v.z == slot) | (v.w == slot);
    }
    if (h && s_count[w] != 0) return true;
  }
  return false;
}

// K1 (kMulti) and K2, one thread per request of a chunk of 1024.  K1: CAS
// 0 -> id where the request's bias lane is set, lowest attempting index
// first per slot.  K2: the first request per slot (over all requests)
// stores; unless unconditional only into a free slot; with check_rbias only
// while *rbias != 0.
template <bool kMulti, bool kHashed>
__global__ void __launch_bounds__(kMaxRequests)
lease_kernel(const LeaseArgs a) {
  __shared__ __align__(16) int s_list[kMaxRequests];
  __shared__ int s_count[kMaxWarps];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n_warps = blockDim.x / kWarp;   // 1 for a batch of <= 32
  const bool conditional = kMulti || !a.unconditional;
  // the hashed release stores 0 and grants nothing: which of two requests
  // for one slot stores makes no difference, so it checks no collision
  const bool any_order = kHashed && !conditional && a.granted == nullptr;

  // the first trip: this thread's inputs and K2's scalar bias
  Inputs in = load_inputs<kHashed>(a, tid);
  const bool bias_ok = kMulti || !a.check_rbias || *a.rbias != 0;

  for (int base = 0; base < a.m; base += kMaxRequests) {
    const int i = base + tid;
    const bool active = i < a.m;
    if (base > 0) in = load_inputs<kHashed>(a, i);
    const Lease r = resolve<kMulti, kHashed>(a, in, active);
    // design (a): the occupancy read, issued here so that its trip overlaps
    // the collision checks; a request that is not first ignores it
    const bool reads =
        r.attempt && conditional && in_table(r.slot, a.n_slots);
    const int cur = reads ? a.table[r.slot] : 0;
    bool first = r.attempt;
    if (!any_order) {
      // the chunks before this one (batches past 1024 requests only)
      for (int b2 = 0; b2 < base; b2 += kMaxRequests) {
        const Lease e = resolve<kMulti, kHashed>(
            a, load_inputs<kHashed>(a, b2 + tid), true);
        __syncthreads();   // the scans of the previous list are done
        warp_list(e, lane, warp, true, s_list, s_count);
        __syncthreads();
        if (first) first = !listed(r.slot, 0, n_warps, s_list, s_count);
      }
      // this chunk: the lanes below in this warp, then the warps before it
      const bool multi = n_warps > 1;
      if (multi && base > 0) __syncthreads();
      first = warp_list(r, lane, warp, multi, s_list, s_count) && first;
      if (multi) {
        __syncthreads();
        if (first) first = !listed(r.slot, 0, warp, s_list, s_count);
      }
    }
    // only a request first for its slot over the batch uses its occupancy
    // (and only it stores there): every decision sees the table before the
    // batch
    bool win = first && bias_ok;
    if (win && reads) win = cur == 0;
    __syncwarp();   // this warp's occupancy reads before its first store
    if (active) {
      if (win && in_table(r.slot, a.n_slots)) a.table[r.slot] = r.id;
      if (a.granted != nullptr) a.granted[i] = win;
    }
  }
}

// Group g of four slots (slots 4g .. 4g + 3): one 16-byte access (kVec), or
// four 4-byte ones where the pointer is not 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ int4 load_group(const int32_t* p, int g) {
  if (kVec) return reinterpret_cast<const int4*>(p)[g];
  return make_int4(p[4 * g], p[4 * g + 1], p[4 * g + 2], p[4 * g + 3]);
}

template <bool kVec>
__device__ __forceinline__ void store_group(int32_t* p, int g, int4 v) {
  if (kVec) {
    reinterpret_cast<int4*>(p)[g] = v;
  } else {
    p[4 * g] = v.x;
    p[4 * g + 1] = v.y;
    p[4 * g + 2] = v.z;
    p[4 * g + 3] = v.w;
  }
}

// What one poll_kernel CTA computes: K3's count of lock_id; K9's count
// and match mask, one 4-byte word of four mask bytes a group (slot 4g + i
// in byte i); or, K4, CTA j's count of lock_ids[j] into
// count[j].
enum class Poll { kCount, kMask, kMulti };

// K3, K9 and K4: the exact count of slots equal to one lock
// value.  kWarps warps; each thread loads kLoads groups of four slots a
// trip, all before it compares any.
template <int kWarps, int kLoads, bool kVec, Poll kMode>
__global__ void __launch_bounds__(kWarps * kWarp)
poll_kernel(const int32_t* __restrict__ table, int n_slots, int32_t lock_id,
            const int32_t* __restrict__ lock_ids, uint32_t* __restrict__ mask,
            int32_t* __restrict__ count) {
  constexpr int kThreads = kWarps * kWarp;
  if constexpr (kMode == Poll::kMulti) lock_id = lock_ids[blockIdx.x];
  const int n_groups = n_slots / 4;   // tables are whole rows of 128 slots
  const int miss = ~lock_id;           // matches nothing
  int local = 0;
  for (int base = threadIdx.x; base < n_groups; base += kThreads * kLoads) {
    int4 v[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int g = base + q * kThreads;
      v[q] = g < n_groups ? load_group<kVec>(table, g)
                          : make_int4(miss, miss, miss, miss);
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      if constexpr (kMode == Poll::kMask) {
        const uint32_t hits = static_cast<uint32_t>(v[q].x == lock_id) |
                              static_cast<uint32_t>(v[q].y == lock_id) << 8 |
                              static_cast<uint32_t>(v[q].z == lock_id) << 16 |
                              static_cast<uint32_t>(v[q].w == lock_id) << 24;
        const int g = base + q * kThreads;
        if (g < n_groups) mask[g] = hits;
        local += __popc(hits);
      } else {
        local += (v[q].x == lock_id) + (v[q].y == lock_id) +
                 (v[q].z == lock_id) + (v[q].w == lock_id);
      }
    }
  }
  local = __reduce_add_sync(kFull, local);
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) s_warp[warp] = local;
  __syncthreads();
  if (warp == 0) {
    const int total =
        __reduce_add_sync(kFull, lane < kWarps ? s_warp[lane] : 0);
    if (lane == 0) count[kMode == Poll::kMulti ? blockIdx.x : 0] = total;
  }
}

// K10's copy of groups [g0, g1), out = table: kCopyGroups groups of four
// slots a thread a trip, every load of a trip issued before its stores.
// Each CTA copies one slice of kCopyGroups * blockDim.x groups in one trip.
constexpr int kCopyGroups = 4;

template <bool kVec>
__device__ __forceinline__ void copy_table(const int32_t* __restrict__ table,
                                           int32_t* __restrict__ out, int g0,
                                           int g1) {
  const int step = blockDim.x;
  for (int base = g0 + threadIdx.x; base < g1; base += kCopyGroups * step) {
    int4 v[kCopyGroups];
#pragma unroll
    for (int q = 0; q < kCopyGroups; ++q) {
      const int g = base + q * step;
      v[q] = g < g1 ? load_group<kVec>(table, g) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < kCopyGroups; ++q) {
      const int g = base + q * step;
      if (g < g1) store_group<kVec>(out, g, v[q]);
    }
  }
}

// Warps of a chunk of 32 * n_warps requests that hold any of the n left.
__device__ __forceinline__ int warps_holding(int n, int n_warps) {
  return min(n_warps, (n + kWarp - 1) / kWarp);
}

// K10: the TPU kernel's loop over the requests in order (`cur = t[slot];
// ok = unconditional || cur == 0; if (ok) t[slot] = id; granted[i] = ok`),
// resolved in parallel by its closed form (see the note at the head), into
// a NEW table `out`.  One thread per request of a chunk of blockDim.x.
// CTA b copies groups [b * slice, (b + 1) * slice) of the table, makes
// every decision, and stores only those whose slot lies in its slice; CTA
// 0 writes the grants.  The bound asks for one block of 1024 an SM, which
// leaves each thread 64 registers: held to the 32 of two such blocks,
// ptxas spilled the request's id to local memory in the first trip, and
// that store waited for the load before the copy's loads issued.
template <bool kVec>
__global__ void __launch_bounds__(kMaxRequests, 1)
publish_seq_kernel(const int32_t* __restrict__ table, int n_slots, int slice,
                   int32_t* __restrict__ out,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ ids,
                   bool* __restrict__ granted, int m, int unconditional) {
  __shared__ __align__(16) int s_list[kMaxRequests];
  __shared__ int s_count[kMaxWarps];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int chunk = blockDim.x, n_warps = chunk / kWarp;
  const unsigned below = (1u << lane) - 1u;
  const unsigned above = ~below & ~(1u << lane);
  // the first trip: this thread's request (request 0's past the batch), and
  // the copy's loads
  int slot = 0, id = 0;
  if (m > 0) {
    slot = slots[tid < m ? tid : 0];
    id = ids[tid < m ? tid : 0];
  }
  const int g0 = blockIdx.x * slice;
  copy_table<kVec>(table, out, g0, min(n_slots / 4, g0 + slice));

  for (int base = 0; base < m; base += chunk) {
    const int i = base + tid;
    const bool active = i < m;
    if (base > 0) {
      slot = slots[active ? i : 0];
      id = ids[active ? i : 0];
    }
    const bool in = active && in_table(slot, n_slots);
    // conditional: the slot's value before the batch, read from the input,
    // which no store touches
    const int t0 = !unconditional && in ? table[slot] : 0;
    // the requests the others look for: conditional, the nonzero ids (the
    // requests after one find its slot taken); unconditional, every request
    // in the table (it overwrites the stores of the requests before it)
    const bool lists = in && (unconditional || id != 0);
    const unsigned same =
        __match_any_sync(kFull, slot) & __ballot_sync(kFull, lists);
    // none before it in the warp (conditional), none after it (unconditional)
    bool decide = in && (same & (unconditional ? above : below)) == 0;
    const bool lead = lists && decide;   // this warp's list entry for the slot
    // the chunks before this one (conditional) or after it (unconditional)
    const int lo = unconditional ? base + chunk : 0;
    const int hi = unconditional ? m : base;
    for (int b2 = lo; b2 < hi; b2 += chunk) {
      const int j = b2 + tid;
      const int sj = slots[j < m ? j : 0];
      const int ij = ids[j < m ? j : 0];
      const bool lj = j < m && in_table(sj, n_slots) &&
                      (unconditional || ij != 0);
      __syncthreads();   // the scans of the previous list are done
      list_row(sj, lj, lane, warp, s_list, s_count);
      __syncthreads();
      if (decide)
        decide = !listed(slot, 0, warps_holding(m - b2, n_warps), s_list,
                         s_count);
    }
    // this chunk: the warps before this one (conditional), after it
    // (unconditional)
    if (base > 0 || lo < hi) __syncthreads();
    list_row(slot, lead, lane, warp, s_list, s_count);
    __syncthreads();   // the lists and, before the first stores, the copy
    if (decide)
      decide = unconditional
                   ? !listed(slot, warp + 1, warps_holding(m - base, n_warps),
                             s_list, s_count)
                   : !listed(slot, 0, warp, s_list, s_count);
    // decide: no request for the slot before this one has a nonzero id
    // (conditional), or none comes after it (unconditional)
    if (active) {
      const bool mine = in && slot / 4 >= g0 && slot / 4 < g0 + slice;
      if (mine && decide && (unconditional || (id != 0 && t0 == 0)))
        out[slot] = id;
      if (blockIdx.x == 0)
        granted[i] = !in || unconditional || (decide && t0 == 0);
    }
  }
}

#endif  // BRAVO_TABLE_PARENT

// A kernel that does nothing, launched as the scans are (one CTA of
// kScanThreads): its time in a graph replay is the floor under every table
// kernel's, the cost of a launch with no work.
__global__ void __launch_bounds__(kScanThreads) empty_kernel() {}

// One thread per request of a chunk: m rounded up to a warp, at most 1024.
inline int request_threads(int m) {
  return m < kMaxRequests ? ((m + 31) / 32) * 32 : kMaxRequests;
}


// The floors K1/K2 are timed against, one warp each: one global load and
// one store a thread; two dependent loads (vals[idx[t]]) and a store.
__global__ void __launch_bounds__(kWarp)
load_floor_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out) {
  out[threadIdx.x] = src[threadIdx.x];
}

__global__ void __launch_bounds__(kWarp)
chain_floor_kernel(const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ vals,
                   int32_t* __restrict__ out) {
  out[threadIdx.x] = vals[idx[threadIdx.x]];
}

#if !BRAVO_TABLE_PARENT
LeaseArgs lease_args(void* table, int n_slots, void* granted, int m) {
  LeaseArgs a{};
  a.table = static_cast<int32_t*>(table);
  a.n_slots = n_slots;
  a.granted = static_cast<bool*>(granted);
  a.m = m;
  return a;
}

template <bool kMulti, bool kHashed>
int launch_lease(const LeaseArgs& a, void* stream) {
  lease_kernel<kMulti, kHashed><<<1, request_threads(a.m), 0,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// K3 and K9 in one CTA, K4 in `blocks` (one a lock value), of kWarps warps.
template <int kWarps, int kLoads, Poll kMode>
int launch_poll(const void* table, int n_slots, int lock_id,
                const void* lock_ids, int blocks, void* mask, void* count,
                cudaStream_t stream) {
  const auto* t = static_cast<const int32_t*>(table);
  const auto* l = static_cast<const int32_t*>(lock_ids);
  auto* m = static_cast<uint32_t*>(mask);
  auto* c = static_cast<int32_t*>(count);
  constexpr int kThreads = kWarps * kWarp;
  if (aligned16(table))
    poll_kernel<kWarps, kLoads, true, kMode>
        <<<blocks, kThreads, 0, stream>>>(t, n_slots, lock_id, l, m, c);
  else
    poll_kernel<kWarps, kLoads, false, kMode>
        <<<blocks, kThreads, 0, stream>>>(t, n_slots, lock_id, l, m, c);
  return static_cast<int>(cudaGetLastError());
}

// K3's layouts by table size: 8 warps of 4 loads a trip up to 4096 slots,
// 32 of 1 past it.
template <Poll kMode>
int poll(const void* table, int n_slots, int lock_id, const void* lock_ids,
         int blocks, void* mask, void* count, cudaStream_t stream) {
  if (n_slots <= kSmallTable)
    return launch_poll<8, 4, kMode>(table, n_slots, lock_id, lock_ids,
                                    blocks, mask, count, stream);
  return launch_poll<32, 1, kMode>(table, n_slots, lock_id, lock_ids, blocks,
                                   mask, count, stream);
}

// K10's launch: one thread per request of a chunk (at least a warp), and
// the table cut into slices of kCopyGroups groups a thread, one a CTA.
struct SeqGrid {
  int threads, slice, blocks;
};

SeqGrid seq_grid(int m, int n_slots) {
  SeqGrid g;
  g.threads = m > kWarp ? request_threads(m) : kWarp;
  g.slice = g.threads * kCopyGroups;
  g.blocks = (n_slots / 4 + g.slice - 1) / g.slice;
  if (g.blocks < 1) g.blocks = 1;
  return g;
}
#endif

}  // namespace

extern "C" {

const char* bravo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bravo_publish_multi(void* table, int n_slots, const void* rbias,
                        int n_locks, const void* slots, const void* lock_idx,
                        const void* ids, void* granted, int m, void* stream) {
#if BRAVO_TABLE_PARENT
  publish_multi_kernel<false>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots,
          static_cast<const int32_t*>(rbias), nullptr, n_locks,
          static_cast<const int32_t*>(slots),
          static_cast<const int32_t*>(lock_idx), 1,
          static_cast<const int32_t*>(ids), nullptr, 0,
          static_cast<bool*>(granted), m);
  return static_cast<int>(cudaGetLastError());
#else
  LeaseArgs a = lease_args(table, n_slots, granted, m);
  a.rbias = static_cast<const int32_t*>(rbias);
  a.n_locks = n_locks;
  a.slots = static_cast<const int32_t*>(slots);
  a.lock_idx = static_cast<const int32_t*>(lock_idx);
  a.lidx_stride = 1;
  a.ids = static_cast<const int32_t*>(ids);
  return launch_lease<true, false>(a, stream);
#endif
}

int bravo_acquire_hashed(void* table, int n_slots, const void* rbias,
                         const void* lock_vals, int n_locks,
                         const void* lock_idx, int lidx_stride,
                         const void* reader_ids, void* granted, int m,
                         void* stream) {
#if BRAVO_TABLE_PARENT
  publish_multi_kernel<true>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots,
          static_cast<const int32_t*>(rbias),
          static_cast<const int32_t*>(lock_vals), n_locks, nullptr,
          static_cast<const int32_t*>(lock_idx), lidx_stride, nullptr,
          reader_ids, 0, static_cast<bool*>(granted), m);
  return static_cast<int>(cudaGetLastError());
#else
  LeaseArgs a = lease_args(table, n_slots, granted, m);
  a.rbias = static_cast<const int32_t*>(rbias);
  a.lock_vals = static_cast<const int32_t*>(lock_vals);
  a.n_locks = n_locks;
  a.lock_idx = static_cast<const int32_t*>(lock_idx);
  a.lidx_stride = lidx_stride;
  a.reader_ids = reader_ids;
  return launch_lease<true, true>(a, stream);
#endif
}

int bravo_publish(void* table, int n_slots, const void* rbias,
                  int check_rbias, int unconditional, const void* slots,
                  const void* ids, void* granted, int m, void* stream) {
#if BRAVO_TABLE_PARENT
  publish_kernel<false>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots,
          static_cast<const int32_t*>(rbias), check_rbias, unconditional,
          static_cast<const int32_t*>(slots),
          static_cast<const int32_t*>(ids), nullptr, 0, nullptr, 0, nullptr,
          0, nullptr, static_cast<bool*>(granted), m);
  return static_cast<int>(cudaGetLastError());
#else
  LeaseArgs a = lease_args(table, n_slots, granted, m);
  a.rbias = static_cast<const int32_t*>(rbias);
  a.check_rbias = check_rbias;
  a.unconditional = unconditional;
  a.slots = static_cast<const int32_t*>(slots);
  a.ids = static_cast<const int32_t*>(ids);
  return launch_lease<false, false>(a, stream);
#endif
}

int bravo_release_hashed(void* table, int n_slots, const void* lock_vals,
                         int n_locks, const void* lock_idx, int lidx_stride,
                         const void* reader_ids, int reader_wide,
                         const void* mask, int m, void* stream) {
#if BRAVO_TABLE_PARENT
  publish_kernel<true>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots, nullptr, 0, 1, nullptr,
          nullptr, static_cast<const int32_t*>(lock_vals), n_locks,
          static_cast<const int32_t*>(lock_idx), lidx_stride, reader_ids,
          reader_wide, static_cast<const bool*>(mask), nullptr, m);
  return static_cast<int>(cudaGetLastError());
#else
  LeaseArgs a = lease_args(table, n_slots, nullptr, m);
  a.unconditional = 1;
  a.lock_vals = static_cast<const int32_t*>(lock_vals);
  a.n_locks = n_locks;
  a.lock_idx = static_cast<const int32_t*>(lock_idx);
  a.lidx_stride = lidx_stride;
  a.reader_ids = reader_ids;
  a.reader_wide = reader_wide;
  a.mask = static_cast<const bool*>(mask);
  return launch_lease<false, true>(a, stream);
#endif
}

int bravo_publish_hashed(void* table, int n_slots, const void* rbias,
                         const void* lock_vals, int n_locks,
                         const void* lock_idx, int lidx_stride,
                         const void* reader_ids, int reader_wide,
                         void* granted, int m, void* stream) {
#if BRAVO_TABLE_PARENT
  publish_kernel<true>
      <<<1, request_threads(m), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(table), n_slots,
          static_cast<const int32_t*>(rbias), 1, 0, nullptr, nullptr,
          static_cast<const int32_t*>(lock_vals), n_locks,
          static_cast<const int32_t*>(lock_idx), lidx_stride, reader_ids,
          reader_wide, nullptr, static_cast<bool*>(granted), m);
  return static_cast<int>(cudaGetLastError());
#else
  LeaseArgs a = lease_args(table, n_slots, granted, m);
  a.rbias = static_cast<const int32_t*>(rbias);
  a.check_rbias = 1;
  a.lock_vals = static_cast<const int32_t*>(lock_vals);
  a.n_locks = n_locks;
  a.lock_idx = static_cast<const int32_t*>(lock_idx);
  a.lidx_stride = lidx_stride;
  a.reader_ids = reader_ids;
  a.reader_wide = reader_wide;
  return launch_lease<false, true>(a, stream);
#endif
}

int bravo_poll(const void* table, int n_slots, int lock_id, void* count,
               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#if BRAVO_TABLE_PARENT
  poll_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(table), n_slots, lock_id,
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
#else
  return poll<Poll::kCount>(table, n_slots, lock_id, nullptr, 1, nullptr,
                            count, s);
#endif
}

int bravo_multi_poll(const void* table, int n_slots, const void* lock_ids,
                     int k, void* counts, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#if BRAVO_TABLE_PARENT
  if (k > kMaxLocks)   // its shared arrays hold kMaxLocks values
    return static_cast<int>(cudaErrorInvalidValue);
  multi_poll_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(table), n_slots,
      static_cast<const int32_t*>(lock_ids), k,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
#else
  if (k <= 0) return static_cast<int>(cudaSuccess);
  return poll<Poll::kMulti>(table, n_slots, 0, lock_ids, k, nullptr, counts,
                            s);
#endif
}

int bravo_scan(const void* table, int n_slots, int lock_id, void* mask,
               void* count, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#if BRAVO_TABLE_PARENT
  scan_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(table), n_slots, lock_id,
      static_cast<int8_t*>(mask), static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
#else
  if (reinterpret_cast<uintptr_t>(mask) & 3)   // stored as 4-byte words
    return static_cast<int>(cudaErrorMisalignedAddress);
  return poll<Poll::kMask>(table, n_slots, lock_id, nullptr, 1, mask, count,
                           s);
#endif
}

int bravo_publish_seq(const void* table, int n_slots, void* out,
                      const void* slots, const void* ids, void* granted,
                      int m, int unconditional, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int32_t*>(table);
  auto* o = static_cast<int32_t*>(out);
  const auto* sl = static_cast<const int32_t*>(slots);
  const auto* id = static_cast<const int32_t*>(ids);
  auto* g = static_cast<bool*>(granted);
#if BRAVO_TABLE_PARENT
  const size_t smem = static_cast<size_t>(n_slots) * sizeof(int32_t);
  if (smem > kSeqMaxSmem)   // the staged table does not fit
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSeqDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        publish_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  publish_seq_kernel<<<1, kScanThreads, smem, s>>>(t, n_slots, o, sl, id, g,
                                                    m, unconditional);
#else
  const SeqGrid q = seq_grid(m, n_slots);
  if (aligned16(table) && aligned16(out))
    publish_seq_kernel<true><<<q.blocks, q.threads, 0, s>>>(
        t, n_slots, q.slice, o, sl, id, g, m, unconditional);
  else
    publish_seq_kernel<false><<<q.blocks, q.threads, 0, s>>>(
        t, n_slots, q.slice, o, sl, id, g, m, unconditional);
#endif
  return static_cast<int>(cudaGetLastError());
}

int bravo_empty(void* stream) {
  empty_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int bravo_load_floor(const void* src, void* out, void* stream) {
  load_floor_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int bravo_chain_floor(const void* idx, const void* vals, void* out,
                      void* stream) {
  chain_floor_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(vals),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
