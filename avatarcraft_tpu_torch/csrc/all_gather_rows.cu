// all_gather_rows: reassemble a row-sharded table, out = concat(shards, rows).
//
// Replaces the JAX package's one TPU kernel, parallel/ring.py:27
// _ring_all_gather_kernel (reached through ring_all_gather, pallas_call at
// ring.py:133): each device's [S, F] shard gathered into [n*S, F].
//
// Every shard lies on this card (on a host with several cards the same
// interface takes peer pointers), so the ring order, the entry barrier and
// the per-step acks of the TPU kernel have no job here: the kernel is a copy
// of n equal byte ranges into one. No flags, no spin-waits on other blocks,
// no dependence between blocks: the kernel cannot hang.
//
// Bound: bytes. On the main path (the 128^3 x 4 grid, [2,097,152, 4] f32) it
// reads 32 MiB and writes 32 MiB: 2 x 32 MiB / 3.35 TB/s ~= 20 us on an H100
// SXM at its 700 W limit. It does no arithmetic. What the design does about
// what held the first version (a direct grid-stride gather) back:
//
// - Shard pointers by value. The launch copies the host's n pointers into a
//   1 KB parameter table (at most kMaxShards = 128) that the kernel reads as
//   a __grid_constant__ argument. No block waits on a dependent load from
//   device memory before its first copy, and the wrapper makes no pinned
//   allocation and no host-to-device copy per call. Peer pointers of other
//   cards fit the same table.
// - One flat work space cut into whole waves. The output's n * shard_bytes
//   are cut into equal contiguous spans (multiples of 16 bytes), one for
//   each block, and the grid is one block per SM (the SM count read once per
//   device and cached): one full wave, whatever n is. A span that crosses a
//   shard boundary is split there.
// - TMA bulk copies for the aligned body. One thread of each block moves its
//   span through a ring of kStages shared-memory stages of kStageBytes:
//   cp.async.bulk global -> shared completing on the stage's mbarrier, then
//   cp.async.bulk shared -> global in a bulk group; a stage is loaded again
//   only after cp.async.bulk.wait_group.read says the store before it has
//   read it, so kStages - 1 loads stay in flight while the stores drain.
//   The ring's shape was swept on an H100 at 700 W (stage size and count,
//   blocks per SM, spans per block, an L2 evict-first hint on the reads):
//   the bytes in flight per SM decided it. 7 stages of 32 KB (224 KB, about
//   all a block may hold) at one block and one span per SM, some 29 MB in
//   flight over the card, beat the 4 x 32 KB starting point and torch.cat's
//   copy with the L2 cold; stages under 16 KB cost more (the one issuing
//   thread's work per byte grows); more blocks or more, smaller spans per SM
//   gained nothing; the evict-first hint made warm calls faster and cold ones
//   slower, and the paths find the table cold, so it is not used. PERF.md
//   section 6 has the times (chip_smoke.py).
// - The edges in the same kernel. Bulk copies need 16-byte-aligned addresses
//   and sizes. Where a piece's source and destination agree mod 16, the other
//   warps copy its head and tail bytes and the bulk engine the middle; where
//   they do not (6-byte rows, shards that start 6 bytes past a boundary), the
//   other warps copy the whole piece with plain loads and stores of the widest
//   width both addresses share.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers); bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxShards = 128;  // 1 KB of pointers in the parameter table
constexpr int kThreads = 256;    // warp 0: the bulk pipeline; warps 1-7: edges
constexpr int kEdgeThreads = kThreads - 32;
constexpr unsigned kStageBytes = 32768;
constexpr int kStages = 7;
constexpr int kSmemBytes = kStages * (kStageBytes + sizeof(uint64_t));  // stages, then their mbarriers
constexpr int kMaxDevices = 64;

struct ShardTable {
  const char* ptr[kMaxShards];
};

struct Plan {
  char* out;
  long long shard_bytes;
  long long total;  // n * shard_bytes
  long long span;   // output bytes per block, a multiple of 16
};

// The block's span of the output: [start, end).
struct Span {
  long long start, end;

  __device__ __forceinline__ explicit Span(const Plan& p) {
    start = static_cast<long long>(blockIdx.x) * p.span;
    end = start + p.span < p.total ? start + p.span : p.total;
  }
};

// The bytes of output [pos, end) that lie in one shard: the first piece.
struct Piece {
  const char* src;
  char* dst;
  long long len;
};

__device__ __forceinline__ Piece piece_at(const ShardTable& t, const Plan& p, long long pos,
                                          long long end) {
  const long long s = pos / p.shard_bytes;
  const long long off = pos - s * p.shard_bytes;
  const long long len = p.shard_bytes - off < end - pos ? p.shard_bytes - off : end - pos;
  return {t.ptr[s] + off, p.out + pos, len};
}

__device__ __forceinline__ bool bulk_ok(const Piece& c) {
  return ((reinterpret_cast<uintptr_t>(c.src) ^ reinterpret_cast<uintptr_t>(c.dst)) & 15) == 0;
}

// head: bytes before the first 16-byte boundary; body: the 16-byte multiple
// after it that the bulk engine copies (0 where the piece cannot be bulk
// copied); the tail is what is left.
__device__ __forceinline__ void split(const Piece& c, long long& head, long long& body) {
  if (!bulk_ok(c)) {
    head = c.len;
    body = 0;
    return;
  }
  head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(c.dst) & 15)) & 15);
  if (head > c.len) head = c.len;
  body = (c.len - head) & ~15LL;
}

// --- the bulk pipeline (one thread) ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const char* src, unsigned bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Waits for the phase of the given parity to complete. A load's bytes always
// arrive, but should one not, the kernel traps after 2^24 polls (a second or so)
// and the launch reports an error rather than holding the card.
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void bulk_store(char* dst, uint32_t src, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Walks the bulk bodies of the block's span in chunks of at most
// kStageBytes. The pipeline runs two of these: one for the loads, one,
// behind it, for the stores.
struct BulkCursor {
  Span span;
  long long pos;

  __device__ __forceinline__ explicit BulkCursor(const Plan& p) : span(p), pos(span.start) {}

  __device__ __forceinline__ bool next(const ShardTable& t, const Plan& p, const char*& src,
                                       char*& dst, unsigned& bytes) {
    while (pos < span.end) {
      const Piece c = piece_at(t, p, pos, span.end);
      long long head, body;
      split(c, head, body);
      if (body > 0) {
        bytes = body < kStageBytes ? static_cast<unsigned>(body) : kStageBytes;
        src = c.src + head;
        dst = c.dst + head;
        pos += head + bytes;
        return true;
      }
      pos += c.len;
    }
    return false;
  }
};

__device__ void bulk_pipeline(const ShardTable& t, const Plan& p, unsigned char* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bars + s)), "r"(1)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  BulkCursor loads(p), stores(p);
  const char* src;
  char* dst;
  unsigned bytes;
  long long issued = 0;
  for (; issued < kStages && loads.next(t, p, src, dst, bytes); ++issued) {
    bulk_load(smem_addr(smem + issued * kStageBytes), src, bytes, smem_addr(bars + issued));
  }
  for (long long k = 0; k < issued; ++k) {
    const int s = static_cast<int>(k % kStages);
    wait_parity(smem_addr(bars + s), static_cast<uint32_t>((k / kStages) & 1));
    stores.next(t, p, src, dst, bytes);
    bulk_store(dst, smem_addr(smem + s * kStageBytes), bytes);
    // refill the stage of store k - 1 once that store has read it
    if (k >= 1 && loads.next(t, p, src, dst, bytes)) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      const int r = static_cast<int>((k - 1) % kStages);
      bulk_load(smem_addr(smem + r * kStageBytes), src, bytes, smem_addr(bars + r));
      ++issued;
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// --- the edges (warps 1-7) --------------------------------------------------

template <typename T>
__device__ __forceinline__ void copy_elems(char* __restrict__ dst, const char* __restrict__ src,
                                           long long count, int tid) {
  T* d = reinterpret_cast<T*>(dst);
  const T* s = reinterpret_cast<const T*>(src);
  long long i = tid;
  for (; i + 3LL * kEdgeThreads < count; i += 4LL * kEdgeThreads) {
    const T a = s[i], b = s[i + kEdgeThreads], c = s[i + 2 * kEdgeThreads],
            e = s[i + 3 * kEdgeThreads];
    d[i] = a;
    d[i + kEdgeThreads] = b;
    d[i + 2 * kEdgeThreads] = c;
    d[i + 3 * kEdgeThreads] = e;
  }
  for (; i < count; i += kEdgeThreads) d[i] = s[i];
}

// len bytes with plain loads and stores, as wide as both addresses allow.
__device__ void copy_plain(char* dst, const char* src, long long len, int tid) {
  const uintptr_t both = reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst);
  const int width = (both & 7) == 0 ? 8 : (both & 3) == 0 ? 4 : (both & 1) == 0 ? 2 : 1;
  long long head = static_cast<long long>((width - (reinterpret_cast<uintptr_t>(dst) & (width - 1))) &
                                          (width - 1));
  if (head > len) head = len;
  const long long count = (len - head) / width;
  const long long tail = head + count * width;
  if (tid < head) dst[tid] = src[tid];
  if (tid < len - tail) dst[tail + tid] = src[tail + tid];
  switch (width) {
    case 8: copy_elems<uint2>(dst + head, src + head, count, tid); break;
    case 4: copy_elems<uint32_t>(dst + head, src + head, count, tid); break;
    case 2: copy_elems<uint16_t>(dst + head, src + head, count, tid); break;
    default: copy_elems<uint8_t>(dst + head, src + head, count, tid); break;
  }
}

__device__ void copy_edges(const ShardTable& t, const Plan& p, int tid) {
  const Span span(p);
  for (long long pos = span.start; pos < span.end;) {
    const Piece c = piece_at(t, p, pos, span.end);
    long long head, body;
    split(c, head, body);
    if (body == 0) {
      copy_plain(c.dst, c.src, c.len, tid);
    } else {
      if (tid < head) c.dst[tid] = c.src[tid];
      const long long tail = head + body;
      if (tid < c.len - tail) c.dst[tail + tid] = c.src[tail + tid];
    }
    pos += c.len;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    gather_rows_kernel(const __grid_constant__ ShardTable shards,
                       const __grid_constant__ Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x == 0) {
    bulk_pipeline(shards, plan, smem);
  } else if (threadIdx.x >= 32) {
    copy_edges(shards, plan, static_cast<int>(threadIdx.x) - 32);
  }
}

// per device: the SM count (0: not read yet), and whether the kernel has been
// allowed its shared memory
std::atomic<int> sm_count[kMaxDevices];
std::atomic<bool> smem_allowed[kMaxDevices];

}  // namespace

extern "C" {

// shard_ptrs: a host array of n (1 to 128) pointers, each to shard_bytes
// contiguous bytes on this card. out: n * shard_bytes bytes. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
int all_gather_rows(const void* const* shard_ptrs, int n, void* out, long long shard_bytes,
                    cudaStream_t stream) {
  if (shard_ptrs == nullptr || out == nullptr || n <= 0 || n > kMaxShards || shard_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ShardTable table{};
  for (int i = 0; i < n; ++i) table.ptr[i] = static_cast<const char*>(shard_ptrs[i]);
  const long long total = n * shard_bytes;
  if (total == 0) return static_cast<int>(cudaSuccess);

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = sm_count[dev].load();
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count[dev].store(sms);
  }
  if (!smem_allowed[dev].load()) {
    err = cudaFuncSetAttribute(gather_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[dev].store(true);
  }

  // one wave, one equal span per block; fewer blocks where there is less
  // than a stage of work for each
  long long blocks = sms;
  const long long by_stage = (total + kStageBytes - 1) / kStageBytes;
  if (blocks > by_stage) blocks = by_stage;
  const long long span = ((total + blocks - 1) / blocks + 15) & ~15LL;
  blocks = (total + span - 1) / span;
  const Plan plan{static_cast<char*>(out), shard_bytes, total, span};
  gather_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, stream>>>(table, plan);
  return static_cast<int>(cudaGetLastError());
}

const char* all_gather_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
