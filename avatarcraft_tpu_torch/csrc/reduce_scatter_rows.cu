// reduce_scatter_rows: the backward of the table all-gather,
// out_i[S, F] = sum_{r=0..m-1} ct_r[i*S:(i+1)*S, :] for i < n.
//
// Replaces the VJP of the JAX package's one TPU kernel, parallel/ring.py:27
// _ring_all_gather_kernel: ring_all_gather_grad (ring.py:153) pairs the
// Pallas ring forward with a psum_scatter backward (_ring_ag_bwd,
// ring.py:168-169): each device's shard gradient is its row block of the
// table's cotangent, summed over the replicas that gathered the table.
//
// Bound: bytes. It reads m*n*S*F*4 bytes and writes n*S*F*4, (m+1)*n*S*F*4
// in all: at m = 1 and the 128^3 x 4 grid table ([2,097,152, 4] f32) 2 x 32
// MiB, about 20 us at the H100 SXM's 3.35 TB/s; at the hash table
// ([6,119,857, 2]) about 29 us. Its (m-1)*n*S*F f32 adds are nothing beside
// that. On one card the trainer has one replica (m = 1), and the function
// is then a copy of one contiguous table into n row blocks: Tensor.clone
// computes it in one call.
//
// What held the first design back (a grid-stride loop over a grid.y of one
// row per output shard, up to 4,096 blocks of 256 threads each), so that it
// lost to Tensor.clone at the hash table:
//
// - An all-or-nothing vector path: float4 loads and stores only when every
//   pointer was 16-byte aligned and S*F a multiple of 4. The hash table's
//   12,239,714 floats (2 mod 4) went through 4-byte loads and stores.
// - One float4 per thread and loop trip through registers: little in
//   flight per SM.
// - 3.9 waves of blocks a shard at the grid table, with a ragged last wave,
//   and n times that for n shards.
//
// The design:
//
// - Pointers by value. The m + n pointers (at most kMaxTables) travel in a
//   1 KB __grid_constant__ table of the launch's parameters: the wrapper
//   makes no pinned allocation and no host-to-device copy, and a launch
//   captured into a CUDA graph holds its pointers in the graph itself.
// - Flat work, whatever the row width. Output shard s is the flat byte
//   range [s*S*F*4, (s+1)*S*F*4) of every input, so the work is the n*S*F*4
//   output bytes, cut into pieces of 16-byte multiples; a piece that
//   crosses a shard boundary is split there.
// - Widths decided per piece. The 16-byte-aligned middle of a piece takes
//   the wide path, its head and tail bytes 4-byte loads and stores; where
//   the addresses of a piece disagree mod 16, the whole piece takes the
//   widest width they all share.
// - The sum (reduce_scatter_rows_kernel_sum), for every m: a block of
//   kSumThreads threads a chunk of kSumChunkBytes, each thread 16 bytes of
//   it (one float4, two float2 or four floats, their loads issued before
//   its stores), the replicas added in replica order (r = 0, 1, ..., m-1)
//   in f32, the order of the plain version reduce_scatter_rows_plain, so the
//   two agree bit for bit (no FMA, no reassociation, no atomics); stores
//   are as wide as the loads. The block scheduler deals the chunks out.
// - The copy (reduce_scatter_rows_kernel_copy), m = 1 where every shard's
//   source and output agree mod 16 (the host reads this from the pointers):
//   a staged TMA bulk copy, the mirror of all_gather_rows.cu (one
//   contiguous source cut into n outputs here, n sources into one there).
//   One equal span per block, one block per SM (the SM count read once per
//   device and cached). One thread of each block moves the aligned middles
//   of its span through a ring of kStages shared-memory stages of
//   kStageBytes: cp.async.bulk global -> shared completing on the stage's
//   mbarrier, then shared -> global in a bulk group; a stage is loaded again
//   once cp.async.bulk.wait_group.read says the store before it has read it.
//   The second warp copies the head and tail bytes, fewer than 16 a piece.
//   Any other m = 1 call, whose pieces the bulk engine could not take
//   whole, goes to the sum kernel, which spreads them over the whole card.
//
// Measured on an H100 at 700 W (PERF.md section 6). A first sweep of this
// file's constants: the gather's 7 x 32 KB stages stayed best for the copy
// with the split into n outputs; for the sum, a block a chunk of a few KB
// beat both long contiguous runs a block and a wave of persistent blocks,
// and more than 16 bytes a thread, or loading several replicas before
// adding, gained nothing. chip_smoke.py's kernel phase on variants of this
// file in turns: the copy beats the sum at m = 1 by 5 % warm and 10 % cold
// at the 128^3 x 4 grid table and ties it at the hash table; a cotangent 4
// bytes off a boundary (four floats a thread) runs at 76 % of the bound,
// the first design at 62 %.
//
// One launch per call, of one of the two kernels (both named
// reduce_scatter_rows_kernel_*). No flags, no spin-waits on other blocks,
// no block waits on another: the kernel cannot hang; a lost mbarrier
// completion traps after 2^24 polls. The one-time set-up (the SM count, the
// copy's shared-memory attribute) is no stream operation and may run on a
// first call inside a CUDA graph's capture.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers); bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxTables = 128;  // m + n pointers: 1 KB of the launch's parameters
constexpr int kThreads = 64;     // the copy: warp 0 the bulk pipeline, warp 1 the edges
constexpr unsigned kStageBytes = 32768;
constexpr int kStages = 7;
constexpr int kSmemBytes = kStages * (kStageBytes + sizeof(uint64_t));  // stages, then their mbarriers
constexpr int kSumThreads = 256;     // the sum
constexpr int kSumChunkBytes = 4096;  // the sum's block: 16 bytes for each of its threads
constexpr int kMaxDevices = 64;

// ptr[0..m) are the cotangent tables, ptr[m + s] the output of shard s.
struct TableList {
  const char* ptr[kMaxTables];
};

struct Plan {
  long long shard_bytes;
  long long total;  // n * shard_bytes
  long long span;   // output bytes per block of the copy, a multiple of 16
  int m;
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
// Its sources are ptr[r] + pos, its output dst.
struct Piece {
  long long pos;
  char* dst;
  long long len;
};

__device__ __forceinline__ Piece piece_at(const TableList& t, const Plan& p, long long pos, long long end) {
  const long long s = p.total == p.shard_bytes ? 0 : pos / p.shard_bytes;  // one shard: no division
  const long long off = pos - s * p.shard_bytes;
  const long long len = p.shard_bytes - off < end - pos ? p.shard_bytes - off : end - pos;
  return {pos, const_cast<char*>(t.ptr[p.m + s]) + off, len};
}

// The widest of 16, 8 and 4 bytes that every source and the output of the
// piece share mod 16 (every address is a multiple of 4: f32 tables).
__device__ __forceinline__ int piece_width(const TableList& t, const Plan& p, const Piece& c) {
  uintptr_t both = 0;
  for (int r = 0; r < p.m; ++r) {
    both |= reinterpret_cast<uintptr_t>(t.ptr[r] + c.pos) ^ reinterpret_cast<uintptr_t>(c.dst);
  }
  return (both & 15) == 0 ? 16 : (both & 7) == 0 ? 8 : 4;
}

// head: bytes before the output's first boundary of `width` bytes; body:
// the multiple of `width` after it; the tail is what is left.
__device__ __forceinline__ void split(const Piece& c, int width, long long& head, long long& body) {
  head = static_cast<long long>((width - (reinterpret_cast<uintptr_t>(c.dst) & (width - 1))) & (width - 1));
  if (head > c.len) head = c.len;
  body = (c.len - head) & ~static_cast<long long>(width - 1);
}

// --- m = 1: the bulk pipeline (one thread) ----------------------------------

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

// Walks the 16-byte-aligned bodies of the block's span in chunks of at most
// kStageBytes. The pipeline runs two of these: one for the loads, one,
// behind it, for the stores.
struct BulkCursor {
  Span span;
  long long pos;

  __device__ __forceinline__ explicit BulkCursor(const Plan& p) : span(p), pos(span.start) {}

  __device__ __forceinline__ bool next(const TableList& t, const Plan& p, const char*& src, char*& dst,
                                       unsigned& bytes) {
    while (pos < span.end) {
      const Piece c = piece_at(t, p, pos, span.end);
      long long head, body;
      split(c, 16, head, body);
      if (body > 0) {
        bytes = body < kStageBytes ? static_cast<unsigned>(body) : kStageBytes;
        src = t.ptr[0] + c.pos + head;
        dst = c.dst + head;
        pos += head + bytes;
        return true;
      }
      pos += c.len;
    }
    return false;
  }
};

__device__ void bulk_pipeline(const TableList& t, const Plan& p, unsigned char* smem) {
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

// --- m = 1: the edges (warp 1) -------------------------------------------------

// The head and tail bytes of each piece, fewer than 16 each: every piece's
// source and output agree mod 16, so the bulk pipeline takes the rest.
__device__ void copy_edges(const TableList& t, const Plan& p, int tid) {
  const Span span(p);
  for (long long pos = span.start; pos < span.end;) {
    const Piece c = piece_at(t, p, pos, span.end);
    const char* src = t.ptr[0] + c.pos;
    long long head, body;
    split(c, 16, head, body);
    if (tid < head) c.dst[tid] = src[tid];
    const long long tail = head + body;
    if (tid < c.len - tail) c.dst[tail + tid] = src[tail + tid];
    pos += c.len;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    reduce_scatter_rows_kernel_copy(const __grid_constant__ TableList tables, const __grid_constant__ Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x == 0) {
    bulk_pipeline(tables, plan, smem);
  } else if (threadIdx.x >= 32) {
    copy_edges(tables, plan, static_cast<int>(threadIdx.x) - 32);
  }
}

// --- the sum: in-order sums ----------------------------------------------------

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float2& a, const float2& b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// count vectors of type V from byte `pos` of every source, summed in
// replica order into dst, by the block's threads. A thread takes 16 bytes a
// trip, one float4, two float2 or four floats, and issues their loads
// before it stores any: narrow vectors keep as many bytes in flight as wide.
template <typename V>
__device__ __forceinline__ void sum_vectors(const TableList& t, int m, long long pos, char* dst, long long count) {
  constexpr int kPer = 16 / sizeof(V);
  const V* src0 = reinterpret_cast<const V*>(t.ptr[0] + pos);
  V* out = reinterpret_cast<V*>(dst);
  long long i = threadIdx.x;
  for (; i + (kPer - 1) * kSumThreads < count; i += kPer * kSumThreads) {
    V acc[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) acc[u] = __ldg(src0 + i + u * kSumThreads);
    for (int r = 1; r < m; ++r) {
      const V* src = reinterpret_cast<const V*>(t.ptr[r] + pos);
      V v[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) v[u] = __ldg(src + i + u * kSumThreads);
#pragma unroll
      for (int u = 0; u < kPer; ++u) add_to(acc[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) out[i + u * kSumThreads] = acc[u];
  }
  for (; i < count; i += kSumThreads) {
    V acc = __ldg(src0 + i);
    for (int r = 1; r < m; ++r) add_to(acc, __ldg(reinterpret_cast<const V*>(t.ptr[r] + pos) + i));
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kSumThreads)
    reduce_scatter_rows_kernel_sum(const __grid_constant__ TableList tables, const __grid_constant__ Plan plan) {
  const long long start = static_cast<long long>(blockIdx.x) * kSumChunkBytes;
  const long long end = start + kSumChunkBytes < plan.total ? start + kSumChunkBytes : plan.total;
  for (long long pos = start; pos < end;) {
    const Piece c = piece_at(tables, plan, pos, end);
    const int width = piece_width(tables, plan, c);
    long long head, body;
    split(c, width, head, body);
    switch (width) {
      case 16: sum_vectors<float4>(tables, plan.m, c.pos + head, c.dst + head, body / 16); break;
      case 8: sum_vectors<float2>(tables, plan.m, c.pos + head, c.dst + head, body / 8); break;
      default: sum_vectors<float>(tables, plan.m, c.pos + head, c.dst + head, body / 4); break;
    }
    // the head's and the tail's floats, fewer than 4 each
    const long long tail = head + body;
    const int k = static_cast<int>(threadIdx.x);
    if (k < 8) {
      const long long at = k < 4 ? 4LL * k : tail + 4LL * (k - 4);
      if ((k < 4 && at < head) || (k >= 4 && at < c.len)) {
        float acc = __ldg(reinterpret_cast<const float*>(tables.ptr[0] + c.pos + at));
        for (int r = 1; r < plan.m; ++r) acc += __ldg(reinterpret_cast<const float*>(tables.ptr[r] + c.pos + at));
        *reinterpret_cast<float*>(c.dst + at) = acc;
      }
    }
    pos += c.len;
  }
}

// per device: the SM count (0: not read yet), and whether the copy kernel
// has been allowed its shared memory
std::atomic<int> sm_count[kMaxDevices];
std::atomic<bool> smem_allowed[kMaxDevices];

// Reads what the copy's launch needs of the device once.
cudaError_t device_setup(int dev) {
  if (sm_count[dev].load() == 0) {
    int sms = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev].store(sms);
  }
  if (!smem_allowed[dev].load()) {
    const cudaError_t err = cudaFuncSetAttribute(reduce_scatter_rows_kernel_copy,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_allowed[dev].store(true);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// ptrs: a host array of m + n pointers (at most 128) on this card: the m
// cotangent tables, each of n * rows_per_shard * cols contiguous floats,
// then the n outputs, each of rows_per_shard * cols floats. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
int reduce_scatter_rows(const void* const* ptrs, int m, int n, long long rows_per_shard, long long cols,
                        cudaStream_t stream) {
  if (ptrs == nullptr || m <= 0 || n <= 0 || m + n > kMaxTables || rows_per_shard < 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TableList tables{};
  for (int i = 0; i < m + n; ++i) {
    tables.ptr[i] = static_cast<const char*>(ptrs[i]);
    // f32 tables: every piece's width is at least 4 bytes
    if ((reinterpret_cast<uintptr_t>(ptrs[i]) & 3) != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long shard_bytes = rows_per_shard * cols * 4;
  if (shard_bytes == 0) return static_cast<int>(cudaSuccess);
  const long long total = n * shard_bytes;

  // the copy only where every shard's source and output agree mod 16: the
  // bulk engine then takes all but fewer than 16 bytes at each end of a piece
  bool bulk = m == 1;
  for (int s = 0; bulk && s < n; ++s) {
    const uintptr_t src = reinterpret_cast<uintptr_t>(ptrs[0]) + s * shard_bytes;
    bulk = ((src ^ reinterpret_cast<uintptr_t>(ptrs[1 + s])) & 15) == 0;
  }
  if (!bulk) {
    // a block a chunk, the block scheduler dealing them out
    const long long blocks = (total + kSumChunkBytes - 1) / kSumChunkBytes;
    const Plan plan{shard_bytes, total, 0, m};
    reduce_scatter_rows_kernel_sum<<<static_cast<unsigned>(blocks), kSumThreads, 0, stream>>>(tables, plan);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  err = device_setup(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave, one equal span per block; fewer blocks where there is less
  // than a stage of work for each
  long long blocks = sm_count[dev].load();
  const long long by_stage = (total + kStageBytes - 1) / kStageBytes;
  if (blocks > by_stage) blocks = by_stage;
  const long long span = ((total + blocks - 1) / blocks + 15) & ~15LL;
  blocks = (total + span - 1) / span;
  const Plan plan{shard_bytes, total, span, 1};
  reduce_scatter_rows_kernel_copy<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, stream>>>(tables, plan);
  return static_cast<int>(cudaGetLastError());
}

const char* reduce_scatter_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
