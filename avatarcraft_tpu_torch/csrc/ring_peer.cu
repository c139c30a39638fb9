// ring_peer: the table all-gather and its reduce-scatter backward across
// ranks (processes, or streams of one process), and an all-reduce, on peer
// memory.
//
// Replaces the JAX package's one TPU kernel across devices,
// parallel/ring.py:27 _ring_all_gather_kernel (reached through
// ring_all_gather, pallas_call at ring.py:133): each device's [S, F] shard
// gathered into [n*S, F] behind an entry barrier (ring.py:49-64), through a
// staging buffer that the neighbour writes by remote DMA (ring.py:86-95,
// 138-144), with acks so that no slot is reused before its reader is done
// (ring.py:79-84, 106-110). And its VJP, ring_all_gather_grad /
// _ring_ag_bwd = lax.psum_scatter (ring.py:153, 168-169): each device's
// block of the sum over devices of the [n*S, F] cotangent.
//
// The all-reduce replaces no TPU kernel: it stands where XLA inserts the
// gradient psum of a data-parallel step (workloads/reconstruct.py:12-13),
// so that a CUDA graph can hold the step of a mesh of ranks.
//
// Buffers. Each rank owns one symmetric buffer per (group, kind, size): a
// header, then the data: for the gather and the reduce-scatter two slots
// of the staged input, used in turn (slot seq % 2); for the all-reduce the
// input's n blocks, then one block for this rank's block of the sum. It is
// allocated here with cudaMalloc (an IPC
// handle names a whole allocation, and the pointers must not move),
// exported with cudaIpcGetMemHandle and opened by every other rank with
// cudaIpcOpenMemHandle; ranks that are streams of one process use the
// pointers as they are. The n base pointers travel by value in the launch's
// parameters, as all_gather_rows passes its shards, so a CUDA graph holds
// everything a call reads.
//
// One call is ONE launch of peer_kernel and no host step: the C functions
// launch and return cudaGetLastError(), nothing more. Its protocol, whose
// Python model is avatarcraft_tpu_torch/parallel/peer_model.py (held under
// random interleavings of 2 to 4 ranks by tests/test_torch_peer_model.py):
//  0. seq = calls + 1, where calls is this rank's call count in its own
//     header. The host passes no sequence number: a replayed graph
//     continues the count, and eager calls mixed with replays agree.
//  1. stage (gather, reduce-scatter): every block waits until done[p] >=
//     seq - 2 for every p in this rank's header (p has finished reading
//     this slot's previous contents, of call seq - 2: the TPU kernel's
//     acks), then copies its part of the input into slot seq % 2. The
//     all-reduce stages nothing: its caller wrote the input into the
//     buffer's first n blocks before the call.
//  2. entry barrier: a grid-wide count (arrived); the block that arrives
//     last sets ready[me] = seq in every rank's header. Every block then
//     waits until ready[p] >= seq for every p.
//  3. body: the gather copies each rank's shard to its rows of the output;
//     the reduce-scatter adds block `me` of the n ranks' data in rank order
//     (p = 0, 1, ..., n-1) in f32, the order of the plain version, into the
//     output. The all-reduce adds the same way into this rank's sum block;
//     the grid count again, the last block sets reduced[me] = seq
//     everywhere, every block waits for reduced[p] >= seq and copies rank
//     p's sum block to block p of the output (two-shot: every rank ends
//     with the same bits).
//  4. exit: the grid count; the last block sets done[me] = seq in every
//     rank's header, resets the count and sets calls = seq.
// Why no wait goes further: ready[p] >= seq means p's kernel of call seq
// has started, so p's kernel of call seq - 1 (the same buffer, the same
// stream order) has ended, done[p] >= seq - 1 with it. So a stage's ack
// wait is met once its previous call passed its entry barrier (the slot it
// writes was last read in call seq - 2), and a peer has read an
// all-reduce's input blocks once it set reduced[p]: when the call ends the
// caller may write the next input, and the sum block is rewritten only
// after the next entry barrier. The model checks these orders.
// A grid-wide count only works if every block of the grid is resident
// while others wait, and the n ranks' kernels wait on each other: the grid
// is persistent, at most cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// the SMs / the ranks that share the card, with grid-stride loops.
// Flags are written with st.release.sys after __threadfence_system() and
// read with ld.acquire.sys; the data with ld.global.cg (L2, not L1). A wait
// polls with __nanosleep and gives up after kWaitNs of %globaltimer: the
// kernel then sets a sticky error word in mapped host memory, every later
// wait gives up within kErrPolls polls (so the call ends, with wrong data,
// instead of hanging), and the host reads the word after a step, a replay
// or a check (ring_peer_error) and raises with ring_peer_error_string's
// text. Only the host clears it.
//
// Bound: bytes. Over all n ranks through one HBM, each input read once and
// each output written once: the gather (n + n^2) S F 4, the reduce-scatter
// (n^2 + n) S F 4, the all-reduce 2 n N 4. The design adds the staging copy
// (a read and a write of each input) to the gather and the reduce-scatter,
// and the all-reduce's sum block (written, then read by every rank).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers); bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 64;
constexpr long long kHeaderBytes = 4096;  // the flags, then the data (16-byte aligned)
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr unsigned long long kWaitNs = 20ull * 1000 * 1000 * 1000;  // 20 s
constexpr int kPeerTimeout = 2000;  // above every cudaError_t
constexpr unsigned kErrPolls = 4096;

enum Op : int { kGather = 0, kReduceScatter = 1, kAllReduce = 2 };
enum Flag : int { kReady = 0, kReduced = 1, kDone = 2 };

struct Header {
  unsigned long long ready[kMaxRanks];    // ready[p] = seq: rank p's input of call seq is in p's buffer
  unsigned long long reduced[kMaxRanks];  // reduced[p] = seq: block p of the all-reduce's sum is in p's buffer
  unsigned long long done[kMaxRanks];     // done[p] = seq: rank p has read every buffer of call seq
  unsigned long long calls;               // the calls this rank has completed on this buffer
  unsigned int arrived;                   // this rank's blocks past the grid-wide counts of the current call
};
static_assert(sizeof(Header) <= kHeaderBytes, "header too large");

// the n ranks' buffers (header, then data), as mapped in this process
struct Peers {
  char* base[kMaxRanks];
};

struct Call {
  const char* src;        // the input to stage into this rank's buffer (gather, reduce-scatter)
  char* out;              // this rank's output
  long long bytes;        // gather: a shard's bytes; reduce-scatter, all-reduce: a block's floats
  long long out_elems;    // all-reduce: the output's floats (the n blocks' padding is never written out)
  int n, me, op;
  int* err;               // the sticky error word (mapped host memory)
};

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ Header* header(const Peers& peers, int p) {
  return reinterpret_cast<Header*>(peers.base[p]);
}

__device__ __forceinline__ char* data(const Peers& peers, int p) { return peers.base[p] + kHeaderBytes; }

// where the input of call seq lies in each buffer's data: the gather's and
// the reduce-scatter's slot seq % 2, the all-reduce's one input region
__device__ __forceinline__ long long input_offset(const Call& c, unsigned long long seq) {
  const long long slot = c.op == kGather ? c.bytes : c.op == kReduceScatter ? c.n * c.bytes * 4 : 0;
  return static_cast<long long>(seq & 1ull) * slot;
}

__device__ __forceinline__ unsigned long long* flags(Header* h, int which) {
  return which == kReady ? h->ready : which == kReduced ? h->reduced : h->done;
}

// One thread waits until f[p] >= target for every p < n. Past kWaitNs it
// sets the error word; once the word is set (by this call or an earlier
// one) it gives up within kErrPolls polls. The word lives in host memory,
// so it is read only every kErrPolls polls.
__device__ void wait_flags(const unsigned long long* f, int n, unsigned long long target, int* err) {
  const unsigned long long t0 = global_ns();
  unsigned polls = 0;
  for (int p = 0; p < n; ++p) {
    while (load_acquire(f + p) < target) {
      if (++polls % kErrPolls == 0 && *reinterpret_cast<volatile int*>(err) != 0) return;
      if (global_ns() - t0 > kWaitNs) {
        atomicExch(err, kPeerTimeout);
        return;
      }
      __nanosleep(256);
    }
  }
}

// Thread 0 of the block waits (wait_flags); every thread leaves together.
__device__ void block_wait(const unsigned long long* f, int n, unsigned long long target, int* err) {
  if (threadIdx.x == 0) wait_flags(f, n, target, err);
  __syncthreads();
}

// The grid-wide count: every block calls it once per step, after its work;
// true in the block that arrives last (the count then reaches `target`),
// once every block's writes are visible system-wide.
__device__ bool arrive(Header* mine, unsigned target) {
  __shared__ int last;
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&mine->arrived, 1u) == target - 1;
    if (last) __threadfence_system();
  }
  __syncthreads();
  return last != 0;
}

// flag slot `me` of kind `which` set to seq in every rank's header (thread 0)
__device__ void publish(const Peers& peers, int n, int me, int which, unsigned long long seq) {
  for (int p = 0; p < n; ++p) store_release(flags(header(peers, p), which) + me, seq);
}

template <typename T>
__device__ __forceinline__ void copy_as(char* dst, const char* src, long long bytes, long long tid,
                                        long long stride) {
  T* d = reinterpret_cast<T*>(dst);
  const T* s = reinterpret_cast<const T*>(src);
  const long long count = bytes / static_cast<long long>(sizeof(T));
  for (long long i = tid; i < count; i += stride) d[i] = __ldcg(s + i);
}

// bytes from src to dst by the whole grid, as wide as both addresses and the
// length allow
__device__ void grid_copy(char* dst, const char* src, long long bytes) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uintptr_t all = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                        static_cast<uintptr_t>(bytes);
  if ((all & 15) == 0) {
    copy_as<uint4>(dst, src, bytes, tid, stride);
  } else if ((all & 7) == 0) {
    copy_as<uint2>(dst, src, bytes, tid, stride);
  } else if ((all & 3) == 0) {
    copy_as<unsigned int>(dst, src, bytes, tid, stride);
  } else {
    copy_as<unsigned char>(dst, src, bytes, tid, stride);
  }
}

// out[i] = sum over p = 0..n-1, in that order, of block `me` of rank p's
// input (at `in` bytes into its data), for the block's `elems` floats
__device__ void grid_reduce(const Peers& peers, int n, int me, long long in, float* out, long long elems) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long offset = static_cast<long long>(me) * elems;
  if ((elems & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < elems / 4; i += stride) {
      float4 acc = __ldcg(reinterpret_cast<const float4*>(data(peers, 0) + in) + offset / 4 + i);
      for (int p = 1; p < n; ++p) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(data(peers, p) + in) + offset / 4 + i);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      out4[i] = acc;
    }
  } else {
    for (long long i = tid; i < elems; i += stride) {
      float acc = __ldcg(reinterpret_cast<const float*>(data(peers, 0) + in) + offset + i);
      for (int p = 1; p < n; ++p) acc += __ldcg(reinterpret_cast<const float*>(data(peers, p) + in) + offset + i);
      out[i] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads) peer_kernel(const __grid_constant__ Peers peers,
                                                        const __grid_constant__ Call c) {
  Header* mine = header(peers, c.me);
  const unsigned long long seq = *reinterpret_cast<volatile unsigned long long*>(&mine->calls) + 1;
  const long long in = input_offset(c, seq);
  unsigned target = gridDim.x;
  // 1. stage
  if (c.src != nullptr) {
    block_wait(mine->done, c.n, seq > 2 ? seq - 2 : 0, c.err);
    const long long stage = c.op == kGather ? c.bytes : static_cast<long long>(c.n) * c.bytes * 4;
    grid_copy(data(peers, c.me) + in, c.src, stage);
  }
  // 2. entry barrier
  if (arrive(mine, target) && threadIdx.x == 0) publish(peers, c.n, c.me, kReady, seq);
  block_wait(mine->ready, c.n, seq, c.err);
  // 3. body
  if (c.op == kGather) {
    for (int p = 0; p < c.n; ++p) grid_copy(c.out + p * c.bytes, data(peers, p) + in, c.bytes);
  } else if (c.op == kReduceScatter) {
    grid_reduce(peers, c.n, c.me, in, reinterpret_cast<float*>(c.out), c.bytes);
  } else {
    const long long block = c.bytes, sum = c.n * block * 4;  // the sum block follows the n input blocks
    grid_reduce(peers, c.n, c.me, in, reinterpret_cast<float*>(data(peers, c.me) + sum), block);
    target += gridDim.x;
    if (arrive(mine, target) && threadIdx.x == 0) publish(peers, c.n, c.me, kReduced, seq);
    block_wait(mine->reduced, c.n, seq, c.err);
    for (int p = 0; p < c.n; ++p) {
      const long long first = p * block;
      const long long count = c.out_elems - first < block ? c.out_elems - first : block;
      if (count > 0) grid_copy(c.out + first * 4, data(peers, p) + sum, count * 4);
    }
  }
  // 4. exit
  target += gridDim.x;
  if (arrive(mine, target) && threadIdx.x == 0) {
    publish(peers, c.n, c.me, kDone, seq);
    mine->arrived = 0;  // the next kernel of this stream starts after this one
    *reinterpret_cast<volatile unsigned long long*>(&mine->calls) = seq;
    __threadfence();
  }
}

int* host_err = nullptr;  // mapped host memory: the sticky timeout word
int* dev_err = nullptr;
int resident[kMaxDevices];  // peer_kernel's blocks that fit on each card at once (0: not asked yet)

cudaError_t error_word() {
  if (host_err != nullptr) return cudaSuccess;
  cudaError_t e = cudaHostAlloc(reinterpret_cast<void**>(&host_err), sizeof(int), cudaHostAllocMapped);
  if (e != cudaSuccess) return e;
  *reinterpret_cast<volatile int*>(host_err) = 0;
  return cudaHostGetDevicePointer(reinterpret_cast<void**>(&dev_err), host_err, 0);
}

// the resident block count of the current card (asked once, when a buffer
// is made: never while a stream is being captured)
cudaError_t query_resident(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, peer_kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    resident[dev] = per_sm * sms;
  }
  *out = resident[dev];
  return cudaSuccess;
}

bool load_peers(Peers& peers, void* const* bases, int n, int me) {
  if (bases == nullptr || n < 1 || n > kMaxRanks || me < 0 || me >= n) return false;
  for (int p = 0; p < n; ++p) {
    if (bases[p] == nullptr) return false;
    peers.base[p] = static_cast<char*>(bases[p]);
  }
  return true;
}

// one launch of peer_kernel on `stream`: a persistent grid no larger than
// the card's resident blocks / `share` (the ranks whose kernels wait on each
// other on this card) nor than the bytes a rank moves need
int launch(void* const* bases, int n, int me, int share, Call c, long long moved_bytes, cudaStream_t stream) {
  Peers peers{};
  if (!load_peers(peers, bases, n, me) || share < 1 || c.out == nullptr || c.bytes < 0 || host_err == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices || resident[dev] == 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (moved_bytes + kThreads * 16 - 1) / (kThreads * 16);
  const long long cap = resident[dev] / share;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  c.n = n;
  c.me = me;
  c.err = dev_err;
  peer_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(peers, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// A buffer of kHeaderBytes + bytes on the current card, zeroed (the header's
// flags and counts, and the all-reduce's padding) and the zeroing finished
// before this returns (peers write its flags once they hold its handle).
// Also makes the error word and asks the card's resident block count.
int ring_peer_alloc(long long bytes, void** out) {
  if (out == nullptr || bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = error_word();
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = query_resident(&blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMalloc(out, static_cast<size_t>(kHeaderBytes + bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemset(*out, 0, static_cast<size_t>(kHeaderBytes + bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaDeviceSynchronize());
}

int ring_peer_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

int ring_peer_header_bytes() { return static_cast<int>(kHeaderBytes); }

int ring_peer_handle_size() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

int ring_peer_handle(void* ptr, void* handle_out) {
  return static_cast<int>(cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle_out), ptr));
}

int ring_peer_open(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  const char* src = static_cast<const char*>(handle);
  char* dst = reinterpret_cast<char*>(&h);
  for (size_t i = 0; i < sizeof(h); ++i) dst[i] = src[i];
  return static_cast<int>(cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

int ring_peer_close(void* ptr) { return static_cast<int>(cudaIpcCloseMemHandle(ptr)); }

// The gather: this rank's shard (shard_bytes at src) staged into its buffer
// (bases[me]), then the n shards into out (n * shard_bytes) in rank order.
// bases: the n buffers' pointers in this process, each with room for two
// slots of shard_bytes; share: the ranks of the call on this card.
int ring_peer_all_gather(void* const* bases, int n, int me, int share, const void* src, void* out,
                         long long shard_bytes, cudaStream_t stream) {
  if (src == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Call c{static_cast<const char*>(src), static_cast<char*>(out), shard_bytes, 0, 0, 0, kGather, nullptr};
  return launch(bases, n, me, share, c, (1 + 2LL * n) * shard_bytes, stream);
}

// The reduce-scatter: this rank's cotangent (n * block_elems floats at src)
// staged into its buffer, then out (block_elems floats) = the sum over
// p = 0..n-1, in that order, of block `me` of rank p's cotangent. bases:
// each with room for two slots of n * block_elems floats.
int ring_peer_reduce_scatter(void* const* bases, int n, int me, int share, const float* src, float* out,
                             long long block_elems, cudaStream_t stream) {
  if (src == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Call c{reinterpret_cast<const char*>(src), reinterpret_cast<char*>(out), block_elems, 0, 0, 0, kReduceScatter,
         nullptr};
  return launch(bases, n, me, share, c, (2LL * n + 1) * block_elems * 4, stream);
}

// The all-reduce: the caller has written this rank's n * block_elems floats
// (out_elems of them its input, the rest padding) into its buffer, which
// has room for n + 1 blocks; out (out_elems floats) = the sum over p =
// 0..n-1, in that order, of rank p's input, the same bits on every rank.
// When the call ends no peer reads the input blocks any more.
int ring_peer_all_reduce(void* const* bases, int n, int me, int share, float* out, long long block_elems,
                         long long out_elems, cudaStream_t stream) {
  if (out_elems < 0 || out_elems > static_cast<long long>(n) * block_elems || (block_elems & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Call c{nullptr, reinterpret_cast<char*>(out), block_elems, out_elems, 0, 0, kAllReduce, nullptr};
  return launch(bases, n, me, share, c, (2LL * n + 1) * block_elems * 4, stream);
}

// The sticky error word: 0, or kPeerTimeout once a wait of any call of this
// process gave up. Read without a synchronisation: it shows the calls that
// have ended.
int ring_peer_error() { return host_err == nullptr ? 0 : *reinterpret_cast<volatile int*>(host_err); }

void ring_peer_clear_error() {
  if (host_err != nullptr) *reinterpret_cast<volatile int*>(host_err) = 0;
}

const char* ring_peer_error_string(int code) {
  if (code == kPeerTimeout) {
    return "a peer's flag did not arrive within the wait bound (a rank stopped calling, or the ranks' calls "
           "differ)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
