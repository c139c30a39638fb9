// ring_peer: the table all-gather and its reduce-scatter backward across
// ranks (processes), on peer memory.
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
// Design. Each rank owns one symmetric buffer per (group, kind, size):
// a header of flags, then the data. It is allocated here with cudaMalloc
// (an IPC handle names a whole allocation, and the pointers must not move)
// and exported with cudaIpcGetMemHandle; each rank opens the others' with
// cudaIpcOpenMemHandle, so every rank holds the n buffers' base pointers.
// That works between processes on one card and between cards joined by
// NVLink. The n pointers travel by value in the launch's parameters, as
// all_gather_rows passes its shards.
//
// One call, sequence number seq (the same on every rank; nothing is reset
// between calls):
//  1. stage: every block waits until each rank p has set done[p] >= seq - 1
//     in this rank's header (p has finished reading this buffer's previous
//     contents: the TPU kernel's acks), then copies its part of the local
//     input into this rank's data. The last block to finish sets ready[me]
//     = seq in every rank's header (the entry barrier's signal).
//  2. body: every block waits until ready[p] >= seq for every p in this
//     rank's header, then reads the n buffers: the gather copies each
//     rank's shard to its rows of the output; the reduce-scatter adds block
//     `me` of the n ranks' cotangents in rank order (p = 0, 1, ..., n-1) in
//     f32, the order of the plain version. The last block to finish sets
//     done[me] = seq in every rank's header.
// Flags are written with st.release.sys after __threadfence_system() and
// read with ld.acquire.sys; the data with ld.global.cg (L2, not L1). A wait
// polls with __nanosleep and gives up after kWaitNs of %globaltimer: the
// kernel then sets an error word in mapped host memory, and the call
// returns kPeerTimeout, which the wrapper raises. Without MPS the ranks of
// one card time-slice, so a waiting block makes progress only when its
// peers' contexts get the card: the bound is generous. The call ends with a
// stream synchronisation, which reads that word.
//
// Bound: bytes. The gather moves, over all n ranks through one HBM, n x (2
// shard bytes of staging + 2 n shard bytes of gather); the reduce-scatter n x
// (2 n S F 4 of staging + n S F 4 read + S F 4 written). On one card the
// ranks take turns, so a time measures that time-slicing, not NVLink.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers); bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 64;
constexpr long long kHeaderBytes = 4096;  // the flags, then the data (16-byte aligned)
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1024;
constexpr unsigned long long kWaitNs = 20ull * 1000 * 1000 * 1000;  // 20 s
constexpr int kPeerTimeout = 2000;  // above every cudaError_t

struct Header {
  unsigned long long ready[kMaxRanks];  // ready[p] = seq: rank p's data of call seq is in p's buffer
  unsigned long long done[kMaxRanks];   // done[p] = seq: rank p has read every buffer of call seq
  unsigned int blocks_finished;         // this rank's count of finished blocks in the current kernel
};
static_assert(sizeof(Header) <= kHeaderBytes, "header too large");

// the n ranks' buffers (header, then data), as mapped in this process
struct Peers {
  char* base[kMaxRanks];
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

// Thread 0 of the block waits until flags[p] >= target for every p < n.
// Returns false (and sets *err) past the bound. Every thread gets the answer.
__device__ bool block_wait(const unsigned long long* flags, int n, unsigned long long target, int* err) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    ok = 1;
    const unsigned long long t0 = global_ns();
    for (int p = 0; p < n && ok; ++p) {
      while (load_acquire(flags + p) < target) {
        if (global_ns() - t0 > kWaitNs) {
          atomicExch(err, kPeerTimeout);
          ok = 0;
          break;
        }
        __nanosleep(256);
      }
    }
  }
  __syncthreads();
  return ok != 0;
}

// After the block's work: the last block of the grid sets flag slot `me` of
// `which` (0: ready, 1: done) to seq in every rank's header.
__device__ void finish(const Peers& peers, int n, int me, unsigned long long seq, int which) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    Header* mine = reinterpret_cast<Header*>(peers.base[me]);
    const unsigned prev = atomicAdd(&mine->blocks_finished, 1u);
    if (prev == gridDim.x - 1) {
      mine->blocks_finished = 0;  // the next kernel of this stream starts after this one
      __threadfence_system();
      for (int p = 0; p < n; ++p) {
        Header* h = reinterpret_cast<Header*>(peers.base[p]);
        store_release(which == 0 ? &h->ready[me] : &h->done[me], seq);
      }
    }
  }
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

__global__ void __launch_bounds__(kThreads) stage_kernel(const __grid_constant__ Peers peers, int n, int me,
                                                         unsigned long long seq, const char* src,
                                                         long long bytes, int* err) {
  const Header* mine = reinterpret_cast<const Header*>(peers.base[me]);
  if (!block_wait(mine->done, n, seq - 1, err)) return;
  grid_copy(peers.base[me] + kHeaderBytes, src, bytes);
  finish(peers, n, me, seq, 0);
}

__global__ void __launch_bounds__(kThreads) gather_kernel(const __grid_constant__ Peers peers, int n, int me,
                                                          unsigned long long seq, char* out,
                                                          long long shard_bytes, int* err) {
  const Header* mine = reinterpret_cast<const Header*>(peers.base[me]);
  if (!block_wait(mine->ready, n, seq, err)) return;
  for (int p = 0; p < n; ++p) grid_copy(out + p * shard_bytes, peers.base[p] + kHeaderBytes, shard_bytes);
  finish(peers, n, me, seq, 1);
}

__global__ void __launch_bounds__(kThreads) reduce_kernel(const __grid_constant__ Peers peers, int n, int me,
                                                          unsigned long long seq, float* out,
                                                          long long block_elems, int* err) {
  const Header* mine = reinterpret_cast<const Header*>(peers.base[me]);
  if (!block_wait(mine->ready, n, seq, err)) return;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long offset = static_cast<long long>(me) * block_elems;
  const bool vec = (block_elems & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (vec) {
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < block_elems / 4; i += stride) {
      float4 acc = __ldcg(reinterpret_cast<const float4*>(peers.base[0] + kHeaderBytes) + offset / 4 + i);
      for (int p = 1; p < n; ++p) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(peers.base[p] + kHeaderBytes) + offset / 4 + i);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      out4[i] = acc;
    }
  } else {
    for (long long i = tid; i < block_elems; i += stride) {
      float acc = __ldcg(reinterpret_cast<const float*>(peers.base[0] + kHeaderBytes) + offset + i);
      for (int p = 1; p < n; ++p) acc += __ldcg(reinterpret_cast<const float*>(peers.base[p] + kHeaderBytes) + offset + i);
      out[i] = acc;
    }
  }
  finish(peers, n, me, seq, 1);
}

int* host_err = nullptr;  // mapped host memory: a kernel's timeout
int* dev_err = nullptr;

cudaError_t error_word() {
  if (host_err != nullptr) return cudaSuccess;
  cudaError_t e = cudaHostAlloc(reinterpret_cast<void**>(&host_err), sizeof(int), cudaHostAllocMapped);
  if (e != cudaSuccess) return e;
  return cudaHostGetDevicePointer(reinterpret_cast<void**>(&dev_err), host_err, 0);
}

unsigned blocks_for(long long bytes) {
  long long b = (bytes + kThreads * 16 - 1) / (kThreads * 16);
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b);
}

bool load_peers(Peers& peers, void* const* bases, int n, int me) {
  if (bases == nullptr || n < 1 || n > kMaxRanks || me < 0 || me >= n) return false;
  for (int p = 0; p < n; ++p) {
    if (bases[p] == nullptr) return false;
    peers.base[p] = static_cast<char*>(bases[p]);
  }
  return true;
}

// both kernels of a call on `stream`, then the stream synchronised and the
// timeout word read
template <typename Body>
int run_call(const Peers& peers, int n, int me, unsigned long long seq, const void* src, long long stage_bytes,
             long long body_bytes, cudaStream_t stream, Body body) {
  cudaError_t e = error_word();
  if (e != cudaSuccess) return static_cast<int>(e);
  *reinterpret_cast<volatile int*>(host_err) = 0;
  stage_kernel<<<blocks_for(stage_bytes), kThreads, 0, stream>>>(peers, n, me, seq, static_cast<const char*>(src),
                                                                   stage_bytes, dev_err);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  body(blocks_for(body_bytes));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamSynchronize(stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return *reinterpret_cast<volatile int*>(host_err) != 0 ? kPeerTimeout : 0;
}

}  // namespace

extern "C" {

// A buffer of kHeaderBytes + bytes on the current card, its header zeroed
// and the zeroing finished before this returns (peers write its flags once
// they hold its handle).
int ring_peer_alloc(long long bytes, void** out) {
  if (out == nullptr || bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMalloc(out, static_cast<size_t>(kHeaderBytes + bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemset(*out, 0, kHeaderBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaDeviceSynchronize());
}

int ring_peer_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

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

// The gather of call `seq`: this rank's shard (shard_bytes at src) staged
// into its buffer (bases[me]), then the n shards into out (n * shard_bytes)
// in rank order. bases: the n buffers' pointers in this process, each with
// room for shard_bytes.
int ring_peer_all_gather(void* const* bases, int n, int me, unsigned long long seq, const void* src, void* out,
                         long long shard_bytes, cudaStream_t stream) {
  Peers peers{};
  if (!load_peers(peers, bases, n, me) || src == nullptr || out == nullptr || shard_bytes < 0 || seq == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run_call(peers, n, me, seq, src, shard_bytes, static_cast<long long>(n) * shard_bytes, stream,
                  [&](unsigned blocks) {
                    gather_kernel<<<blocks, kThreads, 0, stream>>>(peers, n, me, seq, static_cast<char*>(out),
                                                                   shard_bytes, dev_err);
                  });
}

// The reduce-scatter of call `seq`: this rank's cotangent (n * block_elems
// floats at src) staged into its buffer, then out (block_elems floats) =
// the sum over p = 0..n-1, in that order, of block `me` of rank p's
// cotangent. bases: each with room for n * block_elems floats.
int ring_peer_reduce_scatter(void* const* bases, int n, int me, unsigned long long seq, const float* src,
                             float* out, long long block_elems, cudaStream_t stream) {
  Peers peers{};
  if (!load_peers(peers, bases, n, me) || src == nullptr || out == nullptr || block_elems < 0 || seq == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long stage_bytes = static_cast<long long>(n) * block_elems * 4;
  return run_call(peers, n, me, seq, src, stage_bytes, block_elems * 4, stream, [&](unsigned blocks) {
    reduce_kernel<<<blocks, kThreads, 0, stream>>>(peers, n, me, seq, out, block_elems, dev_err);
  });
}

const char* ring_peer_error_string(int code) {
  if (code == kPeerTimeout) {
    return "a peer's flag did not arrive within the wait bound (a rank stopped calling, or the ranks' calls "
           "differ)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
