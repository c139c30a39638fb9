// all_gather_rows: reassemble a row-sharded table, out = concat(shards, rows).
//
// Replaces the JAX package's one TPU kernel, parallel/ring.py:27
// _ring_all_gather_kernel (reached through ring_all_gather, pallas_call at
// ring.py:133): each device's [S, F] shard gathered into [n*S, F].
//
// Design: a direct gather. Every shard lies on this card (on a host with
// several cards the same interface takes peer pointers), so the ring order,
// the entry barrier and the per-step acks of the TPU kernel have no job
// here: grid.y picks the shard, the blocks along grid.x stride over its
// bytes, and each block copies spans of output rows from the shard that
// owns them. No flags, no spin-waits, no dependence between blocks: the
// kernel cannot hang. Copies are 16-byte vectors when source and
// destination are both 16-byte aligned (the scalar tail covers
// shard_bytes % 16), byte copies otherwise.
//
// Bound: bytes. On the main path (the 128^3 x 4 grid, [2,097,152, 4] f32)
// it reads 32 MiB and writes 32 MiB: 2 x 32 MiB / 3.35 TB/s ~= 20 us on an
// H100 SXM at its 700 W limit. It does no arithmetic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers); bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocksPerShard = 4096;

__global__ void gather_rows_kernel(const void* const* __restrict__ shard_ptrs,
                                   char* __restrict__ out,
                                   long long shard_bytes) {
  const int s = blockIdx.y;
  const char* src = static_cast<const char*>(shard_ptrs[s]);
  char* dst = out + static_cast<long long>(s) * shard_bytes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (aligned) {
    const long long n_vec = shard_bytes >> 4;
    const int4* src4 = reinterpret_cast<const int4*>(src);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (long long i = tid; i < n_vec; i += stride) dst4[i] = __ldg(src4 + i);
    for (long long i = (n_vec << 4) + tid; i < shard_bytes; i += stride) dst[i] = src[i];
  } else {
    for (long long i = tid; i < shard_bytes; i += stride) dst[i] = src[i];
  }
}

}  // namespace

extern "C" {

// shard_ptrs: device array of n pointers, each to rows_per_shard * row_bytes
// contiguous bytes. out: n * rows_per_shard * row_bytes bytes. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
int all_gather_rows(const void* const* shard_ptrs, void* out, long long rows_per_shard,
                    long long row_bytes, int n, cudaStream_t stream) {
  if (shard_ptrs == nullptr || out == nullptr || n <= 0 || n > 65535 || rows_per_shard < 0 ||
      row_bytes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long shard_bytes = rows_per_shard * row_bytes;
  if (shard_bytes == 0) return static_cast<int>(cudaSuccess);
  const long long per_block = static_cast<long long>(kThreads) * 16;
  long long blocks = (shard_bytes + per_block - 1) / per_block;
  if (blocks > kMaxBlocksPerShard) blocks = kMaxBlocksPerShard;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  gather_rows_kernel<<<grid, kThreads, 0, stream>>>(shard_ptrs, static_cast<char*>(out),
                                                    shard_bytes);
  return static_cast<int>(cudaGetLastError());
}

const char* all_gather_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
