// reduce_scatter_rows: the backward of the table all-gather,
// out_i[S, F] = sum_{r=0..m-1} ct_r[i*S:(i+1)*S, :] for i < n.
//
// Replaces the VJP of the JAX package's one TPU kernel, parallel/ring.py:27
// _ring_all_gather_kernel: ring_all_gather_grad (ring.py:153) pairs the
// Pallas ring forward with a psum_scatter backward (_ring_ag_bwd,
// ring.py:168-169): each device's shard gradient is its row block of the
// table's cotangent, summed over the replicas that gathered the table.
//
// Design: the inputs are m cotangent tables [n*S, F] (one per replica), the
// outputs n shard gradients [S, F]; both come as device arrays of pointers,
// the interface of all_gather_rows, so a version across cards passes peer
// pointers. grid.y picks the output shard, the blocks along grid.x stride
// over its elements, and each thread adds the m replicas' values in replica
// order (r = 0, 1, ..., m-1) in f32, the order the plain version
// reduce_scatter_rows_plain uses, so the two agree bit for bit. No flags,
// no spin-waits, no block waits on another: the kernel cannot hang. Loads
// and stores are float4 vectors when every pointer is 16-byte aligned and
// S*F is a multiple of 4, scalars otherwise.
//
// On one card the trainer has one replica (m = 1): the kernel then copies
// row blocks of the cotangent into the shard gradients.
//
// Bound: bytes. It reads m*n*S*F*4 bytes and writes n*S*F*4: at m = 1 and
// the 128^3 x 4 grid table ([2,097,152, 4] f32) that is 2 x 32 MiB, about
// 20 us at the H100 SXM's 3.35 TB/s. It does (m-1)*n*S*F adds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no PyTorch headers); bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocksPerShard = 4096;

__device__ __forceinline__ const float* table(const unsigned long long* ptrs, int r) {
  return reinterpret_cast<const float*>(ptrs[r]);
}

// ptrs[0..m) are the cotangent tables, ptrs[m + s] the output of shard s.
__global__ void reduce_scatter_rows_kernel(const unsigned long long* __restrict__ ptrs,
                                           long long shard_elems, int m) {
  const int s = blockIdx.y;
  const long long offset = static_cast<long long>(s) * shard_elems;
  float* dst = reinterpret_cast<float*>(ptrs[m + s]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  bool aligned = (shard_elems & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  for (int r = 0; r < m; ++r) aligned = aligned && (ptrs[r] & 15) == 0;
  if (aligned) {
    const long long n_vec = shard_elems >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (long long i = tid; i < n_vec; i += stride) {
      float4 acc = __ldg(reinterpret_cast<const float4*>(table(ptrs, 0) + offset) + i);
      for (int r = 1; r < m; ++r) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(table(ptrs, r) + offset) + i);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      dst4[i] = acc;
    }
  } else {
    for (long long i = tid; i < shard_elems; i += stride) {
      float acc = __ldg(table(ptrs, 0) + offset + i);
      for (int r = 1; r < m; ++r) acc += __ldg(table(ptrs, r) + offset + i);
      dst[i] = acc;
    }
  }
}

}  // namespace

extern "C" {

// ptrs: device array of m + n pointers as 64-bit integers: the m cotangent
// tables, each of n * rows_per_shard * cols contiguous floats, then the n
// outputs, each of rows_per_shard * cols floats. Launches on `stream`, does
// not synchronise, returns cudaGetLastError().
int reduce_scatter_rows(const unsigned long long* ptrs, long long rows_per_shard, long long cols,
                        int m, int n, cudaStream_t stream) {
  if (ptrs == nullptr || m <= 0 || n <= 0 || n > 65535 || rows_per_shard < 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long shard_elems = rows_per_shard * cols;
  if (shard_elems == 0) return static_cast<int>(cudaSuccess);
  const long long per_block = static_cast<long long>(kThreads) * 4;
  long long blocks = (shard_elems + per_block - 1) / per_block;
  if (blocks > kMaxBlocksPerShard) blocks = kMaxBlocksPerShard;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  reduce_scatter_rows_kernel<<<grid, kThreads, 0, stream>>>(ptrs, shard_elems, m);
  return static_cast<int>(cudaGetLastError());
}

const char* reduce_scatter_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
