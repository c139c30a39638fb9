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
// outputs n shard gradients [S, F]. Their m + n pointers (at most
// kMaxTables) travel by value in the launch's parameters, a 1 KB
// __grid_constant__ table, as all_gather_rows passes its shards: the
// wrapper makes no pinned allocation and no host-to-device copy per call,
// and a launch captured into a CUDA graph holds its pointers in the graph
// itself (a copy from a host buffer would replay from memory since freed
// or reused). A version across cards passes peer pointers in the same
// table. grid.y picks the output shard, the blocks along grid.x stride
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
constexpr int kMaxTables = 128;  // m + n pointers: 1 KB of the launch's parameters

// ptr[0..m) are the cotangent tables, ptr[m + s] the output of shard s.
struct TableList {
  const float* ptr[kMaxTables];
};

__global__ void reduce_scatter_rows_kernel(const __grid_constant__ TableList tables,
                                           long long shard_elems, int m) {
  const int s = blockIdx.y;
  const long long offset = static_cast<long long>(s) * shard_elems;
  float* dst = const_cast<float*>(tables.ptr[m + s]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  bool aligned = (shard_elems & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  for (int r = 0; r < m; ++r) aligned = aligned && (reinterpret_cast<uintptr_t>(tables.ptr[r]) & 15) == 0;
  if (aligned) {
    const long long n_vec = shard_elems >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (long long i = tid; i < n_vec; i += stride) {
      float4 acc = __ldg(reinterpret_cast<const float4*>(tables.ptr[0] + offset) + i);
      for (int r = 1; r < m; ++r) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(tables.ptr[r] + offset) + i);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      dst4[i] = acc;
    }
  } else {
    for (long long i = tid; i < shard_elems; i += stride) {
      float acc = __ldg(tables.ptr[0] + offset + i);
      for (int r = 1; r < m; ++r) acc += __ldg(tables.ptr[r] + offset + i);
      dst[i] = acc;
    }
  }
}

}  // namespace

extern "C" {

// ptrs: a host array of m + n pointers (at most 128) on this card: the m
// cotangent tables, each of n * rows_per_shard * cols contiguous floats,
// then the n outputs, each of rows_per_shard * cols floats. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
int reduce_scatter_rows(const void* const* ptrs, int m, int n, long long rows_per_shard, long long cols,
                        cudaStream_t stream) {
  if (ptrs == nullptr || m <= 0 || n <= 0 || n > 65535 || m + n > kMaxTables || rows_per_shard < 0 ||
      cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TableList tables{};
  for (int i = 0; i < m + n; ++i) tables.ptr[i] = static_cast<const float*>(ptrs[i]);
  const long long shard_elems = rows_per_shard * cols;
  if (shard_elems == 0) return static_cast<int>(cudaSuccess);
  const long long per_block = static_cast<long long>(kThreads) * 4;
  long long blocks = (shard_elems + per_block - 1) / per_block;
  if (blocks > kMaxBlocksPerShard) blocks = kMaxBlocksPerShard;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  reduce_scatter_rows_kernel<<<grid, kThreads, 0, stream>>>(tables, shard_elems, m);
  return static_cast<int>(cudaGetLastError());
}

const char* reduce_scatter_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
