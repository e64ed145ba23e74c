// hist256: 256-bin byte histogram of a block, or of its strided row sample.
//
// Replaces huffman_tpu/ops/lookup.py:_hist_pallas_kernel (entry
// _histogram256_pallas), plus the row sampling and +1 smoothing of
// _table_hist in huffman_tpu/models/tpu_codec.py.  The TPU kernel counts
// with nibble one-hot matmuls because it has no fast scatter; a GPU has
// shared-memory atomics, so this is the direct form.
//
// Bound on the H100: the 1-in-32 sample of a 16 MiB block is 512 KiB, a
// few microseconds of device-memory traffic, so the launch and the
// shared-memory atomics bound it.  Skewed data (the biased corpus puts a
// fifth of its bytes on one value) serialises the atomics of a warp on
// one bank.
//
// Design: a grid of blocks strides over rows; each block counts into a
// 256-entry int32 histogram in shared memory and adds it into the global
// result with one atomic per bin.  The rows to count are described by
// (rows, row_len, pitch, last_len), so the sample is never written out,
// and the +1 of the sampled branch is added by block 0.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void hist256_kernel(const uint8_t* __restrict__ data, long long rows,
                               int row_len, long long pitch, int last_len,
                               int bias, int* __restrict__ out) {
  __shared__ int sh[256];
  sh[threadIdx.x] = 0;
  __syncthreads();
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const uint8_t* p = data + r * pitch;
    const int len = (r == rows - 1) ? last_len : row_len;
    for (int c = threadIdx.x; c < len; c += kThreads) atomicAdd(&sh[p[c]], 1);
  }
  __syncthreads();
  int v = sh[threadIdx.x];
  if (blockIdx.x == 0) v += bias;
  if (v) atomicAdd(&out[threadIdx.x], v);
}

}  // namespace

// Counts rows r = 0..rows-1 of row_len bytes at data + r*pitch (the last
// row holds last_len bytes) into out[256], then adds bias to every bin.
// Returns the CUDA error code of the memset and launch (0 on success).
extern "C" int hist256_launch(const void* data, long long rows, int row_len,
                              long long pitch, int last_len, int bias,
                              void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, 256 * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = rows < 1 ? 1 : (rows < 1056 ? rows : 1056);
  hist256_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), rows, row_len, pitch, last_len, bias,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
