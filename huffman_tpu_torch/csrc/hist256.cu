// hist256: 256-bin byte histogram of a block, or of its strided row sample.
//
// Replaces huffman_tpu/ops/lookup.py:_hist_pallas_kernel (entry
// _histogram256_pallas), plus the row sampling and +1 smoothing of
// _table_hist in huffman_tpu/models/tpu_codec.py.  The TPU kernel counts
// with nibble one-hot matmuls because it has no fast scatter; a GPU has
// shared-memory atomics, so this is the direct form.
//
// Bound on the H100: the 1-in-32 sample of a 16 MiB block is 512 KiB, a
// fraction of a microsecond of device-memory traffic, so the launch, one
// load's latency and the adds into the result bound it; a full count of
// 16 MiB is bound by device memory and the shared-memory atomics.  Skewed
// data (the biased corpus puts a fifth of its bytes on one value) makes
// many lanes of a warp hit one bin at once.
//
// Design: about kBlocksPerSm thread blocks a streaming multiprocessor,
// fewer where there are fewer rows than warps.  The rows to count are
// described by (rows, row_len, pitch, last_len), so the sample is never
// written out.  Each warp takes whole rows of at most 512 bytes, kUnroll
// at a time, and reads the aligned body of a row as one 16-byte load a
// lane; its unaligned head and ragged tail (each under 16 bytes) are
// counted byte by byte.  Each warp counts into its own 256-bin copy in shared memory, so
// hot bins contend only within a warp; a block sums its copies and adds
// each nonzero bin into the result with one atomic, and block 0 adds the
// +1 of the sampled branch.  The result is zeroed first.
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr int kUnroll = 4;
constexpr int kRowMax = 512;  // a warp's 16-byte loads, one a lane
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void count4(int* h, uint32_t v) {
  atomicAdd(&h[v & 0xFF], 1);
  atomicAdd(&h[(v >> 8) & 0xFF], 1);
  atomicAdd(&h[(v >> 16) & 0xFF], 1);
  atomicAdd(&h[v >> 24], 1);
}

__device__ __forceinline__ void count16(int* h, uint4 v) {
  count4(h, v.x);
  count4(h, v.y);
  count4(h, v.z);
  count4(h, v.w);
}

// Bytes of row p before its first 16-byte boundary, at most len.
__device__ __forceinline__ int head_bytes(const uint8_t* p, int len) {
  return min(len, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15));
}

__global__ void __launch_bounds__(kThreads)
    hist256_kernel(const uint8_t* __restrict__ data, long long rows, int row_len,
                   long long pitch, int last_len, int bias, int* __restrict__ out) {
  __shared__ int sh[kWarps][256];
  const int t = threadIdx.x, lane = t & 31;
  for (int i = t; i < kWarps * 256; i += kThreads) sh[i >> 8][i & 255] = 0;
  __syncthreads();
  int* mine = sh[t >> 5];
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r0 = static_cast<long long>(blockIdx.x) * kWarps + (t >> 5); r0 < rows;
       r0 += warps * kUnroll) {
    // The first 512 aligned bytes of kUnroll rows, all loads in flight.
    uint4 v[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long r = r0 + j * warps;
      ok[j] = false;
      if (r < rows) {
        const uint8_t* p = data + r * pitch;
        const int len = r == rows - 1 ? last_len : row_len;
        const int h = head_bytes(p, len);
        if (lane < (len - h) >> 4) {
          v[j] = *reinterpret_cast<const uint4*>(p + h + 16 * lane);
          ok[j] = true;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (ok[j]) count16(mine, v[j]);
    // The rest of each row: its head and its tail, each under 16 bytes.
    for (int j = 0; j < kUnroll; ++j) {
      const long long r = r0 + j * warps;
      if (r >= rows) break;
      const uint8_t* p = data + r * pitch;
      const int len = r == rows - 1 ? last_len : row_len;
      const int h = head_bytes(p, len);
      const int tail = h + ((len - h) & ~15);
      if (lane < h) atomicAdd(&mine[p[lane]], 1);
      if (tail + lane < len) atomicAdd(&mine[p[tail + lane]], 1);
    }
  }
  __syncthreads();
  if (t < 256) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += sh[w][t];
    if (blockIdx.x == 0) v += bias;
    if (v) atomicAdd(&out[t], v);
  }
}

// The current device's SM count, read once a device (0 where unknown).
cudaError_t sm_count(int* sms) {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = known[dev].load(std::memory_order_relaxed);
  if (*sms == 0) {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    known[dev].store(*sms, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

}  // namespace

// Counts rows r = 0..rows-1 of row_len bytes at data + r*pitch (the last
// row holds last_len bytes; both at most kRowMax) into out[256], then
// adds bias to every bin.  Returns the CUDA error code of the memset and
// launch (0 on success).
extern "C" int hist256_launch(const void* data, long long rows, int row_len,
                              long long pitch, int last_len, int bias,
                              void* out, void* stream) {
  if (row_len > kRowMax || last_len > kRowMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e == cudaSuccess) e = cudaMemsetAsync(out, 0, 256 * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // One row a warp at least, at most kBlocksPerSm blocks an SM.
  long long blocks = (rows + kWarps - 1) / kWarps;
  const long long most = static_cast<long long>(kBlocksPerSm) * sms;
  blocks = blocks < 1 ? 1 : (blocks > most ? most : blocks);
  hist256_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), rows, row_len, pitch, last_len, bias,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
