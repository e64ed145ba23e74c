// hist256_batch: one 256-bin byte histogram per row of a (B, n) batch.
//
// Replaces huffman_tpu/ops/lookup.py:_hist_pallas_kernel_batch (entry
// histogram256_batch), which the batched encode (_encode_batch in
// models/tpu_codec.py) calls for B blocks at once.  The TPU kernel walks a
// (B, chunks) grid in order, carries each row's sum in its output block
// and counts with nibble one-hot matmuls; it pads every row to a whole
// chunk and subtracts the pad from bin 0 afterwards.  Here every byte of
// a row is counted exactly once and nothing is padded.
//
// Bound on the H100: at 160 rows of 100 KiB the kernel reads 16 MB, about
// 5 us of device-memory traffic at the H100 SXM's published 3.35 TB/s
// (0.0064 ms a launch on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, PERF.md), so the launch, the memset and the
// shared-memory atomics bound it.  Skewed data (the biased corpus puts a
// fifth of its bytes on one value) makes many threads of a warp hit one
// bin at once.
//
// Design: a 2-D grid, row chunks along x and batch rows along y (rows
// past 65535 loop).  Each warp counts into its own 256-bin copy in shared
// memory, so hot bins contend only within a warp; the eight copies are
// summed per bin and added into out[b, :] with one global atomic per
// nonzero bin.  Rows of a length divisible by 4 whose start is 4-byte
// aligned are read as u32 words.  The output is zeroed first.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// About eight resident blocks on each of the 132 SMs.
constexpr long long kTargetBlocks = 1056;
constexpr long long kMinChunk = 4096;

__global__ void hist256_batch_kernel(const uint8_t* __restrict__ data, int B,
                                     long long n, long long chunk, bool vec4,
                                     int* __restrict__ out) {
  __shared__ int sh[kWarps][256];
  const int t = threadIdx.x;
  for (int w = 0; w < kWarps; ++w) sh[w][t] = 0;
  __syncthreads();
  int* mine = sh[t / 32];
  const long long lo = static_cast<long long>(blockIdx.x) * chunk;
  const long long hi = min(n, lo + chunk);
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const uint8_t* row = data + static_cast<size_t>(b) * n;
    if (vec4) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(row + lo);
      for (long long i = t; i < (hi - lo) / 4; i += kThreads) {
        const uint32_t v = p[i];
        atomicAdd(&mine[v & 0xFF], 1);
        atomicAdd(&mine[(v >> 8) & 0xFF], 1);
        atomicAdd(&mine[(v >> 16) & 0xFF], 1);
        atomicAdd(&mine[v >> 24], 1);
      }
    } else {
      for (long long i = lo + t; i < hi; i += kThreads) atomicAdd(&mine[row[i]], 1);
    }
    __syncthreads();
    int v = 0;
    for (int w = 0; w < kWarps; ++w) {
      v += sh[w][t];
      sh[w][t] = 0;
    }
    if (v) atomicAdd(&out[static_cast<size_t>(b) * 256 + t], v);
    __syncthreads();
  }
}

}  // namespace

// data: (B, n) uint8, row-major; out: (B, 256) int32 counts of each row.
// B >= 1, n >= 1.  Returns the CUDA error code of the memset and launch
// (0 on success).
extern "C" int hist256_batch_launch(const void* data, int B, long long n,
                                    void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(B) * 256 * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // Chunks per row: enough blocks to fill the card, each at least kMinChunk
  // bytes; the chunk is a multiple of 16 so u32 reads stay aligned.
  long long per_row = (kTargetBlocks + B - 1) / B;
  per_row = std::max(1LL, std::min(per_row, (n + kMinChunk - 1) / kMinChunk));
  long long chunk = (n + per_row - 1) / per_row;
  chunk = (chunk + 15) / 16 * 16;
  per_row = (n + chunk - 1) / chunk;
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 4 == 0;
  const dim3 grid(static_cast<unsigned>(per_row), static_cast<unsigned>(std::min(B, 65535)));
  hist256_batch_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(data), B, n,
                                                 chunk, vec4, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
