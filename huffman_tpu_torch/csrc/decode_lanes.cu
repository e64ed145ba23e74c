// decode_lanes: (W, K) u32 lane words -> (s, K) bytes, s symbols per lane.
//
// Replaces huffman_tpu/ops/decode_pallas.py:_make_decode_kernel (entry
// decode_bitserial_pallas) as _decode_full in models/tpu_codec.py calls
// it.  The TPU kernel advances every lane one bit per step in lockstep
// and compacts the symbols it finds, because it cannot address memory
// per lane; a GPU thread can walk its own lane's bits, so there is no
// compaction, no staging group and no scan bound here.
//
// Bound on the H100: the serial bit walk of each lane (about 20
// dependent integer operations per symbol) and the byte-wide stores;
// device traffic is only the compressed words plus s*K output bytes.
//
// Design: one thread per lane with a 64-bit, MSB-aligned bit buffer that
// is refilled one u32 word at a time from words[w*K + k] (coalesced
// across a warp; words past W read as zero).  Per symbol: win = the top
// 15 bits, len = 1 + #{l in 1..14 : win >= e_bound[l]},
// rank = clip((win >> (15-len)) + g_rank[len], 0, 255), byte = syms[rank]
// (the canonical-boundary decode of huffman_tpu/ops/decode_bits.py).  The
// constants sit in shared memory.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL = 15;
constexpr int kThreads = 256;

__global__ void decode_lanes_kernel(const uint32_t* __restrict__ words, int n_words,
                                    int k, const int* __restrict__ e_bound,
                                    const int* __restrict__ g_rank,
                                    const int* __restrict__ syms, int s,
                                    uint8_t* __restrict__ out) {
  __shared__ int eb[kL + 2];
  __shared__ int gr[kL + 1];
  __shared__ uint8_t sy[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    sy[i] = static_cast<uint8_t>(syms[i]);
    if (i < kL + 2) eb[i] = e_bound[i];
    if (i < kL + 1) gr[i] = g_rank[i];
  }
  __syncthreads();
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= k) return;
  uint64_t buf = 0;  // next stream bit at bit 63
  int avail = 0;
  int w = 0;
  for (int r = 0; r < s; ++r) {
    if (avail < kL) {
      const uint32_t nxt = w < n_words ? words[static_cast<size_t>(w) * k + lane] : 0u;
      ++w;
      buf |= static_cast<uint64_t>(nxt) << (32 - avail);
      avail += 32;
    }
    const int win = static_cast<int>(buf >> (64 - kL));
    int len = 1;
#pragma unroll
    for (int l = 1; l < kL; ++l) len += win >= eb[l];
    const int rank = min(max((win >> (kL - len)) + gr[len], 0), 255);
    out[static_cast<size_t>(r) * k + lane] = sy[rank];
    buf <<= len;
    avail -= len;
  }
}

}  // namespace

// words: (n_words, k) u32; e_bound (17,), g_rank (16,), syms (256,) int32;
// out: (s, k) uint8.  Returns the CUDA error code of the launch.
extern "C" int decode_lanes_launch(const void* words, int n_words, int k,
                                   const void* e_bound, const void* g_rank,
                                   const void* syms, int s, void* out,
                                   void* stream) {
  const int blocks = (k + kThreads - 1) / kThreads;
  decode_lanes_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, k,
      static_cast<const int*>(e_bound), static_cast<const int*>(g_rank),
      static_cast<const int*>(syms), s, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
