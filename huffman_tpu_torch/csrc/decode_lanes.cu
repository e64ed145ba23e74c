// decode_lanes: (B, W, K) u32 lane words -> (B, s, K) bytes, s symbols per
// lane of each of B blocks.
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
// Design: one thread per lane k of block b; a batch of B blocks (the
// vmapped decode of _decode_batch in models/tpu_codec.py) is one launch of
// a flat grid of B * ceil(K/256) thread blocks, and a single block is
// B = 1.  Each thread keeps a 64-bit, MSB-aligned bit buffer that is
// refilled one u32 word at a time from words[b][w*K + k] (coalesced
// across a warp) through a lane pointer stepped by K, and writes its
// bytes through another; indexing every access from the block's base
// instead cost the B = 1 decode about 1.1x on the H100.
// Block b's words are W rows apart, and only the first w rows are read:
// rows past w read as zero, as the JAX batch slices each block to w rows.
// Per symbol: win = the top 15 bits,
// len = 1 + #{l in 1..14 : win >= e_bound[l]},
// rank = clip((win >> (15-len)) + g_rank[len], 0, 255), byte = syms[rank]
// (the canonical-boundary decode of huffman_tpu/ops/decode_bits.py).  The
// block's constants sit in shared memory.  A single-symbol block (all
// lengths 0, zero words) decodes by the same walk: every window is 0,
// len 1, rank clip(0 + g_rank[1]) = 0, so it emits syms[0].
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL = 15;
constexpr int kThreads = 256;

__global__ void decode_lanes_kernel(const uint32_t* __restrict__ words, int lane_blocks,
                                    int pitch, int n_words, int k,
                                    const int* __restrict__ e_bound,
                                    const int* __restrict__ g_rank,
                                    const int* __restrict__ syms, int s,
                                    uint8_t* __restrict__ out) {
  const int b = blockIdx.x / lane_blocks;
  __shared__ int eb[kL + 2];
  __shared__ int gr[kL + 1];
  __shared__ uint8_t sy[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    sy[i] = static_cast<uint8_t>(syms[static_cast<size_t>(b) * 256 + i]);
    if (i < kL + 2) eb[i] = e_bound[static_cast<size_t>(b) * (kL + 2) + i];
    if (i < kL + 1) gr[i] = g_rank[static_cast<size_t>(b) * (kL + 1) + i];
  }
  __syncthreads();
  const int lane = (blockIdx.x - b * lane_blocks) * kThreads + threadIdx.x;
  if (lane >= k) return;
  // The lane's next word and next output byte, each stepped by k.
  const uint32_t* src = words + static_cast<size_t>(b) * pitch * k + lane;
  uint8_t* dst = out + static_cast<size_t>(b) * s * k + lane;
  uint64_t buf = 0;  // next stream bit at bit 63
  int avail = 0;
  int w = 0;
  for (int r = 0; r < s; ++r) {
    if (avail < kL) {
      const uint32_t nxt = w < n_words ? __ldg(src) : 0u;
      ++w;
      src += k;
      buf |= static_cast<uint64_t>(nxt) << (32 - avail);
      avail += 32;
    }
    const int win = static_cast<int>(buf >> (64 - kL));
    int len = 1;
#pragma unroll
    for (int l = 1; l < kL; ++l) len += win >= eb[l];
    const int rank = min(max((win >> (kL - len)) + gr[len], 0), 255);
    *dst = sy[rank];
    dst += k;
    buf <<= len;
    avail -= len;
  }
}

}  // namespace

// words: (B, pitch, k) u32, of which rows 0..n_words-1 of each block are
// read (n_words <= pitch); e_bound (B, 17), g_rank (B, 16), syms (B, 256)
// int32; out: (B, s, k) uint8.  B >= 1.  Returns the CUDA error code of
// the launch.
extern "C" int decode_lanes_launch(const void* words, int B, int pitch, int n_words,
                                   int k, const void* e_bound, const void* g_rank,
                                   const void* syms, int s, void* out, void* stream) {
  const int lane_blocks = (k + kThreads - 1) / kThreads;
  const long long grid = static_cast<long long>(lane_blocks) * B;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  decode_lanes_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), lane_blocks, pitch, n_words, k,
      static_cast<const int*>(e_bound), static_cast<const int*>(g_rank),
      static_cast<const int*>(syms), s, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
