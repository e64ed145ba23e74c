// encode_lanes: B blocks of K lanes of S bytes -> (B, w32, K) u32 lane
// words + (B, K) bit counts.
//
// Replaces huffman_tpu/ops/encode_pallas.py:_make_encode_kernel (entry
// encode_lanes_pallas), with the u16 -> u32 word pairing of
// huffman_tpu/ops/decode_words.py:pack_u16_words_to_u32 and the pad/trim
// to w32 rows of _encode_with_tables_body (models/tpu_codec.py) fused in.
// The TPU kernel places bits with a prefix sum and log-round shift+OR
// passes because it cannot gather or scatter per lane; a GPU thread can
// simply own a lane and append its codes to a bit accumulator.
//
// Bound on the H100: device memory.  A 16 MiB block reads 16 MiB of bytes
// and writes w32*K*4 bytes of words (32 MiB at S=128, K=131072), one
// coalesced row at a time across a warp; the per-lane loop is a short
// dependent chain (table load, shift, or) per byte.
//
// Design: one thread per lane k of block b; a batch of B blocks (the
// vmapped encode of _encode_batch in models/tpu_codec.py) is one launch of
// a flat grid of B * ceil(K/256) thread blocks, and a single block is
// B = 1.  Each thread owns one (block, lane); the kernel moves its pointer
// parameters to block b and then runs the single-block code.  Both
// matter on the H100: with a loop over blocks inside the kernel nvcc no
// longer issued the unrolled rows' byte loads ahead of the word stores
// (B = 1 encode 1.5x as long), and with block offsets folded into every
// index it was still 1.2x.  Row r's byte is
// padded[b][r*K + k] (the strided lane map), so a warp reads 32
// neighbouring bytes per row.  The block's 256-entry table sits in shared
// memory.  Codes are appended MSB-first to a 64-bit accumulator and every
// full u32 goes straight to words[b][w*K + k]; rows past the lane's end
// are written as zero, so the output needs no memset.  There is no limit
// on S.  Offsets are size_t: a batch passes 2^31 bytes.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL = 15;
constexpr int kThreads = 256;

__global__ void encode_lanes_kernel(const uint8_t* __restrict__ padded,
                                    const int* __restrict__ enc_table, int lane_blocks,
                                    int s, int k, int w32, uint32_t* __restrict__ words,
                                    int* __restrict__ bit_counts) {
  // Move the parameters to block b; below is the code of a single block.
  const int b = blockIdx.x / lane_blocks;
  padded += static_cast<size_t>(b) * s * k;
  enc_table += static_cast<size_t>(b) * 256;
  words += static_cast<size_t>(b) * w32 * k;
  bit_counts += static_cast<size_t>(b) * k;
  __shared__ uint32_t tab[256];
  for (int i = threadIdx.x; i < 256; i += kThreads)
    tab[i] = static_cast<uint32_t>(enc_table[i]);
  __syncthreads();
  const int lane = (blockIdx.x - b * lane_blocks) * kThreads + threadIdx.x;
  if (lane >= k) return;
  uint64_t acc = 0;
  int nbits = 0;  // bits in acc not yet written, < 32 between bytes
  int total = 0;
  int w = 0;
  for (int r = 0; r < s; ++r) {
    const uint32_t e = tab[padded[static_cast<size_t>(r) * k + lane]];
    const int len = e & 15;
    acc = (acc << len) | ((e >> 4) >> (kL - len));
    nbits += len;
    total += len;
    if (nbits >= 32) {
      nbits -= 32;
      words[static_cast<size_t>(w++) * k + lane] = static_cast<uint32_t>(acc >> nbits);
    }
  }
  if (nbits > 0)
    words[static_cast<size_t>(w++) * k + lane] = static_cast<uint32_t>(acc << (32 - nbits));
  for (; w < w32; ++w) words[static_cast<size_t>(w) * k + lane] = 0;
  bit_counts[lane] = total;
}

}  // namespace

// padded: (B, s*k) uint8; enc_table: (B, 256) int32; words: (B, w32, k)
// u32; bit_counts: (B, k) int32.  B >= 1.  w32 must exceed the longest
// lane's word count (w32 = (s*15+31)/32 + 1 always does).  Returns the
// CUDA error code of the launch.
extern "C" int encode_lanes_launch(const void* padded, const void* enc_table, int B,
                                   int s, int k, int w32, void* words,
                                   void* bit_counts, void* stream) {
  const int lane_blocks = (k + kThreads - 1) / kThreads;
  const long long grid = static_cast<long long>(lane_blocks) * B;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  encode_lanes_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(padded), static_cast<const int*>(enc_table), lane_blocks,
      s, k, w32, static_cast<uint32_t*>(words), static_cast<int*>(bit_counts));
  return static_cast<int>(cudaGetLastError());
}
