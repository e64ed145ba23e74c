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
// Bound on the H100: the latency of each lane's serial chain, one symbol
// after another, with a shared-memory lookup on it.  Device traffic is
// only the payload bits and s*K output bytes (~7 us for the 16 MiB block
// at 3.35 TB/s).  Measured on the 16 MiB block (PERF.md, by
// tools/kernel_ab.py): the same loop with a fixed code length and no
// lookup takes ~11 us; the lookup's bank conflicts (32 lanes, random
// entries) and its escape branch add ~5-6 us each.  A symbol that hits
// the table costs ~23 instructions and one shared load in the SASS.
//
// Design:
// - A direct lookup for short codes.  Each thread block first builds, in
//   shared memory, a table of 2^kLut entries indexed by the top kLut bits
//   of the 15-bit window: (byte, len) where the canonical search gives the
//   same length len <= kLut at the lowest and the highest window of that
//   prefix, else an escape (len 0).  The length is nondecreasing in the
//   window, so it is then constant over the prefix, and the rank depends
//   only on the top len bits: the entry is exact for every window.  The
//   build finds the length by a binary search over e_bound, which is
//   nondecreasing for every coding (len_count >= 0), as the plain
//   version's searchsorted also requires.  A hit is one shared load a
//   symbol; an escape runs the canonical search below with the boundaries
//   in registers.
// - Prefetched words: each lane loads its words kAhead refills ahead into
//   registers, so a load's latency overlaps the symbols that the words
//   before it feed.  The buffer is refilled when it holds fewer than 30
//   bits, so every refill check covers two symbols.  The loads stay
//   coalesced across a warp; rows past the block's word count read as 0.
// - 512 threads a block, one lane each, so a 16 MiB block is 256 thread
//   blocks, ~16 warps an SM, and the table is built once per 512 lanes.
//   The sweep of tools/kernel_ab.py (PERF.md) measured the other
//   choices against it: 256 threads 9 % slower at 16 MiB and 5 % faster
//   at B = 160, 1024 threads 6 % faster and 26 % slower; words loaded 1
//   or 4 refills ahead, or a table of 10 or 12 bits, 2-12 % slower at
//   16 MiB.
//
// Layout: one thread block per kThreads lanes of block b; a batch of B
// blocks (the vmapped decode of _decode_batch in models/tpu_codec.py) is
// one launch of a flat grid of B * ceil(K/kThreads) thread blocks, and a
// single block is B = 1.  Lane k of block b reads words[b][w*K + k] and
// writes out[b][r*K + k] through pointers stepped by K; block b's words
// are `pitch` rows apart, of which the first n_words are read.
// The canonical search (huffman_tpu/ops/decode_bits.py): win = the top 15
// bits, len = 1 + #{l in 1..14 : win >= e_bound[l]}, rank =
// clip((win >> (15-len)) + g_rank[len], 0, 255), byte = syms[rank].  A
// single-symbol block (all lengths 0, zero words) takes the same path:
// every window is 0, len 1, rank clip(0 + g_rank[1]) = 0, so it emits
// syms[0] (its table entry).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL = 15;
constexpr int kLut = 11;  // window bits that the lookup table resolves
constexpr int kLutSize = 1 << kLut;
constexpr int kThreads = 512;  // lanes a thread block
constexpr int kAhead = 2;  // words loaded ahead of the refill that takes them

// The canonical code length of a 15-bit window; eb[1..14] in registers.
__device__ __forceinline__ int search_len(int win, const int (&eb)[kL]) {
  int len = 1;
#pragma unroll
  for (int l = 1; l < kL; ++l) len += win >= eb[l];
  return len;
}

__global__ void __launch_bounds__(kThreads)
    decode_lanes_kernel(const uint32_t* __restrict__ words, int lane_blocks, int pitch,
                        int n_words, int k, const int* __restrict__ e_bound,
                        const int* __restrict__ g_rank, const int* __restrict__ syms, int s,
                        uint8_t* __restrict__ out) {
  const int b = blockIdx.x / lane_blocks;
  __shared__ uint16_t lut[kLutSize];  // len << 8 | byte; len 0 is the escape
  __shared__ int gr[kL + 1];
  __shared__ uint8_t sy[256];
  __shared__ int bound[16];
  const int* eb_row = e_bound + static_cast<size_t>(b) * (kL + 2);
  int eb[kL];
#pragma unroll
  for (int l = 1; l < kL; ++l) eb[l] = __ldg(eb_row + l);
  const int t = threadIdx.x;
  if (t < 256) sy[t] = static_cast<uint8_t>(syms[static_cast<size_t>(b) * 256 + t]);
  if (t < kL + 1) gr[t] = g_rank[static_cast<size_t>(b) * (kL + 1) + t];
  // bound[i] = e_bound[i + 1] for the 14 boundaries, then two that no
  // window reaches.
  if (t < 16) bound[t] = t < kL - 1 ? eb_row[t + 1] : 0x7FFFFFFF;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kLutSize / kThreads; ++j) {
    const int p = j * kThreads + t;
    const int lo = p << (kL - kLut), hi = lo | ((1 << (kL - kLut)) - 1);
    // Binary search: c = #{i : lo >= bound[i]}, so len(lo) = c + 1, and
    // hi has the same length when it is below the next boundary.
    int c = 0;
#pragma unroll
    for (int step = 8; step > 0; step >>= 1) c += lo >= bound[c + step - 1] ? step : 0;
    const int len = c + 1;
    int entry = 0;
    if (len <= kLut && hi < bound[c]) {
      entry = len << 8 | sy[min(max((lo >> (kL - len)) + gr[len], 0), 255)];
    }
    lut[p] = static_cast<uint16_t>(entry);
  }
  __syncthreads();

  const int lane = (blockIdx.x - b * lane_blocks) * kThreads + t;
  if (lane >= k) return;
  const uint32_t* src = words + static_cast<size_t>(b) * pitch * k + lane;  // next word to load
  uint8_t* dst = out + static_cast<size_t>(b) * s * k + lane;  // next output byte
  uint32_t nxt[kAhead];  // the words that the next refills take
  int left = n_words;    // words still to load
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    nxt[a] = left > 0 ? __ldg(src) : 0u;
    --left;
    src += k;
  }
  uint64_t buf = 0;  // next stream bit at bit 63
  int avail = 0;     // valid bits in buf
  for (int r = 0; r < s; r += 2) {
    // Refill to at least 30 bits, enough for two symbols.
    if (avail < 2 * kL) {
      buf |= static_cast<uint64_t>(nxt[0]) << (32 - avail);
      avail += 32;
#pragma unroll
      for (int a = 0; a + 1 < kAhead; ++a) nxt[a] = nxt[a + 1];
      nxt[kAhead - 1] = left > 0 ? __ldg(src) : 0u;
      --left;
      src += k;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half == 1 && r + 1 >= s) break;
      int entry = lut[static_cast<uint32_t>(buf >> 32) >> (32 - kLut)];
      int len = entry >> 8;
      if (len == 0) {
        const int win = static_cast<int>(buf >> (64 - kL));
        len = search_len(win, eb);
        entry = sy[min(max((win >> (kL - len)) + gr[len], 0), 255)];
      }
      *dst = static_cast<uint8_t>(entry);
      dst += k;
      buf <<= len;
      avail -= len;
    }
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
