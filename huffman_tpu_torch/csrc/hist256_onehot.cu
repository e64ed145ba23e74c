// hist256_onehot: 256-bin byte histogram by nibble one-hot products on the
// tensor cores.
//
// Replaces tools/hist_experiments.py:make_kernel (entry hist_variant), the
// histogram variants raced on the TPU.  Like them it counts bin 16*hi + lo
// as entry (hi, lo) of the sum over all bytes of the outer product of the
// hi-nibble and lo-nibble one-hots: a (16 x n) by (n x 16) matrix product.
// The TPU variants differ in the compare's type and the rows per dot, which
// choose how Mosaic builds the one-hot in VMEM; here the one-hot is built in
// registers whatever the product's type, and the instruction fixes the k
// depth, so the five TPU variants become three MMA input types: s8 (i8dot,
// m16n8k32, int32 sums), bf16 (base, bf16cmp, wide, m16n8k16, f32 sums) and
// tf32 (f32cmp, m16n8k8, f32 sums).
//
// Bound on the H100: 16 MiB is 5.0 us of device-memory traffic; the
// product is 512 operations a byte, 4.3 us at the s8 dense peak, 8.7 us at
// bf16's and 17.4 us at tf32's.  What bounds the kernel is the one-hot
// build, integer work outside the tensor cores: in the mma fragments the 8
// threads of a t-group (g = lane/4, same t) hold the same bytes, and each
// needs their one-hot entries for its own rows g and g+8 and columns g and
// g+8: 32 one-hot bytes to make for every input byte, whatever the design.
// Byte-wise compares took about 20 integer instructions per 4 bytes per
// thread, nibble extraction included, 8 times over.
//
// Design: one lookup per 4 one-hot bytes, from selectors built once a byte.
//  - Thread row g keeps an 8-byte table (tlo, thi) whose byte g is the
//    type's one and every other byte 0.  PTX prmt.b32 with selector nibble
//    n gives byte n of the table for n < 8, [n == g], and for n >= 8 the
//    replicated msb of byte n & 7, which is 0: so [n == g] for every
//    nibble.  The same selector with bit 3 flipped (^ 0x8888) gives
//    [n == g + 8].  The lookup is inline PTX: CUDA documents __byte_perm
//    for bits 2:0 of a nibble only.
//  - A warp step covers 128 bytes, two 64-byte chunks of the mma layout,
//    32 words: each word is loaded and turned into selectors by one
//    thread (the lo nibbles packed into the low 16 bits, lo | hi << 16,
//    and the same word with its halves swapped for the hi nibbles), and
//    the lane that holds word j of t's 16 bytes of chunk h is 16h + 4j + t.
//    The t-group reads them with two shuffles a word, not a shared-memory
//    stage: the same issue slots as a shared load, and no barrier.  A
//    warp iteration is 512 bytes, one 16-byte load a lane, four steps.
//  - Per 4 bytes a thread then makes its A rows g and g+8 and B columns g
//    and g+8 with 4 prmt and 2 XOR.  s8's one is 0x01 and the lookups are
//    the fragments.  bf16 and tf32 take 0.5 (0x3F in the top byte, 0 in
//    the others), so that one prmt by a fixed selector moves a looked-up
//    byte into a bf16 pair or a tf32 word; their sums count 0.25 a byte
//    and are scaled by 4 at the flush.
// SASS of one 64-byte warp step (tools/kernel_ab.py's count), expected
// before the first build: s8 about 44, bf16 about 80, tf32 about 120;
// counted: s8 44.25 (17 prmt, 10 lop3, 8 shfl, 4 imma), bf16 77.5 (49
// prmt, 8 hmma), tf32 117.5 (81 prmt, 16 hmma), against the byte-wise
// compares' 105.5, 157.75 and 229.75.  On an H100 SXM at 700 W the
// 16 MiB count takes 0.027 / 0.046 / 0.069 ms (0.059 / 0.073 / 0.103
// before), about 27 / 46 / 69 SM clocks a 64-byte warp step: the
// lookups, XORs and shuffles still bound it, 19-25 % of the bounds below.
//
// The 16 x 16 sums stay in registers (two n = 8 tiles) and are flushed into
// the block's int32 shared histogram every 64 iterations (far below
// the 2^24 at which an f32 sum of 0.25s stops being exact), so the int32
// result is exact for any n < 2^31.  Each block adds its bins to the output
// with one atomic per nonzero bin.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFlushEvery = 64;  // 512-byte iterations between flushes of the sums
constexpr long long kMaxBlocks = 1056;  // 8 blocks on each of 132 SMs
constexpr unsigned kNibbles = 0x0F0F0F0Fu;
constexpr unsigned kFlip = 0x8888u;  // bit 3 of each selector nibble

enum Variant { kS8 = 0, kBf16 = 1, kTf32 = 2 };

// The nibbles of the 4 bytes of w as two prmt selectors: lo nibbles in
// bits 0-15, hi nibbles in bits 16-31, byte i's in nibble i of each half.
__device__ __forceinline__ unsigned selectors(unsigned w) {
  const unsigned lo = w & kNibbles, hi = (w >> 4) & kNibbles;
  return __byte_perm(lo | lo >> 4, hi | hi >> 4, 0x6420u);
}

// Byte i of the result is byte s_i of (lo, hi) for selector nibble s_i < 8
// and the msb of byte s_i & 7 replicated for s_i >= 8 (PTX default mode).
__device__ __forceinline__ unsigned lookup(unsigned lo, unsigned hi, unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return d;
}

__device__ __forceinline__ void mma(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                    unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int V>
__device__ __forceinline__ void mma(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                    unsigned a3, unsigned b0, unsigned b1) {
  if constexpr (V == kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

// Looked-up bytes 0, 1 (sel 0x1404) or 2, 3 (0x3424) as a bf16 pair.
__device__ __forceinline__ unsigned bf16_pair(unsigned x, unsigned sel) {
  return __byte_perm(x, 0, sel);
}

// Looked-up byte i as a tf32 word.
__device__ __forceinline__ unsigned tf32_word(unsigned x, int i) {
  return __byte_perm(x, 0, 0x0444u | (i << 12));
}

// Adds the 16 bytes of one chunk of this thread's t-group to the sums:
// their selectors s (lo | hi << 16) and r (halves swapped) are held by
// lanes src + 4j, j = 0..3, word j.  acc[0] is the n-tile of lo 0..7,
// acc[1] of lo 8..15; (tlo, thi) is the thread's table.
template <int V, typename T>
__device__ __forceinline__ void accumulate(T (&acc)[2][4], unsigned s, unsigned r, int src,
                                           unsigned tlo, unsigned thi) {
  unsigned ah[4], ah8[4], bl[4], bl8[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned lo = __shfl_sync(0xFFFFFFFFu, s, src + 4 * j);
    const unsigned hi = __shfl_sync(0xFFFFFFFFu, r, src + 4 * j);
    ah[j] = lookup(tlo, thi, hi);
    ah8[j] = lookup(tlo, thi, hi ^ kFlip);
    bl[j] = lookup(tlo, thi, lo);
    bl8[j] = lookup(tlo, thi, lo ^ kFlip);
  }
  if constexpr (V == kS8) {
    // One k = 32 step per word pair: word x holds k = 4t..4t+3 and word y
    // k = 16+4t..16+4t+3; the lookups are the int8 fragments.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int x = 2 * j, y = 2 * j + 1;
      mma(acc[0], ah[x], ah8[x], ah[y], ah8[y], bl[x], bl[y]);
      mma(acc[1], ah[x], ah8[x], ah[y], ah8[y], bl8[x], bl8[y]);
    }
  } else if constexpr (V == kBf16) {
    // One k = 16 step per word: bytes 0, 1 are k = 2t, 2t+1 and bytes 2, 3
    // k = 2t+8, 2t+9.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned a0 = bf16_pair(ah[i], 0x1404u), a1 = bf16_pair(ah8[i], 0x1404u);
      const unsigned a2 = bf16_pair(ah[i], 0x3424u), a3 = bf16_pair(ah8[i], 0x3424u);
      mma<V>(acc[0], a0, a1, a2, a3, bf16_pair(bl[i], 0x1404u), bf16_pair(bl[i], 0x3424u));
      mma<V>(acc[1], a0, a1, a2, a3, bf16_pair(bl8[i], 0x1404u), bf16_pair(bl8[i], 0x3424u));
    }
  } else {
    // Two k = 8 steps per word: bytes 2h and 2h+1 are k = t and t+4.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = 2 * h;
        const unsigned a0 = tf32_word(ah[i], b), a1 = tf32_word(ah8[i], b);
        const unsigned a2 = tf32_word(ah[i], b + 1), a3 = tf32_word(ah8[i], b + 1);
        mma<V>(acc[0], a0, a1, a2, a3, tf32_word(bl[i], b), tf32_word(bl[i], b + 1));
        mma<V>(acc[1], a0, a1, a2, a3, tf32_word(bl8[i], b), tf32_word(bl8[i], b + 1));
      }
    }
  }
}

// Moves the sums into the shared histogram and zeroes them.  Accumulator
// entry i of tile n is row g (+8 for i >= 2), column 8n + 2t + (i & 1).
template <typename T>
__device__ __forceinline__ void flush(T (&acc)[2][4], int* sh, int g, int t) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int v;
      if constexpr (std::is_same<T, int>::value) {
        v = acc[n][i];
      } else {
        v = __float2int_rn(acc[n][i] * 4.0f);  // a byte counts 0.5 * 0.5
      }
      if (v) atomicAdd(&sh[(g + (i >> 1) * 8) * 16 + 8 * n + 2 * t + (i & 1)], v);
      acc[n][i] = 0;
    }
  }
}

// One 128-byte warp step from the word w of this thread: its selectors,
// then both 64-byte chunks accumulated.
template <int V, typename T>
__device__ __forceinline__ void step(T (&acc)[2][4], unsigned w, int t, unsigned tlo,
                                     unsigned thi) {
  const unsigned s = selectors(w), r = __byte_perm(s, 0, 0x1032u);
  accumulate<V>(acc, s, r, t, tlo, thi);
  accumulate<V>(acc, s, r, 16 + t, tlo, thi);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    hist256_onehot_kernel(const unsigned* __restrict__ data, long long chunks,
                          int* __restrict__ out) {
  using T = typename std::conditional<V == kS8, int, float>::type;
  __shared__ int sh[256];
  sh[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned one = V == kS8 ? 0x01u : 0x3Fu;
  const unsigned tlo = g < 4 ? one << (8 * g) : 0u, thi = g < 4 ? 0u : one << (8 * (g - 4));
  T acc[2][4] = {};
  // Whole 512-byte iterations: lane l loads words 4l..4l+3 with one
  // 16-byte load, and its word u takes part in step u.  Which bytes make
  // up a step does not change the counts, only that each is counted once.
  const long long iters = chunks / 8;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const uint4* q = reinterpret_cast<const uint4*>(data) + warp * 32 + lane;
  int since = 0;
  for (long long it = warp; it < iters; it += warps, q += warps * 32) {
    const uint4 v = *q;
    step<V>(acc, v.x, t, tlo, thi);
    step<V>(acc, v.y, t, tlo, thi);
    step<V>(acc, v.z, t, tlo, thi);
    step<V>(acc, v.w, t, tlo, thi);
    if (++since == kFlushEvery) {
      flush(acc, sh, g, t);
      since = 0;
    }
  }
  // The last chunks % 8 chunks, by warp 0 in 128-byte steps: thread (g, t)
  // loads word g & 3 of t's 16 bytes of chunk g >> 2, and a half past the
  // end is not accumulated.
  const long long done = iters * 8;
  if (warp == 0) {
    for (long long c = done; c < chunks; c += 2) {
      const int half = g >> 2;
      const unsigned w = c + half < chunks ? data[c * 16 + half * 16 + t * 4 + (g & 3)] : 0u;
      const unsigned s = selectors(w), r = __byte_perm(s, 0, 0x1032u);
      accumulate<V>(acc, s, r, t, tlo, thi);
      if (c + 1 < chunks) accumulate<V>(acc, s, r, 16 + t, tlo, thi);
    }
  }
  flush(acc, sh, g, t);
  __syncthreads();
  const int v = sh[threadIdx.x];
  if (v) atomicAdd(&out[threadIdx.x], v);
}

}  // namespace

// Counts the n bytes at data (n a multiple of 64, data 16-byte aligned)
// into out[256] with the MMA type `variant` (0 s8, 1 bf16, 2 tf32).
// Returns the CUDA error code of the memset and launch (0 on success).
extern "C" int hist256_onehot_launch(const void* data, long long n, int variant,
                                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || n % 64 != 0 || variant < kS8 || variant > kTf32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaMemsetAsync(out, 0, 256 * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long chunks = n / 64;
  if (chunks == 0) return static_cast<int>(cudaGetLastError());
  // As many iterations for every warp as can be: the fewest a warp that
  // kMaxBlocks allow, then the fewest blocks that need no more.
  const long long iters = chunks / 8;
  const long long per_warp = (iters + kMaxBlocks * kWarps - 1) / (kMaxBlocks * kWarps);
  long long blocks = per_warp ? (iters + per_warp * kWarps - 1) / (per_warp * kWarps) : 1;
  const unsigned* d = static_cast<const unsigned*>(data);
  int* o = static_cast<int*>(out);
  const int grid = static_cast<int>(blocks);
  if (variant == kS8) {
    hist256_onehot_kernel<kS8><<<grid, kThreads, 0, s>>>(d, chunks, o);
  } else if (variant == kBf16) {
    hist256_onehot_kernel<kBf16><<<grid, kThreads, 0, s>>>(d, chunks, o);
  } else {
    hist256_onehot_kernel<kTf32><<<grid, kThreads, 0, s>>>(d, chunks, o);
  }
  return static_cast<int>(cudaGetLastError());
}
