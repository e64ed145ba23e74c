// hist256_onehot: 256-bin byte histogram by nibble one-hot products on the
// tensor cores.
//
// Replaces tools/hist_experiments.py:make_kernel (entry hist_variant), the
// histogram variants raced on the TPU.  Like them it counts bin 16*hi + lo
// as entry (hi, lo) of the sum over all bytes of the outer product of the
// hi-nibble and lo-nibble one-hots: a (16 x n) by (n x 16) matrix product.
// The TPU variants differ in the compare's type and the rows per dot, which
// choose how Mosaic builds the one-hot in VMEM; here integer compares build
// it in registers whatever the product's type, and the instruction fixes
// the k depth, so the five TPU variants become three MMA input types:
// s8 (i8dot, m16n8k32, int32 sums), bf16 (base, bf16cmp, wide, m16n8k16,
// f32 sums) and tf32 (f32cmp, m16n8k8, f32 sums).
//
// Bound on the H100: 16 MiB is 5.0 us of device-memory traffic; the
// product is 512 operations a byte, 4.3 us at the s8 dense peak, 8.7 us at
// bf16's and 17.4 us at tf32's.  The one-hot build is integer work outside
// the tensor cores: per 4 bytes a thread extracts both nibble words (3
// instructions) and tests them against its two hi rows and two lo columns
// (3 instructions each, 4 bytes at a time), and every thread of a
// t-group repeats this for its own rows, so it probably sets the bound.
//
// Design: 8 warps a block, a grid of blocks striding over 64-byte chunks,
// one chunk per warp step (each of the warp's four t-groups loads its own
// 16 bytes, a 64-byte coalesced access).  In the mma fragments a thread
// (group g = lane/4, t = lane%4) holds the A rows g and g+8 and the B column
// g of the k positions that belong to its t, so the 8 threads of a t-group
// share the same bytes, and each builds its one-hot entries from them with
// byte-wise compares.  The 16 x 16 sums stay in registers (two n = 8 tiles)
// and are flushed into the block's int32 shared histogram every 64 steps
// (16 KiB a warp, far below the 2^24 at which an f32 sum stops being
// exact), so the int32 result is exact for any n < 2^31.  Each block adds
// its bins to the output with one atomic per nonzero bin.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // chunks loaded ahead per warp step
constexpr int kFlushEvery = 64;  // warp steps between flushes of the sums
constexpr long long kMaxBlocks = 1056;  // 8 blocks on each of 132 SMs
constexpr unsigned kOnes = 0x01010101u;
constexpr unsigned kHigh = 0x80808080u;
constexpr unsigned kNibbles = 0x0F0F0F0Fu;

enum Variant { kS8 = 0, kBf16 = 1, kTf32 = 2 };

// 0x80 in each byte where v equals c, 0 elsewhere (bytes below 0x80).
__device__ __forceinline__ unsigned eq_bytes(unsigned v, unsigned c) {
  return ~(((v ^ c) | kHigh) - kOnes) & kHigh;
}

// Bytes 0 and 1 (or 2 and 3) of a 0x80 mask as two bf16 1.0 / 0.0.
__device__ __forceinline__ unsigned bf16_pair(unsigned m, unsigned sel) {
  return __byte_perm(m, 0, sel) * 0x7Fu;  // 0x80 * 0x7F = 0x3F80
}

// Byte i of a 0x80 mask as an f32 (tf32) 1.0 / 0.0.
__device__ __forceinline__ unsigned f32_one(unsigned m, int i) {
  return __byte_perm(m, 0, 0x4044u | (i << 8)) * 0x7Fu;  // 0x800000 * 0x7F
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

// Adds the 16 bytes q of this thread's t-group to the sums.  acc[0] is the
// n-tile of lo 0..7, acc[1] of lo 8..15; G and G8 hold g and g + 8 in
// every byte.
template <int V, typename T>
__device__ __forceinline__ void accumulate(T (&acc)[2][4], uint4 q, unsigned G,
                                           unsigned G8) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  unsigned ah[4], ah8[4], bl[4], bl8[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned hi = (w[i] >> 4) & kNibbles, lo = w[i] & kNibbles;
    ah[i] = eq_bytes(hi, G);
    ah8[i] = eq_bytes(hi, G8);
    bl[i] = eq_bytes(lo, G);
    bl8[i] = eq_bytes(lo, G8);
  }
  if constexpr (V == kS8) {
    // One k = 32 step per word pair: word x holds k = 4t..4t+3 and word y
    // k = 16+4t..16+4t+3; the masks become int8 ones.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int x = 2 * j, y = 2 * j + 1;
      const unsigned a0 = ah[x] >> 7, a1 = ah8[x] >> 7, a2 = ah[y] >> 7, a3 = ah8[y] >> 7;
      mma(acc[0], a0, a1, a2, a3, bl[x] >> 7, bl[y] >> 7);
      mma(acc[1], a0, a1, a2, a3, bl8[x] >> 7, bl8[y] >> 7);
    }
  } else if constexpr (V == kBf16) {
    // One k = 16 step per word: bytes 0, 1 are k = 2t, 2t+1 and bytes 2, 3
    // k = 2t+8, 2t+9.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned a0 = bf16_pair(ah[i], 0x4140u), a1 = bf16_pair(ah8[i], 0x4140u);
      const unsigned a2 = bf16_pair(ah[i], 0x4342u), a3 = bf16_pair(ah8[i], 0x4342u);
      mma<V>(acc[0], a0, a1, a2, a3, bf16_pair(bl[i], 0x4140u), bf16_pair(bl[i], 0x4342u));
      mma<V>(acc[1], a0, a1, a2, a3, bf16_pair(bl8[i], 0x4140u), bf16_pair(bl8[i], 0x4342u));
    }
  } else {
    // Two k = 8 steps per word: bytes 2h and 2h+1 are k = t and t+4.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = 2 * h;
        const unsigned a0 = f32_one(ah[i], b), a1 = f32_one(ah8[i], b);
        const unsigned a2 = f32_one(ah[i], b + 1), a3 = f32_one(ah8[i], b + 1);
        mma<V>(acc[0], a0, a1, a2, a3, f32_one(bl[i], b), f32_one(bl[i], b + 1));
        mma<V>(acc[1], a0, a1, a2, a3, f32_one(bl8[i], b), f32_one(bl8[i], b + 1));
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
        v = __float2int_rn(acc[n][i]);
      }
      if (v) atomicAdd(&sh[(g + (i >> 1) * 8) * 16 + 8 * n + 2 * t + (i & 1)], v);
      acc[n][i] = 0;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    hist256_onehot_kernel(const uint4* __restrict__ data, long long chunks,
                          int* __restrict__ out) {
  using T = typename std::conditional<V == kS8, int, float>::type;
  __shared__ int sh[256];
  sh[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned G = g * kOnes, G8 = (g + 8) * kOnes;
  T acc[2][4] = {};
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  int steps = 0;
  for (long long c = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       c < chunks; c += warps * kUnroll) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * warps < chunks) q[u] = data[(c + u * warps) * 4 + t];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * warps < chunks) accumulate<V>(acc, q[u], G, G8);
    }
    if (++steps == kFlushEvery) {
      flush(acc, sh, g, t);
      steps = 0;
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
  long long blocks = (chunks + kWarps * kUnroll - 1) / (kWarps * kUnroll);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const uint4* d = static_cast<const uint4*>(data);
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
