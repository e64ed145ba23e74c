// bench_ops: the measurement harness's two device passes around the codec.
//
//  carry: out = x + isnan(*acc) for a contiguous u8 or int32 tensor x
//         and the sustained loop's float32 accumulator acc on the device
//         (the carried 0 of a sustained body; 1 once acc is NaN); u8
//         wraps mod 256.
//  fold:  *acc += float32(the sum of one to four contiguous u8 or int32
//         tensors in int32 arithmetic that wraps mod 2^32), in one launch.
//
// Replaces no Pallas kernel.  One iteration of the JAX harness's loop
// (huffman_tpu/bench/harness.py:40-42) is
//   pert = jnp.isnan(acc).astype(jnp.uint8); acc + body(pert)
// around bodies that write ``d + pert`` and end in
// ``(jnp.sum(bits) + jnp.sum(t["enc_table"])).astype(jnp.float32)`` or
// ``jnp.sum(o.astype(jnp.int32)).astype(jnp.float32)`` (bench.py:172-190,
// the tools' bodies), which XLA turns into one vectorised pass each, the
// NaN test, the conversions and the float add placed in those fusions.
// PyTorch's eager ops take a launch for each of those scalar steps, its u8
// add runs near a quarter of the card's memory rate, and its int32 sum of
// u8 first writes a 4x wider copy.  These kernels are those fusions by
// hand: a sustained step launches the codec's kernels, one carry and one
// fold, and nothing else.
//
// Bound on the H100: device memory.  carry reads n bytes and writes n;
// fold reads the bytes of its tensors and writes 4.
//
// Design: both stream their tensors as 16-byte vectors, one a thread per
// step of a grid-stride loop, kUnroll steps' loads in flight at once, on
// at most kBlocksPerSm blocks an SM.
//  - carry: the output comes from PyTorch's allocator, 16-byte aligned;
//    the input may be a view at any byte offset m.  Each output vector is
//    cut from the two aligned input vectors that hold its bytes by
//    funnel shifts (the word offset m / 4 a template argument, so the
//    eight words stay in registers; the byte shift runtime), so every
//    load and store is a whole aligned vector.  u8 adds the carried value
//    to each byte of a word with one __vadd4.  The ragged tail (under 16
//    bytes) goes element by element in block 0.  The NaN test reads acc
//    on the device, never on the host, so a step can be captured in a
//    CUDA graph.
//  - fold: the sum does not care about order, so each tensor's head
//    before its first 16-byte boundary and its tail are summed element by
//    element in block 0, and the aligned body as vectors: u8 by __dp4a
//    against 0x01010101 (four bytes into the sum in one instruction),
//    int32 by adds.  The tensors' descriptors travel in the kernel's
//    parameters.  Each thread's sum goes through a warp shuffle and the
//    block's warps in shared memory; each block then adds 2^48 + its
//    sum to one 64-bit scratch word with one atomicAdd: the low 48 bits
//    gather the sums (under 2^11 blocks of 32-bit sums never carry out of
//    them) and the high 16 count the blocks done.  The block whose add
//    finds gridDim.x - 1 blocks done is the last: the value it read plus
//    its own is every block's total, with no second read and no fence.
//    It zeroes the word and adds __int2float_rn(the total's low 32 bits)
//    to *acc (round to nearest, as XLA's convert; one int32 total then one
//    conversion, as ``(jnp.sum(a) + jnp.sum(b)).astype(jnp.float32)``).
//    So no memset runs, graph replays start from a zeroed word, and the
//    scratch comes from PyTorch's allocator (bytes 8-15 of the
//    accumulator's storage).  Unsigned arithmetic throughout: the sum
//    wraps mod 2^32, the same bits as XLA's int32 reduction.
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads an SM
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;

// The 16 output bytes that start m = 4 * kQ + rbits / 8 bytes into lo,
// hi holding the 16 bytes after lo.
template <int kQ>
__device__ __forceinline__ uint4 shifted(const uint4& lo, const uint4& hi, int rbits) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return make_uint4(__funnelshift_r(w[kQ], w[kQ + 1], rbits),
                    __funnelshift_r(w[kQ + 1], w[kQ + 2], rbits),
                    __funnelshift_r(w[kQ + 2], w[kQ + 3], rbits),
                    __funnelshift_r(w[kQ + 3], w[kQ + 4], rbits));
}

// Each byte (kBytes) or each word of v plus p.
template <bool kBytes>
__device__ __forceinline__ uint4 add4(const uint4& v, uint32_t p) {
  if (kBytes) {
    const uint32_t p4 = p * 0x01010101u;
    return make_uint4(__vadd4(v.x, p4), __vadd4(v.y, p4), __vadd4(v.z, p4), __vadd4(v.w, p4));
  }
  return make_uint4(v.x + p, v.y + p, v.z + p, v.w + p);
}

// Vector j of dst = vector j of the n bytes at src + m, plus isnan(*acc)
// per element, for j < vecs = n / 16; then the tail bytes [16 * vecs, n).
// src is 16-byte aligned; m = 4 * kQ + rbits / 8.
template <bool kBytes, int kQ>
__global__ void __launch_bounds__(kThreads)
    carry_kernel(const uint8_t* __restrict__ src, int rbits, long long n,
                 const float* __restrict__ acc, uint8_t* __restrict__ dst) {
  const float a = *acc;
  const uint32_t p = a != a ? 1u : 0u;  // the NaN test: IEEE compares, no fast math
  const long long vecs = n >> 4;
  const bool split = kQ != 0 || rbits != 0;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j0 < vecs;
       j0 += stride * kUnroll) {
    uint4 lo[kUnroll], hi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * stride;
      if (j < vecs) {
        lo[u] = s[j];
        // With m > 0, vector j + 1 holds byte m + 16 j + 15 < m + n.
        if (split) hi[u] = s[j + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * stride;
      if (j < vecs) d[j] = add4<kBytes>(split ? shifted<kQ>(lo[u], hi[u], rbits) : lo[u], p);
    }
  }
  if (blockIdx.x == 0) {
    const uint8_t* x = src + 4 * kQ + (rbits >> 3);
    const long long tail = vecs << 4;
    if (kBytes) {
      const long long i = tail + threadIdx.x;
      if (i < n) dst[i] = static_cast<uint8_t>(x[i] + p);
    } else {
      const long long i = tail + 4 * threadIdx.x;
      if (i < n) {
        *reinterpret_cast<uint32_t*>(dst + i) = *reinterpret_cast<const uint32_t*>(x + i) + p;
      }
    }
  }
}

template <bool kBytes>
__device__ __forceinline__ uint32_t sum16(const uint4& v, uint32_t acc) {
  if (kBytes) {
    constexpr unsigned kOnes = 0x01010101u;
    return __dp4a(v.w, kOnes, __dp4a(v.z, kOnes, __dp4a(v.y, kOnes, __dp4a(v.x, kOnes, acc))));
  }
  return acc + v.x + v.y + v.z + v.w;
}

// The elements of [lo, hi) bytes of x that thread t of block 0 owns.
template <bool kBytes>
__device__ __forceinline__ uint32_t sum_edge(const uint8_t* x, long long lo, long long hi) {
  const long long i = lo + (kBytes ? 1 : 4) * static_cast<long long>(threadIdx.x);
  if (i >= hi) return 0;
  return kBytes ? x[i] : *reinterpret_cast<const uint32_t*>(x + i);
}

constexpr int kMaxParts = 4;

// One tensor of a fold: n bytes at x as elem-byte elements, whose aligned
// body starts head bytes in (head < 16).
struct Part {
  const uint8_t* x;
  long long n;
  int head;
  int elem;
};

struct Parts {
  Part p[kMaxParts];
  int count;
};

// acc plus this thread's share of the sum of one tensor, mod 2^32.
template <bool kBytes>
__device__ __forceinline__ uint32_t sum_part(const Part& q, uint32_t acc) {
  const long long vecs = (q.n - q.head) >> 4;
  const uint4* body = reinterpret_cast<const uint4*>(q.x + q.head);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j0 < vecs;
       j0 += stride * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * stride;
      if (j < vecs) v[u] = body[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j0 + u * stride < vecs) acc = sum16<kBytes>(v[u], acc);
  }
  if (blockIdx.x == 0) {
    acc += sum_edge<kBytes>(q.x, 0, q.head);
    acc += sum_edge<kBytes>(q.x, q.head + (vecs << 4), q.n);
  }
  return acc;
}

// The scratch word: blocks done in the high bits, their sums below.
constexpr int kDoneShift = 48;
constexpr unsigned long long kSumMask = (1ull << kDoneShift) - 1;
constexpr int kMaxBlocks = 1 << 11;  // 2^11 sums under 2^32 stay under 2^43

// *acc += float32(the sum of the parts' elements mod 2^32, as int32).
// *scratch is 0 on entry and on exit.
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const Parts parts, float* __restrict__ acc,
                unsigned long long* __restrict__ scratch) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < kMaxParts; ++i) {
    if (i < parts.count) {
      sum = parts.p[i].elem == 1 ? sum_part<true>(parts.p[i], sum)
                                 : sum_part<false>(parts.p[i], sum);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp != 0) return;
  sum = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (lane != 0) return;
  const unsigned long long before = atomicAdd(scratch, (1ull << kDoneShift) + sum);
  if ((before >> kDoneShift) != gridDim.x - 1) return;
  const auto total = static_cast<uint32_t>((before & kSumMask) + sum);
  *scratch = 0;
  *acc = __fadd_rn(*acc, __int2float_rn(static_cast<int>(total)));
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

// One thread a vector, at most kBlocksPerSm blocks an SM, at least one
// block (the tail and the edges run in block 0).
cudaError_t grid_for(long long vecs, int* blocks) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  long long b = (vecs + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(kBlocksPerSm) * sms;
  *blocks = static_cast<int>(b < 1 ? 1 : (b > most ? most : b));
  return cudaSuccess;
}

template <bool kBytes>
void carry_dispatch(int q, int grid, cudaStream_t s, const uint8_t* src, int rbits, long long n,
                    const float* acc, uint8_t* dst) {
  switch (q) {
    case 0: carry_kernel<kBytes, 0><<<grid, kThreads, 0, s>>>(src, rbits, n, acc, dst); break;
    case 1: carry_kernel<kBytes, 1><<<grid, kThreads, 0, s>>>(src, rbits, n, acc, dst); break;
    case 2: carry_kernel<kBytes, 2><<<grid, kThreads, 0, s>>>(src, rbits, n, acc, dst); break;
    default: carry_kernel<kBytes, 3><<<grid, kThreads, 0, s>>>(src, rbits, n, acc, dst); break;
  }
}

}  // namespace

// out = x + isnan(*acc) over nbytes bytes of elem_bytes-byte elements
// (1: u8, wrapping mod 256; 4: int32, wrapping mod 2^32).  x may lie at
// any element-aligned address; out must be 16-byte aligned; acc is one
// float32 on the device.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int carry_launch(const void* x, long long nbytes, int elem_bytes, const void* acc,
                            void* out, void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  if ((elem_bytes != 1 && elem_bytes != 4) || nbytes % elem_bytes != 0 ||
      a % elem_bytes != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0;
  cudaError_t e = grid_for(nbytes >> 4, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int m = static_cast<int>(a & 15);
  const uint8_t* src = static_cast<const uint8_t*>(x) - m;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const float*>(acc);
  auto* dst = static_cast<uint8_t*>(out);
  if (elem_bytes == 1) {
    carry_dispatch<true>(m >> 2, grid, s, src, 8 * (m & 3), nbytes, pa, dst);
  } else {
    carry_dispatch<false>(m >> 2, grid, s, src, 0, nbytes, pa, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

// *acc += float32(the sum of count tensors, tensor i nbytes[i] bytes at
// xs[i] as elem_bytes[i]-byte elements (1: u8, 4: int32), in int32
// arithmetic that wraps mod 2^32, rounded to nearest).  1 <= count <= 4;
// each xs[i] may lie at any element-aligned address.  scratch is one
// 8-byte-aligned 64-bit word on the device, 0 on entry; the kernel leaves
// it 0.  Returns the CUDA error code of the launch (0 on success).
extern "C" int fold_launch(const void* const* xs, const long long* nbytes,
                           const int* elem_bytes, int count, void* acc, void* scratch,
                           void* stream) {
  if (count < 1 || count > kMaxParts || reinterpret_cast<uintptr_t>(acc) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Parts parts = {};
  parts.count = count;
  long long vecs = 0;
  for (int i = 0; i < count; ++i) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(xs[i]);
    const long long n = nbytes[i];
    const int elem = elem_bytes[i];
    if ((elem != 1 && elem != 4) || n < 0 || n % elem != 0 || a % elem != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long to16 = static_cast<long long>((16 - (a & 15)) & 15);
    const int head = static_cast<int>(n < to16 ? n : to16);
    parts.p[i] = {static_cast<const uint8_t*>(xs[i]), n, head, elem};
    vecs += (n - head) >> 4;
  }
  int grid = 0;
  cudaError_t e = grid_for(vecs, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grid > kMaxBlocks) return static_cast<int>(cudaErrorInvalidConfiguration);
  fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      parts, static_cast<float*>(acc), static_cast<unsigned long long*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
