// bench_ops: the measurement harness's two device passes around the codec.
//
//  carry:    out = x + pert for a contiguous u8 or int32 tensor x and a
//            u8 pert that lies on the device (the carried 0 of a
//            sustained body); u8 wraps mod 256.
//  checksum: the sum of a contiguous u8 or int32 tensor in int32
//            arithmetic that wraps mod 2^32, into one int32 word.
//
// Replaces no Pallas kernel.  The JAX harness bodies (bench.py:172-190,
// huffman_tpu/bench/harness.py:127-145, the tools' bodies) write
// ``d + pert`` and ``jnp.sum(o.astype(jnp.int32))``, which XLA turns into
// one vectorised pass each: the sum reads the bytes once with the
// widening fused in.  PyTorch's eager ops do not: its u8 add runs near a
// quarter of the card's memory rate, and its int32 sum of u8 first writes
// a 4x wider copy.  These kernels are those fusions by hand.
//
// Bound on the H100: device memory.  carry reads n bytes and writes n;
// checksum reads n bytes and writes 4.
//
// Design: both stream the tensor as 16-byte vectors, one a thread per
// step of a grid-stride loop, kUnroll steps' loads in flight at once, on
// at most kBlocksPerSm blocks an SM.
//  - carry: the output comes from PyTorch's allocator, 16-byte aligned;
//    the input may be a view at any byte offset m.  Each output vector is
//    cut from the two aligned input vectors that hold its bytes by
//    funnel shifts (the word offset m / 4 a template argument, so the
//    eight words stay in registers; the byte shift runtime), so every
//    load and store is a whole aligned vector.  u8 adds pert to each byte
//    of a word with one __vadd4.  The ragged tail (under 16 bytes) goes
//    element by element in block 0.  pert is read on the device, never on
//    the host, so a step that carries it can be captured in a CUDA graph.
//  - checksum: the sum does not care about order, so the input's head
//    before its first 16-byte boundary and its tail are summed element by
//    element in block 0, and the aligned body as vectors: u8 by __dp4a
//    against 0x01010101 (four bytes into the sum in one instruction),
//    int32 by adds.  Each thread's sum goes through a warp shuffle and
//    the block's warps in shared memory, and each block adds its sum into
//    the result with one atomicAdd.  The C entry zeroes the result word
//    first with cudaMemsetAsync: no scratch, no ticket, nothing allocated
//    outside PyTorch's allocator, and both the memset and the launch can
//    be captured in a CUDA graph.  Unsigned arithmetic throughout: it
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

// Vector j of dst = vector j of the n bytes at src + m, plus *pert per
// element, for j < vecs = n / 16; then the tail bytes [16 * vecs, n).
// src is 16-byte aligned; m = 4 * kQ + rbits / 8.
template <bool kBytes, int kQ>
__global__ void __launch_bounds__(kThreads)
    carry_kernel(const uint8_t* __restrict__ src, int rbits, long long n,
                 const uint8_t* __restrict__ pert, uint8_t* __restrict__ dst) {
  const uint32_t p = *pert;
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

// *out += the sum of the n bytes at x, as u8 or int32 elements, mod 2^32;
// the aligned body starts head bytes in (head < 16).
template <bool kBytes>
__global__ void __launch_bounds__(kThreads)
    checksum_kernel(const uint8_t* __restrict__ x, long long n, int head,
                    unsigned* __restrict__ out) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const long long vecs = (n - head) >> 4;
  const uint4* body = reinterpret_cast<const uint4*>(x + head);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint32_t acc = 0;
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
    acc += sum_edge<kBytes>(x, 0, head);
    acc += sum_edge<kBytes>(x, head + (vecs << 4), n);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) atomicAdd(out, acc);
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
                    const uint8_t* pert, uint8_t* dst) {
  switch (q) {
    case 0: carry_kernel<kBytes, 0><<<grid, kThreads, 0, s>>>(src, rbits, n, pert, dst); break;
    case 1: carry_kernel<kBytes, 1><<<grid, kThreads, 0, s>>>(src, rbits, n, pert, dst); break;
    case 2: carry_kernel<kBytes, 2><<<grid, kThreads, 0, s>>>(src, rbits, n, pert, dst); break;
    default: carry_kernel<kBytes, 3><<<grid, kThreads, 0, s>>>(src, rbits, n, pert, dst); break;
  }
}

}  // namespace

// out = x + *pert over nbytes bytes of elem_bytes-byte elements (1: u8,
// wrapping mod 256; 4: int32, wrapping mod 2^32).  x may lie at any
// element-aligned address; out must be 16-byte aligned; pert is one u8
// on the device.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int carry_launch(const void* x, long long nbytes, int elem_bytes, const void* pert,
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
  const auto* p = static_cast<const uint8_t*>(pert);
  auto* dst = static_cast<uint8_t*>(out);
  if (elem_bytes == 1) {
    carry_dispatch<true>(m >> 2, grid, s, src, 8 * (m & 3), nbytes, p, dst);
  } else {
    carry_dispatch<false>(m >> 2, grid, s, src, 0, nbytes, p, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

// *out = the sum of nbytes bytes at x as elem_bytes-byte elements (1: u8,
// 4: int32), in int32 arithmetic that wraps mod 2^32.  x may lie at any
// element-aligned address.  Returns the CUDA error code of the memset and
// launch (0 on success).
extern "C" int checksum_launch(const void* x, long long nbytes, int elem_bytes, void* out,
                               void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  if ((elem_bytes != 1 && elem_bytes != 4) || nbytes % elem_bytes != 0 || a % elem_bytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long to16 = static_cast<long long>((16 - (a & 15)) & 15);
  const int head = static_cast<int>(nbytes < to16 ? nbytes : to16);
  int grid = 0;
  cudaError_t e = grid_for((nbytes - head) >> 4, &grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(out, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* px = static_cast<const uint8_t*>(x);
  auto* po = static_cast<unsigned*>(out);
  if (elem_bytes == 1) {
    checksum_kernel<true><<<grid, kThreads, 0, s>>>(px, nbytes, head, po);
  } else {
    checksum_kernel<false><<<grid, kThreads, 0, s>>>(px, nbytes, head, po);
  }
  return static_cast<int>(cudaGetLastError());
}
