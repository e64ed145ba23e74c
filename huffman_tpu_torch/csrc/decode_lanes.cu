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
// Bound on the H100 (PERF.md §6, by tools/kernel_ab.py on an NVIDIA H100
// 80GB HBM3 at 700 W): device traffic is only the payload bits and s*K
// output bytes, ~7.3 us for the 16 MiB block at the published 3.35 TB/s,
// but each lane is a serial chain of two dependent shared-memory lookups
// a pair of symbols, and the SM's integer pipe takes a warp's integer
// instruction every other cycle.  At 16 MiB with the L2 warm the kernel
// takes 17.3 us; with a fixed 4-bit code and no lookup 8.5 us, with
// lookups that all hit one entry a warp (no bank conflicts) 16.0 us.
// Eight blocks in turns, as the benchmark's requests, find their words
// in device memory: 22.9 us a block, 24.6 without the rows asked into L2
// at the start.
//
// Design:
// - Bit reader: the two words that hold the next bits (hi, lo) and the
//   bit position pos, whose low 5 bits are the offset into hi; one
//   __funnelshift_l gives the next 32 bits, enough for two symbols (the
//   second is that window shifted by the first's length).  A refill, at
//   most one a pair, moves lo into hi and the word loaded a refill before
//   into lo, and loads the next: predicated, so no lane waits on another's
//   branch, its moves f32 selects and its address steps multiply-adds, so
//   that they issue off the integer pipe; rows from n_words on read as
//   zero.  The first three words load before the tables are built, and
//   the next kPrefetch rows are asked into L2 then.
// - First-level table: (byte | len << 8) for each kLut-bit prefix of the
//   15-bit window whose code is at most kLut bits; kEsc where it is
//   longer.  The length is nondecreasing in the window and every
//   boundary e_bound[l], l <= kLut, is a multiple of 2^(15-l), so a
//   prefix below e_bound[kLut] has one length and one rank: the entry is
//   exact for every window, and the escapes are exactly the windows from
//   e_bound[kLut] on.  The table is stored kCopies times, interleaved by
//   word, and lane t of a warp reads copy t % kCopies, which spreads a
//   warp's lookups over more banks; its address is a multiply-add.
// - Second-level table: the entry of every window from e_bound[kLut] on,
//   (byte | len << 8) as u16, indexed by window - e_bound[kLut]; a
//   complete code of 256 symbols needs at most 256 << (14 - kLut) of
//   them.  A pair whose first-level entries are both hits takes no
//   branch; otherwise the pair is decoded again with one more load for
//   each long code.  Windows past kL2 entries (codings that are not
//   complete, such as the all-zero table) take the canonical search.
// - Both tables are built by each thread block in shared memory before it
//   decodes (kSmemBytes, dynamic), each first-level entry by one binary
//   search over e_bound and stored kCopies times with 16-byte stores.
// - Threads a block: chosen by the launcher from K and B and the
//   occupancy the card reports, so that the busiest SM decodes the
//   fewest lanes (a table build counted as kBuildLanes lanes).
//
// Layout: one thread block per T lanes of block b; a batch of B blocks
// (the vmapped decode of _decode_batch in models/tpu_codec.py) is one
// launch of a flat grid of B * ceil(K/T) thread blocks, and a single
// block is B = 1.  Lane k of block b reads words[b][w*K + k] and writes
// out[b][r*K + k]; block b's words are `pitch` rows apart, of which the
// first n_words are read.
// The canonical search (huffman_tpu/ops/decode_bits.py): win = the top 15
// bits, len = 1 + #{l in 1..14 : win >= e_bound[l]}, rank =
// clip((win >> (15-len)) + g_rank[len], 0, 255), byte = syms[rank].  A
// single-symbol block (every e_bound 2^15) has one first-level entry of
// length 1 for every prefix, rank clip(g_rank[1] + 0 or 1) = 0.
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL = 15;
constexpr int kLut = 11;  // window bits that the first-level table resolves
constexpr int kCopies = 4;  // copies of the first-level table, by lane
constexpr int kL2 = 2048;  // second-level entries
constexpr int kUnroll = 8;  // pairs of symbols a loop step
constexpr int kPrefetch = 12;  // rows after the first three that a lane asks into L2 at its start
constexpr int kMaxThreads = 1024;  // the launcher tries this, half and a quarter
constexpr int kBuildLanes = 128;  // a table build, in lanes decoded
constexpr uint32_t kEsc = 1u << 31;  // a first-level entry whose code is longer
constexpr int kL1Words = kCopies << kLut;
constexpr int kSmemBytes = kL1Words * 4 + kL2 * 2;
static_assert((kCopies & (kCopies - 1)) == 0, "kCopies must be a power of two");
constexpr int log2i(int x) { return x > 1 ? 1 + log2i(x / 2) : 0; }
constexpr int kEntryShift = log2i(kCopies * 4);  // bytes between entries, as a shift

// The canonical (byte | len << 8) of a 15-bit window: len by a binary
// search over bound (e_bound[1..14], then two that no window reaches).
__device__ __forceinline__ uint32_t canonical(int win, const int* bound, const int* gr,
                                              const uint8_t* sy) {
  int c = 0;
#pragma unroll
  for (int step = 8; step > 0; step >>= 1) c += win >= bound[c + step - 1] ? step : 0;
  const int len = c + 1;
  return static_cast<uint32_t>(len << 8 | sy[min(max((win >> (kL - len)) + gr[len], 0), 255)]);
}

// The first-level entry of the window at the top of w: from this lane's
// copy, whose first word is at shared address base, entries stride bytes
// apart (a register, so that the address is one multiply-add, which
// issues to the FMA pipe and not the integer pipe).
__device__ __forceinline__ uint32_t first_level(uint32_t base, uint32_t stride, uint32_t w) {
  uint32_t e;
  asm volatile(
      "{\n\t.reg .u32 a;\n\t"
      "shr.u32 a, %1, %4;\n\t"
      "mad.lo.u32 a, a, %2, %3;\n\t"
      "ld.shared.u32 %0, [a];\n\t}"
      : "=r"(e)
      : "r"(w), "r"(stride), "r"(base), "n"(32 - kLut));
  return e;
}

// The entry of a window whose code is longer than kLut bits.
__device__ __forceinline__ uint32_t second_level(uint32_t w, int ek, int n2, const uint16_t* l2,
                                                 const int* bound, const int* gr,
                                                 const uint8_t* sy) {
  const int win = static_cast<int>(w >> (32 - kL));
  const unsigned j = static_cast<unsigned>(win - ek);
  return j < static_cast<unsigned>(n2) ? l2[j] : canonical(win, bound, gr, sy);
}

// One lane's bit reader and output.  hi and lo hold the bits from pos on
// (pos's low 5 bits are its offset into hi), nx the word after lo, loaded
// a refill ahead; src points at the word after nx, dst at the next byte.
struct Lane {
  uint32_t hi, lo, nx;
  int pos, next;  // bits taken; the bit at which lo starts
  const uint32_t* src;
  uint8_t* dst;
};

// Where pos has passed into lo: lo moves to hi, nx to lo, and the word at
// src loads into nx (zero from row n_words on, where next reaches last).
// Predicated, so no lane waits on another's branch, and no instruction
// takes the word being loaded.  The three moves are f32 selects, so that
// they issue to the FP pipe and not the integer pipe (the bits pass
// unchanged); one is 1 in a register, so that the step of src is a
// multiply-add.
__device__ __forceinline__ void refill(Lane& l, int last, int k4, int one) {
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t.reg .f32 h, m, n;\n\t"
      "mov.b32 h, %0;\n\tmov.b32 m, %1;\n\tmov.b32 n, %2;\n\t"
      "setp.ge.s32 p, %5, %3;\n\t"
      "setp.lt.and.s32 q, %3, %6, p;\n\t"
      "selp.f32 h, m, h, p;\n\t"
      "selp.f32 m, n, m, p;\n\t"
      "selp.f32 n, 0f00000000, n, p;\n\t"
      "mov.b32 %0, h;\n\tmov.b32 %1, m;\n\tmov.b32 %2, n;\n\t"
      "@q ld.global.nc.u32 %2, [%4];\n\t"
      "@p add.s32 %3, %3, 32;\n\t"
      "@p mad.wide.s32 %4, %7, %8, %4;\n\t}"
      : "+r"(l.hi), "+r"(l.lo), "+r"(l.nx), "+r"(l.next), "+l"(l.src)
      : "r"(l.pos), "r"(last), "r"(k4), "r"(one));
}

// Stores two symbols to rows r and r + 1 of the lane and steps dst by 2k;
// one is 1 in a register, so the steps are multiply-adds.
__device__ __forceinline__ void store_pair(Lane& l, uint32_t e1, uint32_t e2, int k, int one) {
  asm volatile(
      "{\n\t.reg .u64 d;\n\t"
      "st.global.u8 [%0], %1;\n\t"
      "mad.wide.s32 d, %3, %4, %0;\n\t"
      "st.global.u8 [d], %2;\n\t"
      "mad.wide.s32 %0, %3, %4, d;\n\t}"
      : "+l"(l.dst)
      : "r"(e1), "r"(e2), "r"(k), "r"(one)
      : "memory");
}

// A pair whose first-level entries were not both hits, decoded again
// with the second level: (e1, e2).
__device__ __forceinline__ uint2 long_pair(uint32_t w, uint32_t base, uint32_t stride, uint32_t e1,
                                           int ek, int n2,
                                           const uint16_t* l2, const int* bound, const int* gr,
                                           const uint8_t* sy) {
  if (e1 & kEsc) e1 = second_level(w, ek, n2, l2, bound, gr, sy);
  const uint32_t w2 = w << (e1 >> 8);
  uint32_t e2 = first_level(base, stride, w2);
  if (e2 & kEsc) e2 = second_level(w2, ek, n2, l2, bound, gr, sy);
  return make_uint2(e1, e2);
}

__global__ void __launch_bounds__(kMaxThreads)
    decode_lanes_kernel(const uint32_t* __restrict__ words, int lane_blocks, int pitch,
                        int n_words, int k, const int* __restrict__ e_bound,
                        const int* __restrict__ g_rank, const int* __restrict__ syms, int s,
                        uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t l1[];  // kCopies copies, then the second level
  uint16_t* l2 = reinterpret_cast<uint16_t*>(l1 + kL1Words);
  __shared__ int gr[kL + 1];
  __shared__ uint8_t sy[256];
  __shared__ int bound[16];
  const int b = blockIdx.x / lane_blocks;
  const int t = threadIdx.x, nt = blockDim.x;
  const int* eb_row = e_bound + static_cast<size_t>(b) * (kL + 2);
  // The lane's first words, loaded before the tables are built so that
  // their latency passes under the build, and the rows after them asked
  // into L2.  A thread past the block's lanes builds tables and stops.
  const int lane = (blockIdx.x - b * lane_blocks) * nt + t;
  const bool decodes = lane < k;
  Lane ln;
  const uint32_t* src = words + static_cast<size_t>(b) * pitch * k + min(lane, k - 1);
  ln.hi = decodes && n_words > 0 ? __ldg(src) : 0u;
  ln.lo = decodes && n_words > 1 ? __ldg(src + k) : 0u;
  ln.nx = decodes && n_words > 2 ? __ldg(src + 2 * static_cast<size_t>(k)) : 0u;
  ln.src = src + 3 * static_cast<size_t>(k);
  if (decodes) {
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int row = 3 + i;
      if (row < n_words)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(src + static_cast<size_t>(row) * k));
    }
  }
  for (int i = t; i < 256; i += nt)
    sy[i] = static_cast<uint8_t>(syms[static_cast<size_t>(b) * 256 + i]);
  if (t < kL + 1) gr[t] = g_rank[static_cast<size_t>(b) * (kL + 1) + t];
  if (t < 16) bound[t] = t < kL - 1 ? eb_row[t + 1] : 0x7FFFFFFF;
  // The first window whose code is longer than kLut bits, and the
  // second-level entries from it.
  const int ek = min(max(__ldg(eb_row + kLut), 0), 1 << kL);
  const int n2 = min((1 << kL) - ek, kL2);
  __syncthreads();
  for (int i = t; i < (1 << kLut); i += nt) {
    const int lo = i << (kL - kLut);
    const uint32_t e =
        lo + (1 << (kL - kLut)) <= ek ? canonical(lo, bound, gr, sy) : kEsc | kLut << 8;
    if constexpr (kCopies % 4 == 0) {
      const uint4 v = make_uint4(e, e, e, e);
#pragma unroll
      for (int c = 0; c < kCopies; c += 4) *reinterpret_cast<uint4*>(l1 + i * kCopies + c) = v;
    } else {
#pragma unroll
      for (int c = 0; c < kCopies; ++c) l1[i * kCopies + c] = e;
    }
  }
  for (int j = t; j < n2; j += nt) l2[j] = static_cast<uint16_t>(canonical(ek + j, bound, gr, sy));
  __syncthreads();

  if (!decodes) return;
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(l1)) + (t & (kCopies - 1)) * 4;
  // 1 and the entry stride, in registers the compiler cannot fold.
  const int one = (n_words >> 31) + 1;
  const uint32_t stride = static_cast<uint32_t>(one) << kEntryShift;
  ln.dst = out + static_cast<size_t>(b) * s * k + lane;
  ln.pos = 0;
  ln.next = 32;

  // A refill from next = last on reads no more words: its row, next / 32
  // + 2, is n_words or past it.
  const int last = (n_words - 2) * 32;
  // The next two symbols of the lane, its bits advanced and refilled.
  auto pair = [&]() {
    const uint32_t w = __funnelshift_l(ln.lo, ln.hi, ln.pos);
    uint32_t e1 = first_level(base, stride, w);
    uint32_t e2 = first_level(base, stride, w << ((e1 >> 8) & 31));
    if (__builtin_expect(static_cast<int>(e1 | e2) < 0, 0)) {
      const uint2 e = long_pair(w, base, stride, e1, ek, n2, l2, bound, gr, sy);
      e1 = e.x;
      e2 = e.y;
    }
    ln.pos += static_cast<int>((e1 >> 8) + (e2 >> 8));
    refill(ln, last, 4 * k, one);
    return make_uint2(e1, e2);
  };
  int r = 0;
  for (; r + 2 * kUnroll <= s; r += 2 * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint2 e = pair();
      store_pair(ln, e.x, e.y, k, one);
    }
  }
  for (; r + 1 < s; r += 2) {
    const uint2 e = pair();
    store_pair(ln, e.x, e.y, k, one);
  }
  if (s & 1) {
    const uint32_t w = __funnelshift_l(ln.lo, ln.hi, ln.pos);
    uint32_t e = first_level(base, stride, w);
    if (e & kEsc) e = second_level(w, ek, n2, l2, bound, gr, sy);
    *ln.dst = static_cast<uint8_t>(e);
  }
}

// The kernel's shared memory is over 48 KB, so a device launches it only
// after its attribute is set there.  The launcher sets it on the first
// device it runs on, and on any other the first time a launch there is
// refused, so that a launch asks nothing more of the runtime.
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(decode_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

// The threads a block for B blocks of k lanes: of kMaxThreads, half and a
// quarter, the one whose busiest SM decodes the fewest lanes, a table
// build counted as kBuildLanes (the larger on a tie); 0 where none fits.
// The SM count and the occupancies are read once, on the first device the
// launcher runs on: the cards of a host are alike, and the choice moves
// only the speed.
cudaError_t pick_threads(int B, int k, int* threads) {
  constexpr int kChoices = 3;
  static std::atomic<int> known{0};  // the SM count once read
  static int occupancy[kChoices];
  int sms = known.load(std::memory_order_acquire);
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = allow_smem();
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    for (int i = 0; i < kChoices && e == cudaSuccess; ++i)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[i], decode_lanes_kernel,
                                                        kMaxThreads >> i, kSmemBytes);
    if (e != cudaSuccess) return e;
    known.store(sms, std::memory_order_release);
  }
  long long best = 0;
  *threads = 0;
  for (int i = 0; i < kChoices; ++i) {
    const int nt = kMaxThreads >> i;
    if (occupancy[i] <= 0) continue;
    const long long grid = static_cast<long long>((k + nt - 1) / nt) * B;
    const long long cost = (grid + sms - 1) / sms * (nt + kBuildLanes);
    if (*threads == 0 || cost < best) {
      best = cost;
      *threads = nt;
    }
  }
  return cudaSuccess;
}

}  // namespace

// words: (B, pitch, k) u32, of which rows 0..n_words-1 of each block are
// read (n_words <= pitch); e_bound (B, 17), g_rank (B, 16), syms (B, 256)
// int32; out: (B, s, k) uint8.  B >= 1.  Returns the CUDA error code of
// the launch.
extern "C" int decode_lanes_launch(const void* words, int B, int pitch, int n_words,
                                   int k, const void* e_bound, const void* g_rank,
                                   const void* syms, int s, void* out, void* stream) {
  int threads = 0;
  const cudaError_t e = pick_threads(B, k, &threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (threads == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int lane_blocks = (k + threads - 1) / threads;
  const long long grid = static_cast<long long>(lane_blocks) * B;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto launch = [&]() {
    decode_lanes_kernel<<<static_cast<unsigned>(grid), threads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), lane_blocks, pitch, n_words, k,
        static_cast<const int*>(e_bound), static_cast<const int*>(g_rank),
        static_cast<const int*>(syms), s, static_cast<uint8_t*>(out));
    return cudaGetLastError();
  };
  cudaError_t rc = launch();
  // A device without the attribute refuses the launch: set it there, again.
  if (rc != cudaSuccess && allow_smem() == cudaSuccess) rc = launch();
  return static_cast<int>(rc);
}
