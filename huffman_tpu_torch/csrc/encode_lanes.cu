// encode_lanes: B blocks of K lanes of S bytes -> (B, w32, K) u32 lane
// words + (B, K) bit counts.
//
// Replaces huffman_tpu/ops/encode_pallas.py:_make_encode_kernel (entry
// encode_lanes_pallas), with the u16 -> u32 word pairing of
// huffman_tpu/ops/decode_words.py:pack_u16_words_to_u32 and the pad/trim
// to w32 rows of _encode_with_tables_body (models/tpu_codec.py) fused in.
// The TPU kernel places bits with a prefix sum and log-round shift+OR
// passes because it cannot gather or scatter per lane; a GPU thread can
// simply own a lane and append its codes to a bit accumulator.  Like the
// TPU kernel, which encodes a whole (S, blk, 128) tile in VMEM and writes
// its word tile in one piece, this one works on tiles of lanes.
//
// Bound on the H100: device memory.  A 16 MiB block reads 16 MiB of bytes
// and writes w32*K*4 bytes of words (32 MiB at S=128, K=131072), of which
// about three quarters are the zeros past the lanes' ends.  A kernel with
// one thread a lane that stores each word as its lane fills it spends
// most of its time on those stores: the lanes of a warp reach a word row
// at different bytes, so each store instruction lands on several rows.
//
// Design: a thread block owns a tile of kTileLanes lanes of block b (a
// batch of B blocks, the vmapped encode of _encode_batch in
// models/tpu_codec.py, is one flat grid of B * tiles thread blocks; a
// single block is B = 1), one thread a lane.
//  - Input: the tile's byte rows come into shared memory in stages of
//    kStageRows rows, double-buffered, by 16-byte cp.async copies while
//    the threads encode the stage before; each thread then reads its
//    lane's column, 32 neighbouring bytes a warp.  The copies are of the
//    16-byte-aligned chunks that hold a byte of the row, so a base or K
//    that is not a multiple of 16 (an offset view of a tensor) takes the
//    same path: a row lands in shared memory at its own misalignment, and
//    a row pitch equal to K modulo 16 keeps the column's bytes one pitch
//    apart.  A chunk that holds a byte of the row never crosses a page,
//    so its bytes outside the row are read safely and never used.
//  - Encode: kGroupRows bytes and then their table entries (codes
//    right-aligned, in shared memory) are loaded at once; the codes of
//    two rows are joined (at most 30 bits) and appended MSB-first to a
//    64-bit accumulator, so a step takes one append and one check; every
//    full u32 goes to the lane's column of a word tile in shared memory
//    (w32 rows of the tile's lanes: no bank conflicts).
//  - Output: the tile is written out as whole rows, 16 bytes a thread,
//    words past a lane's end written as zero, so no lane stores on its
//    own schedule and the output needs no memset (4-byte stores where K
//    is not a multiple of 4).
// A word tile holds w32 <= 128 rows in kTileBytes of shared memory
// (S <= 271, every S the codec's default lane count makes up to 34 MiB);
// longer lanes take encode_lanes_direct_kernel, which stores each lane's
// words straight to device memory, so there is no limit on S.  Offsets
// are size_t: a batch passes 2^31 bytes.
//
// Row counts (the ref profile, huffman_tpu/models/jax_codec.py, whose
// XLA encode appends nothing for rows where its valid mask is false):
// with lane_rows, lane t takes only its first min(lane_rows[t], S) rows,
// the same counts for every block of a batch.  A thread just ends its
// loop over a stage's rows earlier, so its bit count, words and zero
// tail come out as if the rows were absent; the rows are staged all the
// same.  The tiled kernel without row counts (encode_lanes_kernel) is
// its own instance of the tile code (encode_tile<false>), so the tpu
// profile's encode compiles as it did.
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL = 15;
constexpr int kTileLanes = 128;
constexpr int kStageRows = 32;
constexpr int kGroupRows = 16;  // rows whose loads are in flight at once
constexpr int kTileBytes = 64 << 10;  // most shared bytes a word tile takes
constexpr int kDirectThreads = 256;
constexpr int kMaxDevices = 64;
// Keeps the second stage buffer, kStageRows * pitch bytes in, on 16 bytes.
static_assert(kStageRows % 16 == 0, "kStageRows must be a multiple of 16");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes between two staged rows of a tile of tl lanes: a row of chunks
// starts up to 15 bytes before its first byte and ends up to 15 after
// its last, and a pitch equal to K modulo 16 puts every row's chunks on
// 16 bytes.
__host__ __device__ constexpr int stage_pitch(int tl, int k) { return tl + 32 + (k & 15); }

// Shared memory of a tile of tl lanes: the table, each lane's word count,
// the word tile and the two stage buffers.
constexpr size_t tile_smem(int tl, int w32, int k) {
  return 256 * 4 + static_cast<size_t>(tl) * 4 + static_cast<size_t>(w32) * tl * 4 +
         2 * static_cast<size_t>(kStageRows) * stage_pitch(tl, k);
}

// One thread block a tile of blockDim.x lanes (a multiple of 32); vec_out:
// every row of the tile's words starts on 16 bytes; kRows: lane_rows holds
// each lane's row count.
template <bool kRows>
__device__ __forceinline__ void encode_tile(const uint8_t* __restrict__ padded,
                                            const int* __restrict__ enc_table,
                                            const int* __restrict__ lane_rows, int tiles, int s,
                                            int k, int w32, bool vec_out,
                                            uint32_t* __restrict__ words,
                                            int* __restrict__ bit_counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tl = blockDim.x;
  const int pitch = stage_pitch(tl, k);
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  int* nw = reinterpret_cast<int*>(tab + 256);
  uint32_t* tile = reinterpret_cast<uint32_t*>(nw + tl);
  uint8_t* stage = reinterpret_cast<uint8_t*>(tile + w32 * tl);
  // Move the parameters to block b and the tile's first lane.
  const int b = blockIdx.x / tiles;
  const int lane0 = (blockIdx.x - b * tiles) * tl;
  padded += static_cast<size_t>(b) * s * k + lane0;
  enc_table += static_cast<size_t>(b) * 256;
  words += static_cast<size_t>(b) * w32 * k + lane0;
  bit_counts += static_cast<size_t>(b) * k + lane0;
  const int t = threadIdx.x;
  const int width = min(tl, k - lane0);  // lanes of this tile
  const int my_rows = kRows && t < width ? min(lane_rows[lane0 + t], s) : s;
  // The table as (code, right-aligned) << 4 | len.
  for (int i = t; i < 256; i += tl) {
    const uint32_t e = static_cast<uint32_t>(enc_table[i]), len = e & 15;
    tab[i] = ((e >> 4) >> (kL - len)) << 4 | len;
  }

  // Misalignment of row r's first byte.
  auto mis = [&](int r) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(padded) + static_cast<size_t>(r) * k) & 15);
  };
  // Rows [r0, r0 + kStageRows) of the tile into stage buffer buf: row r's
  // first byte at mis(r0) + r * pitch, by the aligned chunks that hold a
  // byte of it.
  const int cpr = (width + 30) >> 4;  // most chunks a row
  auto load = [&](int r0, int buf) {
    uint8_t* dst = stage + buf * kStageRows * pitch + mis(r0);
    const int rows = min(kStageRows, s - r0);
    for (int i = t; i < rows * cpr; i += tl) {
      const int r = i / cpr, c = (i - r * cpr) << 4, m = mis(r0 + r);
      const uint8_t* row = padded + static_cast<size_t>(r0 + r) * k;
      if (c < m + width) cp_async16(dst + r * pitch - m + c, row - m + c);
    }
    cp_async_commit();
  };

  uint64_t acc = 0;
  int nbits = 0;  // bits in acc not yet written, < 32 between steps
  int next = t;   // the lane's next word in the tile
  // Two rows' table entries: their codes joined into at most 30 bits, so
  // one append and one check a step, and at most one full word.
  auto append = [&](uint32_t e0, uint32_t e1) {
    const int len = (e0 & 15) + (e1 & 15);
    acc = (acc << len) | ((e0 >> 4) << (e1 & 15) | (e1 >> 4));
    nbits += len;
    if (nbits >= 32) {
      nbits -= 32;
      tile[next] = static_cast<uint32_t>(acc >> nbits);
      next += tl;
    }
  };
  const int stages = (s + kStageRows - 1) / kStageRows;
  if (stages > 0) load(0, 0);
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      load((st + 1) * kStageRows, (st + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t < width) {
      const uint8_t* col = stage + (st & 1) * kStageRows * pitch + mis(st * kStageRows) + t;
      const int rows = min(kStageRows, my_rows - st * kStageRows);  // < 1: none
      // kGroupRows rows at a time, every byte and table entry loaded
      // before the first append (whose word store the compiler may not
      // move the next loads above); then the rest in pairs, a last odd
      // row beside an empty entry.
      int r = 0;
      for (; r + kGroupRows <= rows; r += kGroupRows) {
        uint32_t e[kGroupRows];
#pragma unroll
        for (int j = 0; j < kGroupRows; ++j) e[j] = col[(r + j) * pitch];
#pragma unroll
        for (int j = 0; j < kGroupRows; ++j) e[j] = tab[e[j]];
#pragma unroll
        for (int j = 0; j < kGroupRows; j += 2) append(e[j], e[j + 1]);
      }
      for (; r < rows; r += 2)
        append(tab[col[r * pitch]], r + 1 < rows ? tab[col[(r + 1) * pitch]] : 0u);
    }
    __syncthreads();  // before the next load overwrites this buffer
  }
  int w = (next - t) / tl;  // full words
  if (t < width) {
    bit_counts[t] = 32 * w + nbits;
    if (nbits > 0) tile[w++ * tl + t] = static_cast<uint32_t>(acc << (32 - nbits));
  }
  nw[t] = w;  // 0 past the tile's lanes
  __syncthreads();

  // Write the tile out row by row; words past a lane's end are zero.
  if (vec_out) {
    const int cpr = tl >> 2;  // 16-byte chunks a tile row
    const int c = (t % cpr) << 2;
    if (c < width) {
      const int4 n = *reinterpret_cast<const int4*>(nw + c);
      for (int row = t / cpr; row < w32; row += 4) {
        uint4 v = *reinterpret_cast<const uint4*>(tile + row * tl + c);
        v.x = row < n.x ? v.x : 0u;
        v.y = row < n.y ? v.y : 0u;
        v.z = row < n.z ? v.z : 0u;
        v.w = row < n.w ? v.w : 0u;
        *reinterpret_cast<uint4*>(words + static_cast<size_t>(row) * k + c) = v;
      }
    }
  } else if (t < width) {
    for (int row = 0; row < w32; ++row)
      words[static_cast<size_t>(row) * k + t] = row < w ? tile[row * tl + t] : 0u;
  }
}

__global__ void encode_lanes_kernel(const uint8_t* __restrict__ padded,
                                    const int* __restrict__ enc_table, int tiles, int s, int k,
                                    int w32, bool vec_out, uint32_t* __restrict__ words,
                                    int* __restrict__ bit_counts) {
  encode_tile<false>(padded, enc_table, nullptr, tiles, s, k, w32, vec_out, words, bit_counts);
}

__global__ void encode_lanes_rows_kernel(const uint8_t* __restrict__ padded,
                                         const int* __restrict__ enc_table,
                                         const int* __restrict__ lane_rows, int tiles, int s,
                                         int k, int w32, bool vec_out,
                                         uint32_t* __restrict__ words,
                                         int* __restrict__ bit_counts) {
  encode_tile<true>(padded, enc_table, lane_rows, tiles, s, k, w32, vec_out, words, bit_counts);
}

// Lanes too long for a tile: one thread a lane stores every full
// u32 straight to words[b][w*K + k], then zeros to row w32; lane_rows
// (or nullptr: S each) as in the tiles.
__global__ void encode_lanes_direct_kernel(const uint8_t* __restrict__ padded,
                                           const int* __restrict__ enc_table,
                                           const int* __restrict__ lane_rows, int lane_blocks,
                                           int s, int k, int w32, uint32_t* __restrict__ words,
                                           int* __restrict__ bit_counts) {
  const int b = blockIdx.x / lane_blocks;
  padded += static_cast<size_t>(b) * s * k;
  enc_table += static_cast<size_t>(b) * 256;
  words += static_cast<size_t>(b) * w32 * k;
  bit_counts += static_cast<size_t>(b) * k;
  __shared__ uint32_t tab[256];
  for (int i = threadIdx.x; i < 256; i += kDirectThreads)
    tab[i] = static_cast<uint32_t>(enc_table[i]);
  __syncthreads();
  const int lane = (blockIdx.x - b * lane_blocks) * kDirectThreads + threadIdx.x;
  if (lane >= k) return;
  const int rows = lane_rows != nullptr ? min(lane_rows[lane], s) : s;
  uint64_t acc = 0;
  int nbits = 0;
  int total = 0;
  int w = 0;
  for (int r = 0; r < rows; ++r) {
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

// padded: (B, s*k) uint8; enc_table: (B, 256) int32; lane_rows: (k,)
// int32 row counts shared by the B blocks, or nullptr for s rows a lane;
// words: (B, w32, k) u32; bit_counts: (B, k) int32.  B >= 1.  w32 must
// exceed the longest lane's word count (w32 = (s*15+31)/32 + 1 always
// does).  Returns the CUDA error code of the launch.
extern "C" int encode_lanes_rows_launch(const void* padded, const void* enc_table, int B,
                                        int s, int k, int w32, const void* lane_rows,
                                        void* words, void* bit_counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(padded);
  const int* tab = static_cast<const int*>(enc_table);
  const int* rows = static_cast<const int*>(lane_rows);
  uint32_t* out = static_cast<uint32_t*>(words);
  int* bits = static_cast<int*>(bit_counts);
  if (static_cast<size_t>(w32) * kTileLanes * 4 > kTileBytes) {
    const int lane_blocks = (k + kDirectThreads - 1) / kDirectThreads;
    const long long grid = static_cast<long long>(lane_blocks) * B;
    if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
    encode_lanes_direct_kernel<<<static_cast<unsigned>(grid), kDirectThreads, 0, st>>>(
        in, tab, rows, lane_blocks, s, k, w32, out, bits);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = (k + kTileLanes - 1) / kTileLanes;
  const long long grid = static_cast<long long>(tiles) * B;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = tile_smem(kTileLanes, w32, k);
  // Above 48 KB a kernel needs the attribute, on each device: set once a
  // device for both tiled kernels, to the most any tile takes, before
  // their first launch there (and so before a graph capture).  Two
  // threads may both set it.
  static std::atomic<bool> big[kMaxDevices];
  if (smem > (48 << 10)) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!big[dev].load(std::memory_order_acquire)) {
      const int most = static_cast<int>(tile_smem(kTileLanes, kTileBytes / (kTileLanes * 4), 15));
      e = cudaFuncSetAttribute(encode_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(encode_lanes_rows_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e != cudaSuccess) return static_cast<int>(e);
      big[dev].store(true, std::memory_order_release);
    }
  }
  const bool vec_out = k % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (rows != nullptr)
    encode_lanes_rows_kernel<<<static_cast<unsigned>(grid), kTileLanes, smem, st>>>(
        in, tab, rows, tiles, s, k, w32, vec_out, out, bits);
  else
    encode_lanes_kernel<<<static_cast<unsigned>(grid), kTileLanes, smem, st>>>(
        in, tab, tiles, s, k, w32, vec_out, out, bits);
  return static_cast<int>(cudaGetLastError());
}

// encode_lanes_rows_launch with s rows a lane: the tpu profile's entry,
// whose argument list other versions of this file share.
extern "C" int encode_lanes_launch(const void* padded, const void* enc_table, int B,
                                   int s, int k, int w32, void* words,
                                   void* bit_counts, void* stream) {
  return encode_lanes_rows_launch(padded, enc_table, B, s, k, w32, nullptr, words, bit_counts,
                                  stream);
}
