// table_build: histogram -> the whole canonical coding of the tpu profile.
//
// Replaces huffman_tpu/ops/table_build.py:_tree_kernel/_tree_body (entry
// _huffman_len_count_pallas) and _full_table_kernel (entry
// _build_tables_fused_pallas), together with the XLA steps around them in
// build_coding_device: the count clamp, the stable frequency sort, the
// Moffat-Katajainen tree, the MiniZ repair to 15 bits and the canonical
// derivation (enc_table, e_bound, g_rank, l_min).
//
// Bound on the H100: latency.  The work is a few thousand operations on
// 2 KiB, so what counts is the longest chain of dependent steps.  The
// Huffman merge is inherently serial: 2 (n - 1) picks, each decided by
// the one before it; every other step parallelises over the 256 symbols.
// On the 16 MiB block's table (n = 256) the merge is ~80 % of ~24k
// cycles, an iteration (two picks) a chain of compares and selects in
// registers of ~75 cycles; the rest, sort to enumeration, is ~5k
// (PERF.md, by tools/kernel_ab.py).
//
// Design: one block of 256 threads per table, one thread per symbol; a
// batch of B histograms (the vmapped build of _encode_batch in
// models/tpu_codec.py) is one launch of B blocks.
//   1. Total and clamp by warp reductions.
//   2. Rank by a bitonic sort of the 256 keys (count descending, symbol
//      ascending, absent symbols after the present ones by symbol), warp
//      shuffles for strides below 32 and shared memory above.
//   3. Merge on one thread, with both queues' heads in registers: the
//      next four leaves and the next three internal weights.  An
//      iteration decides both picks from three independent compares of
//      the first two of each, shifts the windows by selects, appends the
//      new weight in a register, and loads the slots that shift in a full
//      iteration before any pick reads them.  Ties take the leaf
//      (table_build.py:225).  It stores only each node's weight and how
//      many internal nodes were consumed by then, in one 8-byte store;
//      the parents follow in parallel.
//   4. Depths of the internal nodes by pointer jumping over their parent
//      indices (8 rounds for up to 255 nodes), counted per depth with
//      shared atomics.
//   5. len_count, the fold past 15 bits, the MiniZ repair, e_bound,
//      g_rank and l_min in one warp's registers (lane l holds length l).
//   6. Enumeration in closed form, one thread per rank: rank i of length
//      l gets code E[l-1] + ((i - C[l-1]) << (15 - l)), E and C the
//      running Kraft sum and count, written straight to enc[syms[i]].
// The tie rules are those of the JAX table build, so the tables and the
// blobs are byte-identical.
//
// Output: one int32 buffer of B*563 entries, field-major: field f of
// table b at kOff_f*B + b*size_f (kOff* below), so each of the seven keys
// is one contiguous (B, size) block that the encode and decode kernels
// read without a copy.  For B = 1 this is one table's kOff* layout.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL = 15;       // TPU_MAX_CODE_LEN
constexpr int kN = 256;      // alphabet
constexpr int kDepth = 64;   // unlimited depth buckets
constexpr int kBig = 1 << 30;
constexpr int kPad = 8;      // slack past the queues for the look-ahead loads
constexpr unsigned kAll = 0xFFFFFFFFu;

constexpr int kOffEnc = 0;             // enc_table[256]: code<<4 | len
constexpr int kOffLc = 256;            // len_count[16]
constexpr int kOffSyms = 272;          // sorted_syms[256]
constexpr int kOffNumSyms = 528;       // num_syms
constexpr int kOffEBound = 529;        // e_bound[17]
constexpr int kOffGRank = 546;         // g_rank[16]
constexpr int kOffLMin = 562;          // l_min

// One compare-exchange of the bitonic network: keep the smaller key when
// this thread's slot and the direction agree.
__device__ __forceinline__ unsigned long long keep(unsigned long long mine,
                                                   unsigned long long other, bool take_min) {
  return take_min == (other < mine) ? other : mine;
}

__global__ void __launch_bounds__(kN) table_build_kernel(const int* __restrict__ hists,
                                                         int* __restrict__ outs) {
  const size_t b = blockIdx.x, nb = gridDim.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ unsigned long long keys[kN];
  __shared__ int leaves[kN + kPad];    // leaf weights ascending, kBig past n
  __shared__ int2 nodes[kN + kPad];    // node i: (weight, nodes consumed by then)
  __shared__ int parent[kN];           // internal node i's parent
  __shared__ int depth[kN], up[kN];    // pointer-jumping state
  __shared__ int inodes[kDepth];       // internal nodes per depth
  __shared__ int e_run[kL + 1], c_run[kL + 1];
  __shared__ int part[kN / 32];

  // 1. Total, clamp and the number of present symbols.
  const int h = hists[b * kN + t];
  const int hw = __reduce_add_sync(kAll, h);
  if (lane == 0) part[warp] = hw;
  if (t < kDepth) inodes[t] = 0;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kN / 32; ++w) total += part[w];
  const int floor_count = max(total >> kL, 1);
  const int c = h > 0 ? max(h, floor_count) : 0;
  const int n = __syncthreads_count(c > 0);

  // 2. Rank: ascending keys; an absent symbol's count 0 sorts after every
  // present one, by symbol.  Counts are below 2^31, so the key is exact.
  unsigned long long key = (static_cast<unsigned long long>(0x7FFFFFFF - c) << 8) | t;
#pragma unroll
  for (int size = 2; size <= kN; size <<= 1) {
    const bool up_dir = (t & size) == 0;
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool take_min = up_dir == ((t & stride) == 0);
      unsigned long long other;
      if (stride >= 32) {
        keys[t] = key;
        __syncthreads();
        other = keys[t ^ stride];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(kAll, key, stride);
      }
      key = keep(key, other, take_min);
    }
  }
  // Thread t now holds rank t.
  const int sym = static_cast<int>(key & 0xFF);
  const int cd = 0x7FFFFFFF - static_cast<int>(key >> 8);
  if (t < n) leaves[n - 1 - t] = cd;
  if (t >= n) leaves[t] = kBig;
  if (t < kPad) leaves[kN + t] = kBig;
  __syncthreads();

  // 3. The merge.  lw0..lw3 = leaves[leaf..leaf+3]; iw0..iw2 = the first
  // min(q, 3) weights of the internal queue nodes[root..i-1].x (q = i -
  // root); slots at or past q hold stale values that no pick reads.  Only
  // lw0, lw1, iw0 and iw1 decide a pick; the loads refill slots that no
  // pick reads before the next iteration.
  const int n_int = max(n - 1, 0);
  if (t == 0) {
    int lw0 = leaves[0], lw1 = leaves[1], lw2 = leaves[2], lw3 = leaves[3];
    int iw0 = 0, iw1 = 0, iw2 = 0;
    int leaf = 0, root = 0, q = 0;
    for (int i = 0; i < n_int; ++i) {
      const int x4 = leaves[leaf + 4], x5 = leaves[leaf + 5];
      const int y3 = nodes[root + 3].x, y4 = nodes[root + 4].x;
      // Two picks; ties take the leaf (table_build.py:225).
      const bool t1 = q > 0 && iw0 < lw0;
      const bool t2 = t1 ? q > 1 && iw1 < lw0 : q > 0 && iw0 < lw1;
      const int ki = t1 + t2;  // internal nodes taken; 2 - ki leaves
      const bool k0 = ki == 0, k2 = ki == 2;
      const int w = k0 ? lw0 + lw1 : k2 ? iw0 + iw1 : lw0 + iw0;
      const int l0 = k2 ? lw0 : k0 ? lw2 : lw1, l1 = k2 ? lw1 : k0 ? lw3 : lw2;
      const int l2 = k2 ? lw2 : k0 ? x4 : lw3, l3 = k2 ? lw3 : k0 ? x5 : x4;
      const int j0 = k0 ? iw0 : k2 ? iw2 : iw1, j1 = k0 ? iw1 : k2 ? y3 : iw2;
      const int j2 = k0 ? iw2 : k2 ? y4 : y3;
      // Node i joins the queue at q - ki.
      const int q2 = q - ki;
      iw0 = q2 == 0 ? w : j0;
      iw1 = q2 == 1 ? w : j1;
      iw2 = q2 == 2 ? w : j2;
      lw0 = l0;
      lw1 = l1;
      lw2 = l2;
      lw3 = l3;
      root += ki;
      leaf += 2 - ki;
      q = q2 + 1;
      nodes[i] = make_int2(w, root);
    }
  }
  __syncthreads();
  // Node i consumed the internal nodes nodes[i-1].y .. nodes[i].y - 1.
  if (t < n_int) {
    for (int j = t > 0 ? nodes[t - 1].y : 0; j < nodes[t].y; ++j) parent[j] = t;
  }
  __syncthreads();

  // 4. Depths: the root (node n_int - 1) at 0, every other internal node
  // one below its parent.
  const int root_node = n_int - 1;
  if (t < n_int) {
    depth[t] = t == root_node ? 0 : 1;
    up[t] = t == root_node ? t : parent[t];
  }
  __syncthreads();
#pragma unroll 1
  for (int round = 0; round < 8; ++round) {
    int d = 0, u = 0;
    if (t < n_int) {
      const int a = up[t];
      d = depth[t] + depth[a];
      u = up[a];
    }
    __syncthreads();
    if (t < n_int) {
      depth[t] = d;
      up[t] = u;
    }
    __syncthreads();
  }
  if (t < n_int) atomicAdd(&inodes[min(depth[t], kDepth - 1)], 1);
  __syncthreads();

  // 5. In warp 0, lane l holds len_count[l] for l <= 15:
  // len_count[d] = 2 I[d-1] - I[d] (I = internal nodes at depth d), the
  // lengths past 15 folded into 15, then demoted until the Kraft sum is
  // exact, always splitting the longest shorter code.
  if (warp == 0) {
    int lca, lcb;
    if (n == 1) {
      lca = lane == 0;
      lcb = 0;
    } else {
      lca = lane == 0 ? 0 : max(2 * inodes[lane - 1] - inodes[lane], 0);
      lcb = max(2 * inodes[lane + 31] - inodes[lane + 32], 0);
    }
    const int over = __reduce_add_sync(kAll, (lane > kL ? lca : 0) + lcb);
    int v = lane < kL ? lca : lane == kL ? lca + over : 0;
    int kraft = __reduce_add_sync(kAll, lane <= kL ? v * (1 << (kL - lane)) : 0);
    while (kraft > (1 << kL)) {
      if (lane == kL) --v;
      const unsigned shorter = __ballot_sync(kAll, lane < kL && v > 0);
      const int j = shorter ? 31 - __clz(shorter) : 0;
      if (lane == j) --v;
      if (lane == j + 1) v += 2;
      --kraft;
    }
    // E[l] = sum_{j<=l} lc[j] << (15-j) and C[l] = sum_{j<=l} lc[j];
    // g_rank[l] = C[l-1] - (E[l-1] >> (15-l)).
    int e = lane <= kL ? v * (1 << (kL - lane)) : 0, cnt = v;
#pragma unroll
    for (int s = 1; s < 16; s <<= 1) {
      const int e_s = __shfl_up_sync(kAll, e, s), c_s = __shfl_up_sync(kAll, cnt, s);
      if (lane >= s) {
        e += e_s;
        cnt += c_s;
      }
    }
    const int e_prev = __shfl_up_sync(kAll, e, 1), c_prev = __shfl_up_sync(kAll, cnt, 1);
    const unsigned present = __ballot_sync(kAll, lane >= 1 && lane <= kL && v > 0);
    if (lane <= kL) {
      e_run[lane] = e;
      c_run[lane] = cnt;
      outs[kOffLc * nb + b * (kL + 1) + lane] = v;
      outs[kOffEBound * nb + b * (kL + 2) + lane] = e;
      outs[kOffGRank * nb + b * (kL + 1) + lane] =
          lane == 0 ? 0 : c_prev - (e_prev >> (kL - lane));
    }
    if (lane == kL) outs[kOffEBound * nb + b * (kL + 2) + kL + 1] = e;
    if (lane == 0) {
      outs[kOffLMin * nb + b] = present ? __ffs(present) - 1 : 1;
      outs[kOffNumSyms * nb + b] = n;
    }
  }
  __syncthreads();

  // 6. Canonical enumeration; absent symbols keep entry 0.
  int code_len = 0;
  if (t < n) {
    int l = 0;
#pragma unroll
    for (int j = 0; j <= kL; ++j) l += c_run[j] <= t;
    l = min(l, kL);
    const int e_below = l > 0 ? e_run[l - 1] : 0, c_below = l > 0 ? c_run[l - 1] : 0;
    code_len = (((t - c_below) << (kL - l)) + e_below) << 4 | l;
  }
  outs[kOffEnc * nb + b * kN + sym] = code_len;
  outs[kOffSyms * nb + b * kN + t] = sym;
}

}  // namespace

// hist: (B, 256) int32 counts, each row's total < 2^30.  out: B*563
// int32, field-major as above.  B >= 1.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int table_build_launch(const void* hist, int B, void* out, void* stream) {
  table_build_kernel<<<B, kN, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
