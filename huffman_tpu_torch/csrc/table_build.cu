// table_build: histogram -> the whole canonical coding of the tpu profile.
//
// Replaces huffman_tpu/ops/table_build.py:_tree_kernel/_tree_body (entry
// _huffman_len_count_pallas) and _full_table_kernel (entry
// _build_tables_fused_pallas), together with the XLA steps around them in
// build_coding_device: the count clamp, the stable frequency sort, the
// Moffat-Katajainen tree, the MiniZ repair to 15 bits and the canonical
// derivation (enc_table, e_bound, g_rank, l_min).
//
// Bound on the H100: latency.  The tree and the repair are a chain of a
// few thousand dependent shared-memory operations on one thread (some
// tens of microseconds); nothing here touches more than 2 KiB.
//
// Design: one block of 256 threads, one per symbol.  The clamp, the
// total and the sort are parallel (each thread finds its own rank by
// counting the symbols that sort before it), which leaves only the
// inherently serial tree, repair and code enumeration to thread 0.  The
// tie rules are those of the JAX table build, so the tables and the blobs
// are byte-identical.
//
// Output: one int32 buffer of kOutLen entries, laid out as kOff* below.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL = 15;       // TPU_MAX_CODE_LEN
constexpr int kN = 256;      // alphabet
constexpr int kDepth = 64;   // unlimited depth buckets
constexpr int kBig = 1 << 30;

constexpr int kOffEnc = 0;             // enc_table[256]: code<<4 | len
constexpr int kOffLc = 256;            // len_count[16]
constexpr int kOffSyms = 272;          // sorted_syms[256]
constexpr int kOffNumSyms = 528;       // num_syms
constexpr int kOffEBound = 529;        // e_bound[17]
constexpr int kOffGRank = 546;         // g_rank[16]
constexpr int kOffLMin = 562;          // l_min
constexpr int kOutLen = 563;

__global__ void table_build_kernel(const int* __restrict__ hist,
                                   int* __restrict__ out) {
  __shared__ int cnt[kN];    // clamped counts by symbol
  __shared__ int cd[kN];     // clamped counts by rank (descending)
  __shared__ int syms[kN];   // symbol by rank
  __shared__ int a[kN];      // Moffat's in-place array
  __shared__ int lens[kN];   // code length by rank
  __shared__ int enc[kN];    // enc_table by symbol
  __shared__ int inodes[kDepth];
  __shared__ int lc[kDepth];
  __shared__ int total;
  const int t = threadIdx.x;

  const int h = hist[t];
  if (t == 0) total = 0;
  __syncthreads();
  atomicAdd(&total, h);
  __syncthreads();
  // Clamp: present counts rise to max(total >> 15, 1).
  const int floor_count = max(total >> kL, 1);
  const int c = h > 0 ? max(h, floor_count) : 0;
  cnt[t] = c;
  enc[t] = 0;
  const int n = __syncthreads_count(c > 0);

  // Rank: frequency descending, symbol ascending; absent symbols after
  // the present ones, by symbol.
  int rank = 0;
  if (c > 0) {
    for (int u = 0; u < kN; ++u) {
      const int cu = cnt[u];
      rank += (cu > c) || (cu == c && u < t);
    }
  } else {
    rank = n;
    for (int u = 0; u < t; ++u) rank += cnt[u] == 0;
  }
  syms[rank] = t;
  cd[rank] = c;
  __syncthreads();

  if (t == 0) {
    // Phase 1: a[0:n] = weights ascending; internal node i goes to a[i],
    // consumed internal nodes are overwritten by their parent's index.
    const int n_int = max(n - 1, 0);
    for (int i = 0; i < kN; ++i) a[i] = i < n ? cd[max(n - 1 - i, 0)] : kBig;
    for (int d = 0; d < kDepth; ++d) inodes[d] = 0;
    int leaf = 0, root = 0;
    for (int i = 0; i < n_int; ++i) {
      int w = 0;
      for (int p = 0; p < 2; ++p) {
        const int leaf_w = leaf < n ? a[min(leaf, kN - 1)] : kBig;
        const int root_w = a[min(root, kN - 1)];
        // Ties take the leaf (table_build.py:225).
        if (root < i && root_w < leaf_w) {
          w += root_w;
          a[root] = i;
          ++root;
        } else {
          w += leaf_w;
          ++leaf;
        }
      }
      a[i] = w;
    }
    // Phase 2: depths in place, root (slot n_int-1) at depth 0.
    if (n_int >= 1) a[n_int - 1] = 0;
    for (int nxt = n_int - 2; nxt >= 0; --nxt) a[nxt] = a[min(a[nxt], kN - 1)] + 1;
    // len_count[d] = 2*I[d-1] - I[d], I[d] = internal nodes at depth d.
    for (int i = 0; i < n_int; ++i) ++inodes[min(max(a[i], 0), kDepth - 1)];
    for (int d = 0; d < kDepth; ++d) {
      const int v = d >= 1 ? 2 * inodes[d - 1] - inodes[d] : 0;
      lc[d] = max(n == 1 ? (d == 0 ? 1 : 0) : v, 0);
    }
    // MiniZ repair: fold lengths past 15 into 15, then demote until the
    // Kraft sum is exact, always splitting the longest shorter code.
    int over = 0;
    for (int d = kL + 1; d < kDepth; ++d) {
      over += lc[d];
      lc[d] = 0;
    }
    lc[kL] += over;
    int kraft = 0;
    for (int d = 0; d <= kL; ++d) kraft += lc[d] << (kL - d);
    while (kraft > (1 << kL)) {
      --lc[kL];
      int j = 0;
      for (int d = 0; d < kL; ++d)
        if (lc[d] > 0) j = d;
      --lc[j];
      lc[j + 1] += 2;
      --kraft;
    }

    // Decode constants: E[l] = sum_{j<=l} lc[j] << (15-j);
    // g_rank[l] = (#codes shorter than l) - (E[l-1] >> (15-l)).
    int acc = 0, nshort = 0;
    out[kOffGRank] = 0;
    for (int l = 0; l <= kL; ++l) {
      if (l >= 1) out[kOffGRank + l] = nshort - (acc >> (kL - l));
      acc += lc[l] << (kL - l);
      out[kOffEBound + l] = acc;
      nshort += lc[l];
    }
    out[kOffEBound + kL + 1] = acc;
    int l_min = 1;
    for (int l = kL; l >= 1; --l)
      if (lc[l] > 0) l_min = l;
    out[kOffLMin] = l_min;
    out[kOffNumSyms] = n;

    // Canonical enumeration in rank order; absent symbols keep entry 0.
    int cur = 0;
    for (int l = 0; l <= kL; ++l)
      for (int j = 0; j < lc[l] && cur < kN; ++j) lens[cur++] = l;
    int code = 0;
    for (int i = 0; i < n; ++i) {
      const int l = lens[i];
      enc[syms[i]] = (code << 4) | l;
      code += 1 << (kL - l);
    }
  }
  __syncthreads();
  out[kOffEnc + t] = enc[t];
  out[kOffSyms + t] = syms[t];
  if (t <= kL) out[kOffLc + t] = lc[t];
}

}  // namespace

// hist: (256,) int32 counts, total < 2^30.  out: (563,) int32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int table_build_launch(const void* hist, void* out, void* stream) {
  table_build_kernel<<<1, kN, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
