// encode_chain: the three kernels of a compress request, queued by one call.
//
// Replaces no TPU kernel: the JAX package's compress is one XLA program,
// so its host pays one dispatch a request.  The port's compress is three
// hand-written kernels (hist256 or hist256_batch, table_build,
// encode_lanes), and a request through their wrappers crossed from
// Python to C three times, with the wrappers' checks, allocations and
// stream lookups between the crossings.  On an H100 that host time was
// about three times the kernels' device time (PERF.md), so the card sat
// idle most of each request.
//
// Design: no kernel of its own.  Each entry queues on the given stream
// exactly what the three wrappers queue, in the same order with the same
// grids and arguments, by calling their C entries as they are; the
// library is linked from this file and the sources of those entries.
// The caller allocates one buffer for every output and the histogram
// between them, and passes a pointer into it for each.  The table
// buffer's first field is the (B, 256) encode table (table_build.cu,
// kOffEnc = 0), so encode_lanes reads it where table_build wrote it.
#include <cuda_runtime.h>

extern "C" int hist256_launch(const void* data, long long rows, int row_len, long long pitch,
                              int last_len, int bias, void* out, void* stream);
extern "C" int hist256_batch_launch(const void* data, int B, long long n, void* out,
                                    void* stream);
extern "C" int table_build_launch(const void* hist, int B, void* out, void* stream);
extern "C" int encode_lanes_launch(const void* padded, const void* enc_table, int B, int s,
                                   int k, int w32, void* words, void* bit_counts,
                                   void* stream);

// One block of s*k bytes: hist256 over the rows (rows, row_len, pitch,
// last_len, bias) describe, its table, its encode.  hist: 256 int32;
// table: 563 int32; words: (w32, k) u32; bit_counts: (k,) int32.  Returns
// the first nonzero CUDA error code of the three launches, which then
// stop, or 0.
extern "C" int encode_chain_launch(const void* padded, long long rows, int row_len,
                                   long long pitch, int last_len, int bias, int s, int k,
                                   int w32, void* hist, void* table, void* words,
                                   void* bit_counts, void* stream) {
  int e = hist256_launch(padded, rows, row_len, pitch, last_len, bias, hist, stream);
  if (e == 0) e = table_build_launch(hist, 1, table, stream);
  if (e == 0) e = encode_lanes_launch(padded, table, 1, s, k, w32, words, bit_counts, stream);
  return e;
}

// B blocks of s*k bytes, (B, s*k) row-major: hist256_batch of every
// byte, a table each, one encode.  hist: (B, 256) int32; table: B*563
// int32, field-major; words: (B, w32, k) u32; bit_counts: (B, k) int32.
// Returns as encode_chain_launch.
extern "C" int encode_chain_batch_launch(const void* blocks, int B, int s, int k, int w32,
                                         void* hist, void* table, void* words,
                                         void* bit_counts, void* stream) {
  int e = hist256_batch_launch(blocks, B, static_cast<long long>(s) * k, hist, stream);
  if (e == 0) e = table_build_launch(hist, B, table, stream);
  if (e == 0) e = encode_lanes_launch(blocks, table, B, s, k, w32, words, bit_counts, stream);
  return e;
}
