// The device graph build's k-mer counting (ops/build_device.py).
//
// Replaces the XLA device code of corticall_tpu/ops/build_device.py:
//   ctk_count_windows  <- _extract_windows (line 73): every window of a 2-bit
//                         packed stream as its canonical k-mer and in/out edge
//                         masks, one thread a window;
//   ctk_segment_reduce <- _sort_reduce's segment sums and per-bit maxima
//                         (lines 149-163): over rows already sorted by key,
//                         each run of equal keys becomes one row with its
//                         coverage summed (uint32, wrapping) and its masks ORed.
// The sort between them stays torch.sort, as the JAX package left lax.sort
// to XLA.  Plain PyTorch twins: corticall_tpu_torch/ops/build_device.py.
//
// The stream holds base p at bits 30 - 2 (p % 16) of word p / 16; the two
// bitmaps (base valid, window owned) hold bit i at bit i % 32 of word i / 32.
// A window is valid when it is owned and its k bases are valid, which a
// thread tests on the bitmap directly (k <= 63 bits span at most 3 words;
// the JAX package derives it from a cumsum).  An invalid window is written
// as the all-ones key with zero masks: all-T never is a canonical k-mer
// (it canonicalizes to all-A), so the key marks the row.
//
// What bounds them on this card, and what the design does about it:
// - count_windows streams: it reads half a byte a window (stream and
//   bitmaps, shared by a warp's neighbouring windows through L1) and writes
//   4 W + 1 bytes, a warp's keys and masks contiguous.  It is bound by its
//   writes; nothing is staged.
// - segment_reduce reads each sorted row once or twice (a head walks its own
//   run; rows are mostly distinct, runs ~ coverage long) and writes the
//   unique rows, compacted in order by a three-kernel scan: heads a block,
//   one block's exclusive scan of those counts, then each head's run summed
//   and written at its block's offset plus its rank in the block.

#include "kmer.cuh"

namespace {

constexpr int kThreads = 256;       // a reduce block: 8 warps
constexpr int kScanThreads = 1024;  // the one block that scans the block counts

__device__ __forceinline__ bool bit_at(const uint32_t* __restrict__ words, long long i) {
  return (__ldg(words + (i >> 5)) >> (i & 31)) & 1u;
}

// bits [i, i + k) of a bitmap all set (the caller checks i + k <= n)
__device__ __forceinline__ bool all_set(const uint32_t* __restrict__ words, long long i, int k) {
  const long long last = i + k - 1;
  for (long long q = i >> 5; q <= last >> 5; ++q) {
    const int lo = q == (i >> 5) ? (int)(i & 31) : 0;
    const int hi = q == (last >> 5) ? (int)(last & 31) : 31;
    const uint32_t span = hi - lo == 31 ? 0xFFFFFFFFu : ((1u << (hi - lo + 1)) - 1u) << lo;
    if ((__ldg(words + q) & span) != span) return false;
  }
  return true;
}

// 32 stream bits from bit offset `off` (MSB first); off > -32, bits before
// the stream or past its last word read as zeros
__device__ __forceinline__ uint32_t bits32(const uint32_t* __restrict__ stream, long long nwords,
                                           long long off) {
  if (off < 0) return __ldg(stream) >> (-off);
  const long long q = off >> 5;
  const int r = (int)(off & 31);
  const uint32_t hi = q < nwords ? __ldg(stream + q) : 0u;
  if (r == 0) return hi;
  const uint32_t lo = q + 1 < nwords ? __ldg(stream + q + 1) : 0u;
  return (hi << r) | (lo >> (32 - r));
}

__device__ __forceinline__ uint32_t base_at(const uint32_t* __restrict__ stream, long long p) {
  return (__ldg(stream + (p >> 4)) >> (30 - 2 * (p & 15))) & 3u;
}

template <int W>
__global__ void __launch_bounds__(256)
count_windows_kernel(const uint32_t* __restrict__ stream, long long nwords,
                     const uint32_t* __restrict__ valid, const uint32_t* __restrict__ own,
                     long long n, int k, uint32_t* __restrict__ keys,
                     uint8_t* __restrict__ masks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t* key = keys + i * W;
  if (!(bit_at(own, i) && i + k <= n && all_set(valid, i, k))) {
#pragma unroll
    for (int j = 0; j < W; ++j) key[j] = 0xFFFFFFFFu;
    masks[i] = 0;
    return;
  }
  // word j of the right-aligned key: stream bits [2i - s + 32j, + 32)
  const int s = 32 * W - 2 * k;
  uint32_t v[W], canon[W];
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = bits32(stream, nwords, 2 * i - s + 32 * j);
  v[0] &= top_mask<W>(k);
  const bool flip = canonicalize<W>(v, canon, k);
  const bool has_prev = i > 0 && bit_at(valid, i - 1);
  const bool has_next = i + k < n && bit_at(valid, i + k);
  const uint32_t prev_b = has_prev ? base_at(stream, i - 1) : 0u;
  const uint32_t next_b = has_next ? base_at(stream, i + k) : 0u;
  uint32_t in_m = 0u, out_m = 0u;
  if (!flip) {
    if (has_prev) in_m = 1u << prev_b;
    if (has_next) out_m = 1u << next_b;
  } else {
    if (has_next) in_m = 1u << (3u - next_b);
    if (has_prev) out_m = 1u << (3u - prev_b);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) key[j] = canon[j];
  masks[i] = (uint8_t)((in_m << 4) | out_m);
}

template <int W>
__device__ __forceinline__ bool same_row(const uint32_t* __restrict__ keys, int a, int b) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < W; ++j)
    eq = eq && __ldg(keys + (size_t)a * W + j) == __ldg(keys + (size_t)b * W + j);
  return eq;
}

template <int W>
__device__ __forceinline__ bool is_head(const uint32_t* __restrict__ keys, int i, int m) {
  return i < m && (i == 0 || !same_row<W>(keys, i, i - 1));
}

// heads (first rows of their runs) a block
template <int W>
__global__ void __launch_bounds__(kThreads)
count_heads_kernel(const uint32_t* __restrict__ keys, int m, int* __restrict__ block_count) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int heads = __syncthreads_count(is_head<W>(keys, i, m));
  if (threadIdx.x == 0) block_count[blockIdx.x] = heads;
}

// one block: the block counts -> exclusive offsets, in place; their sum to *total
__global__ void __launch_bounds__(kScanThreads)
scan_counts_kernel(int* __restrict__ counts, int nblocks, int* __restrict__ total) {
  __shared__ int sums[kScanThreads];
  const int t = threadIdx.x;
  const int per = (nblocks + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, nblocks), hi = min(lo + per, nblocks);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += counts[i];
  sums[t] = own;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {  // inclusive Hillis-Steele scan
    const int add = t >= d ? sums[t - d] : 0;
    __syncthreads();
    sums[t] += add;
    __syncthreads();
  }
  int run = sums[t] - own;
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (t == kScanThreads - 1) *total = sums[t];
}

// each head sums its run and writes one row at its block's offset plus its
// rank among the block's heads
template <int W>
__global__ void __launch_bounds__(kThreads)
reduce_runs_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ cov,
                   const uint8_t* __restrict__ masks, int m,
                   const int* __restrict__ block_offset, uint32_t* __restrict__ out_keys,
                   uint32_t* __restrict__ out_cov, uint8_t* __restrict__ out_masks) {
  __shared__ int warp_heads[kThreads / 32];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool head = is_head<W>(keys, i, m);
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, head);
  if (lane == 0) warp_heads[warp] = __popc(ballot);
  __syncthreads();
  if (!head) return;
  int pos = block_offset[blockIdx.x] + __popc(ballot & ((1u << lane) - 1u));
  for (int x = 0; x < warp; ++x) pos += warp_heads[x];
  uint32_t c = 0u, mk = 0u;
  for (int j = i; j < m && (j == i || same_row<W>(keys, j, i)); ++j) {
    c += __ldg(cov + j);
    mk |= __ldg(masks + j);
  }
#pragma unroll
  for (int x = 0; x < W; ++x) out_keys[(size_t)pos * W + x] = __ldg(keys + (size_t)i * W + x);
  out_cov[pos] = c;
  out_masks[pos] = (uint8_t)mk;
}

template <int W>
void launch_reduce(const uint32_t* keys, const uint32_t* cov, const uint8_t* masks, int m,
                   uint32_t* out_keys, uint32_t* out_cov, uint8_t* out_masks, int* count,
                   int* scratch, cudaStream_t stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  count_heads_kernel<W><<<blocks, kThreads, 0, stream>>>(keys, m, scratch);
  scan_counts_kernel<<<1, kScanThreads, 0, stream>>>(scratch, blocks, count);
  reduce_runs_kernel<W><<<blocks, kThreads, 0, stream>>>(keys, cov, masks, m, scratch, out_keys,
                                                          out_cov, out_masks);
}

}  // namespace

// stream: nwords packed words; valid, own: bitmaps of n bits; keys: [n][w]
// words out; masks: n bytes out (in << 4 | out)
extern "C" int ctk_count_windows(const void* stream, long long nwords, const void* valid,
                                 const void* own, long long n, int w, int k, void* keys,
                                 void* masks, cudaStream_t st) {
  if (n <= 0 || nwords * 16 < n || k < 1 || k > 63 || w != (k + 15) / 16)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  const uint32_t* s = static_cast<const uint32_t*>(stream);
  const uint32_t* v = static_cast<const uint32_t*>(valid);
  const uint32_t* o = static_cast<const uint32_t*>(own);
  uint32_t* ky = static_cast<uint32_t*>(keys);
  uint8_t* mk = static_cast<uint8_t*>(masks);
  switch (w) {
    case 1: count_windows_kernel<1><<<blocks, 256, 0, st>>>(s, nwords, v, o, n, k, ky, mk); break;
    case 2: count_windows_kernel<2><<<blocks, 256, 0, st>>>(s, nwords, v, o, n, k, ky, mk); break;
    case 3: count_windows_kernel<3><<<blocks, 256, 0, st>>>(s, nwords, v, o, n, k, ky, mk); break;
    default: count_windows_kernel<4><<<blocks, 256, 0, st>>>(s, nwords, v, o, n, k, ky, mk); break;
  }
  return (int)cudaGetLastError();
}

// keys: [m][w] sorted rows, cov: m, masks: m; out_*: room for m rows; count:
// one int out (the unique rows); scratch: one int a block of 256 rows
extern "C" int ctk_segment_reduce(const void* keys, const void* cov, const void* masks, int m,
                                  int w, void* out_keys, void* out_cov, void* out_masks,
                                  void* count, void* scratch, cudaStream_t st) {
  if (m <= 0 || w < 1 || w > 4) return (int)cudaErrorInvalidValue;
  const uint32_t* ky = static_cast<const uint32_t*>(keys);
  const uint32_t* cv = static_cast<const uint32_t*>(cov);
  const uint8_t* mk = static_cast<const uint8_t*>(masks);
  uint32_t* oky = static_cast<uint32_t*>(out_keys);
  uint32_t* ocv = static_cast<uint32_t*>(out_cov);
  uint8_t* omk = static_cast<uint8_t*>(out_masks);
  int* cnt = static_cast<int*>(count);
  int* sc = static_cast<int*>(scratch);
  switch (w) {
    case 1: launch_reduce<1>(ky, cv, mk, m, oky, ocv, omk, cnt, sc, st); break;
    case 2: launch_reduce<2>(ky, cv, mk, m, oky, ocv, omk, cnt, sc, st); break;
    case 3: launch_reduce<3>(ky, cv, mk, m, oky, ocv, omk, cnt, sc, st); break;
    default: launch_reduce<4>(ky, cv, mk, m, oky, ocv, omk, cnt, sc, st); break;
  }
  return (int)cudaGetLastError();
}
