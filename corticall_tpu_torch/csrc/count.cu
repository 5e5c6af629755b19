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
// - segment_reduce must read each sorted row once (4 W bytes of key words,
//   4 of coverage, 1 of masks: 17 at k = 47) and write each unique row once.
//   One launch, one pass: persistent blocks take tiles of 2,048 rows in
//   order, copy the next tile's keys (with the row either side), coverage
//   and masks into shared memory with cp.async while they reduce the
//   current one, find heads and tails there, reduce each thread's 8
//   consecutive rows in registers and scan the threads' (coverage sum, mask
//   OR) segmented by heads with warp shuffles, take the tile's output offset
//   and the carry of a run begun in earlier tiles by decoupled look-back
//   (Merrill & Garland's single-pass scan) over 64-bit status words tagged
//   with the launch's epoch: no memset and no serial loop, a run of any
//   length summed by the scans and its row written by the tile holding its
//   last row (coverage and masks staged in shared memory and written out
//   coalesced, key words straight from the striped rows).  The
//   scratch (two counters, two status words a tile) stays on the card
//   between launches (ops/build_device.reduce_scratch).

#include "kmer.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// segment_reduce: one pass over tiles of sorted rows
// ---------------------------------------------------------------------------

constexpr int kReduceThreads = 256;                        // 8 warps
constexpr int kReduceItems = 8;                            // rows a thread
constexpr int kTileRows = kReduceThreads * kReduceItems;   // 2,048
constexpr int kReduceWarps = kReduceThreads / 32;
constexpr int kTileSpans = kReduceItems * kReduceWarps;    // a warp's 32 rows of an item
constexpr int kLaneSpans = kTileSpans / 32;                // warp 0 scans them, this many a lane
static_assert(kTileSpans % 32 == 0, "warp 0 scans the tile's spans in whole lanes");
static_assert(kReduceWarps <= 32, "warp 0 scans the warps' spans, one a lane");

// A tile's status word: a 40-bit value, a 2-bit flag (0: not yet written in
// this launch) and the launch's epoch above them, so that words left by an
// earlier launch read as not written and no memset precedes a launch.
constexpr int kFlagShift = 40, kEpochShift = 42;
constexpr unsigned long long kAggregate = 1ull, kPrefix = 2ull;
constexpr uint32_t kCut = 0x100u;  // an (OR | cut) word's bit: the span holds a head

// A span of consecutive rows, reduced: its heads and tails (first and last
// rows of runs), and the coverage sum and mask OR of its last open run (from
// its last head, or all of it), with kCut set when it holds a head.  The
// combination (older span first) is associative, and its sum and OR are
// exact in any grouping: uint32 sums wrap as the twin's do.
struct Span {
  uint32_t heads, tails, sum, orc;
};

__device__ __forceinline__ Span combine(const Span& a, const Span& b) {
  const bool cut = b.orc & kCut;
  return {a.heads + b.heads, a.tails + b.tails, cut ? b.sum : a.sum + b.sum,
          cut ? b.orc : (a.orc | b.orc)};
}

__device__ __forceinline__ Span shfl_span(const Span& s, int src) {
  return {__shfl_sync(kFullMask, s.heads, src), __shfl_sync(kFullMask, s.tails, src),
          __shfl_sync(kFullMask, s.sum, src), __shfl_sync(kFullMask, s.orc, src)};
}

__device__ __forceinline__ Span shfl_up_span(const Span& s, int d) {
  return {__shfl_up_sync(kFullMask, s.heads, d), __shfl_up_sync(kFullMask, s.tails, d),
          __shfl_up_sync(kFullMask, s.sum, d), __shfl_up_sync(kFullMask, s.orc, d)};
}

// A status word's flag and value travel in one 64-bit word, and a relaxed
// gpu-scope 64-bit access is single-copy atomic, so a read is never torn;
// nothing else is published through them, so no ordering is needed
// (release / acquire cost ~8% on a 17.7M-row chunk: tools/table_probe.py).
__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long status_word(unsigned long long epoch,
                                                          unsigned long long flag,
                                                          unsigned long long value) {
  return epoch << kEpochShift | flag << kFlagShift | value;
}

// a status word of this launch's epoch, written (A or P); spins until it is
__device__ __forceinline__ unsigned long long await_status(const unsigned long long* p,
                                                           unsigned long long epoch) {
  unsigned long long v = ld_status(p);
  while (v >> kEpochShift != epoch || !(v >> kFlagShift & 3ull)) {
    __nanosleep(32);
    v = ld_status(p);
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
  return v;
}

__device__ __forceinline__ uint32_t warp_or(uint32_t v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v |= __shfl_xor_sync(kFullMask, v, d);
  return v;
}

template <int W>
__device__ __forceinline__ bool same_words(const uint32_t* a, const uint32_t* b) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < W; ++j) eq = eq && a[j] == b[j];
  return eq;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async: a copy from global into shared memory that bypasses registers
// and completes in the background, in groups the block waits on
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {  // all groups but the newest
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// A tile's inputs in shared memory: its key rows with the row either side
// (global word x at keys[x - base], base the multiple of 4 at or below the
// row before the tile's first word, so 16-byte pieces line up), its
// coverage and its masks.  The output rows are staged over them in place.
template <int W>
struct __align__(16) TileBuf {
  static constexpr int kKeyWords = ((kTileRows + 2) * W + 4 + 3) / 4 * 4;  // whole 16-byte pieces
  uint32_t keys[kKeyWords];
  uint32_t cov[kTileRows];
  uint8_t masks[kTileRows];
};

// Issue (one commit group) the copies of tile `tile`'s inputs into b:
// 16-byte pieces, and the words (the last tile's mask bytes) outside them.
template <int W>
__device__ __forceinline__ void prefetch_tile(TileBuf<W>& b, const uint32_t* __restrict__ keys,
                                              const uint32_t* __restrict__ cov,
                                              const uint8_t* __restrict__ masks, int m,
                                              long long tile) {
  const int t = threadIdx.x;
  const long long start = tile * kTileRows;
  const int rows = (int)min((long long)kTileRows, (long long)m - start);
  const long long base = ((start - 1) * W) & ~3ll;
  const long long lo = max(start - 1, 0ll) * W, hi = min(start + rows + 1, (long long)m) * W;
  const long long a = min(hi, (lo + 3) & ~3ll), z = max(a, hi & ~3ll);
  for (long long x = lo + t; x < a; x += kReduceThreads) cp_async4(&b.keys[x - base], keys + x);
  for (long long x = z + t; x < hi; x += kReduceThreads) cp_async4(&b.keys[x - base], keys + x);
  for (long long v = a / 4 + t; v < z / 4; v += kReduceThreads)
    cp_async16(&b.keys[4 * v - base], keys + 4 * v);
  for (int v = t; v < rows / 4; v += kReduceThreads)
    cp_async16(&b.cov[4 * v], cov + start + 4 * v);
  for (int x = rows / 4 * 4 + t; x < rows; x += kReduceThreads)
    cp_async4(&b.cov[x], cov + start + x);
  for (int v = t; v < rows / 16; v += kReduceThreads)
    cp_async16(&b.masks[16 * v], masks + start + 16 * v);
  for (int x = rows / 16 * 16 + t; x < rows; x += kReduceThreads)
    b.masks[x] = __ldg(masks + start + x);
  cp_async_commit();
}

// The block-wide state of a tile's reduction.
struct TileShared {
  // a row's head flag (it begins a run), and at kTileRows the flag of the
  // row after the tile (1 past the last row); row i's tail flag is flag i + 1
  __align__(16) uint8_t head[kTileRows + 16];
  uint32_t tails[kTileSpans];  // tails of a warp's 32 rows of an item, then their prefix
  Span span[kReduceWarps];     // a warp's 256 rows reduced, then their prefix
  long long out;               // the output row of the tile's first run end
  int ends;                    // the runs that end in the tile
  uint32_t carry[2];           // the continued run's (sum, OR) from the tiles before
};

// One tile of kTileRows sorted rows, already in b.
//  1. striped (row i * kReduceThreads + t is thread t's item i): each row's
//     head flag from the key rows in shared memory; then its tail flag (the
//     next row's head), balloted a warp and item;
//  2. blocked (rows 8 t .. 8 t + 7 are thread t's): the rows' coverage,
//     masks and flags as vectors, reduced in registers to the thread's span,
//     a warp-shuffle scan of the spans, each warp's total into shared memory;
//  3. warp 0 scans the warps' spans and the tail counts (exclusive prefixes
//     within the tile) and publishes the tile's aggregate: its heads, and its
//     trailing open run's (sum, OR) -- already the inclusive prefix (P) when
//     the tile has a head; then looks back (32 tiles a step) until a P on
//     each word: the heads before the tile (its output offset) and, when its
//     first row is not a head, the carry of the run it continues; then
//     publishes its P;
//  4. blocked: each thread walks its rows from its prefix (plus the carry for
//     a run begun before the tile) and stages each run end's (sum, OR) at its
//     rank among the tile's tails, in place over the inputs already read;
//     striped: each run end's key words go straight to their output row; the
//     staged coverage and masks go out coalesced.
// A run's row is written by the tile that holds its last row, at its head's
// rank (the heads before it), so every output row is written once.
template <int W>
__device__ __forceinline__ void reduce_tile(TileBuf<W>& b, TileShared& sh, long long tile, int m,
                                            int ntiles, uint32_t* __restrict__ out_keys,
                                            uint32_t* __restrict__ out_cov,
                                            uint8_t* __restrict__ out_masks,
                                            int* __restrict__ count,
                                            unsigned long long* __restrict__ status,
                                            unsigned long long epoch) {
  static_assert(kReduceItems == 8, "a thread's rows are read as 8-row vectors");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long start = tile * kTileRows;
  const int rows = (int)min((long long)kTileRows, (long long)m - start);
  const long long base = ((start - 1) * W) & ~3ll;

  // 1. head flags, then tail ballots, striped
#pragma unroll
  for (int i = 0; i < kReduceItems; ++i) {
    const int local = i * kReduceThreads + t;
    const long long r = start + local;
    bool head = local == rows;  // past the last row: the data's end
    if (local < rows) {
      const uint32_t* row = b.keys + (r * W - base);
      head = r == 0 || !same_words<W>(row, row - W);
    }
    sh.head[local] = head;
  }
  if (t == 0 && rows == kTileRows) {
    const long long r = start + kTileRows;  // the row after the tile
    const uint32_t* row = b.keys + (r * W - base);
    sh.head[kTileRows] = r == m || !same_words<W>(row, row - W);
  }
  __syncthreads();
  unsigned tails[kReduceItems];
#pragma unroll
  for (int i = 0; i < kReduceItems; ++i) {
    const int local = i * kReduceThreads + t;
    tails[i] = __ballot_sync(kFullMask, local < rows && sh.head[local + 1]);
    if (lane == 0) sh.tails[i * kReduceWarps + warp] = (uint32_t)__popc(tails[i]);
  }

  // 2. the thread's 8 rows, blocked
  const int r0 = kReduceItems * t;
  const uint4 c0 = reinterpret_cast<const uint4*>(b.cov + r0)[0];
  const uint4 c1 = reinterpret_cast<const uint4*>(b.cov + r0)[1];
  const uint2 mk2 = *reinterpret_cast<const uint2*>(b.masks + r0);
  const uint2 hd2 = *reinterpret_cast<const uint2*>(sh.head + r0);
  const uint32_t c[kReduceItems] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const unsigned long long mk = (unsigned long long)mk2.y << 32 | mk2.x;
  const unsigned long long hd = (unsigned long long)hd2.y << 32 | hd2.x;
  const unsigned long long tl = hd >> 8 | (unsigned long long)sh.head[r0 + kReduceItems] << 56;
  const int valid = max(0, min(kReduceItems, rows - r0));
  Span own = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int u = 0; u < kReduceItems; ++u) {
    if (u < valid) {
      const bool h = hd >> (8 * u) & 1ull;
      const uint32_t mu = (uint32_t)(mk >> (8 * u)) & 0xFFu;
      own = combine(own, Span{h, (uint32_t)(tl >> (8 * u) & 1ull), c[u], mu | (h ? kCut : 0u)});
    }
  }
  Span inc = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Span p = shfl_up_span(inc, d);
    if (lane >= d) inc = combine(p, inc);
  }
  Span before_lane = shfl_up_span(inc, 1);
  if (lane == 0) before_lane = Span{0u, 0u, 0u, 0u};
  if (lane == 31) sh.span[warp] = inc;
  __syncthreads();

  // 3. the tile's prefixes, then its prefix among the tiles by look-back
  if (warp == 0) {
    Span ws = lane < kReduceWarps ? sh.span[lane] : Span{0u, 0u, 0u, 0u};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Span p = shfl_up_span(ws, d);
      if (lane >= d) ws = combine(p, ws);
    }
    Span exc = shfl_up_span(ws, 1);
    if (lane == 0) exc = Span{0u, 0u, 0u, 0u};
    if (lane < kReduceWarps) sh.span[lane] = exc;
    const Span total = shfl_span(ws, 31);
    // the tail counts: lane holds kLaneSpans consecutive ones
    uint32_t tc[kLaneSpans], tsum = 0u;
#pragma unroll
    for (int u = 0; u < kLaneSpans; ++u) {
      tc[u] = sh.tails[kLaneSpans * lane + u];
      tsum += tc[u];
    }
    uint32_t tinc = tsum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t p = __shfl_up_sync(kFullMask, tinc, d);
      if (lane >= d) tinc += p;
    }
    uint32_t texc = tinc - tsum;
#pragma unroll
    for (int u = 0; u < kLaneSpans; ++u) {
      sh.tails[kLaneSpans * lane + u] = texc;
      texc += tc[u];
    }
    const bool lead = !sh.head[0];  // the tile continues a run
    const bool cut = total.orc & kCut;
    unsigned long long* own_status = status + 2 * tile;  // heads word, carry word
    if (lane == 0) {
      st_status(own_status, status_word(epoch, tile ? kAggregate : kPrefix, total.heads));
      st_status(own_status + 1,
                status_word(epoch, tile == 0 || cut ? kPrefix : kAggregate,
                            (unsigned long long)(total.orc & 0xFFu) << 32 | total.sum));
    }
    uint32_t before = 0u, csum = 0u, cor = 0u;
    bool hdone = tile == 0, cdone = tile == 0 || !lead;
    for (long long j0 = tile - 1; !(hdone && cdone); j0 -= 32) {
      const long long j = j0 - lane;  // lane 0 the nearest tile
      unsigned long long hw = 0ull, cw = 0ull;
      if (j >= 0 && !hdone) hw = await_status(status + 2 * j, epoch);
      if (j >= 0 && !cdone) cw = await_status(status + 2 * j + 1, epoch);
      if (!hdone) {
        const unsigned pm = __ballot_sync(kFullMask, j < 0 || (hw >> kFlagShift & 3ull) == kPrefix);
        const int stop = pm ? __ffs(pm) - 1 : 31;
        before += warp_sum(lane <= stop ? (uint32_t)hw : 0u);
        hdone = pm != 0u;
      }
      if (!cdone) {
        const unsigned pm = __ballot_sync(kFullMask, j < 0 || (cw >> kFlagShift & 3ull) == kPrefix);
        const int stop = pm ? __ffs(pm) - 1 : 31;
        csum += warp_sum(lane <= stop ? (uint32_t)cw : 0u);
        cor |= warp_or(lane <= stop ? (uint32_t)(cw >> 32) & 0xFFu : 0u);
        cdone = pm != 0u;
      }
    }
    if (lane == 0) {
      if (tile) st_status(own_status, status_word(epoch, kPrefix, before + total.heads));
      if (tile && !cut)
        st_status(own_status + 1,
                  status_word(epoch, kPrefix,
                              (unsigned long long)((cor | total.orc) & 0xFFu) << 32 |
                                  (csum + total.sum)));
      if (tile == ntiles - 1) *count = (int)(before + total.heads);
      sh.carry[0] = csum;
      sh.carry[1] = cor;
      sh.out = (long long)before - (lead ? 1 : 0);
      sh.ends = (int)total.tails;
    }
  }
  __syncthreads();

  // 4. run ends: (sum, OR) staged blocked, keys written striped
  const long long out0 = sh.out;
  const Span pre = combine(sh.span[warp], before_lane);  // the tile's rows before mine
  uint32_t s = pre.sum, o = pre.orc;
  if (!(o & kCut)) {  // a run begun before the tile
    s += sh.carry[0];
    o |= sh.carry[1];
  }
  int at = (int)pre.tails;
#pragma unroll
  for (int u = 0; u < kReduceItems; ++u) {
    if (u < valid) {
      if (hd >> (8 * u) & 1ull) s = o = 0u;
      s += c[u];
      o |= (uint32_t)(mk >> (8 * u)) & 0xFFu;
      if (tl >> (8 * u) & 1ull) {
        b.cov[at] = s;
        b.masks[at] = (uint8_t)o;
        ++at;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kReduceItems; ++i) {
    if (tails[i] >> lane & 1u) {
      const long long r = start + i * kReduceThreads + t;
      const uint32_t* row = b.keys + (r * W - base);
      const long long dst =
          (out0 + sh.tails[i * kReduceWarps + warp] + __popc(tails[i] & ((1u << lane) - 1u))) * W;
#pragma unroll
      for (int j = 0; j < W; ++j) out_keys[dst + j] = row[j];
    }
  }
  __syncthreads();
  const int ends = sh.ends;
  for (int x = t; x < ends; x += kReduceThreads) {
    out_cov[out0 + x] = b.cov[x];
    out_masks[out0 + x] = b.masks[x];
  }
  __syncthreads();  // b is refilled next
}

// A persistent block: tiles taken in order from an atomic counter, each
// tile's inputs copied (cp.async) while the block reduces the tile before
// it, so a tile waits only on running tiles and the loads overlap the scans
// and the look-back.  The last block to finish puts the two counters back
// to 0 for the next launch.
template <int W>
__global__ void __launch_bounds__(kReduceThreads, W < 4 ? 3 : 2)  // as many as shared memory holds
segment_reduce_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ cov,
                      const uint8_t* __restrict__ masks, int m, int ntiles,
                      uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_cov,
                      uint8_t* __restrict__ out_masks, int* __restrict__ count,
                      unsigned* __restrict__ counters, unsigned long long* __restrict__ status,
                      unsigned long long epoch) {
  extern __shared__ __align__(16) unsigned char smem[];
  TileBuf<W>* buf = reinterpret_cast<TileBuf<W>*>(smem);
  __shared__ TileShared sh;
  __shared__ int s_next;

  if (threadIdx.x == 0) s_next = (int)atomicAdd(counters, 1u);
  __syncthreads();
  int tile = s_next, cur = 0;
  if (tile < ntiles) prefetch_tile<W>(buf[0], keys, cov, masks, m, tile);
  while (tile < ntiles) {
    __syncthreads();  // every thread has read s_next
    if (threadIdx.x == 0) s_next = (int)atomicAdd(counters, 1u);
    __syncthreads();
    const int next = s_next;
    if (next < ntiles)
      prefetch_tile<W>(buf[cur ^ 1], keys, cov, masks, m, next);
    else
      cp_async_commit();  // an empty group: the wait below counts groups
    cp_async_wait_prior();
    __syncthreads();
    reduce_tile<W>(buf[cur], sh, tile, m, ntiles, out_keys, out_cov, out_masks, count, status,
                   epoch);
    tile = next;
    cur ^= 1;
  }
  if (threadIdx.x == 0 && atomicAdd(counters + 1, 1u) == gridDim.x - 1) {
    counters[0] = 0u;  // every block has taken its last tile
    counters[1] = 0u;
  }
}

template <int W>
int launch_reduce(const uint32_t* ky, const uint32_t* cv, const uint8_t* mk, int m, int ntiles,
                  uint32_t* oky, uint32_t* ocv, uint8_t* omk, int* cnt, unsigned* counters,
                  unsigned long long* status, unsigned long long epoch, cudaStream_t st) {
  const int smem = (int)(2 * sizeof(TileBuf<W>));
  cudaError_t err = cudaFuncSetAttribute(segment_reduce_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_reduce_kernel<W>,
                                                        kReduceThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = max(1, min(ntiles, sms * per_sm));
  segment_reduce_kernel<W><<<blocks, kReduceThreads, smem, st>>>(
      ky, cv, mk, m, ntiles, oky, ocv, omk, cnt, counters, status, epoch);
  return (int)cudaGetLastError();
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

// keys: [m][w] sorted rows, cov: m, masks: m, each 16-byte aligned; out_*:
// room for m rows; count: one int out (the unique rows); scratch: 16-byte
// aligned, two uint32 counters (zero at rest) in its first 8 bytes, then from
// byte 16 two status words (uint64) a tile for `tiles` tiles; epoch: 1 ..
// 2^22 - 1, not used by an earlier launch on words still holding it.
extern "C" int ctk_segment_reduce(const void* keys, const void* cov, const void* masks, int m,
                                  int w, void* out_keys, void* out_cov, void* out_masks,
                                  void* count, void* scratch, int tiles, unsigned epoch,
                                  cudaStream_t st) {
  const long long ntiles = ((long long)m + kTileRows - 1) / kTileRows;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (m <= 0 || w < 1 || w > 4 || tiles < ntiles || epoch == 0u || epoch >= (1u << 22) ||
      !aligned(scratch) || !aligned(keys) || !aligned(cov) || !aligned(masks))
    return (int)cudaErrorInvalidValue;
  const uint32_t* ky = static_cast<const uint32_t*>(keys);
  const uint32_t* cv = static_cast<const uint32_t*>(cov);
  const uint8_t* mk = static_cast<const uint8_t*>(masks);
  uint32_t* oky = static_cast<uint32_t*>(out_keys);
  uint32_t* ocv = static_cast<uint32_t*>(out_cov);
  uint8_t* omk = static_cast<uint8_t*>(out_masks);
  int* cnt = static_cast<int*>(count);
  unsigned* counters = static_cast<unsigned*>(scratch);
  unsigned long long* status = static_cast<unsigned long long*>(scratch) + 2;
  const int nt = (int)ntiles;
  switch (w) {
    case 1: return launch_reduce<1>(ky, cv, mk, m, nt, oky, ocv, omk, cnt, counters, status, epoch, st);
    case 2: return launch_reduce<2>(ky, cv, mk, m, nt, oky, ocv, omk, cnt, counters, status, epoch, st);
    case 3: return launch_reduce<3>(ky, cv, mk, m, nt, oky, ocv, omk, cnt, counters, status, epoch, st);
    default: return launch_reduce<4>(ky, cv, mk, m, nt, oky, ocv, omk, cnt, counters, status, epoch, st);
  }
}
