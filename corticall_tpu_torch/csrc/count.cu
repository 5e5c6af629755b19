// The device graph build's k-mer counting (ops/build_device.py).
//
// Replaces the XLA device code and the host packing of
// corticall_tpu/ops/build_device.py:
//   ctk_count_windows  <- _extract_windows (line 73) and the host packing of
//                         DeviceCounter._count_piece (lines 216-232): a
//                         piece's raw read bytes in, its valid windows out,
//                         compacted in stream order, each as its canonical
//                         k-mer and in/out edge masks;
//   ctk_segment_reduce <- _sort_reduce's segment sums and per-bit maxima
//                         (lines 149-163): over rows already sorted by key,
//                         each run of equal keys becomes one row with its
//                         coverage summed (uint32, wrapping) and its masks ORed.
// The sort between them stays torch.sort, as the JAX package left lax.sort
// to XLA.  Plain PyTorch twins: corticall_tpu_torch/ops/build_device.py.
//
// A piece is ASCII bytes: reads joined by k 'N's.  ACGT and acgt are the
// bases 0..3, every other byte an invalid base.  The window at i is valid
// when it is owned (own_lo <= i < own_hi), i + k <= n and its k bases are
// valid; its in and out masks see the bases at i - 1 and i + k where those
// are valid bases of the piece.  The JAX package packs a piece on the host
// at 2 bits a base because its rig's host-to-device link ran at tens of
// MB/s; over the H100's PCIe a 33.5 MB chunk takes milliseconds, and the
// host packing had cost over half of the device route's seconds, so the
// bytes cross as they are and are packed here.
//
// What bounds them on this card, and what the design does about it:
// - count_windows reads each byte once and writes each valid window's 4 W + 1
//   bytes: on a trio chunk at k = 47, 33.6 MB in and 17.7M rows (13 bytes
//   each, 230 MB) out, 0.079 ms at the card's memory rate; measured, it is
//   bound by its instructions instead (a tile's load, tests, scans and
//   writes run in series in a block, and the canonical form of a window
//   is a reverse complement of W words: PERF.md, tools/table_probe.py
//   --count --ablate), so the design keeps them few.  Persistent blocks of
//   256 threads take tiles of 4,096 windows in order from a counter; a
//   block loads its tile's bytes (with one vector before it and 64 bytes
//   after it: the first window's prev base, the last's other bases and its
//   next) as 16-byte vectors and packs them in shared memory into the 2-bit
//   words and a base-valid bitmap (four bytes at a time with byte-SIMD
//   compares).  A thread takes 16 windows, striped (j * 256 + t), tests
//   them on the bitmap, and warp ballots rank a warp's 32 valid windows;
//   warp 0 scans the tile's 128 spans, publishes the tile's count, and takes
//   the tile's first output row by decoupled look-back over status words
//   tagged with the launch's epoch (scratch of its own: count_scratch) while
//   the other warps canonicalize their valid windows and stage keys and
//   masks in shared memory at their ranks.  A tile's rows are contiguous in
//   the output, so they leave as 16-byte stores.  The tile that holds the
//   last window writes the count.  Sizes: a tile's staging is 16 W KB of
//   keys and 4 KB of masks (55 KB of shared memory at W = 3: four blocks,
//   1,024 threads an SM); halving the tile doubles its look-backs, doubling
//   it halves the blocks an SM (tools/table_probe.py --count --ablate).
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

// ---------------------------------------------------------------------------
// look-back status words, shared by both kernels
// ---------------------------------------------------------------------------

// A tile's status word: a 40-bit value, a 2-bit flag (0: not yet written in
// this launch) and the launch's epoch above them, so that words left by an
// earlier launch read as not written and no memset precedes a launch.
constexpr int kFlagShift = 40, kEpochShift = 42;
constexpr unsigned long long kAggregate = 1ull, kPrefix = 2ull;

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

// ---------------------------------------------------------------------------
// count_windows: a piece's bytes in, its valid windows out in stream order
// ---------------------------------------------------------------------------

constexpr int kCountThreads = 256;                         // 8 warps
constexpr int kCountItems = 16;                            // windows a thread
constexpr int kCountTile = kCountThreads * kCountItems;    // 4,096 windows a tile
constexpr int kCountWarps = kCountThreads / 32;
constexpr int kCountSpans = kCountItems * kCountWarps;     // a warp's 32 windows of an item
constexpr int kCountLaneSpans = kCountSpans / 32;          // warp 0 scans them, this many a lane
constexpr int kLead = 16;   // bytes loaded before a tile: its first window's prev base, a vector
constexpr int kTrail = 64;  // after it: the last window's other k - 1 bases and next base
constexpr int kTileVecs = (kLead + kCountTile + kTrail) / 16;  // 16-byte vectors a tile loads
static_assert(kCountSpans % 32 == 0, "warp 0 scans the tile's spans in whole lanes");
static_assert(kCountItems <= 32, "a thread's windows' flags are the bits of one word");

// A tile in shared memory.  Loaded byte x of the tile (global byte
// start - kLead + x) is base x of `stream` (bits 30 - 2 (x % 16) of word
// x / 16, the JAX package's stream layout) and bit x of `valid`; a byte
// outside the piece is an invalid base.
template <int W>
struct __align__(16) CountBuf {
  uint32_t keys[kCountTile * W];      // the tile's valid windows' keys, at their ranks
  uint8_t masks[kCountTile];          // and their masks (in << 4 | out)
  uint32_t stream[kTileVecs + 1];     // 2-bit codes, an invalid base as 3
  uint32_t valid[kTileVecs / 2 + 3];  // base-valid bits (read up to two words past a window)
  uint32_t ballots[kCountSpans];      // a span's valid windows, a bit a lane
  uint32_t before[kCountSpans];       // the tile's valid windows before each span
  long long out;                      // the output row of the tile's first valid window
  int rows;                           // the tile's valid windows
};

// Four bytes (the first in the low byte): their 2-bit codes, the first
// highest, in bits 0-7 (an invalid base as 3), and their base-valid bits,
// the first lowest, in bits 8-11.  Only 'A' and 'a' become 'a' under | 0x20
// (and so for c, g, t), and ((c >> 1) ^ (c >> 2)) & 3 maps a, c, g, t
// (0x61, 0x63, 0x67, 0x74) to 0, 1, 2, 3.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  const uint32_t c = x | 0x20202020u;
  const uint32_t ok = __vcmpeq4(c, 0x61616161u) | __vcmpeq4(c, 0x63636363u) |
                      __vcmpeq4(c, 0x67676767u) | __vcmpeq4(c, 0x74747474u);
  const uint32_t code = ((((c >> 1) ^ (c >> 2)) & ok) | ~ok) & 0x03030303u;
  const uint32_t r = __byte_perm(code, 0u, 0x0123);  // the first base's code in the top byte
  return ((r | r >> 6 | r >> 12 | r >> 18) & 0xFFu) |
         (((ok & 0x08040201u) * 0x01010101u) >> 24) << 8;
}

// The tile's bytes [g0, g0 + 16 kTileVecs) into b.stream and b.valid, a
// 16-byte vector a thread; vectors across the piece's ends byte by byte.
template <int W>
__device__ __forceinline__ void load_tile(CountBuf<W>& b, const uint8_t* __restrict__ bases,
                                          long long n, long long g0) {
  for (int v = threadIdx.x; v < kTileVecs; v += kCountThreads) {
    const long long g = g0 + 16ll * v;
    uint4 x;
    if (g >= 0 && g + 16 <= n) {
      x = __ldg(reinterpret_cast<const uint4*>(bases + g));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};  // byte 0: an invalid base
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (g + u >= 0 && g + u < n) w[u >> 2] |= (uint32_t)__ldg(bases + g + u) << (8 * (u & 3));
      x = make_uint4(w[0], w[1], w[2], w[3]);
    }
    const uint32_t p0 = pack4(x.x), p1 = pack4(x.y), p2 = pack4(x.z), p3 = pack4(x.w);
    b.stream[v] = (p0 & 0xFFu) << 24 | (p1 & 0xFFu) << 16 | (p2 & 0xFFu) << 8 | (p3 & 0xFFu);
    reinterpret_cast<uint16_t*>(b.valid)[v] =
        (uint16_t)(p0 >> 8 | (p1 >> 8) << 4 | (p2 >> 8) << 8 | (p3 >> 8) << 12);
  }
}

// bits [p, p + k) of a bitmap all set (k <= 63: three words, funnel-shifted)
__device__ __forceinline__ bool run_set(const uint32_t* words, int p, int k) {
  const int q = p >> 5, r = p & 31;
  const uint32_t lo = __funnelshift_r(words[q], words[q + 1], r);
  const uint32_t hi = __funnelshift_r(words[q + 1], words[q + 2], r);
  const unsigned long long need = (1ull << k) - 1ull;
  return (((unsigned long long)hi << 32 | lo) & need) == need;
}

__device__ __forceinline__ bool bit_of(const uint32_t* words, int p) {
  return words[p >> 5] >> (p & 31) & 1u;
}

// 32 stream bits from bit `off` (MSB first), off >= 0
__device__ __forceinline__ uint32_t stream_bits(const uint32_t* stream, int off) {
  return __funnelshift_l(stream[(off >> 5) + 1], stream[off >> 5], off & 31);
}

__device__ __forceinline__ uint32_t code_of(const uint32_t* stream, int p) {
  return stream[p >> 4] >> (30 - 2 * (p & 15)) & 3u;
}

// Warp 0, after the tile has published its count: the valid windows of the
// tiles before `tile`, looking back 32 tiles a step to the nearest prefix.
__device__ __forceinline__ uint32_t look_back(const unsigned long long* __restrict__ status,
                                              int tile, unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  uint32_t before = 0u;
  for (int j0 = tile - 1, done = tile == 0; !done; j0 -= 32) {
    const int j = j0 - lane;  // lane 0 the nearest tile
    const unsigned long long s = j >= 0 ? await_status(status + j, epoch) : 0ull;
    const unsigned pm = __ballot_sync(kFullMask, j < 0 || (s >> kFlagShift & 3ull) == kPrefix);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    before += warp_sum(lane <= stop ? (uint32_t)s : 0u);
    done = pm != 0u;
  }
  return before;
}

// The tile's staged rows out: key words and mask bytes each from their
// first 16-byte boundary in the output as 16-byte stores, the ragged ends a
// word or a byte a thread.
template <int W>
__device__ __forceinline__ void write_rows(const CountBuf<W>& b, uint32_t* __restrict__ keys,
                                           uint8_t* __restrict__ masks) {
  const int t = threadIdx.x;
  const long long out = b.out;
  const int rows = b.rows;
  uint32_t* kd = keys + out * W;
  const int words = rows * W;
  const int kh = min(words, (int)((4 - ((out * W) & 3)) & 3));
  const int kv = (words - kh) >> 2;
  if (t < kh) kd[t] = b.keys[t];
  for (int v = t; v < kv; v += kCountThreads) {
    const int x = kh + 4 * v;
    *reinterpret_cast<uint4*>(kd + x) =
        make_uint4(b.keys[x], b.keys[x + 1], b.keys[x + 2], b.keys[x + 3]);
  }
  for (int x = kh + 4 * kv + t; x < words; x += kCountThreads) kd[x] = b.keys[x];
  uint8_t* md = masks + out;
  const int mh = min(rows, (int)((16 - (out & 15)) & 15));
  const int mv = (rows - mh) >> 4;
  if (t < mh) md[t] = b.masks[t];
  for (int v = t; v < mv; v += kCountThreads) {
    const uint8_t* s = b.masks + mh + 16 * v;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = s[4 * q] | (uint32_t)s[4 * q + 1] << 8 | (uint32_t)s[4 * q + 2] << 16 |
             (uint32_t)s[4 * q + 3] << 24;
    *reinterpret_cast<uint4*>(md + mh + 16 * v) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int x = mh + 16 * mv + t; x < rows; x += kCountThreads) md[x] = b.masks[x];
}

// One tile of kCountTile windows, from `tile` * kCountTile.
//  1. its bytes into shared memory, packed (load_tile);
//  2. striped (window j * kCountThreads + t is thread t's item j): each
//     window's validity, balloted a warp and item;
//  3. warp 0 scans the spans' counts (the valid windows before each, within
//     the tile) and publishes the tile's count: A, or P for tile 0;
//  4. warp 0 looks back for the tile's first output row and publishes P
//     (and the count, from the last tile), while every warp canonicalizes
//     its valid windows (today's key arithmetic over shared memory) and
//     stages each key and mask at its rank in the tile;
//  5. the staged rows out, contiguous (write_rows).
template <int W>
__device__ __forceinline__ void count_tile(CountBuf<W>& b, const uint8_t* __restrict__ bases,
                                           long long n, long long own_lo, long long own_hi, int k,
                                           int tile, int ntiles, uint32_t* __restrict__ keys,
                                           uint8_t* __restrict__ masks, int* __restrict__ count,
                                           unsigned long long* __restrict__ status,
                                           unsigned long long epoch) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long start = (long long)tile * kCountTile;
  load_tile<W>(b, bases, n, start - kLead);
  __syncthreads();

  unsigned mine = 0u;  // bit j: item j's window is valid
#pragma unroll
  for (int j = 0; j < kCountItems; ++j) {
    const int l = j * kCountThreads + t;
    const long long i = start + l;
    // own_hi <= n, and a byte past the piece is invalid, so i + k <= n
    const bool ok = i >= own_lo && i < own_hi && run_set(b.valid, kLead + l, k);
    const unsigned bal = __ballot_sync(kFullMask, ok);
    if (lane == 0) b.ballots[j * kCountWarps + warp] = bal;
    mine |= (unsigned)ok << j;
  }
  __syncthreads();

  uint32_t rows = 0u;
  if (warp == 0) {
    uint32_t c[kCountLaneSpans], sum = 0u;
#pragma unroll
    for (int u = 0; u < kCountLaneSpans; ++u) {
      c[u] = __popc(b.ballots[kCountLaneSpans * lane + u]);
      sum += c[u];
    }
    uint32_t inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t p = __shfl_up_sync(kFullMask, inc, d);
      if (lane >= d) inc += p;
    }
    uint32_t exc = inc - sum;
#pragma unroll
    for (int u = 0; u < kCountLaneSpans; ++u) {
      b.before[kCountLaneSpans * lane + u] = exc;
      exc += c[u];
    }
    rows = __shfl_sync(kFullMask, inc, 31);
    if (lane == 0) st_status(status + tile, status_word(epoch, tile ? kAggregate : kPrefix, rows));
  }
  __syncthreads();

  if (warp == 0) {
    const uint32_t before = look_back(status, tile, epoch);
    if (lane == 0) {
      if (tile) st_status(status + tile, status_word(epoch, kPrefix, before + rows));
      if (tile == ntiles - 1) *count = (int)(before + rows);
      b.out = before;
      b.rows = (int)rows;
    }
  }
  // the valid windows, staged at their ranks
  const int s = 32 * W - 2 * k;
  const unsigned below = (1u << lane) - 1u;
  for (int j = 0; j < kCountItems; ++j) {
    if (!(mine >> j & 1u)) continue;
    const int span = j * kCountWarps + warp;
    const int rank = (int)b.before[span] + __popc(b.ballots[span] & below);
    const int p = kLead + j * kCountThreads + t;
    // word w of the right-aligned key: stream bits [2p - s + 32w, + 32)
    uint32_t v[W], canon[W];
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = stream_bits(b.stream, 2 * p - s + 32 * w);
    v[0] &= top_mask<W>(k);
    const bool flip = canonicalize<W>(v, canon, k);
    // the bytes before the piece and past it are invalid bases
    const bool has_prev = bit_of(b.valid, p - 1), has_next = bit_of(b.valid, p + k);
    const uint32_t prev_b = code_of(b.stream, p - 1), next_b = code_of(b.stream, p + k);
    uint32_t in_m = 0u, out_m = 0u;
    if (!flip) {
      if (has_prev) in_m = 1u << prev_b;
      if (has_next) out_m = 1u << next_b;
    } else {
      if (has_next) in_m = 1u << (3u - next_b);
      if (has_prev) out_m = 1u << (3u - prev_b);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) b.keys[rank * W + w] = canon[w];
    b.masks[rank] = (uint8_t)((in_m << 4) | out_m);
  }
  __syncthreads();
  write_rows<W>(b, keys, masks);
  __syncthreads();  // b is refilled next
}

// A persistent block: tiles taken in order from an atomic counter, so a
// tile looks back only at tiles that running blocks hold.  The last block
// to finish puts the two counters back to 0 for the next launch.
template <int W>
__global__ void __launch_bounds__(kCountThreads)
count_windows_kernel(const uint8_t* __restrict__ bases, long long n, long long own_lo,
                     long long own_hi, int k, int ntiles, uint32_t* __restrict__ keys,
                     uint8_t* __restrict__ masks, int* __restrict__ count,
                     unsigned* __restrict__ counters, unsigned long long* __restrict__ status,
                     unsigned long long epoch) {
  extern __shared__ __align__(16) unsigned char smem[];
  CountBuf<W>& b = *reinterpret_cast<CountBuf<W>*>(smem);
  __shared__ int s_tile;
  for (;;) {
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(counters, 1u);
    __syncthreads();
    const int tile = s_tile;
    if (tile >= ntiles) break;
    count_tile<W>(b, bases, n, own_lo, own_hi, k, tile, ntiles, keys, masks, count, status,
                  epoch);
  }
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(counters + 1, 1u) == gridDim.x - 1) {
      counters[0] = 0u;  // every block has taken its last tile
      counters[1] = 0u;
    }
  }
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

template <int W>
int launch_count(const uint8_t* bases, long long n, long long own_lo, long long own_hi, int k,
                 int ntiles, uint32_t* ky, uint8_t* mk, int* cnt, unsigned* counters,
                 unsigned long long* status, unsigned long long epoch, cudaStream_t st) {
  const int smem = (int)sizeof(CountBuf<W>);
  cudaError_t err = cudaFuncSetAttribute(count_windows_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_windows_kernel<W>,
                                                        kCountThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = max(1, min(ntiles, sms * per_sm));
  count_windows_kernel<W><<<blocks, kCountThreads, smem, st>>>(
      bases, n, own_lo, own_hi, k, ntiles, ky, mk, cnt, counters, status, epoch);
  return (int)cudaGetLastError();
}

// out: threads a block, registers a thread, blocks resident an SM, local
// (spilled) bytes a thread, dynamic shared bytes a block, windows a tile, SMs
template <int W>
int count_info(int* out) {
  const int smem = (int)sizeof(CountBuf<W>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(count_windows_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, count_windows_kernel<W>);
  int blocks = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, count_windows_kernel<W>,
                                                        kCountThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  out[0] = kCountThreads;
  out[1] = attr.numRegs;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  out[4] = smem;
  out[5] = kCountTile;
  out[6] = sms;
  return (int)cudaSuccess;
}

}  // namespace

// bases: n bytes (a piece: reads joined by k 'N's), 16-byte aligned; the
// owned windows [own_lo, own_hi); keys: [rows][w] words out, masks: rows
// bytes out (in << 4 | out), both 16-byte aligned, with room for the owned
// windows; count: one int out (the valid windows, rows written in stream
// order); scratch: 16-byte aligned, two uint32 counters (zero at rest) in its
// first 8 bytes, then from byte 16 one status word (uint64) a tile for
// `tiles` tiles of 4,096 windows; epoch: 1 .. 2^22 - 1, not used by an
// earlier launch on words still holding it.
extern "C" int ctk_count_windows(const void* bases, long long n, long long own_lo,
                                 long long own_hi, int w, int k, void* keys, void* masks,
                                 void* count, void* scratch, int tiles, unsigned epoch,
                                 cudaStream_t st) {
  const long long ntiles = (n + kCountTile - 1) / kCountTile;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (n <= 0 || n >= (1ll << 31) || own_lo < 0 || own_lo > own_hi || own_hi > n || k < 1 ||
      k > 63 || w != (k + 15) / 16 || tiles < ntiles || epoch == 0u || epoch >= (1u << 22) ||
      !aligned(bases) || !aligned(keys) || !aligned(masks) || !aligned(scratch))
    return (int)cudaErrorInvalidValue;
  const uint8_t* b = static_cast<const uint8_t*>(bases);
  uint32_t* ky = static_cast<uint32_t*>(keys);
  uint8_t* mk = static_cast<uint8_t*>(masks);
  int* cnt = static_cast<int*>(count);
  unsigned* counters = static_cast<unsigned*>(scratch);
  unsigned long long* status = static_cast<unsigned long long*>(scratch) + 2;
  const int nt = (int)ntiles;
  switch (w) {
    case 1: return launch_count<1>(b, n, own_lo, own_hi, k, nt, ky, mk, cnt, counters, status, epoch, st);
    case 2: return launch_count<2>(b, n, own_lo, own_hi, k, nt, ky, mk, cnt, counters, status, epoch, st);
    case 3: return launch_count<3>(b, n, own_lo, own_hi, k, nt, ky, mk, cnt, counters, status, epoch, st);
    default: return launch_count<4>(b, n, own_lo, own_hi, k, nt, ky, mk, cnt, counters, status, epoch, st);
  }
}

// How a ctk_count_windows launch at w words a key runs on the current card
// (count_info's seven fields).
extern "C" int ctk_count_windows_info(int w, int* out) {
  switch (w) {
    case 1: return count_info<1>(out);
    case 2: return count_info<2>(out);
    case 3: return count_info<3>(out);
    case 4: return count_info<4>(out);
    default: return (int)cudaErrorInvalidValue;
  }
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
