// Jump-table build and walk (Partition's device walk).
//
// Replaces the XLA device code of corticall_tpu/ops/cuckoo.py:
//   ctk_jump_stage0  <- _jump_stage0 (line 757), one thread a k-mer writing
//                       both orientations' rows 2*i and 2*i + 1 at once;
//   ctk_jump_compose <- _jump_compose (line 805), one pointer-doubling pass,
//                       on packed rows, so _jump_pack_rows (line 831) is
//                       fused into every pass;
//   ctk_jump_walk    <- _jump_seed_rows / lookup_payload_tag_flat (lines
//                       960, 974) fused into _jump_walk / _jump_step_fn /
//                       _jump_init (lines 1016-1113).
// Plain PyTorch twins: corticall_tpu_torch/ops/jump.py.  Words are uint32
// bit patterns; k-mers are W = ceil(k/16) <= 4 right-aligned words (k <= 63),
// so every kernel is instantiated for W = 1..4 and holds its k-mer in
// registers.  A wide row is a uint4 (hi, lo, next_row, meta): the run's bases
// linearly packed big-endian in (hi, lo), the landing row or kEnd, and meta =
// length (bits 0-5) | junction (29) | flag (30) | cycle (31).  Buckets are
// [NB][2][W+1] words: two entries of (key words..., tag), tag bit 31 set when
// occupied, low bits the record id.
//
// Narrow rows.  After stage 0 and compose pass p a run holds at most 2^p
// bases, and a row with a live pointer holds exactly 2^p, with no junction and
// no cycle (the invariant of cuckoo.py::_jump_compose: next_row != END <=>
// the run is full and continuing).  So up to pass 4 (16 bases, 32 bits) a row
// fits a uint2 (bases, link): bases as a wide row's hi, link = flag << 31 |
// next_row for a live row (its length implied by the pass), else flag << 31
// | kEnded | cycle << 6 | junction << 5 | length.  Row ids stay below kEnded
// (the entry points refuse larger tables, which no 80 GB card holds anyway).
// Stage 0 and passes 1-4 write narrow rows, pass 5 the wide table: a build
// streams 8 bytes a row where it streamed 16, and gathers from a table half
// the size (ops/jump.py: narrow_rows / widen_rows are the plain encode and
// decode).
//
// What bounds them on this card, and what the design does about it:
// - stage0: one thread a k-mer.  Its words, edge byte and flag are loaded
//   once, the reverse complement computed once, and both orientations'
//   landing lookups issued back to back, only for an orientation with exactly
//   one successor (the others' lookups decide nothing).  A lookup reads the
//   primary bucket with the widest aligned vector loads (16 bytes at W = 1, 3,
//   8 bytes at W = 2, 4) and the second bucket only when the key is not in
//   the first: the placement (ops/placement.place) stores each of a graph's
//   unique canonical keys in exactly one slot, so the twin's maximum over the
//   matches of both buckets is the one match, wherever it is found, and most
//   keys sit in their primary bucket at the 0.5 load factor.  The two narrow
//   rows of a k-mer are one 16-byte store.  Bound by the random
//   bucket reads (one 32-byte sector each, latency hidden by the threads in
//   flight);
// - compose: one thread a row, one dependent random read a live row (8 bytes
//   narrow, 16 wide; a 32-byte sector either way); ping-pong buffers, no
//   atomics.  A narrow table of up to ~6M rows fits the 50 MB L2 whole.
//   Streaming cache hints on the row's own slot measured no faster
//   (tools/jump_probe.py) and are not used;
// - walk: one thread per lane, the whole lane state in registers; each jump
//   is one 16-byte read whose address is the previous read's next_row, so a
//   lane is a chain of dependent random loads.  The design lever is many
//   lanes in flight per SM: 128-thread blocks and few registers, so that up
//   to 2048 lanes a SM (about 270k on the card) wait on their loads at once.
//   Every jump slot is written, lane-major, a DRAM sector at a time (see
//   jump_walk_kernel).  Its seed lookup is stage 0's.

#include "kmer.cuh"

namespace {

constexpr uint32_t kEnd = 0xFFFFFFFFu;
constexpr uint32_t kEnded = 0x7FFFFF80u;  // a narrow row's link: the run ended

// one bucket's 2 * (W + 1) words with the widest aligned vector loads: a
// bucket is 8 (W + 1) bytes, so 16-byte loads at W = 1, 3 and 8-byte loads at
// W = 2, 4 (the wrapper checks that the array is 16-byte aligned)
template <int W>
__device__ __forceinline__ void load_bucket(const uint32_t* __restrict__ buckets,
                                            uint32_t b,
                                            uint32_t (&ent)[2 * (W + 1)]) {
  constexpr int kWords = 2 * (W + 1);
  const uint32_t* p = buckets + (size_t)b * kWords;
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kWords / 4; ++j) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + j);
      ent[4 * j] = x.x;
      ent[4 * j + 1] = x.y;
      ent[4 * j + 2] = x.z;
      ent[4 * j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kWords / 2; ++j) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p) + j);
      ent[2 * j] = x.x;
      ent[2 * j + 1] = x.y;
    }
  }
}

// the record id of `key` in a loaded bucket, or false
template <int W>
__device__ __forceinline__ bool match_bucket(const uint32_t (&ent)[2 * (W + 1)],
                                             const uint32_t (&key)[W],
                                             uint32_t& payload) {
  bool found = false;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const uint32_t tag = ent[e * (W + 1) + W];
    bool match = tag >= kTag;
#pragma unroll
    for (int j = 0; j < W; ++j) match = match && ent[e * (W + 1) + j] == key[j];
    if (match) {
      found = true;
      payload = tag & 0x7FFFFFFFu;
    }
  }
  return found;
}

// two-choice lookups of `count` canonical keys, issued together: every
// wanted key's primary bucket, then the second bucket of the keys that the
// first does not hold (each key sits in one slot: see the note above)
template <int W, int kCount>
__device__ __forceinline__ void lookup(const uint32_t* __restrict__ buckets,
                                       uint32_t nb_mask,
                                       const uint32_t (&key)[kCount][W],
                                       const bool (&want)[kCount],
                                       uint32_t (&payload)[kCount],
                                       bool (&present)[kCount]) {
  uint32_t h[kCount], ent[kCount][2 * (W + 1)];
#pragma unroll
  for (int c = 0; c < kCount; ++c) {
    h[c] = hash_words<W>(key[c]);
    payload[c] = 0u;
    if (want[c]) load_bucket<W>(buckets, h[c] & nb_mask, ent[c]);
  }
#pragma unroll
  for (int c = 0; c < kCount; ++c)
    present[c] = want[c] && match_bucket<W>(ent[c], key[c], payload[c]);
#pragma unroll
  for (int c = 0; c < kCount; ++c) {
    if (want[c] && !present[c]) {
      load_bucket<W>(buckets, mix32(h[c] ^ kGolden) & nb_mask, ent[c]);
      present[c] = match_bucket<W>(ent[c], key[c], payload[c]);
    }
  }
}

// (hi, lo) >> s for the 64-bit value in two halves, s in [0, 64)
__device__ __forceinline__ void pair_shr(uint32_t hi, uint32_t lo, uint32_t s,
                                         uint32_t& ohi, uint32_t& olo) {
  if (s >= 32) {
    ohi = 0u;
    olo = hi >> (s - 32);
  } else if (s == 0) {
    ohi = hi;
    olo = lo;
  } else {
    ohi = hi >> s;
    olo = (lo >> s) | (hi << (32 - s));
  }
}

// a narrow row from a row's (hi, next_row, meta), lo = 0 and length <= 16
__device__ __forceinline__ uint2 narrow_row(uint32_t hi, uint32_t ptr, uint32_t meta) {
  const uint32_t link = ptr != kEnd ? ptr
                                    : kEnded | ((meta >> 31) << 6) |
                                          (((meta >> 29) & 1u) << 5) | (meta & 0x3Fu);
  return make_uint2(hi, (((meta >> 30) & 1u) << 31) | link);
}

// row i of a narrow table as (hi, lo, next_row, meta); live runs hold live_len bases
__device__ __forceinline__ uint4 narrow_at(const uint2* __restrict__ rows, uint32_t i,
                                           uint32_t live_len) {
  const uint2 r = __ldg(rows + i);
  const uint32_t flag = (r.y >> 31) << 30;
  if ((r.y & kEnded) == kEnded)
    return make_uint4(r.x, 0u, kEnd, (r.y & 0x1Fu) | (((r.y >> 5) & 1u) << 29) | flag |
                                         (((r.y >> 6) & 1u) << 31));
  return make_uint4(r.x, 0u, r.y & 0x7FFFFFFFu, live_len | flag);
}

template <int W>
__global__ void __launch_bounds__(256)
jump_stage0_kernel(const uint32_t* __restrict__ kmers,
                   const uint8_t* __restrict__ edges,
                   const uint8_t* __restrict__ flags,
                   const uint32_t* __restrict__ buckets, uint32_t nb_mask,
                   int n, int k, uint4* __restrict__ rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t cur[2][W];
#pragma unroll
  for (int j = 0; j < W; ++j) cur[0][j] = kmers[(size_t)i * W + j];
  revcomp<W>(cur[0], cur[1], k);
  const uint32_t e = edges[i];
  const uint32_t fl = flags[i] ? 1u : 0u;
  uint32_t base[2], canon[2][W];
  bool flip[2], single[2], junction[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const uint32_t mask = d ? (e >> 4) : (e & 0xFu);
    const int nm = __popc(mask);
    single[d] = nm == 1;
    junction[d] = nm >= 2;
    base[d] = lowest_set_base(mask);
    uint32_t nxt[W];
    shift_append<W>(cur[d], base[d], k, nxt);
    flip[d] = canonicalize<W>(nxt, canon[d], k);
  }
  uint32_t pay[2];
  bool present[2];
  lookup<W, 2>(buckets, nb_mask, canon, single, pay, present);
  uint2 row[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const uint32_t dest = 2u * pay[d] + (flip[d] ? 1u : 0u);
    const bool self_loop = present[d] && dest == 2u * (uint32_t)i + d;
    const bool run = single[d] && !self_loop;
    const uint32_t meta = (run ? 1u : 0u) | ((junction[d] ? 1u : 0u) << 29) | (fl << 30) |
                          ((self_loop ? 1u : 0u) << 31);
    row[d] = narrow_row(run ? base[d] << 30 : 0u, run && present[d] ? dest : kEnd, meta);
  }
  rows[i] = make_uint4(row[0].x, row[0].y, row[1].x, row[1].y);
}

// one doubling pass from narrow rows whose live runs hold live_len bases;
// narrow rows out while runs fit 16 bases, then the wide table
template <bool kOutWide>
__global__ void __launch_bounds__(256)
jump_compose_kernel(const uint2* __restrict__ in, void* __restrict__ out, int n2,
                    uint32_t live_len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const uint4 r = narrow_at(in, (uint32_t)i, live_len);
  uint32_t hi = r.x, lo = r.y, ptr = r.z;
  uint32_t len = r.w & 0x3Fu;
  uint32_t endj = (r.w >> 29) & 1u, flag = (r.w >> 30) & 1u, cyc = r.w >> 31;
  if (ptr != kEnd) {
    // a full run with a live pointer appends its destination's run
    const uint4 b = narrow_at(in, ptr, live_len);
    uint32_t shi, slo;
    pair_shr(b.x, b.y, 2u * len, shi, slo);
    hi |= shi;
    lo |= slo;
    len += b.w & 0x3Fu;
    flag |= (b.w >> 30) & 1u;
    endj = (b.w >> 29) & 1u;  // the stop cause is the destination's
    // a cycle closed inside the composed run: the chain came back here
    cyc = (b.w >> 31) | (b.z == (uint32_t)i ? 1u : 0u);
    ptr = b.z;
  }
  if (cyc) ptr = kEnd;
  const uint32_t meta = len | (endj << 29) | (flag << 30) | (cyc << 31);
  if constexpr (kOutWide)
    static_cast<uint4*>(out)[i] = make_uint4(hi, lo, ptr, meta);
  else
    static_cast<uint2*>(out)[i] = narrow_row(hi, ptr, meta);
}

// A walking lane's state (cuckoo.py::_jump_init / _jump_step_fn's carry).
struct Lane {
  int row, emitcnt, saved, power, lam;
  bool active, cycled, touched, endj;
};

// One jump of a lane (_jump_step_fn): the bases it emits, (0, 0) when it
// emits none, and the lane's state advanced.  An inactive lane's state never
// changes again, so it reads nothing.
__device__ __forceinline__ uint2 jump_step(const uint4* __restrict__ rows,
                                           int num_steps, Lane& s) {
  if (!s.active) return make_uint2(0u, 0u);
  const uint4 r = __ldg(rows + s.row);
  const uint32_t meta = r.w;
  const int run_len = (int)(meta & 0x3Fu);
  const bool run_cyc = (meta >> 31) != 0u;
  s.touched = s.touched || ((meta >> 30) & 1u);
  s.endj = (meta >> 29) & 1u;

  const int m = min(run_len, num_steps - s.emitcnt);
  const bool emit = m > 0;
  const int mm = emit ? m : 0;
  const int nxt = (int)r.z;
  const bool has_next = emit && m == run_len && r.z != kEnd && !run_cyc;
  const bool is_cycle = has_next && nxt == s.saved;
  const bool ends_cycle = (emit && run_cyc && m == run_len) || (run_cyc && run_len == 0);
  const bool advance = has_next && !is_cycle && s.emitcnt + mm < num_steps;

  uint2 out = make_uint2(0u, 0u);
  if (emit) {
    // keep the first mm bases (the cap may clamp the final jump)
    const uint32_t keep = 2u * (uint32_t)mm;  // (0, 64]
    const uint32_t hi_mask = keep >= 32u ? 0xFFFFFFFFu : 0xFFFFFFFFu << (32u - keep);
    const uint32_t lo_keep = keep > 32u ? keep - 32u : 0u;
    const uint32_t lo_mask = lo_keep >= 32u ? 0xFFFFFFFFu
                             : lo_keep ? 0xFFFFFFFFu << (32u - lo_keep) : 0u;
    out = make_uint2(r.x & hi_mask, r.y & lo_mask);
  }
  if (advance && s.power == s.lam) {  // Brent: move the anchor
    s.saved = nxt;
    s.power *= 2;
    s.lam = 0;
  }
  if (advance) {
    s.lam += 1;
    s.row = nxt;
  }
  s.emitcnt += mm;
  s.cycled = s.cycled || is_cycle || ends_cycle;
  s.active = advance;
  return out;
}

// One thread a lane.  The lane writes every one of its jump slots, zeros
// after it stops, into its own row of the output: lane-major, so the [B, 2T]
// contract needs no zero fill and no transposing copy.  A row holds `pitch`
// slots, a multiple of four (32 bytes, one DRAM sector), of which the first
// `iters` are the contract's [B, 2T] (a strided view; the rest are zeros).  A
// lane keeps four jumps (one sector) in registers; the warp stages its 32
// sectors in shared memory and stores them as two instructions of 16 full
// sectors, two lanes a sector, so that every sector is written whole by one
// instruction (the lanes' rows are `pitch` slots apart, so a sector a lane is
// as coalesced as lane-major rows allow).  Steps and the three flags go to
// one byte buffer: int32 steps [B], then cycled, touched and ends-junction
// bytes [3][B].
template <int W>
__global__ void __launch_bounds__(128)
jump_walk_kernel(const uint4* __restrict__ rows,
                 const uint32_t* __restrict__ buckets, uint32_t nb_mask, int k,
                 const uint32_t* __restrict__ seeds, int batch, int num_steps,
                 int iters, int pitch, uint2* __restrict__ out,
                 uint8_t* __restrict__ lanes) {
  __shared__ uint4 stage[128][2];  // each thread's four jumps
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int wl = threadIdx.x & 31;
  const int warp0 = threadIdx.x - wl;  // the warp's first thread in the block
  // a lane past the batch walks nothing and stores nothing, but stays in its
  // warp's staging
  int row = -1;
  if (lane < batch) {
    uint32_t v[W], canon[1][W];
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = seeds[(size_t)lane * W + j];
    const bool flipped = canonicalize<W>(v, canon[0], k);
    const bool want[1] = {true};
    uint32_t pay[1];
    bool present[1];
    lookup<W, 1>(buckets, nb_mask, canon, want, pay, present);
    row = present[0] ? (int)(2u * pay[0] + (flipped ? 1u : 0u)) : -1;
  }

  Lane s = {row, 0, row, 1, 0, row >= 0, false, false, false};
  for (int t = 0; t < pitch; t += 4) {
    uint2 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s.active = s.active && t + u < iters;
      x[u] = jump_step(rows, num_steps, s);
    }
    __syncwarp();  // the warp's reads of the previous group are done
    stage[threadIdx.x][0] = make_uint4(x[0].x, x[0].y, x[1].x, x[1].y);
    stage[threadIdx.x][1] = make_uint4(x[2].x, x[2].y, x[3].x, x[3].y);
    __syncwarp();
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int src = part * 16 + (wl >> 1);  // the warp lane whose sector this lane halves
      const int dst = lane - wl + src;
      if (dst < batch)
        reinterpret_cast<uint4*>(out + (size_t)dst * pitch + t)[wl & 1] =
            stage[warp0 + src][wl & 1];
    }
  }
  if (lane < batch) {
    reinterpret_cast<int*>(lanes)[lane] = s.emitcnt;
    lanes[4 * (size_t)batch + lane] = s.cycled;
    lanes[5 * (size_t)batch + lane] = s.touched;
    lanes[6 * (size_t)batch + lane] = s.endj;
  }
}

}  // namespace

// rows: 2n narrow rows (uint2), 16-byte aligned; buckets 16-byte aligned
extern "C" int ctk_jump_stage0(const void* kmers, const void* edges,
                               const void* flags, const void* buckets, int nb,
                               int n, int w, int k, void* rows,
                               cudaStream_t stream) {
  if (!pow2(nb) || n <= 0 || 2LL * n > (long long)kEnded || k < 1 || k > 63 ||
      w != (k + 15) / 16)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const uint32_t* km = static_cast<const uint32_t*>(kmers);
  const uint8_t* ed = static_cast<const uint8_t*>(edges);
  const uint8_t* fl = static_cast<const uint8_t*>(flags);
  const uint32_t* bk = static_cast<const uint32_t*>(buckets);
  uint4* out = static_cast<uint4*>(rows);
  const uint32_t mask = (uint32_t)nb - 1u;
  switch (w) {
    case 1: jump_stage0_kernel<1><<<blocks, threads, 0, stream>>>(km, ed, fl, bk, mask, n, k, out); break;
    case 2: jump_stage0_kernel<2><<<blocks, threads, 0, stream>>>(km, ed, fl, bk, mask, n, k, out); break;
    case 3: jump_stage0_kernel<3><<<blocks, threads, 0, stream>>>(km, ed, fl, bk, mask, n, k, out); break;
    default: jump_stage0_kernel<4><<<blocks, threads, 0, stream>>>(km, ed, fl, bk, mask, n, k, out); break;
  }
  return (int)cudaGetLastError();
}

// in: narrow rows after stage in_stage (0 = stage 0, p = pass p); out: the
// narrow rows of stage in_stage + 1 (in_stage < 4) or the wide table
extern "C" int ctk_jump_compose(const void* in, void* out, int n2, int in_stage,
                                int out_wide, cudaStream_t stream) {
  if (n2 <= 0 || (long long)n2 > (long long)kEnded || in_stage < 0 || in_stage > 4 ||
      (!out_wide && in_stage == 4))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n2 + threads - 1) / threads);
  const uint2* src = static_cast<const uint2*>(in);
  const uint32_t live_len = 1u << in_stage;
  if (out_wide)
    jump_compose_kernel<true><<<blocks, threads, 0, stream>>>(src, out, n2, live_len);
  else
    jump_compose_kernel<false><<<blocks, threads, 0, stream>>>(src, out, n2, live_len);
  return (int)cudaGetLastError();
}

// out: [batch][pitch] jump slots (uint2), pitch a multiple of 4 and at
// least iters, 32-byte aligned; lanes: int32 steps [batch] then cycled,
// touched, ends-junction bytes [3][batch]
extern "C" int ctk_jump_walk(const void* rows, const void* buckets, int nb,
                             int w, int k, const void* seeds, int batch,
                             int num_steps, int iters, int pitch, void* out,
                             void* lanes, cudaStream_t stream) {
  if (!pow2(nb) || batch <= 0 || num_steps < 0 || iters <= 0 || k < 1 ||
      k > 63 || w != (k + 15) / 16 || pitch < iters || pitch % 4 ||
      reinterpret_cast<uintptr_t>(out) % 32)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((batch + threads - 1) / threads);
  const uint4* rw = static_cast<const uint4*>(rows);
  const uint32_t* bk = static_cast<const uint32_t*>(buckets);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  uint2* o = static_cast<uint2*>(out);
  uint8_t* ln = static_cast<uint8_t*>(lanes);
  const uint32_t mask = (uint32_t)nb - 1u;
  switch (w) {
    case 1: jump_walk_kernel<1><<<blocks, threads, 0, stream>>>(rw, bk, mask, k, sd, batch, num_steps, iters, pitch, o, ln); break;
    case 2: jump_walk_kernel<2><<<blocks, threads, 0, stream>>>(rw, bk, mask, k, sd, batch, num_steps, iters, pitch, o, ln); break;
    case 3: jump_walk_kernel<3><<<blocks, threads, 0, stream>>>(rw, bk, mask, k, sd, batch, num_steps, iters, pitch, o, ln); break;
    default: jump_walk_kernel<4><<<blocks, threads, 0, stream>>>(rw, bk, mask, k, sd, batch, num_steps, iters, pitch, o, ln); break;
  }
  return (int)cudaGetLastError();
}

// The walk's [B, 2T] jump slots from the card's padded rows into host
// memory (pinned, for an asynchronous copy): one pitched 2-D copy of `rows`
// rows of `width` bytes on `stream`.
extern "C" int ctk_copy_rows_to_host(void* dst, int dst_pitch, const void* src, int src_pitch,
                                     int width, int rows, cudaStream_t stream) {
  if (rows <= 0) return 0;
  return (int)cudaMemcpy2DAsync(dst, (size_t)dst_pitch, src, (size_t)src_pitch, (size_t)width,
                                (size_t)rows, cudaMemcpyDeviceToHost, stream);
}
