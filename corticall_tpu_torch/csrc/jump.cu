// Jump-table build and walk (Partition's device walk).
//
// Replaces the XLA device code of corticall_tpu/ops/cuckoo.py:
//   ctk_jump_stage0  <- _jump_stage0 (line 757), both orientations at once,
//                       writing the interleaved row 2*i + d directly;
//   ctk_jump_compose <- _jump_compose (line 805), one pointer-doubling pass,
//                       on packed rows, so _jump_pack_rows (line 831) is
//                       fused into every pass;
//   ctk_jump_walk    <- _jump_seed_rows / lookup_payload_tag_flat (lines
//                       960, 974) fused into _jump_walk / _jump_step_fn /
//                       _jump_init (lines 1016-1113).
// Plain PyTorch twins: corticall_tpu_torch/ops/jump.py.  Words are uint32
// bit patterns; k-mers are W = ceil(k/16) <= 4 right-aligned words (k <= 63),
// so every kernel is instantiated for W = 1..4 and holds its k-mer in
// registers.  A row is a uint4 (hi, lo, next_row, meta): the run's bases
// linearly packed big-endian in (hi, lo), the landing row or kEnd, and meta =
// length (bits 0-5) | junction (29) | flag (30) | cycle (31).  Buckets are
// [NB][2][W+1] words: two entries of (key words..., tag), tag bit 31 set when
// occupied, low bits the record id.
//
// What bounds them on this card:
// - stage0: one thread per (k-mer, orientation) row; a hash and two random
//   bucket reads per row, so it is bound by the latency of those reads;
// - compose: one thread per row, one dependent random 16-byte read per live
//   row, five passes over 2N rows; ping-pong buffers, no atomics;
// - walk: one thread per lane, the whole lane state in registers; each jump
//   is one 16-byte read whose address is the previous read's next_row, so a
//   lane is a chain of dependent random loads.  The design lever is many
//   lanes in flight per SM: 128-thread blocks and few registers, so that up
//   to 2048 lanes a SM (about 270k on the card) wait on their loads at once;
//   a lane that stops leaves the loop, and the zero-filled output needs no
//   stores for the jumps it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kEnd = 0xFFFFFFFFu;
constexpr uint32_t kTag = 0x80000000u;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

template <int W>
__device__ __forceinline__ uint32_t hash_words(const uint32_t (&v)[W]) {
  uint32_t h = 0x811C9DC5u;
#pragma unroll
  for (int i = 0; i < W; ++i) h = mix32(h ^ v[i]) * 0x01000193u;
  return mix32(h);
}

__device__ __forceinline__ uint32_t reverse_pairs(uint32_t x) {
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  return (x << 16) | (x >> 16);
}

template <int W>
__device__ __forceinline__ uint32_t top_mask(int k) {
  const int used = 2 * k - 32 * (W - 1);
  return used >= 32 ? 0xFFFFFFFFu : ((1u << used) - 1u);
}

template <int W>
__device__ __forceinline__ void revcomp(const uint32_t (&in)[W],
                                        uint32_t (&out)[W], int k) {
  uint32_t rev[W];
#pragma unroll
  for (int j = 0; j < W; ++j) rev[j] = reverse_pairs(~in[W - 1 - j]);
  const int s = 32 * W - 2 * k;  // right realignment, in [0, 32)
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint32_t v = rev[j];
    if (s) v = (v >> s) | (j > 0 ? rev[j > 0 ? j - 1 : 0] << (32 - s) : 0u);
    out[j] = v;
  }
  out[0] &= top_mask<W>(k);
}

// canonical orientation of v; returns true when it is the reverse complement
template <int W>
__device__ __forceinline__ bool canonicalize(const uint32_t (&v)[W],
                                             uint32_t (&canon)[W], int k) {
  uint32_t rc[W];
  revcomp<W>(v, rc, k);
  bool less = false, decided = false;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (!decided && rc[i] != v[i]) {
      less = rc[i] < v[i];
      decided = true;
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) canon[i] = less ? rc[i] : v[i];
  return less;
}

template <int W>
__device__ __forceinline__ void shift_append(const uint32_t (&in)[W],
                                             uint32_t base, int k,
                                             uint32_t (&out)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j)
    out[j] = (in[j] << 2) | (j + 1 < W ? in[j + 1 < W ? j + 1 : j] >> 30 : 0u);
  out[W - 1] |= base;
  out[0] &= top_mask<W>(k);
}

// two-choice lookup of a canonical key: record id in `payload`, or false
template <int W>
__device__ __forceinline__ bool lookup(const uint32_t* __restrict__ buckets,
                                       uint32_t nb_mask,
                                       const uint32_t (&key)[W],
                                       uint32_t& payload) {
  const uint32_t h = hash_words<W>(key);
  const uint32_t cand[2] = {h & nb_mask, mix32(h ^ kGolden) & nb_mask};
  bool present = false;
  uint32_t pay = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint32_t* bucket = buckets + (size_t)cand[c] * (2 * (W + 1));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t* ent = bucket + e * (W + 1);
      const uint32_t tag = ent[W];
      bool match = tag >= kTag;
#pragma unroll
      for (int j = 0; j < W; ++j) match = match && ent[j] == key[j];
      if (match) {
        present = true;
        pay = max(pay, tag & 0x7FFFFFFFu);
      }
    }
  }
  payload = pay;
  return present;
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

template <int W>
__global__ void jump_stage0_kernel(const uint32_t* __restrict__ kmers,
                                   const uint8_t* __restrict__ edges,
                                   const uint8_t* __restrict__ flags,
                                   const uint32_t* __restrict__ buckets,
                                   uint32_t nb_mask, int n, int k,
                                   uint4* __restrict__ rows) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2LL * n) return;
  const int i = (int)(t >> 1);
  const int d = (int)(t & 1);
  uint32_t v[W], cur[W];
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = kmers[(size_t)i * W + j];
  if (d) {
    revcomp<W>(v, cur, k);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) cur[j] = v[j];
  }
  const uint32_t e = edges[i];
  const uint32_t mask = d ? (e >> 4) : (e & 0xFu);
  const int nm = __popc(mask);
  // lowest set base; 3 for an empty mask, as kmer_jax.lowest_set_base
  const uint32_t base = (mask & 1u) ? 0u : (mask & 2u) ? 1u : (mask & 4u) ? 2u : 3u;
  uint32_t nxt[W], canon[W];
  shift_append<W>(cur, base, k, nxt);
  const bool fl2 = canonicalize<W>(nxt, canon, k);
  uint32_t pay;
  const bool present = lookup<W>(buckets, nb_mask, canon, pay);
  const uint32_t dest = 2u * pay + (fl2 ? 1u : 0u);
  const bool single = nm == 1;
  const bool self_loop = single && present && dest == (uint32_t)t;
  const uint32_t len = (single && !self_loop) ? 1u : 0u;
  const uint32_t ptr = (single && present && !self_loop) ? dest : kEnd;
  const uint32_t meta = len | ((nm >= 2 ? 1u : 0u) << 29) |
                        ((flags[i] ? 1u : 0u) << 30) |
                        ((self_loop ? 1u : 0u) << 31);
  rows[t] = make_uint4(len ? base << 30 : 0u, 0u, ptr, meta);
}

__global__ void jump_compose_kernel(const uint4* __restrict__ in,
                                    uint4* __restrict__ out, int n2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const uint4 r = in[i];
  uint32_t hi = r.x, lo = r.y, ptr = r.z;
  uint32_t len = r.w & 0x3Fu;
  uint32_t endj = (r.w >> 29) & 1u, flag = (r.w >> 30) & 1u, cyc = r.w >> 31;
  if (ptr != kEnd) {
    // a full run with a live pointer appends its destination's run
    const uint4 b = in[ptr];
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
  out[i] = make_uint4(hi, lo, ptr, len | (endj << 29) | (flag << 30) | (cyc << 31));
}

template <int W>
__global__ void __launch_bounds__(128)
jump_walk_kernel(const uint4* __restrict__ rows,
                 const uint32_t* __restrict__ buckets, uint32_t nb_mask, int k,
                 const uint32_t* __restrict__ seeds, int batch, int num_steps,
                 int iters, uint2* __restrict__ out, int* __restrict__ steps_out,
                 uint8_t* __restrict__ cycled_out,
                 uint8_t* __restrict__ touched_out,
                 uint8_t* __restrict__ endj_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  uint32_t v[W], canon[W];
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = seeds[(size_t)lane * W + j];
  const bool flipped = canonicalize<W>(v, canon, k);
  uint32_t pay;
  const bool present = lookup<W>(buckets, nb_mask, canon, pay);
  int row = present ? (int)(2u * pay + (flipped ? 1u : 0u)) : -1;

  bool active = row >= 0;
  int emitcnt = 0, saved = row, power = 1, lam = 0;
  bool cycled = false, touched = false, endj = false;
  // an inactive lane's state never changes again, so the lane may stop
  for (int t = 0; t < iters && active; ++t) {
    const uint4 r = __ldg(rows + row);
    const uint32_t meta = r.w;
    const int run_len = (int)(meta & 0x3Fu);
    const bool run_cyc = (meta >> 31) != 0u;
    touched = touched || ((meta >> 30) & 1u);
    endj = (meta >> 29) & 1u;

    const int m = min(run_len, num_steps - emitcnt);
    const bool emit = m > 0;
    const int mm = emit ? m : 0;
    const int nxt = (int)r.z;
    const bool has_next = emit && m == run_len && r.z != kEnd && !run_cyc;
    const bool is_cycle = has_next && nxt == saved;
    const bool ends_cycle = (emit && run_cyc && m == run_len) ||
                            (run_cyc && run_len == 0);
    const bool advance = has_next && !is_cycle && emitcnt + mm < num_steps;

    if (emit) {
      // keep the first mm bases (the cap may clamp the final jump)
      const uint32_t keep = 2u * (uint32_t)mm;  // (0, 64]
      const uint32_t hi_mask = keep >= 32u ? 0xFFFFFFFFu : 0xFFFFFFFFu << (32u - keep);
      const uint32_t lo_keep = keep > 32u ? keep - 32u : 0u;
      const uint32_t lo_mask = lo_keep >= 32u ? 0xFFFFFFFFu
                               : lo_keep ? 0xFFFFFFFFu << (32u - lo_keep) : 0u;
      out[(size_t)t * batch + lane] = make_uint2(r.x & hi_mask, r.y & lo_mask);
    }
    if (advance && power == lam) {  // Brent: move the anchor
      saved = nxt;
      power *= 2;
      lam = 0;
    }
    if (advance) {
      lam += 1;
      row = nxt;
    }
    emitcnt += mm;
    cycled = cycled || is_cycle || ends_cycle;
    active = advance;
  }
  steps_out[lane] = emitcnt;
  cycled_out[lane] = cycled;
  touched_out[lane] = touched;
  endj_out[lane] = endj;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

extern "C" int ctk_jump_stage0(const void* kmers, const void* edges,
                               const void* flags, const void* buckets, int nb,
                               int n, int w, int k, void* rows,
                               cudaStream_t stream) {
  if (!pow2(nb) || n <= 0 || k < 1 || k > 63 || w != (k + 15) / 16)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((2LL * n + threads - 1) / threads);
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

extern "C" int ctk_jump_compose(const void* in, void* out, int n2,
                                cudaStream_t stream) {
  if (n2 <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  jump_compose_kernel<<<(n2 + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), n2);
  return (int)cudaGetLastError();
}

extern "C" int ctk_jump_walk(const void* rows, const void* buckets, int nb,
                             int w, int k, const void* seeds, int batch,
                             int num_steps, int iters, void* out, void* steps,
                             void* cycled, void* touched, void* endj,
                             cudaStream_t stream) {
  if (!pow2(nb) || batch <= 0 || num_steps < 0 || iters <= 0 || k < 1 ||
      k > 63 || w != (k + 15) / 16)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((batch + threads - 1) / threads);
  const uint4* rw = static_cast<const uint4*>(rows);
  const uint32_t* bk = static_cast<const uint32_t*>(buckets);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  uint2* o = static_cast<uint2*>(out);
  int* st = static_cast<int*>(steps);
  uint8_t* cy = static_cast<uint8_t*>(cycled);
  uint8_t* tc = static_cast<uint8_t*>(touched);
  uint8_t* ej = static_cast<uint8_t*>(endj);
  const uint32_t mask = (uint32_t)nb - 1u;
  switch (w) {
    case 1: jump_walk_kernel<1><<<blocks, threads, 0, stream>>>(rw, bk, mask, k, sd, batch, num_steps, iters, o, st, cy, tc, ej); break;
    case 2: jump_walk_kernel<2><<<blocks, threads, 0, stream>>>(rw, bk, mask, k, sd, batch, num_steps, iters, o, st, cy, tc, ej); break;
    case 3: jump_walk_kernel<3><<<blocks, threads, 0, stream>>>(rw, bk, mask, k, sd, batch, num_steps, iters, o, st, cy, tc, ej); break;
    default: jump_walk_kernel<4><<<blocks, threads, 0, stream>>>(rw, bk, mask, k, sd, batch, num_steps, iters, o, st, cy, tc, ej); break;
  }
  return (int)cudaGetLastError();
}
