// DeviceGraph's hash-table lookup and the speculative single-step walk.
//
// Replaces the XLA device code of
//   ctk_ht_lookup <- corticall_tpu/ops/hashtable.py::lookup (line 131): an
//                    open-addressing linear probe, one thread a query;
//   ctk_spec_walk <- corticall_tpu/ops/cuckoo.py::walk_forward_spec (line
//                    306) with _spec_step_fn / _spec_init (lines 256, 298):
//                    one thread a lane, the whole lane state in registers.
// Plain PyTorch twins: corticall_tpu_torch/ops/hashtable.py::lookup_plain and
// ops/cuckoo.py::spec_walk_plain.
//
// ht_lookup: slot s holds a record id or -1 (empty); a query probes from
// hash & (M - 1) for at most max_probe slots and stops at its key (the record
// id) or at an empty slot (a miss, -1).  The JAX package's loop ends early
// only when every lane has resolved; each lane's answer is its own, so one
// thread a lane that stops at its own resolution gives the same bits.  Bound
// by the dependent random reads (a slot, then the record's key words).
//
// spec_walk: buckets [NB][BS][W+1] words, an entry (key words..., tag), tag =
// 0x80000000 | edge byte.  An iteration canonicalizes the lane's k-mer,
// hashes it and reads ONE bucket: the primary, or the second on the
// iteration after a miss there (a stall, which emits -1).  The entry's edge
// nibble gives the next base; Brent's anchor detects cycles; emission stops at
// num_steps.  A lane that goes inactive never comes back, so it fills -1 to
// the end and stops reading.  Each iteration writes one byte a lane to row t
// of the [T][B] output (a warp writes 32 contiguous bytes).  Bound by the
// chain of dependent random bucket reads (one or two 32-byte sectors a row);
// the design lever is lanes in flight: 128-thread blocks, few registers.

#include "kmer.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(256)
ht_lookup_kernel(const int* __restrict__ slots, uint32_t mask, const uint32_t* __restrict__ keys,
                 const uint32_t* __restrict__ queries, int batch, int max_probe,
                 int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  uint32_t q[W];
#pragma unroll
  for (int j = 0; j < W; ++j) q[j] = queries[(size_t)i * W + j];
  const uint32_t h = hash_words<W>(q) & mask;
  int found = -1;
  for (int p = 0; p < max_probe; ++p) {
    const int idx = __ldg(slots + ((h + (uint32_t)p) & mask));
    if (idx < 0) break;  // an empty slot: a miss
    bool eq = true;
#pragma unroll
    for (int j = 0; j < W; ++j) eq = eq && __ldg(keys + (size_t)idx * W + j) == q[j];
    if (eq) {
      found = idx;
      break;
    }
  }
  out[i] = found;
}

template <int W>
__global__ void __launch_bounds__(128)
spec_walk_kernel(const uint32_t* __restrict__ buckets, uint32_t nb_mask, int bs, int k,
                 const uint32_t* __restrict__ seeds, int batch, int num_steps, int iters,
                 int8_t* __restrict__ bases, uint8_t* __restrict__ cycled_out,
                 int* __restrict__ steps_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  uint32_t cur[W], saved[W];
#pragma unroll
  for (int j = 0; j < W; ++j) saved[j] = cur[j] = seeds[(size_t)lane * W + j];
  int power = 1, lam = 0, emitcnt = 0;
  bool probe = false, active = true, cycled = false;
  const int entry = W + 1;
  int t = 0;
  for (; t < iters && active; ++t) {
    uint32_t canon[W];
    const bool flipped = canonicalize<W>(cur, canon, k);
    const uint32_t h = hash_words<W>(canon);
    const uint32_t* row = buckets + (size_t)((probe ? mix32(h ^ kGolden) : h) & nb_mask) * bs * entry;
    bool found = false;
    uint32_t e = 0u;
    for (int s = 0; s < bs; ++s) {
      const uint32_t tag = __ldg(row + s * entry + W);
      bool match = tag >= kTag;
#pragma unroll
      for (int j = 0; j < W; ++j) match = match && __ldg(row + s * entry + j) == canon[j];
      if (match) {
        found = true;
        e = max(e, tag & 0x7FFFFFFFu);
      }
    }
    const uint32_t next_mask = (flipped ? e >> 4 : e) & 0xFu;
    const uint32_t base = lowest_set_base(next_mask);
    uint32_t nxt[W];
    shift_append<W>(cur, base, k, nxt);
    const bool single = found && __popc(next_mask) == 1;
    bool at_anchor = true;
#pragma unroll
    for (int j = 0; j < W; ++j) at_anchor = at_anchor && nxt[j] == saved[j];
    const bool is_cycle = at_anchor && single;
    const bool advance = single && !is_cycle && emitcnt < num_steps;
    const bool stall = !found && !probe;
    bases[(size_t)t * batch + lane] = advance ? (int8_t)base : (int8_t)-1;
    if (advance) {
      if (power == lam) {  // Brent: move the anchor
#pragma unroll
        for (int j = 0; j < W; ++j) saved[j] = nxt[j];
        power *= 2;
        lam = 0;
      }
      lam += 1;
#pragma unroll
      for (int j = 0; j < W; ++j) cur[j] = nxt[j];
      emitcnt += 1;
    }
    cycled = cycled || is_cycle;
    probe = stall;
    active = advance || stall;
  }
  for (; t < iters; ++t) bases[(size_t)t * batch + lane] = -1;
  steps_out[lane] = emitcnt;
  cycled_out[lane] = cycled;
}

}  // namespace

// slots: m ints (m a power of two); keys: [n][w] words; queries: [batch][w]
// words; out: batch record ids (-1: a miss)
extern "C" int ctk_ht_lookup(const void* slots, int m, const void* keys, int w,
                             const void* queries, int batch, int max_probe, void* out,
                             cudaStream_t stream) {
  if (!pow2(m) || batch <= 0 || max_probe < 0 || w < 1 || w > 4)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((batch + 255) / 256);
  const int* sl = static_cast<const int*>(slots);
  const uint32_t* ky = static_cast<const uint32_t*>(keys);
  const uint32_t* qs = static_cast<const uint32_t*>(queries);
  int* o = static_cast<int*>(out);
  const uint32_t mask = (uint32_t)m - 1u;
  switch (w) {
    case 1: ht_lookup_kernel<1><<<blocks, 256, 0, stream>>>(sl, mask, ky, qs, batch, max_probe, o); break;
    case 2: ht_lookup_kernel<2><<<blocks, 256, 0, stream>>>(sl, mask, ky, qs, batch, max_probe, o); break;
    case 3: ht_lookup_kernel<3><<<blocks, 256, 0, stream>>>(sl, mask, ky, qs, batch, max_probe, o); break;
    default: ht_lookup_kernel<4><<<blocks, 256, 0, stream>>>(sl, mask, ky, qs, batch, max_probe, o); break;
  }
  return (int)cudaGetLastError();
}

// buckets: [nb][bs][w + 1] words; seeds: [batch][w] words; bases: [iters][batch]
// bytes out; cycled: batch bytes out; steps: batch ints out
extern "C" int ctk_spec_walk(const void* buckets, int nb, int bs, int w, int k, const void* seeds,
                             int batch, int num_steps, int iters, void* bases, void* cycled,
                             void* steps, cudaStream_t stream) {
  if (!pow2(nb) || bs < 1 || batch <= 0 || num_steps < 0 || iters < 0 || k < 1 || k > 63 ||
      w != (k + 15) / 16)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((batch + 127) / 128);
  const uint32_t* bk = static_cast<const uint32_t*>(buckets);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  int8_t* ob = static_cast<int8_t*>(bases);
  uint8_t* oc = static_cast<uint8_t*>(cycled);
  int* os = static_cast<int*>(steps);
  const uint32_t mask = (uint32_t)nb - 1u;
  switch (w) {
    case 1: spec_walk_kernel<1><<<blocks, 128, 0, stream>>>(bk, mask, bs, k, sd, batch, num_steps, iters, ob, oc, os); break;
    case 2: spec_walk_kernel<2><<<blocks, 128, 0, stream>>>(bk, mask, bs, k, sd, batch, num_steps, iters, ob, oc, os); break;
    case 3: spec_walk_kernel<3><<<blocks, 128, 0, stream>>>(bk, mask, bs, k, sd, batch, num_steps, iters, ob, oc, os); break;
    default: spec_walk_kernel<4><<<blocks, 128, 0, stream>>>(bk, mask, bs, k, sd, batch, num_steps, iters, ob, oc, os); break;
  }
  return (int)cudaGetLastError();
}
