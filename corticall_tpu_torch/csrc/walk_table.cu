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
// ht_lookup: the JAX package's table is slots int32[M] (a record id or -1)
// with the key words in the graph's k-mers; a query probes from hash & (M - 1)
// for at most max_probe slots and stops at its key (the record id) or at an
// empty slot (a miss, -1).  The first form read slots[s] and then, dependent
// on it, the record's key row: ~2-4 dependent random sectors a query.  This
// kernel reads the interleaved probe table built from it once a graph
// (ops/hashtable.probe_table): entry s is (key words of slots[s], slots[s] +
// 1), 0 marking an empty slot, padded to 16 bytes (W <= 3) or 32 (W = 4); or
// the 8-byte tag form (slots[s] + 1, mix32(hash ^ kGolden) of its key) that
// confirms a tag match against the record's key row.  G lanes take a query:
// a round loads G consecutive entries aligned on G (whole sectors), one a
// lane as a vector, masks the lanes before the home slot and at probe index
// >= max_probe, and a ballot finds the first slot in probe order that holds
// the key or is empty; that slot's answer is the query's.  So a query costs
// its rounds' sectors and no second read (key form), and the answer is
// lookup's (not lookup_fused's, which rounds the probe count up).  Bound by
// the card's rate of random sector reads, not by bytes: G trades sectors a
// round for dependent rounds; the tag form trades half the table for a
// confirming read a hit (chip_smoke.py phase 9's ablation and
// tools/table_probe.py; the wrapper's LOOKUP_GROUP and PROBE_FORM).

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

template <int E>
__device__ __forceinline__ void load_entry(const uint32_t* __restrict__ ent, uint32_t (&v)[E]) {
  if constexpr (E == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(ent));
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int u = 0; u < E / 4; ++u) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(ent) + u);
      v[4 * u] = x.x;
      v[4 * u + 1] = x.y;
      v[4 * u + 2] = x.z;
      v[4 * u + 3] = x.w;
    }
  }
}

// G lanes a query (G divides 32, so a group is in one warp); TAG: the
// 8-byte tag entries, else the key entries of E words
template <int W, int G, bool TAG>
__global__ void __launch_bounds__(256)
ht_probe_kernel(const uint32_t* __restrict__ table, uint32_t mask,
                const uint32_t* __restrict__ keys, const uint32_t* __restrict__ queries,
                int batch, int max_probe, int* __restrict__ out) {
  constexpr int E = TAG ? 2 : (W <= 3 ? 4 : 8);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long qi = tid / G;
  const int lane = threadIdx.x & 31, sub = lane % G;
  const unsigned group = (G == 32 ? kFullMask : (1u << G) - 1u) << (lane - sub);
  bool done = qi >= batch;
  uint32_t q[W];
#pragma unroll
  for (int j = 0; j < W; ++j) q[j] = done ? 0u : __ldg(queries + qi * W + j);
  const uint32_t h = hash_words<W>(q);
  const uint32_t tag = mix32(h ^ kGolden);
  // rounds of G slots aligned on G (a round is whole sectors): the home
  // slot is probe 0, the lanes before it in the first round are masked
  const int skip = (int)(h & (G - 1));
  for (int p0 = -skip; __any_sync(kFullMask, !done); p0 += G) {
    const int p = p0 + sub;
    bool resolves = false;
    int id = -1;
    if (!done && p >= 0 && p < max_probe) {
      uint32_t e[E];
      load_entry<E>(table + (size_t)((h + (uint32_t)p) & mask) * E, e);
      const uint32_t held = TAG ? e[0] : e[W];  // record id + 1, 0: empty
      bool match = held != 0u;
      if constexpr (TAG) {
        match = match && e[1] == tag;
        if (match) {
#pragma unroll
          for (int j = 0; j < W; ++j)
            match = match && __ldg(keys + (size_t)(held - 1u) * W + j) == q[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) match = match && e[j] == q[j];
      }
      id = (int)held - 1;
      resolves = held == 0u || match;
    }
    const unsigned hit = __ballot_sync(kFullMask, resolves) & group;
    if (!done && (hit || p0 + G >= max_probe)) {
      // the first resolving slot in probe order answers: its record, or -1
      // for an empty slot; with none left to probe, the group's first lane -1
      if (lane == (hit ? __ffs(hit) - 1 : lane - sub)) out[qi] = hit ? id : -1;
      done = true;
    }
  }
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

template <int W, bool TAG>
void launch_probe(int group, unsigned blocks, cudaStream_t st, const uint32_t* tb, uint32_t mask,
                  const uint32_t* ky, const uint32_t* qs, int batch, int max_probe, int* o) {
  switch (group) {
    case 1: ht_probe_kernel<W, 1, TAG><<<blocks, 256, 0, st>>>(tb, mask, ky, qs, batch, max_probe, o); break;
    case 2: ht_probe_kernel<W, 2, TAG><<<blocks, 256, 0, st>>>(tb, mask, ky, qs, batch, max_probe, o); break;
    case 4: ht_probe_kernel<W, 4, TAG><<<blocks, 256, 0, st>>>(tb, mask, ky, qs, batch, max_probe, o); break;
    default: ht_probe_kernel<W, 8, TAG><<<blocks, 256, 0, st>>>(tb, mask, ky, qs, batch, max_probe, o); break;
  }
}

template <bool TAG>
void launch_probe_w(int w, int group, unsigned blocks, cudaStream_t st, const uint32_t* tb,
                    uint32_t mask, const uint32_t* ky, const uint32_t* qs, int batch,
                    int max_probe, int* o) {
  switch (w) {
    case 1: launch_probe<1, TAG>(group, blocks, st, tb, mask, ky, qs, batch, max_probe, o); break;
    case 2: launch_probe<2, TAG>(group, blocks, st, tb, mask, ky, qs, batch, max_probe, o); break;
    case 3: launch_probe<3, TAG>(group, blocks, st, tb, mask, ky, qs, batch, max_probe, o); break;
    default: launch_probe<4, TAG>(group, blocks, st, tb, mask, ky, qs, batch, max_probe, o); break;
  }
}

}  // namespace

// table: m entries (m a power of two) of entry_words words, 4 (w <= 3) or 8
// (w = 4) for key entries, 2 for tag entries; keys: [n][w] words (the
// records' k-mers, read by the tag form); queries: [batch][w] words; group:
// lanes a query, 1, 2, 4 or 8; out: batch record ids (-1: a miss)
extern "C" int ctk_ht_lookup(const void* table, int m, int entry_words, const void* keys, int w,
                             const void* queries, int batch, int max_probe, int group, void* out,
                             cudaStream_t stream) {
  const bool tag = entry_words == 2;
  if (!pow2(m) || batch <= 0 || max_probe < 0 || w < 1 || w > 4 ||
      (!tag && entry_words != (w <= 3 ? 4 : 8)) ||
      (group != 1 && group != 2 && group != 4 && group != 8) ||
      reinterpret_cast<uintptr_t>(table) % (tag ? 8 : 16) != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((long long)batch * group + 255) / 256);
  const uint32_t* tb = static_cast<const uint32_t*>(table);
  const uint32_t* ky = static_cast<const uint32_t*>(keys);
  const uint32_t* qs = static_cast<const uint32_t*>(queries);
  int* o = static_cast<int*>(out);
  const uint32_t mask = (uint32_t)m - 1u;
  if (tag)
    launch_probe_w<true>(w, group, blocks, stream, tb, mask, ky, qs, batch, max_probe, o);
  else
    launch_probe_w<false>(w, group, blocks, stream, tb, mask, ky, qs, batch, max_probe, o);
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
