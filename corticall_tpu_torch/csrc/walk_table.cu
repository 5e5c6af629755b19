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
// num_steps.  A lane that goes inactive never comes back and reads no more.
// Each iteration writes one byte a lane to row t of the [T][B] output (a warp
// writes 32 contiguous bytes).  Bound by the card's rate of dependent random
// row reads (a walk reads a row a step; the walk table is ~20x the L2), not by
// the bytes of the distinct rows.  The design, a thread a walk with its state
// in registers:
// - the walk table's 2-entry row (BS = 2, 16-40 bytes) is loaded as 16- or
//   8-byte vectors, all issued before any compare (the first form read it
//   word by word, each load behind the compare before it); other bucket
//   sizes, or a table not so aligned, take the word-at-a-time path;
// - the lanes in flight: 128-thread blocks capped at 32 registers keep 2,048
//   threads an SM, so 262,144 lanes run as one wave on 132 SMs;
// - the tail: a lane that ends fills its own -1 rows.
// tools/table_probe.py --spec --ablate rebuilds this file with the cap
// lifted, with two walks a thread (both rows' loads issued before either is
// compared, 64 registers) and with a warp-cooperative tail (a warp walks
// until its last lane ends); none was faster at phase 9's 262,144 lanes
// (PERF.md, Findings).

#include "kmer.cuh"

namespace {

// E words at ent as 16-byte vectors (E a multiple of 4, ent 16-byte
// aligned), else as 8-byte ones (E even, ent 8-byte aligned), all issued
// before any is used
template <int E>
__device__ __forceinline__ void load_entry(const uint32_t* __restrict__ ent, uint32_t (&v)[E]) {
  static_assert(E % 2 == 0, "an entry is whole 8-byte vectors");
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int u = 0; u < E / 4; ++u) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(ent) + u);
      v[4 * u] = x.x;
      v[4 * u + 1] = x.y;
      v[4 * u + 2] = x.z;
      v[4 * u + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < E / 2; ++u) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(ent) + u);
      v[2 * u] = x.x;
      v[2 * u + 1] = x.y;
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

constexpr int kSpecThreads = 128;
// walks a thread, and blocks an SM for the register cap: 16 blocks of 128
// threads is 32 registers a thread, 2,048 threads an SM
constexpr int kSpecWalks = 1;
constexpr int kSpecMinBlocks = 16;

// a walk's state, held in registers
template <int W>
struct SpecLane {
  uint32_t cur[W], saved[W];
  int power, lam, emitcnt;
  bool probe, active, cycled;
};

// the payload of the entries of a loaded row of BS entries that hold canon
// (their largest; 0 when none does: found false)
template <int W, int BS>
__device__ __forceinline__ uint32_t row_payload(const uint32_t (&v)[BS * (W + 1)],
                                                const uint32_t (&canon)[W], bool& found) {
  uint32_t e = 0u;
  found = false;
#pragma unroll
  for (int s = 0; s < BS; ++s) {
    const uint32_t tag = v[s * (W + 1) + W];
    bool match = tag >= kTag;
#pragma unroll
    for (int j = 0; j < W; ++j) match &= v[s * (W + 1) + j] == canon[j];
    found |= match;
    e = max(e, match ? tag & 0x7FFFFFFFu : 0u);
  }
  return e;
}

// the same for a row of bs entries read from memory, an entry's words
// issued together
template <int W>
__device__ __forceinline__ uint32_t row_payload_words(const uint32_t* __restrict__ row, int bs,
                                                      const uint32_t (&canon)[W], bool& found) {
  uint32_t e = 0u;
  found = false;
  for (int s = 0; s < bs; ++s) {
    uint32_t v[W + 1];
#pragma unroll
    for (int j = 0; j <= W; ++j) v[j] = __ldg(row + s * (W + 1) + j);
    bool held;
    e = max(e, row_payload<W, 1>(v, canon, held));
    found |= held;
  }
  return e;
}

// one iteration of an active walk given its row's answer (found, payload e):
// the next base when it advances, Brent's anchor, the stall and the end;
// returns the byte it emits (-1 at a stall, a cycle, a branch or the cap)
template <int W>
__device__ __forceinline__ int8_t spec_advance(SpecLane<W>& l, bool found, uint32_t e,
                                               bool flipped, int k, int num_steps) {
  const uint32_t next_mask = (flipped ? e >> 4 : e) & 0xFu;
  const uint32_t base = lowest_set_base(next_mask);
  uint32_t nxt[W];
  shift_append<W>(l.cur, base, k, nxt);
  const bool single = found && __popc(next_mask) == 1;
  bool at_anchor = true;
#pragma unroll
  for (int j = 0; j < W; ++j) at_anchor = at_anchor && nxt[j] == l.saved[j];
  const bool is_cycle = at_anchor && single;
  const bool advance = single && !is_cycle && l.emitcnt < num_steps;
  const bool stall = !found && !l.probe;
  if (advance) {
    if (l.power == l.lam) {  // Brent: move the anchor
#pragma unroll
      for (int j = 0; j < W; ++j) l.saved[j] = nxt[j];
      l.power *= 2;
      l.lam = 0;
    }
    l.lam += 1;
#pragma unroll
    for (int j = 0; j < W; ++j) l.cur[j] = nxt[j];
    l.emitcnt += 1;
  }
  l.cycled = l.cycled || is_cycle;
  l.probe = stall;
  l.active = advance || stall;
  return advance ? (int8_t)base : (int8_t)-1;
}

// P = kSpecWalks walks a thread (walk tid + p * ceil(batch / P), so that
// each slot's stores are a warp's 32 contiguous bytes); VEC: 2-entry rows
// loaded as vectors (load_entry), else bs entries a word at a time
template <int W, bool VEC>
__global__ void __launch_bounds__(kSpecThreads, kSpecMinBlocks)
spec_walk_kernel(const uint32_t* __restrict__ buckets, uint32_t nb_mask, int bs, int k,
                 const uint32_t* __restrict__ seeds, int batch, int num_steps, int iters,
                 int8_t* __restrict__ bases, uint8_t* __restrict__ cycled_out,
                 int* __restrict__ steps_out) {
  constexpr int P = kSpecWalks;
  constexpr int R = VEC ? 2 * (W + 1) : 1;  // a loaded row's words
  const int span = (batch + P - 1) / P;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  SpecLane<W> lane[P];
  int walk[P];
  bool in[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    walk[p] = tid + p * span;
    in[p] = tid < span && walk[p] < batch;
#pragma unroll
    for (int j = 0; j < W; ++j)
      lane[p].saved[j] = lane[p].cur[j] = in[p] ? __ldg(seeds + (size_t)walk[p] * W + j) : 0u;
    lane[p].power = 1;
    lane[p].lam = lane[p].emitcnt = 0;
    lane[p].probe = lane[p].cycled = false;
    lane[p].active = in[p];
  }
  int t = 0;
  for (; t < iters; ++t) {
    bool live = false;
#pragma unroll
    for (int p = 0; p < P; ++p) live = live || lane[p].active;
    if (!live) break;
    // every active walk's row requested before any is compared
    uint32_t canon[P][W], row[P][R];
    const uint32_t* at[P];
    bool flipped[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (lane[p].active) {
        flipped[p] = canonicalize<W>(lane[p].cur, canon[p], k);
        const uint32_t h = hash_words<W>(canon[p]);
        at[p] = buckets + (size_t)((lane[p].probe ? mix32(h ^ kGolden) : h) & nb_mask) *
                              (VEC ? 2 : bs) * (W + 1);
        if constexpr (VEC) load_entry<R>(at[p], row[p]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int8_t out = -1;
      if (lane[p].active) {
        bool found;
        uint32_t e;
        if constexpr (VEC)
          e = row_payload<W, 2>(row[p], canon[p], found);
        else
          e = row_payload_words<W>(at[p], bs, canon[p], found);
        out = spec_advance<W>(lane[p], found, e, flipped[p], k, num_steps);
      }
      if (in[p]) bases[(size_t)t * batch + walk[p]] = out;
    }
  }
  for (; t < iters; ++t) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (in[p]) bases[(size_t)t * batch + walk[p]] = -1;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (in[p]) {
      steps_out[walk[p]] = lane[p].emitcnt;
      cycled_out[walk[p]] = lane[p].cycled;
    }
  }
}

using SpecKernel = void (*)(const uint32_t*, uint32_t, int, int, const uint32_t*, int, int, int,
                            int8_t*, uint8_t*, int*);

// whether a launch reads its rows as vectors: 2-entry rows, the table
// aligned for their vectors (16 bytes at odd w, whose rows are 2 (w + 1) words)
bool spec_vec(const void* buckets, int bs, int w) {
  const uintptr_t align = w % 2 ? 16 : 8;
  return bs == 2 && reinterpret_cast<uintptr_t>(buckets) % align == 0;
}

template <bool VEC>
SpecKernel spec_kernel_for(int w) {
  switch (w) {
    case 1: return spec_walk_kernel<1, VEC>;
    case 2: return spec_walk_kernel<2, VEC>;
    case 3: return spec_walk_kernel<3, VEC>;
    default: return spec_walk_kernel<4, VEC>;
  }
}

SpecKernel spec_kernel_for(const void* buckets, int bs, int w) {
  return spec_vec(buckets, bs, w) ? spec_kernel_for<true>(w) : spec_kernel_for<false>(w);
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
// bytes out (every byte written); cycled: batch bytes out; steps: batch ints
// out
extern "C" int ctk_spec_walk(const void* buckets, int nb, int bs, int w, int k, const void* seeds,
                             int batch, int num_steps, int iters, void* bases, void* cycled,
                             void* steps, cudaStream_t stream) {
  if (!pow2(nb) || bs < 1 || batch <= 0 || num_steps < 0 || iters < 0 || k < 1 || k > 63 ||
      w != (k + 15) / 16)
    return (int)cudaErrorInvalidValue;
  const int threads = (batch + kSpecWalks - 1) / kSpecWalks;
  const unsigned blocks = (unsigned)((threads + kSpecThreads - 1) / kSpecThreads);
  const SpecKernel fn = spec_kernel_for(buckets, bs, w);
  fn<<<blocks, kSpecThreads, 0, stream>>>(
      static_cast<const uint32_t*>(buckets), (uint32_t)nb - 1u, bs, k,
      static_cast<const uint32_t*>(seeds), batch, num_steps, iters, static_cast<int8_t*>(bases),
      static_cast<uint8_t*>(cycled), static_cast<int*>(steps));
  return (int)cudaGetLastError();
}

// How a ctk_spec_walk launch over `buckets` (bs entries a bucket, w words a
// k-mer) runs on the current card: out[0] threads a block, out[1] registers
// a thread, out[2] blocks an SM resident, out[3] local memory bytes a thread
// (spills), out[4] walks a thread, out[5] the card's SMs, out[6] 1 where it
// reads its rows as vectors, 0 a word at a time.
extern "C" int ctk_spec_walk_info(const void* buckets, int bs, int w, int* out) {
  if (w < 1 || w > 4 || bs < 1) return (int)cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(spec_kernel_for(buckets, bs, w));
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kSpecThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  out[0] = kSpecThreads;
  out[1] = attr.numRegs;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kSpecWalks;
  out[5] = sms;
  out[6] = spec_vec(buckets, bs, w);
  return (int)cudaSuccess;
}
