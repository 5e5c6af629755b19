// The linked device walker: link-assisted walks with a LinkStore a walk.
//
// Replaces the XLA device code of corticall_tpu/ops/walk_links.py:
//   ctk_link_walk <- walk_links_forward (line 199), its scan step with
//                    store_add (97), store_advance (135) and _char_at (192),
//                    and the one-gather cuckoo lookup_payload of
//                    corticall_tpu/ops/cuckoo.py (line 190), all fused into
//                    one launch over num_steps.
// Plain PyTorch twin: corticall_tpu_torch/ops/walk_links.py::
// walk_links_forward_plain.
//
// One warp a walk, lane j = LinkStore element j (CAP = 32, the warp's
// width): each lane keeps its element in registers (two choice words, len,
// pos, age, seq, valid), and every reduction over the store is a warp
// intrinsic, so a step needs no shared memory and no barrier:
// - store_add: lanes 0-15 hold the current k-mer's link records 0-15 (the
//   CSR gather, orientation-gated); a record's add rank and a free slot's
//   free rank are popcounts of ballots below the lane, and the slot of free
//   rank r pulls the record of add rank r with __shfl_sync.  The element's
//   seq is seq_counter + its record index; seq_counter grows by MAX_ADD a
//   step;
// - store_advance: oldest_age by __reduce_max_sync, the first oldest by
//   __ffs of a ballot (lane 0 when there is none, as jnp.argmax gives for an
//   all-false row), rep_char and rep_words by __shfl_sync, agree by
//   __all_sync, same_list compares both words, latest is the first lane
//   holding the largest masked seq (lane 0 when all are -1);
// - the lookup: the warp reads both candidate buckets, an entry a lane
//   (kmer.cuh::warp_lookup_payload), and takes the payload (record + 1) as a
//   maximum.
// Every value a step decides is the same in all lanes, so the warp's control
// flow is uniform.  A walk whose step does not advance stays on its k-mer for
// good and adds nothing more (its store_add is gated by `active`, and the
// rec_cnt > MAX_ADD overflow of that k-mer was counted on the step that
// stopped it), so the warp writes -1 for the remaining steps and leaves.
//
// Emission is one byte a walk a step.  The warp stages 32 steps' bytes, one
// a lane, and writes them as one 32-byte sector of the walk-major [B][pitch]
// stream (pitch a multiple of 32); the wrapper hands back the [T, B] view.
//
// What bounds it on this card: each step is a chain of dependent random
// reads (the bucket pair, then the record's edge byte and CSR offsets, then
// its link records) and ~30 warp-synchronous shuffles and votes; the lever is
// walks in flight (128-thread blocks of 4 walks, few registers).

#include "kmer.cuh"

namespace {

constexpr int kMaxAdd = 16;  // walk_links.MAX_ADD; the store's CAP is the warp

// position of the n-th (from 0) set bit of mask; mask has more than n
__device__ __forceinline__ int nth_set_bit(unsigned mask, int n) {
  for (int i = 0; i < n; ++i) mask &= mask - 1u;
  return __ffs(mask) - 1;
}

template <int W>
__global__ void __launch_bounds__(128)
link_walk_kernel(const uint32_t* __restrict__ buckets, uint32_t nb_mask, int bs, int k,
                 const uint8_t* __restrict__ edges, const int* __restrict__ link_off,
                 const uint2* __restrict__ link_choices, const int* __restrict__ link_len,
                 const uint8_t* __restrict__ link_fw, int num_links,
                 const uint32_t* __restrict__ seeds, int batch, int num_steps, int pitch,
                 int8_t* __restrict__ stream, uint8_t* __restrict__ overflow_out,
                 int* __restrict__ steps_out, int* __restrict__ junctions_out) {
  const int lane = threadIdx.x & 31;
  const int walk = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (walk >= batch) return;  // a whole warp
  const unsigned below = (1u << lane) - 1u;
  uint32_t cur[W];
#pragma unroll
  for (int j = 0; j < W; ++j) cur[j] = seeds[(size_t)walk * W + j];

  uint32_t ch0 = 0u, ch1 = 0u;  // this lane's element
  int len = 0, pos = 0, age = 0, seq = 0;
  bool valid = false;
  bool overflow = false;
  int seq_counter = 0, steps = 0, junctions = 0;
  int8_t* row = stream + (size_t)walk * pitch;
  int8_t staged = -1;
  int t = 0;
  while (t < num_steps) {
    uint32_t canon[W];
    const bool flipped = canonicalize<W>(cur, canon, k);
    const int rec = (int)warp_lookup_payload<W>(buckets, nb_mask, bs, canon, lane) - 1;
    uint32_t edge = 0u;
    int off = 0, cnt = 0;
    if (rec >= 0) {
      edge = __ldg(edges + rec);
      off = __ldg(link_off + rec);
      cnt = __ldg(link_off + rec + 1) - off;
    }

    // 1. store_add: records of this k-mer into the free slots, by rank
    bool gate = false;
    uint2 rch = make_uint2(0u, 0u);
    int rlen = 0;
    if (lane < min(cnt, kMaxAdd)) {
      const int idx = min(off + lane, num_links - 1);
      gate = (__ldg(link_fw + idx) != 0) == !flipped;
      if (gate) {
        rch = __ldg(link_choices + idx);
        rlen = __ldg(link_len + idx);
      }
    }
    const unsigned gmask = __ballot_sync(kFullMask, gate);
    const unsigned fmask = __ballot_sync(kFullMask, !valid);
    const int ngate = __popc(gmask);
    const int rfree = __popc(fmask & below);
    const bool filled = !valid && rfree < ngate;
    const int src = filled ? nth_set_bit(gmask, rfree) : lane;
    const uint32_t p0 = __shfl_sync(kFullMask, rch.x, src);
    const uint32_t p1 = __shfl_sync(kFullMask, rch.y, src);
    const int plen = __shfl_sync(kFullMask, rlen, src);
    if (filled) {
      ch0 = p0;
      ch1 = p1;
      len = plen;
      pos = 0;
      age = 0;
      seq = seq_counter + src;
      valid = true;
    }
    overflow = overflow || ngate > __popc(fmask) || cnt > kMaxAdd;
    seq_counter += kMaxAdd;

    // 2-4. successor choice, junction consume, ageing
    const uint32_t next_mask = (flipped ? edge >> 4 : edge) & 0xFu;
    const int n = __popc(next_mask);
    const bool live = valid && pos < len;
    const int oldest = __reduce_max_sync(kFullMask, live ? age : -1);
    const bool is_oldest = live && age == oldest && oldest >= 0;
    const uint32_t ch = (((pos >> 4) ? ch1 : ch0) >> (2 * (pos & 15))) & 3u;
    const unsigned omask = __ballot_sync(kFullMask, is_oldest);
    const int first = omask ? __ffs(omask) - 1 : 0;
    const uint32_t rep_char = __shfl_sync(kFullMask, ch, first);
    const bool agree = __all_sync(kFullMask, !is_oldest || ch == rep_char);
    const uint32_t rep0 = __shfl_sync(kFullMask, ch0, first);
    const uint32_t rep1 = __shfl_sync(kFullMask, ch1, first);
    const int masked = (valid && ch0 == rep0 && ch1 == rep1) ? seq : -1;
    const int latest_seq = __reduce_max_sync(kFullMask, masked);
    const int latest = __ffs(__ballot_sync(kFullMask, masked == latest_seq)) - 1;
    const uint32_t choice = __shfl_sync(kFullMask, ch, latest);

    const bool is_first = t == 0;
    const bool junction = n > 1;
    const bool take_choice =
        junction && omask != 0u && agree && ((next_mask >> choice) & 1u) && !is_first;
    const uint32_t base = junction ? choice : lowest_set_base(next_mask);
    const bool advance = n == 1 || take_choice;
    if (take_choice) {
      const bool keep = valid && ch == choice && pos + 1 < len;
      if (keep) ++pos;
      valid = keep;
    }
    const bool new_paths = __any_sync(kFullMask, valid && age == 0);
    if (valid && !is_first) age += (junction ? 1 : 0) + (new_paths ? 1 : 0);
    const bool store_active = __any_sync(kFullMask, valid);

    const int8_t e = advance ? (int8_t)(base | (store_active ? 8u : 0u)) : (int8_t)-1;
    if (lane == (t & 31)) staged = e;
    if ((t & 31) == 31) {
      row[t - 31 + lane] = staged;
      staged = -1;
    }
    ++t;
    junctions += take_choice ? 1 : 0;
    if (!advance) break;
    ++steps;
    uint32_t nxt[W];
    shift_append<W>(cur, base, k, nxt);
#pragma unroll
    for (int j = 0; j < W; ++j) cur[j] = nxt[j];
  }
  // the staged part of the last sector (lanes past the walk's end hold -1),
  // then -1 to the end of the row, 4 bytes a lane
  if (t & 31) row[(t & ~31) + lane] = staged;
  for (int p = ((t + 31) & ~31) + 4 * lane; p < pitch; p += 128)
    *reinterpret_cast<int*>(row + p) = -1;
  if (lane == 0) {
    overflow_out[walk] = overflow;
    steps_out[walk] = steps;
    junctions_out[walk] = junctions;
  }
}

}  // namespace

// buckets: [nb][bs][w + 1] words (payload = record + 1); edges: n bytes;
// link_off: n + 1 ints; link_choices: [num_links][2] words (8-byte aligned);
// link_len: num_links ints; link_fw: num_links bytes; seeds: [batch][w]
// words; stream: [batch][pitch] bytes out (pitch a multiple of 32, at least
// num_steps); overflow: batch bytes out; steps, junctions: batch ints out
extern "C" int ctk_link_walk(const void* buckets, int nb, int bs, int w, int k, const void* edges,
                             const void* link_off, const void* link_choices, const void* link_len,
                             const void* link_fw, int num_links, const void* seeds, int batch,
                             int num_steps, int pitch, void* stream, void* overflow, void* steps,
                             void* junctions, cudaStream_t cuda_stream) {
  if (!pow2(nb) || bs < 1 || batch <= 0 || num_steps < 0 || pitch < num_steps || pitch % 32 ||
      num_links < 1 || k < 1 || k > 63 || w != (k + 15) / 16 ||
      reinterpret_cast<uintptr_t>(link_choices) % 8 || reinterpret_cast<uintptr_t>(stream) % 4)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((batch + 3) / 4);
  const uint32_t* bk = static_cast<const uint32_t*>(buckets);
  const uint8_t* ed = static_cast<const uint8_t*>(edges);
  const int* lo = static_cast<const int*>(link_off);
  const uint2* lc = static_cast<const uint2*>(link_choices);
  const int* ll = static_cast<const int*>(link_len);
  const uint8_t* lf = static_cast<const uint8_t*>(link_fw);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  int8_t* st = static_cast<int8_t*>(stream);
  uint8_t* ov = static_cast<uint8_t*>(overflow);
  int* sp = static_cast<int*>(steps);
  int* jn = static_cast<int*>(junctions);
  const uint32_t mask = (uint32_t)nb - 1u;
#define CTK_LINK_WALK(WW)                                                                      \
  link_walk_kernel<WW><<<blocks, 128, 0, cuda_stream>>>(bk, mask, bs, k, ed, lo, lc, ll, lf,   \
                                                        num_links, sd, batch, num_steps, pitch, \
                                                        st, ov, sp, jn)
  switch (w) {
    case 1: CTK_LINK_WALK(1); break;
    case 2: CTK_LINK_WALK(2); break;
    case 3: CTK_LINK_WALK(3); break;
    default: CTK_LINK_WALK(4); break;
  }
#undef CTK_LINK_WALK
  return (int)cudaGetLastError();
}
