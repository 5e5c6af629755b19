// One step of a walk's LinkStore by a whole warp, shared by the linked
// walkers of csrc/walk_links.cu (ctk_link_walk, ctk_link_step).
//
// The step is store_add then store_advance of corticall_tpu/ops/
// walk_links.py (:97, :135), with _char_at (:192); the plain PyTorch twins
// are corticall_tpu_torch/ops/walk_links.py::store_add / store_advance.
// Lane j holds store element j (CAP = 32, the warp's width) in registers, so
// every reduction over the store is a warp intrinsic and a step needs no
// shared memory and no barrier:
// - store_add: lanes 0-15 hold the current k-mer's link records 0-15 (the
//   caller's gather, orientation-gated); a record's add rank and a free
//   slot's free rank are popcounts of ballots below the lane, and the slot
//   of free rank r pulls the record of add rank r with __shfl_sync.  The
//   element's seq is seq_counter + its record index;
// - store_advance: oldest_age by __reduce_max_sync, the first oldest by
//   __ffs of a ballot (lane 0 when there is none, as jnp.argmax gives for an
//   all-false row), rep_char and rep_words by __shfl_sync, agree by
//   __all_sync, same_list compares both words, latest is the first lane
//   holding the largest masked seq (lane 0 when all are -1).
// Every value the step decides is the same in all lanes, so the warp's
// control flow stays uniform.
#pragma once

#include "kmer.cuh"
#include "shard_answer.cuh"

namespace {

// position of the n-th (from 0) set bit of mask; mask has more than n
__device__ __forceinline__ int nth_set_bit(unsigned mask, int n) {
  for (int i = 0; i < n; ++i) mask &= mask - 1u;
  return __ffs(mask) - 1;
}

// one store element, in its lane's registers
struct LinkElement {
  uint32_t ch0, ch1;  // the choice words: choice j in bits 2*(j%16) of word j/16
  int len, pos, age, seq;
  bool valid;
};

// what a step decided, the same in every lane
struct LinkStep {
  bool advance;       // the walk moves on to shift_append(cur, base)
  bool take_choice;   // at a junction past the seed, by a link choice
  bool store_active;  // an element is valid after the step
  uint32_t base;
};

// One step of an active walk at its current k-mer: the k-mer's gated link
// records join the store (this lane's record: gate, rch, rlen, on lanes <
// kMaxAdd; cnt: the k-mer's record count), then the successor is chosen
// from `edge` (the combined edge byte; 0 when the k-mer is not in the graph)
// in the walk's orientation (`flipped`), a junction's choice is consumed and
// the elements age.  seq_counter is kMaxAdd times the step.  Every lane of
// the warp must call it.
__device__ __forceinline__ LinkStep link_store_step(LinkElement& el, bool gate, uint2 rch,
                                                    int rlen, int cnt, uint32_t edge,
                                                    bool flipped, bool is_first,
                                                    int seq_counter, bool& overflow, int lane) {
  const unsigned below = (1u << lane) - 1u;

  // 1. store_add: records of this k-mer into the free slots, by rank
  const unsigned gmask = __ballot_sync(kFullMask, gate);
  const unsigned fmask = __ballot_sync(kFullMask, !el.valid);
  const int ngate = __popc(gmask);
  const int rfree = __popc(fmask & below);
  const bool filled = !el.valid && rfree < ngate;
  const int src = filled ? nth_set_bit(gmask, rfree) : lane;
  const uint32_t p0 = __shfl_sync(kFullMask, rch.x, src);
  const uint32_t p1 = __shfl_sync(kFullMask, rch.y, src);
  const int plen = __shfl_sync(kFullMask, rlen, src);
  if (filled) {
    el.ch0 = p0;
    el.ch1 = p1;
    el.len = plen;
    el.pos = 0;
    el.age = 0;
    el.seq = seq_counter + src;
    el.valid = true;
  }
  overflow = overflow || ngate > __popc(fmask) || cnt > kMaxAdd;

  // 2-4. successor choice, junction consume, ageing
  const uint32_t next_mask = (flipped ? edge >> 4 : edge) & 0xFu;
  const int n = __popc(next_mask);
  const bool live = el.valid && el.pos < el.len;
  const int oldest = __reduce_max_sync(kFullMask, live ? el.age : -1);
  const bool is_oldest = live && el.age == oldest && oldest >= 0;
  const uint32_t ch = (((el.pos >> 4) ? el.ch1 : el.ch0) >> (2 * (el.pos & 15))) & 3u;
  const unsigned omask = __ballot_sync(kFullMask, is_oldest);
  const int first = omask ? __ffs(omask) - 1 : 0;
  const uint32_t rep_char = __shfl_sync(kFullMask, ch, first);
  const bool agree = __all_sync(kFullMask, !is_oldest || ch == rep_char);
  const uint32_t rep0 = __shfl_sync(kFullMask, el.ch0, first);
  const uint32_t rep1 = __shfl_sync(kFullMask, el.ch1, first);
  const int masked = (el.valid && el.ch0 == rep0 && el.ch1 == rep1) ? el.seq : -1;
  const int latest_seq = __reduce_max_sync(kFullMask, masked);
  const int latest = __ffs(__ballot_sync(kFullMask, masked == latest_seq)) - 1;
  const uint32_t choice = __shfl_sync(kFullMask, ch, latest);

  const bool junction = n > 1;
  LinkStep out;
  out.take_choice =
      junction && omask != 0u && agree && ((next_mask >> choice) & 1u) && !is_first;
  out.base = junction ? choice : lowest_set_base(next_mask);
  out.advance = n == 1 || out.take_choice;
  if (out.take_choice) {
    const bool keep = el.valid && ch == choice && el.pos + 1 < el.len;
    if (keep) ++el.pos;
    el.valid = keep;
  }
  const bool new_paths = __any_sync(kFullMask, el.valid && el.age == 0);
  if (el.valid && !is_first) el.age += (junction ? 1 : 0) + (new_paths ? 1 : 0);
  out.store_active = __any_sync(kFullMask, el.valid);
  return out;
}

}  // namespace
