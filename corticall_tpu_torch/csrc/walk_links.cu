// The linked device walkers: link-assisted walks with a LinkStore a walk.
//
// Replace the XLA device code of corticall_tpu/ops/walk_links.py and
// corticall_tpu/parallel/mesh.py:
//   ctk_link_walk <- walk_links_forward (walk_links.py:199), its scan step
//                    with store_add (97), store_advance (135) and _char_at
//                    (192), and the one-gather cuckoo lookup_payload of
//                    corticall_tpu/ops/cuckoo.py (line 190), all fused into
//                    one launch over num_steps;
//   ctk_link_step <- one step of the sharded linked walk (mesh.py:300-325):
//                    the same store step on the payload that the walk's
//                    owning shard returned (ctk_shard_answer), a launch a
//                    step, the store in global memory between launches.
// Plain PyTorch twins: corticall_tpu_torch/ops/walk_links.py::
// walk_links_forward_plain and ops/sharding.py::link_step_plain.
//
// One warp a walk, lane j = LinkStore element j (csrc/link_store.cuh holds
// the step both kernels run).  ctk_link_walk keeps the element in registers
// for the whole walk; its lookup is kmer.cuh::warp_lookup_payload (the warp
// reads both candidate buckets, an entry a lane, and takes the payload,
// record + 1, as a maximum).  A walk whose step does not advance stays on
// its k-mer for good and adds nothing more (its store_add is gated by
// `active`, and the rec_cnt > MAX_ADD overflow of that k-mer was counted on
// the step that stopped it), so the warp writes -1 for the remaining steps
// and leaves.  Emission is one byte a walk a step: the warp stages 32 steps'
// bytes, one a lane, and writes them as one 32-byte sector of the walk-major
// [B][pitch] stream (pitch a multiple of 32); the wrapper hands back the
// [T, B] view.
//
// ctk_link_step keeps the store element-minor, int32 [B][7][32] (two choice
// words, length, position, age, sequence, valid), so that a warp's load or
// store of one field is one coalesced 128-byte row; it reads the walk's
// answer row by the walk's slot (the unsort of mesh.py:163-165) and writes
// row `step` of the [T, B] stream.
//
// What bounds them on this card: each step is a chain of dependent random
// reads (ctk_link_walk: the bucket pair, then the record's edge byte and CSR
// offsets, then its link records; ctk_link_step: the answer row and the
// store's 896 bytes) and ~30 warp-synchronous shuffles and votes; the lever
// is walks in flight (128-thread blocks of 4 walks, few registers).

#include "link_store.cuh"

namespace {

constexpr int kStoreFields = 7;  // sharding.STORE_FIELDS

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
  uint32_t cur[W];
#pragma unroll
  for (int j = 0; j < W; ++j) cur[j] = seeds[(size_t)walk * W + j];

  LinkElement el{0u, 0u, 0, 0, 0, 0, false};  // this lane's element
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
    const LinkStep st =
        link_store_step(el, gate, rch, rlen, cnt, edge, flipped, t == 0, seq_counter, overflow,
                        lane);
    seq_counter += kMaxAdd;

    const int8_t e =
        st.advance ? (int8_t)(st.base | (st.store_active ? 8u : 0u)) : (int8_t)-1;
    if (lane == (t & 31)) staged = e;
    if ((t & 31) == 31) {
      row[t - 31 + lane] = staged;
      staged = -1;
    }
    ++t;
    junctions += st.take_choice ? 1 : 0;
    if (!st.advance) break;
    ++steps;
    uint32_t nxt[W];
    shift_append<W>(cur, st.base, k, nxt);
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

template <int W>
__global__ void __launch_bounds__(128)
link_step_kernel(uint32_t* __restrict__ cur, int batch, int k, uint8_t* __restrict__ active,
                 const uint8_t* __restrict__ flipped, const int* __restrict__ slot,
                 const int* __restrict__ back, int a_cols, int* __restrict__ store,
                 uint8_t* __restrict__ overflow_io, int* __restrict__ junctions, int step,
                 int8_t* __restrict__ row) {
  const int lane = threadIdx.x & 31;
  const int walk = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (walk >= batch) return;  // a whole warp
  const int sl = slot[walk];
  if (sl < 0) {  // not routed: a walk that has ended
    if (lane == 0) row[walk] = -1;
    return;
  }
  const int* ans = back + (size_t)sl * a_cols;
  const int cnt = __ldg(ans + kAnsCnt);
  if (!active[walk]) {  // routed at the seed step while inactive: store_add's count overflow
    if (lane == 0) {
      if (cnt > kMaxAdd) overflow_io[walk] = 1;
      row[walk] = -1;
    }
    return;
  }
  const bool fl = flipped[walk] != 0;
  bool gate = false;
  uint2 rch = make_uint2(0u, 0u);
  int rlen = 0;
  if (lane < min(cnt, kMaxAdd)) {
    gate = (__ldg(ans + kAnsFw + lane) != 0) == !fl;
    if (gate) {
      rch = make_uint2((uint32_t)__ldg(ans + kAnsChoices + 2 * lane),
                       (uint32_t)__ldg(ans + kAnsChoices + 2 * lane + 1));
      rlen = __ldg(ans + kAnsLen + lane);
    }
  }
  int* el_row = store + (size_t)walk * kStoreFields * 32 + lane;
  LinkElement el{(uint32_t)el_row[0], (uint32_t)el_row[32], el_row[64], el_row[96],
                 el_row[128], el_row[160], el_row[192] != 0};
  bool overflow = overflow_io[walk] != 0;
  const LinkStep st = link_store_step(el, gate, rch, rlen, cnt, (uint32_t)__ldg(ans + kAnsEdge),
                                      fl, step == 0, step * kMaxAdd, overflow, lane);
  el_row[0] = (int)el.ch0;
  el_row[32] = (int)el.ch1;
  el_row[64] = el.len;
  el_row[96] = el.pos;
  el_row[128] = el.age;
  el_row[160] = el.seq;
  el_row[192] = el.valid ? 1 : 0;
  if (lane == 0) {
    overflow_io[walk] = overflow;
    junctions[walk] += st.take_choice ? 1 : 0;
    active[walk] = st.advance;
    row[walk] = st.advance ? (int8_t)(st.base | (st.store_active ? 8u : 0u)) : (int8_t)-1;
    if (st.advance) {
      uint32_t c[W], nxt[W];
#pragma unroll
      for (int j = 0; j < W; ++j) c[j] = cur[(size_t)walk * W + j];
      shift_append<W>(c, st.base, k, nxt);
#pragma unroll
      for (int j = 0; j < W; ++j) cur[(size_t)walk * W + j] = nxt[j];
    }
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

// cur: [batch][w] words (updated); active, flipped: batch bytes; slot: batch
// ints (-1: not routed); back: [routed][a_cols] answer ints (a_cols >= the
// linked answer's); store: [batch][7][32] ints (updated); overflow: batch
// bytes, junctions: batch ints (updated); row: batch bytes out (row `step`
// of the stream)
extern "C" int ctk_link_step(void* cur, int batch, int w, int k, void* active,
                             const void* flipped, const void* slot, const void* back, int a_cols,
                             void* store, void* overflow, void* junctions, int step, void* row,
                             cudaStream_t cuda_stream) {
  if (batch <= 0 || k < 1 || k > 63 || w != (k + 15) / 16 || a_cols < kLinkAnswer || step < 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((batch + 3) / 4);
  uint32_t* cu = static_cast<uint32_t*>(cur);
  uint8_t* ac = static_cast<uint8_t*>(active);
  const uint8_t* fl = static_cast<const uint8_t*>(flipped);
  const int* sl = static_cast<const int*>(slot);
  const int* bk = static_cast<const int*>(back);
  int* sto = static_cast<int*>(store);
  uint8_t* ov = static_cast<uint8_t*>(overflow);
  int* jn = static_cast<int*>(junctions);
  int8_t* rw = static_cast<int8_t*>(row);
#define CTK_LINK_STEP(WW)                                                                    \
  link_step_kernel<WW><<<blocks, 128, 0, cuda_stream>>>(cu, batch, k, ac, fl, sl, bk, a_cols, \
                                                        sto, ov, jn, step, rw)
  switch (w) {
    case 1: CTK_LINK_STEP(1); break;
    case 2: CTK_LINK_STEP(2); break;
    case 3: CTK_LINK_STEP(3); break;
    default: CTK_LINK_STEP(4); break;
  }
#undef CTK_LINK_STEP
  return (int)cudaGetLastError();
}
