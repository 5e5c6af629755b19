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
//                    owning shard returned (ctk_shard_answer), one launch a
//                    step over every shard a card holds, the stores in
//                    global memory between launches.
// Plain PyTorch twins: corticall_tpu_torch/ops/walk_links.py::
// walk_links_forward_plain and ops/sharding.py::link_step_plain.
//
// A thread a walk, 32 walks a warp.  Each lane runs its own walk's k-mer
// chain in registers: the canonical form, the cuckoo lookup (both candidate
// buckets as 16-byte vectors, kmer.cuh::thread_lookup_payload_vec), the
// edge byte and CSR count, the successors, shift_append.  Almost every step
// of a walk leaves its store as it is (csrc/link_store.cuh: the needy rule,
// ops/walk_links.py::needy_steps); a lane decides that from two bits it
// keeps (kNonEmpty, kPending), and only the needy lanes' stores are
// stepped: the warp takes them one at a time in lane order, broadcasts the
// walk's record count, offset, edge byte and orientation, loads its store
// (element-minor int32 [7][32], one coalesced 128-byte row a field, lane j =
// element j), runs link_store_step, writes the store back and hands the
// outcome to the owning lane.  The step's code is the one the warp-a-walk
// kernels ran, so the outputs stay the twins' bit for bit.
//
// ctk_link_walk keeps the stores in a scratch [B][7][32] the wrapper
// allocates (not zeroed: a store is read only while kNonEmpty, after a
// needy step wrote every element of it) and writes a store back only when
// it is non-empty.  A lane stages its walk's emitted bytes in 8 registers
// and writes each 32 steps as one 32-byte sector of its row of the
// walk-major [B][pitch] stream (two 16-byte stores), then -1 to the end of
// the row; a walk that stopped stages -1 while its warp runs on.
// ctk_link_step keeps LinkState's stores, its bits and its per-walk state,
// and takes a table of shard descriptors by value, so that the shards a
// card holds step in one launch; a warp belongs to one shard.
//
// What bounds them on this card: each step of ctk_link_walk is a chain of
// two dependent random reads (the bucket pair, then the record's edge byte
// and CSR offsets), ~4-6 sectors a walk step, so the bulk walk is set by
// random sector reads once the chain's instructions are spread over the
// lanes; the ROI walks (88 warps) by the chain's latency, ~2,000 dependent
// steps.  ctk_link_step moves a few bytes a walk and is a launch's latency.

#include "link_store.cuh"

namespace {

constexpr int kStoreFields = 7;       // sharding.STORE_FIELDS
constexpr int kShardsPerLaunch = 32;  // shard descriptors a ctk_link_step launch carries

// 32-thread blocks while the walks fill fewer than 4 warps an SM, so that
// small batches spread over the SMs; 128-thread blocks otherwise
int block_threads(int warps) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return warps < 4 * sms ? 32 : 128;
}

// a lane's staged emission: 8 words of the current 32-step sector and the
// word being filled (`acc`, a byte a step from the top)
struct Staged {
  uint32_t acc, s0, s1, s2, s3, s4, s5, s6, s7;

  // the byte of step t; at the sector's last step, the sector to `row`
  __device__ __forceinline__ void put(int8_t e, int t, int8_t* row, bool mine) {
    acc = (acc >> 8) | ((uint32_t)(uint8_t)e << 24);
    if ((t & 3) == 3) {
      s0 = s1; s1 = s2; s2 = s3; s3 = s4; s4 = s5; s5 = s6; s6 = s7; s7 = acc;
    }
    if ((t & 31) == 31 && mine) {
      uint4* p = reinterpret_cast<uint4*>(row + (t - 31));
      p[0] = make_uint4(s0, s1, s2, s3);
      p[1] = make_uint4(s4, s5, s6, s7);
    }
  }
};

// 64 registers at W = 3: 8 blocks of 128 threads an SM, no spills (a cap
// of 12 blocks, 40 registers, spills and runs the bulk walk 1.55x slower:
// tools/link_probe.py --ablate)
template <int W, int BS>
__global__ void __launch_bounds__(128, 8)
link_walk_kernel(const uint32_t* __restrict__ buckets, uint32_t nb_mask, int bs, int k,
                 const uint8_t* __restrict__ edges, const int* __restrict__ link_off,
                 const uint2* __restrict__ link_choices, const int* __restrict__ link_len,
                 const uint8_t* __restrict__ link_fw, int num_links,
                 const uint32_t* __restrict__ seeds, int batch, int num_steps, int pitch,
                 int* __restrict__ stores, int8_t* __restrict__ stream,
                 uint8_t* __restrict__ overflow_out, int* __restrict__ steps_out,
                 int* __restrict__ junctions_out) {
  const int lane = threadIdx.x & 31;
  const int walk = blockIdx.x * blockDim.x + threadIdx.x;
  const int walk0 = walk - lane;
  if (walk0 >= batch) return;  // a whole warp
  const bool mine = walk < batch;
  uint32_t cur[W];
#pragma unroll
  for (int j = 0; j < W; ++j) cur[j] = mine ? seeds[(size_t)walk * W + j] : 0u;

  bool active = mine, overflow = false;
  uint32_t bits = 0u;  // kNonEmpty | kPending of this lane's store
  int steps = 0, junctions = 0;
  int8_t* row = stream + (size_t)(mine ? walk : walk0) * pitch;
  Staged out{0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  int t = 0;
  for (; t < num_steps; ++t) {
    if (!__any_sync(kFullMask, active)) break;
    bool needy = false, flipped = false;
    uint32_t edge = 0u;
    int off = 0, cnt = 0;
    LinkStep st{false, false, false, 0u};
    if (active) {
      uint32_t canon[W];
      flipped = canonicalize<W>(cur, canon, k);
      const int rec = (int)lookup_payload<W, BS>(buckets, nb_mask, bs, canon) - 1;
      if (rec >= 0) {
        edge = __ldg(edges + rec);
        off = __ldg(link_off + rec);
        cnt = __ldg(link_off + rec + 1) - off;
      }
      const uint32_t next_mask = (flipped ? edge >> 4 : edge) & 0xFu;
      needy = needy_step(cnt, next_mask, bits);
      if (!needy) st = idle_step(next_mask, bits);
    }
    // the needy walks' stores, one at a time, by the whole warp
    for (unsigned todo = __ballot_sync(kFullMask, needy); todo; todo &= todo - 1u) {
      const int src = __ffs(todo) - 1;
      const int w_off = __shfl_sync(kFullMask, off, src);
      const int w_cnt = __shfl_sync(kFullMask, cnt, src);
      const uint32_t w_edge = __shfl_sync(kFullMask, edge, src);
      const bool w_flipped = __shfl_sync(kFullMask, (int)flipped, src) != 0;
      const uint32_t w_bits = __shfl_sync(kFullMask, bits, src);
      bool w_overflow = __shfl_sync(kFullMask, (int)overflow, src) != 0;
      bool gate = false;
      uint2 rch = make_uint2(0u, 0u);
      int rlen = 0;
      if (lane < min(w_cnt, kMaxAdd)) {
        const int idx = min(w_off + lane, num_links - 1);
        gate = (__ldg(link_fw + idx) != 0) == !w_flipped;
        if (gate) {
          rch = __ldg(link_choices + idx);
          rlen = __ldg(link_len + idx);
        }
      }
      int* el_row = stores + (size_t)(walk0 + src) * kStoreFields * 32 + lane;
      LinkElement el{0u, 0u, 0, 0, 0, 0, false};
      if (w_bits & kNonEmpty) el = load_element(el_row);
      const LinkStep ws = link_store_step(el, gate, rch, rlen, w_cnt, w_edge, w_flipped, t == 0,
                                          t * kMaxAdd, w_overflow, lane);
      const uint32_t w_new = store_bits(el, ws.store_active);
      if (ws.store_active) store_element(el_row, el);
      if (lane == src) {
        st = ws;
        bits = w_new;
        overflow = w_overflow;
      }
    }
    int8_t e = -1;
    if (active) {
      junctions += st.take_choice ? 1 : 0;
      if (st.advance) {
        e = (int8_t)(st.base | (st.store_active ? 8u : 0u));
        ++steps;
        uint32_t nxt[W];
        shift_append<W>(cur, st.base, k, nxt);
#pragma unroll
        for (int j = 0; j < W; ++j) cur[j] = nxt[j];
      } else {
        active = false;  // it stays on its k-mer and adds nothing more
      }
    }
    out.put(e, t, row, mine);
  }
  // the rest of the last sector, then -1 to the end of the row
  for (; t & 31; ++t) out.put(-1, t, row, mine);
  if (mine) {
    for (int p = t; p < pitch; p += 16)
      *reinterpret_cast<uint4*>(row + p) = make_uint4(~0u, ~0u, ~0u, ~0u);
    overflow_out[walk] = overflow;
    steps_out[walk] = steps;
    junctions_out[walk] = junctions;
  }
}

// one shard's linked walks, as ctk_link_step takes them (ops/sharding.py
// LINK_SHARD_FIELDS): cur [batch][w] words, active, bits, flipped (route),
// slot (route, -1: not routed), back [routed][a_cols] answers, store
// [batch][7][32], overflow, junctions, row (row `step` of the stream)
struct LinkShard {
  uint32_t* cur;
  uint8_t* active;
  uint8_t* bits;
  const uint8_t* flipped;
  const int* slot;
  const int* back;
  int* store;
  uint8_t* overflow;
  int* junctions;
  int8_t* row;
  int batch, a_cols, warp0;  // warp0: the shard's first warp in the launch
};

struct LinkShards {
  LinkShard s[kShardsPerLaunch];
  int n;
};

template <int W>
__global__ void __launch_bounds__(128)
link_step_kernel(const __grid_constant__ LinkShards shards, int total_warps, int k, int step) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= total_warps) return;  // a whole warp
  int s = 0;
  while (s + 1 < shards.n && warp >= shards.s[s + 1].warp0) ++s;
  const LinkShard& d = shards.s[s];
  const int walk0 = (warp - d.warp0) * 32;
  const int walk = walk0 + lane;
  const bool mine = walk < d.batch;
  const int sl = mine ? d.slot[walk] : -1;
  const int* ans = d.back + (size_t)max(sl, 0) * d.a_cols;
  bool live = false, needy = false, fl = false;
  int cnt = 0;
  uint32_t edge = 0u, bits = 0u;
  LinkStep st{false, false, false, 0u};
  if (sl >= 0) {
    cnt = __ldg(ans + kAnsCnt);
    live = d.active[walk] != 0;
    if (!live) {  // routed at the seed step while inactive: store_add's count overflow
      if (cnt > kMaxAdd) d.overflow[walk] = 1;
    } else {
      fl = d.flipped[walk] != 0;
      edge = (uint32_t)__ldg(ans + kAnsEdge);
      bits = d.bits[walk];
      const uint32_t next_mask = (fl ? edge >> 4 : edge) & 0xFu;
      needy = needy_step(cnt, next_mask, bits);
      if (!needy) st = idle_step(next_mask, bits);
    }
  }
  for (unsigned todo = __ballot_sync(kFullMask, needy); todo; todo &= todo - 1u) {
    const int src = __ffs(todo) - 1;
    const int* a = d.back + (size_t)__shfl_sync(kFullMask, sl, src) * d.a_cols;
    const int w_cnt = __shfl_sync(kFullMask, cnt, src);
    const bool w_fl = __shfl_sync(kFullMask, (int)fl, src) != 0;
    bool gate = false;
    uint2 rch = make_uint2(0u, 0u);
    int rlen = 0;
    if (lane < min(w_cnt, kMaxAdd)) {
      gate = (__ldg(a + kAnsFw + lane) != 0) == !w_fl;
      if (gate) {
        rch = make_uint2((uint32_t)__ldg(a + kAnsChoices + 2 * lane),
                         (uint32_t)__ldg(a + kAnsChoices + 2 * lane + 1));
        rlen = __ldg(a + kAnsLen + lane);
      }
    }
    int* el_row = d.store + (size_t)(walk0 + src) * kStoreFields * 32 + lane;
    LinkElement el = load_element(el_row);
    bool ov = d.overflow[walk0 + src] != 0;
    const LinkStep ws = link_store_step(el, gate, rch, rlen, w_cnt,
                                        __shfl_sync(kFullMask, edge, src), w_fl, step == 0,
                                        step * kMaxAdd, ov, lane);
    const uint32_t w_new = store_bits(el, ws.store_active);
    store_element(el_row, el);
    if (lane == src) {
      st = ws;
      d.overflow[walk] = ov;
      if (w_new != bits) d.bits[walk] = (uint8_t)w_new;
    }
  }
  if (!mine) return;
  if (!live) {
    d.row[walk] = -1;
    return;
  }
  d.row[walk] = st.advance ? (int8_t)(st.base | (st.store_active ? 8u : 0u)) : (int8_t)-1;
  if (st.take_choice) d.junctions[walk] += 1;
  if (!st.advance) {
    d.active[walk] = 0;
    return;
  }
  uint32_t c[W], nxt[W];
#pragma unroll
  for (int j = 0; j < W; ++j) c[j] = d.cur[(size_t)walk * W + j];
  shift_append<W>(c, st.base, k, nxt);
#pragma unroll
  for (int j = 0; j < W; ++j) d.cur[(size_t)walk * W + j] = nxt[j];
}

template <int W, int BS>
const void* walk_kernel_fn() {
  return reinterpret_cast<const void*>(&link_walk_kernel<W, BS>);
}

const void* walk_kernel_for(int w, bool vec) {
  switch (w) {
    case 1: return vec ? walk_kernel_fn<1, 4>() : walk_kernel_fn<1, 0>();
    case 2: return vec ? walk_kernel_fn<2, 4>() : walk_kernel_fn<2, 0>();
    case 3: return vec ? walk_kernel_fn<3, 4>() : walk_kernel_fn<3, 0>();
    default: return vec ? walk_kernel_fn<4, 4>() : walk_kernel_fn<4, 0>();
  }
}

const void* step_kernel_for(int w) {
  switch (w) {
    case 1: return reinterpret_cast<const void*>(&link_step_kernel<1>);
    case 2: return reinterpret_cast<const void*>(&link_step_kernel<2>);
    case 3: return reinterpret_cast<const void*>(&link_step_kernel<3>);
    default: return reinterpret_cast<const void*>(&link_step_kernel<4>);
  }
}

}  // namespace

// buckets: [nb][bs][w + 1] words (payload = record + 1); edges: n bytes;
// link_off: n + 1 ints; link_choices: [num_links][2] words (8-byte aligned);
// link_len: num_links ints; link_fw: num_links bytes; seeds: [batch][w]
// words; stores: [batch][7][32] ints of scratch; stream: [batch][pitch]
// bytes out (pitch a multiple of 32, at least num_steps, 16-byte aligned);
// overflow: batch bytes out; steps, junctions: batch ints out
extern "C" int ctk_link_walk(const void* buckets, int nb, int bs, int w, int k, const void* edges,
                             const void* link_off, const void* link_choices, const void* link_len,
                             const void* link_fw, int num_links, const void* seeds, int batch,
                             int num_steps, int pitch, void* stores, void* stream, void* overflow,
                             void* steps, void* junctions, cudaStream_t cuda_stream) {
  if (!pow2(nb) || bs < 1 || batch <= 0 || num_steps < 0 || pitch < num_steps || pitch % 32 ||
      num_links < 1 || k < 1 || k > 63 || w != (k + 15) / 16 ||
      reinterpret_cast<uintptr_t>(link_choices) % 8 || reinterpret_cast<uintptr_t>(stream) % 16 ||
      reinterpret_cast<uintptr_t>(stores) % 4)
    return (int)cudaErrorInvalidValue;
  const int warps = (batch + 31) / 32;
  const int threads = block_threads(warps);
  const unsigned blocks = (unsigned)((batch + threads - 1) / threads);
  const uint32_t* bk = static_cast<const uint32_t*>(buckets);
  const uint8_t* ed = static_cast<const uint8_t*>(edges);
  const int* lo = static_cast<const int*>(link_off);
  const uint2* lc = static_cast<const uint2*>(link_choices);
  const int* ll = static_cast<const int*>(link_len);
  const uint8_t* lf = static_cast<const uint8_t*>(link_fw);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  int* sto = static_cast<int*>(stores);
  int8_t* st = static_cast<int8_t*>(stream);
  uint8_t* ov = static_cast<uint8_t*>(overflow);
  int* sp = static_cast<int*>(steps);
  int* jn = static_cast<int*>(junctions);
  const uint32_t mask = (uint32_t)nb - 1u;
  const bool vec = vector_lookup(buckets, bs);
#define CTK_LINK_WALK(WW, BB)                                                                     \
  link_walk_kernel<WW, BB><<<blocks, threads, 0, cuda_stream>>>(bk, mask, bs, k, ed, lo, lc, ll,  \
                                                                lf, num_links, sd, batch,         \
                                                                num_steps, pitch, sto, st, ov,    \
                                                                sp, jn)
#define CTK_LINK_WALK_W(WW)    \
  if (vec)                     \
    CTK_LINK_WALK(WW, 4);      \
  else                         \
    CTK_LINK_WALK(WW, 0)
  switch (w) {
    case 1: CTK_LINK_WALK_W(1); break;
    case 2: CTK_LINK_WALK_W(2); break;
    case 3: CTK_LINK_WALK_W(3); break;
    default: CTK_LINK_WALK_W(4); break;
  }
#undef CTK_LINK_WALK_W
#undef CTK_LINK_WALK
  return (int)cudaGetLastError();
}

// shards: num_shards host descriptors (LinkShard, warp0 ignored: set here),
// every pointer on the current card; each shard's batch >= 0 and a_cols >=
// the linked answer's.  One launch for every kShardsPerLaunch shards.
extern "C" int ctk_link_step(const void* shards, int num_shards, int w, int k, int step,
                             cudaStream_t cuda_stream) {
  if (num_shards < 0 || k < 1 || k > 63 || w != (k + 15) / 16 || step < 0)
    return (int)cudaErrorInvalidValue;
  const LinkShard* in = static_cast<const LinkShard*>(shards);
  for (int i = 0; i < num_shards; ++i)
    if (in[i].batch < 0 || (in[i].batch > 0 && in[i].a_cols < kLinkAnswer))
      return (int)cudaErrorInvalidValue;
  for (int first = 0; first < num_shards; first += kShardsPerLaunch) {
    LinkShards table;
    table.n = 0;
    int warps = 0;
    for (int i = first; i < num_shards && i < first + kShardsPerLaunch; ++i) {
      if (in[i].batch == 0) continue;
      table.s[table.n] = in[i];
      table.s[table.n].warp0 = warps;
      warps += (in[i].batch + 31) / 32;
      ++table.n;
    }
    if (!warps) continue;
    const int threads = block_threads(warps);
    const unsigned blocks = (unsigned)((warps * 32 + threads - 1) / threads);
#define CTK_LINK_STEP(WW) \
  link_step_kernel<WW><<<blocks, threads, 0, cuda_stream>>>(table, warps, k, step)
    switch (w) {
      case 1: CTK_LINK_STEP(1); break;
      case 2: CTK_LINK_STEP(2); break;
      case 3: CTK_LINK_STEP(3); break;
      default: CTK_LINK_STEP(4); break;
    }
#undef CTK_LINK_STEP
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// What a launch of `batch` walks at W = w runs as: out[0] threads a block,
// out[1] registers a thread, out[2] blocks an SM the card keeps resident,
// out[3] local memory bytes a thread (spills).  which: 0 ctk_link_walk (bs,
// buckets: the table it would walk), 1 ctk_link_step.
extern "C" int ctk_link_kernel_info(int which, int w, int bs, const void* buckets, int batch,
                                    int* out) {
  if (w < 1 || w > 4 || batch <= 0 || (which != 0 && which != 1))
    return (int)cudaErrorInvalidValue;
  const void* fn = which == 0 ? walk_kernel_for(w, vector_lookup(buckets, bs)) : step_kernel_for(w);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  const int threads = block_threads((batch + 31) / 32);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = attr.numRegs;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  return (int)cudaSuccess;
}
