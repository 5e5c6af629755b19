// The hash-sharded graph's kernels: routing, the owners' answers, the walk
// step.
//
// Replace the XLA device code of corticall_tpu/parallel/mesh.py:
//   ctk_route           <- kmer_jax.canonicalize_words (:310, :422, :574)
//                          and the routing half of _routed_exchange
//                          (:111-118): each query's owner and the packing
//                          by owner (the argsort / searchsorted), here of
//                          the queries of every shard on one card into one
//                          buffer;
//   ctk_shard_answer    <- the local answer of sharded_lookup_fn /
//                          sharded_lookup_tree_fn (:180-185, :205-209):
//                          cuckoo.lookup_payload (corticall_tpu/ops/
//                          cuckoo.py:190) and the payload gathers (the
//                          combined edge byte, :278-284, :407-413,
//                          :559-565; the link rows, :285-292), for every
//                          owner on one card;
//   ctk_shard_walk_step <- the walk step of :419-438 (Brent's cycle test)
//                          and :568-583 (the plain advance), with the
//                          unsort of the answers (:163-165).
// Plain PyTorch twins: corticall_tpu_torch/ops/sharding.py.
//
// The shards that share a card exchange on the card: a step is one
// ctk_route launch over the card's queries (its shards' walks, shard after
// shard), one ctk_shard_answer launch over its owners, then the walk step,
// with no host read between them.
//
// ctk_route is a stable counting sort of the queries by owner (at most
// 64) into one owner-major buffer: owner t's block holds the queries sent
// to t in the queries' order, so shard after shard (the layout that an
// exchange on the host builds by slicing).  One cooperative launch (every
// block resident), three phases split by two grid barriers: (1) a block a
// 256-query tile of one asker: the canonical form, owner and flag of each
// query and the tile's count of each owner; (2) a block an owner: the
// exclusive scan of its counts over the tiles, its total and each asker's
// count; (3) the owners' starts (a scan of the totals), then each routed
// query's slot, its owner's start + its tile's offset + its rank among the
// tile's queries of that owner (the lanes of its warp by seven ballots over
// the owner's bits, then the warps before it), where its canonical words
// go.  Nothing is zeroed ahead of the launch: every count is written, not
// added to, and the barrier's two words come back to rest.  What bounds it:
// a few words a query, and at the few thousand queries of a linked step
// the launch and the barriers' latency; one launch a card replaces a launch
// a shard of two passes and two memsets.
//
// ctk_shard_answer takes the owners' tables from a descriptor table passed
// by value and reads each owner's block start and the routed total on the
// card: a grid-stride grid sized by the buffer's capacity, threads past the
// total return.  The walk's answer (2 words) is a thread a query: the
// cuckoo lookup on both buckets' 16-byte vectors, the colours' edge bytes
// ORed, one 8-byte store.  The linked answer (67 words) is a warp a run of
// 32 rows: a lane a query for the lookup, then the warp gathers the 32
// queries' link rows (two queries a pass, a lane a row, every load issued
// before any store), stages the rows in shared memory and writes the run
// as contiguous 16-byte vectors.  What bounds it: the random reads (the
// bucket pair, the edge bytes, the CSR rows) and the rows written; 64-thread
// blocks spread a linked step's few thousand queries over as many SMs.
//
// ctk_shard_walk_step is a thread a walk, its answer row read by its slot.
// A step moves a few words a walk (~18.6 MB at 262,144 walks), so what
// bounds it is the chain of round trips to memory before a thread can write:
// the first form read a walk's slot only after its active flag, its answer
// only after the slot, and its anchor, power and lam only after the answer.
// Here a thread reads its active flag and slot at entry, then for a live walk
// the answer row by the slot together with the walk's route flag, words,
// anchor, power, lam and steps: two round trips, and an ended walk costs its
// flag and slot.  (The answer read as one 8-byte vector bought nothing at
// k = 47: tools/link_probe.py --ablate.  Reading the state at entry for
// every walk, live or not, was no faster at 262,144 live walks and slower on
// walks that end early: PERF.md, Findings.)  Only what the step changes is
// written: the words, steps and lam of a walk that advances, the anchor and
// power where it teleports, the cycle flag where it finds one, the active
// flag where the walk stops.

#include <algorithm>

#include "kmer.cuh"
#include "shard_answer.cuh"

namespace {

constexpr int kMaxShards = 64;      // sharding.MAX_SHARDS
constexpr int kRouteThreads = 256;  // a route tile: sharding.ROUTE_TILE queries of one asker
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kOwnerBits = 7;       // an owner, or kMaxShards for a query not routed
constexpr int kAnswerThreads = 256;
constexpr int kLinkAnswerThreads = 64;
constexpr int kLinkRows = 32;       // linked answer rows a warp stages: one a lane
static_assert(kMaxAdd == 16, "the link gather takes a row a lane, two queries a pass");

template <int W>
__device__ __forceinline__ uint32_t routing_hash(const uint32_t (&canon)[W]) {
  return mix32(hash_words<W>(canon) ^ kGolden);
}

template <int W>
__device__ __forceinline__ bool load_canonical(const uint32_t* __restrict__ cur, int i, int k,
                                               uint32_t (&canon)[W]) {
  uint32_t v[W];
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = cur[(size_t)i * W + j];
  return canonicalize<W>(v, canon, k);
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// A barrier over the grid of a cooperative launch (every block resident):
// bar[0] counts the blocks arrived and is 0 again when the barrier opens,
// bar[1] is the generation each opening bumps.  Both persist from launch to
// launch, zero at first, and need no reset.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// the askers' spans of the card's queries, as ctk_route builds them
struct RouteAskers {
  int start[kMaxShards + 1];  // asker a's queries: [start[a], start[a + 1])
  int tile0[kMaxShards + 1];  // its tiles: [tile0[a], tile0[a + 1])
  int n;
};

__device__ __forceinline__ int asker_of_tile(const RouteAskers& as, int tile) {
  int a = 0;
  while (a + 1 < as.n && tile >= as.tile0[a + 1]) ++a;
  return a;
}

// the route of the card's queries: cur [B][W], active (null: every query);
// owner, flipped, slot [B] out; send [B][W] out (rows [0, offsets[n]));
// counts [askers][n] and offsets [n + 1] out; hist [n][tiles] and tot [n]
// scratch; bar the barrier's words
template <int W>
__global__ void __launch_bounds__(kRouteThreads)
route_kernel(const __grid_constant__ RouteAskers askers, const uint32_t* __restrict__ cur,
             const uint8_t* __restrict__ active, int k, int n, int tiles,
             int* __restrict__ owner, uint8_t* __restrict__ flipped, int* __restrict__ slot,
             uint32_t* __restrict__ send, int* __restrict__ counts, int* __restrict__ offsets,
             int* __restrict__ hist, int* __restrict__ tot, unsigned* bar) {
  __shared__ int s_count[kRouteWarps][kMaxShards];
  __shared__ int s_start[kMaxShards + 1];
  __shared__ int s_sum[kRouteWarps];
  __shared__ int s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. a tile a pass: each query's canonical form, owner and flag, and the
  // tile's count of each owner
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int j = threadIdx.x; j < n; j += kRouteThreads) s_count[0][j] = 0;
    __syncthreads();
    const int a = asker_of_tile(askers, tile);
    const int i = askers.start[a] + (tile - askers.tile0[a]) * kRouteThreads + threadIdx.x;
    if (i < askers.start[a + 1]) {
      uint32_t canon[W];
      flipped[i] = load_canonical<W>(cur, i, k, canon);
      const int o = (int)(routing_hash<W>(canon) % (uint32_t)n);
      owner[i] = o;
      if (active == nullptr || active[i]) atomicAdd(&s_count[0][o], 1);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kRouteThreads)
      hist[(size_t)j * tiles + tile] = s_count[0][j];
    __syncthreads();
  }
  grid_barrier(bar);

  // 2. a block an owner: the exclusive scan of its counts over the tiles
  // (in place), its total, and each asker's count (its tiles' span)
  for (int o = blockIdx.x; o < n; o += gridDim.x) {
    int* col = hist + (size_t)o * tiles;
    const int per = (tiles + kRouteThreads - 1) / kRouteThreads;
    const int lo = min((int)threadIdx.x * per, tiles), hi = min(lo + per, tiles);
    int sum = 0;
    for (int t = lo; t < hi; ++t) sum += __ldcg(col + t);
    const int incl = warp_inclusive_sum(sum);
    if (lane == 31) s_sum[warp] = incl;
    __syncthreads();
    int run = incl - sum;
    for (int w = 0; w < warp; ++w) run += s_sum[w];
    for (int t = lo; t < hi; ++t) {
      const int c = __ldcg(col + t);
      __stcg(col + t, run);
      run += c;
    }
    if (threadIdx.x == kRouteThreads - 1) {  // its run ends at the total
      tot[o] = run;
      s_total = run;
    }
    __syncthreads();
    for (int a = threadIdx.x; a < askers.n; a += kRouteThreads) {
      const int t0 = askers.tile0[a], t1 = askers.tile0[a + 1];
      counts[a * n + o] = (t1 < tiles ? __ldcg(col + t1) : s_total) -
                          (t0 < tiles ? __ldcg(col + t0) : s_total);
    }
    __syncthreads();
  }
  grid_barrier(bar);

  // 3. the owners' starts (the scan of their totals; n <= 64, two a lane),
  // then each routed query's slot and canonical words
  if (warp == 0) {
    const int j0 = 2 * lane, j1 = j0 + 1;
    const int v0 = j0 < n ? __ldcg(tot + j0) : 0, v1 = j1 < n ? __ldcg(tot + j1) : 0;
    const int incl = warp_inclusive_sum(v0 + v1);
    if (j0 < n) s_start[j0] = incl - v0 - v1;
    if (j1 < n) s_start[j1] = incl - v1;
    if (lane == 31) s_start[n] = incl;
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j <= n; j += kRouteThreads) offsets[j] = s_start[j];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int j = threadIdx.x; j < kRouteWarps * kMaxShards; j += kRouteThreads)
      s_count[j / kMaxShards][j % kMaxShards] = 0;
    __syncthreads();
    const int a = asker_of_tile(askers, tile);
    const int i = askers.start[a] + (tile - askers.tile0[a]) * kRouteThreads + threadIdx.x;
    const bool in = i < askers.start[a + 1];
    const int o = in && (active == nullptr || active[i]) ? owner[i] : n;  // this thread's own
    unsigned peers = kFullMask;  // the lanes routing to the same owner (or none)
#pragma unroll
    for (int b = 0; b < kOwnerBits; ++b) {
      const bool bit = (o >> b) & 1;
      const unsigned set = __ballot_sync(kFullMask, bit);
      peers &= bit ? set : ~set;
    }
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (o < n && rank == 0) s_count[warp][o] = __popc(peers);
    __syncthreads();
    if (in) {
      int p = -1;
      if (o < n) {
        p = s_start[o] + __ldcg(hist + (size_t)o * tiles + tile) + rank;
        for (int w = 0; w < warp; ++w) p += s_count[w][o];
        uint32_t canon[W];
        load_canonical<W>(cur, i, k, canon);
#pragma unroll
        for (int j = 0; j < W; ++j) send[(size_t)p * W + j] = canon[j];
      }
      slot[i] = p;
    }
    __syncthreads();
  }
}

// one owner's tables, as ctk_shard_answer takes them (ops/sharding.py
// ANSWER_OWNER_FIELDS): buckets [nb][bs][w + 1] words (payload = the
// owner's record + 1); edges [records][num_colors] bytes; the link CSR
// (link_off null: none), choices 8-byte aligned
struct AnswerOwner {
  const uint32_t* buckets;
  const uint8_t* edges;
  const int* link_off;
  const uint2* link_choices;
  const int* link_len;
  const uint8_t* link_fw;
  int num_links;
};

struct AnswerOwners {
  AnswerOwner o[kMaxShards];
  int n;
};

// the owner of received row i < s_off[m]: the one whose block holds it
__device__ __forceinline__ int owner_of_row(const int* s_off, int m, int i) {
  int lo = 1, hi = m;  // the first u in [1, m] with s_off[u] > i
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_off[mid] > i)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo - 1;
}

__device__ __forceinline__ uint32_t edge_byte(const uint8_t* __restrict__ edges, int rec,
                                              int num_colors, uint32_t color_mask) {
  uint32_t edge = 0u;
  for (int c = 0; c < num_colors; ++c)
    if ((color_mask >> c) & 1u) edge |= __ldg(edges + (size_t)rec * num_colors + c);
  return edge;
}

// the walk's answer: a thread a received row
template <int W, int BS>
__global__ void __launch_bounds__(kAnswerThreads)
walk_answer_kernel(const __grid_constant__ AnswerOwners owners, const uint32_t* __restrict__ recv,
                   const int* __restrict__ offsets, uint32_t nb_mask, int bs, int num_colors,
                   uint32_t color_mask, int2* __restrict__ ans) {
  __shared__ int s_off[kMaxShards + 1];
  for (int j = threadIdx.x; j <= owners.n; j += kAnswerThreads) s_off[j] = __ldg(offsets + j);
  __syncthreads();
  const int total = s_off[owners.n];
  for (int i = blockIdx.x * kAnswerThreads + threadIdx.x; i < total;
       i += gridDim.x * kAnswerThreads) {
    const AnswerOwner& d = owners.o[owner_of_row(s_off, owners.n, i)];
    uint32_t q[W];
#pragma unroll
    for (int j = 0; j < W; ++j) q[j] = __ldg(recv + (size_t)i * W + j);
    const int rec = (int)lookup_payload<W, BS>(d.buckets, nb_mask, bs, q) - 1;
    ans[i] = make_int2(rec, rec >= 0 ? (int)edge_byte(d.edges, rec, num_colors, color_mask) : 0);
  }
}

// the linked answer: a warp a run of kLinkRows received rows
template <int W, int BS>
__global__ void __launch_bounds__(kLinkAnswerThreads)
link_answer_kernel(const __grid_constant__ AnswerOwners owners, const uint32_t* __restrict__ recv,
                   const int* __restrict__ offsets, uint32_t nb_mask, int bs, int num_colors,
                   uint32_t color_mask, int* __restrict__ ans) {
  __shared__ int s_off[kMaxShards + 1];
  __shared__ __align__(16) int s_rows[kLinkAnswerThreads / 32][kLinkRows * kLinkAnswer];
  for (int j = threadIdx.x; j <= owners.n; j += kLinkAnswerThreads) s_off[j] = __ldg(offsets + j);
  __syncthreads();
  const int total = s_off[owners.n];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, j = lane & 15;
  int* rows = s_rows[warp];
  for (int base = (blockIdx.x * (kLinkAnswerThreads / 32) + warp) * kLinkRows; base < total;
       base += gridDim.x * kLinkAnswerThreads) {
    // a lane a row: its owner, record, edge byte and link span
    const int i = base + lane;
    int t = 0, rec = -1, off = 0, cnt = 0;
    uint32_t edge = 0u;
    if (i < total) {
      t = owner_of_row(s_off, owners.n, i);
      const AnswerOwner& d = owners.o[t];
      uint32_t q[W];
#pragma unroll
      for (int w = 0; w < W; ++w) q[w] = __ldg(recv + (size_t)i * W + w);
      rec = (int)lookup_payload<W, BS>(d.buckets, nb_mask, bs, q) - 1;
      if (rec >= 0) {
        edge = edge_byte(d.edges, rec, num_colors, color_mask);
        off = __ldg(d.link_off + rec);
        cnt = __ldg(d.link_off + rec + 1) - off;
      }
    }
    int* row = rows + lane * kLinkAnswer;
    row[kAnsRec] = rec;
    row[kAnsEdge] = (int)edge;
    row[kAnsCnt] = cnt;
    // the warp on the link rows: in pass p, lane (q, j) = (2p + lane / 16,
    // lane % 16) reads row j of query q; zero past min(count, MAX_ADD)
    uint2 ch[kLinkRows / 2];
    int len[kLinkRows / 2], fw[kLinkRows / 2];
#pragma unroll
    for (int p = 0; p < kLinkRows / 2; ++p) {
      const int q = 2 * p + (lane >> 4);
      const int q_off = __shfl_sync(kFullMask, off, q);
      const int take = min(__shfl_sync(kFullMask, cnt, q), kMaxAdd);
      const int q_t = __shfl_sync(kFullMask, t, q);
      ch[p] = make_uint2(0u, 0u);
      len[p] = fw[p] = 0;
      if (j < take) {  // rows past the pool cannot be read: the JAX clamp
        const AnswerOwner& d = owners.o[q_t];
        const int src = min(q_off + j, d.num_links - 1);
        ch[p] = __ldg(d.link_choices + src);
        len[p] = __ldg(d.link_len + src);
        fw[p] = __ldg(d.link_fw + src);
      }
    }
#pragma unroll
    for (int p = 0; p < kLinkRows / 2; ++p) {
      int* r = rows + (2 * p + (lane >> 4)) * kLinkAnswer;
      r[kAnsChoices + 2 * j] = (int)ch[p].x;
      r[kAnsChoices + 2 * j + 1] = (int)ch[p].y;
      r[kAnsLen + j] = len[p];
      r[kAnsFw + j] = fw[p];
    }
    __syncwarp();
    // the run out: its rows are contiguous words (base is a multiple of 32,
    // so the run starts on a 16-byte boundary)
    const int words = min(kLinkRows, total - base) * kLinkAnswer;
    int* out = ans + (size_t)base * kLinkAnswer;
    for (int v = lane; v < words / 4; v += 32)
      reinterpret_cast<int4*>(out)[v] = reinterpret_cast<const int4*>(rows)[v];
    for (int v = (words & ~3) + lane; v < words; v += 32) out[v] = rows[v];
    __syncwarp();
  }
}

// the card's SM count, and the blocks of a kernel that can all be resident
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

int resident_blocks(const void* fn, int threads) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0) != cudaSuccess)
    return 0;
  return per_sm * sm_count();
}

const void* route_kernel_for(int w) {
  switch (w) {
    case 1: return reinterpret_cast<const void*>(&route_kernel<1>);
    case 2: return reinterpret_cast<const void*>(&route_kernel<2>);
    case 3: return reinterpret_cast<const void*>(&route_kernel<3>);
    default: return reinterpret_cast<const void*>(&route_kernel<4>);
  }
}

template <int W>
__global__ void __launch_bounds__(256)
shard_walk_step_kernel(uint32_t* __restrict__ cur, int batch, int k, uint8_t* __restrict__ active,
                       const uint8_t* __restrict__ flipped, const int* __restrict__ slot,
                       const int* __restrict__ back, int a_cols, uint32_t* __restrict__ saved,
                       int* __restrict__ power, int* __restrict__ lam,
                       uint8_t* __restrict__ cycled, int* __restrict__ steps, int cycle_check,
                       int8_t* __restrict__ row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  // the flag and the slot at once; then, for a live walk, the answer row by
  // the slot (the one read that waits) together with the walk's own state
  const bool live = active[i] != 0;
  const int s = __ldg(slot + i);
  int8_t e = -1;
  if (live) {  // an active walk is always routed
    const int* a = back + (size_t)s * a_cols;
    const int rec = __ldg(a + kAnsRec);
    const uint32_t edge = (uint32_t)__ldg(a + kAnsEdge);
    const bool flip = __ldg(flipped + i) != 0;
    uint32_t c[W], anchor[W] = {};
#pragma unroll
    for (int j = 0; j < W; ++j) c[j] = cur[(size_t)i * W + j];
    int pw = 0, lm = 0;
    if (cycle_check) {
#pragma unroll
      for (int j = 0; j < W; ++j) anchor[j] = saved[(size_t)i * W + j];
      pw = power[i];
      lm = lam[i];
    }
    const int st = steps[i];
    const uint32_t next_mask = (flip ? edge >> 4 : edge) & 0xFu;
    const uint32_t base = lowest_set_base(next_mask);
    uint32_t nxt[W];
    shift_append<W>(c, base, k, nxt);
    const bool single = __popc(next_mask) == 1 && rec >= 0;
    bool is_cycle = cycle_check && single;
#pragma unroll
    for (int j = 0; j < W; ++j) is_cycle = is_cycle && anchor[j] == nxt[j];
    const bool advance = single && !is_cycle;
    if (advance) {
#pragma unroll
      for (int j = 0; j < W; ++j) cur[(size_t)i * W + j] = nxt[j];
      steps[i] = st + 1;
      e = (int8_t)base;
    }
    if (cycle_check) {
      const bool teleport = advance && pw == lm;
      if (teleport) {
#pragma unroll
        for (int j = 0; j < W; ++j) saved[(size_t)i * W + j] = nxt[j];
        power[i] = pw * 2;
      }
      if (advance) lam[i] = teleport ? 1 : lm + 1;
      if (is_cycle) cycled[i] = 1;
    }
    if (!advance) active[i] = 0;
  }
  row[i] = e;
}

}  // namespace

#define CTK_BY_W(MACRO) \
  switch (w) {          \
    case 1: MACRO(1); break; \
    case 2: MACRO(2); break; \
    case 3: MACRO(3); break; \
    default: MACRO(4); break; \
  }

// cur: [batch][w] walk-oriented words, the card's queries asker after asker
// (batches: a host array of the askers' counts, summing to batch); active:
// batch bytes or null (route every query); owner, slot: batch ints out;
// flipped: batch bytes out; send: [batch][w] words out (rows [0,
// offsets[n]) written); counts: [askers][n] ints out; offsets: n + 1 ints
// out; scratch: n * (tiles + 1) ints, tiles = the askers' ceil(count /
// 256) summed; barrier: 2 words, zero before the card's first route and
// left so (one route at a time a card).  One cooperative launch.
extern "C" int ctk_route(const void* cur, int w, int k, int n, const void* active,
                         const void* batches, int askers, void* owner, void* flipped, void* slot,
                         void* send, void* counts, void* offsets, void* scratch, void* barrier,
                         cudaStream_t cuda_stream) {
  if (n < 1 || n > kMaxShards || askers < 1 || askers > kMaxShards || k < 1 || k > 63 ||
      w != (k + 15) / 16)
    return (int)cudaErrorInvalidValue;
  RouteAskers table;
  table.n = askers;
  table.start[0] = table.tile0[0] = 0;
  const int* b = static_cast<const int*>(batches);
  for (int a = 0; a < askers; ++a) {
    if (b[a] < 0) return (int)cudaErrorInvalidValue;
    table.start[a + 1] = table.start[a] + b[a];
    table.tile0[a + 1] = table.tile0[a] + (b[a] + kRouteThreads - 1) / kRouteThreads;
  }
  int tiles = table.tile0[askers];
  const void* fn = route_kernel_for(w);
  const int resident = resident_blocks(fn, kRouteThreads);
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const uint32_t* cu = static_cast<const uint32_t*>(cur);
  const uint8_t* ac = static_cast<const uint8_t*>(active);
  int* ow = static_cast<int*>(owner);
  uint8_t* fl = static_cast<uint8_t*>(flipped);
  int* sl = static_cast<int*>(slot);
  uint32_t* se = static_cast<uint32_t*>(send);
  int* co = static_cast<int*>(counts);
  int* of = static_cast<int*>(offsets);
  int* hist = static_cast<int*>(scratch);
  int* tot = hist + (size_t)n * tiles;
  unsigned* bar = static_cast<unsigned*>(barrier);
  void* args[] = {&table, &cu, &ac, (void*)&k, (void*)&n, &tiles, &ow, &fl, &sl, &se, &co, &of,
                  &hist, &tot, &bar};
  const unsigned grid = (unsigned)std::max(1, std::min(tiles, resident));
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kRouteThreads), args, 0,
                                          cuda_stream);
}

// owners: m host descriptors (AnswerOwner), every pointer on the current
// card, every owner with its link CSR (a_cols = the linked answer's) or
// none (a_cols = the walk's); recv: [capacity][w] canonical words, owner
// j's block rows [offsets[j], offsets[j + 1]); offsets: m + 1 ints on the
// card, offsets[m] <= capacity; buckets: [nb][bs][w + 1] words for every
// owner; ans: [capacity][a_cols] ints out, 16-byte aligned, rows past
// offsets[m] left as they were
extern "C" int ctk_shard_answer(const void* owners, int m, const void* recv, int capacity, int w,
                                const void* offsets, int nb, int bs, int num_colors,
                                unsigned color_mask, void* ans, int a_cols,
                                cudaStream_t cuda_stream) {
  if (m < 1 || m > kMaxShards || capacity < 0 || w < 1 || w > 4 || !pow2(nb) || bs < 1 ||
      num_colors < 1 || num_colors > 32 || (a_cols != kWalkAnswer && a_cols != kLinkAnswer) ||
      reinterpret_cast<uintptr_t>(ans) % 16)
    return (int)cudaErrorInvalidValue;
  const AnswerOwner* in = static_cast<const AnswerOwner*>(owners);
  AnswerOwners table;
  table.n = m;
  bool vec = true;
  for (int j = 0; j < m; ++j) {
    const AnswerOwner& d = in[j];
    if ((d.link_off != nullptr) != (a_cols == kLinkAnswer) ||
        (d.link_off && (d.num_links < 1 || reinterpret_cast<uintptr_t>(d.link_choices) % 8)))
      return (int)cudaErrorInvalidValue;
    vec = vec && vector_lookup(d.buckets, bs);
    table.o[j] = d;
  }
  if (capacity == 0) return (int)cudaSuccess;
  const int sms = std::max(sm_count(), 1);
  const uint32_t* rv = static_cast<const uint32_t*>(recv);
  const int* of = static_cast<const int*>(offsets);
  const uint32_t mask = (uint32_t)nb - 1u;
  if (a_cols == kWalkAnswer) {
    const unsigned blocks =
        (unsigned)std::min((capacity + kAnswerThreads - 1) / kAnswerThreads, 8 * sms);
#define CTK_WALK_ANSWER(WW, BB)                                                              \
  walk_answer_kernel<WW, BB><<<blocks, kAnswerThreads, 0, cuda_stream>>>(                    \
      table, rv, of, mask, bs, num_colors, color_mask, static_cast<int2*>(ans))
#define CTK_WALK_ANSWER_W(WW) \
  if (vec)                    \
    CTK_WALK_ANSWER(WW, 4);   \
  else                        \
    CTK_WALK_ANSWER(WW, 0)
    CTK_BY_W(CTK_WALK_ANSWER_W)
#undef CTK_WALK_ANSWER_W
#undef CTK_WALK_ANSWER
  } else {
    const unsigned blocks =
        (unsigned)std::min((capacity + kLinkAnswerThreads - 1) / kLinkAnswerThreads, 16 * sms);
#define CTK_LINK_ANSWER(WW, BB)                                                              \
  link_answer_kernel<WW, BB><<<blocks, kLinkAnswerThreads, 0, cuda_stream>>>(                \
      table, rv, of, mask, bs, num_colors, color_mask, static_cast<int*>(ans))
#define CTK_LINK_ANSWER_W(WW) \
  if (vec)                    \
    CTK_LINK_ANSWER(WW, 4);   \
  else                        \
    CTK_LINK_ANSWER(WW, 0)
    CTK_BY_W(CTK_LINK_ANSWER_W)
#undef CTK_LINK_ANSWER_W
#undef CTK_LINK_ANSWER
  }
  return (int)cudaGetLastError();
}

// cur: [batch][w] words (updated); active: batch bytes (updated); flipped:
// batch bytes; slot: batch ints; back: [routed][a_cols] answer ints; saved:
// [batch][w] words, power, lam: batch ints, cycled: batch bytes (updated
// when cycle_check; may be null otherwise); steps: batch ints (updated);
// row: batch bytes out (row `step` of the stream)
extern "C" int ctk_shard_walk_step(void* cur, int batch, int w, int k, void* active,
                                   const void* flipped, const void* slot, const void* back,
                                   int a_cols, void* saved, void* power, void* lam, void* cycled,
                                   void* steps, int cycle_check, void* row,
                                   cudaStream_t cuda_stream) {
  if (batch <= 0 || k < 1 || k > 63 || w != (k + 15) / 16 || a_cols < kWalkAnswer)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((batch + 255) / 256);
#define CTK_WALK_STEP(WW)                                                                    \
  shard_walk_step_kernel<WW><<<blocks, 256, 0, cuda_stream>>>(                               \
      static_cast<uint32_t*>(cur), batch, k, static_cast<uint8_t*>(active),                  \
      static_cast<const uint8_t*>(flipped), static_cast<const int*>(slot),                   \
      static_cast<const int*>(back), a_cols, static_cast<uint32_t*>(saved),                  \
      static_cast<int*>(power), static_cast<int*>(lam), static_cast<uint8_t*>(cycled),       \
      static_cast<int*>(steps), cycle_check, static_cast<int8_t*>(row))
  CTK_BY_W(CTK_WALK_STEP)
#undef CTK_WALK_STEP
  return (int)cudaGetLastError();
}
#undef CTK_BY_W
