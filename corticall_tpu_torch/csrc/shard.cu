// The hash-sharded graph's kernels: routing, a shard's answer, the walk step.
//
// Replace the XLA device code of corticall_tpu/parallel/mesh.py:
//   ctk_route           <- kmer_jax.canonicalize_words (:310, :422, :574)
//                          and the routing half of _routed_exchange
//                          (:111-118): the owner, the per-owner counts and
//                          each query's place in a send buffer packed by
//                          owner (the argsort / searchsorted packing);
//   ctk_shard_answer    <- the local answer of sharded_lookup_fn /
//                          sharded_lookup_tree_fn (:180-185, :205-209):
//                          cuckoo.lookup_payload (corticall_tpu/ops/
//                          cuckoo.py:190) and the payload gathers (the
//                          combined edge byte, :278-284, :407-413,
//                          :559-565; the link rows, :285-292);
//   ctk_shard_walk_step <- the walk step of :419-438 (Brent's cycle test)
//                          and :568-583 (the plain advance), with the
//                          unsort of the answers (:163-165).
// Plain PyTorch twins: corticall_tpu_torch/ops/sharding.py.
//
// One thread a query (a walk).  ctk_route runs two passes: the first
// canonicalizes, hashes and counts the routed queries by owner (a shared-
// memory histogram a block, one global atomic an owner a block); the second
// takes each owner's block start as an exclusive scan of the n counts, and
// each routed query's slot as that start plus its block's share of an
// atomic cursor plus its rank in the block (a shared atomic), and writes its
// canonical words there.  The order within an owner's block follows the
// atomics and may vary between runs; every answer returns to its asker
// through the slot.  The shard's answer probes both candidate buckets (kmer
// .cuh::thread_lookup_payload), ORs the walk colours' edge bytes and, for
// the linked walk, copies the record's first MAX_ADD link rows (zero past
// its count).  The walk step reads its answer row by the walk's slot.
//
// What bounds them on this card: bytes.  Each moves a few words a query and
// does a few hundred integer operations; the answer's and the step's reads
// are random (the bucket pair, the record's edge bytes and CSR, the answer
// row), so the lever is queries in flight (256-thread blocks, few
// registers).

#include "kmer.cuh"
#include "shard_answer.cuh"

namespace {

constexpr int kMaxShards = 64;  // sharding.MAX_SHARDS

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

template <int W>
__global__ void __launch_bounds__(256)
route_count_kernel(const uint32_t* __restrict__ cur, int batch, int k, int n,
                   const uint8_t* __restrict__ active, int* __restrict__ owner,
                   uint8_t* __restrict__ flipped, int* __restrict__ counts) {
  __shared__ int local[kMaxShards];
  for (int j = threadIdx.x; j < n; j += blockDim.x) local[j] = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < batch) {
    uint32_t canon[W];
    flipped[i] = load_canonical<W>(cur, i, k, canon);
    const int o = (int)(routing_hash<W>(canon) % (uint32_t)n);
    owner[i] = o;
    if (active == nullptr || active[i]) atomicAdd(local + o, 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    if (local[j]) atomicAdd(counts + j, local[j]);
}

template <int W>
__global__ void __launch_bounds__(256)
route_place_kernel(const uint32_t* __restrict__ cur, int batch, int k, int n,
                   const uint8_t* __restrict__ active, const int* __restrict__ owner,
                   const int* __restrict__ counts, int* __restrict__ cursor,
                   uint32_t* __restrict__ send, int* __restrict__ slot) {
  __shared__ int start[kMaxShards], local[kMaxShards], base[kMaxShards];
  if (threadIdx.x == 0) {
    int s = 0;
    for (int j = 0; j < n; ++j) {
      start[j] = s;
      s += counts[j];
    }
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) local[j] = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool routed = i < batch && (active == nullptr || active[i]);
  int o = 0, rank = 0;
  if (routed) {
    o = owner[i];
    rank = atomicAdd(local + o, 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    base[j] = local[j] ? atomicAdd(cursor + j, local[j]) : 0;
  __syncthreads();
  if (i >= batch) return;
  if (!routed) {
    slot[i] = -1;
    return;
  }
  const int p = start[o] + base[o] + rank;
  slot[i] = p;
  uint32_t canon[W];
  load_canonical<W>(cur, i, k, canon);
#pragma unroll
  for (int j = 0; j < W; ++j) send[(size_t)p * W + j] = canon[j];
}

template <int W>
__global__ void __launch_bounds__(256)
shard_answer_kernel(const uint32_t* __restrict__ recv, int r, const uint32_t* __restrict__ buckets,
                    uint32_t nb_mask, int bs, const uint8_t* __restrict__ edges, int num_colors,
                    uint32_t color_mask, const int* __restrict__ link_off,
                    const uint2* __restrict__ link_choices, const int* __restrict__ link_len,
                    const uint8_t* __restrict__ link_fw, int num_links, int* __restrict__ ans,
                    int a_cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  uint32_t q[W];
#pragma unroll
  for (int j = 0; j < W; ++j) q[j] = __ldg(recv + (size_t)i * W + j);
  const int rec = (int)thread_lookup_payload<W>(buckets, nb_mask, bs, q) - 1;
  uint32_t edge = 0u;
  if (rec >= 0)
    for (int c = 0; c < num_colors; ++c)
      if ((color_mask >> c) & 1u) edge |= __ldg(edges + (size_t)rec * num_colors + c);
  int* row = ans + (size_t)i * a_cols;
  row[kAnsRec] = rec;
  row[kAnsEdge] = (int)edge;
  if (link_off == nullptr) return;
  int off = 0, cnt = 0;
  if (rec >= 0) {
    off = __ldg(link_off + rec);
    cnt = __ldg(link_off + rec + 1) - off;
  }
  row[kAnsCnt] = cnt;
  const int take = min(cnt, kMaxAdd);
  for (int j = 0; j < kMaxAdd; ++j) {
    uint2 ch = make_uint2(0u, 0u);
    int len = 0, fw = 0;
    if (j < take) {  // rows past the pool cannot be read: the JAX clamp
      const int src = min(off + j, num_links - 1);
      ch = __ldg(link_choices + src);
      len = __ldg(link_len + src);
      fw = __ldg(link_fw + src);
    }
    row[kAnsChoices + 2 * j] = (int)ch.x;
    row[kAnsChoices + 2 * j + 1] = (int)ch.y;
    row[kAnsLen + j] = len;
    row[kAnsFw + j] = fw;
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
  int8_t e = -1;
  if (active[i]) {  // an active walk is always routed
    const int* a = back + (size_t)slot[i] * a_cols;
    const int rec = __ldg(a + kAnsRec);
    const uint32_t edge = (uint32_t)__ldg(a + kAnsEdge);
    const uint32_t next_mask = (flipped[i] ? edge >> 4 : edge) & 0xFu;
    const uint32_t base = lowest_set_base(next_mask);
    uint32_t c[W], nxt[W];
#pragma unroll
    for (int j = 0; j < W; ++j) c[j] = cur[(size_t)i * W + j];
    shift_append<W>(c, base, k, nxt);
    const bool single = __popc(next_mask) == 1 && rec >= 0;
    bool is_cycle = false;
    if (cycle_check && single) {
      is_cycle = true;
#pragma unroll
      for (int j = 0; j < W; ++j) is_cycle = is_cycle && saved[(size_t)i * W + j] == nxt[j];
    }
    const bool advance = single && !is_cycle;
    if (advance) {
#pragma unroll
      for (int j = 0; j < W; ++j) cur[(size_t)i * W + j] = nxt[j];
      steps[i] += 1;
      e = (int8_t)base;
    }
    if (cycle_check) {
      const bool teleport = advance && power[i] == lam[i];
      if (teleport) {
#pragma unroll
        for (int j = 0; j < W; ++j) saved[(size_t)i * W + j] = nxt[j];
        power[i] *= 2;
      }
      if (advance) lam[i] = teleport ? 1 : lam[i] + 1;
      if (is_cycle) cycled[i] = 1;
    }
    active[i] = advance;
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

// cur: [batch][w] walk-oriented words; active: batch bytes or null (route
// every query); send: [batch][w] words out (the first sum(counts) rows
// written); slot, owner: batch ints out; flipped: batch bytes out; counts:
// n ints out; cursor: n ints of scratch
extern "C" int ctk_route(const void* cur, int batch, int w, int k, int n, const void* active,
                         void* send, void* slot, void* owner, void* flipped, void* counts,
                         void* cursor, cudaStream_t cuda_stream) {
  if (batch < 0 || n < 1 || n > kMaxShards || k < 1 || k > 63 || w != (k + 15) / 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * n, cuda_stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(cursor, 0, sizeof(int) * n, cuda_stream);
  if (err != cudaSuccess || batch == 0) return (int)err;
  const unsigned blocks = (unsigned)((batch + 255) / 256);
  const uint32_t* cu = static_cast<const uint32_t*>(cur);
  const uint8_t* ac = static_cast<const uint8_t*>(active);
  int* ow = static_cast<int*>(owner);
  int* co = static_cast<int*>(counts);
#define CTK_ROUTE(WW)                                                                          \
  route_count_kernel<WW><<<blocks, 256, 0, cuda_stream>>>(cu, batch, k, n, ac, ow,             \
                                                          static_cast<uint8_t*>(flipped), co); \
  route_place_kernel<WW><<<blocks, 256, 0, cuda_stream>>>(                                     \
      cu, batch, k, n, ac, ow, co, static_cast<int*>(cursor), static_cast<uint32_t*>(send),   \
      static_cast<int*>(slot))
  CTK_BY_W(CTK_ROUTE)
#undef CTK_ROUTE
  return (int)cudaGetLastError();
}

// recv: [r][w] canonical words; buckets: [nb][bs][w + 1] words (payload =
// shard-local record + 1); edges: [records][num_colors] bytes; link_off ...
// link_fw: the shard's link CSR (link_off null: no link columns), choices 8-
// byte aligned; ans: [r][a_cols] ints out
extern "C" int ctk_shard_answer(const void* recv, int r, int w, const void* buckets, int nb,
                                int bs, const void* edges, int num_colors, unsigned color_mask,
                                const void* link_off, const void* link_choices,
                                const void* link_len, const void* link_fw, int num_links,
                                void* ans, int a_cols, cudaStream_t cuda_stream) {
  if (r <= 0 || w < 1 || w > 4 || !pow2(nb) || bs < 1 || num_colors < 1 || num_colors > 32 ||
      a_cols < (link_off ? kLinkAnswer : kWalkAnswer) || (link_off && num_links < 1) ||
      reinterpret_cast<uintptr_t>(link_choices) % 8)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((r + 255) / 256);
#define CTK_ANSWER(WW)                                                                       \
  shard_answer_kernel<WW><<<blocks, 256, 0, cuda_stream>>>(                                  \
      static_cast<const uint32_t*>(recv), r, static_cast<const uint32_t*>(buckets),          \
      (uint32_t)nb - 1u, bs, static_cast<const uint8_t*>(edges), num_colors, color_mask,     \
      static_cast<const int*>(link_off), static_cast<const uint2*>(link_choices),            \
      static_cast<const int*>(link_len), static_cast<const uint8_t*>(link_fw), num_links,    \
      static_cast<int*>(ans), a_cols)
  CTK_BY_W(CTK_ANSWER)
#undef CTK_ANSWER
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
