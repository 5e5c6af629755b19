// Packed k-mer bit primitives shared by the kernels (ops/kmer.py is their
// plain PyTorch twin).  Words are uint32 bit patterns; a k-mer is
// W = ceil(k/16) <= 4 right-aligned words, word 0 most significant, held in
// registers, so every kernel that takes k-mers is instantiated for W = 1..4.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kTag = 0x80000000u;     // a bucket entry's tag: occupied
constexpr uint32_t kGolden = 0x9E3779B9u;  // the second bucket's hash salt
constexpr unsigned kFullMask = 0xFFFFFFFFu;  // every lane of a warp

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

// lowest set base of a 4-bit mask; 3 for an empty mask, as kmer_jax gives
__device__ __forceinline__ uint32_t lowest_set_base(uint32_t mask) {
  return (mask & 1u) ? 0u : (mask & 2u) ? 1u : (mask & 4u) ? 2u : 3u;
}

// The payload of one bucket entry (key words..., tag) if it is occupied and
// holds the key, else 0.
template <int W>
__device__ __forceinline__ uint32_t entry_payload(const uint32_t* __restrict__ ent,
                                                  const uint32_t (&canon)[W]) {
  const uint32_t tag = __ldg(ent + W);
  bool match = tag >= kTag;
#pragma unroll
  for (int j = 0; j < W; ++j) match = match && __ldg(ent + j) == canon[j];
  return match ? tag & 0x7FFFFFFFu : 0u;
}

// The one-gather cuckoo lookup (corticall_tpu/ops/cuckoo.py::lookup_payload,
// line 190) by a whole warp: buckets [NB][bs][W+1] words, an entry (key
// words..., tag), tag = 0x80000000 | payload.  Lane e reads entry e of the
// pair (primary bucket h, then second bucket mix32(h ^ kGolden)), both
// buckets always, as the gather does; the payload is the maximum over the
// entries holding the key (0: a miss), the same in every lane.  Every lane of
// the warp must call it.
template <int W>
__device__ __forceinline__ uint32_t warp_lookup_payload(const uint32_t* __restrict__ buckets,
                                                        uint32_t nb_mask, int bs,
                                                        const uint32_t (&canon)[W], int lane) {
  const uint32_t h = hash_words<W>(canon);
  const uint32_t b1 = h & nb_mask, b2 = mix32(h ^ kGolden) & nb_mask;
  uint32_t best = 0u;
  for (int e = lane; e < 2 * bs; e += 32)
    best = max(best, entry_payload<W>(
        buckets + ((size_t)(e < bs ? b1 : b2) * bs + (e < bs ? e : e - bs)) * (W + 1), canon));
  return __reduce_max_sync(kFullMask, best);
}

// The same lookup by one thread (a query a thread, as the shard's answer
// makes it): both candidate buckets, every entry; the payload is the largest
// among the entries holding the key (0: a miss).
template <int W>
__device__ __forceinline__ uint32_t thread_lookup_payload(const uint32_t* __restrict__ buckets,
                                                          uint32_t nb_mask, int bs,
                                                          const uint32_t (&canon)[W]) {
  const uint32_t h = hash_words<W>(canon);
  const uint32_t b1 = h & nb_mask, b2 = mix32(h ^ kGolden) & nb_mask;
  uint32_t best = 0u;
  for (int e = 0; e < 2 * bs; ++e)
    best = max(best, entry_payload<W>(
        buckets + ((size_t)(e < bs ? b1 : b2) * bs + (e < bs ? e : e - bs)) * (W + 1), canon));
  return best;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace
