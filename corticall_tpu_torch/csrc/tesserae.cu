// Tesserae mosaic-alignment Viterbi DP + traceback, one launch per section,
// on one thread-block cluster (the register form) or on a grid of clusters
// (the wide form, below).
//
// Replaces the device code of corticall_tpu/ops/tesserae_jax.py:
// _tesserae_scan (the lax.scan over query columns), _tesserae_traceback (the
// on-device while_loop) and _tesserae_full (both in one dispatch), which
// TesseraeDevice.align runs for each Call section.  The plain twin is
// corticall_tpu_torch/ops/tesserae_torch.py::tesserae_full; this kernel
// computes the same float32 operations in the same order (nvcc --fmad=false
// keeps every multiply and add separately rounded), so the traceback cells
// are identical and max_r is equal in bits.
//
// What bounds it: the chain of query columns.  Each column needs the
// previous column's global argmax (the recombination value), the previous
// column's cell at j-1 and a prefix max along every target (the delete
// state), so a column cannot start before the last one has been reduced
// over the whole section.  The arithmetic is ~40 instructions a cell and
// the traceback one byte a cell; at the sections Call sends (up to ~66k
// cells a column) both are far below the card's rates, and the time is the
// number of columns times the latency of one column.  Measured on an H100
// (PERF.md, PR 3; corticall_tpu_torch/tools/tesserae_probe.py): 4-11 us a
// column, shared between each thread's dependent chain of per-cell
// arithmetic and the column's exchange and barriers.
//
// Form: one cluster of K CTAs (K <= 16; above 8 the cluster is non-portable)
// owns the section.  The S x W cells are laid out flat (f = s * W + j) and
// each thread owns C consecutive cells (C <= W, so a thread meets at most
// one target boundary), holding their M/I/D state in registers for the
// whole scan.  For each query column:
//   A. every thread computes M and I for its cells from its registers and
//      its left neighbour's last cell of the previous column (the local
//      candidate with first-index argmax, then `local > recomb` strict), the
//      maximum of the delete-scan input over its cells of its last target,
//      and its argmax candidate; warps scan and reduce these by shuffles,
//      warp 0 of each CTA over its warps (one __syncthreads);
//   cluster barrier 1 (see cluster_barrier): each warp reads every CTA's
//      summary through distributed shared memory and finishes the segmented
//      prefix max (a target spans threads, warps and CTAs) and the argmax;
//   B. every thread computes its delete state and its branch bits, and
//      publishes its last cell (M, I, D);
//   cluster barrier 2: each thread reads its left neighbour's last cell
//      (through distributed shared memory across a CTA edge): the branch of
//      its first cell's delete state now, the previous-column values of the
//      next column.
// The traceback is one byte a cell and column (M: recombination or local
// M/I/D; I: recombination or local M/I; D: M or D; positions follow from j)
// plus the column's recombination word `who<<25 | state<<23 | pos`, the only
// place `who` is stored: local moves stay inside one target.  The word is
// 64 bits, so any number of targets fits (the JAX package's int32 word
// reaches the sign bit at 64); up to 63 targets its value is the int32 word's.
// After the last column one thread walks the path, decoding each step into
// the packed word the plain twin reads, and writes (n, max_r, cells[cap, 3]).
//
// The wide form (the same kernel template with GRID true, entry point
// ctk_tesserae_wide) takes the sections past the register form's 16 x 512 x
// 16 = 131,072 cells, up to the most that TesseraeDevice.align's budget gate
// sends to the device (1,064,960 cells: 16,384 targets of at most 64 bases;
// ops/tesserae_torch.gate_max_cells).  The section is spread over a grid of
// G clusters of K CTAs of T threads, every thread kWideCells = 16
// consecutive cells of the flat order held in registers as the register form
// holds them (a run may now cross any number of targets: the Seg summary
// composes across them unchanged), G the fewest clusters that hold the
// section.  The column loop is the register form's, line for line, with two
// global steps:
//   A. after cluster barrier 1 one thread a cluster writes the cluster's Seg
//      and argmax candidate to a slot indexed [col & 1][cluster] and arrives
//      at a grid barrier (a counter in global memory, one release add a
//      cluster, each CTA's thread 0 spinning on an acquire load towards the
//      monotone target col * G); every warp then reads the G summaries and
//      composes the prefix of the clusters before its own and the column's
//      argmax itself (fmaxf and a first-index argmax: exact and associative,
//      so bit-identical to the twin for any G);
//   B. the last thread of each cluster publishes its last cell (M, I, D) to
//      its cluster's edge slot under a release store of the column number,
//      and the first thread of the next cluster spins on it (acquire) after
//      cluster barrier 2: a point-to-point wait, not a second grid barrier.
// The summaries are double-buffered by column parity, so a fast cluster
// cannot overwrite one a slow cluster has not read.  An edge slot needs no
// second buffer: the thread that reads it arrives at the next column's grid
// barrier after the read, and its writer overwrites it only past that
// barrier.  A grid barrier needs every CTA resident: the wrapper sizes the
// launch against cudaOccupancyMaxActiveClusters (ctk_tesserae_wide_info) and
// refuses a grid past it, and every spin traps after kMaxPolls polls, so
// that a co-residency mistake fails the launch rather than hanging it.  The
// traceback layout, the recombination word and the
// walk are the register form's.
//
// The exact form (the register form's template in double, entry point
// ctk_tesserae_f64) takes the sections that TesseraeDevice.align's budget
// gate sends to the exact numpy oracle (models/tesserae.py, float64), where
// the JAX package runs that oracle on the host.  It computes the oracle's
// own operations in the oracle's order: the parameters are the oracle's
// doubles, the delete term ldel + leps*(j-1) is two roundings as numpy's
// (no FMA: --fmad=false), every other line is the float32 forms' own, ties
// fall as np.argmax's (first index wins), and SMALL is -1e32 in double, so
// max_r and the path equal the oracle's.  Positions past the longest target
// (the oracle pads to the query's length too) are never on a path and never
// feed a cell before them, as for the float32 forms.  Its reach is the
// register form's cells at kRegisterCells<double> cells a thread; a gated
// section past it stays on the numpy oracle.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kM = 1, kI = 2, kD = 3;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kNumParams = 9 + 25 + 5;

// The wide form's shape: kWideCells cells a thread, at most kWideThreads
// threads a CTA, and kWideBlocks CTAs an SM under its register cap (65,536
// registers over 3 x 256 threads: 80 a thread); with clusters of 8 CTAs
// (ops/tesserae_torch.wide_config) the fastest shape on the gate's largest
// section (tools/tesserae_probe.py ablate).
constexpr int kWideCells = 16;
constexpr int kWideThreads = 256;
constexpr int kWideBlocks = 3;
// polls of a grid-level spin before it traps: each is an L2 round trip, so
// seconds, where a column waits microseconds
constexpr unsigned kMaxPolls = 1u << 24;

// The value type of a form: float (the float32 forms, bit-equal to the plain
// twin and XLA) or double (the exact form, bit-equal to the numpy oracle).
// SMALL is the oracle's -1e32 in that type.
template <typename T>
constexpr T kSmall = T(-1e32);
template <>
constexpr float kSmall<float> = -1e32f;

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }

// the packed traceback word of the plain twin (models/tesserae.py)
__device__ __forceinline__ long long pack(int who, int state, int pos) {
  return ((long long)who << 25) | ((long long)state << 23) | (long long)pos;
}

// the delete state's constant term ldel + leps*(j-1), rounded once as XLA's
// CPU backend contracts it into an FMA (tesserae_jax.py:63); the one FMA of
// the kernel: --fmad=false keeps every other line two roundings, as in JAX
__device__ __forceinline__ float delete_term(float ldel, float leps, int j) {
  return __fmaf_rn(leps, (float)(j - 1), ldel);
}

// the exact form's: the product and the sum rounded each, as numpy computes
// ldel + leps * (jj - 1) in the oracle (models/tesserae.py::_delete_scan)
__device__ __forceinline__ double delete_term(double ldel, double leps, int j) {
  return ldel + leps * (double)(j - 1);
}

__global__ void delete_term_kernel(const float* params, int W, float* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < W) out[j] = delete_term(params[0], params[1], j);
}

// better (value, flat index): larger value, then smaller index (first argmax)
template <typename T>
__device__ __forceinline__ void take_better(T& v, int& idx, T ov, int oi) {
  if (ov > v || (ov == v && oi < idx)) {
    v = ov;
    idx = oi;
  }
}

// over the first `width` lanes (a power of two); the others hold no candidate
template <typename T>
__device__ __forceinline__ void warp_best(T& v, int& idx, int width = 32) {
  for (int d = width >> 1; d > 0; d >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, d);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, d);
    take_better(v, idx, ov, oi);
  }
}

// Summary of a run of cells for the segmented prefix max of the delete
// state: the first and last target of the run and the maximum over the
// run's cells of its last target.  first < 0: an empty run.
template <typename T>
struct Seg {
  int first, last;
  T v;
};

template <typename T>
__device__ __forceinline__ Seg<T> empty_seg() { return {-1, -1, -INFINITY}; }

// a then b: b's maximum carries a's only when b is one target that a ends in
template <typename T>
__device__ __forceinline__ Seg<T> combine(Seg<T> a, Seg<T> b) {
  if (a.first < 0) return b;
  if (b.first < 0) return a;
  const bool joined = b.first == b.last && a.last == b.first;
  return {a.first, b.last, joined ? vmax(a.v, b.v) : b.v};
}

template <typename T>
__device__ __forceinline__ Seg<T> shfl_up(Seg<T> x, int d) {
  return {__shfl_up_sync(0xffffffffu, x.first, d),
          __shfl_up_sync(0xffffffffu, x.last, d),
          __shfl_up_sync(0xffffffffu, x.v, d)};
}

template <typename T>
__device__ __forceinline__ Seg<T> shfl(Seg<T> x, int lane) {
  return {__shfl_sync(0xffffffffu, x.first, lane), __shfl_sync(0xffffffffu, x.last, lane),
          __shfl_sync(0xffffffffu, x.v, lane)};
}

// inclusive scan over the first `width` lanes of a warp
template <typename T>
__device__ __forceinline__ Seg<T> warp_scan(Seg<T> x, int lane, int width = 32) {
  for (int d = 1; d < width; d <<= 1) {
    const Seg<T> o = shfl_up(x, d);
    if (lane >= d) x = combine(o, x);
  }
  return x;
}

// C traceback bytes to global memory (dst is C-byte aligned)
template <int C>
__device__ __forceinline__ void store_codes(unsigned char* dst, const unsigned (&w)[(C + 3) / 4]) {
  if constexpr (C == 1) {
    *dst = (unsigned char)w[0];
  } else if constexpr (C == 2) {
    *reinterpret_cast<unsigned short*>(dst) = (unsigned short)w[0];
  } else if constexpr (C == 4) {
    *reinterpret_cast<unsigned*>(dst) = w[0];
  } else if constexpr (C == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The cluster barrier of the column loop.  A CTA barrier first makes every
// shared-memory write visible inside the CTA; then only the threads whose
// writes other CTAs read arrive with release semantics, the rest relaxed,
// and all wait with acquire semantics.  `publishes` is uniform in a warp
// (the .aligned forms need the whole warp).  A full cluster.sync() fences
// every thread: 0.37-0.71 us a barrier on an H100 against 0.04-0.06 us with
// relaxed arrivals (tools/tesserae_probe.py barriers).
__device__ __forceinline__ void cluster_barrier(bool publishes) {
  __syncthreads();
  if (publishes) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  } else {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// GPU-scope release add, acquire load and release store: the wide form's
// grid barrier and edge slots
__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Spin until *p >= target (a monotone count: no reset between columns or
// launches of one scratch).  A grid whose CTAs do not all co-reside never
// gets there: the spin traps after kMaxPolls polls instead of hanging.
__device__ __forceinline__ void spin_until(const unsigned* p, unsigned target) {
  unsigned polls = 0;
  while (ld_acquire(p) < target) {
    if (++polls == kMaxPolls) __trap();
  }
}

// The wide form's grid: this CTA's cluster and the number of clusters, and
// the scratch, zero before the launch (int4 blocks; ctk_tesserae_wide_scratch):
// [0].x the barrier's count; [1, 1 + 2G) each cluster's summary (first,
// last, v, argmax value as bits) by column parity, [col & 1][cluster];
// [1 + 2G, 1 + 3G) each cluster's edge into the next (M, I, D as bits, .w
// the column that wrote it); then 2G ints, the argmax indices.
struct Grid {
  int cid, G;
  unsigned* count;
  int4* sum;
  int4* edge;
  int* arg;
};

// Shared memory of the column loop: the warps' and the CTA's summaries and
// argmax candidates, and each thread's last cell (M, I, D) of the column.
template <typename T>
struct Column {
  Seg<T> warp_sum[kMaxWarps];
  Seg<T> warp_carry[kMaxWarps];
  T warp_bv[kMaxWarps];
  int warp_bi[kMaxWarps];
  Seg<T> cta_sum;
  T cta_bv;
  int cta_bi;
  T edge[3][kMaxThreads];
};

// The lanes the CTA-level and cluster-level passes span, and the threads'
// places, for the column loop of either form.
struct Layout {
  int rank, K, T, tid, lane, warp, nwarps, wpow2, kpow2;
};

__device__ __forceinline__ Layout layout(cg::cluster_group& cluster) {
  Layout y;
  y.rank = (int)cluster.block_rank();
  y.K = (int)cluster.num_blocks();
  y.T = blockDim.x;
  y.tid = threadIdx.x;
  y.lane = y.tid & 31;
  y.warp = y.tid >> 5;
  y.nwarps = y.T >> 5;
  y.wpow2 = 1;
  y.kpow2 = 1;
  while (y.wpow2 < y.nwarps) y.wpow2 <<= 1;
  while (y.kpow2 < y.K) y.kpow2 <<= 1;
  return y;
}

// End of pass A: from each thread's run summary `mine` and argmax candidate
// (bv, bi), the summary of every cell before the thread's (the segmented
// exclusive prefix of the delete-scan input) and the column's argmax
// (max_r, best, identical in every thread): warp scans and reductions by
// shuffles, warp 0 of each CTA over its warps (one __syncthreads), then
// cluster barrier 1 and every warp over the CTAs' summaries through
// distributed shared memory, lane r reading CTA r.  The wide form then
// publishes the cluster's summary, passes the grid barrier of column `col`
// and has every warp compose the G clusters' summaries, lane r a run of
// ceil(G / 32) of them.
template <typename T, bool GRID>
__device__ __forceinline__ Seg<T> reduce_column(cg::cluster_group& cluster, Column<T>& sh,
                                                const Layout& y, Seg<T> mine, T bv, int bi,
                                                T& max_r, int& best, const Grid& gr, int col) {
  const Seg<T> incl = warp_scan(mine, y.lane);
  Seg<T> excl = shfl_up(incl, 1);
  if (y.lane == 0) excl = empty_seg<T>();
  warp_best(bv, bi);
  if (y.lane == 31) sh.warp_sum[y.warp] = incl;
  if (y.lane == 0) {
    sh.warp_bv[y.warp] = bv;
    sh.warp_bi[y.warp] = bi;
  }
  __syncthreads();
  if (y.warp == 0) {
    const Seg<T> x = warp_scan(y.lane < y.nwarps ? sh.warp_sum[y.lane] : empty_seg<T>(),
                               y.lane, y.wpow2);
    Seg<T> before = shfl_up(x, 1);
    if (y.lane == 0) before = empty_seg<T>();
    if (y.lane < y.nwarps) sh.warp_carry[y.lane] = before;
    if (y.lane == y.nwarps - 1) sh.cta_sum = x;
    T v = y.lane < y.nwarps ? sh.warp_bv[y.lane] : -INFINITY;
    int idx = y.lane < y.nwarps ? sh.warp_bi[y.lane] : 0x7fffffff;
    warp_best(v, idx, y.wpow2);
    if (y.lane == 0) {
      sh.cta_bv = v;
      sh.cta_bi = idx;
    }
  }
  cluster_barrier(y.warp == 0);

  Seg<T> x = empty_seg<T>();
  T v = -INFINITY;
  int idx = 0x7fffffff;
  if (y.lane < y.K) {
    x = *cluster.map_shared_rank(&sh.cta_sum, y.lane);
    v = *cluster.map_shared_rank(&sh.cta_bv, y.lane);
    idx = *cluster.map_shared_rank(&sh.cta_bi, y.lane);
  }
  x = warp_scan(x, y.lane, y.kpow2);
  warp_best(v, idx, y.kpow2);
  v = __shfl_sync(0xffffffffu, v, 0);
  idx = __shfl_sync(0xffffffffu, idx, 0);
  max_r = v;
  best = idx;
  // the summary of every CTA before this one
  Seg<T> prev_ctas = {__shfl_sync(0xffffffffu, x.first, max(y.rank - 1, 0)),
                      __shfl_sync(0xffffffffu, x.last, max(y.rank - 1, 0)),
                      __shfl_sync(0xffffffffu, x.v, max(y.rank - 1, 0))};
  if (y.rank == 0) prev_ctas = empty_seg<T>();
  if constexpr (GRID) {
    const int par = (col & 1) * gr.G;
    if (y.rank == 0 && y.warp == 0) {
      const Seg<T> total = shfl(x, y.K - 1);
      if (y.lane == 0) {
        gr.sum[par + gr.cid] =
            make_int4(total.first, total.last, __float_as_int(total.v), __float_as_int(v));
        gr.arg[par + gr.cid] = idx;
        red_release_add(gr.count, 1u);
      }
    }
    if (y.tid == 0) spin_until(gr.count, (unsigned)col * (unsigned)gr.G);
    __syncthreads();
    const int per = (gr.G + 31) >> 5;
    Seg<T> s = empty_seg<T>();
    T cv = -INFINITY;
    int ci = 0x7fffffff;
    for (int k = 0; k < per; ++k) {
      const int c = y.lane * per + k;
      if (c < gr.G) {
        const int4 r = __ldcg(&gr.sum[par + c]);
        if (c < gr.cid) s = combine(s, Seg<T>{r.x, r.y, __int_as_float(r.z)});
        take_better(cv, ci, __int_as_float(r.w), __ldcg(&gr.arg[par + c]));
      }
    }
    s = warp_scan(s, y.lane);
    warp_best(cv, ci);
    max_r = cv;
    best = ci;
    prev_ctas = combine(shfl(s, 31), prev_ctas);
  }
  return combine(combine(prev_ctas, sh.warp_carry[y.warp]), excl);
}

// End of pass B: publish this thread's last cell (m, i, d), cluster barrier
// 2, and read the left neighbour's (through distributed shared memory
// across a CTA edge) into left_*; thread 0 of CTA 0 keeps its own.  In the
// wide form the cluster's last thread also publishes its cell to the next
// cluster's edge slot, whose first thread waits for it.
template <typename T, bool GRID>
__device__ __forceinline__ void exchange_edges(cg::cluster_group& cluster, Column<T>& sh,
                                               const Layout& y, T m, T i, T d, T& left_m,
                                               T& left_i, T& left_d, const Grid& gr, int col) {
  sh.edge[0][y.tid] = m;
  sh.edge[1][y.tid] = i;
  sh.edge[2][y.tid] = d;
  if constexpr (GRID) {
    if (y.rank == y.K - 1 && y.tid == y.T - 1 && gr.cid + 1 < gr.G) {
      int4* e = &gr.edge[gr.cid];
      e->x = __float_as_int(m);
      e->y = __float_as_int(i);
      e->z = __float_as_int(d);
      st_release(reinterpret_cast<unsigned*>(&e->w), (unsigned)col);
    }
  }
  cluster_barrier(y.warp == y.nwarps - 1);  // the warp of the edge other CTAs read
  if (y.tid > 0) {
    left_m = sh.edge[0][y.tid - 1];
    left_i = sh.edge[1][y.tid - 1];
    left_d = sh.edge[2][y.tid - 1];
  } else if (y.rank > 0) {
    left_m = cluster.map_shared_rank(&sh.edge[0][0], y.rank - 1)[y.T - 1];
    left_i = cluster.map_shared_rank(&sh.edge[1][0], y.rank - 1)[y.T - 1];
    left_d = cluster.map_shared_rank(&sh.edge[2][0], y.rank - 1)[y.T - 1];
  } else if constexpr (GRID) {
    if (gr.cid > 0) {
      const int4* e = &gr.edge[gr.cid - 1];
      spin_until(reinterpret_cast<const unsigned*>(&e->w), (unsigned)col);
      const int4 v = __ldcg(e);
      left_m = __int_as_float(v.x);
      left_i = __int_as_float(v.y);
      left_d = __int_as_float(v.z);
    }
  }
}

// The head of a launch's output before its cells: n and max_r's bits, then
// (the exact form) a word of padding so that the double's two words follow
// on an 8-byte boundary.
template <typename T>
constexpr int kOutHead = std::is_same<T, double>::value ? 4 : 2;

__device__ __forceinline__ void store_max_r(int* out, float max_r) {
  out[1] = __float_as_int(max_r);
}

__device__ __forceinline__ void store_max_r(int* out, double max_r) {
  out[1] = 0;
  out[2] = __double2loint(max_r);
  out[3] = __double2hiint(max_r);
}

// The traceback (one thread), the while_loop of _tesserae_traceback with
// each packed word rebuilt from its byte code: a flat cell f's byte of
// column pt is codes[pt * npad + f].
template <typename T>
__device__ void walk_path(const unsigned char* codes, int npad, const long long* rec,
                          int L, int S, int W, int best, T max_r, int* out, int cap) {
  const int two_w = 2 * W;
  const int who = best / two_w + 1;
  const int cst = (best % two_w) % 2 == 0 ? kM : kI;
  const int pos = (best % two_w) / 2;
  int* cells = out + kOutHead<T>;
  cells[0] = who;
  cells[1] = cst;
  cells[2] = pos;
  int n = 1, pt = L;
  int w_ = who, s_ = cst, p_ = pos;
  while (pt >= 1 && n < cap) {
    // Python's negative indexing, as the plain twin's tb[..., sidx, pos]
    int sidx = w_ - 1;
    if (w_ < 1) sidx += S;
    if (sidx < 0) sidx += S;
    long long v;
    if ((s_ == kM || s_ == kI) && pt < 2) {
      v = 0;
    } else {
      const unsigned code = codes[(size_t)pt * npad + (size_t)sidx * W + p_];
      if (s_ == kM) {
        const int c = code & 3;
        v = c ? pack(sidx + 1, c, max(p_ - 1, 0)) : rec[pt - 1];
      } else if (s_ == kI) {
        const int c = (code >> 2) & 3;
        v = c ? pack(sidx + 1, c, p_) : rec[pt - 1];
      } else {
        v = pack(sidx + 1, (code & 16) ? kD : kM, max(p_ - 1, 0));
      }
    }
    const int wn = (int)(v >> 25), sn = (int)((v >> 23) & 3), pn = (int)(v & ((1 << 23) - 1));
    cells[3 * n] = wn;
    cells[3 * n + 1] = sn;
    cells[3 * n + 2] = pn;
    ++n;
    if (s_ != kD) --pt;
    w_ = wn;
    s_ = sn;
    p_ = pn;
  }
  out[0] = n;
  store_max_r(out, max_r);
}

// the column's recombination word, from its argmax
__device__ __forceinline__ long long rec_word(int best, int W) {
  const int two_w = 2 * W;
  return pack(best / two_w + 1, (best % two_w) % 2 == 0 ? kM : kI, (best % two_w) / 2);
}

// Every form: GRID false is the register form (one cluster, C <= W, so a
// thread's run meets at most one target boundary), GRID true the wide form
// (a grid of clusters; a run may cross any number of targets, so a cell's
// position steps a cell at a time).  The per-cell arithmetic is the same
// lines in the same order in both.  T is the value type: float for both
// float32 forms, double for the exact form (the register form in float64:
// its parameters the oracle's doubles, its delete term two roundings, every
// other line the float32 forms' own, so that each sum, comparison and tie
// falls as in the numpy oracle and max_r and the path equal its own).
template <typename T, int C, bool GRID>
__global__ void __launch_bounds__(GRID ? kWideThreads : kMaxThreads, GRID ? kWideBlocks : 1)
tesserae_kernel(const int* __restrict__ q, const int* __restrict__ t_codes,
                const unsigned char* __restrict__ valid,
                const T* __restrict__ params, int L, int S, int W, int npad,
                unsigned char* __restrict__ codes, long long* __restrict__ rec,
                int* __restrict__ out, int cap, int4* __restrict__ scratch) {
  static_assert(C == 1 || C == 2 || C == 4 || C == 8 || C == 16, "C: 1..16, a power of two");
  static_assert(!GRID || std::is_same<T, float>::value, "the wide form is float32 only");
  __shared__ T prm[kNumParams];
  __shared__ Column<T> sh;

  cg::cluster_group cluster = cg::this_cluster();
  const Layout y = layout(cluster);
  const int rank = y.rank, nt = y.T, tid = y.tid;
  Grid gr = {0, 1, nullptr, nullptr, nullptr, nullptr};
  if constexpr (GRID) {
    gr.G = (int)gridDim.x / y.K;
    gr.cid = (int)blockIdx.x / y.K;
    gr.count = reinterpret_cast<unsigned*>(scratch);
    gr.sum = scratch + 1;
    gr.edge = scratch + 1 + 2 * gr.G;
    gr.arg = reinterpret_cast<int*>(scratch + 1 + 3 * gr.G);
  }
  // the thread that writes the recombination words and walks the path
  const bool lead = gr.cid == 0 && rank == 0 && tid == 0;
  for (int x = tid; x < kNumParams; x += nt) prm[x] = params[x];
  __syncthreads();
  const T ldel = prm[0], leps = prm[1], lrho = prm[2], lpiM = prm[3],
          lpiI = prm[4], lmm = prm[5], lgm = prm[6], ldm = prm[7],
          lsize_l = prm[8];
  const T* lsm = prm + 9;   // [5][5]
  const T* lsi = prm + 34;  // [5]

  // this thread's cells: flat f0 .. f0 + C - 1 of N = S * W
  const int N = S * W;
  const int f0 = ((gr.cid * y.K + rank) * nt + tid) * C;
  const int s0 = f0 / W, j0 = f0 % W;
  unsigned vbits = 0;              // cell i valid: j >= 1 and valid[s][j-1]
  unsigned long long tbits = 0;    // cell i's target code, 4 bits a cell
  int ncells = 0;                  // cells below N
  {
    int s = s0, j = j0;            // the wide form's position, a cell at a time
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if constexpr (!GRID) {
        j = j0 + i;
        s = s0;
        if (j >= W) { j -= W; ++s; }
      }
      if (f0 + i < N) {
        ncells = i + 1;
        if (j >= 1) {
          const size_t at = (size_t)s * (W - 1) + (j - 1);
          if (valid[at]) vbits |= 1u << i;
          tbits |= (unsigned long long)(t_codes[at] & 15) << (4 * i);
        }
      }
      if constexpr (GRID) {
        if (++j == W) { j = 0; ++s; }
      }
    }
  }

  T vm[C], vi[C], vd[C];
#pragma unroll
  for (int i = 0; i < C; ++i) vm[i] = vi[i] = vd[i] = kSmall<T>;
  // the left neighbour's last cell of the previous column
  T left_m = kSmall<T>, left_i = kSmall<T>, left_d = kSmall<T>;
  // column argmax carried into the next column (identical in every thread)
  T max_r = 0;
  int best = 0;

  for (int col = 1; col <= L; ++col) {
    const int qc = q[col - 1];
    const bool first = col == 1;
    const int min_j = first ? 1 : 2;
    const T recomb = ((max_r + lrho) + lpiM) - lsize_l;
    const T recomb_i = ((max_r + lrho) + lpiI) - lsize_l;
    const T* em = lsm + qc * 5;
    const T emi = lsi[qc];
    unsigned w[(C + 3) / 4];
#pragma unroll
    for (int x = 0; x < (C + 3) / 4; ++x) w[x] = 0;

    // ---- A. M and I, the delete-scan input's maximum, the argmax candidate
    T bv = -INFINITY;
    int bi = 0x7fffffff;
    T pm_l = left_m, pi_l = left_i, pd_l = left_d;  // previous column, j-1
    Seg<T> mine = empty_seg<T>();
    {
      int s = s0, j = j0;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (i < ncells) {
          if constexpr (!GRID) {
            j = j0 + i;
            s = s0;
            if (j >= W) { j -= W; ++s; }
          }
          const bool ok = (vbits >> i) & 1u;
          const int t = (int)((tbits >> (4 * i)) & 15);
          const T om = vm[i], oi = vi[i];
          T m, v;
          if (first) {
            m = ok ? (lpiM - lsize_l) + em[t] : kSmall<T>;
            v = ok ? (lpiI - lsize_l) + emi : kSmall<T>;
          } else {
            // local M: (M, I, D) at (j-1, previous column), first max wins
            const T c0 = (j >= 1 ? pm_l : kSmall<T>) + lmm;
            const T c1 = (j >= 1 ? pi_l : kSmall<T>) + lgm;
            const T c2 = (j >= 1 ? pd_l : kSmall<T>) + ldm;
            T lval = c0;
            int larg = 0;
            if (c1 > lval) { lval = c1; larg = 1; }
            if (c2 > lval) { lval = c2; larg = 2; }
            const bool use_local = lval > recomb;
            m = use_local ? lval : recomb;
            m = (j == 0) ? kSmall<T> : (ok ? m + em[t] : kSmall<T>);
            // I: (M, I) at (j, previous column)
            const T i0 = om + ldel, i1 = oi + leps;
            const int iarg = (i1 > i0) ? 1 : 0;
            const T ival = iarg ? i1 : i0;
            const bool use_i = ival > recomb_i;
            v = use_i ? ival : recomb_i;
            v = (j == 0) ? kSmall<T> : (ok ? v + emi : kSmall<T>);
            const unsigned code = (use_local ? (unsigned)(larg + 1) : 0u) |
                                  ((use_i ? (unsigned)(iarg + 1) : 0u) << 2);
            w[i / 4] |= code << (8 * (i % 4));
          }
          pm_l = om;
          pi_l = oi;
          pd_l = vd[i];
          vm[i] = m;
          vi[i] = v;
          // a thread meets its candidates in increasing flat index (M before
          // I), so a strictly larger value is the only way to replace one
          const T cm = ok ? m : kSmall<T>, ci = ok ? v : kSmall<T>;
          const bool take_i = ci > cm;
          const T cv = take_i ? ci : cm;
          if (cv > bv) {
            bv = cv;
            bi = 2 * (f0 + i) + (take_i ? 1 : 0);
          }
          const T adj = (j >= min_j - 1) ? m - leps * (T)j : kSmall<T>;
          if (mine.first < 0) mine.first = s;
          if (s != mine.last) { mine.last = s; mine.v = -INFINITY; }
          mine.v = vmax(mine.v, adj);
          if constexpr (GRID) {
            if (++j == W) { j = 0; ++s; }
          }
        }
      }
    }
    const Seg<T> excl = reduce_column<T, GRID>(cluster, sh, y, mine, bv, bi, max_r, best, gr, col);

    // ---- B. delete state vd[j] = ldel + leps*(j-1) + max_{t<j} adj[t] and
    // its branch (M if nvm[j-1] + ldel >= vd[j-1] + leps)
    {
      T run = (excl.first >= 0 && excl.last == s0) ? excl.v : -INFINITY;
      int j = j0;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (i < ncells) {
          if constexpr (!GRID) {
            j = j0 + i;
            if (j >= W) j -= W;
          }
          const T m = vm[i];
          const T adj = (j >= min_j - 1) ? m - leps * (T)j : kSmall<T>;
          if (j == 0) run = -INFINITY;
          const T run_prev = (j == 0) ? kSmall<T> : run;
          const T d = (j >= min_j) ? delete_term(ldel, leps, j) + run_prev : kSmall<T>;
          run = vmax(run, adj);
          if (i > 0) {
            const T mb = (j == 0 ? kSmall<T> : vm[i > 0 ? i - 1 : 0]) + ldel;
            const T db = (j == 0 ? kSmall<T> : vd[i > 0 ? i - 1 : 0]) + leps;
            if (!(mb >= db)) w[i / 4] |= 16u << (8 * (i % 4));
          }
          vd[i] = d;
          if constexpr (GRID) {
            if (++j == W) j = 0;
          }
        }
      }
    }
    exchange_edges<T, GRID>(cluster, sh, y, vm[C - 1], vi[C - 1], vd[C - 1], left_m, left_i,
                         left_d, gr, col);
    if (ncells > 0) {
      const T mb = (j0 == 0 ? kSmall<T> : left_m) + ldel;
      const T db = (j0 == 0 ? kSmall<T> : left_d) + leps;
      if (!(mb >= db)) w[0] |= 16u;
      store_codes<C>(codes + (size_t)col * npad + f0, w);
    }
    if (lead) rec[col] = rec_word(best, W);
  }

  // ---- traceback, once every thread's codes are out: a cluster barrier,
  // and in the wide form one more grid arrival that only the walker awaits
  __threadfence();
  cluster.sync();
  if constexpr (GRID) {
    if (rank == 0 && tid == 0) {
      red_release_add(gr.count, 1u);
      if (gr.cid == 0) spin_until(gr.count, (unsigned)(L + 1) * (unsigned)gr.G);
    }
  }
  if (lead) walk_path(codes, npad, rec, L, S, W, best, max_r, out, cap);
}

// the kernel of each form for `cells` a thread (null: not one it takes)
template <typename T>
using TesseraeFn = void (*)(const int*, const int*, const unsigned char*, const T*, int, int,
                            int, int, unsigned char*, long long*, int*, int, int4*);

// The most cells a thread of the register form in each value type: 16 in
// float32; in float64 the most that compile without spills under the 128
// registers of 512 threads (three doubles a cell, two registers each): 4, at
// 128 registers, where 8 spill 216 bytes (H100).  tesserae_torch.py's
// EXACT_CELLS_PER_THREAD is the float64 value; ctk_tesserae_f64_info refuses
// past it, which the card's tests check
template <typename T>
constexpr int kRegisterCells = std::is_same<T, double>::value ? 4 : 16;

template <typename T>
TesseraeFn<T> register_kernel(int cells) {
  if (cells > kRegisterCells<T>) return nullptr;
  switch (cells) {
    case 1: return tesserae_kernel<T, 1, false>;
    case 2: return tesserae_kernel<T, 2, false>;
    case 4: return tesserae_kernel<T, 4, false>;
    case 8:
      if constexpr (kRegisterCells<T> >= 8) return tesserae_kernel<T, 8, false>;
      return nullptr;
    case 16:
      if constexpr (kRegisterCells<T> >= 16) return tesserae_kernel<T, 16, false>;
      return nullptr;
    default: return nullptr;
  }
}

TesseraeFn<float> wide_kernel(int cells) {
  if (cells != kWideCells) return nullptr;
  return tesserae_kernel<float, kWideCells, true>;
}

// a launch configuration of `clusters` clusters of `cluster` CTAs of
// `threads` threads on `stream` (above 8 CTAs the cluster is non-portable)
template <typename T>
cudaError_t cluster_config(TesseraeFn<T> kernel, int clusters, int cluster, int threads,
                           cudaStream_t stream, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  if (cluster > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = dim3(clusters * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// the clusters of this shape that the card holds at once (0 on an error)
int max_clusters(TesseraeFn<float> kernel, int cluster, int threads) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  if (cluster_config(kernel, 1, cluster, threads, nullptr, cfg, attr) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return 0;
  return n;
}

// a kernel's registers and local (spilled) bytes a thread and static shared
// bytes a CTA into out[0], out[1] and out[2]
template <typename T>
cudaError_t kernel_attributes(TesseraeFn<T> kernel, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  return cudaSuccess;
}

template <typename T>
int launch(TesseraeFn<T> kernel, int clusters, int cluster, int threads, cudaStream_t stream,
           const int* q, const int* t_codes, const unsigned char* valid, const T* params,
           int L, int S, int W, int npad, unsigned char* codes, long long* rec, int* out,
           int cap, int4* scratch) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, clusters, cluster, threads, stream, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, q, t_codes, valid, params, L, S, W, npad, codes, rec,
                           out, cap, scratch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool bad_shape(int L, int S, int W, int cells, int clusters, int cluster, int threads, int npad,
               int cap) {
  const long long n = (long long)S * W;
  return threads <= 0 || threads > kMaxThreads || threads % 32 || cluster < 1 ||
         cluster > kMaxCluster || clusters < 1 || S < 1 || L < 1 || W < 2 || cells < 1 ||
         cap < 1 || npad % 16 || npad < n ||
         (long long)clusters * cluster * threads * cells < n;
}

// the register form in value type T: one cluster
template <typename T>
int register_launch(const int* q, const int* t_codes, const unsigned char* valid,
                    const T* params, int L, int S, int W, int cells, int cluster, int threads,
                    unsigned char* codes, int npad, long long* rec, int* out, int cap,
                    cudaStream_t stream) {
  const TesseraeFn<T> kernel = register_kernel<T>(cells);
  if (!kernel || bad_shape(L, S, W, cells, 1, cluster, threads, npad, cap) || cells > W)
    return (int)cudaErrorInvalidValue;
  return launch(kernel, 1, cluster, threads, stream, q, t_codes, valid, params, L, S, W, npad,
                codes, rec, out, cap, nullptr);
}

}  // namespace

// One section: `cluster` CTAs of `threads` threads, `cells` cells a thread
// (a power of two up to 16, at most W); codes uint8[L+1, npad] with npad a
// multiple of 16 and at least S*W; rec int64[L+1]; out int32[2 + 3*cap].
extern "C" int ctk_tesserae(const int* q, const int* t_codes,
                            const unsigned char* valid, const float* params,
                            int L, int S, int W, int cells, int cluster,
                            int threads, unsigned char* codes, int npad,
                            long long* rec, int* out, int cap, cudaStream_t stream) {
  return register_launch(q, t_codes, valid, params, L, S, W, cells, cluster, threads, codes,
                         npad, rec, out, cap, stream);
}

// The exact form: ctk_tesserae in float64, for the sections that
// TesseraeDevice.align's budget gate sends to the numpy oracle.  params are
// the oracle's 9 + 25 + 5 doubles; `cells` a power of two up to
// kRegisterCells<double>; out int32[4 + 3*cap]: n, a padding word, max_r as
// a double, then the cells.
extern "C" int ctk_tesserae_f64(const int* q, const int* t_codes,
                                const unsigned char* valid, const double* params,
                                int L, int S, int W, int cells, int cluster,
                                int threads, unsigned char* codes, int npad,
                                long long* rec, int* out, int cap, cudaStream_t stream) {
  return register_launch(q, t_codes, valid, params, L, S, W, cells, cluster, threads, codes,
                         npad, rec, out, cap, stream);
}

// The wide form of ctk_tesserae: `clusters` clusters of `cluster` CTAs of
// `threads` threads (at most 256), `cells` = 16 cells a thread (any W);
// codes, rec and out as ctk_tesserae's; scratch: int32 words, as
// ctk_tesserae_wide_scratch gives them, zero before the launch.  The caller
// keeps `clusters` within what the card holds at once
// (ctk_tesserae_wide_info's out[2]); past it the grid barrier cannot open
// and its spin traps.
extern "C" int ctk_tesserae_wide(const int* q, const int* t_codes,
                                 const unsigned char* valid, const float* params,
                                 int L, int S, int W, int cells, int clusters, int cluster,
                                 int threads, unsigned char* codes, int npad,
                                 long long* rec, int* scratch, int* out, int cap,
                                 cudaStream_t stream) {
  const TesseraeFn<float> kernel = wide_kernel(cells);
  if (!kernel || threads > kWideThreads ||
      bad_shape(L, S, W, cells, clusters, cluster, threads, npad, cap) ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  return launch(kernel, clusters, cluster, threads, stream, q, t_codes, valid, params, L, S, W,
                npad, codes, rec, out, cap, reinterpret_cast<int4*>(scratch));
}

// The scratch ctk_tesserae_wide needs for `clusters` clusters, in int32
// words (Grid's layout).
extern "C" int ctk_tesserae_wide_scratch(int clusters) {
  return 4 * (1 + 3 * clusters) + 2 * clusters;
}

// How the wide form's kernel for `cells` a thread runs at `cluster` CTAs of
// `threads` threads: out[0] registers a thread, out[1] local (spilled) bytes
// a thread, out[2] the clusters the card holds at once, out[3] static shared
// bytes a CTA.
extern "C" int ctk_tesserae_wide_info(int cells, int cluster, int threads, int* out) {
  const TesseraeFn<float> kernel = wide_kernel(cells);
  if (!kernel || threads < 32 || threads > kWideThreads || threads % 32 || cluster < 1 ||
      cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  int attrs[3];
  const cudaError_t err = kernel_attributes(kernel, attrs);
  if (err != cudaSuccess) return (int)err;
  out[0] = attrs[0];
  out[1] = attrs[1];
  out[2] = max_clusters(kernel, cluster, threads);
  out[3] = attrs[2];
  return (int)cudaGetLastError();
}

// ctk_tesserae_f64's kernel for `cells` a thread (invalid past
// kRegisterCells<double>): out[0] registers a thread, out[1] local (spilled)
// bytes a thread, out[2] static shared bytes a CTA.
extern "C" int ctk_tesserae_f64_info(int cells, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (const TesseraeFn<double> kernel = register_kernel<double>(cells))
    err = kernel_attributes(kernel, out);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The delete term of ctk_tesserae for j = 0 .. W-1 (out float32[W]), from
// the same params (ldel, leps first), for the tests that hold it to the
// plain twin's tesserae_torch.delete_term.
extern "C" int ctk_tesserae_delete_term(const float* params, int W, float* out,
                                        cudaStream_t stream) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  delete_term_kernel<<<(W + 255) / 256, 256, 0, stream>>>(params, W, out);
  return (int)cudaGetLastError();
}
