// Tesserae mosaic-alignment Viterbi DP + traceback, one launch per section,
// on one thread-block cluster.
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
// The wide form (tesserae_wide_kernel) takes the sections past the register
// form's 16 x 512 x 16 = 131,072 cells, up to the most that
// TesseraeDevice.align's budget gate sends to the device (1,064,960 cells:
// 16,384 targets of at most 64 bases; ops/tesserae_torch.gate_max_cells).
// It is a repair, not a redesign: the same cluster, passes, barriers and
// arithmetic in the same order, but each thread owns C = ceil(S*W / 8192)
// consecutive cells of any number of targets, and their M/I/D state lives in
// global memory (at most 12.8 MB, which stays in the 50 MB L2).  The state,
// each cell's target code and validity, and a column's traceback bytes are
// stored cell-major across the threads (thread g's i-th cell at i*NT + g),
// so that a warp's loads and stores of its lanes' i-th cells are coalesced;
// the traceback walk maps a flat cell f to (f % C) * NT + f / C.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kSmall = -1e32f;
constexpr int kM = 1, kI = 2, kD = 3;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kNumParams = 9 + 25 + 5;

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

__global__ void delete_term_kernel(const float* params, int W, float* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < W) out[j] = delete_term(params[0], params[1], j);
}

// better (value, flat index): larger value, then smaller index (first argmax)
__device__ __forceinline__ void take_better(float& v, int& idx, float ov, int oi) {
  if (ov > v || (ov == v && oi < idx)) {
    v = ov;
    idx = oi;
  }
}

// over the first `width` lanes (a power of two); the others hold no candidate
__device__ __forceinline__ void warp_best(float& v, int& idx, int width = 32) {
  for (int d = width >> 1; d > 0; d >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, d);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, d);
    take_better(v, idx, ov, oi);
  }
}

// Summary of a run of cells for the segmented prefix max of the delete
// state: the first and last target of the run and the maximum over the
// run's cells of its last target.  first < 0: an empty run.
struct Seg {
  int first, last;
  float v;
};

__device__ __forceinline__ Seg empty_seg() { return {-1, -1, -INFINITY}; }

// a then b: b's maximum carries a's only when b is one target that a ends in
__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  if (a.first < 0) return b;
  if (b.first < 0) return a;
  const bool joined = b.first == b.last && a.last == b.first;
  return {a.first, b.last, joined ? fmaxf(a.v, b.v) : b.v};
}

__device__ __forceinline__ Seg shfl_up(Seg x, int d) {
  return {__shfl_up_sync(0xffffffffu, x.first, d),
          __shfl_up_sync(0xffffffffu, x.last, d),
          __shfl_up_sync(0xffffffffu, x.v, d)};
}

// inclusive scan over the first `width` lanes of a warp
__device__ __forceinline__ Seg warp_scan(Seg x, int lane, int width = 32) {
  for (int d = 1; d < width; d <<= 1) {
    const Seg o = shfl_up(x, d);
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

// Shared memory of the column loop: the warps' and the CTA's summaries and
// argmax candidates, and each thread's last cell (M, I, D) of the column.
struct Column {
  Seg warp_sum[kMaxWarps];
  Seg warp_carry[kMaxWarps];
  float warp_bv[kMaxWarps];
  int warp_bi[kMaxWarps];
  Seg cta_sum;
  float cta_bv;
  int cta_bi;
  float edge[3][kMaxThreads];
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
// distributed shared memory, lane r reading CTA r.
__device__ __forceinline__ Seg reduce_column(cg::cluster_group& cluster, Column& sh,
                                             const Layout& y, Seg mine, float bv, int bi,
                                             float& max_r, int& best) {
  const Seg incl = warp_scan(mine, y.lane);
  Seg excl = shfl_up(incl, 1);
  if (y.lane == 0) excl = empty_seg();
  warp_best(bv, bi);
  if (y.lane == 31) sh.warp_sum[y.warp] = incl;
  if (y.lane == 0) {
    sh.warp_bv[y.warp] = bv;
    sh.warp_bi[y.warp] = bi;
  }
  __syncthreads();
  if (y.warp == 0) {
    const Seg x = warp_scan(y.lane < y.nwarps ? sh.warp_sum[y.lane] : empty_seg(), y.lane,
                            y.wpow2);
    Seg before = shfl_up(x, 1);
    if (y.lane == 0) before = empty_seg();
    if (y.lane < y.nwarps) sh.warp_carry[y.lane] = before;
    if (y.lane == y.nwarps - 1) sh.cta_sum = x;
    float v = y.lane < y.nwarps ? sh.warp_bv[y.lane] : -INFINITY;
    int idx = y.lane < y.nwarps ? sh.warp_bi[y.lane] : 0x7fffffff;
    warp_best(v, idx, y.wpow2);
    if (y.lane == 0) {
      sh.cta_bv = v;
      sh.cta_bi = idx;
    }
  }
  cluster_barrier(y.warp == 0);

  Seg x = empty_seg();
  float v = -INFINITY;
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
  Seg prev_ctas = {__shfl_sync(0xffffffffu, x.first, max(y.rank - 1, 0)),
                   __shfl_sync(0xffffffffu, x.last, max(y.rank - 1, 0)),
                   __shfl_sync(0xffffffffu, x.v, max(y.rank - 1, 0))};
  if (y.rank == 0) prev_ctas = empty_seg();
  return combine(combine(prev_ctas, sh.warp_carry[y.warp]), excl);
}

// End of pass B: publish this thread's last cell (m, i, d), cluster barrier
// 2, and read the left neighbour's (through distributed shared memory
// across a CTA edge) into left_*; thread 0 of CTA 0 keeps its own.
__device__ __forceinline__ void exchange_edges(cg::cluster_group& cluster, Column& sh,
                                               const Layout& y, float m, float i, float d,
                                               float& left_m, float& left_i, float& left_d) {
  sh.edge[0][y.tid] = m;
  sh.edge[1][y.tid] = i;
  sh.edge[2][y.tid] = d;
  cluster_barrier(y.warp == y.nwarps - 1);  // the warp of the edge other CTAs read
  if (y.tid > 0) {
    left_m = sh.edge[0][y.tid - 1];
    left_i = sh.edge[1][y.tid - 1];
    left_d = sh.edge[2][y.tid - 1];
  } else if (y.rank > 0) {
    left_m = cluster.map_shared_rank(&sh.edge[0][0], y.rank - 1)[y.T - 1];
    left_i = cluster.map_shared_rank(&sh.edge[1][0], y.rank - 1)[y.T - 1];
    left_d = cluster.map_shared_rank(&sh.edge[2][0], y.rank - 1)[y.T - 1];
  }
}

// The traceback (one thread), the while_loop of _tesserae_traceback with
// each packed word rebuilt from its byte code.  A flat cell f's byte of
// column pt is codes[pt * npad + f] in the register form (wide_c 0) and
// codes[pt * npad + (f % wide_c) * nt + f / wide_c] in the wide form.
__device__ void walk_path(const unsigned char* codes, int npad, const long long* rec,
                          int L, int S, int W, int best, float max_r, int* out, int cap,
                          int wide_c, int nt) {
  const int two_w = 2 * W;
  const int who = best / two_w + 1;
  const int cst = (best % two_w) % 2 == 0 ? kM : kI;
  const int pos = (best % two_w) / 2;
  int* cells = out + 2;
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
      const size_t f = (size_t)sidx * W + p_;
      const size_t at = wide_c ? (f % wide_c) * nt + f / wide_c : f;
      const unsigned code = codes[(size_t)pt * npad + at];
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
  out[1] = __float_as_int(max_r);
}

// the column's recombination word, from its argmax
__device__ __forceinline__ long long rec_word(int best, int W) {
  const int two_w = 2 * W;
  return pack(best / two_w + 1, (best % two_w) % 2 == 0 ? kM : kI, (best % two_w) / 2);
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
tesserae_kernel(const int* __restrict__ q, const int* __restrict__ t_codes,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ params, int L, int S, int W, int npad,
                unsigned char* __restrict__ codes, long long* __restrict__ rec,
                int* __restrict__ out, int cap) {
  static_assert(C == 1 || C == 2 || C == 4 || C == 8 || C == 16, "C: 1..16, a power of two");
  __shared__ float prm[kNumParams];
  __shared__ Column sh;

  cg::cluster_group cluster = cg::this_cluster();
  const Layout y = layout(cluster);
  const int rank = y.rank, T = y.T, tid = y.tid;
  for (int x = tid; x < kNumParams; x += T) prm[x] = params[x];
  __syncthreads();
  const float ldel = prm[0], leps = prm[1], lrho = prm[2], lpiM = prm[3],
              lpiI = prm[4], lmm = prm[5], lgm = prm[6], ldm = prm[7],
              lsize_l = prm[8];
  const float* lsm = prm + 9;   // [5][5]
  const float* lsi = prm + 34;  // [5]

  // this thread's cells: flat f0 .. f0 + C - 1 of N = S * W
  const int N = S * W;
  const int f0 = (rank * T + tid) * C;
  const int s0 = f0 / W, j0 = f0 % W;
  unsigned vbits = 0;              // cell i valid: j >= 1 and valid[s][j-1]
  unsigned long long tbits = 0;    // cell i's target code, 4 bits a cell
  int ncells = 0;                  // cells below N
#pragma unroll
  for (int i = 0; i < C; ++i) {
    int j = j0 + i, s = s0;
    if (j >= W) { j -= W; ++s; }
    if (f0 + i < N) {
      ncells = i + 1;
      if (j >= 1) {
        const size_t at = (size_t)s * (W - 1) + (j - 1);
        if (valid[at]) vbits |= 1u << i;
        tbits |= (unsigned long long)(t_codes[at] & 15) << (4 * i);
      }
    }
  }

  float vm[C], vi[C], vd[C];
#pragma unroll
  for (int i = 0; i < C; ++i) vm[i] = vi[i] = vd[i] = kSmall;
  // the left neighbour's last cell of the previous column
  float left_m = kSmall, left_i = kSmall, left_d = kSmall;
  // column argmax carried into the next column (identical in every thread)
  float max_r = 0.0f;
  int best = 0;

  for (int col = 1; col <= L; ++col) {
    const int qc = q[col - 1];
    const bool first = col == 1;
    const int min_j = first ? 1 : 2;
    const float recomb = ((max_r + lrho) + lpiM) - lsize_l;
    const float recomb_i = ((max_r + lrho) + lpiI) - lsize_l;
    const float* em = lsm + qc * 5;
    const float emi = lsi[qc];
    unsigned w[(C + 3) / 4];
#pragma unroll
    for (int x = 0; x < (C + 3) / 4; ++x) w[x] = 0;

    // ---- A. M and I, the delete-scan input's maximum, the argmax candidate
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    float pm_l = left_m, pi_l = left_i, pd_l = left_d;  // previous column, j-1
    Seg mine = empty_seg();
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (i < ncells) {
        int j = j0 + i, s = s0;
        if (j >= W) { j -= W; ++s; }
        const bool ok = (vbits >> i) & 1u;
        const int t = (int)((tbits >> (4 * i)) & 15);
        const float om = vm[i], oi = vi[i];
        float m, v;
        if (first) {
          m = ok ? (lpiM - lsize_l) + em[t] : kSmall;
          v = ok ? (lpiI - lsize_l) + emi : kSmall;
        } else {
          // local M: (M, I, D) at (j-1, previous column), first max wins
          const float c0 = (j >= 1 ? pm_l : kSmall) + lmm;
          const float c1 = (j >= 1 ? pi_l : kSmall) + lgm;
          const float c2 = (j >= 1 ? pd_l : kSmall) + ldm;
          float lval = c0;
          int larg = 0;
          if (c1 > lval) { lval = c1; larg = 1; }
          if (c2 > lval) { lval = c2; larg = 2; }
          const bool use_local = lval > recomb;
          m = use_local ? lval : recomb;
          m = (j == 0) ? kSmall : (ok ? m + em[t] : kSmall);
          // I: (M, I) at (j, previous column)
          const float i0 = om + ldel, i1 = oi + leps;
          const int iarg = (i1 > i0) ? 1 : 0;
          const float ival = iarg ? i1 : i0;
          const bool use_i = ival > recomb_i;
          v = use_i ? ival : recomb_i;
          v = (j == 0) ? kSmall : (ok ? v + emi : kSmall);
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
        const float cm = ok ? m : kSmall, ci = ok ? v : kSmall;
        const bool take_i = ci > cm;
        const float cv = take_i ? ci : cm;
        if (cv > bv) {
          bv = cv;
          bi = 2 * (f0 + i) + (take_i ? 1 : 0);
        }
        const float adj = (j >= min_j - 1) ? m - leps * (float)j : kSmall;
        if (mine.first < 0) mine.first = s;
        if (s != mine.last) { mine.last = s; mine.v = -INFINITY; }
        mine.v = fmaxf(mine.v, adj);
      }
    }
    const Seg excl = reduce_column(cluster, sh, y, mine, bv, bi, max_r, best);

    // ---- B. delete state vd[j] = ldel + leps*(j-1) + max_{t<j} adj[t] and
    // its branch (M if nvm[j-1] + ldel >= vd[j-1] + leps)
    {
      float run = (excl.first >= 0 && excl.last == s0) ? excl.v : -INFINITY;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (i < ncells) {
          int j = j0 + i;
          if (j >= W) j -= W;
          const float m = vm[i];
          const float adj = (j >= min_j - 1) ? m - leps * (float)j : kSmall;
          if (j == 0) run = -INFINITY;
          const float run_prev = (j == 0) ? kSmall : run;
          const float d = (j >= min_j) ? delete_term(ldel, leps, j) + run_prev : kSmall;
          run = fmaxf(run, adj);
          if (i > 0) {
            const float mb = (j == 0 ? kSmall : vm[i > 0 ? i - 1 : 0]) + ldel;
            const float db = (j == 0 ? kSmall : vd[i > 0 ? i - 1 : 0]) + leps;
            if (!(mb >= db)) w[i / 4] |= 16u << (8 * (i % 4));
          }
          vd[i] = d;
        }
      }
    }
    exchange_edges(cluster, sh, y, vm[C - 1], vi[C - 1], vd[C - 1], left_m, left_i, left_d);
    if (ncells > 0) {
      const float mb = (j0 == 0 ? kSmall : left_m) + ldel;
      const float db = (j0 == 0 ? kSmall : left_d) + leps;
      if (!(mb >= db)) w[0] |= 16u;
      store_codes<C>(codes + (size_t)col * npad + f0, w);
    }
    if (rank == 0 && tid == 0) rec[col] = rec_word(best, W);
  }

  // ---- traceback
  __threadfence();
  cluster.sync();
  if (rank == 0 && tid == 0) walk_path(codes, npad, rec, L, S, W, best, max_r, out, cap, 0, 0);
}

// The wide form: the register kernel's column loop with each thread's C
// cells (any number, crossing any number of targets) in global memory,
// cell-major across the NT = K * T threads.  state float[3][C * NT] (M, I,
// D), info uint8[C * NT] (target code in bits 0-3, validity in bit 4);
// codes uint8[L+1, npad] with npad >= C * NT.  Every line of arithmetic is
// the register kernel's, in the same order.
__global__ void __launch_bounds__(kMaxThreads)
tesserae_wide_kernel(const int* __restrict__ q, const int* __restrict__ t_codes,
                     const unsigned char* __restrict__ valid,
                     const float* __restrict__ params, int L, int S, int W, int C, int npad,
                     unsigned char* __restrict__ codes, long long* __restrict__ rec,
                     float* __restrict__ state, unsigned char* __restrict__ info,
                     int* __restrict__ out, int cap) {
  __shared__ float prm[kNumParams];
  __shared__ Column sh;

  cg::cluster_group cluster = cg::this_cluster();
  const Layout y = layout(cluster);
  const int rank = y.rank, T = y.T, tid = y.tid;
  for (int x = tid; x < kNumParams; x += T) prm[x] = params[x];
  __syncthreads();
  const float ldel = prm[0], leps = prm[1], lrho = prm[2], lpiM = prm[3],
              lpiI = prm[4], lmm = prm[5], lgm = prm[6], ldm = prm[7],
              lsize_l = prm[8];
  const float* lsm = prm + 9;   // [5][5]
  const float* lsi = prm + 34;  // [5]

  // this thread's cells: flat f0 .. f0 + ncells - 1 of N = S * W, the i-th
  // at i * NT + g in state, info and a column's codes
  const int NT = y.K * T;
  const int g = rank * T + tid;
  const int N = S * W;
  const int f0 = g * C;
  const int s0 = f0 / W, j0 = f0 % W;
  const int ncells = max(0, min(C, N - f0));
  float* __restrict__ sm = state;
  float* __restrict__ si = state + (size_t)C * NT;
  float* __restrict__ sd = state + 2 * (size_t)C * NT;
  {
    int s = s0, j = j0;
    for (int i = 0; i < ncells; ++i) {
      const size_t x = (size_t)i * NT + g;
      unsigned b = 0;
      if (j >= 1) {
        const size_t at = (size_t)s * (W - 1) + (j - 1);
        b = (unsigned)(t_codes[at] & 15) | (valid[at] ? 16u : 0u);
      }
      info[x] = (unsigned char)b;
      sm[x] = si[x] = sd[x] = kSmall;
      if (++j == W) {
        j = 0;
        ++s;
      }
    }
  }

  float left_m = kSmall, left_i = kSmall, left_d = kSmall;
  float max_r = 0.0f;
  int best = 0;

  for (int col = 1; col <= L; ++col) {
    const int qc = q[col - 1];
    const bool first = col == 1;
    const int min_j = first ? 1 : 2;
    const float recomb = ((max_r + lrho) + lpiM) - lsize_l;
    const float recomb_i = ((max_r + lrho) + lpiI) - lsize_l;
    const float* em = lsm + qc * 5;
    const float emi = lsi[qc];
    unsigned char* __restrict__ crow = codes + (size_t)col * npad;

    // ---- A. M and I, the delete-scan input's maximum, the argmax candidate
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    float pm_l = left_m, pi_l = left_i, pd_l = left_d;  // previous column, j-1
    Seg mine = empty_seg();
    {
      int s = s0, j = j0;
#pragma unroll 4
      for (int i = 0; i < ncells; ++i) {
        const size_t x = (size_t)i * NT + g;
        const unsigned b = info[x];
        const bool ok = (b >> 4) & 1u;
        const int t = (int)(b & 15);
        const float om = sm[x], oi = si[x], od = sd[x];
        float m, v;
        unsigned code = 0;
        if (first) {
          m = ok ? (lpiM - lsize_l) + em[t] : kSmall;
          v = ok ? (lpiI - lsize_l) + emi : kSmall;
        } else {
          const float c0 = (j >= 1 ? pm_l : kSmall) + lmm;
          const float c1 = (j >= 1 ? pi_l : kSmall) + lgm;
          const float c2 = (j >= 1 ? pd_l : kSmall) + ldm;
          float lval = c0;
          int larg = 0;
          if (c1 > lval) { lval = c1; larg = 1; }
          if (c2 > lval) { lval = c2; larg = 2; }
          const bool use_local = lval > recomb;
          m = use_local ? lval : recomb;
          m = (j == 0) ? kSmall : (ok ? m + em[t] : kSmall);
          const float i0 = om + ldel, i1 = oi + leps;
          const int iarg = (i1 > i0) ? 1 : 0;
          const float ival = iarg ? i1 : i0;
          const bool use_i = ival > recomb_i;
          v = use_i ? ival : recomb_i;
          v = (j == 0) ? kSmall : (ok ? v + emi : kSmall);
          code = (use_local ? (unsigned)(larg + 1) : 0u) |
                 ((use_i ? (unsigned)(iarg + 1) : 0u) << 2);
        }
        pm_l = om;
        pi_l = oi;
        pd_l = od;
        sm[x] = m;
        si[x] = v;
        crow[x] = (unsigned char)code;
        const float cm = ok ? m : kSmall, ci = ok ? v : kSmall;
        const bool take_i = ci > cm;
        const float cv = take_i ? ci : cm;
        if (cv > bv) {
          bv = cv;
          bi = 2 * (f0 + i) + (take_i ? 1 : 0);
        }
        const float adj = (j >= min_j - 1) ? m - leps * (float)j : kSmall;
        if (mine.first < 0) mine.first = s;
        if (s != mine.last) { mine.last = s; mine.v = -INFINITY; }
        mine.v = fmaxf(mine.v, adj);
        if (++j == W) {
          j = 0;
          ++s;
        }
      }
    }
    const Seg excl = reduce_column(cluster, sh, y, mine, bv, bi, max_r, best);

    // ---- B. the delete state and its branch, as the register kernel's
    float last_m = kSmall, last_i = kSmall, last_d = kSmall;
    {
      float run = (excl.first >= 0 && excl.last == s0) ? excl.v : -INFINITY;
      float prev_m = kSmall, prev_d = kSmall;  // this column's M and D at cell i-1
      int j = j0;
#pragma unroll 4
      for (int i = 0; i < ncells; ++i) {
        const size_t x = (size_t)i * NT + g;
        const float m = sm[x];
        const float adj = (j >= min_j - 1) ? m - leps * (float)j : kSmall;
        if (j == 0) run = -INFINITY;
        const float run_prev = (j == 0) ? kSmall : run;
        const float d = (j >= min_j) ? delete_term(ldel, leps, j) + run_prev : kSmall;
        run = fmaxf(run, adj);
        if (i > 0) {
          const float mb = (j == 0 ? kSmall : prev_m) + ldel;
          const float db = (j == 0 ? kSmall : prev_d) + leps;
          if (!(mb >= db)) crow[x] |= 16u;
        }
        sd[x] = d;
        prev_m = m;
        prev_d = d;
        if (++j == W) j = 0;
      }
      // the register kernel publishes its C-th cell, SMALL past the section
      if (ncells == C) {
        last_m = prev_m;
        last_i = si[(size_t)(C - 1) * NT + g];
        last_d = prev_d;
      }
    }
    exchange_edges(cluster, sh, y, last_m, last_i, last_d, left_m, left_i, left_d);
    if (ncells > 0) {
      const float mb = (j0 == 0 ? kSmall : left_m) + ldel;
      const float db = (j0 == 0 ? kSmall : left_d) + leps;
      if (!(mb >= db)) crow[g] |= 16u;
    }
    if (rank == 0 && tid == 0) rec[col] = rec_word(best, W);
  }

  __threadfence();
  cluster.sync();
  if (rank == 0 && tid == 0) walk_path(codes, npad, rec, L, S, W, best, max_r, out, cap, C, NT);
}

// One cluster of `cluster` CTAs of `threads` threads (above 8 CTAs the
// cluster is non-portable) on `stream`.
template <typename... Exp, typename... Act>
int launch_cluster(void (*kernel)(Exp...), int cluster, int threads, cudaStream_t stream,
                   Act... args) {
  if (cluster > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool bad_shape(int L, int S, int W, int cells, int cluster, int threads, int npad, int cap) {
  const long long n = (long long)S * W;
  return threads <= 0 || threads > kMaxThreads || threads % 32 || cluster < 1 ||
         cluster > kMaxCluster || S < 1 || L < 1 || W < 2 || cells < 1 || cap < 1 ||
         npad % 16 || (long long)cluster * threads * cells < n;
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
  if (bad_shape(L, S, W, cells, cluster, threads, npad, cap) || cells > W ||
      npad < (long long)S * W) {
    return (int)cudaErrorInvalidValue;
  }
#define CTK_TESSERAE_LAUNCH(C)                                                              \
  launch_cluster(tesserae_kernel<C>, cluster, threads, stream, q, t_codes, valid, params, L, \
                 S, W, npad, codes, rec, out, cap)
  switch (cells) {
    case 1: return CTK_TESSERAE_LAUNCH(1);
    case 2: return CTK_TESSERAE_LAUNCH(2);
    case 4: return CTK_TESSERAE_LAUNCH(4);
    case 8: return CTK_TESSERAE_LAUNCH(8);
    case 16: return CTK_TESSERAE_LAUNCH(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CTK_TESSERAE_LAUNCH
}

// The wide form of ctk_tesserae (one section, any `cells` a thread):
// codes uint8[L+1, npad] with npad a multiple of 16 and at least
// cluster * threads * cells; state float32[3 * cluster * threads * cells]
// and info uint8[cluster * threads * cells], scratch; rec and out as
// ctk_tesserae's.
extern "C" int ctk_tesserae_wide(const int* q, const int* t_codes,
                                 const unsigned char* valid, const float* params,
                                 int L, int S, int W, int cells, int cluster,
                                 int threads, unsigned char* codes, int npad,
                                 long long* rec, float* state, unsigned char* info,
                                 int* out, int cap, cudaStream_t stream) {
  if (bad_shape(L, S, W, cells, cluster, threads, npad, cap) ||
      npad < (long long)cluster * threads * cells) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_cluster(tesserae_wide_kernel, cluster, threads, stream, q, t_codes, valid,
                        params, L, S, W, cells, npad, codes, rec, state, info, out, cap);
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
