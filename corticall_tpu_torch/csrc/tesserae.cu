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

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
tesserae_kernel(const int* __restrict__ q, const int* __restrict__ t_codes,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ params, int L, int S, int W, int npad,
                unsigned char* __restrict__ codes, long long* __restrict__ rec,
                int* __restrict__ out, int cap) {
  static_assert(C == 1 || C == 2 || C == 4 || C == 8 || C == 16, "C: 1..16, a power of two");
  __shared__ float prm[kNumParams];
  __shared__ Seg warp_sum[kMaxWarps];
  __shared__ Seg warp_carry[kMaxWarps];
  __shared__ float warp_bv[kMaxWarps];
  __shared__ int warp_bi[kMaxWarps];
  __shared__ Seg cta_sum;
  __shared__ float cta_bv;
  __shared__ int cta_bi;
  __shared__ float edge[3][kMaxThreads];  // each thread's last cell: M, I, D

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int K = (int)cluster.num_blocks();
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  int wpow2 = 1, kpow2 = 1;  // lanes the CTA-level and cluster-level passes span
  while (wpow2 < nwarps) wpow2 <<= 1;
  while (kpow2 < K) kpow2 <<= 1;
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
    const Seg incl = warp_scan(mine, lane);
    Seg excl = shfl_up(incl, 1);
    if (lane == 0) excl = empty_seg();
    warp_best(bv, bi);
    if (lane == 31) warp_sum[warp] = incl;
    if (lane == 0) {
      warp_bv[warp] = bv;
      warp_bi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      const Seg x = warp_scan(lane < nwarps ? warp_sum[lane] : empty_seg(), lane, wpow2);
      Seg before = shfl_up(x, 1);
      if (lane == 0) before = empty_seg();
      if (lane < nwarps) warp_carry[lane] = before;
      if (lane == nwarps - 1) cta_sum = x;
      float v = lane < nwarps ? warp_bv[lane] : -INFINITY;
      int idx = lane < nwarps ? warp_bi[lane] : 0x7fffffff;
      warp_best(v, idx, wpow2);
      if (lane == 0) {
        cta_bv = v;
        cta_bi = idx;
      }
    }
    cluster_barrier(warp == 0);

    // every warp: the CTAs' summaries and bests through distributed shared
    // memory, lane r reading CTA r
    {
      Seg x = empty_seg();
      float v = -INFINITY;
      int idx = 0x7fffffff;
      if (lane < K) {
        x = *cluster.map_shared_rank(&cta_sum, lane);
        v = *cluster.map_shared_rank(&cta_bv, lane);
        idx = *cluster.map_shared_rank(&cta_bi, lane);
      }
      x = warp_scan(x, lane, kpow2);
      warp_best(v, idx, kpow2);
      v = __shfl_sync(0xffffffffu, v, 0);
      idx = __shfl_sync(0xffffffffu, idx, 0);
      max_r = v;
      best = idx;
      // the summary of every CTA before this one
      Seg prev_ctas = {__shfl_sync(0xffffffffu, x.first, max(rank - 1, 0)),
                       __shfl_sync(0xffffffffu, x.last, max(rank - 1, 0)),
                       __shfl_sync(0xffffffffu, x.v, max(rank - 1, 0))};
      if (rank == 0) prev_ctas = empty_seg();
      excl = combine(combine(prev_ctas, warp_carry[warp]), excl);
    }

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
    edge[0][tid] = vm[C - 1];
    edge[1][tid] = vi[C - 1];
    edge[2][tid] = vd[C - 1];
    cluster_barrier(warp == nwarps - 1);  // the warp of the edge other CTAs read

    if (tid > 0) {
      left_m = edge[0][tid - 1];
      left_i = edge[1][tid - 1];
      left_d = edge[2][tid - 1];
    } else if (rank > 0) {
      left_m = cluster.map_shared_rank(&edge[0][0], rank - 1)[T - 1];
      left_i = cluster.map_shared_rank(&edge[1][0], rank - 1)[T - 1];
      left_d = cluster.map_shared_rank(&edge[2][0], rank - 1)[T - 1];
    }
    if (ncells > 0) {
      const float mb = (j0 == 0 ? kSmall : left_m) + ldel;
      const float db = (j0 == 0 ? kSmall : left_d) + leps;
      if (!(mb >= db)) w[0] |= 16u;
      store_codes<C>(codes + (size_t)col * npad + f0, w);
    }
    if (rank == 0 && tid == 0) {
      const int two_w = 2 * W;
      rec[col] = pack(best / two_w + 1, (best % two_w) % 2 == 0 ? kM : kI,
                      (best % two_w) / 2);
    }
  }

  // ---- traceback (one thread), the while_loop of _tesserae_traceback with
  // each packed word rebuilt from its byte code
  __threadfence();
  cluster.sync();
  if (rank == 0 && tid == 0) {
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
    out[1] = __float_as_int(max_r);
  }
}

template <int C>
int launch(const int* q, const int* t_codes, const unsigned char* valid,
           const float* params, int L, int S, int W, int npad, int cluster,
           int threads, unsigned char* codes, long long* rec, int* out, int cap,
           cudaStream_t stream) {
  auto kernel = tesserae_kernel<C>;
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, q, t_codes, valid, params, L,
                                             S, W, npad, codes, rec, out, cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
  const long long n = (long long)S * W;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 || cluster < 1 ||
      cluster > kMaxCluster || S < 1 || L < 1 || W < 2 ||
      cells > W || cap < 1 || npad % 16 || npad < n ||
      (long long)cluster * threads * cells < n) {
    return (int)cudaErrorInvalidValue;
  }
  switch (cells) {
    case 1: return launch<1>(q, t_codes, valid, params, L, S, W, npad, cluster, threads, codes, rec, out, cap, stream);
    case 2: return launch<2>(q, t_codes, valid, params, L, S, W, npad, cluster, threads, codes, rec, out, cap, stream);
    case 4: return launch<4>(q, t_codes, valid, params, L, S, W, npad, cluster, threads, codes, rec, out, cap, stream);
    case 8: return launch<8>(q, t_codes, valid, params, L, S, W, npad, cluster, threads, codes, rec, out, cap, stream);
    case 16: return launch<16>(q, t_codes, valid, params, L, S, W, npad, cluster, threads, codes, rec, out, cap, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
