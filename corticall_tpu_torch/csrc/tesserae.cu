// Tesserae mosaic-alignment Viterbi DP + traceback, one launch per section.
//
// Replaces the device code of corticall_tpu/ops/tesserae_jax.py:
// _tesserae_scan (the lax.scan over query columns), _tesserae_traceback (the
// on-device while_loop) and _tesserae_full (both in one dispatch), which
// TesseraeDevice.align runs for each Call section (caller/call.py:1457).  The
// plain twin is corticall_tpu_torch/ops/tesserae_torch.py::tesserae_full;
// this kernel computes the same float32 operations in the same order
// (nvcc --fmad=false keeps every multiply and add separately rounded), so
// the traceback cells are identical and max_r is equal in bits.
//
// Form: one block of up to 1024 threads owns the section.  Each warp owns a
// contiguous range of columns of one target (with more targets than warp
// slots, a warp takes several targets in turn) and walks it in tiles of 32
// consecutive columns, a lane a column, so every load and store of a warp
// touches one or two cache lines.  The [S, W] M/I/D state lives in device
// memory, double-buffered by column parity (it stays in L2).  For each query
// column the block
//   1. computes M and I for its cells from the previous column (the local
//      candidate with first-index argmax, then `local > recomb` strict),
//      writing the packed traceback words `who<<25 | state<<23 | pos`, and
//      each warp's maximum of the delete-scan input over its range;
//   2. runs the delete state as a per-target prefix max: the maxima of the
//      earlier warps of the same target (shared memory), then tile by tile a
//      warp-shuffle scan with a running carry;
//   3. takes the flat column argmax over (target, j, M before I) by warp
//      shuffles plus one pass over the per-warp winners in shared memory,
//      which every thread repeats, so the next column's recombination value
//      needs no broadcast.
// Two barriers per column.  The traceback buffers int32[3, L+1, S, W] never
// leave the device: after the loop thread 0 walks the path and writes
// (n, max_r, cells[cap, 3]) to one small output buffer.
//
// Bound on this card: one SM per section — caller/call.py:1457 aligns the
// sections one at a time — so a section is limited by the latency of that
// SM's path to L2 (about fifteen 4-byte accesses a cell and column: the
// state, the targets and the three traceback words; ~1.5 ns a cell-column
// at 16 targets on an H100) and by two barriers a column; the other 131
// SMs idle.  A later PR would batch the sections of a partition into one
// launch (a block each) and keep each warp's range in registers so that
// only its edges go through memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kSmall = -1e32f;
constexpr int kM = 1, kI = 2, kD = 3;
constexpr int kMaxThreads = 1024;
constexpr int kNumParams = 9 + 25 + 5;
// targets the packed traceback word can name (who in bits 25..30)
constexpr int kMaxTargetSlots = 64;

__device__ __forceinline__ int pack(int who, int state, int pos) {
  return (who << 25) | (state << 23) | pos;
}

// better (value, flat index): larger value, then smaller index (first argmax)
__device__ __forceinline__ void take_better(float& v, int& idx, float ov, int oi) {
  if (ov > v || (ov == v && oi < idx)) {
    v = ov;
    idx = oi;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
tesserae_kernel(const int* __restrict__ q, const int* __restrict__ t_codes,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ params, int L, int S, int W,
                float* __restrict__ state, int* __restrict__ tb,
                int* __restrict__ out, int cap) {
  __shared__ float prm[kNumParams];
  __shared__ float seg_max[kMaxTargetSlots];
  __shared__ float warp_best_v[kMaxThreads / 32];
  __shared__ int warp_best_i[kMaxThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int x = tid; x < kNumParams; x += blockDim.x) prm[x] = params[x];
  __syncthreads();
  const float ldel = prm[0], leps = prm[1], lrho = prm[2], lpiM = prm[3],
              lpiI = prm[4], lmm = prm[5], lgm = prm[6], ldm = prm[7],
              lsize_l = prm[8];
  const float* lsm = prm + 9;   // [5][5]
  const float* lsi = prm + 34;  // [5]

  // warp -> (first target, column range): wpt warps per target, ngroups
  // targets in flight; a warp takes targets g, g + ngroups, ...
  int s_pow2 = 1;
  while (s_pow2 < S) s_pow2 <<= 1;
  const int wpt = max(1, nwarps / s_pow2);
  const int ngroups = nwarps / wpt;
  const int g = warp / wpt;
  const int wk = warp % wpt;
  const int span = ((W + wpt - 1) / wpt + 31) / 32 * 32;
  const int wlo = min(wk * span, W);
  const int whi = min(wlo + span, W);

  const size_t SW = (size_t)S * W;
  // state[buf][0:M 1:I 2:D][S][W]; column c writes buf c&1, reads buf (c-1)&1
  auto st = [&](int buf, int which, int s) {
    return state + ((size_t)buf * 3 + which) * SW + (size_t)s * W;
  };
  // tb[0:M 1:I 2:D][col][S][W]
  auto tbp = [&](int which, int col, int s) {
    return tb + ((size_t)which * (L + 1) + col) * SW + (size_t)s * W;
  };

  // column argmax carried into the next column (identical in every thread)
  int who = 1, cst = kM, pos = 0;
  float max_r = 0.0f;

  for (int col = 1; col <= L; ++col) {
    const int qc = q[col - 1];
    const int nb = col & 1;
    const int pb = nb ^ 1;
    const int min_j = (col == 1) ? 1 : 2;
    const float recomb = ((max_r + lrho) + lpiM) - lsize_l;
    const float recomb_i = ((max_r + lrho) + lpiI) - lsize_l;
    const int tb_rec = pack(who, cst, pos);
    float bv = -INFINITY;
    int bi = 0x7fffffff;

    // ---- pass 1: M and I, the range maximum of the delete-scan input,
    // the lane's column argmax candidate
    for (int s = g; s < S; s += ngroups) {
      float* nvm = st(nb, 0, s);
      float* nvi = st(nb, 1, s);
      const float* pvm = st(pb, 0, s);
      const float* pvi = st(pb, 1, s);
      const float* pvd = st(pb, 2, s);
      const int* trow = t_codes + (size_t)s * (W - 1);
      const unsigned char* vrow = valid + (size_t)s * (W - 1);
      const int who_self = s + 1;
      float lane_max = -INFINITY;
      for (int j = wlo + lane; j < whi; j += 32) {
        const bool ok = j >= 1 && vrow[j - 1];
        float m, vi;
        if (col == 1) {
          m = ok ? (lpiM - lsize_l) + lsm[qc * 5 + trow[j - 1]] : kSmall;
          vi = ok ? (lpiI - lsize_l) + lsi[qc] : kSmall;
        } else {
          const float pm = pvm[j], pi = pvi[j];
          const float pm_l = j >= 1 ? pvm[j - 1] : kSmall;
          const float pi_l = j >= 1 ? pvi[j - 1] : kSmall;
          const float pd_l = j >= 1 ? pvd[j - 1] : kSmall;
          // local M: (M, I, D) at (j-1, previous column), first max wins
          const float c0 = pm_l + lmm, c1 = pi_l + lgm, c2 = pd_l + ldm;
          float lval = c0;
          int larg = 0;
          if (c1 > lval) { lval = c1; larg = 1; }
          if (c2 > lval) { lval = c2; larg = 2; }
          const bool use_local = lval > recomb;
          m = use_local ? lval : recomb;
          tbp(0, col, s)[j] = use_local ? pack(who_self, larg + 1, max(j - 1, 0)) : tb_rec;
          m = (j == 0) ? kSmall : (ok ? m + lsm[qc * 5 + trow[j - 1]] : kSmall);
          // I: (M, I) at (j, previous column)
          const float i0 = pm + ldel, i1 = pi + leps;
          const int iarg = (i1 > i0) ? 1 : 0;
          const float ival = iarg ? i1 : i0;
          const bool use_i = ival > recomb_i;
          vi = use_i ? ival : recomb_i;
          tbp(1, col, s)[j] = use_i ? pack(who_self, iarg + 1, j) : tb_rec;
          vi = (j == 0) ? kSmall : (ok ? vi + lsi[qc] : kSmall);
        }
        nvm[j] = m;
        nvi[j] = vi;
        lane_max = fmaxf(lane_max, (j >= min_j - 1) ? m - leps * (float)j : kSmall);
        const int flat = (int)(((size_t)s * W + j) * 2);
        take_better(bv, bi, ok ? m : kSmall, flat);
        take_better(bv, bi, ok ? vi : kSmall, flat + 1);
      }
      for (int d = 16; d > 0; d >>= 1)
        lane_max = fmaxf(lane_max, __shfl_xor_sync(0xffffffffu, lane_max, d));
      if (lane == 0) seg_max[s * wpt + wk] = lane_max;
    }
    for (int d = 16; d > 0; d >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, d);
      const int oi = __shfl_down_sync(0xffffffffu, bi, d);
      take_better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      warp_best_v[warp] = bv;
      warp_best_i[warp] = bi;
    }
    __syncthreads();

    // block argmax (every thread, same order): the next column's recomb
    {
      float v = warp_best_v[0];
      int idx = warp_best_i[0];
      for (int w = 1; w < nwarps; ++w) take_better(v, idx, warp_best_v[w], warp_best_i[w]);
      const int two_w = 2 * W;
      who = idx / two_w + 1;
      const int rem = idx % two_w;
      pos = rem / 2;
      cst = (rem % 2 == 0) ? kM : kI;
      max_r = v;
    }

    // ---- pass 2: delete state vd[j] = ldel + leps*(j-1) + max_{t<j} adj[t]
    // and its branch (M if nvm[j-1] + ldel >= vd[j-1] + leps)
    for (int s = g; s < S; s += ngroups) {
      const float* nvm = st(nb, 0, s);
      float* nvd = st(nb, 2, s);
      int* tbd = tbp(2, col, s);
      const int who_self = s + 1;
      float carry = -INFINITY;  // max adj over [0, tile start)
      for (int w = 0; w < wk; ++w) carry = fmaxf(carry, seg_max[s * wpt + w]);
      float vd_carry = 0.0f;    // vd at tile start - 1
      for (int base = wlo; base < whi; base += 32) {
        const int j = base + lane;
        const bool in = j < whi;
        const float m = in ? nvm[j] : kSmall;
        const float adj = !in ? -INFINITY : ((j >= min_j - 1) ? m - leps * (float)j : kSmall);
        float incl = adj;
        for (int d = 1; d < 32; d <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl = fmaxf(incl, o);
        }
        float before = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) before = -INFINITY;
        const float run_prev = (j == 0) ? kSmall : fmaxf(carry, before);
        const float vd = (j >= min_j) ? (ldel + leps * (float)(j - 1)) + run_prev : kSmall;
        float vd_left = __shfl_up_sync(0xffffffffu, vd, 1);
        if (lane == 0) vd_left = vd_carry;
        if (in) {
          nvd[j] = vd;
          if (j > wlo) {
            const float mb = nvm[j - 1] + ldel, db = vd_left + leps;
            tbd[j] = pack(who_self, mb >= db ? kM : kD, j - 1);
          }
        }
        carry = fmaxf(carry, __shfl_sync(0xffffffffu, incl, 31));
        vd_carry = __shfl_sync(0xffffffffu, vd, 31);
      }
    }
    __syncthreads();
    // delete-state branch of each range's first cell (needs j-1 of the
    // neighbouring warp, visible after the barrier)
    if (lane == 0 && wlo < whi) {
      for (int s = g; s < S; s += ngroups) {
        const float* nvm = st(nb, 0, s);
        const float* nvd = st(nb, 2, s);
        const float mb = (wlo == 0 ? kSmall : nvm[wlo - 1]) + ldel;
        const float db = (wlo == 0 ? kSmall : nvd[wlo - 1]) + leps;
        tbp(2, col, s)[wlo] = pack(s + 1, mb >= db ? kM : kD, max(wlo - 1, 0));
      }
    }
  }
  __syncthreads();

  // ---- traceback (thread 0), the while_loop of _tesserae_traceback
  if (tid == 0) {
    int* cells = out + 2;
    cells[0] = who;
    cells[1] = cst;
    cells[2] = pos;
    int n = 1, pt = L;
    int w_ = who, s_ = cst, p_ = pos;
    while (pt >= 1 && n < cap) {
      int sidx = w_ - 1;
      if (sidx < 0) sidx += S;  // jnp indexing wraps a negative index
      const size_t at = ((size_t)sidx * W) + p_;
      int v;
      if (s_ == kM) {
        v = pt >= 2 ? tb[((size_t)0 * (L + 1) + pt) * SW + at] : 0;
      } else if (s_ == kI) {
        v = pt >= 2 ? tb[((size_t)1 * (L + 1) + pt) * SW + at] : 0;
      } else {
        v = tb[((size_t)2 * (L + 1) + pt) * SW + at];
      }
      const int wn = v >> 25, sn = (v >> 23) & 3, pn = v & ((1 << 23) - 1);
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

}  // namespace

extern "C" int ctk_tesserae(const int* q, const int* t_codes,
                            const unsigned char* valid, const float* params,
                            int L, int S, int W, int threads, float* state,
                            int* tb, int* out, int cap, cudaStream_t stream) {
  if (threads <= 0 || threads > kMaxThreads || threads % 32 || S < 1 ||
      S > kMaxTargetSlots || L < 1 || W < 2 || cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  tesserae_kernel<<<1, threads, 0, stream>>>(q, t_codes, valid, params, L, S, W,
                                             state, tb, out, cap);
  return (int)cudaGetLastError();
}
