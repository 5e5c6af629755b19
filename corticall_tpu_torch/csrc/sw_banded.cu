// Batched banded local Smith-Waterman with affine gaps (score + end cell).
//
// ctk_sw_banded replaces corticall_tpu/ops/sw_device.py::_sw_banded_pallas_jit
// (line 366, its TPU kernel call at line 477), the production pre-score of
// models/contig_aligner.align_contigs; banded_sw_pallas (line 133, TPU
// kernel call at line 188) has the same contract and takes the same kernel.
// Contract: int32 codes with 4 = pad/N, band % 8 == 0, band <= 1024, scores
// MATCH 5 / MISMATCH -4 / GAP_OPEN 10 / GAP_EXTEND 0.5 (models/sw.py); row i
// scores subject columns [i - band/2, i + band/2); returns the best cell's
// score and 1-based inclusive (q_end, s_end), all zero when no cell scores
// above 0; ties go to the earliest row, then the lowest band cell.  Plain
// twin: corticall_tpu_torch/ops/sw_device.py::banded_sw_scores, which this
// kernel equals bit for bit.
//
// What bounds it: not bytes (a window's inputs are a few KiB) nor
// arithmetic (~12 operations a cell), but the chain of Q dependent query
// rows, each a prefix-max scan along the row.  The kernel's design is about
// making one row short:
//
// - One warp a window, one window a block (sw_kernel_config in
//   ops/sw_device.py picks the cells a lane).  A row needs no barrier of any
//   kind: lane L holds C consecutive cells in registers (H, F, subject code,
//   and each cell's best value and the first row reaching it).  A row is
//   the in-lane update, the horizontal-gap prefix (an in-lane run, then a
//   five-step __shfl_up_sync max-scan over the lane totals), then the E
//   pass.  The vertical and diagonal feeds are in registers except at a
//   lane's edge, which takes one shuffle.
// - Only subject columns are computed.  The warp's n = min(band, S) slots
//   cover columns [base, base + n) with base = clamp(i - band/2, 0, S - n):
//   while the band lies inside the subject the slots slide with it (slot s
//   is band cell s, the state shifts down one slot by a shuffle, and the new
//   right column reads its subject code), and where the band overhangs an
//   end of the subject the slots stay put (slot s is column base + s).  A
//   slot outside the band holds -inf; the twin's fills (0 at column -1,
//   -inf outside the subject) are applied by rule, so every feed equals the
//   twin's.  Rows whose slots all lie in the band skip the masks.
// - Integer half-units on Hopper's DPX instructions.  Every value is a
//   multiple of 0.5 and |H| <= 5 Q, so doubled scores are exact in int32;
//   __viaddmax_s32 (max(a + b, c)) and __viaddmax_s32_relu (max(a + b, c,
//   0)) do a cell's F and H in two instructions.  The result converts back
//   with an exact x 0.5, so --fmad=false plays no part here.  -inf is kNeg2
//   = -2^30: with Q <= 2^20 and S <= 2^27 (the entry point refuses more) no
//   sum of kNeg2 and a column index, a score or a gap cost leaves int32, and
//   every such sum stays below every real score.
// - The tie rule is applied once, at the end: each slot keeps its best value
//   and the first row reaching it (strict >), its column follows from that
//   row's base, and the window reduces (value desc, row asc, column asc).
//   The column order within a row is the band-cell order, so any ownership
//   of cells gives the twin's answer.
//
// Other forms were measured on an H100 and gained nothing (PERF.md): a
// wavefront (lane L a query row behind lane L - 1, the horizontal carry one
// shuffle a step, no scan) was ~1.3x slower a row for subjects narrower
// than the band, and windows of 2 or 4 warps meeting at a named barrier a
// row took as long a row as one warp, as did loading the query codes 32
// rows ahead and putting 2-4 windows in a block: a row's time is the
// latency of its dependent chain (the lane-edge feed, the in-lane run, the
// scan's six shuffles), ~0.25-0.4 us, not the instruction throughput of its
// cells nor its loads.
//
// ctk_sw_full replaces corticall_tpu/ops/sw_device.py::_sw_pallas_jit (line
// 236, its TPU kernel call at line 328): local SW over the full matrix, or
// band-masked (row i scores subject columns [i - band/2, i + band/2)), with
// that kernel's own semantics -- every subject column starts at H = 0, the
// diagonal feed of column 0 is 0, cells outside the band are -inf -- and
// its tie rule: the earliest row whose best strictly beats the running
// best, then the first column of that row.  Plain twin:
// corticall_tpu_torch/ops/sw_device.py::sw_full_scores.
//
// Form: one block per alignment; the subject is tiled across the block,
// thread t owning the C consecutive columns [t*C, t*C + C) in registers
// (H, F, subject code, and each column's best value and the first row that
// reached it).  A row: every thread publishes its last column's H of the
// previous row (the next thread's diagonal feed), a barrier, the row update
// of its C columns, the horizontal-gap prefix as a block-wide max-scan (the
// in-thread run, warp shuffles over the thread totals, the warp totals in
// shared memory after a second barrier), then the E pass over the columns.
// The best cell is found once at the end from the per-column bests, which
// gives the tie rule above: the earliest row holding the final best value,
// then the lowest column in it.  C is 8 up to S = 4096 (at most 512
// threads) and 16 up to kMaxFullS = 8192; longer subjects are refused.
// Bound: two barriers and C columns a row, latency-bound like the banded
// kernel; the inputs are a few KiB an alignment.

#include <cuda_runtime.h>

namespace {

constexpr float kMatch = 5.0f;
constexpr float kMismatch = -4.0f;
constexpr float kGapOpen = 10.0f;
constexpr float kGapExtend = 0.5f;
constexpr float kNeg = -1e30f;

// the banded kernel's integer half-units: GAP_EXTEND, GAP_OPEN and
// GAP_OPEN + GAP_EXTEND, doubled (MATCH 10 and MISMATCH -8 are bytes of the
// substitution table below)
constexpr int kExt2 = 1;
constexpr int kOpen2 = 20;
constexpr int kOpenExt2 = 21;
constexpr int kNeg2 = -(1 << 30);
constexpr int kMaxBand = 1024;
constexpr int kMaxQ = 1 << 20;
constexpr int kMaxS = 1 << 27;
constexpr unsigned kFull = 0xffffffffu;

// The substitution score is one byte permute: a slot holds its subject
// code's prmt selector (byte c of an 8-byte table, sign-extended), and a
// row's table has MATCH at byte qc when qc is a base (0..3) and MISMATCH
// elsewhere, bytes 4..7 included.  Codes other than 0..3 read as N (byte 4).
constexpr unsigned kMismatchBytes = 0xF8F8F8F8u;   // int8 -8 in every byte

__device__ __forceinline__ int code_selector(int code) {
  const unsigned b = (unsigned)code < 4u ? (unsigned)code : 4u;
  return (int)(b | ((b | 8u) << 4) | ((b | 8u) << 8) | ((b | 8u) << 12));
}

__device__ __forceinline__ unsigned row_table(int qc) {
  return (unsigned)qc < 4u ? kMismatchBytes ^ ((0xF8u ^ 0x0Au) << (8 * qc))
                           : kMismatchBytes;
}

__device__ __forceinline__ int substitution(unsigned table, int selector) {
  int out;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(out) : "r"(table), "r"(kMismatchBytes), "r"(selector));
  return out;
}

__device__ __forceinline__ int base_of(int i, int half, int maxbase) {
  return min(max(i - half, 0), maxbase);
}

// (value, row, column) a is better than b: value desc, row asc, column asc
__device__ __forceinline__ bool better(int va, int ra, int ca, int vb, int rb, int cb) {
  return va > vb || (va == vb && (ra < rb || (ra == rb && ca < cb)));
}

// The cell update of one query row on a lane's C slots (columns j0 .. j0 +
// C - 1), given each slot's diagonal and vertical feeds.  Column offsets
// within the lane are immediates (k); pre[k] = max_{1<=t<=k}(H[t] + t)
// leaves slot 0 off the chain, so a shuffle that feeds slot 0 overlaps the
// other slots' work.  MASK: slots outside the band (off + k >= width, in
// unsigned arithmetic) get H = -inf; their F needs no mask, since a column
// right of the band has held H = -inf from the start (its F stays near
// -inf until it enters) and a column left of the band never returns.
// Returns the lane's max(H[t] + t).
template <int C, bool MASK>
__device__ __forceinline__ int cells_update(const int (&diag)[C], const int (&uh)[C],
                                            const int (&uf)[C], const int (&sc)[C],
                                            int qc, unsigned off, unsigned width,
                                            int (&f)[C], int (&hn)[C], int (&pre)[C]) {
  const unsigned table = row_table(qc);
  int run = kNeg2;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int fv = __viaddmax_s32(uf[k], -kExt2, uh[k] - kOpenExt2);
    const int hv = MASK && off + k >= width
                       ? kNeg2
                       : __viaddmax_s32_relu(diag[k], substitution(table, sc[k]), fv);
    f[k] = fv;
    hn[k] = hv;
    if (k > 0) {
      run = __viaddmax_s32(hv, k, run);
      pre[k] = run;
    }
  }
  return max(run, hn[0]);
}

// The horizontal gap and the new H: E = max_{t<k}(H[t] + t) - k - open
// over the lane's slots and `carry` (the left lanes' max(H[t] + t), in this
// lane's offsets); H = max(H, E) (H >= 0 in the band).  Strict > keeps the
// earliest row per slot.
template <int C, bool MASK>
__device__ __forceinline__ void cells_finish(int carry, const int (&hn)[C],
                                             const int (&pre)[C], int row, int (&h)[C],
                                             int (&bv)[C], int (&br)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = k == 0 ? carry
                : k == 1 ? max(carry, hn[0])
                         : __vimax3_s32(carry, hn[0], pre[k > 1 ? k - 1 : 1]);
    const int hv = hn[k];
    int out = __viaddmax_s32(c, -(k + kOpen2), hv);
    if (MASK) out = hv < 0 ? kNeg2 : out;
    h[k] = out;
    if (out > bv[k]) {
      bv[k] = out;
      br[k] = row;
    }
  }
}

// One query row of one window, in place on the lane's C slots.
// SLIDE: the slots moved one column right since the previous row (slot s
// takes slot s + 1's state; the slot at n - 1 is the band's new right
// column, fed -inf from above and `newcode` as its subject code); otherwise
// slot s is the same column as before.  MASK: some slots lie outside the
// band's columns [lo, hi).
template <int C, bool SLIDE, bool MASK>
__device__ __forceinline__ void sw_row(int (&h)[C], int (&f)[C], int (&sc)[C],
                                       int (&bv)[C], int (&br)[C], int i,
                                       int qc, int base, int lane, int n,
                                       int lo, int hi, int newcode) {
  int diag[C], uh[C], uf[C], hn[C], pre[C];
  if (SLIDE) {
    const int h0 = __shfl_down_sync(kFull, h[0], 1);
    const int f0 = __shfl_down_sync(kFull, f[0], 1);
    const int s0 = __shfl_down_sync(kFull, sc[0], 1);
    const int klast = n - 1 - lane * C;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const bool last = k == klast;
      diag[k] = h[k];
      uh[k] = last ? kNeg2 : (k + 1 < C ? h[k + 1 < C ? k + 1 : k] : h0);
      uf[k] = last ? kNeg2 : (k + 1 < C ? f[k + 1 < C ? k + 1 : k] : f0);
      sc[k] = last ? newcode : (k + 1 < C ? sc[k + 1 < C ? k + 1 : k] : s0);
    }
  } else {
    // lane 0's slot 0 is column 0 (its diagonal feed is column -1's fill,
    // 0) or lies left of the band
    const int hl = __shfl_up_sync(kFull, h[C - 1], 1);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      diag[k] = k > 0 ? h[k > 0 ? k - 1 : 0] : (lane ? hl : 0);
      uh[k] = h[k];
      uf[k] = f[k];
    }
  }
  const int j0 = base + lane * C;
  const unsigned off = (unsigned)(j0 - lo);
  const unsigned width = (unsigned)max(hi - lo, 0);
  int tot = cells_update<C, MASK>(diag, uh, uf, sc, qc, off, width, f, hn, pre) + j0;
  // exclusive max-scan of the lane totals across the warp (a lane below
  // the shuffle's distance reads its own value, which leaves it unchanged)
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) tot = max(tot, __shfl_up_sync(kFull, tot, d));
  const int carry = __shfl_up_sync(kFull, tot, 1);
  cells_finish<C, MASK>((lane ? carry : kNeg2) - j0, hn, pre, i, h, bv, br);
}

// One warp a window, one window a block.
template <int C>
__global__ void __launch_bounds__(32)
sw_banded_kernel(const int* __restrict__ q, const int* __restrict__ s,
                 int batch, int qlen, int slen, int band,
                 float* __restrict__ score, int* __restrict__ q_end,
                 int* __restrict__ s_end) {
  const int lane = threadIdx.x & 31;
  // The window index goes through threadIdx although a block is one warp:
  // from blockIdx alone (uniform across the warp) the same kernel took
  // 7-10% longer a row on an H100 at the band-512 shapes (PERF.md).
  const int win = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (win >= batch) return;
  const int* qb = q + (size_t)win * qlen;
  const int* sb = s + (size_t)win * slen;
  const int half = band >> 1;
  const int n = min(band, slen);
  const int maxbase = slen - n;

  int bestv = 0, bestr = 0, bestc = 0;
  if (n > 0 && qlen > 0) {
    // row -1: 0 at columns -1 .. band/2 - 2 (the band's in-subject part),
    // -inf elsewhere; base 0
    int h[C], f[C], sc[C], bv[C], br[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int slot = lane * C + k;
      h[k] = (slot < n && slot < half - 1) ? 0 : kNeg2;
      f[k] = kNeg2;
      sc[k] = code_selector(slot < n ? sb[slot] : 4);
      bv[k] = 0;
      br[k] = 0;
    }
    int base = 0;
    int qc = qb[0];
    int newcode = code_selector(sb[base_of(0, half, maxbase) + n - 1]);
    for (int i = 0; i < qlen; ++i) {
      const int nb = base_of(i, half, maxbase);
      const bool slide = nb != base;
      base = nb;
      const int lo = i - half;
      const int hi = min(i + half, slen);
      // prefetch the next row's query code and new right column's code
      const int qn = i + 1 < qlen ? qb[i + 1] : 4;
      const int cn = code_selector(sb[base_of(i + 1, half, maxbase) + n - 1]);
      if (slide)  // the slots are exactly the band's columns
        sw_row<C, true, false>(h, f, sc, bv, br, i, qc, base, lane, n, lo, hi, newcode);
      else if (base >= lo && base + n <= hi)
        sw_row<C, false, false>(h, f, sc, bv, br, i, qc, base, lane, n, lo, hi, newcode);
      else
        sw_row<C, false, true>(h, f, sc, bv, br, i, qc, base, lane, n, lo, hi, newcode);
      qc = qn;
      newcode = cn;
    }
    // the lane's best slot: value desc, row asc, column asc
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int slot = lane * C + k;
      const int col = base_of(br[k], half, maxbase) + slot;
      if (slot < n && better(bv[k], br[k], col, bestv, bestr, bestc)) {
        bestv = bv[k];
        bestr = br[k];
        bestc = col;
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int v = __shfl_xor_sync(kFull, bestv, d);
    const int r = __shfl_xor_sync(kFull, bestr, d);
    const int c = __shfl_xor_sync(kFull, bestc, d);
    if (better(v, r, c, bestv, bestr, bestc)) {
      bestv = v;
      bestr = r;
      bestc = c;
    }
  }
  if (lane == 0) {
    const bool found = bestv > 0;
    score[win] = found ? (float)bestv * 0.5f : 0.0f;
    q_end[win] = found ? bestr + 1 : 0;
    s_end[win] = found ? bestc + 1 : 0;
  }
}

constexpr int kMaxFullThreads = 512;
constexpr int kMaxFullS = 8192;

template <int C>
__global__ void __launch_bounds__(kMaxFullThreads)
sw_full_kernel(const int* __restrict__ q, const int* __restrict__ s, int qlen,
               int slen, int band, float* __restrict__ score,
               int* __restrict__ q_end, int* __restrict__ s_end) {
  __shared__ float hlast_sh[kMaxFullThreads];
  __shared__ float warp_run[kMaxFullThreads / 32];
  __shared__ float best_sh[kMaxFullThreads];
  __shared__ int row_sh[kMaxFullThreads];
  __shared__ int col_sh[kMaxFullThreads];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int j0 = t * C;
  const int half = band / 2;
  const int* qb = q + (size_t)blockIdx.x * qlen;
  const int* sb = s + (size_t)blockIdx.x * slen;

  int sc[C];
  float h[C], f[C], bestv[C];
  int bestr[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const bool in = j0 + c < slen;
    sc[c] = in ? sb[j0 + c] : 4;
    h[c] = in ? 0.0f : kNeg;  // row -1: every subject column starts at 0
    f[c] = kNeg;
    bestv[c] = 0.0f;
    bestr[c] = 0;
  }

  for (int i = 0; i < qlen; ++i) {
    hlast_sh[t] = h[C - 1];
    __syncthreads();
    const float diag0 = t ? hlast_sh[t - 1] : 0.0f;
    const int qc = qb[i];
    // descending, so h[c - 1] is still the previous row's
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {
      const int j = j0 + c;
      const bool valid = j < slen && (band <= 0 || (j >= i - half && j < i + half));
      const float d = c ? h[c > 0 ? c - 1 : 0] : diag0;
      const float sub = (qc == sc[c] && qc < 4) ? kMatch : kMismatch;
      const float fn = fmaxf(f[c] - kGapExtend, (h[c] - kGapOpen) - kGapExtend);
      const float hn = fmaxf(fmaxf(d + sub, fn), 0.0f);
      f[c] = fn;
      h[c] = valid ? hn : kNeg;
    }
    // E[j] = max_{t<j}(H[t] + ext*t) - ext*j - open: block-wide max-scan
    float run = kNeg;
#pragma unroll
    for (int c = 0; c < C; ++c) run = fmaxf(run, h[c] + kGapExtend * (float)(j0 + c));
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, run, d);
      if (lane >= d) run = fmaxf(run, o);
    }
    float carry = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) carry = kNeg;
    if (lane == 31) warp_run[warp] = run;
    __syncthreads();
    for (int w = 0; w < warp; ++w) carry = fmaxf(carry, warp_run[w]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const float cf = (float)j;
      const bool valid = j < slen && (band <= 0 || (j >= i - half && j < i + half));
      const float e = (carry - kGapExtend * cf) - kGapOpen;
      carry = fmaxf(carry, h[c] + kGapExtend * cf);
      const float hn = valid ? fmaxf(fmaxf(h[c], e), 0.0f) : kNeg;
      h[c] = hn;
      // strict > keeps the earliest row per column
      if (hn > bestv[c]) {
        bestv[c] = hn;
        bestr[c] = i;
      }
    }
  }

  // best value, then earliest row, then lowest column
  float bv = bestv[0];
  int br = bestr[0], bc = j0;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    if (bestv[c] > bv || (bestv[c] == bv && bestr[c] < br)) {
      bv = bestv[c];
      br = bestr[c];
      bc = j0 + c;
    }
  }
  best_sh[t] = bv;
  row_sh[t] = br;
  col_sh[t] = bc;
  __syncthreads();
  if (t == 0) {
    for (int u = 1; u < (int)blockDim.x; ++u) {
      const float v = best_sh[u];
      const int r = row_sh[u];
      if (v > bv || (v == bv && r < br)) {
        bv = v;
        br = r;
        bc = col_sh[u];
      }
    }
    const bool found = bv > 0.0f;
    score[blockIdx.x] = found ? bv : 0.0f;
    q_end[blockIdx.x] = found ? br + 1 : 0;
    s_end[blockIdx.x] = found ? bc + 1 : 0;
  }
}

}  // namespace

extern "C" int ctk_sw_full(const int* q, const int* s, int batch, int qlen,
                           int slen, int band, float* score, int* q_end,
                           int* s_end, cudaStream_t stream) {
  if (batch <= 0 || qlen < 0 || slen < 0 || slen > kMaxFullS)
    return (int)cudaErrorInvalidValue;
  const int c = slen <= 8 * kMaxFullThreads ? 8 : 16;
  const int threads = max(32, (slen + c * 32 - 1) / (c * 32) * 32);
  if (c == 8)
    sw_full_kernel<8><<<batch, threads, 0, stream>>>(q, s, qlen, slen, band,
                                                      score, q_end, s_end);
  else
    sw_full_kernel<16><<<batch, threads, 0, stream>>>(q, s, qlen, slen, band,
                                                       score, q_end, s_end);
  return (int)cudaGetLastError();
}

// cells: slots a lane (1, 2, 4, 6, 8, 12, 16, 24 or 32, with 32 * cells >=
// min(band, slen)).
extern "C" int ctk_sw_banded(const int* q, const int* s, int batch, int qlen,
                             int slen, int band, int cells, float* score,
                             int* q_end, int* s_end, cudaStream_t stream) {
  if (batch <= 0 || band <= 0 || band > kMaxBand || band % 8 || qlen < 0 ||
      qlen > kMaxQ || slen < 0 || slen > kMaxS || 32 * cells < min(band, slen))
    return (int)cudaErrorInvalidValue;
#define CTK_SW_BANDED(C)                                                  \
  case C:                                                                 \
    sw_banded_kernel<C><<<batch, 32, 0, stream>>>(                        \
        q, s, batch, qlen, slen, band, score, q_end, s_end);              \
    break;
  switch (cells) {
    CTK_SW_BANDED(1)
    CTK_SW_BANDED(2)
    CTK_SW_BANDED(4)
    CTK_SW_BANDED(6)
    CTK_SW_BANDED(8)
    CTK_SW_BANDED(12)
    CTK_SW_BANDED(16)
    CTK_SW_BANDED(24)
    CTK_SW_BANDED(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CTK_SW_BANDED
  return (int)cudaGetLastError();
}

extern "C" const char* ctk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
