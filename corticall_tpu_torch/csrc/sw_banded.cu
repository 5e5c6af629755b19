// Batched banded local Smith-Waterman with affine gaps (score + end cell).
//
// Replaces corticall_tpu/ops/sw_device.py::_sw_banded_pallas_jit (line 366,
// its TPU kernel call at line 477), the production pre-score of
// models/contig_aligner.align_contigs.  Same
// contract: int32 codes with 4 = pad/N, band % 8 == 0, scores MATCH 5 /
// MISMATCH -4 / GAP_OPEN 10 / GAP_EXTEND 0.5 (models/sw.py); returns the best
// cell's score and 1-based inclusive (q_end, s_end), all zero when no cell
// scores above 0; ties go to the earliest row, then the lowest band cell.
//
// Form: one thread block per alignment, one thread per band cell (blockDim =
// band rounded up to a warp).  The block loops over query rows.  Cell c of
// row i is subject column jj = i - band/2 + c; it reads s[jj] directly (no
// sliding window).  Its diagonal feed is its own H of the previous row, the
// vertical feed is cell c+1 of the previous row (shared memory, double
// buffered by row parity).  The horizontal gap is the closed form
//   E[c] = max_{t<c}(H[t] + ext*t) - ext*c - open,
// an exclusive max-scan over the band: warp shuffles, then the totals of the
// warps before this one from shared memory.  Each cell keeps its best value
// and the first row reaching it in registers; one thread applies the tie
// rule over the band at the end.  Every value is a multiple of 0.5 and far
// from float32's limits, so the kernel is bit-identical to the plain twin
// (corticall_tpu_torch/ops/sw_device.py::banded_sw_scores).
//
// Bound on this card: two block-wide barriers per query row, so a row costs
// a few hundred cycles whatever the band; with 512 threads a block, four
// blocks share an SM, and the 4096-row production shape is latency-bound,
// not bandwidth-bound (the inputs are 12 KiB per alignment).  A later PR
// would drop the barriers by giving each warp several cells in registers
// (one warp per alignment, band/32 cells a lane, shuffles only).
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
constexpr int kMaxBand = 1024;

__global__ void __launch_bounds__(kMaxBand)
sw_banded_kernel(const int* __restrict__ q, const int* __restrict__ s,
                 int qlen, int slen, int band, float* __restrict__ score,
                 int* __restrict__ q_end, int* __restrict__ s_end) {
  __shared__ float h_sh[2][kMaxBand];
  __shared__ float f_sh[2][kMaxBand];
  __shared__ float warp_run[2][kMaxBand / 32];
  __shared__ float best_sh[kMaxBand];
  __shared__ int row_sh[kMaxBand];

  const int c = threadIdx.x;
  const int lane = c & 31;
  const int warp = c >> 5;
  const int half = band / 2;
  const bool is_cell = c < band;
  const int* qb = q + (size_t)blockIdx.x * qlen;
  const int* sb = s + (size_t)blockIdx.x * slen;
  const float cf = (float)c;

  // row -1 state: cells left of subject column 0 are -inf, the rest 0
  float h = (c - half >= 0) ? 0.0f : kNeg;
  float f = kNeg;
  float best = 0.0f;
  int best_row = 0;

  for (int i = 0; i < qlen; ++i) {
    const int p = i & 1;
    h_sh[p][c] = h;
    f_sh[p][c] = f;
    __syncthreads();
    const float up_h = (c + 1 < band) ? h_sh[p][c + 1] : kNeg;
    const float up_f = (c + 1 < band) ? f_sh[p][c + 1] : kNeg;

    const int jj = i - half + c;
    const bool valid = is_cell && jj >= 0 && jj < slen;
    // the virtual column jj == -1 reads 0: it feeds next row's jj == 0
    // diagonally (a local alignment may start at subject 0 on any row)
    const float fill = (jj == -1) ? 0.0f : kNeg;
    const int qc = qb[i];
    const int sc = valid ? sb[jj] : 4;
    const float sub = (qc == sc && qc < 4) ? kMatch : kMismatch;

    const float fn = fmaxf(up_f - kGapExtend, (up_h - kGapOpen) - kGapExtend);
    float hn = fmaxf(fmaxf(h + sub, fn), 0.0f);
    hn = valid ? hn : fill;

    float run = (valid ? hn : kNeg) + kGapExtend * cf;
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, run, d);
      if (lane >= d) run = fmaxf(run, o);
    }
    float excl = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) excl = kNeg;
    if (lane == 31) warp_run[p][warp] = run;
    __syncthreads();
    for (int w = 0; w < warp; ++w) excl = fmaxf(excl, warp_run[p][w]);
    const float e = (excl - kGapExtend * cf) - kGapOpen;
    hn = valid ? fmaxf(fmaxf(hn, e), 0.0f) : fill;

    // strict > keeps the earliest row per cell
    if (hn > best) {
      best = hn;
      best_row = i;
    }
    h = hn;
    f = fn;
  }

  best_sh[c] = best;
  row_sh[c] = best_row;
  __syncthreads();
  if (c == 0) {
    float bv = best_sh[0];
    int br = row_sh[0];
    int bc = 0;
    for (int t = 1; t < band; ++t) {
      const float v = best_sh[t];
      const int r = row_sh[t];
      if (v > bv || (v == bv && r < br)) {
        bv = v;
        br = r;
        bc = t;
      }
    }
    const bool found = bv > 0.0f;
    score[blockIdx.x] = found ? bv : 0.0f;
    q_end[blockIdx.x] = found ? br + 1 : 0;
    s_end[blockIdx.x] = found ? br - half + bc + 1 : 0;
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

extern "C" int ctk_sw_banded(const int* q, const int* s, int batch, int qlen,
                             int slen, int band, float* score, int* q_end,
                             int* s_end, cudaStream_t stream) {
  if (band <= 0 || band > kMaxBand) return (int)cudaErrorInvalidValue;
  const int threads = (band + 31) / 32 * 32;
  sw_banded_kernel<<<batch, threads, 0, stream>>>(q, s, qlen, slen, band,
                                                  score, q_end, s_end);
  return (int)cudaGetLastError();
}

extern "C" const char* ctk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
