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
// (one warp per alignment, band/32 cells a lane, shuffles only) and, for
// the full-matrix mode of sw_device.py:236, tile the subject.

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

}  // namespace

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
