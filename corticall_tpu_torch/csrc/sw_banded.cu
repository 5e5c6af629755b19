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
// corticall_tpu_torch/ops/sw_device.py::sw_full_scores.  A band-masked call
// whose band ctk_sw_banded takes goes to the banded kernel instead
// (ops/sw_device.py::sw_full_form): there the two twins are equal.
//
// Form: the banded kernel's machinery with a full start.  One warp owns a
// tile of up to 1,024 subject columns, C a lane in registers (H, F, subject
// selector, each column's best value and first row), in integer half-units
// on DPX, the tie rule applied at the end by `better`.  A row is
// cells_update / cells_finish with no sliding: the slots are the columns.
// Subjects of up to 1,024 columns are one warp an alignment, one alignment a
// block.  Longer ones (up to kMaxFullS = 8192) are a block of ceil(S/1024)
// warps, warp w owning columns [w * 32C, (w + 1) * 32C) and running one
// query row behind warp w - 1: a row's E carry (max over the columns left
// of the tile of H + column, in half-units) and the tile's last H (the next
// row's diagonal feed at the tile edge) go from warp w - 1 to warp w through
// a ring of kFullRing slots in shared memory, handed over by a per-warp
// count of finished rows (release / acquire at block scope); no
// __syncthreads in the row loop.  A warp waits for its left neighbour only
// after its own in-warp scan, and for its right neighbour only when it runs
// kFullRing rows ahead.  What bounds it is the row's dependent chain, as in
// the banded kernel: all alignments are resident at once.

#include <cuda_runtime.h>

namespace {

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

constexpr int kFullWarpCols = 1024;  // columns a warp's tile holds at most
constexpr int kMaxFullS = 8192;
constexpr int kMaxFullWarps = kMaxFullS / kFullWarpCols;
constexpr int kFullRing = 16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" :: "r"(smem_addr(p)), "r"(v) : "memory");
}

template <int C>
__global__ void __launch_bounds__(kMaxFullWarps * 32)
sw_full_kernel(const int* __restrict__ q, const int* __restrict__ s, int qlen,
               int slen, int band, float* __restrict__ score,
               int* __restrict__ q_end, int* __restrict__ s_end) {
  // ring[w][i % kFullRing] = (max_{t < tile end}(H[i][t] + t), H[i][tile end - 1])
  __shared__ int2 ring[kMaxFullWarps][kFullRing];
  __shared__ int done[kMaxFullWarps];  // rows warp w has published
  __shared__ int best_sh[kMaxFullWarps][3];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int j0 = (warp * 32 + lane) * C;      // this lane's first column
  const int tile_end = (warp + 1) * 32 * C;
  const int* qb = q + (size_t)blockIdx.x * qlen;
  const int* sb = s + (size_t)blockIdx.x * slen;
  const int half = band >> 1;

  int h[C], f[C], sc[C], bv[C], br[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const bool in = j0 + k < slen;
    sc[k] = code_selector(in ? sb[j0 + k] : 4);
    h[k] = in ? 0 : kNeg2;  // row -1: every subject column starts at 0
    f[k] = kNeg2;
    bv[k] = 0;
    br[k] = 0;
  }
  if (lane == 0) done[warp] = 0;
  __syncthreads();

  // H[i-1][tile start - 1], the diagonal feed of the tile's first column: 0
  // at row -1 and at column 0
  int edge = 0;
  int qc = qlen > 0 ? qb[0] : 4;
  for (int i = 0; i < qlen; ++i) {
    const int qn = i + 1 < qlen ? qb[i + 1] : 4;
    const int lo = band > 0 ? i - half : 0;
    const int hi = band > 0 ? min(i + half, slen) : slen;
    const bool mask = lo > warp * 32 * C || min(tile_end, slen) > hi;
    const int hl = __shfl_up_sync(kFull, h[C - 1], 1);
    int diag[C], uh[C], uf[C], hn[C], pre[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      diag[k] = k > 0 ? h[k > 0 ? k - 1 : 0] : (lane ? hl : edge);
      uh[k] = h[k];
      uf[k] = f[k];
    }
    const unsigned off = (unsigned)(j0 - lo);
    const unsigned width = (unsigned)max(hi - lo, 0);
    int tot = (mask ? cells_update<C, true>(diag, uh, uf, sc, qc, off, width, f, hn, pre)
                    : cells_update<C, false>(diag, uh, uf, sc, qc, off, width, f, hn, pre)) + j0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) tot = max(tot, __shfl_up_sync(kFull, tot, d));
    int carry = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) carry = kNeg2;
    if (warp > 0) {
      while (ld_acquire(&done[warp - 1]) <= i) {
      }
      const int2 in = ring[warp - 1][i % kFullRing];
      carry = max(carry, in.x);
      tot = max(tot, in.x);
      edge = in.y;
    }
    if (mask)
      cells_finish<C, true>(carry - j0, hn, pre, i, h, bv, br);
    else
      cells_finish<C, false>(carry - j0, hn, pre, i, h, bv, br);
    // every lane's read of ring[warp - 1] happens before lane 31's release
    // lets the left warp overwrite that slot
    __syncwarp();
    if (warp + 1 < nwarps) {
      // the right neighbour has read the slot this row overwrites
      while (ld_acquire(&done[warp + 1]) < i + 1 - kFullRing) {
      }
      if (lane == 31) {
        ring[warp][i % kFullRing] = make_int2(tot, h[C - 1]);
        st_release(&done[warp], i + 1);
      }
    } else if (lane == 31) {
      st_release(&done[warp], i + 1);
    }
    qc = qn;
  }

  // best value, then earliest row, then lowest column
  int bestv = 0, bestr = 0, bestc = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if (j0 + k < slen && better(bv[k], br[k], j0 + k, bestv, bestr, bestc)) {
      bestv = bv[k];
      bestr = br[k];
      bestc = j0 + k;
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
    best_sh[warp][0] = bestv;
    best_sh[warp][1] = bestr;
    best_sh[warp][2] = bestc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nwarps; ++w) {
      if (better(best_sh[w][0], best_sh[w][1], best_sh[w][2], bestv, bestr, bestc)) {
        bestv = best_sh[w][0];
        bestr = best_sh[w][1];
        bestc = best_sh[w][2];
      }
    }
    const bool found = bestv > 0;
    score[blockIdx.x] = found ? (float)bestv * 0.5f : 0.0f;
    q_end[blockIdx.x] = found ? bestr + 1 : 0;
    s_end[blockIdx.x] = found ? bestc + 1 : 0;
  }
}

}  // namespace

// band 0: the full matrix.  cells: columns a lane, warps: warps an alignment
// (1..8, 32 * warps * cells >= slen; sw_device.sw_full_config picks them).
extern "C" int ctk_sw_full(const int* q, const int* s, int batch, int qlen,
                           int slen, int band, int cells, int warps, float* score,
                           int* q_end, int* s_end, cudaStream_t stream) {
  if (batch <= 0 || qlen < 0 || qlen > kMaxQ || slen < 0 || slen > kMaxFullS || band < 0 ||
      warps < 1 || warps > kMaxFullWarps || 32 * warps * cells < slen)
    return (int)cudaErrorInvalidValue;
#define CTK_SW_FULL(C)                                                               \
  case C:                                                                            \
    sw_full_kernel<C><<<batch, 32 * warps, 0, stream>>>(q, s, qlen, slen, band, score, \
                                                         q_end, s_end);              \
    break;
  switch (cells) {
    CTK_SW_FULL(1)
    CTK_SW_FULL(2)
    CTK_SW_FULL(4)
    CTK_SW_FULL(6)
    CTK_SW_FULL(8)
    CTK_SW_FULL(12)
    CTK_SW_FULL(16)
    CTK_SW_FULL(24)
    CTK_SW_FULL(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CTK_SW_FULL
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
