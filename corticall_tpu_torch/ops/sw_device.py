"""Batched local Smith-Waterman: plain PyTorch twins + CUDA kernel wrappers.

Counterpart of corticall_tpu/ops/sw_device.py.  `banded_sw_scores` is the
PyTorch twin of the JAX scan (one query row per step, the band in the last
dimension, the horizontal-gap prefix in closed form with `torch.cummax`);
`sw_banded` runs it for CPU tensors and launches `csrc/sw_banded.cu`'s
banded kernel for CUDA tensors (one warp a window, one window a block;
`sw_kernel_config` picks its cells a lane); `banded_sw_pallas` is the same
contract under the JAX package's name.  `sw_full_scores` is the twin of the
JAX package's full-matrix (optionally band-masked) kernel, `sw_full` its
wrapper: a band-masked call whose band the banded kernel takes launches it
(`sw_full_form`), anything else `ctk_sw_full` (`sw_full_config` picks its
cells a lane and warps an alignment).  All return (score f32[B], q_end
i32[B], s_end i32[B]), ends 1-based inclusive, and each kernel equals its
twin bit for bit: every value is a multiple of 0.5.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels
from .. import kmer as km
from ..models.sw import GAP_EXTEND, GAP_OPEN, MATCH, MISMATCH

NEG = -1e30
MAX_BAND = 1024
MAX_FULL_S = 8192             # longest subject the full-matrix kernel takes
FULL_WARP_COLS = 1024         # columns one warp of the full-matrix kernel holds
# the banded kernel's limits (its -inf sentinel leaves int32 beyond them)
# and the cells a lane it is built for
MAX_Q = 1 << 20
MAX_S = 1 << 27
SW_CELLS = (1, 2, 4, 6, 8, 12, 16, 24, 32)

# kernel launches (plain integers; chip_smoke.py resets and reads them):
# LAUNCHES counts sw_banded's launches, FULL_LAUNCHES sw_full's (either form)
LAUNCHES = 0
FULL_LAUNCHES = 0


def codes_batch(strings, width: int) -> np.ndarray:
    """Pack strings into int32[B, width] codes padded with 4 (N)."""
    out = np.full((len(strings), width), 4, dtype=np.int32)
    for i, s in enumerate(strings):
        c = km.string_to_codes_permissive(s)[:width]
        out[i, :len(c)] = c
    return out


def banded_sw_scores(q_codes: torch.Tensor, s_codes: torch.Tensor,
                     band: int = 128):
    """Plain twin of corticall_tpu.ops.sw_device.banded_sw_scores.

    q_codes int32[B, Q], s_codes int32[B, S] (4 = pad/N).  Row i scores band
    cells c = 0..band-1 at subject columns i - band//2 + c.  Returns the best
    cell (earliest row, then lowest cell) as (score, q_end, s_end)."""
    bsz, qmax = q_codes.shape
    smax = s_codes.shape[1]
    dev = q_codes.device
    w, half = band, band // 2
    # padded subject: row i's window is s_pad[:, i:i+w] (subject i-half..)
    s_pad = torch.full((bsz, qmax + band), 4, dtype=torch.int32, device=dev)
    keep = min(smax, qmax + half)
    s_pad[:, half:half + keep] = s_codes[:, :keep]
    lane = torch.arange(w, dtype=torch.int32, device=dev)
    cc = lane.to(torch.float32)[None, :]
    neg_col = torch.full((bsz, 1), NEG, dtype=torch.float32, device=dev)

    h = torch.where(lane - half >= 0, 0.0, NEG).to(torch.float32).expand(bsz, w)
    f = torch.full((bsz, w), NEG, dtype=torch.float32, device=dev)
    best = torch.zeros(bsz, dtype=torch.float32, device=dev)
    bq = torch.zeros(bsz, dtype=torch.int32, device=dev)
    bs = torch.zeros(bsz, dtype=torch.int32, device=dev)
    for i in range(qmax):
        qc = q_codes[:, i:i + 1]
        s_win = s_pad[:, i:i + w]
        jj = (i - half) + lane
        valid = (jj >= 0) & (jj < smax)
        fill = torch.where(jj == -1, 0.0, NEG).to(torch.float32)
        sub = torch.where((qc == s_win) & (qc < 4), MATCH, MISMATCH).to(torch.float32)

        up_h = torch.cat([h[:, 1:], neg_col], dim=1)
        f = torch.maximum(torch.cat([f[:, 1:], neg_col], dim=1) - GAP_EXTEND,
                          up_h - GAP_OPEN - GAP_EXTEND)
        hn = torch.clamp_min(torch.maximum(h + sub, f), 0.0)
        hn = torch.where(valid, hn, fill)
        # E[c] = max_{t<c}(h[t] + ext*t) - ext*c - open
        adj = torch.where(valid, hn, NEG) + GAP_EXTEND * cc
        run = torch.cummax(adj, dim=1).values
        run_prev = torch.cat([neg_col, run[:, :-1]], dim=1)
        e = run_prev - GAP_EXTEND * cc - GAP_OPEN
        h = torch.where(valid, torch.clamp_min(torch.maximum(hn, e), 0.0), fill)

        row_best = h.amax(dim=1)
        row_arg = torch.where(h == row_best[:, None], lane, w).amin(dim=1)
        improved = row_best > best
        best = torch.where(improved, row_best, best)
        bq = torch.where(improved, i + 1, bq)
        bs = torch.where(improved, (i - half + 1) + row_arg, bs)
    return best, bq, bs


def sw_full_scores(q_codes: torch.Tensor, s_codes: torch.Tensor,
                   band: int | None = None):
    """Plain twin of corticall_tpu.ops.sw_device._sw_pallas_jit: local SW
    over the full [Q, S] matrix, or band-masked (row i scores subject
    columns [i - band//2, i + band//2)).  Every subject column starts at 0,
    column 0's diagonal feed is 0, masked cells are -inf.  The best cell is
    the first row whose best strictly beats the running best, then the first
    column of that row."""
    bsz, qmax = q_codes.shape
    smax = s_codes.shape[1]
    dev = q_codes.device
    col = torch.arange(smax, dtype=torch.int32, device=dev)
    cc = col.to(torch.float32)[None, :]
    half = band // 2 if band is not None else 0
    neg_col = torch.full((bsz, 1), NEG, dtype=torch.float32, device=dev)
    zero_col = torch.zeros((bsz, 1), dtype=torch.float32, device=dev)
    if smax == 0:
        return (zero_col[:, 0], torch.zeros(bsz, dtype=torch.int32, device=dev),
                torch.zeros(bsz, dtype=torch.int32, device=dev))

    h = torch.zeros((bsz, smax), dtype=torch.float32, device=dev)
    f = torch.full((bsz, smax), NEG, dtype=torch.float32, device=dev)
    best = torch.zeros(bsz, dtype=torch.float32, device=dev)
    bq = torch.zeros(bsz, dtype=torch.int32, device=dev)
    bs = torch.zeros(bsz, dtype=torch.int32, device=dev)
    for i in range(qmax):
        qc = q_codes[:, i:i + 1]
        valid = (torch.ones_like(col, dtype=torch.bool) if band is None
                 else (col >= i - half) & (col < i + half))
        sub = torch.where((qc == s_codes) & (qc < 4), MATCH, MISMATCH).to(torch.float32)
        diag = torch.cat([zero_col, h[:, :-1]], dim=1)
        f = torch.maximum(f - GAP_EXTEND, (h - GAP_OPEN) - GAP_EXTEND)
        hn = torch.clamp_min(torch.maximum(diag + sub, f), 0.0)
        hn = torch.where(valid, hn, NEG)
        run = torch.cummax(hn + GAP_EXTEND * cc, dim=1).values
        e = (torch.cat([neg_col, run[:, :-1]], dim=1) - GAP_EXTEND * cc) - GAP_OPEN
        h = torch.where(valid, torch.clamp_min(torch.maximum(hn, e), 0.0), NEG)

        row_best = h.amax(dim=1)
        row_arg = torch.where(h == row_best[:, None], col, smax).amin(dim=1)
        improved = row_best > best
        best = torch.where(improved, row_best, best)
        bq = torch.where(improved, i + 1, bq)
        bs = torch.where(improved, row_arg + 1, bs)
    return best, bq, bs


def _check_pair(q_codes, s_codes):
    if q_codes.dim() != 2 or s_codes.dim() != 2:
        raise ValueError("q_codes and s_codes must be 2-D [B, len]")
    if q_codes.shape[0] != s_codes.shape[0]:
        raise ValueError("q_codes and s_codes must have the same batch size")
    if q_codes.dtype != torch.int32 or s_codes.dtype != torch.int32:
        raise TypeError("codes must be int32")
    if q_codes.device != s_codes.device:
        raise ValueError("q_codes and s_codes must be on the same device")


def _check(q_codes, s_codes, band):
    _check_pair(q_codes, s_codes)
    if band % 8 or not 0 < band <= MAX_BAND:
        raise ValueError(f"band must be a multiple of 8 in (0, {MAX_BAND}]")


def sw_kernel_config(qlen: int, slen: int, band: int) -> int:
    """Cells a lane of the banded kernel.

    A window is one warp (and one block) whose 32 lanes hold its
    min(band, slen) subject slots, `cells` consecutive ones a lane: the
    fewest of SW_CELLS that cover them.  Raises ValueError on a shape the
    kernel does not take."""
    if band % 8 or not 0 < band <= MAX_BAND:
        raise ValueError(f"band must be a multiple of 8 in (0, {MAX_BAND}]")
    if not 0 <= qlen <= MAX_Q or not 0 <= slen <= MAX_S:
        raise ValueError(f"the banded kernel takes qlen <= {MAX_Q} and "
                         f"slen <= {MAX_S}, got qlen {qlen}, slen {slen}")
    return next(c for c in SW_CELLS if 32 * c >= min(band, slen))


def _launch(entry: str, q_codes: torch.Tensor, s_codes: torch.Tensor,
            band: int, *config: int):
    """Allocate the outputs and launch one of csrc/sw_banded.cu's entry
    points on CUDA tensors: (q, s, batch, qlen, slen, band, *config,
    outputs..., stream).  Returns (outputs, launched)."""
    if q_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {q_codes.device}")
    q = q_codes.contiguous()
    s = s_codes.contiguous()
    bsz, qlen = q.shape
    score = torch.empty(bsz, dtype=torch.float32, device=q.device)
    q_end = torch.empty(bsz, dtype=torch.int32, device=q.device)
    s_end = torch.empty(bsz, dtype=torch.int32, device=q.device)
    if bsz == 0:
        return (score, q_end, s_end), False
    err = getattr(_kernels.library(), entry)(
        q.data_ptr(), s.data_ptr(), bsz, qlen, s.shape[1], band, *config,
        score.data_ptr(), q_end.data_ptr(), s_end.data_ptr(),
        _kernels.stream(q.device))
    _kernels.check(err, entry)
    return (score, q_end, s_end), True


def sw_banded(q_codes: torch.Tensor, s_codes: torch.Tensor, band: int = 128):
    """Banded local SW scores: the plain twin for CPU tensors, the CUDA
    kernel (csrc/sw_banded.cu) for CUDA tensors.  Same contract as the JAX
    package's production TPU kernel (corticall_tpu/ops/sw_device.py:350)."""
    global LAUNCHES
    _check(q_codes, s_codes, band)
    cells = sw_kernel_config(q_codes.shape[1], s_codes.shape[1], band)
    if q_codes.device.type == "cpu":
        return banded_sw_scores(q_codes, s_codes, band)
    out, launched = _launch("ctk_sw_banded", q_codes, s_codes, band, cells)
    LAUNCHES += launched
    return out


def banded_sw_pallas(q_codes: torch.Tensor, s_codes: torch.Tensor,
                     band: int = 128):
    """The contract of corticall_tpu/ops/sw_device.py::banded_sw_pallas (the
    band-window twin of banded_sw_scores).  It is sw_banded's contract, so
    the banded kernel meets it: same twin on the CPU, same launch on CUDA."""
    return sw_banded(q_codes, s_codes, band)


def sw_full_form(band: int | None):
    """(entry point, band) that sw_full launches on a card.  With a band b,
    the masked full matrix scores columns [i - b//2, i + b//2) of row i: the
    banded twin's cells at band 2 * (b // 2) (held by test_torch_sw's
    property test), so where ctk_sw_banded takes that band (a multiple of 8
    in (0, MAX_BAND]) it runs, computing only in-band cells.  Otherwise
    (no band, or one the banded kernel refuses) the full-matrix kernel runs,
    masked by `band` (0: no band)."""
    if band is not None:
        even = 2 * (band // 2)
        if even % 8 == 0 and 0 < even <= MAX_BAND:
            return "ctk_sw_banded", even
    return "ctk_sw_full", band or 0


def sw_full_config(slen: int):
    """(cells a lane, warps an alignment) of the full-matrix kernel: one warp
    a FULL_WARP_COLS-column tile, the fewest of SW_CELLS a lane that cover
    the tile's share of the subject."""
    if not 0 <= slen <= MAX_FULL_S:
        raise ValueError(f"subjects longer than {MAX_FULL_S} are not supported")
    warps = max(1, -(-slen // FULL_WARP_COLS))
    return next(c for c in SW_CELLS if 32 * warps * c >= slen), warps


def sw_full(q_codes: torch.Tensor, s_codes: torch.Tensor,
            band: int | None = None):
    """Full-matrix (band None) or band-masked local SW scores: the plain
    twin for CPU tensors; for CUDA tensors one launch of the kernel that
    sw_full_form names.  Same contract as corticall_tpu/ops/sw_device.py::
    sw_pallas; subjects longer than MAX_FULL_S and queries longer than MAX_Q
    are refused."""
    global FULL_LAUNCHES
    _check_pair(q_codes, s_codes)
    if band is not None and band <= 0:
        raise ValueError("band must be positive or None")
    cells, warps = sw_full_config(s_codes.shape[1])
    if q_codes.shape[1] > MAX_Q:
        raise ValueError(f"the full-matrix kernel takes qlen <= {MAX_Q}")
    if q_codes.device.type == "cpu":
        return sw_full_scores(q_codes, s_codes, band)
    entry, kernel_band = sw_full_form(band)
    if entry == "ctk_sw_banded":
        config = (sw_kernel_config(q_codes.shape[1], s_codes.shape[1], kernel_band),)
    else:
        config = (cells, warps)
    out, launched = _launch(entry, q_codes, s_codes, kernel_band, *config)
    FULL_LAUNCHES += launched
    return out
