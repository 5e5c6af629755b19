"""Batched banded Smith-Waterman: plain PyTorch twin + CUDA kernel wrapper.

Counterpart of corticall_tpu/ops/sw_device.py.  `banded_sw_scores` is the
PyTorch twin of the JAX scan (one query row per step, the band in the last
dimension, the horizontal-gap prefix in closed form with `torch.cummax`);
`sw_banded` runs it for CPU tensors and launches `csrc/sw_banded.cu` for
CUDA tensors.  Both return (score f32[B], q_end i32[B], s_end i32[B]), ends
1-based inclusive, and agree bit for bit: every value is a multiple of 0.5.
"""

from __future__ import annotations

import numpy as np
import torch

from corticall_tpu import kmer as km
from corticall_tpu.models.sw import GAP_EXTEND, GAP_OPEN, MATCH, MISMATCH

from . import _kernels

NEG = -1e30
MAX_BAND = 1024

# kernel launches (plain integer; chip_smoke.py resets and reads it)
LAUNCHES = 0


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


def _check(q_codes, s_codes, band):
    if q_codes.dim() != 2 or s_codes.dim() != 2:
        raise ValueError("q_codes and s_codes must be 2-D [B, len]")
    if q_codes.shape[0] != s_codes.shape[0]:
        raise ValueError("q_codes and s_codes must have the same batch size")
    if q_codes.dtype != torch.int32 or s_codes.dtype != torch.int32:
        raise TypeError("codes must be int32")
    if q_codes.device != s_codes.device:
        raise ValueError("q_codes and s_codes must be on the same device")
    if band % 8 or not 0 < band <= MAX_BAND:
        raise ValueError(f"band must be a multiple of 8 in (0, {MAX_BAND}]")


def sw_banded(q_codes: torch.Tensor, s_codes: torch.Tensor, band: int = 128):
    """Banded local SW scores: the plain twin for CPU tensors, the CUDA
    kernel (csrc/sw_banded.cu) for CUDA tensors.  Same contract as the JAX
    package's production TPU kernel (corticall_tpu/ops/sw_device.py:350)."""
    global LAUNCHES
    _check(q_codes, s_codes, band)
    if q_codes.device.type == "cpu":
        return banded_sw_scores(q_codes, s_codes, band)
    if q_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {q_codes.device}")
    q = q_codes.contiguous()
    s = s_codes.contiguous()
    bsz, qlen = q.shape
    slen = s.shape[1]
    score = torch.empty(bsz, dtype=torch.float32, device=q.device)
    q_end = torch.empty(bsz, dtype=torch.int32, device=q.device)
    s_end = torch.empty(bsz, dtype=torch.int32, device=q.device)
    if bsz == 0:
        return score, q_end, s_end
    lib = _kernels.library()
    err = lib.ctk_sw_banded(q.data_ptr(), s.data_ptr(), bsz, qlen, slen, band,
                            score.data_ptr(), q_end.data_ptr(), s_end.data_ptr(),
                            _kernels.stream(q.device))
    _kernels.check(err, "sw_banded")
    LAUNCHES += 1
    return score, q_end, s_end
