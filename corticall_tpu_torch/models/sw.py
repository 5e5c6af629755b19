"""Pairwise alignment: Gotoh affine-gap DP, wavefront-vectorized.

Replaces the reference's cell-object Smith-Waterman (utils/alignment/sw/,
EDNAFULL match 5 / mismatch -4, gap open 10 / extend 0.5 —
SmithWaterman.java:9-13) and the global NeedlemanWunsch (utils/alignment/swold/).

The DP advances along antidiagonals with numpy vector ops (the same wavefront
structure the banded Pallas kernel uses on device), not per-cell loops.
"""

from __future__ import annotations

import numpy as np

MATCH = 5.0
MISMATCH = -4.0
GAP_OPEN = 10.0
GAP_EXTEND = 0.5

NEG = -1e30


def _codes(s: str) -> np.ndarray:
    lut = np.full(256, 4, dtype=np.int8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    return lut[np.frombuffer(s.upper().encode(), dtype=np.uint8)]


def _score_vec(qc, sc):
    return np.where((qc == sc) & (qc < 4), MATCH, MISMATCH)


def _gotoh(q: str, s: str, local: bool):
    """Wavefront Gotoh.  Returns (H, tbH, tbE, tbF) traceback matrices.

    tbH: 0=diag(M) 1=E(gap in s / deletion from q... gap in query row) 2=F 3=stop(local zero)

    The C++ fill (native/corticall_native.cpp::ct_gotoh_fill, exact same
    recurrence and tie-breaking) is used when available; the numpy wavefront
    below is the always-available fallback.
    """
    from .. import native
    filled = native.gotoh_fill_native(q, s, local)
    if filled is not None:
        return filled
    n, m = len(q), len(s)
    qc, sc = _codes(q), _codes(s)

    H = np.full((n + 1, m + 1), 0.0 if local else NEG)
    E = np.full((n + 1, m + 1), NEG)  # gap in query (consume s)
    F = np.full((n + 1, m + 1), NEG)  # gap in subject (consume q)
    tbH = np.zeros((n + 1, m + 1), dtype=np.int8)
    tbE = np.zeros((n + 1, m + 1), dtype=np.int8)  # 0: opened from H, 1: extended
    tbF = np.zeros((n + 1, m + 1), dtype=np.int8)

    if not local:
        H[0, 0] = 0.0
        for j in range(1, m + 1):
            E[0, j] = -(GAP_OPEN + GAP_EXTEND * j)
            H[0, j] = E[0, j]
            tbH[0, j] = 1
            tbE[0, j] = 1 if j > 1 else 0
        for i in range(1, n + 1):
            F[i, 0] = -(GAP_OPEN + GAP_EXTEND * i)
            H[i, 0] = F[i, 0]
            tbH[i, 0] = 2
            tbF[i, 0] = 1 if i > 1 else 0

    # wavefront over antidiagonals d = i + j
    for d in range(2, n + m + 1):
        i_lo = max(1, d - m)
        i_hi = min(n, d - 1)
        if i_lo > i_hi:
            continue
        ii = np.arange(i_lo, i_hi + 1)
        jj = d - ii
        sub = _score_vec(qc[ii - 1], sc[jj - 1])

        e_open = H[ii, jj - 1] - (GAP_OPEN + GAP_EXTEND)
        e_ext = E[ii, jj - 1] - GAP_EXTEND
        E[ii, jj] = np.maximum(e_open, e_ext)
        tbE[ii, jj] = (e_ext > e_open).astype(np.int8)

        f_open = H[ii - 1, jj] - (GAP_OPEN + GAP_EXTEND)
        f_ext = F[ii - 1, jj] - GAP_EXTEND
        F[ii, jj] = np.maximum(f_open, f_ext)
        tbF[ii, jj] = (f_ext > f_open).astype(np.int8)

        diag = H[ii - 1, jj - 1] + sub
        best = diag
        tb = np.zeros(len(ii), dtype=np.int8)
        eh = E[ii, jj]
        m_ = eh > best
        best = np.where(m_, eh, best)
        tb = np.where(m_, 1, tb)
        fh = F[ii, jj]
        m_ = fh > best
        best = np.where(m_, fh, best)
        tb = np.where(m_, 2, tb)
        if local:
            m_ = best < 0
            best = np.where(m_, 0.0, best)
            tb = np.where(m_, 3, tb)
        H[ii, jj] = best
        tbH[ii, jj] = tb

    return H, E, F, tbH, tbE, tbF


def _traceback(q, s, H, tbH, tbE, tbF, i, j, local):
    aq, as_, cigar = [], [], []
    state = 0  # in H
    while i > 0 or j > 0:
        if local and H[i, j] <= 0 and state == 0:
            break
        if state == 0:
            t = tbH[i, j]
            if t == 3:
                break
            if t == 0:
                if i == 0 or j == 0:
                    break
                aq.append(q[i - 1])
                as_.append(s[j - 1])
                cigar.append("M")
                i -= 1
                j -= 1
            elif t == 1:
                state = 1
            else:
                state = 2
        elif state == 1:  # E: gap in query, consume s
            aq.append("-")
            as_.append(s[j - 1])
            cigar.append("D")
            if tbE[i, j] == 0:
                state = 0
            j -= 1
        else:  # F: gap in subject, consume q
            aq.append(q[i - 1])
            as_.append("-")
            cigar.append("I")
            if tbF[i, j] == 0:
                state = 0
            i -= 1
    return "".join(reversed(aq)), "".join(reversed(as_)), "".join(reversed(cigar)), i, j


def _rle_cigar(ops: str) -> str:
    out = []
    i = 0
    while i < len(ops):
        j = i
        while j < len(ops) and ops[j] == ops[i]:
            j += 1
        out.append(f"{j - i}{ops[i]}")
        i = j
    return "".join(out)


class SmithWaterman:
    """Local affine-gap alignment (SmithWaterman.java API parity)."""

    def get_alignment(self, q: str, s: str):
        """-> (aligned_q, aligned_s) of the best local alignment."""
        H, E, F, tbH, tbE, tbF = _gotoh(q, s, local=True)
        i, j = np.unravel_index(int(np.argmax(H)), H.shape)
        aq, as_, _, _, _ = _traceback(q, s, H, tbH, tbE, tbF, int(i), int(j), True)
        return aq, as_

    def align_detailed(self, q: str, s: str):
        H, E, F, tbH, tbE, tbF = _gotoh(q, s, local=True)
        i, j = np.unravel_index(int(np.argmax(H)), H.shape)
        score = float(H[i, j])
        aq, as_, ops, i0, j0 = _traceback(q, s, H, tbH, tbE, tbF, int(i), int(j), True)
        nm = sum(1 for a, b in zip(aq, as_) if a != b)
        return {
            "aligned_query": aq, "aligned_subject": as_, "score": score,
            "qstart": i0, "qend": int(i), "sstart": j0, "send": int(j),
            "cigar": _rle_cigar(ops), "nm": nm,
        }


class NeedlemanWunsch:
    """Global affine-gap alignment."""

    def get_alignment(self, q: str, s: str):
        H, E, F, tbH, tbE, tbF = _gotoh(q, s, local=False)
        aq, as_, _, _, _ = _traceback(q, s, H, tbH, tbE, tbF, len(q), len(s), False)
        return aq, as_
