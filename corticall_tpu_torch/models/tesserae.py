"""Tesserae: recombination-aware mosaic alignment HMM (host oracle).

Viterbi alignment of a query against a panel of targets with recombination
jumps between targets (the Mosaic/Tesserae model).  Exact reimplementation of
the reference's semantics (Tesserae.java:9-546): same transition/emission
parameters, same first-index-wins argmax tie-breaks, same
"recombination loses ties to local path" rule, same traceback and segment
reconstruction — but the per-column DP is vectorized over (target, position)
numpy arrays instead of scalar triple loops, and the delete-state recurrence
(a max-plus prefix scan along the target axis) is computed in closed form
with a running maximum.

The device version lives in ops/tesserae_torch.py and is validated
against this oracle at segment level; its exact form (ctk_tesserae_f64, for
the sections the device's budget gate sends here) computes this oracle's
operations in float64 on the card and takes its parameters from
`hmm_params`, so that both round them alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

SMALL = -1e32

# convert(): A->3 C->2 G->4 T->1, other->0 (Tesserae.java:497-506)
_CONVERT = np.zeros(256, dtype=np.int8)
for _c, _v in (("A", 3), ("C", 2), ("G", 4), ("T", 1)):
    _CONVERT[ord(_c)] = _v

EMISS_GAP_NT = np.array([0.2, 0.2, 0.2, 0.2, 0.2])
EMISS_MATCH_NT = np.array([
    #      -     T      C      A      G
    [0.2, 0.2, 0.2, 0.2, 0.2],
    [0.2, 0.9, 0.05, 0.025, 0.025],   # T
    [0.2, 0.05, 0.9, 0.025, 0.025],   # C
    [0.2, 0.025, 0.025, 0.9, 0.05],   # A
    [0.2, 0.025, 0.025, 0.05, 0.9],   # G
])

M, I, D = 1, 2, 3


class HmmParams(NamedTuple):
    """The model's log parameters, in float64."""
    ldel: float
    leps: float
    lrho: float
    lterm: float
    lpiM: float
    lpiI: float
    lmm: float
    lgm: float
    ldm: float
    lsm: np.ndarray           # [5, 5] log match emissions
    lsi: np.ndarray           # [5] log gap emissions


def hmm_params(del_: float, eps: float, rho: float, term: float) -> HmmParams:
    """The log parameters the oracle aligns with, for the oracle and for the
    device's exact form alike."""
    pi_m = 0.75
    return HmmParams(
        ldel=math.log(del_), leps=math.log(eps), lrho=math.log(rho), lterm=math.log(term),
        lpiM=math.log(pi_m), lpiI=math.log(1 - pi_m),
        lmm=math.log(1 - 2 * del_ - rho - term), lgm=math.log(1 - eps - rho - term),
        ldm=math.log(1 - eps), lsm=np.log(EMISS_MATCH_NT), lsi=np.log(EMISS_GAP_NT))

# The packed traceback word is who << 25 | state << 23 | pos.  The reference
# keeps it in int32, where `who` has bits 25-30: up to INT32_TARGETS targets.
# A larger section packs the same word in int64 (the reference's int32 word
# reaches the sign bit at 64 targets and breaks its traceback).
INT32_TARGETS = 63


def word_dtype(s_count: int):
    """numpy dtype of a section's packed traceback words."""
    return np.int32 if s_count <= INT32_TARGETS else np.int64


def _seq_codes(s: str) -> np.ndarray:
    return _CONVERT[np.frombuffer(s.encode(), dtype=np.uint8)].astype(np.int32)


class Tesserae:
    """API parity with the reference: align(query, targets) -> segment list."""

    def __init__(self, del_=0.025, eps=0.75, rho=1e-4, term=1e-3):
        self.del_ = del_
        self.eps = eps
        self.rho = rho
        self.term = term
        self.llk = 0.0
        self.combined_llk = 0.0
        self.path: list = []
        self.edit_track = ""

    # ------------------------------------------------------------------
    def align(self, query: str, targets: dict) -> list:
        """targets: insertion-ordered {name: sequence}.

        Returns [(name, aligned_string_with_leading_spaces, (start, stop))]:
        entry 0 is the query track, subsequent entries are the mosaic source
        segments in query order (Tesserae.java:95-103, 386-494).
        """
        ldel, leps, lrho, lterm, lpiM, lpiI, lmm, lgm, ldm, lsm, lsi = hmm_params(
            self.del_, self.eps, self.rho, self.term)

        if not targets or not query:
            raise ValueError("Tesserae.align requires a non-empty query and targets")
        names = list(targets.keys())
        seqs = [targets[n] for n in names]
        s_count = len(seqs)
        l1 = len(query)
        maxl = max([l1] + [len(t) for t in seqs])
        q = _seq_codes(query)
        t_codes = np.zeros((s_count, maxl), dtype=np.int32)
        t_len = np.array([len(t) for t in seqs], dtype=np.int32)
        for si, t in enumerate(seqs):
            t_codes[si, :len(t)] = _seq_codes(t)
        # valid positions mask over the padded [S, maxl] target-position grid
        jpos = np.arange(1, maxl + 1)
        valid = jpos[None, :] <= t_len[:, None]          # [S, maxl] (j = 1..maxl)

        size_l = float(sum(len(t) for t in seqs))
        lsize_l = math.log(size_l)

        # emission gathers per column are built on the fly:
        #   lsm[q[i-1], t_codes] -> [S, maxl]
        # DP columns [S, maxl+1] (index j = 0..maxl; j=0 is the boundary)
        neg = np.full((s_count, maxl + 1), SMALL)

        # traceback storage: packed (who << 25 | state << 23 | pos), one per
        # state per cell per column, in word_dtype(s_count)
        def pack(who, state, pos):
            return (who << 25) | (state << 23) | pos

        word = word_dtype(s_count)
        tb_m = np.zeros((l1 + 1, s_count, maxl + 1), dtype=word)
        tb_i = np.zeros((l1 + 1, s_count, maxl + 1), dtype=word)
        tb_d = np.zeros((l1 + 1, s_count, maxl + 1), dtype=word)

        seq_ids = np.arange(1, s_count + 1, dtype=word)  # reference 'seq' (1-based after query)

        # ---- column i = 1 (Tesserae.java:223-259) ----
        vm = neg.copy()
        vi = neg.copy()
        vd = neg.copy()
        em = lsm[q[0], t_codes]                                # [S, maxl]
        vm[:, 1:] = np.where(valid, lpiM - lsize_l + em, SMALL)
        vi[:, 1:] = np.where(valid, lpiI - lsize_l + lsi[q[0]], SMALL)
        # delete scan along j at column 1: vd[j] = max(vm[j-1]+ldel, vd[j-1]+leps)
        vd, state_d = self._delete_scan(vm, vd, ldel, leps, valid)
        tb_d[1] = pack(seq_ids[:, None], state_d,
                       np.maximum(np.arange(maxl + 1)[None, :] - 1, 0))

        who_max, state_max, pos_max, max_r = self._column_max(vm, vi, valid)

        # ---- columns i = 2..l1 (Tesserae.java:261-341) ----
        for i in range(2, l1 + 1):
            pm_, pi_, pd_ = vm, vi, vd
            em = lsm[q[i - 1], t_codes]

            # local M: max over (pm, pi, pd) at [j-1, i-1], first-index wins ties
            cand = np.stack([
                np.concatenate([neg[:, :1], pm_[:, :-1]], axis=1) + lmm,
                np.concatenate([neg[:, :1], pi_[:, :-1]], axis=1) + lgm,
                np.concatenate([neg[:, :1], pd_[:, :-1]], axis=1) + ldm,
            ])                                                  # [3, S, maxl+1]
            local_arg = np.argmax(cand, axis=0)                 # first max wins (np.argmax)
            local_val = np.take_along_axis(cand, local_arg[None], axis=0)[0]

            recomb = max_r + lrho + lpiM - lsize_l
            use_local = local_val > recomb
            vm = np.where(use_local, local_val, recomb)
            tb_loc_m = pack(seq_ids[:, None], (local_arg + 1).astype(np.int32),
                            np.maximum(np.arange(maxl + 1)[None, :] - 1, 0))
            tb_rec = pack(who_max, state_max, pos_max)
            tb_m[i] = np.where(use_local, tb_loc_m, tb_rec)
            vm[:, 1:] = np.where(valid, vm[:, 1:] + em, SMALL)
            vm[:, 0] = SMALL

            # I: max(pm[j]+ldel, pi[j]+leps) vs recomb
            cand_i = np.stack([pm_ + ldel, pi_ + leps])
            arg_i = np.argmax(cand_i, axis=0)
            val_i = np.take_along_axis(cand_i, arg_i[None], axis=0)[0]
            recomb_i = max_r + lrho + lpiI - lsize_l
            use_local_i = val_i > recomb_i
            vi = np.where(use_local_i, val_i, recomb_i)
            tb_loc_i = pack(seq_ids[:, None], (arg_i + 1).astype(np.int32),
                            np.arange(maxl + 1)[None, :])
            tb_i[i] = np.where(use_local_i, tb_loc_i, tb_rec)
            vi[:, 1:] = np.where(valid, vi[:, 1:] + lsi[q[i - 1]], SMALL)
            vi[:, 0] = SMALL

            # D: prefix scan along j over current column's M; only for
            # i < l1 and j > 1 (Tesserae.java:307-316)
            if i < l1:
                vd, state_d = self._delete_scan(vm, pd_, ldel, leps, valid, min_j=2)
                tb_d[i] = pack(seq_ids[:, None], state_d,
                               np.maximum(np.arange(maxl + 1)[None, :] - 1, 0))
            else:
                vd = neg.copy()

            who_max, state_max, pos_max, max_r = self._column_max(vm, vi, valid)

        self.llk = max_r + lterm
        self.combined_llk += max_r + lterm

        # ---- traceback (Tesserae.java:346-383) ----
        path_cells = []                     # (who, state, pos) from last to first
        who, state, pos = who_max, state_max, pos_max
        pos_target = l1
        path_cells.append((who, state, pos))
        while pos_target >= 1:
            if state == M:
                tb = tb_m[pos_target, who - 1, pos]
            elif state == I:
                tb = tb_i[pos_target, who - 1, pos]
            else:
                tb = tb_d[pos_target, who - 1, pos]
            tb = int(tb)
            who_n = tb >> 25
            state_n = (tb >> 23) & 3
            pos_n = tb & ((1 << 23) - 1)
            prev_state = state
            who, state, pos = who_n, state_n, pos_n
            path_cells.append((who, state, pos))
            if prev_state != D:
                pos_target -= 1
        path_cells.pop()            # drop the bogus boundary entry
        path_cells.reverse()        # now first..last

        return self._build_path(query, names, seqs, path_cells)

    # ------------------------------------------------------------------
    @staticmethod
    def _delete_scan(vm, vd_prev_col, ldel, leps, valid, min_j=1):
        """vd[j] = max(vm[j-1] + ldel, vd[j-1] + leps) along j, with the M
        branch winning ties (reference argmax order, Tesserae.java:234-239).

        Closed form of the max-plus prefix scan (leps is constant):
        vd[j] = ldel + leps*(j-1) + max_{min_j-1 <= t <= j-1}(vm[t] - leps*t).
        Returns (vd [S, maxl+1], state [S, maxl+1] with 1=M-branch 3=D-branch).
        """
        s_count, width = vm.shape
        jj = np.arange(width)
        adj = vm - leps * jj[None, :]
        adj = adj.copy()
        if min_j > 1:
            adj[:, :min_j - 1] = SMALL  # exclude t < min_j - 1
        run = np.maximum.accumulate(adj, axis=1)            # max over t <= j
        run_prev = np.concatenate(
            [np.full((s_count, 1), SMALL), run[:, :-1]], axis=1)  # max over t <= j-1
        vd = ldel + leps * (jj[None, :] - 1) + run_prev
        vd[:, :min_j] = SMALL
        # branch per cell: M branch (vm[j-1]+ldel) wins ties (Java argmax order)
        m_branch = np.concatenate(
            [np.full((s_count, 1), SMALL), vm[:, :-1]], axis=1) + ldel
        d_branch = np.concatenate(
            [np.full((s_count, 1), SMALL), vd[:, :-1]], axis=1) + leps
        state = np.where(m_branch >= d_branch, M, D).astype(np.int32)
        return vd, state

    @staticmethod
    def _column_max(vm, vi, valid):
        """Global column max; candidate order is (seq asc, j asc, M before I)
        and the first strict maximum wins, exactly the reference's scan order
        (Tesserae.java:242-253, 318-329)."""
        s_count, width = vm.shape
        vmask = np.concatenate([np.zeros((s_count, 1), bool), valid], axis=1)
        vmv = np.where(vmask, vm, SMALL)
        viv = np.where(vmask, vi, SMALL)
        inter = np.stack([vmv, viv], axis=2).reshape(s_count, -1)  # (j, state) interleaved
        flat = int(np.argmax(inter))
        best = float(inter.reshape(-1)[flat])
        s_idx, rem = divmod(flat, width * 2)
        j, st = divmod(rem, 2)
        return s_idx + 1, (M if st == 0 else I), j, best

    # ------------------------------------------------------------------
    def _build_path(self, query, names, seqs, cells):
        """Segment reconstruction (Tesserae.java:386-494), verbatim semantics."""
        all_names = ["query"] + names
        all_seqs = [query] + seqs
        n = len(cells)

        # query track + edit track
        sb = []
        pos_start = -1
        pos_end = -1
        pos_target = 1
        for (who, state, pos) in cells:
            if state == D:
                sb.append("-")
            else:
                if pos_start == -1:
                    pos_start = pos_target - 1
                pos_end = pos_target - 1
                sb.append(query[pos_target - 1])
                pos_target += 1
        path = [("query", "".join(sb), (pos_start, pos_end))]

        et = []
        pos_target = 1
        for (who, state, pos) in cells:
            if state == M:
                et.append("|" if query[pos_target - 1] == all_seqs[who][pos - 1] else " ")
                pos_target += 1
            elif state == I:
                et.append("^")
                pos_target += 1
            else:
                et.append("~")
        self.edit_track = "".join(et)

        # copying tracks
        out = []
        cur_track = all_names[cells[0][0]]
        sb = []
        pos_start = -1
        pos_end = -1
        last_known_pos = -1
        uppercase = True
        for idx, (who, state, pos) in enumerate(cells):
            if idx > 0:
                pwho, pstate, ppos = cells[idx - 1]
                if (who == pwho and abs(pos - ppos) > 1) or pos == last_known_pos + 1:
                    out.append((cur_track, "".join(sb), (pos_start, pos_end)))
                    uppercase = not uppercase
                    last_known_pos = ppos
                    if pos_start != pos_end:
                        pos_start = pos - 1
                        pos_end = pos - 1
                    cur_track = all_names[who]
                    sb = [" "] * idx
                if who != pwho:
                    out.append((cur_track, "".join(sb), (pos_start, pos_end)))
                    uppercase = True
                    if pos_start != pos_end:
                        pos_start = pos - 1
                        pos_end = pos - 1
                    cur_track = all_names[who]
                    sb = [" "] * idx
            if state == I:
                sb.append("-")
            else:
                ch = all_seqs[who][pos - 1]
                ch = ch.upper() if uppercase else ch.lower()
                if pos_start == -1:
                    pos_start = pos - 1
                pos_end = pos - 1
                sb.append(ch)
        out.append((cur_track, "".join(sb), (pos_start, pos_end)))

        self.path = path + out
        return self.path

    def __str__(self):
        lines = []
        for i, (name, track, (a, b)) in enumerate(self.path):
            label = f"{name} ({a}-{b})"
            lines.append(f"{label} {track}")
            if i == 0:
                lines.append(f"{' ' * len(label)} {self.edit_track}")
        lines.append(f"\nMllk: {self.llk}")
        return "\n".join(lines)
