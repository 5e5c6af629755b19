"""Plain reference of Call's Tesserae section: the mosaic-alignment Viterbi
DP, its traceback and the segment reconstruction, in NumPy.

The model is Tesserae.java's (Call's recombination-aware alignment of a
query against labelled targets): match, insert and delete states a target
position, a recombination jump into any target's match or insert state
from the previous column's best cell, first-index-wins ties in the order
(target, position, M before I), and the local path winning a tie against
the recombination.  The delete recurrence vd[j] = max(vm[j-1] + ldel,
vd[j-1] + leps) is taken in its closed form, ldel + leps (j - 1) +
max_{t < j}(vm[t] - leps t), with the constant term rounded once from
float64; every other operation rounds to the stated precision after it,
left to right.  `precision` "float32" is the configuration's; "bfloat16"
rounds every value to 8 significant bits instead (the control).  Imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np

M, I, D = 1, 2, 3
EMISS_GAP = np.full(5, 0.2)
EMISS_MATCH = np.array([
    [0.2, 0.2, 0.2, 0.2, 0.2],
    [0.2, 0.9, 0.05, 0.025, 0.025],
    [0.2, 0.05, 0.9, 0.025, 0.025],
    [0.2, 0.025, 0.025, 0.9, 0.05],
    [0.2, 0.025, 0.025, 0.05, 0.9],
])
_CODE = np.zeros(256, dtype=np.int64)          # A->3 C->2 G->4 T->1, others 0
for _c, _v in (("A", 3), ("C", 2), ("G", 4), ("T", 1)):
    _CODE[ord(_c)] = _v


def _codes(s: str) -> np.ndarray:
    return _CODE[np.frombuffer(s.encode(), dtype=np.uint8)]


def _bf16(x):
    """Round float32 values to the nearest bfloat16 (ties to even), kept in
    float32."""
    a = np.asarray(x, dtype=np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).reshape(a.shape)


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _pack(who, state, pos):
    return (who << 25) | (state << 23) | pos


class Section:
    """One DP over a query and its targets at one precision."""

    def __init__(self, query: str, seqs: list, hmm: tuple, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision {precision}")
        r = self.r = _bf16 if precision == "bfloat16" else _f32
        del_, eps, rho, term = hmm
        self.term = term
        t_len = np.array([len(t) for t in seqs])
        maxl = max(1, int(t_len.max()))
        self.q = _codes(query)
        self.t = np.zeros((len(seqs), maxl), dtype=np.int64)
        for i, s in enumerate(seqs):
            self.t[i, :len(s)] = _codes(s)
        self.valid = np.arange(1, maxl + 1)[None, :] <= t_len[:, None]
        scal = [math.log(del_), math.log(eps), math.log(rho), math.log(0.75), math.log(0.25),
                math.log(1 - 2 * del_ - rho - term), math.log(1 - eps - rho - term),
                math.log(1 - eps), math.log(float(t_len.sum()))]
        (self.ldel, self.leps, self.lrho, self.lpiM, self.lpiI, self.lmm, self.lgm, self.ldm,
         self.lsize) = (r(np.float32(v)) for v in scal)
        self.lsm = r(np.log(EMISS_MATCH).astype(np.float32))
        self.lsi = r(np.log(EMISS_GAP).astype(np.float32))
        self.small = r(np.float32(-1e32))
        s_count, width = len(seqs), maxl + 1
        self.s_count, self.width = s_count, width
        jj = np.arange(width)
        self.jj = jj[None, :]
        self.jf = jj.astype(np.float32)[None, :]
        self.jpos = np.maximum(self.jj - 1, 0)
        self.dconst = r((np.float64(self.ldel) + np.float64(self.leps) * (jj - 1))
                        .astype(np.float32))[None, :]
        self.vmask = np.concatenate([np.zeros((s_count, 1), bool), self.valid], axis=1)
        self.word = np.int32 if s_count <= 63 else np.int64
        self.seq_ids = np.arange(1, s_count + 1, dtype=self.word)[:, None]

    def _shift(self, x):
        return np.concatenate([np.full((x.shape[0], 1), self.small, np.float32), x[:, :-1]],
                              axis=1)

    def _delete(self, vm, min_j):
        r = self.r
        adj = r(vm - r(self.leps * self.jf))
        adj = np.where(self.jj >= min_j - 1, adj, self.small)
        run = np.maximum.accumulate(adj, axis=1)
        vd = r(self.dconst + self._shift(run))
        vd = np.where(self.jj >= min_j, vd, self.small).astype(np.float32)
        state = np.where(r(self._shift(vm) + self.ldel) >= r(self._shift(vd) + self.leps), M, D)
        return vd, state

    def _column_max(self, vm, vi):
        inter = np.stack([np.where(self.vmask, vm, self.small),
                          np.where(self.vmask, vi, self.small)], axis=2).reshape(-1)
        flat = int(np.argmax(inter))
        s_idx, rem = divmod(flat, 2 * self.width)
        j, st = divmod(rem, 2)
        return s_idx + 1, (M if st == 0 else I), j, inter[flat]

    def run(self):
        """(max_r, cells from first to last as (who, state, pos))."""
        r, small, valid = self.r, self.small, self.valid
        s_count, width, l1 = self.s_count, self.width, len(self.q)
        tb = np.zeros((3, l1 + 1, s_count, width), dtype=self.word)
        vm = np.full((s_count, width), small, np.float32)
        vi = vm.copy()
        q0 = self.q[0]
        vm[:, 1:] = np.where(valid, r(r(self.lpiM - self.lsize) + self.lsm[q0][self.t]), small)
        vi[:, 1:] = np.where(valid, r(r(self.lpiI - self.lsize) + self.lsi[q0]), small)
        vd, state_d = self._delete(vm, 1)
        tb[2, 1] = _pack(self.seq_ids, state_d, self.jpos)
        who, state, pos, max_r = self._column_max(vm, vi)
        for i in range(1, l1):
            qc = self.q[i]
            em = self.lsm[qc][self.t]
            c0 = r(self._shift(vm) + self.lmm)
            c1 = r(self._shift(vi) + self.lgm)
            c2 = r(self._shift(vd) + self.ldm)
            local_val = np.maximum(c0, c1)
            local_arg = np.where(c1 > c0, 1, 0)
            local_arg = np.where(c2 > local_val, 2, local_arg)
            local_val = np.maximum(local_val, c2)
            recomb = r(r(r(max_r + self.lrho) + self.lpiM) - self.lsize)
            use_local = local_val > recomb
            nvm = np.where(use_local, local_val, recomb).astype(np.float32)
            tb_rec = _pack(who, state, pos)
            tb[0, i + 1] = np.where(use_local, _pack(self.seq_ids, local_arg + 1, self.jpos),
                                    tb_rec)
            nvm[:, 1:] = np.where(valid, r(nvm[:, 1:] + em), small)
            nvm[:, 0] = small

            i0, i1 = r(vm + self.ldel), r(vi + self.leps)
            arg_i = np.where(i1 > i0, 1, 0)
            val_i = np.maximum(i0, i1)
            recomb_i = r(r(r(max_r + self.lrho) + self.lpiI) - self.lsize)
            use_local_i = val_i > recomb_i
            nvi = np.where(use_local_i, val_i, recomb_i).astype(np.float32)
            tb[1, i + 1] = np.where(use_local_i, _pack(self.seq_ids, arg_i + 1, self.jj), tb_rec)
            nvi[:, 1:] = np.where(valid, r(nvi[:, 1:] + self.lsi[qc]), small)
            nvi[:, 0] = small

            nvd, state_d = self._delete(nvm, 2)
            tb[2, i + 1] = _pack(self.seq_ids, state_d, self.jpos)
            if i == l1 - 1:
                nvd = np.full_like(nvd, small)
            who, state, pos, max_r = self._column_max(nvm, nvi)
            vm, vi, vd = nvm, nvi, nvd
        return max_r, self._traceback(tb, who, state, pos)

    def _traceback(self, tb, who, state, pos):
        l1, s_count = len(self.q), self.s_count
        cap = l1 + self.width + 4
        cells = [(who, state, pos)]
        pt = l1
        while pt >= 1 and len(cells) < cap:
            sidx = who - 1 if who >= 1 else who - 1 + s_count
            if state in (M, I) and pt < 2:
                v = 0
            else:
                v = int(tb[{M: 0, I: 1}.get(state, 2), pt, sidx, pos])
            if state != D:
                pt -= 1
            who, state, pos = v >> 25, (v >> 23) & 3, v & ((1 << 23) - 1)
            cells.append((who, state, pos))
        cells.pop()                       # the zero-packed boundary entry
        cells.reverse()
        return cells


def align(query: str, targets: dict, hmm: tuple, precision: str = "float32"):
    """(path, llk) of a section: the segment list that Tesserae.align
    returns and the log-likelihood max_r + log(term)."""
    names = list(targets)
    seqs = [targets[n] for n in names]
    sec = Section(query, seqs, hmm, precision)
    max_r, cells = sec.run()
    return build_path(query, names, seqs, cells), float(max_r) + math.log(hmm[3])


def build_path(query, names, seqs, cells):
    """Segment reconstruction (Tesserae.java:386-494): the query track,
    then each copied segment as (name, aligned string, (start, stop))."""
    all_names = ["query"] + names
    all_seqs = [query] + seqs
    sb, pos_start, pos_end, pos_target = [], -1, -1, 1
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

    out = []
    cur_track = all_names[cells[0][0]]
    sb, pos_start, pos_end, last_known_pos, uppercase = [], -1, -1, -1, True
    for idx, (who, state, pos) in enumerate(cells):
        if idx > 0:
            pwho, pstate, ppos = cells[idx - 1]
            if (who == pwho and abs(pos - ppos) > 1) or pos == last_known_pos + 1:
                out.append((cur_track, "".join(sb), (pos_start, pos_end)))
                uppercase = not uppercase
                last_known_pos = ppos
                if pos_start != pos_end:
                    pos_start = pos_end = pos - 1
                cur_track = all_names[who]
                sb = [" "] * idx
            if who != pwho:
                out.append((cur_track, "".join(sb), (pos_start, pos_end)))
                uppercase = True
                if pos_start != pos_end:
                    pos_start = pos_end = pos - 1
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
    return path + out
