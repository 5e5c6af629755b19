"""Indexed reference: exact-match k-mer lookup + seed-and-extend aligner.

Replaces the reference's IndexedReference (htsjdk faidx + bwa-mem via JNI,
alignment/reference/IndexedReference.java:19-118, BwaAligner.java:18-82) with
a native design: a sorted packed-seed position index (numpy searchsorted on
host; the same table feeds device gathers) and banded Gotoh extension for
full alignments.  Scoped to what the calling pipeline actually uses:

- find(seq): perfect-match intervals, NM==0 single-op placements
  (IndexedReference.java:90-101; golden semantics from KmerLookupTest:
  0-based occurrence i -> Interval(contig, i+1, i+len, strand)).
- align(query): best-hit placements with contig/start/end/strand/NM/
  mapping-quality, consumed by Call.sortAlignments (Call.java:1920-1944).
- find_interval / source sidecar parity (.sources file, createIndex).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .. import kmer as km
from ..io import fasta as faio
from .sw import _gotoh, _traceback, _rle_cigar
from .sw import GAP_EXTEND, GAP_OPEN, MATCH, MISMATCH


def _trim_to_best_prefix(aq: str, as_: str, ops: str, i0: int, j0: int,
                         score: float):
    """Cut an alignment where its running score peaks UNDER BWA-MEM SCORING
    (match 1, mismatch -4, gap open -6, extend -1) — the Z-drop role bwa's
    extension plays.  EDNAFULL's 0.5 gap-extend lets plain local SW bridge a
    NAHR breakpoint with a net-POSITIVE gap-riddled random tail, so the cut
    metric must be the one whose random-alignment drift is negative; the
    reported score is the EDNAFULL score of the kept prefix.  Returns
    (aq, as_, ops, i_start, j_start, i_end, j_end, score), starts/ends
    rebased like the untrimmed traceback's (i0, j0, i, j)."""
    run = 0.0             # bwa-scored (Kadane), picks the cut window
    best = float("-inf")
    prev = None
    di = dj = 0           # query/subject consumed so far
    seg = (0, 0, 0)       # current segment start: (idx, di, dj)
    lo = hi = 0
    lodi = lodj = hidi = hidj = 0
    for idx, op in enumerate(ops):
        if run < 0:
            run = 0.0
            seg = (idx, di, dj)
            prev = None   # a fresh segment re-opens any gap
        if op == "M":
            run += 1.0 if aq[idx] == as_[idx] else -4.0
            di += 1
            dj += 1
        else:
            run -= 7.0 if prev != op else 1.0
            if op == "I":
                di += 1
            else:
                dj += 1
        prev = op
        if run > best:
            best = run
            lo, lodi, lodj = seg
            hi, hidi, hidj = idx + 1, di, dj
    if lo <= 0 and hi >= len(ops):
        return aq, as_, ops, i0, j0, i0 + di, j0 + dj, score
    # EDNAFULL score of the kept window, for reporting
    edna = 0.0
    prev = None
    for idx in range(lo, hi):
        op = ops[idx]
        if op == "M":
            edna += MATCH if aq[idx] == as_[idx] else MISMATCH
        else:
            edna -= (GAP_OPEN + GAP_EXTEND) if prev != op else GAP_EXTEND
        prev = op
    return (aq[lo:hi], as_[lo:hi], ops[lo:hi],
            i0 + lodi, j0 + lodj, i0 + hidi, j0 + hidj, float(edna))

SEED_K = 15
_SEED_MASK = np.uint32((1 << (2 * SEED_K)) - 1)


@dataclass(frozen=True)
class Interval:
    contig: str
    start: int          # 1-based inclusive
    end: int            # 1-based inclusive
    negative: bool = False

    def __repr__(self):
        return f"{self.contig}:{self.start}-{self.end}:{'-' if self.negative else '+'}"


@dataclass
class Alignment:
    """SAMRecord stand-in with the fields Call consumes."""
    contig: str
    start: int                  # 1-based alignment start on the reference
    end: int                    # 1-based inclusive alignment end
    negative: bool
    mapq: int
    nm: int
    cigar: str
    read: str                   # read sequence in reference (forward) orientation
    score: float = 0.0

    # Java-style accessors for porting fidelity
    def get_contig(self):
        return self.contig

    def get_alignment_start(self):
        return self.start

    def get_alignment_end(self):
        return self.end

    @property
    def read_negative_strand(self):
        return self.negative

    @property
    def read_length(self) -> int:
        return len(self.read)

    def _cigar_ops(self):
        num = ""
        for c in self.cigar:
            if c.isdigit():
                num += c
            else:
                yield int(num), c
                num = ""

    def ref_pos_at_read_pos(self, read_pos: int) -> int:
        """1-based read position -> 1-based reference position, 0 if the read
        base is clipped/inserted (SAMRecord.getReferencePositionAtReadPosition)."""
        rp = 0          # read position consumed (1-based cursor)
        ref = self.start
        for n, op in self._cigar_ops():
            if op in ("S", "I"):
                if rp < read_pos <= rp + n:
                    return 0
                rp += n
            elif op == "M":
                if rp < read_pos <= rp + n:
                    return ref + (read_pos - rp - 1)
                rp += n
                ref += n
            elif op in ("D", "N"):
                ref += n
        return 0


class IndexedReference:
    """One or more reference contigs + seed index + aligner + sources."""

    def __init__(self, path_or_seqs, sources=None):
        if isinstance(path_or_seqs, (str, os.PathLike)):
            self.path = str(path_or_seqs)
            self.seqs = faio.read_fasta(self.path)
            src_file = self.path + ".sources"
            self.sources = set(sources or [])
            if os.path.exists(src_file):
                with open(src_file) as f:
                    self.sources |= {line.strip() for line in f if line.strip()}
        else:
            self.path = None
            self.seqs = dict(path_or_seqs)
            self.sources = set(sources or [])
        self.names = list(self.seqs.keys())
        self._build_index()

    @staticmethod
    def create_index(path, *sources) -> str:
        src = str(path) + ".sources"
        with open(src, "w") as f:
            for s in sources:
                f.write(s + "\n")
        return src

    # ------------------------------------------------------------------
    def _build_index(self):
        packs, contigs, positions = [], [], []
        for ci, name in enumerate(self.names):
            seq = self.seqs[name]
            if len(seq) < SEED_K:
                continue
            codes = km.string_to_codes_permissive(seq)
            m = len(codes) - SEED_K + 1
            vals = np.zeros(m, dtype=np.uint32)
            for j in range(SEED_K):
                # contiguous slice per position beats a strided window view
                vals = (vals << np.uint32(2)) | codes[j:j + m].astype(np.uint32)
            # window valid iff it contains no non-ACGT code: O(n) via prefix
            # sums instead of the O(n*K) all-over-window reduction
            bad = np.zeros(len(codes) + 1, dtype=np.int32)
            np.cumsum(codes >= 4, out=bad[1:])
            idx = np.nonzero(bad[SEED_K:] == bad[:m])[0]
            packs.append(vals[idx])
            contigs.append(np.full(len(idx), ci, dtype=np.int32))
            positions.append(idx.astype(np.int32))
        if packs:
            vals = np.concatenate(packs)
            order = np.argsort(vals, kind="stable")
            self._seed_vals = vals[order]
            self._seed_contig = np.concatenate(contigs)[order]
            self._seed_pos = np.concatenate(positions)[order]
        else:
            self._seed_vals = np.zeros(0, np.uint32)
            self._seed_contig = np.zeros(0, np.int32)
            self._seed_pos = np.zeros(0, np.int32)

    def _seed_hits(self, seq: str, offset: int):
        """(contig_idx[], pos[]) of exact SEED_K-mer matches at seq[offset:]."""
        sub = seq[offset:offset + SEED_K]
        if len(sub) < SEED_K or any(c not in "ACGT" for c in sub):
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        val = np.uint32(0)
        for c in sub:
            val = np.uint32((int(val) << 2) | "ACGT".index(c)) & _SEED_MASK
        lo = np.searchsorted(self._seed_vals, val, side="left")
        hi = np.searchsorted(self._seed_vals, val, side="right")
        return self._seed_contig[lo:hi], self._seed_pos[lo:hi]

    # ------------------------------------------------------------------
    def find_interval(self, interval: Interval):
        """Subsequence for a 1-based inclusive interval; revcomp if negative
        (IndexedReference.find(Interval), :60-75)."""
        seq = self.seqs.get(interval.contig)
        if seq is None:
            raise KeyError(f"contig {interval.contig!r} not in reference")
        if interval.start > 0 and interval.end <= len(seq):
            sub = seq[interval.start - 1:interval.end]
            return km.revcomp(sub) if interval.negative else sub
        return None

    def find(self, seq: str) -> set:
        """Perfect full-length matches as Interval set (both strands)."""
        out = set()
        if not seq:
            return out
        for negative, query in ((False, seq), (True, km.revcomp(seq))):
            if len(query) < SEED_K:
                # brute force for very short queries
                for ci, name in enumerate(self.names):
                    start = 0
                    ref = self.seqs[name]
                    while True:
                        p = ref.find(query, start)
                        if p < 0:
                            break
                        out.add(Interval(name, p + 1, p + len(query), negative))
                        start = p + 1
                continue
            cs, ps = self._seed_hits(query, 0)
            for ci, p in zip(cs, ps):
                ref = self.seqs[self.names[ci]]
                if ref[p:p + len(query)] == query:
                    out.add(Interval(self.names[ci], int(p) + 1, int(p) + len(query), negative))
        return out

    # ------------------------------------------------------------------
    def candidate_windows(self, query: str, max_chains: int = 8,
                          band: int = 64) -> list:
        """Seed-chain candidates: [(name, negative, r0, window_str)].
        The seeding/chaining half of align(), exposed so batched aligners
        (models/contig_aligner.py) can score many queries' windows in one
        device dispatch before host-tracing only the winners."""
        hits: dict = {}
        step = max(1, (len(query) - SEED_K) // 16) if len(query) > SEED_K else 1
        for negative in (False, True):
            qs = km.revcomp(query) if negative else query
            for off in range(0, max(1, len(qs) - SEED_K + 1), step):
                cs, ps = self._seed_hits(qs, off)
                if len(cs) > 1000:
                    continue  # repetitive seed
                for ci, p in zip(cs, ps):
                    diag = int(p) - off
                    key = (int(ci), negative, diag // 32)
                    hits.setdefault(key, []).append((off, int(p)))

        # rank chains by seed count and drop weak ones relative to the best
        # (bwa-mem's chain drop_ratio analog) — spurious 1-2-seed chains from
        # repeat content would otherwise get extended into gap-riddled local
        # alignments that can outrank the true placement on reference span
        chains = sorted(hits.items(), key=lambda kv: -len(kv[1]))
        if chains:
            best_seeds = len(chains[0][1])
            chains = [c for c in chains
                      if len(c[1]) >= max(1, int(0.25 * best_seeds))]
        out = []
        for (ci, negative, _), seeds in chains[:max_chains]:
            name = self.names[ci]
            ref = self.seqs[name]
            qs = km.revcomp(query) if negative else query
            qoff, rpos = seeds[0]
            diag = rpos - qoff
            r0 = max(0, diag - band)
            r1 = min(len(ref), diag + len(qs) + band)
            out.append((name, negative, r0, ref[r0:r1]))
        return out

    def extend_window(self, query: str, name: str, negative: bool,
                      r0: int, window: str):
        """Gotoh-extend one candidate window into an Alignment (or None if
        it fails the score/identity gates) — the extension half of align()."""
        qs = km.revcomp(query) if negative else query
        H, E, F, tbH, tbE, tbF = _gotoh(qs, window, local=True)
        i, j = np.unravel_index(int(np.argmax(H)), H.shape)
        score = float(H[i, j])
        aq, as_, ops, i0, j0 = _traceback(qs, window, H, tbH, tbE, tbF,
                                          int(i), int(j), True)
        # Z-drop analog (bwa-mem stops extension when the score falls
        # off its running max; plain local SW happily bridges a mosaic
        # breakpoint with a gap-riddled tail): trim the alignment to its
        # best-scoring prefix, so NAHR-mosaic contigs place as SPLIT
        # alignments — one per donor locus — like the lastz role needs
        aq, as_, ops, i0, j0, i, j, score = _trim_to_best_prefix(
            aq, as_, ops, i0, j0, score)
        nm = sum(1 for a, b in zip(aq, as_) if a != b)
        cigar_ops = []
        if i0 > 0:
            cigar_ops.append(f"{i0}S")
        cigar_ops.append(_rle_cigar(ops))
        if int(i) < len(qs):
            cigar_ops.append(f"{len(qs) - int(i)}S")
        # quality gates (bwa-mem reports nothing like these): minimum
        # score (bwa -T 30 analog) and a loose identity floor — a true
        # placement even in diverged context has nm/len in the percents,
        # a spurious-chain extension is mostly edits
        if score < 30 or nm > 0.3 * max(1, int(i) - i0):
            return None
        return Alignment(
            contig=name, start=r0 + j0 + 1, end=r0 + int(j),
            negative=negative, mapq=0, nm=nm, cigar="".join(cigar_ops),
            read=qs, score=score)

    @staticmethod
    def rank(alignments: list) -> list:
        """Sort by score desc; mapq 60 for a unique best, 0 on ties (the
        uniqueness contract Call and FindContamination rely on)."""
        alignments.sort(key=lambda a: -a.score)
        if alignments:
            best = alignments[0].score
            tied = sum(1 for a in alignments if a.score == best)
            for a in alignments:
                a.mapq = 60 if (a.score == best and tied == 1) else 0
        return alignments

    def align(self, query: str, max_chains: int = 8, band: int = 64) -> list:
        """Seed-chain-extend alignment; returns Alignment list sorted by
        score (see candidate_windows/extend_window/rank)."""
        if isinstance(query, list):
            return [self.align(q) for q in query]
        alignments = []
        for name, negative, r0, window in self.candidate_windows(
                query, max_chains, band):
            a = self.extend_window(query, name, negative, r0, window)
            if a is not None:
                alignments.append(a)
        return self.rank(alignments)
