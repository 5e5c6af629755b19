"""Simulation suite: recombinant haploid children with injected variants.

Capability port of commands/simulate/ (SimulateHaploidChild.java:40-947 and
generators/): cross two parental references with Poisson-drawn recombination
counts, inject de novo variants of the reference's 8 generator types (SNV,
INS, DEL, MNP, INV, STR expansion/contraction, tandem duplication), and emit
the child FASTA plus truth tables — per-variant rows with 100bp seed flanks,
the novel-kmer list (child kmers absent from both parents), and a truth VCF
against the parental reference — the inputs the evaluation harness compares
calls against (Simulate.wdl:1209-1330).
"""

from __future__ import annotations

import numpy as np

from . import kmer as km
from .caller.variants import Variant


# ---------------------------------------------------------------------------
# variant generators (commands/simulate/generators/)
# ---------------------------------------------------------------------------

def _random_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def gen_snv(seq, pos, rng, length):
    old = seq[pos]
    while True:
        base = "ACGT"[rng.integers(0, 4)]
        if base != old.upper():
            return "SNV", pos, old, base


def gen_ins(seq, pos, rng, length):
    old = seq[pos]
    return "INS", pos, old, old + _random_seq(rng, length)


def gen_del(seq, pos, rng, length):
    return "DEL", pos, seq[pos:pos + length + 1], seq[pos]


def gen_mnp(seq, pos, rng, length):
    return "MNP", pos, seq[pos:pos + length], _random_seq(rng, length)


def gen_inv(seq, pos, rng, length):
    old = seq[pos:pos + length]
    return "INV", pos, old, km.revcomp(old)


def _str_loci(seq, s):
    """Start positions of tandem repeats with unit size s (StrExpGenerator)."""
    loci = []
    for i in range(len(seq) - 2 * s):
        unit = seq[i:i + s]
        if "N" not in unit and unit == seq[i + s:i + 2 * s]:
            loci.append(i)
    return loci


def gen_str_exp(seq, pos, rng, length):
    s = int(rng.integers(0, 4)) + 2
    loci = _str_loci(seq, s)
    if not loci:
        return gen_snv(seq, pos, rng, length)
    l = loci[rng.integers(0, len(loci))]
    unit = seq[l:l + s]
    n = int(rng.integers(0, 4)) + 2
    return "STR_EXP", l, unit, unit * n


def gen_str_con(seq, pos, rng, length):
    s = int(rng.integers(0, 4)) + 2
    loci = _str_loci(seq, s)
    if not loci:
        return gen_snv(seq, pos, rng, length)
    l = loci[rng.integers(0, len(loci))]
    unit = seq[l:l + s]
    adjacent = 0
    i = l
    while i < len(seq) - s and seq[i:i + s] == unit:
        adjacent += 1
        i += s
    i = l - s
    while i >= 0 and seq[i:i + s] == unit:
        adjacent += 1
        i -= s
    if adjacent < 2:
        return gen_snv(seq, pos, rng, length)
    n = int(rng.integers(0, adjacent - 1)) + 2
    n = min(n, adjacent)
    return "STR_CON", l, seq[l:l + n * s], unit


def gen_tandem_dup(seq, pos, rng, length):
    old = seq[pos:pos + length]
    return "TD", pos, old, old + old


def gen_nahr(seq, pos, rng, length, donor=None):
    """Non-allelic homologous recombination: splice a mosaic of the local
    region and a donor region (makeNAHR, SimulateHaploidChild.java:545-620).
    Produces an NAHR-INS style allele: the region is replaced by an
    alternating recombinant of itself and the donor."""
    span = max(length * 40, 500)
    if pos + span > len(seq) - 150:
        span = max(200, len(seq) - 150 - pos)
    region = seq[pos:pos + span]
    if donor is None:
        # pick a distant window as the homologous donor
        dstart = int(rng.integers(150, max(151, len(seq) - span - 150)))
        donor = seq[dstart:dstart + span]
    n_rec = int(rng.integers(2, 6))
    points = sorted(int(x) for x in rng.integers(50, max(51, span - 50), n_rec))
    pieces = []
    cur = 0
    prev = 0
    for p in points + [span]:
        src = region if cur == 0 else donor
        pieces.append(src[prev:min(p, len(src))])
        cur ^= 1
        prev = p
    alt = "".join(pieces)
    if alt.upper() == region.upper():
        return gen_snv(seq, pos, rng, 1)
    return "NAHR-INS", pos, region, alt


GENERATORS = [gen_ins, gen_str_exp, gen_tandem_dup, gen_del, gen_str_con,
              gen_mnp, gen_inv, gen_nahr, gen_snv]


# ---------------------------------------------------------------------------
# recombination (SimulateHaploidChild.recombine)
# ---------------------------------------------------------------------------

def recombine(seq1: str, seq2: str, num_recombs: int, k: int, rng):
    """Alternate between two parental sequences at random switch points.

    Returns (pieces, parents) where parents[i] in (1, 2) names the source of
    pieces[i]; switch points are uniform, at least k bases apart.
    """
    n = min(len(seq1), len(seq2))
    points = sorted(set(int(x) for x in rng.integers(k, n - k, num_recombs))) if num_recombs else []
    pieces, parents = [], []
    cur = int(rng.integers(1, 3))
    prev = 0
    for p in points + [n]:
        if p <= prev:
            continue
        src = seq1 if cur == 1 else seq2
        pieces.append(src[prev:p])
        parents.append(cur)
        cur = 2 if cur == 1 else 1
        prev = p
    return pieces, parents


def poisson_draw(rng, mu: float) -> int:
    return int(rng.poisson(mu))


# ---------------------------------------------------------------------------
# vectorized canonical-kmer membership
# ---------------------------------------------------------------------------

def _valid_canonical_keys(seq: str, k: int):
    """(sorted-order-comparable BE byte keys, window start positions) of all
    N-free kmers of seq (uppercased)."""
    s = seq.upper()
    if len(s) < k:
        return None, None
    codes = km.string_to_codes_permissive(s)
    windows = km.kmerize_codes(codes, k)
    ok = (windows >= 0).all(axis=1) & (windows < 4).all(axis=1)
    if not ok.any():
        return None, None
    canon, _ = km.canonicalize_codes(windows[ok])
    keys = km.words_to_bytes_be(km.pack_codes(canon, k), k)
    return keys, np.nonzero(ok)[0]


def _canonical_key_set(seqs, k: int) -> np.ndarray:
    """Sorted unique canonical kmer keys over a list of sequences."""
    parts = []
    for seq in seqs:
        keys, _ = _valid_canonical_keys(seq, k)
        if keys is not None:
            parts.append(keys)
    if not parts:
        return np.zeros(0, dtype="S1")
    return np.unique(np.concatenate(parts))


def _novel_positions(window: str, k: int, parental: np.ndarray) -> np.ndarray:
    """Start positions in `window` of N-free kmers absent from `parental`."""
    keys, pos = _valid_canonical_keys(window, k)
    if keys is None:
        return np.zeros(0, dtype=np.int64)
    if parental.size == 0:
        return pos
    i = np.searchsorted(parental, keys)
    i = np.minimum(i, parental.size - 1)
    return pos[parental[i] != keys]


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

def simulate_haploid_child(ref1: dict, ref2: dict, parents=("parent1", "parent2"),
                           mu: float = 2.0, num_variants: int = 3, k: int = 47,
                           seed: int = 0):
    """Simulate one recombinant child with injected de novo variants.

    ref1/ref2: {chrom: seq} with matching chromosome order.
    Returns dict with: child {chrN: seq}, variants (truth rows), kmers (novel
    kmer rows), recombs (per-piece rows), truth_vcf (list of Variant vs the
    originating parent's coordinates).
    """
    rng = np.random.default_rng(seed)
    chrs1, chrs2 = list(ref1), list(ref2)
    assert len(chrs1) == len(chrs2)

    child_seqs = []
    recomb_rows = []
    for i, (c1, c2) in enumerate(zip(chrs1, chrs2)):
        nrec = poisson_draw(rng, mu)
        pieces, sources = recombine(ref1[c1].upper(), ref2[c2].upper(), nrec, k, rng)
        child_seqs.append((pieces, sources))
        start = 0
        for piece, sw in zip(pieces, sources):
            recomb_rows.append({
                "index": -1, "chr": i + 1, "start": start,
                "stop": start + len(piece),
                "parent": parents[sw - 1], "type": "RECOMB",
            })
            start += len(piece)

    # parental kmer keys for novelty detection — vectorized (sorted canonical
    # byte keys + searchsorted membership) so Pf-scale (20+ Mbp) simulation
    # stays seconds, not minutes
    parental = _canonical_key_set(
        [s for ref in (ref1, ref2) for s in ref.values()], k)

    # inject variants (descending position per chromosome to keep indices valid)
    chroms = ["".join(p) for p, _ in child_seqs]
    sources_per_chrom = []
    for pieces, srcs in child_seqs:
        flat = []
        for piece, sw in zip(pieces, srcs):
            flat.extend([sw] * len(piece))
        sources_per_chrom.append(flat)

    planned = []
    for _ in range(num_variants):
        ci = int(rng.integers(0, len(chroms)))
        gen = GENERATORS[rng.integers(0, len(GENERATORS))]
        seq = chroms[ci]
        length = int(rng.integers(1, 20))
        pos = int(rng.integers(150, max(151, len(seq) - 150 - length)))
        vtype, vpos, old, new = gen(seq, pos, rng, length)
        if old.upper() == new.upper():
            continue
        if vpos < 150 or vpos + len(old) + 150 > len(seq):
            continue
        planned.append((ci, vpos, vtype, old, new))

    # apply in reverse position order per chromosome
    planned.sort(key=lambda t: (t[0], t[1]))
    variant_rows = []
    kmer_rows = []
    truth = []
    applied = [list() for _ in chroms]
    for idx in range(len(planned) - 1, -1, -1):
        ci, pos, vtype, old, new = planned[idx]
        # skip overlaps with later-applied variants
        if any(not (pos + len(old) <= a or pos >= b) for a, b in applied[ci]):
            continue
        seq = chroms[ci]
        if seq[pos:pos + len(old)].upper() != old.upper():
            continue
        chroms[ci] = seq[:pos] + new + seq[pos + len(old):]
        applied[ci].append((pos, pos + len(new)))

        seed_left = chroms[ci][pos - 100:pos]
        seed_right = chroms[ci][pos + len(new):pos + len(new) + 100]
        parent_idx = sources_per_chrom[ci][pos] - 1
        parent_name = parents[parent_idx]
        parent_ref = ref1 if parent_idx == 0 else ref2
        parent_chr = (chrs1 if parent_idx == 0 else chrs2)[ci]
        pseq = parent_ref[parent_chr].upper()
        ref_pos_left = pseq.find(seed_left.upper()) + len(seed_left)
        ref_pos_right = pseq.find(seed_right.upper()) + 1

        variant_rows.append({
            "index": idx, "chr": ci + 1, "start": pos, "stop": pos + len(new),
            "parent": parent_name, "type": vtype,
            "old": old or ".", "new": new or ".",
            "sleft": seed_left, "sright": seed_right,
            "refChr": parent_chr, "refStart": ref_pos_left,
            "refStop": ref_pos_right,
        })

        # novel kmers around the variant
        lo = max(0, pos - 100)
        hi = min(len(chroms[ci]) - k, pos + len(new) + 100 - k)
        window = chroms[ci][lo:hi + k].upper()
        novel_at = _novel_positions(window, k, parental)
        seen = [window[p:p + k] for p in novel_at]
        for nki, nk in enumerate(seen):
            kmer_rows.append({
                "index": idx, "numNovel": len(seen), "kmerIndex": nki,
                "kmer": nk, "type": vtype, "chr": ci, "pos": pos,
                "old": old, "new": new,
            })

        if ref_pos_left > len(seed_left) - 1:
            truth.append(Variant(
                chrom=parent_chr, start=ref_pos_left + 1,
                alleles=[old or seed_left[-1], new or seed_left[-1]],
                attributes={"TYPE": vtype, "SEED_LEFT": seed_left,
                            "SEED_RIGHT": seed_right,
                            "BACKGROUND": parent_name},
            ).compute_end_from_alleles())

    child = {f"chr{i + 1}": s for i, s in enumerate(chroms)}
    return {
        "child": child,
        "variants": variant_rows,
        "kmers": kmer_rows,
        "recombs": recomb_rows,
        "truth_vcf": truth,
    }


VARIANT_COLUMNS = ["index", "chr", "start", "stop", "parent", "type", "old",
                   "new", "sleft", "sright", "refChr", "refStart", "refStop"]


def write_tables(result, variants_path, kmers_path):
    with open(variants_path, "w") as f:
        f.write("\t".join(VARIANT_COLUMNS) + "\n")
        for row in result["recombs"]:
            f.write("\t".join(str(row.get(c, ".")) for c in VARIANT_COLUMNS) + "\n")
        for row in result["variants"]:
            f.write("\t".join(str(row.get(c, ".")) for c in VARIANT_COLUMNS) + "\n")
    with open(kmers_path, "w") as f:
        f.write("id\tlength\tkmerIndex\tkmer\ttype\tchr\tpos\told\tnew\n")
        for row in result["kmers"]:
            f.write("\t".join(str(row[c]) for c in
                              ["index", "numNovel", "kmerIndex", "kmer", "type",
                               "chr", "pos", "old", "new"]) + "\n")


def simulate_reads(seqs, coverage: float = 30.0, read_length: int = 150,
                   error_rate: float = 0.002, seed: int = 0) -> list:
    """Uniform shotgun reads with substitution errors, random strand.

    The reference pipeline's read simulation lives in its WDL
    (cromwell/wdl/tasks/PreprocessReads.wdl feeds `mccortex build` real or
    simulated FASTQs); this generator provides the same role in-framework so
    the build->clean->thread cycle can be exercised on error-bearing reads.
    seqs: {name: sequence} or list of sequences.  Fully vectorized: windows
    are gathered per chromosome, errors applied as masked base shifts, and a
    random half of the reads is reverse-complemented.
    """
    from . import kmer as _km
    rng = np.random.default_rng(seed)
    items = seqs.values() if isinstance(seqs, dict) else seqs
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    out: list = []
    for s in items:
        arr = _km.string_to_codes_permissive(s)
        n_bases = len(arr)
        if n_bases < read_length:
            continue
        n_reads = int(np.ceil(n_bases * coverage / read_length))
        starts = rng.integers(0, n_bases - read_length + 1, n_reads)
        reads = arr[starts[:, None] + np.arange(read_length)]
        if error_rate > 0:
            em = rng.random(reads.shape) < error_rate
            shift = rng.integers(1, 4, reads.shape, dtype=np.int16)
            reads = np.where(em & (reads < 4),
                             (reads + shift) % 4, reads).astype(np.uint8)
        flips = rng.random(n_reads) < 0.5
        rc = reads[:, ::-1].astype(np.int16)
        rc = np.where(rc > 3, 4, 3 - rc)
        reads = np.where(flips[:, None], rc, reads).astype(np.uint8)
        txt = lut[np.minimum(reads, 4)]
        out.extend(row.tobytes().decode() for row in txt)
    return out
