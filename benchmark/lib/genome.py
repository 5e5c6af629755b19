"""The trio a run serves, made from the run's seed.

`make_trio` draws two parental genomes as the Corticall flagship simulates
them (a vectorised copy of corticall_tpu_torch/demo.py::make_cross: random
chromosomes, dispersed repeat families pasted into the shared backbone, the
father the mother with SNP divergence), then the child: one crossover a
chromosome and de novo mutations (SNVs, insertions and deletions).  Bases
are drawn independently at the configuration's A+T share (`at_share`; the
demo draws them uniformly), so the sequence has the genome's composition
but not its low-complexity tracts or the assembly's own repeats.  Every
array is 2-bit base codes, A=0 C=1 G=2 T=3, in uint8.  Nothing here imports
the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class Site:
    """An event in the child: a DNM or a crossover, at child coordinate
    `pos` of chromosome `chrom`."""
    chrom: int
    pos: int
    kind: str


@dataclass
class Trio:
    k: int
    mother: list            # uint8 codes a chromosome
    father: list
    child: list
    sites: list = field(default_factory=list)
    # per chromosome: sorted child coordinates where the parent offset
    # changes, and the offset (parent - child) from there on
    offsets: list = field(default_factory=list)

    def genomes(self) -> list:
        """[(colour name, chromosomes)] in colour order: child, mother, father."""
        return [("child", self.child), ("mother", self.mother), ("father", self.father)]

    def parent_pos(self, chrom: int, child_pos: int) -> int:
        at, off = self.offsets[chrom]
        i = int(np.searchsorted(at, child_pos, side="right")) - 1
        return child_pos + (int(off[i]) if i >= 0 else 0)


def to_string(codes: np.ndarray) -> str:
    return BASES[codes].tobytes().decode()


def draw_bases(rng: np.random.Generator, shape, at_share: float) -> np.ndarray:
    """uint8 base codes, A and T each at at_share / 2, C and G each at the
    rest's half."""
    gc = (1.0 - at_share) / 2
    cdf = np.array([at_share / 2, at_share / 2 + gc, at_share / 2 + 2 * gc])
    return np.searchsorted(cdf, rng.random(shape), side="right").astype(np.uint8)


def make_trio(cfg: dict, seed: int) -> Trio:
    """The configuration's trio for `seed` (any non-negative integer)."""
    rng = np.random.default_rng(seed)
    total = int(round(cfg["genome_mbp"] * 1e6))
    n_chroms = int(cfg["chromosomes"])
    size = total // n_chroms
    rlen, copies = int(cfg["repeat_len"]), int(cfg["repeat_copies"])
    at = float(cfg["at_share"])
    units = draw_bases(rng, (int(cfg["repeat_units"]), rlen), at)
    div = float(cfg["parental_divergence"])
    mother, father = [], []
    for _ in range(n_chroms):
        codes = draw_bases(rng, size, at)
        for u in units:
            for pos in rng.integers(0, size - rlen, max(1, copies // n_chroms)):
                codes[pos:pos + rlen] = u
        mut = rng.random(size) < div
        shift = rng.integers(1, 4, size, dtype=np.uint8)
        mother.append(codes)
        father.append(np.where(mut, (codes + shift) % 4, codes).astype(np.uint8))

    # the child: one crossover a chromosome, from a parent drawn at random
    child, sites, crossovers = [], [], []
    margin = 4 * int(cfg["max_query"])
    for c in range(n_chroms):
        x = int(rng.integers(margin, size - margin))
        first, second = (mother[c], father[c]) if rng.random() < 0.5 else (father[c], mother[c])
        child.append(np.concatenate([first[:x], second[x:]]))
        crossovers.append(x)

    # de novo mutations, applied right to left so that each parent
    # coordinate is still valid when it is applied
    n_dnm = int(cfg["dnms"])
    chrom_of = rng.integers(0, n_chroms, n_dnm)
    pos_of = rng.integers(margin, size - margin, n_dnm)
    kind_of = rng.choice(np.array(["snv", "ins", "del"]), n_dnm, p=cfg["dnm_mix"])
    len_of = rng.integers(1, int(cfg["max_indel"]) + 1, n_dnm)
    ins_codes = draw_bases(rng, (n_dnm, int(cfg["max_indel"])), at)
    snv_shift = rng.integers(1, 4, n_dnm, dtype=np.uint8)
    offsets = []
    for c in range(n_chroms):
        idx = np.nonzero(chrom_of == c)[0]
        idx = idx[np.argsort(pos_of[idx], kind="stable")[::-1]]
        seq = child[c]
        events = []                               # (parent pos, delta length)
        for i in idx:
            p, n = int(pos_of[i]), int(len_of[i])
            if kind_of[i] == "snv":
                seq[p] = (seq[p] + snv_shift[i]) % 4
                events.append((p, 0, "snv"))
            elif kind_of[i] == "ins":
                seq = np.concatenate([seq[:p], ins_codes[i, :n], seq[p:]])
                events.append((p, n, "ins"))
            else:
                seq = np.concatenate([seq[:p], seq[p + n:]])
                events.append((p, -n, "del"))
        child[c] = seq
        events.reverse()                          # left to right, parent coordinates
        at, off, delta, x = [], [], 0, crossovers[c]
        for p, d, kind in events:
            if x is not None and x < p:
                sites.append(Site(c, x + delta, "crossover"))
                x = None
            child_p = p + delta
            sites.append(Site(c, child_p, kind))
            delta += d
            at.append(child_p + max(d, 0))
            off.append(-delta)
        if x is not None:
            sites.append(Site(c, x + delta, "crossover"))
        offsets.append((np.asarray(at, dtype=np.int64), np.asarray(off, dtype=np.int64)))
    sites.sort(key=lambda s: (s.chrom, s.pos))
    return Trio(int(cfg["k"]), mother, father, child, sites, offsets)
