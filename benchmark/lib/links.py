"""The child's read links: reads drawn from the child's genome, threaded
through the child colour as `mccortex thread` threads them, written as a
McCortex links file.

Reads are error-free substrings of the child's chromosomes, `read_length`
bases at `link_read_coverage` times the genome, starts and strands drawn
from the seed.  Threading follows TempLinksAssembler.java:29-72, as the
port's build.thread_reads does it, on each read in both orientations: at
each out-branching k-mer of the child colour that the read leaves by an
edge, the base it takes is appended to the choice string of the k-mer that
precedes each earlier in-branching k-mer of the read.  A record is keyed by
its canonical k-mer, F when the keyed k-mer is the canonical one; equal
records merge; then a record whose choices are a proper prefix of another's
of the same orientation is dropped and its coverage added to the longer one
(io/links.merge_prefix_links, the pipeline's Thread stage).

The reads are error-free, so a read holds a record only where it covers an
in-branching k-mer followed by an out-branching one: the in- and
out-degrees of every oriented k-mer are found on the device by grouping the
k-mers of both strands of every chromosome, and each read's events by
binary searches over the few branching positions.  Only those events come
to the host.  Oriented sequences are numbered as reference/walks.ChildGraph
numbers them: 2 c the chromosome c, 2 c + 1 its reverse complement.
Nothing here imports the program.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.lib import graph as bgraph

BASES = "ACGT"
_COMP = str.maketrans("ACGT", "TGCA")


@dataclass
class ReadLinks:
    k: int
    # canonical k-mer string -> [(forward, choices, coverage)] in file order
    records: dict
    reads: int
    # bool [positions] over the oriented sequences (k-mer positions, in
    # ChildGraph's order): the oriented k-mer there holds records facing it
    carries: torch.Tensor
    start: np.ndarray        # int64 [2 C]: each oriented sequence's first position

    def counts(self) -> dict:
        n = sum(len(v) for v in self.records.values())
        longest = max((len(c) for v in self.records.values() for _, c, _ in v), default=0)
        return {"link_records": n, "kmers_with_links": len(self.records),
                "longest_choices": longest, "reads": self.reads}


def draw_reads(chroms: list, coverage: float, read_length: int, seed: int):
    """(chrom, start, strand) int64 arrays of the reads: round(coverage *
    length / read_length) a chromosome, starts uniform over its positions."""
    rng = np.random.default_rng([seed, 13])
    chrom, start = [], []
    for c, seq in enumerate(chroms):
        n = int(round(coverage * len(seq) / read_length))
        chrom.append(np.full(n, c, dtype=np.int64))
        start.append(rng.integers(0, len(seq) - read_length + 1, n))
    chrom = np.concatenate(chrom)
    return chrom, np.concatenate(start), rng.integers(0, 2, len(chrom))


def _kmer_string(words: np.ndarray, k: int) -> str:
    w = len(words)
    return "".join(BASES[(int(words[w - 1 - (2 * (k - 1 - i)) // 32]) >> ((2 * (k - 1 - i)) % 32))
                         & 3] for i in range(k))


def _branching(seqs: list, k: int, device):
    """Over the oriented sequences' k-mer positions, concatenated: (words
    int64 [P, W], gid int64 [P] (equal oriented k-mers share one), out-degree
    and in-degree int64 [P], next base int64 [P] (-1 at a sequence's last
    k-mer), start int64 [S])."""
    words, nxt, prv, start, total = [], [], [], [], 0
    for s in seqs:
        codes = torch.from_numpy(np.ascontiguousarray(s)).to(device)
        fwd, _ = bgraph.kmer_words(codes, k)
        n = fwd.shape[0]
        c64 = codes.to(torch.int64)
        nb = torch.full((n,), -1, dtype=torch.int64, device=device)
        pb = torch.full((n,), -1, dtype=torch.int64, device=device)
        nb[:n - 1] = c64[k:]
        pb[1:] = c64[:n - 1]
        words.append(fwd)
        nxt.append(nb)
        prv.append(pb)
        start.append(total)
        total += n
    words, nxt, prv = torch.cat(words), torch.cat(nxt), torch.cat(prv)
    order = bgraph.lex_order(words)
    gid = torch.empty_like(order)
    gid[order] = bgraph.group_ids(words[order])
    del order
    groups = int(gid.max()) + 1
    deg = []
    for base in (nxt, prv):
        mask = torch.zeros(groups, dtype=torch.int64, device=device)
        has = base >= 0
        for b in range(4):
            one = torch.zeros(groups, dtype=torch.int64, device=device)
            one.scatter_reduce_(0, gid[has], (base[has] == b).to(torch.int64), reduce="amax")
            mask += one
        deg.append(mask[gid])
    return words, gid, deg[0], deg[1], nxt, np.asarray(start, dtype=np.int64)


def thread(chroms: list, k: int, reads, read_length: int, device) -> ReadLinks:
    """The links that the reads (draw_reads') thread through the child
    colour of the genome `chroms`."""
    seqs = []
    for c in chroms:
        seqs.append(c)
        seqs.append((3 - c[::-1]).astype(np.uint8))
    words, gid, out_deg, in_deg, nxt, start = _branching(seqs, k, device)
    # out-branching k-mers that a read can leave by an edge, in-branching
    # k-mers that a read can enter by one: sorted global positions
    jpos = torch.nonzero((out_deg > 1) & (nxt >= 0)).squeeze(1)
    ipos = torch.nonzero(in_deg > 1).squeeze(1)
    # each read in both orientations, as a span [a, a + m) of k-mer positions
    chrom, s, _ = reads
    lens = np.array([len(c) for c in chroms], dtype=np.int64)
    m = read_length - k + 1
    a = np.concatenate([start[2 * chrom] + s, start[2 * chrom + 1] + lens[chrom] - s - read_length])
    a = torch.from_numpy(a).to(device)
    # the in-branching k-mers p in (a, a + m - 1], entered from the read's
    # k-mer p - 1, the key
    lo = torch.searchsorted(ipos, a + 1)
    cnt = torch.searchsorted(ipos, a + m - 1, right=True) - lo
    span = torch.repeat_interleave(torch.arange(a.shape[0], device=device), cnt)
    nth = torch.arange(span.shape[0], device=device) - (torch.cumsum(cnt, 0) - cnt)[span]
    p = ipos[lo[span] + nth]
    key = p - 1
    # the out-branching k-mers q in [key, a + m - 2]: the choices, in read order
    jlo = torch.searchsorted(jpos, key)
    jhi = torch.searchsorted(jpos, a[span] + m - 2, right=True)
    keep = jlo < jhi
    key, jlo, jhi = key[keep], jlo[keep], jhi[keep]
    # to the host: the keys' words, the junctions' bases; each distinct
    # (key, junction run) once
    events = torch.unique(torch.stack([key, jlo, jhi], dim=1), dim=0).cpu().numpy()
    choice_base = nxt[jpos].cpu().numpy()
    kw = bgraph.to_uint32(words[torch.from_numpy(events[:, 0]).to(device)])
    found: dict = {}
    for (kpos, j0, j1), w in zip(events, kw):
        kmer = _kmer_string(w, k)
        rc = kmer.translate(_COMP)[::-1]
        fw = kmer < rc
        choices = "".join(BASES[b] for b in choice_base[j0:j1])
        found.setdefault(kmer if fw else rc, set()).add((fw, choices))
    records = {key_s: merge_prefixes(sorted(recs)) for key_s, recs in found.items()}
    # the oriented k-mers that hold records facing them: the keys' groups
    holds = torch.zeros(int(gid.max()) + 1, dtype=torch.bool, device=device)
    holds[gid[torch.from_numpy(events[:, 0]).to(device)]] = True
    return ReadLinks(k, records, len(chrom), holds[gid], start)


def merge_prefixes(recs: list) -> list:
    """Distinct (forward, choices) records of a k-mer, each of coverage 1,
    in order: those whose choices are a proper prefix of another record's of
    the same orientation dropped, their coverage added to each longer one
    -> [(forward, choices, coverage)]."""
    out = []
    for fw, ch in recs:
        if any(f == fw and len(c) > len(ch) and c.startswith(ch) for f, c in recs):
            continue
        absorbed = sum(1 for f, c in recs if f == fw and len(c) < len(ch) and ch.startswith(c))
        out.append((fw, ch, 1 + absorbed))
    return out


def passes_links(links: ReadLinks, origin, num_steps: int) -> np.ndarray:
    """bool [n]: whether the first num_steps bases from each seed at
    origin (chrom, strand, q: oriented sequence 2 chrom + strand, k-mer
    position q) pass an oriented k-mer that holds records facing it."""
    chrom, strand, q = origin
    dev = links.carries.device
    ends = np.append(links.start[1:], links.carries.shape[0])
    o = 2 * chrom + strand
    lo = links.start[o] + q
    hi = np.minimum(lo + num_steps - 1, ends[o] - 1)     # the k-mers looked up
    cum = torch.zeros(links.carries.shape[0] + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(links.carries.to(torch.int64), 0)
    lo_t, hi_t = (torch.from_numpy(x).to(dev) for x in (lo, hi))
    return (cum[hi_t + 1] - cum[lo_t] > 0).cpu().numpy()


def write_ctp(path: str, links: ReadLinks, sample: str, num_kmers_in_graph: int) -> None:
    """The links as a McCortex .ctp.gz (CortexLinksIterable.java:49-170): a
    JSON header, then `<kmer> <n>` and `F|R <n> <coverages> <choices>`
    lines."""
    header = {
        "file_format": "ctp", "format_version": 4, "file_key": 0,
        "graph": {"num_colours": 1, "kmer_size": links.k,
                  "num_kmers_in_graph": num_kmers_in_graph,
                  "colours": [{"colour": 0, "sample": sample, "total_sequence": 0,
                               "cleaned_tips": False, "cleaned_unitigs": False}]},
        "paths": {"num_kmers_with_paths": len(links.records),
                  "num_paths": sum(len(v) for v in links.records.values()),
                  "path_bytes": sum(len(v) for v in links.records.values())},
    }
    lines = [json.dumps(header, indent=2), ""]
    for kmer, recs in links.records.items():
        lines.append(f"{kmer} {len(recs)}")
        lines += [f"{'F' if fw else 'R'} {len(ch)} {cov} {ch}" for fw, ch, cov in recs]
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write("\n".join(lines) + "\n")
