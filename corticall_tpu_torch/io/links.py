"""McCortex link annotations (.ctp.gz / .ctp.bgz) reader/writer + fixture builder.

Format (CortexLinksIterable.java:49-170): gzip text — a pretty-printed JSON
header (format_version 2/3/4), optional '#' comment lines, then records:

    <kmer> <numLinks>
    [F|R] <numKmers> <cov,cov,...> <junctionChoices>     x numLinks

The fixture builder replicates TempLinksAssembler.java:29-105: re-thread
simulated reads through the graph, emitting a junction-choice string for every
kmer preceding an in-branching kmer upstream of an out-branching junction.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass, field

from .. import kmer as km
from .. import graph as gr


@dataclass(frozen=True)
class JunctionRecord:
    """One link: orientation flag + junction-choice string (CortexJunctionsRecord.java)."""
    forward: bool
    num_kmers: int
    coverages: tuple
    choices: str

    def to_text(self) -> str:
        return f"{'F' if self.forward else 'R'} {len(self.choices)} {','.join(map(str, self.coverages))} {self.choices}"


@dataclass
class LinksData:
    """All link records of one .ctp file, keyed by the record's stored kmer string.

    Equivalent of ConnectivityAnnotations (CortexLinksMap / CortexLinksRandomAccess).
    """
    sample_name: str
    kmer_size: int
    records: dict = field(default_factory=dict)  # kmer str -> list[JunctionRecord]
    source: str = "unknown"                      # link source label (idx sidecar; else "unknown")
    num_kmers_in_graph: int = 0

    def __contains__(self, kmer_str: str) -> bool:
        return kmer_str in self.records

    def get(self, kmer_str: str):
        return self.records.get(kmer_str)

    def __len__(self) -> int:
        return len(self.records)


def _links_header_json(kmer_size: int, num_kmers_in_graph: int, sample: str,
                       num_kmers_with_links: int, num_paths: int) -> dict:
    return {
        "file_format": "ctp",
        "format_version": 4,
        "file_key": 0,
        "graph": {
            "num_colours": 1,
            "kmer_size": kmer_size,
            "num_kmers_in_graph": num_kmers_in_graph,
            "colours": [{
                "colour": 0,
                "sample": sample,
                "total_sequence": 0,
                "cleaned_tips": False,
                "cleaned_unitigs": False,
            }],
        },
        "paths": {
            "num_kmers_with_paths": num_kmers_with_links,
            "num_paths": num_paths,
            "path_bytes": num_paths,
        },
    }


def write_links(path, data: LinksData) -> None:
    num_paths = sum(len(v) for v in data.records.values())
    header = _links_header_json(data.kmer_size, data.num_kmers_in_graph,
                                data.sample_name, len(data.records), num_paths)
    with gzip.open(path, "wt") as f:
        f.write(json.dumps(header, indent=2))
        f.write("\n\n")
        for kmer_str, recs in data.records.items():
            f.write(f"{kmer_str} {len(recs)}\n")
            for jr in recs:
                f.write(jr.to_text() + "\n")
        f.write("\n")


def read_links(path) -> LinksData:
    with gzip.open(path, "rt") as f:
        lines = f.read().splitlines()
    # header: lines from '{' to the matching top-level '}'
    i = 0
    while i < len(lines) and lines[i].strip() != "{" and not lines[i].startswith("{"):
        i += 1
    depth = 0
    header_lines = []
    while i < len(lines):
        line = lines[i]
        header_lines.append(line)
        depth += line.count("{") - line.count("}")
        i += 1
        if depth == 0 and header_lines:
            break
    header = json.loads("\n".join(header_lines))
    version = header.get("format_version", header.get("formatVersion"))
    if version == 2:
        kmer_size = header["kmer_size"]
        sample = header["colours"][0]["sample"]
        nkig = header.get("num_kmers_in_graph", 0)
    elif version in (3, 4):
        kmer_size = header["graph"]["kmer_size"]
        sample = header["graph"]["colours"][0]["sample"]
        nkig = header["graph"].get("num_kmers_in_graph", 0)
    else:
        raise ValueError(f"unsupported ctp format version {version}")

    data = LinksData(sample_name=sample, kmer_size=kmer_size, num_kmers_in_graph=nkig)
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        kmer_str, num_links = parts[0], int(parts[1])
        recs = []
        for _ in range(num_links):
            lp = lines[i].split()
            i += 1
            covs = tuple(int(x) for x in lp[2].split(","))
            recs.append(JunctionRecord(lp[0] == "F", int(lp[1]), covs, lp[3]))
        data.records[kmer_str] = recs
    return data


# ---------------------------------------------------------------------------
# indexed random access (.ctp.bgz + .ctp.bgz.idx)
# ---------------------------------------------------------------------------
# Index format (CortexLinksRandomAccess.java:34-100, IndexLinks.java:63-136):
# "LNKIDX" | i32 ncolors | i32 k | i64 nKmersInGraph | i64 nKmersWithLinks |
# i64 linkBytes | i32 len + source | per color (i32 len + sampleName) |
# "LNKIDX" | entries: kmer containers (the .ctx on-disk layout) + i64 virtual
# offset + i32 record length.  Integers big-endian (Java ByteBuffer default).

import struct as _struct


def write_links_indexed(path_bgz, data: LinksData, source: str) -> None:
    """Write records to BGZF + the binary sidecar index (IndexLinks parity)."""
    from . import bgzf
    from .. import kmer as _km

    num_paths = sum(len(v) for v in data.records.values())
    header = _links_header_json(data.kmer_size, data.num_kmers_in_graph,
                                data.sample_name, len(data.records), num_paths)
    entries = []
    with bgzf.BgzfWriter(path_bgz) as w:
        w.write(json.dumps(header, indent=2))
        w.write("\n")
        w.write("\n")
        for kmer_str in sorted(data.records):
            recs = data.records[kmer_str]
            text = f"{kmer_str} {len(recs)}\n" + "".join(
                jr.to_text() + "\n" for jr in recs)
            # the reference records the length WITHOUT the final newline
            # (clr.toString().length(); the newline is written separately)
            entries.append((kmer_str, w.tell(), len(text) - 1))
            w.write(text)

    with open(str(path_bgz) + ".idx", "wb") as f:
        f.write(b"LNKIDX")
        f.write(_struct.pack(">iiqqq", 1, data.kmer_size,
                             data.num_kmers_in_graph, len(entries), num_paths))
        f.write(_struct.pack(">i", len(source)) + source.encode())
        name = data.sample_name.encode()
        f.write(_struct.pack(">i", len(name)) + name)
        f.write(b"LNKIDX")
        for kmer_str, vo, length in entries:
            words = _km.pack_codes(_km.string_to_codes(kmer_str))
            # NB: bytes(np.bytes_) strips trailing NULs; tobytes() keeps the
            # fixed container width
            f.write(_km.words_to_disk(words[None, :], data.kmer_size).tobytes())
            f.write(_struct.pack(">qi", vo, length))


class LinksRandomAccess:
    """ConnectivityAnnotations over .ctp.bgz + .idx (lazy record fetch)."""

    def __init__(self, path_bgz):
        from . import bgzf
        from .. import kmer as _km
        self.path = str(path_bgz)
        self.reader = bgzf.BgzfReader(self.path)
        with open(self.path + ".idx", "rb") as f:
            magic = f.read(6)
            if magic != b"LNKIDX":
                raise ValueError("bad links index magic")
            ncolors, k, nkig, nkwl, nbytes = _struct.unpack(">iiqqq", f.read(32))
            (slen,) = _struct.unpack(">i", f.read(4))
            self.source = f.read(slen).decode()
            names = []
            for _ in range(ncolors):
                (ln,) = _struct.unpack(">i", f.read(4))
                names.append(f.read(ln).decode())
            if f.read(6) != b"LNKIDX":
                raise ValueError("bad links index trailer")
            self.kmer_size = k
            self.sample_name = names[0] if names else ""
            self.num_kmers_in_graph = nkig
            s = (k + 31) // 32
            self.index: dict[str, tuple[int, int]] = {}
            for _ in range(nkwl):
                raw = f.read(8 * s)
                vo, length = _struct.unpack(">qi", f.read(12))
                import numpy as _np
                words = _km.disk_to_words(_np.frombuffer(raw, dtype=_np.uint8), k)
                kmer_str = _km.codes_to_string(_km.unpack_words(words[0], k))
                self.index[kmer_str] = (vo, length)

    def __contains__(self, kmer_str: str) -> bool:
        return kmer_str in self.index

    def __len__(self) -> int:
        return len(self.index)

    def get(self, kmer_str: str):
        if kmer_str not in self.index:
            return None
        vo, length = self.index[kmer_str]
        block = self.reader.read_at(vo, length).decode()
        lines = block.splitlines()
        n = int(lines[0].split()[1])
        recs = []
        for line in lines[1:1 + n]:
            lp = line.split()
            covs = tuple(int(x) for x in lp[2].split(","))
            recs.append(JunctionRecord(lp[0] == "F", int(lp[1]), covs, lp[3]))
        return recs

    @property
    def records(self):
        # full materialization (rarely needed; host tools only)
        return {k: self.get(k) for k in self.index}


def open_links(path):
    """CortexLinks facade (CortexLinks.java:17-25): random access if a .idx
    sidecar exists, else full in-memory load."""
    import os
    if os.path.exists(str(path) + ".idx"):
        return LinksRandomAccess(path)
    return read_links(path)


# ---------------------------------------------------------------------------
# fixture builder (TempLinksAssembler semantics)
# ---------------------------------------------------------------------------

def merge_prefix_links(ld: LinksData) -> LinksData:
    """Drop link records whose junction-choice string is a proper prefix of a
    longer same-orientation record on the same kmer, summing coverages into
    the survivor (McCortex's thread path-store merges prefix paths the same
    way).  Walk-exact: prefix elements enter the LinkStore at the same age as
    their extension, always agree with it at every shared junction, and
    expire no later — so removing them cannot change any junction choice
    (LinkStore.java:58-144; traversal/linkstore.py).  Applied by the pipeline
    between Thread and IndexLinks to keep per-kmer record counts (and the
    device walker's fixed caps, ops/walk_links.py) small."""
    out = LinksData(sample_name=ld.sample_name, kmer_size=ld.kmer_size,
                    num_kmers_in_graph=ld.num_kmers_in_graph)
    for key, recs in ld.records.items():
        kept = []
        for r in recs:
            extended = any(
                o is not r and o.forward == r.forward
                and len(o.choices) > len(r.choices)
                and o.choices.startswith(r.choices)
                for o in recs)
            if not extended:
                kept.append(r)
        # fold absorbed coverage into the (first) maximal extension
        merged = []
        for r in kept:
            absorbed = sum(
                o.coverages[0] for o in recs
                if o is not r and o.forward == r.forward
                and r.choices.startswith(o.choices)
                and len(o.choices) < len(r.choices))
            if absorbed:
                r = JunctionRecord(r.forward, r.num_kmers,
                                   (r.coverages[0] + absorbed,)
                                   + tuple(r.coverages[1:]), r.choices)
            merged.append(r)
        out.records[key] = merged
    return out


def build_links(graph: gr.CortexGraph, haplotypes: dict, sample_name: str) -> LinksData:
    """Thread reads through the graph to produce link records.

    Exact TempLinksAssembler.java:29-72 semantics: for each read (fwd and rc),
    at each out-branching kmer sk0 with a followed edge, append that edge base
    to the choice string of every (kmer preceding an in-branching kmer) seen
    earlier on the read.  Records keyed by canonical kmer; F orientation iff
    the keyed kmer is already canonical.
    """
    color = graph.color_for_sample(sample_name)
    k = graph.kmer_size

    # string digraph of this color, both orientations (loadGraph, :108-149)
    out_deg: dict = {}
    in_deg: dict = {}
    verts: set = set()

    def add_edge(a: str, b: str):
        verts.add(a)
        verts.add(b)
        key = (a, b)
        if key in edge_set:
            return
        edge_set.add(key)
        out_deg[a] = out_deg.get(a, 0) + 1
        in_deg[b] = in_deg.get(b, 0) + 1

    edge_set: set = set()
    for i in range(graph.num_records):
        if graph.coverage(i, color) <= 0:
            continue
        fwd = graph.kmer_string(i)
        rev = km.revcomp(fwd)
        e = int(graph.edges[i, color])
        for flipped, sk in ((False, fwd), (True, rev)):
            verts.add(sk)
            prev_mask, next_mask = gr.edges_to_masks(e, flipped)
            for b in range(4):
                if prev_mask & (1 << b):
                    add_edge("ACGT"[b] + sk[:-1], sk)
                if next_mask & (1 << b):
                    add_edge(sk, sk[1:] + "ACGT"[b])

    link_map: dict = {}  # canonical kmer str -> set[JunctionRecord]
    for hap_fwd in haplotypes[sample_name]:
        for hap in (hap_fwd, km.revcomp(hap_fwd)):
            links: dict = {}  # (kmer, i) -> choice string
            for j in range(1, len(hap) - k + 1):
                sk0 = hap[j - 1:j - 1 + k]
                sk1 = hap[j:j + k]
                edge = hap[j + k - 1]
                if out_deg.get(sk0, 0) > 1 and sk1 in verts:
                    for i in range(1, j + 1):
                        ski = hap[i:i + k]
                        if in_deg.get(ski, 0) > 1:
                            skim1 = hap[i - 1:i - 1 + k]
                            links[(skim1, i)] = links.get((skim1, i), "") + edge
            for (kmer_str, _i), choices in links.items():
                canon, flipped = km.canonical_kmer(kmer_str)
                link_map.setdefault(canon, set()).add(
                    JunctionRecord(not flipped, len(choices), (1,), choices)
                )

    data = LinksData(sample_name=sample_name, kmer_size=k,
                     num_kmers_in_graph=graph.num_records)
    for canon in link_map:
        data.records[canon] = list(link_map[canon])
    return data
