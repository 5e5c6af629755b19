"""XMFA (eXtended Multi-FastA) alignment blocks (utils/io/xmfa/XMFASequenceFile.java).

Blocks of aligned sequences separated by '=' lines; headers carry
'seqid:start-end strand comments'.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class XMFAEntry:
    seqid: str
    start: int
    end: int
    strand: str
    comment: str
    sequence: str


@dataclass
class XMFABlock:
    entries: list = field(default_factory=list)

    def __len__(self):
        return len(self.entries)


def read_xmfa(path) -> list:
    blocks: list[XMFABlock] = []
    block = XMFABlock()
    header = None
    seq: list = []

    def flush_entry():
        nonlocal header, seq
        if header is None:
            return
        tokens = header.split()
        loc = tokens[0]
        strand = tokens[1] if len(tokens) > 1 else "+"
        comment = " ".join(tokens[2:])
        if ":" in loc and "-" in loc.split(":", 1)[1]:
            seqid, rng = loc.split(":", 1)
            a, b = rng.split("-", 1)
            start, end = int(a), int(b)
        else:
            seqid, start, end = loc, 0, 0
        block.entries.append(XMFAEntry(seqid, start, end, strand, comment,
                                       "".join(seq)))
        header, seq = None, []

    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                flush_entry()
                header = line[1:].strip()
            elif line.startswith("="):
                flush_entry()
                if block.entries:
                    blocks.append(block)
                block = XMFABlock()
            elif line and header is not None:
                seq.append(line.strip())
    flush_entry()
    if block.entries:
        blocks.append(block)
    return blocks
