"""FASTA reading/writing (htsjdk IndexedFastaSequenceFile stand-in, host side)."""

from __future__ import annotations

import gzip


def read_fasta(path) -> dict:
    """-> insertion-ordered {name: sequence} (name = first whitespace token)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    seqs: dict[str, list] = {}
    full_names: dict[str, str] = {}
    name = None
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                full = line[1:]
                name = full.split()[0]
                seqs[name] = []
                full_names[name] = full
            else:
                seqs[name].append(line.upper())
    return {n: "".join(parts) for n, parts in seqs.items()}


def read_fasta_full_headers(path) -> list:
    """-> [(full_header, sequence)] preserving complete header lines."""
    opener = gzip.open if str(path).endswith(".gz") else open
    out = []
    header = None
    parts: list = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    out.append((header, "".join(parts)))
                header = line[1:]
                parts = []
            else:
                parts.append(line.upper())
    if header is not None:
        out.append((header, "".join(parts)))
    return out


def write_fasta(path, seqs: dict, width: int = 80) -> None:
    with open(path, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + "\n")


def write_fai(path, seqs: dict, width: int = 80) -> None:
    """Write a samtools-compatible .fai for a file produced by write_fasta."""
    with open(str(path) + ".fai", "w") as f:
        offset = 0
        for name, seq in seqs.items():
            offset += len(name) + 2  # '>' + name + '\n'
            nlines = -(-len(seq) // width) if seq else 0
            f.write(f"{name}\t{len(seq)}\t{offset}\t{width}\t{width + 1}\n")
            offset += len(seq) + nlines
