"""Sequencing read input: FASTA/FASTQ, optionally gzipped.

Facade over the two formats (the reference wraps htsjdk FastqReader /
FastaSequenceFile behind utils/io/reads/Reads.java); we sniff the format from
the first record byte.
"""

from __future__ import annotations

import gzip


def read_sequences(path):
    """Yield read sequences (uppercased strings) from FASTA or FASTQ."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        first = f.read(1)
        if not first:
            return
        if first == ">":
            f.readline()  # rest of the first header line ('>' already consumed)
            seq: list = []
            for line in f:
                line = line.strip()
                if line.startswith(">"):
                    if seq:
                        yield "".join(seq).upper()
                    seq = []
                else:
                    seq.append(line)
            if seq:
                yield "".join(seq).upper()
        elif first == "@":
            # FASTQ: 4-line records (first header char already consumed)
            f.readline()  # rest of header
            while True:
                seq = f.readline().strip()
                if not seq:
                    return
                yield seq.upper()
                f.readline()  # +
                f.readline()  # quals
                header = f.readline()
                if not header:
                    return
        else:
            raise ValueError(f"unrecognized read format in {path} (starts {first!r})")
