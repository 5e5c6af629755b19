"""GFF3 parsing + interval queries (utils/io/gff/GFF3.java equivalent)."""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field


@dataclass
class GFF3Record:
    seqid: str
    source: str
    type: str
    start: int          # 1-based inclusive
    end: int
    score: str
    strand: str
    phase: str
    attributes: dict = field(default_factory=dict)

    def get_attribute(self, key, default=None):
        return self.attributes.get(key, default)

    @property
    def interval(self):
        return (self.seqid, self.start, self.end)


def _parse_attributes(s: str) -> dict:
    out = {}
    for kv in s.split(";"):
        kv = kv.strip()
        if "=" in kv:
            k, v = kv.split("=", 1)
            out[k] = v
    return out


class GFF3:
    def __init__(self, path=None, records=None):
        self.records: list[GFF3Record] = list(records or [])
        if path is not None:
            opener = gzip.open if str(path).endswith(".gz") else open
            with opener(path, "rt") as f:
                for line in f:
                    if line.startswith("#") or not line.strip():
                        continue
                    p = line.rstrip("\n").split("\t")
                    if len(p) < 9:
                        continue
                    self.records.append(GFF3Record(
                        p[0], p[1], p[2], int(p[3]), int(p[4]), p[5], p[6],
                        p[7], _parse_attributes(p[8])))

    def __iter__(self):
        return iter(self.records)

    def __len__(self):
        return len(self.records)

    def get_type(self, ftype: str):
        return [r for r in self.records if r.type == ftype]

    def get_contained(self, seqid: str, start: int, end: int):
        """Records fully contained in [start, end] on seqid."""
        return [r for r in self.records
                if r.seqid == seqid and r.start >= start and r.end <= end]

    def get_overlapping(self, seqid: str, start: int, end: int):
        return [r for r in self.records
                if r.seqid == seqid and r.start <= end and r.end >= start]
