"""Variant model + VCF emission (htsjdk VariantContext stand-in).

Carries exactly the semantics Call relies on: allele strings (ref first),
1-based start/stop, computeEndFromAlleles, isSNP/isSymbolic, attribute map,
filters, and the de-duplicating (contig, start, symbolic) sort order of the
reference's TreeSet comparators (Call.java:1845-1887).
"""

from __future__ import annotations

from dataclasses import dataclass, field


def allele_is_symbolic(a: str) -> bool:
    return ("[" in a or "]" in a or "<" in a or a == "."
            or a.startswith(".") or a.endswith("."))


@dataclass
class Variant:
    """Mutable builder + context in one (VariantContextBuilder semantics)."""
    chrom: str = ""
    start: int = 0             # 1-based
    stop: int = 0              # 1-based inclusive
    alleles: list = field(default_factory=list)  # [ref, alt, ...] strings
    id_: str | None = None
    attributes: dict = field(default_factory=dict)
    filters: set = field(default_factory=set)

    # -- htsjdk-style helpers ------------------------------------------------
    def compute_end_from_alleles(self, start: int | None = None) -> "Variant":
        s = self.start if start is None else start
        self.stop = s + len(self.alleles[0]) - 1
        return self

    @property
    def ref(self) -> str:
        return self.alleles[0]

    @property
    def alt(self) -> str:
        return self.alleles[1] if len(self.alleles) > 1 else ""

    def is_symbolic(self) -> bool:
        return any(allele_is_symbolic(a) for a in self.alleles)

    def is_symbolic_or_sv(self) -> bool:
        return self.is_symbolic() or "SVTYPE" in self.attributes

    def is_snp(self) -> bool:
        return (not self.is_symbolic() and len(self.alleles) >= 2
                and len(self.alleles[0]) == 1 and len(self.alleles[1]) == 1
                and self.alleles[0] != self.alleles[1])

    def get_attr(self, key, default=None):
        return self.attributes.get(key, default)

    def attr(self, key, value) -> "Variant":
        self.attributes[key] = value
        return self

    def rm_attrs(self, keys) -> "Variant":
        for k in keys:
            self.attributes.pop(k, None)
        return self

    def is_filtered(self) -> bool:
        return len(self.filters) > 0

    def copy(self) -> "Variant":
        return Variant(self.chrom, self.start, self.stop, list(self.alleles),
                       self.id_, dict(self.attributes), set(self.filters))


class VariantSorterSet:
    """TreeSet with the reference comparator: order by (sequence-dict index,
    start, symbolic-last); comparator==0 entries are DEDUPLICATED, first
    insert wins (Call.java:1845-1887 TreeSet semantics)."""

    def __init__(self, seq_index: dict):
        self.seq_index = seq_index
        self._items: dict = {}

    def _key(self, v: Variant):
        return (self.seq_index.get(v.chrom, 0), v.start, 1 if v.is_symbolic() else 0)

    def add(self, v: Variant) -> bool:
        k = self._key(v)
        if k in self._items:
            return False
        self._items[k] = v
        return True

    def add_all(self, vs) -> None:
        for v in vs:
            self.add(v)

    def __iter__(self):
        return iter(v for _, v in sorted(self._items.items(), key=lambda kv: kv[0]))

    def __len__(self):
        return len(self._items)

    def remove_all(self, vs) -> None:
        victims = {id(v) for v in vs}
        self._items = {k: v for k, v in self._items.items() if id(v) not in victims}

    def to_list(self) -> list:
        return list(self)


def read_vcf(path: str):
    """Parse a corticall VCF back into Variant objects.  Returns
    (variants, sequence_dict) where sequence_dict is [(name, length)] from
    the ##contig header lines.  INFO keys land in the attribute map as
    strings; FILTER values other than ./PASS become filters."""
    variants = []
    seq_dict = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("##contig=<"):
                body = line[len("##contig=<"):-1]
                kv = dict(p.split("=", 1) for p in body.split(",") if "=" in p)
                seq_dict.append((kv.get("ID", "?"), int(kv.get("length", 0))))
                continue
            if line.startswith("#"):
                continue
            fields = line.split("\t")
            chrom, pos, vid, ref, alt = fields[:5]
            filt = fields[6] if len(fields) > 6 else "."
            v = Variant(chrom, int(pos), 0, [ref] + alt.split(","),
                        id_=None if vid == "." else vid)
            if not v.is_symbolic():
                v.compute_end_from_alleles()
            for kv in (fields[7].split(";") if len(fields) > 7 else []):
                if "=" in kv:
                    kk, vv = kv.split("=", 1)
                    v.attr(kk, vv)
            if filt not in (".", "PASS"):
                v.filters.update(filt.split(";"))
            variants.append(v)
    return variants, seq_dict


def format_info(attributes: dict) -> str:
    if not attributes:
        return "."
    parts = []
    for k in sorted(attributes):
        v = attributes[k]
        if isinstance(v, bool):
            v = str(v).lower()
        elif isinstance(v, float):
            v = f"{v:g}"
        s = str(v).replace(" ", "_").replace(";", ",")
        parts.append(f"{k}={s}")
    return ";".join(parts)


def write_vcf(path, variants, sequence_dict: list) -> None:
    """sequence_dict: [(name, length)] in order."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("##source=corticall_tpu\n")
        for name, length in sequence_dict:
            f.write(f"##contig=<ID={name},length={length}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for v in variants:
            filt = ";".join(sorted(v.filters)) if v.filters else "PASS"
            alt = ",".join(v.alleles[1:]) if len(v.alleles) > 1 else "."
            f.write("\t".join([
                v.chrom, str(v.start), v.id_ or ".", v.alleles[0] or ".",
                alt, ".", filt, format_info(v.attributes),
            ]) + "\n")
