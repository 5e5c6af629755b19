"""TSV table reader/writer (utils/io/table/TableReader.java, TableWriter.java)."""

from __future__ import annotations

import gzip


class TableReader:
    """Iterates TSV rows as dicts; optional explicit column names when the
    file has no header line (TableReader.java constructor overloads)."""

    def __init__(self, path, columns=None):
        self.path = path
        self.columns = list(columns) if columns else None

    def __iter__(self):
        opener = gzip.open if str(self.path).endswith(".gz") else open
        with opener(self.path, "rt") as f:
            cols = self.columns
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split("\t")
                if cols is None:
                    cols = parts
                    continue
                yield dict(zip(cols, parts))


class TableWriter:
    """Column order fixed by the first entry (TableWriter.java)."""

    def __init__(self, stream_or_path):
        if hasattr(stream_or_path, "write"):
            self.f = stream_or_path
            self._own = False
        else:
            self.f = open(stream_or_path, "w")
            self._own = True
        self.columns = None

    def add_entry(self, row: dict) -> None:
        if self.columns is None:
            self.columns = list(row.keys())
            self.f.write("\t".join(self.columns) + "\n")
        self.f.write("\t".join(str(row.get(c, "")) for c in self.columns) + "\n")

    def close(self) -> None:
        if self._own:
            self.f.close()
