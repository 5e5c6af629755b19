"""Tabular containers (utils/containers/: DataFrame, DataTable(s), ContainerUtils)."""

from __future__ import annotations


class DataFrame:
    """Two-key table with a default value (utils/containers/DataFrame.java)."""

    def __init__(self, default=0):
        self.default = default
        self.data: dict = {}
        self.row_keys: list = []
        self.col_keys: list = []

    def set(self, row, col, value):
        if row not in self.data:
            self.data[row] = {}
            self.row_keys.append(row)
        if col not in self.col_keys:
            self.col_keys.append(col)
        self.data[row][col] = value

    def get(self, row, col):
        return self.data.get(row, {}).get(col, self.default)

    def to_tsv(self) -> str:
        lines = ["\t".join([""] + [str(c) for c in self.col_keys])]
        for r in self.row_keys:
            lines.append("\t".join([str(r)] + [str(self.get(r, c))
                                               for c in self.col_keys]))
        return "\n".join(lines) + "\n"


class DataTable:
    """Named table with typed columns (utils/containers/DataTable.java)."""

    def __init__(self, name: str, description: str = "", columns=None):
        self.name = name
        self.description = description
        self.columns = list(columns or [])
        self.rows: dict = {}

    def set(self, primary_key, column, value):
        if column not in self.columns:
            self.columns.append(column)
        self.rows.setdefault(primary_key, {})[column] = value

    def get(self, primary_key, column, default=None):
        return self.rows.get(primary_key, {}).get(column, default)

    def increment(self, primary_key, column):
        self.set(primary_key, column, self.get(primary_key, column, 0) + 1)

    def to_tsv(self) -> str:
        lines = [f"#{self.name}\t{self.description}"]
        lines.append("\t".join(str(c) for c in self.columns))
        for pk in self.rows:
            lines.append("\t".join(str(self.rows[pk].get(c, ""))
                                   for c in self.columns))
        return "\n".join(lines) + "\n"


class DataTables:
    def __init__(self):
        self.tables: dict = {}

    def add(self, name: str, description: str = "", columns=None) -> DataTable:
        t = DataTable(name, description, columns)
        self.tables[name] = t
        return t

    def get(self, name: str) -> DataTable:
        return self.tables[name]

    def write(self, path) -> None:
        with open(path, "w") as f:
            for t in self.tables.values():
                f.write(t.to_tsv())


def increment(d: dict, key) -> None:
    """ContainerUtils.increment."""
    d[key] = d.get(key, 0) + 1


def most_common_key(d: dict):
    """ContainerUtils sort-by-value helper."""
    return max(d, key=lambda k: d[k]) if d else None
