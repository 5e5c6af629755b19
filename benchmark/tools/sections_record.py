"""Write the sections record that the `sections` traffic reads: one row a
Tesserae section that Call sent in a run of the port, with its query length
and each target's background and length.

    python3 corticall_tpu_torch/tools/flagship.py OUT_DIR
    python3 benchmark/tools/sections_record.py OUT_DIR/sections.json.gz > RECORD.csv

The input is the flagship driver's dump of every section (partition, route,
query, target names and sequences); a target's background is the part of its
name before the first ':' (Call's labels).  Only lengths are kept: a run
cuts sections of these sizes from its own seeded trio.
"""

from __future__ import annotations

import gzip
import json
import sys


def rows(sections: list) -> list:
    out = []
    for s in sections:
        targets = " ".join(f"{n.split(':')[0]}:{len(t)}"
                           for n, t in zip(s["names"], s["targets"]))
        out.append(f"{s['partition']},{s['route']},{len(s['query'])},{targets}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    with gzip.open(argv[0], "rt") as f:
        sections = json.load(f)
    print("partition,route,query,targets")
    print("\n".join(rows(sections)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
