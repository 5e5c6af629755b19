"""Link-following state machine for a single walk.

Exact reimplementation of McCortex link-following as the reference encodes it
(LinkStore.java:14-159, LinkStoreElement.java): active link elements keyed by
junction-choice string, each with a position (junctions already consumed) and
an age; junction decisions come from the *oldest* link set when unambiguous;
disagreeing or exhausted links expire.

Behavioral notes replicated deliberately (they shape golden contigs):
- elements of the same junction string can coexist at different positions;
  the emitted choice char comes from the LAST element of the chosen junction
  list in insertion order (LinkStore.java:128-131), while candidate agreement
  is checked over oldest elements only (getOldestLink, :92-120);
- expire removes elements whose next char mismatches OR whose position would
  run past the end (incrementPositionsAndExpire, :58-90);
- ages increment once per junction consumed and once per step that added new
  links (TraversalEngine.java:271-277).

The batched device equivalent (fixed-capacity per-walk arrays) lives in
ops/traversal.py; this host version is the correctness oracle.
"""

from __future__ import annotations

from ..kmer import revcomp

_COMP = str.maketrans("ACGT", "TGCA")


class LinkStoreElement:
    __slots__ = ("junctions", "age", "pos", "source")

    def __init__(self, junctions: str, age: int, pos: int, source: str):
        self.junctions = junctions
        self.age = age
        self.pos = pos
        self.source = source


class LinkStore:
    def __init__(self):
        # junction string -> list of elements, insertion-ordered (dict is ordered)
        self.elements: dict[str, list[LinkStoreElement]] = {}

    def add(self, cur_kmer: str, record_kmer: str, junction_records, go_forward: bool,
            source: str) -> None:
        """Add the links of a kmer's record as it is reached by the walk.

        cur_kmer: the walk-orientation kmer string; record_kmer: the kmer
        string stored in the links file (canonical for indexed links).
        """
        orientation_matches = record_kmer == cur_kmer
        for jr in junction_records:
            link_goes_forward = orientation_matches == jr.forward
            junctions = jr.choices if link_goes_forward else jr.choices.translate(_COMP)
            if link_goes_forward == go_forward:
                self.elements.setdefault(junctions, []).append(
                    LinkStoreElement(junctions, 0, 0, source)
                )

    def increment_ages(self) -> None:
        for lst in self.elements.values():
            for el in lst:
                el.age += 1

    def num_new_paths(self) -> int:
        return sum(1 for lst in self.elements.values() for el in lst if el.age == 0)

    def is_active(self) -> bool:
        return len(self.elements) > 0

    def size(self) -> int:
        return sum(len(v) for v in self.elements.values())

    def _oldest_link(self):
        """Junction string of the oldest link set iff all oldest elements agree
        on the next choice char; else None."""
        max_age = None
        for lst in self.elements.values():
            for el in lst:
                if max_age is None or el.age > max_age:
                    max_age = el.age
        if max_age is None:
            return None
        oldest = [el for lst in self.elements.values() for el in lst if el.age == max_age]
        choices = {el.junctions[el.pos] for el in oldest if el.pos + 1 <= len(el.junctions)}
        return oldest[0].junctions if len(choices) == 1 else None

    def _consume(self, choice: str) -> None:
        for junctions in list(self.elements.keys()):
            lst = self.elements[junctions]
            keep = []
            for el in lst:
                if el.pos + 1 >= len(el.junctions) or el.junctions[el.pos] != choice:
                    continue  # expire
                el.pos += 1
                keep.append(el)
            if keep:
                self.elements[junctions] = keep
            else:
                del self.elements[junctions]

    def next_junction_choice(self):
        """(choice char or None, set of link sources)."""
        junctions = self._oldest_link()
        choice = None
        sources: set[str] = set()
        if junctions is not None:
            for el in self.elements[junctions]:
                choice = el.junctions[el.pos]
                for jl in self.elements:
                    if el.pos < len(jl) and jl[el.pos] == choice:
                        sources.add(el.source)
            self._consume(choice)
        return choice, sources
