"""Traversal stopping rules — the full reference inventory.

Contract (AbstractTraversalStoppingRule.java:4-29): a rule instance lives for
one DFS branch; keep_going evaluates succeeded/failed in that order and both
are sticky via the last call.  Inventory parity: utils/stoppingrules/ (21
classes); each class below cites its source.

State fields mirror TraversalState.java:9-81.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class TraversalState:
    vertex: object                  # subgraph.Vertex
    go_forward: bool
    traversal_colors: list
    joining_colors: list
    graph_size: int                 # accumulated graph size incl. progenitors
    junction_depth: int
    branch_size: int
    num_adjacent_edges: int
    num_adjacent_reverse_edges: int
    children_already_traversed: bool
    reached_max_branch_length: bool
    rois: object                    # CortexGraph of novel kmers, or None
    sinks: set = field(default_factory=set)
    graph: object = None            # the CortexGraph being traversed (record access)

    # -- record helpers ----------------------------------------------------
    def coverage(self, color: int) -> int:
        return self.graph.coverage(self.vertex.rec, color) if self.vertex.rec >= 0 else 0

    def in_degree(self, color: int) -> int:
        return self.graph.in_degree(self.vertex.rec, color) if self.vertex.rec >= 0 else 0

    def out_degree(self, color: int) -> int:
        return self.graph.out_degree(self.vertex.rec, color) if self.vertex.rec >= 0 else 0

    def in_roi(self) -> bool:
        return self.rois is not None and self.rois.find_record(self.vertex.canonical) >= 0

    def joining_has_coverage(self) -> bool:
        return any(self.coverage(c) > 0 for c in self.joining_colors)


class StoppingRule:
    """Base: keep_going / succeeded / failed with sticky outcome flags."""

    def __init__(self):
        self._succeeded = False
        self._failed = False

    def keep_going(self, s: TraversalState) -> bool:
        self._succeeded = self.has_succeeded(s)
        self._failed = self.has_failed(s)
        return not self._succeeded and not self._failed

    def has_succeeded(self, s: TraversalState) -> bool:
        return False

    def has_failed(self, s: TraversalState) -> bool:
        return True

    def succeeded(self) -> bool:
        return self._succeeded

    def failed(self) -> bool:
        return self._failed


class ContigStopper(StoppingRule):
    """Stop (accept) at any branch point or length cap (ContigStopper.java:12-19)."""

    def has_succeeded(self, s):
        return s.num_adjacent_edges != 1 or s.reached_max_branch_length

    def has_failed(self, s):
        return False


class CycleCollapsingContigStopper(StoppingRule):
    """CycleCollapsingContigStopper.java:11-21."""

    def has_succeeded(self, s):
        return s.num_adjacent_edges == 0

    def has_failed(self, s):
        return False


class DestinationStopper(StoppingRule):
    """Reach a sink; junction budget decays exponentially with graph size
    (DestinationStopper.java:9-20)."""

    def has_succeeded(self, s):
        return s.vertex.kmer in s.sinks

    def has_failed(self, s):
        junction_limit = 1 + math.ceil(5.0 * math.exp(-0.0001 * s.graph_size))
        return s.junction_depth > junction_limit or s.reached_max_branch_length


class ExplorationStopper(StoppingRule):
    """ExplorationStopper.java:8-18."""

    def has_succeeded(self, s):
        return s.reached_max_branch_length or s.num_adjacent_edges == 0 or s.junction_depth >= 3

    def has_failed(self, s):
        return False


class BubbleOpeningStopper(StoppingRule):
    """Novel kmers then joining-color contact (BubbleOpeningStopper.java:16-36)."""

    def __init__(self):
        super().__init__()
        self.novel_kmers_seen = 0
        self.distance_since_join = 0
        self.has_joined = False

    def has_succeeded(self, s):
        if s.in_roi():
            self.novel_kmers_seen += 1
        if self.has_joined:
            self.distance_since_join += 1
        self.has_joined |= s.joining_has_coverage()
        return (self.novel_kmers_seen > 0 and self.has_joined
                and (self.distance_since_join >= 30 or s.num_adjacent_edges != 1))

    def has_failed(self, s):
        return self.novel_kmers_seen == 0 and (s.junction_depth >= 5 or s.num_adjacent_edges == 0)


class BubbleClosingStopper(StoppingRule):
    """BubbleClosingStopper.java:11-23."""

    def has_succeeded(self, s):
        return False

    def has_failed(self, s):
        return s.branch_size > 10000 or s.junction_depth >= 2 or s.num_adjacent_edges == 0


class ContaminantStopper(StoppingRule):
    """ContaminantStopper.java:8-30."""

    def has_succeeded(self, s):
        return s.joining_has_coverage() or s.num_adjacent_edges == 0

    def has_failed(self, s):
        return s.joining_has_coverage()


class DustStopper(StoppingRule):
    """Low-complexity chain detector (DustStopper.java:9-50)."""

    def __init__(self):
        super().__init__()
        self.since_last_low_complexity = 0

    def has_succeeded(self, s):
        no_in = any(s.in_degree(c) == 0 for c in s.traversal_colors)
        no_out = any(s.out_degree(c) == 0 for c in s.traversal_colors)
        return no_in or no_out or s.joining_has_coverage()

    def has_failed(self, s):
        is_low = any(s.in_degree(c) + s.out_degree(c) > 4 for c in s.traversal_colors)
        if is_low:
            self.since_last_low_complexity = 0
        else:
            self.since_last_low_complexity += 1
        return self.since_last_low_complexity >= len(s.vertex.kmer)


class GapClosingStopper(StoppingRule):
    """GapClosingStopper.java:11-21."""

    def has_succeeded(self, s):
        return False

    def has_failed(self, s):
        return s.junction_depth > 5 or s.num_adjacent_edges == 0


class NahrStopper(StoppingRule):
    """NahrStopper.java:11-36."""

    def __init__(self):
        super().__init__()
        self.found_novels = False
        self.distance_from_last_novel = 0

    def has_succeeded(self, s):
        if self.found_novels:
            self.distance_from_last_novel += 1
        if s.in_roi():
            self.found_novels = True
            self.distance_from_last_novel += 1
        return self.found_novels and (
            self.distance_from_last_novel >= 1000 or s.junction_depth >= 5
            or s.num_adjacent_edges == 0 or s.children_already_traversed)

    def has_failed(self, s):
        return not self.found_novels and (
            s.branch_size >= 1000 or s.junction_depth >= 2 or s.num_adjacent_edges == 0)


class NovelContinuationStopper(StoppingRule):
    """NovelContinuationStopper.java:12-30."""

    def __init__(self):
        super().__init__()
        self.started_with_novel = False
        self.num_kmers_seen = 0

    def has_succeeded(self, s):
        if (s.junction_depth > 0 and self.num_kmers_seen <= 2 * len(s.vertex.kmer)
                and s.in_roi()):
            self.started_with_novel = True
        self.num_kmers_seen += 1
        return ((s.children_already_traversed and s.num_adjacent_edges != 1)
                or s.reached_max_branch_length)

    def has_failed(self, s):
        return (s.junction_depth > 0 and not self.started_with_novel) or s.junction_depth > 3


class NovelKmerAggregationStopper(StoppingRule):
    """NovelKmerAggregationStopper.java:11-40."""

    def __init__(self):
        super().__init__()
        self.have_seen_novel = False

    def has_succeeded(self, s):
        child_cov = any(s.coverage(c) > 0 for c in s.traversal_colors)
        parent_cov = s.joining_has_coverage()
        if child_cov and not parent_cov:
            self.have_seen_novel = True
        return self.have_seen_novel and parent_cov

    def has_failed(self, s):
        return not self.have_seen_novel and (s.branch_size >= 100 or s.junction_depth >= 3)


class NovelKmerLimitedContigStopper(StoppingRule):
    """NovelKmerLimitedContigStopper.java:17-50."""

    def __init__(self):
        super().__init__()
        self.found_novel = False
        self.distance_from_seed = 0

    def has_succeeded(self, s):
        self.distance_from_seed += 1
        if s.rois is None:
            raise ValueError("NovelKmerLimitedContigStopper requires rois")
        if s.in_roi():
            self.found_novel = True
            self.distance_from_seed = 0
        stop_now = (self.distance_from_seed > 2000 or s.num_adjacent_edges != 1
                    or s.reached_max_branch_length)
        return self.found_novel and stop_now

    def has_failed(self, s):
        return False


class NovelPartitionStopper(StoppingRule):
    """NovelPartitionStopper.java:14-46."""

    def __init__(self):
        super().__init__()
        self.found_novel = False
        self.distance_from_seed = 0

    def _stop_now(self, s):
        return (self.distance_from_seed > 2000 or s.junction_depth > 0
                or s.reached_max_branch_length or s.num_adjacent_edges == 0
                or (s.num_adjacent_edges > 1 and s.children_already_traversed))

    def has_succeeded(self, s):
        self.distance_from_seed += 1
        if s.rois is None:
            raise ValueError("NovelPartitionStopper requires rois")
        if s.in_roi():
            self.found_novel = True
            self.distance_from_seed = 0
        return self.found_novel and self._stop_now(s)

    def has_failed(self, s):
        return not self.found_novel and self._stop_now(s)


class OrphanStopper(StoppingRule):
    """OrphanStopper.java:7-32."""

    def has_succeeded(self, s):
        no_in = any(s.in_degree(c) == 0 for c in s.traversal_colors)
        no_out = any(s.out_degree(c) == 0 for c in s.traversal_colors)
        return no_in or no_out

    def has_failed(self, s):
        return s.joining_has_coverage()


class PairedReadClosingStopper(StoppingRule):
    """PairedReadClosingStopper.java:15-37 (sinks compared canonically)."""

    def __init__(self):
        super().__init__()
        self._canon_sinks = None

    def has_succeeded(self, s):
        if self._canon_sinks is None and s.sinks:
            from ..kmer import revcomp
            self._canon_sinks = {min(x, revcomp(x)) for x in s.sinks}
        return bool(self._canon_sinks) and s.vertex.canonical in self._canon_sinks

    def has_failed(self, s):
        return s.junction_depth >= 5 or s.num_adjacent_edges == 0 or s.reached_max_branch_length


class TipBeginningStopper(StoppingRule):
    """TipBeginningStopper.java:7-35."""

    def has_succeeded(self, s):
        return s.joining_has_coverage()

    def has_failed(self, s):
        no_in = any(s.in_degree(c) == 0 for c in s.traversal_colors)
        no_out = any(s.out_degree(c) == 0 for c in s.traversal_colors)
        return no_in or no_out


class TipEndStopper(StoppingRule):
    """TipEndStopper.java:7-33."""

    def has_succeeded(self, s):
        no_in = any(s.in_degree(c) == 0 for c in s.traversal_colors)
        no_out = any(s.out_degree(c) == 0 for c in s.traversal_colors)
        return no_in or no_out

    def has_failed(self, s):
        return s.joining_has_coverage()


class VisualizationStopper(StoppingRule):
    """VisualizationStopper.java:11-21."""

    def has_succeeded(self, s):
        return s.num_adjacent_edges == 0 or s.junction_depth > 2 or s.branch_size > 500

    def has_failed(self, s):
        return False
