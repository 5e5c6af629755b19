"""K-shortest paths in a color-filtered subgraph (PathFinder.java:1-84).

The reference wraps JGraphT's KShortestPaths; here Yen's algorithm over the
Subgraph with unit edge weights (all reference edges carry weight 1.0).
"""

from __future__ import annotations

from collections import deque

from .subgraph import Subgraph, Vertex


def shortest_path(g: Subgraph, source: Vertex, sink: Vertex, color=None,
                  banned_nodes=frozenset(), banned_edges=frozenset()):
    """BFS shortest path as a vertex list, or None."""
    if source == sink:
        return [source]
    prev = {source: None}
    dq = deque([source])
    while dq:
        u = dq.popleft()
        for v, c in g.out_edges(u):
            if color is not None and c != color:
                continue
            if v in prev or v in banned_nodes or (u, v) in banned_edges:
                continue
            prev[v] = u
            if v == sink:
                path = [v]
                while prev[path[-1]] is not None:
                    path.append(prev[path[-1]])
                return list(reversed(path))
            dq.append(v)
    return None


class PathFinder:
    def __init__(self, graph: Subgraph, color=None):
        self.g = graph
        self.color = color

    def get_paths(self, source: Vertex, sink: Vertex, k: int = 10) -> list:
        """Up to k loopless shortest paths (Yen's algorithm), shortest first."""
        first = shortest_path(self.g, source, sink, self.color)
        if first is None:
            return []
        paths = [first]
        candidates: list = []
        while len(paths) < k:
            prev_path = paths[-1]
            for i in range(len(prev_path) - 1):
                spur = prev_path[i]
                root = prev_path[:i + 1]
                banned_edges = set()
                for p in paths:
                    if p[:i + 1] == root and len(p) > i + 1:
                        banned_edges.add((p[i], p[i + 1]))
                banned_nodes = set(root[:-1])
                spur_path = shortest_path(self.g, spur, sink, self.color,
                                          frozenset(banned_nodes),
                                          frozenset(banned_edges))
                if spur_path is not None:
                    total = root[:-1] + spur_path
                    if total not in candidates and total not in paths:
                        candidates.append(total)
            if not candidates:
                break
            candidates.sort(key=len)
            paths.append(candidates.pop(0))
        return paths
