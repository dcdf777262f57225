"""Pose-graph operations on host-side dict-of-sets graphs (port of
neural_graph_mapping_tpu.mapping.graph; plain Python, unchanged).

Rebuild of the reference ``src/neural_graph_mapping/graph.py``. The pose graph
is inherently dynamic, tiny (hundreds to low thousands of keyframes), and
consumed by host-side bookkeeping between jitted device steps — so it stays a
plain Python structure: ``{vertex: set(neighbors)}``.
"""

from __future__ import annotations

from typing import Dict, Set


Graph = Dict[int, Set[int]]


def remove_vertex(graph: Graph, vertex: int) -> Graph:
    """Return a copy of the graph without ``vertex`` or edges to it
    (reference graph.py:10-25)."""
    return {
        v: {n for n in neighbors if n != vertex}
        for v, neighbors in graph.items()
        if v != vertex
    }


def get_neighbors(
    graph: Graph,
    query_vertices: Set[int],
    max_edges: int = 1,
    include_queries: bool = False,
) -> Set[int]:
    """BFS n-hop neighborhood of a set of query vertices (graph.py:28-69).

    Args:
        graph: Must contain all query_vertices.
        query_vertices: Start set (distance 0).
        max_edges: Maximum edge distance of returned vertices.
        include_queries: Whether the queries themselves are returned.

    Returns:
        Set of vertices within ``max_edges`` hops of any query vertex.
    """
    visited: Set[int] = set()
    frontier = set(query_vertices)
    for _ in range(max_edges):
        if not frontier:
            break
        visited |= frontier
        next_frontier: Set[int] = set()
        for vertex in frontier:
            next_frontier |= graph[vertex] - visited
        frontier = next_frontier
    visited |= frontier
    if not include_queries:
        visited -= set(query_vertices)
    return visited
