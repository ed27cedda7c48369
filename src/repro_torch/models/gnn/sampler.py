"""Host-side fanout neighbor sampler (GraphSAGE-style) for minibatch_lg.

A copy of the JAX package's sampler (the port imports nothing of it):
given the same ``np.random.Generator`` state, ``sample_subgraph``
returns the same arrays.  NumPy/CSR on the host (this is data-pipeline
work, not device work): given seed nodes, sample ``fanout[0]``
neighbors per seed, then ``fanout[1]`` per frontier node, etc.  Emits a
PADDED static-shape subgraph, so every training step has the same
shapes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    """Compressed neighbor lists: indptr (N+1,), indices (nnz,)."""

    indptr: np.ndarray
    indices: np.ndarray

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray,
                   n_nodes: int) -> "CSRGraph":
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        counts = np.bincount(src_s, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return cls(indptr.astype(np.int64), dst_s.astype(np.int32))

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


@dataclass
class SampledSubgraph:
    """Padded static-shape subgraph (device-ready)."""

    nodes: np.ndarray  # (max_nodes,) global node ids (0-padded)
    node_mask: np.ndarray  # (max_nodes,) 1.0 = real
    src: np.ndarray  # (max_edges,) LOCAL indices into `nodes`
    dst: np.ndarray  # (max_edges,)
    edge_mask: np.ndarray  # (max_edges,)
    seeds_local: np.ndarray  # (n_seeds,) local indices of the seed nodes


def sample_subgraph(graph: CSRGraph, seeds: np.ndarray, fanout: tuple,
                    rng: np.random.Generator, *, max_nodes: int,
                    max_edges: int) -> SampledSubgraph:
    """Fanout sampling with replacement-free caps; pads to static shapes.

    Budget overflow is handled by truncation (counts toward straggler
    mitigation: every step costs the same regardless of local degree).
    """
    local_of = {int(s): i for i, s in enumerate(seeds)}
    nodes = list(map(int, seeds))
    edges_src, edges_dst = [], []
    frontier = list(map(int, seeds))
    for f in fanout:
        nxt = []
        for v in frontier:
            nb = graph.neighbors(v)
            if len(nb) == 0:
                continue
            take = nb if len(nb) <= f else rng.choice(nb, size=f, replace=False)
            for u in map(int, take):
                if u not in local_of:
                    if len(nodes) >= max_nodes:
                        continue
                    local_of[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                if len(edges_src) < max_edges:
                    # message flows neighbor -> center
                    edges_src.append(local_of[u])
                    edges_dst.append(local_of[v])
        frontier = nxt
        if not frontier:
            break

    n, e = len(nodes), len(edges_src)
    out_nodes = np.zeros(max_nodes, np.int64)
    out_nodes[:n] = nodes
    node_mask = np.zeros(max_nodes, np.float32)
    node_mask[:n] = 1.0
    src = np.zeros(max_edges, np.int32)
    dst = np.zeros(max_edges, np.int32)
    emask = np.zeros(max_edges, np.float32)
    src[:e], dst[:e], emask[:e] = edges_src, edges_dst, 1.0
    return SampledSubgraph(out_nodes, node_mask, src, dst, emask,
                           np.arange(len(seeds), dtype=np.int32))


def budget_for(n_seeds: int, fanout: tuple) -> tuple[int, int]:
    """Static (max_nodes, max_edges) for a fanout spec."""
    nodes, layer, edges = n_seeds, n_seeds, 0
    for f in fanout:
        layer = layer * f
        nodes += layer
        edges += layer
    return nodes, edges
