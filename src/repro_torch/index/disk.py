"""Two-tier disk-resident index model, in-memory half (port of
:mod:`repro.index.disk`).

  fast tier : PQ codes (N, M) uint8 + adjacency (N, R) int32 on the card
  slow tier : full-precision vectors (N, D) float32 — here device-memory rows
              (:class:`InMemorySlowTier`); the block store, hot tier and the
              out-of-core walk are later slices of the port.

Every node expansion counts as one slow-tier read (the per-query hop counter
of :class:`repro_torch.core.search.SearchStats`); :class:`DiskTierModel`
turns counted reads into modelled latency.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import search as search_mod
from repro_torch.core.types import GraphIndex
from repro_torch.pq import PqCodebook, build_lut, pq_encode, train_pq


@dataclasses.dataclass(frozen=True)
class DiskTierModel:
    """Latency model for the slow tier (defaults: the paper's SATA SSD,
    ~90 us per random 4K read, queue depth 8)."""

    read_latency_us: float = 90.0
    queue_depth: int = 8

    def latency_us(self, reads, rerank_reads=0, *, overlapped: bool = False):
        """Modelled time of ``reads`` dependent expansions plus a rerank
        batch of ``rerank_reads`` independent fetches, issued queue_depth at
        a time; ``overlapped`` models the staged engine (max, not sum)."""
        serial = torch.as_tensor(reads, dtype=torch.float32) * self.read_latency_us
        rounds = torch.ceil(torch.as_tensor(rerank_reads, dtype=torch.float32)
                            / max(self.queue_depth, 1))
        rerank_time = rounds * self.read_latency_us
        if overlapped:
            return torch.maximum(serial, rerank_time)
        return serial + rerank_time


@dataclasses.dataclass(frozen=True)
class TieredIndex:
    """A disk-resident MCGI/Vamana index: graph + PQ fast tier + slow tier."""

    graph: GraphIndex
    codebook: PqCodebook
    codes: torch.Tensor     # (N, M) uint8 — fast tier
    vectors: torch.Tensor   # (N, D) float32 — slow tier rows

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def fast_tier_bytes(self) -> int:
        return (self.codes.numel() + self.graph.adj.numel() * 4
                + self.codebook.centroids.numel() * 4)

    def slow_tier_bytes(self) -> int:
        return self.vectors.numel() * 4


def build_tiered_index(x, graph: GraphIndex, m_pq: int = 16, seed: int = 0,
                       *, device="cuda") -> TieredIndex:
    """Train PQ (the PQ view zero-pads D to a multiple of ``m_pq``; L2 over
    zero dims is unchanged) and encode the fast tier; the slow tier keeps
    ``x``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    pad = (-x.shape[1]) % m_pq
    x_pq = F.pad(x, (0, pad)) if pad else x
    book = train_pq(x_pq, m=m_pq, seed=seed)
    return TieredIndex(graph=graph, codebook=book, codes=pq_encode(x_pq, book),
                       vectors=x)


def _query_luts(index: TieredIndex, queries: torch.Tensor) -> torch.Tensor:
    """Per-query ADC LUTs, zero-padding queries to the PQ-padded dim."""
    d_book = index.codebook.m * index.codebook.dsub
    if queries.shape[1] < d_book:
        queries = F.pad(queries, (0, d_book - queries.shape[1]))
    return build_lut(queries, index.codebook.centroids)


def search_tiered(index: TieredIndex, queries, beam_width: int, k: int = 10,
                  max_hops: int = 2048, rerank: bool = True, excl=None):
    """PQ-routed beam search with slow-tier rerank (the deployed path)."""
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=index.device)
    luts = _query_luts(index, queries)
    return search_mod.beam_search_pq(
        index.codes, luts, index.vectors, index.graph.adj, queries,
        index.graph.entry, beam_width=beam_width, max_hops=max_hops, k=k,
        rerank=rerank, excl=excl)


def search_tiered_adaptive(index: TieredIndex, queries,
                           budget_cfg: search_mod.AdaptiveBeamBudget,
                           k: int = 10, rerank: bool = True,
                           num_buckets: int | None = None, excl=None):
    """Per-query adaptive-beam serving path over one tiered index."""
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=index.device)
    luts = _query_luts(index, queries)
    return search_mod.beam_search_pq_adaptive(
        index.codes, luts, index.vectors, index.graph.adj, queries,
        index.graph.entry, budget_cfg=budget_cfg, k=k, rerank=rerank,
        num_buckets=num_buckets, excl=excl)


class InMemorySlowTier:
    """The slow tier as full-precision rows in (device) memory."""

    is_disk = False

    def __init__(self, vectors: torch.Tensor):
        self.vectors = vectors

    def fetch_beams(self, beam_ids: torch.Tensor) -> torch.Tensor:
        """(Q, L) ids -> (Q, L, D) rows; INVALID lanes clamp to node 0 (the
        rerank masks their distances)."""
        return self.vectors[beam_ids.clamp_min(0).long()]
