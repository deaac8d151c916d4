"""Graph attention network (GAT, arXiv:1710.10903) on gathers and
segment reductions, and the fanout neighbour sampler of the minibatch
shape (port of :mod:`repro.models.gnn`).

Message passing is edge-index gathers plus scatter reductions
(``index_add`` for the sums, ``scatter_reduce("amax")`` for the max).
Edge arrays are padded to a static E_max with the sentinel ``n_nodes``
(src = dst = n_nodes): those edges land in a ghost segment that is sliced
off.  The reference gathers node rows at a padded edge's ``n_nodes``, one
past the last row, and JAX clamps that index to the last row; the port
clamps it explicitly (torch would raise on the CPU and assert on the
card).  The ghost segment's messages never reach an output either way.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, init_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GatConfig:
    d_in: int
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    n_layers: int = 2
    negative_slope: float = 0.2


def _layer_shape(cfg: GatConfig, li: int) -> tuple[int, int, bool]:
    """(heads, d_out, last) of layer ``li``."""
    last = li == cfg.n_layers - 1
    return (1 if last else cfg.n_heads,
            cfg.n_classes if last else cfg.d_hidden, last)


def gat_init(generator: torch.Generator | None, cfg: GatConfig, *,
             device="cuda") -> Params:
    """Hidden layers: n_heads x d_hidden (concatenated); the output layer:
    one head -> n_classes (the paper's Cora configuration).  ``layers``
    is a list with no stacked axis, as the reference's is."""
    dev = init_device(device)
    out = []
    d_prev = cfg.d_in
    for li in range(cfg.n_layers):
        heads, d_out, last = _layer_shape(cfg, li)
        a = [torch.randn((heads, d_out), generator=generator,
                         device=dev).mul_(0.1) for _ in range(2)]
        out.append({"w": dense_init(generator, d_prev, heads * d_out,
                                    device=dev),
                    "a_src": a[0], "a_dst": a[1]})
        d_prev = d_out if last else heads * d_out
    return {"layers": out}


def _segment_sum(x: torch.Tensor, seg: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    return x.new_zeros((n_seg,) + tuple(x.shape[1:])).index_add(0, seg, x)


def _gat_layer(p: Params, x: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, n_nodes: int, heads: int, d_out: int,
               negative_slope: float, concat: bool) -> torch.Tensor:
    """One GAT layer: edge scores (SDDMM), a softmax over each node's
    incoming edges, and the weighted scatter of the messages.

    src / dst: (E,) int64 edge endpoints; padded edges carry ``n_nodes``
    and fall into the ghost segment ``n_nodes``."""
    h = (x @ p["w"]).reshape(-1, heads, d_out)                    # (N, H, F)
    alpha_src = torch.einsum("nhf,hf->nh", h, p["a_src"])
    alpha_dst = torch.einsum("nhf,hf->nh", h, p["a_dst"])
    last = n_nodes - 1
    src_row, dst_row = src.clamp(max=last), dst.clamp(max=last)   # JAX's clamp
    e = F.leaky_relu(alpha_src[src_row] + alpha_dst[dst_row], negative_slope)

    n_seg = n_nodes + 1  # the ghost segment of the padded edges
    with torch.no_grad():
        # The softmax does not depend on its shift, so the shift carries
        # no gradient.  A segment with no edge keeps the -inf identity,
        # then 0.
        e_max = e.new_full((n_seg, heads), float("-inf")).scatter_reduce(
            0, dst[:, None].expand(-1, heads), e, "amax", include_self=False)
        e_max = torch.where(torch.isfinite(e_max), e_max, 0.0)
    e_exp = torch.exp(e - e_max[dst])
    denom = _segment_sum(e_exp, dst, n_seg)
    att = e_exp / denom[dst].clamp_min(1e-9)                      # (E, H)

    msg = h[src_row] * att[:, :, None]                            # (E, H, F)
    out = _segment_sum(msg, dst, n_seg)[:n_nodes]
    if concat:
        return F.elu(out.reshape(n_nodes, heads * d_out))
    return out.mean(1)  # the output layer averages its heads


def gat_forward(cfg: GatConfig, params: Params, x: torch.Tensor,
                edge_index: torch.Tensor) -> torch.Tensor:
    """x (N, d_in); edge_index (2, E) (padded with N) -> (N, n_classes)
    logits."""
    n_nodes = x.shape[0]
    src, dst = edge_index[0].long(), edge_index[1].long()
    for li, p in enumerate(params["layers"]):
        heads, d_out, last = _layer_shape(cfg, li)
        x = _gat_layer(p, x, src, dst, n_nodes, heads, d_out,
                       cfg.negative_slope, concat=not last)
    return x


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row logsumexp minus the gold logit (labels floored at 0)."""
    gold = logits.gather(1, labels.long().clamp_min(0)[:, None])[:, 0]
    return torch.logsumexp(logits, -1) - gold


def gat_loss(cfg: GatConfig, params: Params, batch: dict):
    """batch: features (N, F), edge_index (2, E), labels (N,), mask (N,).
    The masked mean of the node cross entropy, and the masked accuracy."""
    logits = gat_forward(cfg, params, batch["features"],
                         batch["edge_index"]).float()
    labels = batch["labels"]
    mask = batch["mask"].float()
    count = mask.sum().clamp_min(1.0)
    loss = (_nll(logits, labels) * mask).sum() / count
    acc = ((logits.argmax(-1) == labels).float() * mask).sum() / count
    return loss, {"ce": loss, "acc": acc}


def gat_graph_loss(cfg: GatConfig, params: Params, batch: dict):
    """Graph-level task (the molecule shape): a block-diagonal batch of
    graphs, node logits mean-pooled per graph.

    batch: features (N, F), edge_index (2, E), graph_ids (N,) in [0, G),
    labels (G,).  A graph id outside [0, G) (a padded node) is dropped
    from the pooling, as the reference's ``segment_sum`` drops it."""
    logits_node = gat_forward(cfg, params, batch["features"],
                              batch["edge_index"])
    g = batch["labels"].shape[0]
    gid = batch["graph_ids"].long()
    gid = torch.where((gid >= 0) & (gid < g), gid, g)
    sums = _segment_sum(logits_node, gid, g + 1)[:g]
    cnts = _segment_sum(torch.ones_like(logits_node[:, 0]).float(), gid,
                        g + 1)[:g]
    logits = (sums / cnts.clamp_min(1.0)[:, None]).float()
    labels = batch["labels"]
    loss = _nll(logits, labels).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"ce": loss, "acc": acc}


# ------------------------------------------------------------- sampler (host)

class NeighborSampler:
    """Fanout neighbour sampler over a host-side CSR graph (GraphSAGE-style,
    the minibatch_lg regime: batch_nodes=1024, fanout 15-10).

    The reference's numpy sampler as it is: the same seed gives the same
    blocks.  Sampling is host work in every production GNN system (DGL /
    PyG data loaders)."""

    def __init__(self, edge_index: np.ndarray, n_nodes: int, seed: int = 0):
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")
        self.src_sorted = src[order].astype(np.int32)
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        counts = np.bincount(dst, minlength=n_nodes)
        self.indptr[1:] = np.cumsum(counts)
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)

    def sample_block(self, seed_nodes: np.ndarray, fanouts: tuple[int, ...]
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Multi-hop sample: (node_ids, edge_src_local, edge_dst_local),
        the edges indices into node_ids (seeds first)."""
        nodes = list(seed_nodes.astype(np.int64))
        node_pos = {int(n): i for i, n in enumerate(nodes)}
        edges_s, edges_d = [], []
        frontier = seed_nodes.astype(np.int64)
        for f in fanouts:
            next_frontier = []
            for u in frontier:
                lo, hi = self.indptr[u], self.indptr[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, deg)
                picks = self.rng.choice(deg, size=take, replace=False) + lo
                for e in picks:
                    v = int(self.src_sorted[e])
                    if v not in node_pos:
                        node_pos[v] = len(nodes)
                        nodes.append(v)
                        next_frontier.append(v)
                    edges_s.append(node_pos[v])
                    edges_d.append(node_pos[int(u)])
            frontier = np.asarray(next_frontier, np.int64)
        return (np.asarray(nodes, np.int32), np.asarray(edges_s, np.int32),
                np.asarray(edges_d, np.int32))


def pad_edges(src: np.ndarray, dst: np.ndarray, e_max: int,
              ghost: int) -> np.ndarray:
    """Pad an edge list to (2, e_max) with the ghost sentinel."""
    e = len(src)
    if e > e_max:
        raise ValueError(f"{e} edges do not fit in {e_max}")
    out = np.full((2, e_max), ghost, np.int32)
    out[0, :e] = src
    out[1, :e] = dst
    return out
