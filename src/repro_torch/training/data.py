"""Synthetic data pipelines, one per architecture family (port of
:mod:`repro.training.data`).

Deterministic, seeded, host-side generators: the same numpy draws as the
reference's, handed over as tensors on the device each pipeline is given
(the card by default).  LM batches follow a Zipfian unigram over the
vocab (so losses move like text, not like uniform noise); recsys batches
draw power-law item popularity; the GNN data is a homophilous graph.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device


def _zipf_ids(rng: np.random.Generator, shape, vocab: int, a: float = 1.1):
    # numpy's zipf + modulo keeps the tail bounded and the draw fast.
    raw = rng.zipf(a, size=shape)
    return (raw % vocab).astype(np.int32)


def _to(dev: torch.device, **arrays) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


@dataclasses.dataclass
class LmBatches:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    device: str = "cuda"

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        dev = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        while True:
            toks = _zipf_ids(rng, (self.batch, self.seq + 1), self.vocab)
            yield _to(dev, tokens=toks[:, :-1], labels=toks[:, 1:])


@dataclasses.dataclass
class DlrmBatches:
    vocab_sizes: tuple[int, ...]
    n_dense: int
    batch: int
    seed: int = 0
    device: str = "cuda"

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        dev = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        while True:
            dense = rng.normal(size=(self.batch, self.n_dense)).astype(
                np.float32)
            sparse = np.stack(
                [_zipf_ids(rng, (self.batch,), v) for v in self.vocab_sizes],
                axis=1)
            # Click-ish labels correlated with a random linear readout.
            w = rng.normal(size=(self.n_dense,))
            p = 1.0 / (1.0 + np.exp(-(dense @ w) * 0.5))
            labels = (rng.uniform(size=self.batch) < p).astype(np.float32)
            yield _to(dev, dense=dense, sparse=sparse, labels=labels)


@dataclasses.dataclass
class SeqRecBatches:
    """Shared by MIND (hist/target) and BERT4Rec (cloze)."""

    n_items: int
    batch: int
    seq: int
    n_mask: int = 20
    seed: int = 0
    device: str = "cuda"

    def mind_iter(self) -> Iterator[dict[str, torch.Tensor]]:
        dev = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        while True:
            hist = _zipf_ids(rng, (self.batch, self.seq), self.n_items)
            lens = rng.integers(self.seq // 2, self.seq + 1, size=self.batch)
            mask = np.arange(self.seq)[None, :] < lens[:, None]
            target = _zipf_ids(rng, (self.batch,), self.n_items)
            yield _to(dev, hist=hist, hist_mask=mask, target=target)

    def bert4rec_iter(self, mask_token: int
                      ) -> Iterator[dict[str, torch.Tensor]]:
        dev = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        while True:
            seq = _zipf_ids(rng, (self.batch, self.seq), self.n_items)
            pos = np.stack(
                [rng.choice(self.seq, size=self.n_mask, replace=False)
                 for _ in range(self.batch)]).astype(np.int32)
            labels = np.take_along_axis(seq, pos, axis=1)
            masked = seq.copy()
            np.put_along_axis(masked, pos, mask_token, axis=1)
            yield _to(dev, seq=masked,
                      seq_mask=np.ones((self.batch, self.seq), bool),
                      mlm_positions=pos, mlm_labels=labels)


def random_graph_data(n_nodes: int, n_edges: int, d_feat: int,
                      n_classes: int, seed: int = 0):
    """Synthetic homophilous graph: community-structured edges and
    class-correlated features (so a GNN can learn).  Returns numpy arrays
    (feats (N, d) float32, edges (2, E) int32, labels (N,) int32, train
    mask (N,) bool), the reference's."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + rng.normal(size=(n_nodes, d_feat)).astype(
        np.float32)
    # 80% intra-class edges, 20% random.
    n_intra = int(0.8 * n_edges)
    by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    srcs, dsts = [], []
    cls = rng.integers(0, n_classes, size=n_intra)
    for c in range(n_classes):
        members = by_class[c]
        cnt = int((cls == c).sum())
        if len(members) < 2 or cnt == 0:
            continue
        srcs.append(rng.choice(members, size=cnt))
        dsts.append(rng.choice(members, size=cnt))
    srcs.append(rng.integers(0, n_nodes,
                             size=n_edges - sum(len(s) for s in srcs)))
    dsts.append(rng.integers(0, n_nodes,
                             size=n_edges - sum(len(d) for d in dsts)))
    src = np.concatenate(srcs)[:n_edges]
    dst = np.concatenate(dsts)[:n_edges]
    mask = rng.uniform(size=n_nodes) < 0.5  # train mask
    return feats, np.stack([src, dst]).astype(np.int32), labels, mask
