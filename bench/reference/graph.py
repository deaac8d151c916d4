"""The structure of a graph index, plain PyTorch.

An adjacency (N, R) of int32 ids, -1 for an empty slot, and an entry node.
A row is sound when every id lies in [-1, N), no id is the row's own node,
no id appears twice in it, and it holds at least one neighbour; the entry
lies in [0, N).
"""
from __future__ import annotations

import torch

ROWS_PER_BLOCK = 1 << 18


def bad_entries(adj: torch.Tensor, entry: int, degree: int) -> int:
    """Count of unsound slots and rows: ids out of range, self loops,
    repeats within a row, empty rows, a wrong width (every row) and an
    entry outside the graph (one)."""
    n = adj.shape[0]
    bad = 0 if 0 <= entry < n else 1
    if adj.dim() != 2 or adj.shape[1] != degree:
        return bad + n
    for s in range(0, n, ROWS_PER_BLOCK):
        blk = adj[s:s + ROWS_PER_BLOCK].long()
        own = torch.arange(s, s + blk.shape[0], device=blk.device)[:, None]
        valid = blk >= 0
        bad += int(((blk < -1) | (blk >= n)).sum())
        bad += int((blk == own).sum())
        srt = torch.sort(torch.where(valid, blk, -1), dim=1).values
        bad += int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum())
        bad += int((~valid.any(1)).sum())
    return bad
