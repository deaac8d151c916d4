"""Adaptive robust pruning — the dynamic occlusion criterion (port of
:mod:`repro.core.prune`).

An edge (u, v) is pruned when a previously selected witness w satisfies
alpha(u)^2 * d2(w, v) <= d2(u, v) (squared-L2 form of alpha * d <= d).
The selection is sequential in candidate rank; it runs as a Python loop over
the candidate positions, vectorised over the node batch.  Plain PyTorch: the
reference has no kernel for it.
"""
from __future__ import annotations

import torch

INVALID = -1


def _dedup_mask(ids: torch.Tensor) -> torch.Tensor:
    """(B, C): True for the first occurrence of each id along a row."""
    c = ids.shape[1]
    same = ids[:, None, :] == ids[:, :, None]            # [b, i, j]
    earlier = torch.ones((c, c), dtype=torch.bool, device=ids.device).tril(-1)
    return ~(same & earlier).any(-1)


def robust_prune_one(cand_ids, cand_d2, cand_pd2, alpha, degree: int):
    """Prune each row's candidate pool to <= ``degree`` neighbours.

    Args (batched over B nodes):
      cand_ids: (B, C) candidate ids, INVALID-padded, duplicates allowed.
      cand_d2:  (B, C) squared distance of each candidate to its node
        (inf for invalid entries).
      cand_pd2: (B, C, C) pairwise squared distances among candidates.
      alpha:    (B,) pruning parameter alpha(u) >= 1 (on true distances).
    Returns:
      (nbr_ids (B, degree) int32, nbr_d2 (B, degree)), ascending, INVALID/inf
      padded.
    """
    b, c = cand_ids.shape
    dev = cand_ids.device
    valid = (cand_ids != INVALID) & torch.isfinite(cand_d2)
    order = torch.argsort(torch.where(valid, cand_d2, torch.inf), dim=1,
                          stable=True)
    ids = torch.gather(cand_ids, 1, order)
    valid = torch.gather(valid, 1, order)
    d2 = torch.where(valid, torch.gather(cand_d2, 1, order), torch.inf)
    pd2 = torch.gather(cand_pd2, 1, order[:, :, None].expand(b, c, c))
    pd2 = torch.gather(pd2, 2, order[:, None, :].expand(b, c, c))
    valid = valid & _dedup_mask(ids)

    alpha_sq = (alpha * alpha)[:, None, None]
    later = torch.ones((c, c), dtype=torch.bool, device=dev).triu(1)
    # occludes[b, i, j]: once selected, candidate i prunes later candidate j.
    occludes = later & (alpha_sq * pd2 <= d2[:, None, :])
    pruned = torch.zeros((b, c), dtype=torch.bool, device=dev)
    selected = torch.zeros((b, c), dtype=torch.bool, device=dev)
    count = torch.zeros((b,), dtype=torch.int32, device=dev)
    for i in range(c):
        active = valid[:, i] & (~pruned[:, i]) & (count < degree)
        selected[:, i] = active
        count += active
        pruned |= active[:, None] & occludes[:, i, :]

    # Compact the selected entries (already distance-sorted) into (degree,).
    pos = torch.arange(c, device=dev).expand(b, c)
    rank = torch.where(selected, pos, c)
    take = torch.argsort(rank, dim=1, stable=True)[:, :degree]
    sel = torch.gather(selected, 1, take)
    out_ids = torch.where(sel, torch.gather(ids, 1, take), INVALID)
    out_d2 = torch.where(sel, torch.gather(d2, 1, take), torch.inf)
    return out_ids.to(torch.int32), out_d2


def robust_prune_batch(x, node_ids, cand_ids, alpha, degree: int):
    """Prune a batch of nodes' pools against the base vectors.

    Args:
      x:        (N, D) base vectors.
      node_ids: (B,) nodes being re-wired.
      cand_ids: (B, C) candidate pools (INVALID-padded, duplicates allowed).
      alpha:    (B,) per-node alpha(u).
    Returns:
      (adj_rows (B, degree) int32, adj_d2 (B, degree)).
    """
    node_ids = node_ids.long()
    cvecs = x[cand_ids.clamp_min(0).long()]              # (B, C, D)
    diff = cvecs - x[node_ids][:, None, :]
    d2 = (diff * diff).sum(-1)
    # Self-edges and invalid slots are never eligible.
    bad = (cand_ids == INVALID) | (cand_ids == node_ids[:, None])
    d2 = torch.where(bad, torch.inf, d2)
    sq = (cvecs * cvecs).sum(-1)
    pd2 = (sq[:, :, None] - 2.0 * torch.bmm(cvecs, cvecs.transpose(1, 2))
           + sq[:, None, :]).clamp_min(0.0)
    ids = torch.where(bad, INVALID, cand_ids)
    return robust_prune_one(ids, d2, pd2, alpha, degree)
