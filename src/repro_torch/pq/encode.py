"""Vector <-> PQ code transforms (port of :mod:`repro.pq.encode`)."""
from __future__ import annotations

import torch

from repro_torch.pq.codebook import PqCodebook


def pq_encode(x: torch.Tensor, book: PqCodebook,
              chunk: int = 16384) -> torch.Tensor:
    """(N, D) -> (N, M) uint8 codes: per subspace, the nearest centroid by
    |sub|^2 - 2 sub.c + |c|^2."""
    cb = book.centroids                                   # (M, K, dsub)
    m, _, dsub = cb.shape
    cn = (cb * cb).sum(-1)                                # (M, K)
    out = []
    for s in range(0, x.shape[0], chunk):
        subs = x[s:s + chunk].reshape(-1, m, dsub).permute(1, 0, 2)  # (M,c,dsub)
        d2 = ((subs * subs).sum(-1, keepdim=True)
              - 2.0 * torch.bmm(subs, cb.transpose(1, 2)) + cn[:, None, :])
        out.append(torch.argmin(d2, dim=2).T.to(torch.uint8))
    if not out:
        return torch.empty((0, m), dtype=torch.uint8, device=x.device)
    return torch.cat(out)


def pq_decode(codes: torch.Tensor, book: PqCodebook) -> torch.Tensor:
    """(N, M) codes -> (N, D) reconstructed vectors (each subspace's
    codebook centroid)."""
    cb = book.centroids                                   # (M, K, dsub)
    m = cb.shape[0]
    sub = torch.arange(m, device=cb.device)[None, :]
    return cb[sub, codes.long()].reshape(codes.shape[0], -1)
