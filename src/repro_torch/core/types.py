"""Index datastructures shared across builders, searchers and the tiers."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GraphIndex:
    """A built proximity-graph index (tensors on one device).

    Attributes:
      adj:   (N, R) int32 out-neighbour lists, -1 padded.
      entry: scalar int32 entry point (medoid).
      alpha: (N,) float32 per-node pruning parameter used at build time.
      lid:   (N,) float32 LID estimates from calibration (zeros when not
             calibrated, e.g. Vamana).
      mu, sigma: scalar float32 population LID statistics (Eq. 7).
    """

    adj: torch.Tensor
    entry: torch.Tensor
    alpha: torch.Tensor
    lid: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.adj.device

    @property
    def degree_cap(self) -> int:
        return self.adj.shape[1]

    def out_degrees(self) -> torch.Tensor:
        return (self.adj != -1).sum(1)
