"""The mapping function Phi: LID -> pruning parameter alpha (paper §3.2),
and the routing-side budget law of Prop. 4.2 (port of
:mod:`repro.core.mapping`).

    z(u)   = (LID(u) - mu) / sigma                            (Eq. 7)
    Phi(u) = alpha_min + (alpha_max - alpha_min) / (1 + e^z)   (Eq. 8)
"""
from __future__ import annotations

import dataclasses
import numbers

import torch

from repro_torch import resolve_device

ALPHA_MIN = 1.0
ALPHA_MAX = 1.5


def phi(lid: torch.Tensor, mu, sigma, alpha_min: float = ALPHA_MIN,
        alpha_max: float = ALPHA_MAX) -> torch.Tensor:
    """Eq. 8, vectorised over ``lid``; sigma is clamped away from zero."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=lid.device)
    z = (lid - mu) / sigma.clamp_min(1e-6)
    z = z.clamp(-40.0, 40.0)   # exp(+-40) already saturates the logistic
    return alpha_min + (alpha_max - alpha_min) / (1.0 + torch.exp(z))


@dataclasses.dataclass(frozen=True)
class AlphaMapping:
    """Frozen Phi parameters: population stats + operational range."""

    mu: torch.Tensor
    sigma: torch.Tensor
    alpha_min: float = ALPHA_MIN
    alpha_max: float = ALPHA_MAX

    def __call__(self, lid: torch.Tensor) -> torch.Tensor:
        return phi(lid, self.mu, self.sigma, self.alpha_min, self.alpha_max)


def constant_alpha(n: int, alpha: float, device="cuda") -> torch.Tensor:
    """Static per-node alpha — the DiskANN/Vamana baseline."""
    return torch.full((n,), alpha, dtype=torch.float32,
                      device=resolve_device(device))


def _f32(v, device) -> torch.Tensor:
    """A float32 tensor on ``device``; a number is filled there (no
    host-to-device copy, which would wait for the stream)."""
    if isinstance(v, numbers.Real):
        return torch.full((), v, dtype=torch.float32, device=device)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def adaptive_beam_budget(lid: torch.Tensor, lam, l_min, l_max: int,
                         mu=None) -> torch.Tensor:
    """Prop. 4.2's budget L(q) = C * exp(lam * (LID(q) - center)), normalised
    so an average query gets sqrt(l_min * l_max), rounded half to even,
    clipped to [l_min, l_max].  (Q,) int32.  ``lam`` and ``l_min`` may be
    0-dim tensors (a shard's calibrated law, float32 and int32)."""
    center = lid.mean() if mu is None else mu
    lo, hi = _f32(l_min, lid.device), _f32(l_max, lid.device)
    budget = torch.sqrt(lo * hi) * torch.exp(lam * (lid - center))
    return torch.clamp(torch.round(budget), lo, hi).to(torch.int32)
