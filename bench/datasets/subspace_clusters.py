"""Gaussian subspace clusters: points on ``n_clusters`` random
``d_intrinsic``-dimensional affine subspaces in ``d`` dimensions plus
isotropic noise, so the local intrinsic dimension is about ``d_intrinsic``
(a copy of ``data/synthetic.py::gaussian_subspace_clusters``, as its
``_sift_like`` and ``_glove_like`` call it).  ``unit_norm`` scales every
point to unit length (angular data served as L2).

Base rows and queries come from one draw, shuffled and split, so the
queries lie on the base set's manifolds.  Every draw is made on the device
from one ``torch.Generator`` seeded with the configuration's ``seed``, in a
few large calls.
"""
from __future__ import annotations

import torch


def generate(data: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(base (n, d), queries (queries, d)), float32 on ``device``."""
    n, d, nq = int(data["n"]), int(data["d"]), int(data["queries"])
    di, nc = int(data["d_intrinsic"]), int(data["n_clusters"])
    total = n + nq
    g = torch.Generator(device=device).manual_seed(int(data["seed"]))
    per = total // nc + 1
    basis = torch.randn((nc, d, di), generator=g, device=device)
    basis = basis / torch.linalg.norm(basis, dim=1, keepdim=True)
    centers = torch.randn((nc, d), generator=g, device=device) * float(
        data["center_scale"])
    coeff = torch.randn((nc, per, di), generator=g, device=device)
    pts = torch.einsum("cdi,cpi->cpd", basis, coeff) + centers[:, None, :]
    pts = pts.reshape(-1, d)[:total]
    pts = pts + float(data["noise"]) * torch.randn(
        pts.shape, generator=g, device=device)
    if data.get("unit_norm", False):
        pts = pts / (torch.linalg.norm(pts, dim=1, keepdim=True) + 1e-9)
    pts = pts[torch.randperm(total, generator=g, device=device)]
    return pts[:n].contiguous(), pts[n:].contiguous()
