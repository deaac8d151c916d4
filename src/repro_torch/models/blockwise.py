"""Blockwise (memory-linear) causal attention in plain PyTorch (port of
:mod:`repro.models.blockwise`).

An online-softmax loop over key/value chunks with every query chunk as a
batched dim, so peak memory is O(S * chunk_k) per head group rather than
O(S^2).  The reference computes it outside any Pallas kernel, and so does
the port: the chunking and the float32 softmax mirror the reference's
default (batched-q) implementation.
"""
from __future__ import annotations

import torch


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, chunk_q: int = 256, chunk_k: int = 1024,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hkv, G, d); k, v: (B, S, Hkv, d) -> (B, S, Hkv, G, d_v).

    GQA group dim G folded in q; softmax in float32; output in q's dtype.
    S must be a multiple of both chunks.
    """
    b, s, hkv, g, d = q.shape
    dv = v.shape[-1]
    if s % chunk_q or s % chunk_k:
        raise ValueError(f"sequence {s} is not a multiple of the chunks "
                         f"({chunk_q}, {chunk_k})")
    nq, nk = s // chunk_q, s // chunk_k
    scale = d ** -0.5
    dev = q.device
    qc = q.reshape(b, nq, chunk_q, hkv, g, d).float()
    kc = k.reshape(b, nk, chunk_k, hkv, d)
    vc = v.reshape(b, nk, chunk_k, hkv, dv)
    q_pos = torch.arange(s, device=dev).reshape(nq, chunk_q)
    k_pos = torch.arange(s, device=dev).reshape(nk, chunk_k)

    acc = torch.zeros((b, nq, chunk_q, hkv, g, dv), dtype=torch.float32,
                      device=dev)
    m = torch.full((b, nq, chunk_q, hkv, g), -torch.inf, device=dev)
    l = torch.zeros((b, nq, chunk_q, hkv, g), device=dev)
    for kj in range(nk):
        logits = torch.einsum("bnqhgd,bkhd->bnqhgk", qc,
                              kc[:, kj].float()) * scale
        if causal:
            mask = q_pos[:, :, None] >= k_pos[kj][None, None, :]
            logits = logits.masked_fill(~mask[None, :, :, None, None, :],
                                        -torch.inf)
        m_new = torch.maximum(m, logits.amax(-1))
        safe_m = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(logits - safe_m[..., None])
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                           torch.zeros_like(m))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bnqhgk,bkhd->bnqhgd", p, vc[:, kj].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, s, hkv, g, dv).to(q.dtype)
