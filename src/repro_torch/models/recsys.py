"""The four recsys architectures (port of :mod:`repro.models.recsys`).

  * DLRM (MLPerf config, arXiv:1906.00091): dense MLP + 26 fused embedding
    tables + dot interaction + top MLP.
  * DeepFM (arXiv:1703.04247): first-order + FM second-order + deep MLP.
  * MIND (arXiv:1904.08030): multi-interest capsule routing retrieval.
  * BERT4Rec (arXiv:1904.06690): bidirectional transformer, cloze training.

Every model has a loss (``*_loss(cfg, params, batch)``) for train_batch, a
forward for serve_p99 / serve_bulk, and ``*_retrieval`` for retrieval_cand
(one user against C candidates, scored in one call over all C, as the
reference scores them).  Parameters are plain dicts of tensors; init
functions draw from a ``torch.Generator`` on ``device`` (the card by
default).  Float32 throughout, at the reference's rounding points.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.embedding import (
    FusedTableSpec,
    fused_lookup,
    fused_table_init,
    pad_rows,
)
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init

Params = dict[str, Any]


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy in float32, the reference's formula:
    max(x, 0) - x y + log1p(exp(-|x|))."""
    x, y = logits.float(), labels.float()
    return (x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()


def _with_field0(rows: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """(1, F) ids broadcast over the C candidates, field 0 replaced by
    them: (C, F)."""
    out = rows.expand(cands.shape[0], rows.shape[1]).clone()
    out[:, 0] = cands
    return out


# ------------------------------------------------------------------- DLRM

# Criteo-1TB per-field cardinalities used by the MLPerf DLRM benchmark.
CRITEO_1TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


@dataclasses.dataclass(frozen=True)
class DlrmConfig:
    n_dense: int = 13
    vocab_sizes: tuple[int, ...] = CRITEO_1TB_VOCABS
    embed_dim: int = 128
    bot_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)

    @property
    def table(self) -> FusedTableSpec:
        return FusedTableSpec(self.vocab_sizes, self.embed_dim)

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


def dlrm_init(generator: torch.Generator | None, cfg: DlrmConfig, *,
              device="cuda") -> Params:
    kw = dict(device=device)
    return {
        "table": fused_table_init(generator, cfg.table, **kw),
        "bot": mlp_init(generator, (cfg.n_dense,) + cfg.bot_mlp, **kw),
        "top": mlp_init(generator,
                        (cfg.n_interact + cfg.bot_mlp[-1],) + cfg.top_mlp,
                        **kw),
    }


def _dot_interaction(vecs: torch.Tensor) -> torch.Tensor:
    """(B, F, D) -> (B, F(F-1)/2): the strictly-lower-triangle pairwise
    dots in row-major order (``torch.tril_indices(f, f, -1)`` is
    ``jnp.tril_indices(f, k=-1)``'s order)."""
    f = vecs.shape[1]
    gram = torch.einsum("bfd,bgd->bfg", vecs, vecs)
    ii, jj = torch.tril_indices(f, f, -1, device=vecs.device)
    return gram[:, ii, jj]


def dlrm_forward(cfg: DlrmConfig, p: Params, dense: torch.Tensor,
                 sparse: torch.Tensor) -> torch.Tensor:
    """dense (B, 13) float32, sparse (B, 26) ids -> (B,) logits.  The
    (B, 26, D) lookup is dropped once concatenated, so retrieval's 1M rows
    hold one copy of it, not two."""
    z = mlp_apply(p["bot"], dense, final_act=True)                # (B, D)
    vecs = torch.cat([z[:, None, :],
                      fused_lookup(p["table"], cfg.table, sparse)], 1)
    inter = _dot_interaction(vecs)
    del vecs
    return mlp_apply(p["top"], torch.cat([z, inter], 1))[:, 0]


def dlrm_loss(cfg: DlrmConfig, p: Params, batch: dict):
    logits = dlrm_forward(cfg, p, batch["dense"], batch["sparse"])
    loss = bce_with_logits(logits, batch["labels"])
    return loss, {"bce": loss}


def dlrm_retrieval(cfg: DlrmConfig, p: Params, batch: dict) -> torch.Tensor:
    """retrieval_cand: one user (dense (1, 13), sparse (1, 26)), the (C,)
    candidate ids written into sparse field 0; every candidate scored by
    the full model: (C,)."""
    cands = batch["candidates"]
    sparse = _with_field0(batch["sparse"], cands)
    dense = batch["dense"].expand(cands.shape[0], cfg.n_dense)
    return dlrm_forward(cfg, p, dense, sparse)


# ----------------------------------------------------------------- DeepFM

@dataclasses.dataclass(frozen=True)
class DeepFmConfig:
    n_fields: int = 39
    vocab_per_field: int = 871264    # ~34M total / 39 fields (Criteo-scale)
    embed_dim: int = 10
    mlp: tuple[int, ...] = (400, 400, 400)

    @property
    def table(self) -> FusedTableSpec:
        return FusedTableSpec((self.vocab_per_field,) * self.n_fields,
                              self.embed_dim)


def _first_order_spec(cfg: DeepFmConfig) -> FusedTableSpec:
    return FusedTableSpec(cfg.table.vocab_sizes, 1)


def deepfm_init(generator: torch.Generator | None, cfg: DeepFmConfig, *,
                device="cuda") -> Params:
    dev = layers.init_device(device)
    return {
        "table": fused_table_init(generator, cfg.table, device=dev),
        "first_order": fused_table_init(generator, _first_order_spec(cfg),
                                        device=dev),
        "b0": torch.zeros((), dtype=torch.float32, device=dev),
        "mlp": mlp_init(generator,
                        (cfg.n_fields * cfg.embed_dim,) + cfg.mlp + (1,),
                        device=dev),
    }


def deepfm_forward(cfg: DeepFmConfig, p: Params,
                   sparse: torch.Tensor) -> torch.Tensor:
    """sparse (B, F) ids -> (B,) logits: b0 + first order + FM second
    order (1/2 ((sum v)^2 - sum v^2), summed over dim) + deep MLP."""
    emb = fused_lookup(p["table"], cfg.table, sparse)             # (B, F, D)
    s = emb.sum(1)
    fm2 = 0.5 * (s * s - (emb * emb).sum(1)).sum(-1)
    first = fused_lookup(p["first_order"], _first_order_spec(cfg),
                         sparse)[..., 0].sum(1)
    deep = mlp_apply(p["mlp"], emb.reshape(emb.shape[0], -1))[:, 0]
    return p["b0"] + first + fm2 + deep


def deepfm_loss(cfg: DeepFmConfig, p: Params, batch: dict):
    logits = deepfm_forward(cfg, p, batch["sparse"])
    loss = bce_with_logits(logits, batch["labels"])
    return loss, {"bce": loss}


def deepfm_retrieval(cfg: DeepFmConfig, p: Params,
                     batch: dict) -> torch.Tensor:
    return deepfm_forward(cfg, p, _with_field0(batch["sparse"],
                                               batch["candidates"]))


# ------------------------------------------------------------------- MIND

@dataclasses.dataclass(frozen=True)
class MindConfig:
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    pow_p: float = 2.0           # label-aware attention sharpness


def mind_init(generator: torch.Generator | None, cfg: MindConfig, *,
              device="cuda") -> Params:
    return {
        "items": layers.embed_init(generator, pad_rows(cfg.n_items),
                                   cfg.embed_dim, device=device),
        # The shared bilinear map.
        "s": dense_init(generator, cfg.embed_dim, cfg.embed_dim,
                        device=device),
    }


def _squash(u: torch.Tensor) -> torch.Tensor:
    n2 = (u * u).sum(-1, keepdim=True)
    return (n2 / (1.0 + n2)) * u / torch.sqrt(n2 + 1e-9)


def mind_interests(cfg: MindConfig, p: Params, hist: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """B2I dynamic routing: (B, L) history -> (B, K, D) interest capsules.
    The routing logits start from the shared ``linspace(-1, 1, K)``; the
    iterations are unrolled, as the reference unrolls them."""
    e_hat = p["items"][hist.long()] @ p["s"]                      # (B, L, D)
    b, l, _ = e_hat.shape
    k = cfg.n_interests
    logits = torch.linspace(-1.0, 1.0, k, device=e_hat.device)
    logits = logits[None, None, :].expand(b, l, k)
    keep = mask[..., None].to(e_hat.dtype)
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(logits, dim=-1) * keep      # over capsules
        u = _squash(torch.einsum("blk,bld->bkd", w, e_hat))
        logits = logits + torch.einsum("bkd,bld->blk", u, e_hat)
    return u


def mind_loss(cfg: MindConfig, p: Params, batch: dict):
    """Sampled softmax with in-batch negatives; label-aware attention."""
    interests = mind_interests(cfg, p, batch["hist"], batch["hist_mask"])
    tgt = p["items"][batch["target"].long()]                      # (B, D)
    att = torch.softmax(
        cfg.pow_p * torch.einsum("bkd,bd->bk", interests, tgt), dim=-1)
    user = torch.einsum("bk,bkd->bd", att, interests)
    logits = user @ tgt.T                                          # (B, B)
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = layers.cross_entropy(logits, labels)
    return loss, {"sampled_ce": loss}


def mind_retrieval(cfg: MindConfig, p: Params, batch: dict) -> torch.Tensor:
    """Max-over-interests dot scores of the (C,) candidates: (B, C)."""
    interests = mind_interests(cfg, p, batch["hist"], batch["hist_mask"])
    cand = p["items"][batch["candidates"].long()]                 # (C, D)
    return torch.einsum("bkd,cd->bkc", interests, cand).amax(1)


# --------------------------------------------------------------- BERT4Rec

@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff_mult: int = 4

    @property
    def mask_token(self) -> int:
        return self.n_items  # vocab rows = n_items + 1


def bert4rec_init(generator: torch.Generator | None, cfg: Bert4RecConfig, *,
                  device="cuda") -> Params:
    dev = layers.init_device(device)
    d = cfg.embed_dim

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=dev)

    def zeros():
        return torch.zeros((d,), dtype=torch.float32, device=dev)

    p: Params = {
        "items": layers.embed_init(generator, pad_rows(cfg.n_items + 1), d,
                                   device=dev),
        "pos": layers.embed_init(generator, cfg.seq_len, d, device=dev)}
    p["blocks"] = [
        {"wqkv": dense_init(generator, d, 3 * d, device=dev),
         "wo": dense_init(generator, d, d, device=dev),
         "ln1_g": ones(), "ln1_b": zeros(),
         "ln2_g": ones(), "ln2_b": zeros(),
         "ffn": mlp_init(generator, (d, cfg.d_ff_mult * d, d), device=dev)}
        for _ in range(cfg.n_blocks)]
    p["ln_f_g"], p["ln_f_b"] = ones(), zeros()
    return p


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation, not the exact erf.
    return F.gelu(x, approximate="tanh")


def bert4rec_encode(cfg: Bert4RecConfig, p: Params, seq: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """seq (B, S) item ids, mask (B, S) validity -> (B, S, D) hidden.
    Masked keys get -inf before a float32 softmax."""
    b, s = seq.shape
    h = p["items"][seq.long()] + p["pos"][None, :s]
    keep = mask.bool()[:, None, None, :]                          # keys
    nh = cfg.n_heads
    dh = cfg.embed_dim // nh
    for blk in p["blocks"]:
        hn = layers.layer_norm(h, blk["ln1_g"], blk["ln1_b"])
        q, k, v = (t.reshape(b, s, nh, dh)
                   for t in (hn @ blk["wqkv"]).split(cfg.embed_dim, -1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (dh ** -0.5)
        logits = logits.masked_fill(~keep, float("-inf"))
        w = torch.softmax(logits.float(), dim=-1).to(h.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, -1)
        h = h + o @ blk["wo"]
        hn = layers.layer_norm(h, blk["ln2_g"], blk["ln2_b"])
        h = h + mlp_apply(blk["ffn"], hn, act=_gelu_tanh)
    return layers.layer_norm(h, p["ln_f_g"], p["ln_f_b"])


def bert4rec_loss(cfg: Bert4RecConfig, p: Params, batch: dict):
    """Cloze objective: the items at the masked positions.

    batch: seq (B, S) with mask_token at the cloze slots, seq_mask (B, S)
    validity, mlm_positions (B, P), mlm_labels (B, P) (-1 pads)."""
    h = bert4rec_encode(cfg, p, batch["seq"], batch["seq_mask"])
    pos = batch["mlm_positions"].long()[..., None].expand(-1, -1, h.shape[-1])
    logits = h.gather(1, pos) @ p["items"].T        # tied output embedding
    labels = batch["mlm_labels"]
    loss = layers.cross_entropy(logits, labels.clamp_min(0), labels >= 0)
    return loss, {"cloze_ce": loss}


def bert4rec_retrieval(cfg: Bert4RecConfig, p: Params,
                       batch: dict) -> torch.Tensor:
    """The hidden state at the last (mask) slot dotted with the (C,)
    candidates' embeddings: (B, C)."""
    h = bert4rec_encode(cfg, p, batch["seq"], batch["seq_mask"])
    cand = p["items"][batch["candidates"].long()]
    return h[:, -1, :] @ cand.T
