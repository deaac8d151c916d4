"""Mixture-of-Experts FFN with scatter-based token dispatch (port of
:mod:`repro.models.moe`).

Covers the two MoE archs of the zoo:
  * qwen3-moe-30b-a3b : 128 routed experts, top-8, expert d_ff=768, no shared
  * deepseek-v2-lite  : 64 routed experts, top-6, 2 shared experts, d_ff=1408

Each token's slot in its expert comes from a token-major cumsum over the
(T * k, E) assignment one-hot; tokens are scattered into (E, cap, D) expert
buffers and the expert FFNs are one batched matmul over experts.  An
assignment past its expert's capacity is dropped (GShard semantics,
capacity_factor 1.0) and contributes 0; its residual stream passes
through.  Routing takes its top-k through :func:`repro_torch.kernels.ops.topk`
on the negated probabilities: ties go to the lower expert id as
``jax.lax.top_k`` sends them, through ``topk_ref`` on the CPU and the
``topk`` kernel on the card.  The gates are the top-k values, so the
router's gradient passes through ``ops.topk``'s value gradient on both
devices, as it passes through ``lax.top_k`` in the reference.  Training
(``transformer.forward``) drops assignments past ``capacity_factor``
(``no_drop=False``); decode keeps every one.

On a ("data", "model") :class:`~repro_torch.distributed.mesh.ShardMesh`
whose shapes allow it, :func:`moe_apply` runs the expert-parallel
schedule (:func:`moe_apply_expert_parallel`, the reference's
``shard_map`` all-to-all): each rank routes its own token block, the
expert slabs are exchanged within each data row, each rank runs its share
of the experts and the results are exchanged back.  One process drives
every rank; a rank's work runs on its card's current stream, and the
exchange is copies between cards (none between ranks on one card).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import layers
from repro_torch.models.layers import dense_init

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_expert: int            # per-expert FFN hidden size
    n_shared: int = 0        # DeepSeek shared experts
    d_shared: int = 0        # shared-expert hidden size (d_expert if 0)
    capacity_factor: float = 1.0
    router_noise: float = 0.0

    @property
    def shared_hidden(self) -> int:
        return self.d_shared or self.d_expert


def moe_init(generator: torch.Generator | None, cfg: MoeConfig, *,
             dtype=torch.float32, device="cuda") -> Params:
    dev = layers.init_device(device)
    kw = dict(dtype=dtype, device=dev)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert

    def experts(shape, fan_in):
        w = torch.randn(shape, generator=generator, **kw)
        return w.mul_((1.0 / fan_in) ** 0.5)

    p = {"router": dense_init(generator, d, e, scale=0.02, **kw),
         "w_gate": experts((e, d, f), d),
         "w_up": experts((e, d, f), d),
         "w_down": experts((e, f, d), f)}
    if cfg.n_shared:
        fs = cfg.shared_hidden * cfg.n_shared
        p["shared"] = {"w_gate": dense_init(generator, d, fs, **kw),
                       "w_up": dense_init(generator, d, fs, **kw),
                       "w_down": dense_init(generator, fs, d, **kw)}
    return p


def _route(p: Params, cfg: MoeConfig, x_flat: torch.Tensor):
    """Token-choice top-k routing. Returns (expert_idx (T, k) int32, gate
    (T, k) float32 normalised by max(sum, 1e-9), router_probs (T, E) for
    the aux loss)."""
    logits = (x_flat @ p["router"]).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    neg_p, top_e = ops.topk(-probs, cfg.top_k)                 # (T, k)
    top_p = -neg_p
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_e, top_p, probs


def load_balance_loss(router_probs: torch.Tensor, expert_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-Transformer aux loss: E * sum_e f_e * P_e."""
    onehot = F.one_hot(expert_idx[:, 0].long(), n_experts).float()
    f = onehot.mean(0)                      # fraction of tokens -> expert
    pmean = router_probs.mean(0)            # mean router prob
    return n_experts * torch.sum(f * pmean)


def _dispatch_group(x_g: torch.Tensor, expert_idx_g: torch.Tensor, cap: int,
                    n_experts: int):
    """One group's scatter-dispatch. x_g (tg, D); expert_idx_g (tg, k).

    Returns (buf (E, cap, D), dest (tg*k,) int32, keep (tg*k,) bool): the
    slot of an assignment is its position in a token-major cumsum over the
    flat assignments; an assignment at slot >= cap is dropped (its dest is
    the discarded row E * cap).
    """
    tg, d = x_g.shape
    k = expert_idx_g.shape[1]
    flat_e = expert_idx_g.reshape(tg * k).long()
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    slot = pos.gather(1, flat_e[:, None])[:, 0]
    keep = slot < cap
    dest = torch.where(keep, flat_e.to(torch.int32) * cap + slot,
                       torch.full_like(slot, n_experts * cap))
    src = x_g.repeat_interleave(k, dim=0)
    buf = torch.zeros((n_experts * cap + 1, d), dtype=x_g.dtype,
                      device=x_g.device).index_add_(0, dest, src)
    return buf[:-1].reshape(n_experts, cap, d), dest, keep


def _axis_size(mesh, axes) -> int:
    """The product of the sizes of ``axes`` (a name or a tuple of names)
    in ``mesh.shape``."""
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _ranks(mesh):
    """[(i_dp, i_tp, device)] of the expert-parallel ranks, in the mesh's
    row-major order: ``i_dp`` the rank's position over the data axes
    (flattened in their order), ``i_tp`` its coordinate on "model", the
    device its shard's.  A rank off coordinate 0 of any other axis would
    repeat a block and is left out."""
    dp = dp_axes(mesh)
    names, sizes = mesh.axis_names, tuple(mesh.shape.values())
    out = []
    for r, dev in enumerate(mesh.shard_devices):
        at = dict(zip(names, np.unravel_index(r, sizes)))
        if any(at[a] for a in names if a not in dp and a != "model"):
            continue
        i_dp = int(np.ravel_multi_index(tuple(at[a] for a in dp),
                                        tuple(mesh.shape[a] for a in dp)))
        out.append((i_dp, int(at["model"]), dev))
    return out


def _on(dev: torch.device):
    """``dev`` made the current card (nothing off the card)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def moe_apply_expert_parallel(p: Params, cfg: MoeConfig, x: torch.Tensor,
                              mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel schedule on ``mesh`` (a ShardMesh with a
    "model" axis): local dispatch -> all-to-all over "model" -> local
    expert FFNs -> all-to-all back -> local combine.

    Rank (i_dp, i_tp) holds the token block ``x[i_dp * B/n_dp : ...,
    i_tp * S/n_tp : ...]`` on its shard's device, routes it (``_route``:
    the ``topk`` kernel on the card) and scatters it into its own (E, cap,
    D) buffer, ``cap`` = max(int(capacity_factor * t_local * k / E), 1)
    for its t_local tokens: capacity is per rank, not per batch.  Within
    each data row, rank j receives slab j of every peer's buffer (dim 0 of
    what it receives is the source peer), applies experts ``[j * E/n_tp,
    (j + 1) * E/n_tp)`` and sends slab j' of its outputs back to peer j',
    which combines its kept assignments by their gates.  The aux loss is
    the Switch form over the global sums of every rank's first-choice
    one-hot and router probabilities.  The rank blocks and the sums are
    gathered to ``x``'s device, where the shared experts run on the whole
    of ``x``.  The weights stay where they are: a rank on another device
    takes a copy of its slice (its gradient flows back through the copy).

    Requirements (:func:`_expert_parallel_ok`): B % n_dp == 0, S % n_tp ==
    0, E % n_tp == 0.
    """
    n_dp = _axis_size(mesh, dp_axes(mesh))
    n_tp = mesh.shape["model"]
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_local = e // n_tp
    bl, sl = b // n_dp, s // n_tp
    t_local = bl * sl
    cap = max(int(cfg.capacity_factor * t_local * k / e), 1)
    home = x.device

    ranks = _ranks(mesh)
    local, f_sum, p_sum = {}, 0, 0
    for i, j, dev in ranks:
        with _on(dev):
            x_blk = x[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].to(dev)
            x_flat = x_blk.reshape(t_local, d)
            top_e, gate, probs = _route({"router": p["router"].to(dev)},
                                        cfg, x_flat)
            onehot = F.one_hot(top_e[:, 0].long(), e).float()
            f_sum = f_sum + onehot.sum(0).to(home)
            p_sum = p_sum + probs.sum(0).to(home)
            buf, dest, keep = _dispatch_group(x_flat, top_e, cap, e)
            local[i, j] = (buf.reshape(n_tp, e_local, cap, d), dest, keep,
                           gate)
    t_glob = t_local * n_dp * n_tp
    aux = e * torch.sum((f_sum / t_glob) * (p_sum / t_glob))

    out = {}
    for i, j, dev in ranks:
        with _on(dev):
            # all_to_all within the data row: recv[j'] = peer j''s slab j.
            recv = torch.stack([local[i, jp][0][j].to(dev)
                                for jp in range(n_tp)])
            w = {n: p[n][j * e_local:(j + 1) * e_local].to(dev)
                 for n in ("w_gate", "w_up", "w_down")}
            h = F.silu(recv @ w["w_gate"]) * (recv @ w["w_up"])
            out[i, j] = h @ w["w_down"]              # (n_tp, e_local, cap, D)

    rows = {}
    for i, j, dev in ranks:
        _, dest, keep, gate = local[i, j]
        with _on(dev):
            # all_to_all back: back[j'] = peer j''s outputs for rank j.
            back = torch.stack([out[i, jp][j].to(dev) for jp in range(n_tp)])
            flat = back.reshape(e * cap, d)
            gathered = torch.where(keep[:, None],
                                   flat[dest.clamp_max(e * cap - 1).long()],
                                   torch.zeros((), dtype=flat.dtype,
                                               device=dev))
            combined = (gathered.reshape(t_local, k, d)
                        * gate[..., None].to(x.dtype)).sum(1)
            rows[i, j] = combined.reshape(bl, sl, d).to(home)
    y = torch.cat([torch.cat([rows[i, j] for j in range(n_tp)], dim=1)
                   for i in range(n_dp)])

    if cfg.n_shared:
        shared = layers.swiglu(p["shared"], x.reshape(b * s, d))
        y = y + shared.reshape(b, s, d).to(y.dtype)
    return y.to(x.dtype), aux


def _expert_parallel_ok(cfg: MoeConfig, x: torch.Tensor, mesh) -> bool:
    """Whether :func:`moe_apply` runs the expert-parallel schedule on
    ``mesh``: a "model" axis of size > 1, B % n_dp == 0, S % n_tp == 0 and
    E % n_tp == 0."""
    if mesh is None or "model" not in mesh.axis_names:
        return False
    n_dp = _axis_size(mesh, dp_axes(mesh))
    n_tp = mesh.shape["model"]
    b, s, _ = x.shape
    return (n_tp > 1 and b % n_dp == 0 and s % n_tp == 0
            and cfg.n_experts % n_tp == 0)


def moe_apply(p: Params, cfg: MoeConfig, x: torch.Tensor,
              no_drop: bool = False, n_groups: int | None = None,
              mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).

    Dispatch is group-local (GShard semantics): the T tokens split into
    ``n_groups`` groups (default 1, or the product of ``mesh``'s data
    axes; halved until it divides T), each scattered into its own (E, cap,
    D) buffer.  ``cap`` is max(int(capacity_factor * tg * k / E), 1) for
    groups of tg tokens, or tg under ``no_drop`` (decode: nothing is
    dropped, so serving is deterministic).  The combine multiplies each
    expert output by its gate cast to x's dtype and sums over k; shared
    experts are added after.

    On a ``mesh`` where :func:`_expert_parallel_ok` holds, and unless
    ``no_drop``, this runs :func:`moe_apply_expert_parallel` instead.
    """
    if not no_drop and _expert_parallel_ok(cfg, x, mesh):
        return moe_apply_expert_parallel(p, cfg, x, mesh)
    b, s, d = x.shape
    t = b * s
    if n_groups is None:
        n_groups = 1 if mesh is None else _axis_size(mesh, dp_axes(mesh))
    while t % n_groups != 0:
        n_groups //= 2  # batch=1 decode etc: fall back to fewer groups
    tg = t // n_groups
    e, k = cfg.n_experts, cfg.top_k

    x_flat = x.reshape(t, d)
    expert_idx, gate, router_probs = _route(p, cfg, x_flat)
    aux = load_balance_loss(router_probs, expert_idx, e)
    cap = tg if no_drop else max(int(cfg.capacity_factor * tg * k / e), 1)

    x_g = x_flat.reshape(n_groups, tg, d)
    eid_g = expert_idx.reshape(n_groups, tg, k)
    groups = [_dispatch_group(x_g[i], eid_g[i], cap, e)
              for i in range(n_groups)]
    buf = torch.stack([g[0] for g in groups])             # (G, E, cap, D)

    # Expert FFNs batched over (group, expert).
    h = F.silu(buf @ p["w_gate"]) * (buf @ p["w_up"])
    out_buf = h @ p["w_down"]                              # (G, E, cap, D)

    # Gather back within each group; dropped slots contribute 0.
    gate_g = gate.reshape(n_groups, tg, k)
    combined = []
    for i, (_, dest, keep) in enumerate(groups):
        flat = out_buf[i].reshape(e * cap, d)
        gathered = torch.where(keep[:, None],
                               flat[dest.clamp_max(e * cap - 1).long()],
                               torch.zeros((), dtype=flat.dtype,
                                           device=flat.device))
        combined.append((gathered.reshape(tg, k, d)
                         * gate_g[i][..., None].to(flat.dtype)).sum(1))
    out = torch.cat(combined).reshape(t, d)

    if cfg.n_shared:
        sp = p["shared"]
        out = out + layers.swiglu(sp, x_flat)
    return out.reshape(b, s, d).to(x.dtype), aux
