"""Plain PyTorch versions of the port's kernels.

Each ``<name>_ref`` is the semantic ground truth its CUDA kernel is held to
(on the card, by ``chip_smoke.py``) and what the wrapper in
:mod:`repro_torch.kernels.ops` runs for tensors on the CPU.  Literal
translations of :mod:`repro.kernels.ref`, with the batch dimension written
out where the reference uses ``vmap``.
"""
from __future__ import annotations

import torch

INVALID = -1


def l2_distance_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D), (N, D) -> (Q, N) squared L2, accumulated in float32:
    max(|q|^2 - 2 q.x + |x|^2, 0)."""
    q, x = q.float(), x.float()
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1)
    return (qn - 2.0 * (q @ x.T) + xn[None, :]).clamp_min(0.0)


def topk_ref(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, N) -> ((Q, k) ascending values, (Q, k) int32 ids) in
    ``lax.top_k``'s order: ties go to the lower index, so the ids are
    distinct even where a row has fewer than k finite entries.

    ``torch.topk`` picks k entries, ties at the k-th value t in no promised
    order.  Rows where more entries equal t than were picked are redone
    exactly: every entry below t, then the lowest positions equal to t.
    """
    vals, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
    t = vals[:, -1:]
    redo = ((d == t).sum(1) > (vals == t).sum(1)).nonzero()[:, 0]
    if redo.numel():
        dr, tr = d[redo], t[redo]
        less, eq = dr < tr, dr == tr
        need = k - less.sum(1, keepdim=True)
        take = less | (eq & (torch.cumsum(eq, 1) <= need))
        pos[redo] = take.nonzero()[:, 1].view(-1, k)
        vals[redo] = torch.gather(dr, 1, pos[redo])
    # Order the k picked entries by (value, position).
    by_pos = torch.argsort(pos, dim=1)
    pos, vals = torch.gather(pos, 1, by_pos), torch.gather(vals, 1, by_pos)
    order = torch.argsort(vals, dim=1, stable=True)
    return (torch.gather(vals, 1, order),
            torch.gather(pos, 1, order).to(torch.int32))


def lid_ref(knn_d2: torch.Tensor) -> torch.Tensor:
    """(B, k) ascending squared k-NN distances -> (B,) Hill LID estimates,
    with r = sqrt(max(d2, 1e-24))."""
    r = torch.sqrt(knn_d2.float().clamp_min(1e-24))
    mean_log = torch.log(r / r[:, -1:]).mean(-1)
    return -1.0 / mean_log.clamp_max(-1.0 / 4096.0)


def _as_lanes(v, q: int, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=device).expand(q)


def _in_budget(beam_ids, budgets):
    """(Q, L) bool: the beam slots below each lane's budget."""
    q, width = beam_ids.shape
    slot = torch.arange(width, device=beam_ids.device)
    return slot[None, :] < _as_lanes(budgets, q, beam_ids.device)[:, None]


def lane_active(beam_ids, beam_exp, hops, budgets, hop_limits) -> torch.Tensor:
    """(Q,) bool: whether each lane's walk can still take a hop — hop limit
    not reached and an unexpanded, valid, in-budget beam slot left."""
    frontier_open = ((~beam_exp) & (beam_ids != INVALID)
                     & _in_budget(beam_ids, budgets)).any(1)
    return (hops < _as_lanes(hop_limits, beam_ids.shape[0], beam_ids.device)
            ) & frontier_open


def _select(state, in_budget):
    """The frontier of every lane: the argmin over its unexpanded, valid,
    in-budget beam slots (ties to the lowest slot; a lane with none open
    takes slot 0), marked expanded.  Returns (state, u)."""
    beam_ids, beam_d, beam_exp, visited, hops, evals = state
    rows = torch.arange(beam_ids.shape[0], device=beam_ids.device)
    cand_d = torch.where(beam_exp | (beam_ids == INVALID) | (~in_budget),
                         torch.inf, beam_d)
    j = torch.argmin(cand_d, dim=1)
    new_exp = beam_exp.clone()
    new_exp[rows, j] = True
    return (beam_ids, beam_d, new_exp, visited, hops, evals), beam_ids[rows, j]


def _expand(state, u, nbrs, ctxs, table, kind):
    """Expand each lane's selected frontier ``u`` (Q,) with its adjacency
    row ``nbrs`` (Q, R): the visited test, the neighbours' distances, the
    visited bits and the keep-best-L merge (a stable argsort).  Returns the
    state of every lane after the hop."""
    beam_ids, beam_d, beam_exp, visited, hops, evals = state
    width = beam_ids.shape[1]
    valid = (nbrs != INVALID) & (u != INVALID)[:, None]
    safe = nbrs.clamp_min(0)
    word_idx = (safe >> 5).long()
    bit = torch.bitwise_left_shift(torch.ones_like(safe), safe & 31)
    seen = (torch.gather(visited, 1, word_idx) & bit) != 0
    valid = valid & (~seen)

    if kind == "pq":
        c = table[safe.long()].long()                       # (Q, R, M)
        d = torch.gather(ctxs, 2, c.transpose(1, 2)).sum(1)  # (Q, R)
    else:
        diff = table[safe.long()].float() - ctxs[:, None, :]
        d = (diff * diff).sum(-1)
    d = torch.where(valid, d, torch.inf)
    # Distinct ids set distinct bits, so an add of the bits is their OR.
    new_visited = visited.scatter_add(
        1, word_idx, torch.where(valid, bit, torch.zeros_like(bit)))

    nbr_ids = torch.where(valid, nbrs, INVALID)
    cat_ids = torch.cat([beam_ids, nbr_ids], 1)
    cat_d = torch.cat([beam_d, d], 1)
    cat_exp = torch.cat([beam_exp, torch.zeros_like(valid)], 1)
    order = torch.argsort(cat_d, dim=1, stable=True)[:, :width]
    return (torch.gather(cat_ids, 1, order), torch.gather(cat_d, 1, order),
            torch.gather(cat_exp, 1, order), new_visited, hops + 1,
            evals + valid.sum(1, dtype=torch.int32))


def _freeze(active, new, old):
    """Lanes where ``active`` (Q,) is False keep their ``old`` leaves."""
    return tuple(torch.where(active.view(-1, *([1] * (n.dim() - 1))), n, o)
                 for n, o in zip(new, old))


def beam_step_ref(state, ctxs, adj, table, budgets, hop_limits, *, kind):
    """One beam-walk hop over a batch of lanes (plain PyTorch oracle).

    ``state`` is (beam_ids (Q, L) int32, beam_d (Q, L) float32, beam_exp
    (Q, L) bool, visited (Q, ceil(N/32)) int32 holding uint32 bit patterns,
    hops (Q,) int32, evals (Q,) int32).  ``kind="exact"``: ``table`` is
    (N, D) float32 vectors and ``ctxs`` (Q, D) queries; ``kind="pq"``:
    ``table`` is (N, M) uint8 codes and ``ctxs`` (Q, M, K) ADC LUTs.
    Returns the post-hop state as new tensors; lanes whose frontier is closed
    or hop limit reached come back unchanged.
    """
    if kind not in ("exact", "pq"):
        raise ValueError(f"unknown beam_step kind {kind!r}")
    active = lane_active(state[0], state[2], state[4], budgets, hop_limits)
    sel, u = _select(state, _in_budget(state[0], budgets))
    new = _expand(sel, u, adj[u.clamp_min(0).long()], ctxs, table, kind)
    return _freeze(active, new, state)


def beam_hop_rows_ref(state, u, active, rows, ctxs, table, budgets,
                      hop_limits, *, kind):
    """One out-of-core hop with the adjacency rows supplied per lane (plain
    version of the row-fed kernel; the reference's ``ooc_hop_batch``).

    Each ``active`` (Q,) bool lane expands its already-selected frontier
    ``u`` (Q,) int32 with ``rows`` (Q, R) int32 (= ``adj[u]``; rows of
    inactive lanes are not read) and the others keep their state; then
    every lane's activity is recomputed (``lane_active``) and each active
    lane selects and marks its next frontier.  Returns ``(state, u_next,
    active_next)`` with ``u_next`` INVALID on lanes that cannot move.
    ``active=None`` (``u``, ``rows``, ``ctxs`` and ``table`` unused) means
    every lane inactive: the select alone, the reference's
    ``ooc_select_batch``.  Tables and state as :func:`beam_step_ref`.
    """
    if kind not in ("exact", "pq"):
        raise ValueError(f"unknown beam_step kind {kind!r}")
    if active is not None:
        new = _expand(state, u, rows, ctxs, table, kind)
        state = _freeze(active, new, state)
    act = lane_active(state[0], state[2], state[4], budgets, hop_limits)
    sel, u_next = _select(state, _in_budget(state[0], budgets))
    return (_freeze(act, sel, state),
            torch.where(act, u_next, torch.full_like(u_next, INVALID)), act)


def beam_walk_ref(state, ctxs, adj, table, budgets, hop_limits, *, kind,
                  max_hops: int):
    """``beam_step_ref`` iterated until no lane can move or ``max_hops``
    hops are taken (plain version of the walk kernel).  Returns
    ``(state, active)``: the state after the walk and the (Q,) bool lanes
    that can still move."""
    active = lane_active(state[0], state[2], state[4], budgets, hop_limits)
    for _ in range(max_hops):
        if not bool(active.any()):
            break
        state = beam_step_ref(state, ctxs, adj, table, budgets, hop_limits,
                              kind=kind)
        active = lane_active(state[0], state[2], state[4], budgets,
                             hop_limits)
    return state, active


def pq_scan_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(Q, M, K) float32 LUTs x (N, M) uint8 codes -> (Q, N) ADC distances
    sum_m LUT[q, m, code[n, m]], summed in m order (the reference's
    ``pq_scan_ref`` with the query batch written out).  Codes must lie
    below K."""
    q, m, _ = luts.shape
    c = codes.long()
    out = torch.zeros((q, codes.shape[0]), dtype=torch.float32,
                      device=luts.device)
    for j in range(m):
        out += luts[:, j, :].float()[:, c[:, j]]
    return out


def decode_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             kv_len: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """GQA decode attention without repeating KV across the group:
    q (B, Hq, d); k, v (B, S, Hkv, d) with Hq = G * Hkv; kv_len (B,) ->
    (B, Hq, d) float32.

    The grouped einsum of the reference (``decode_attention_gqa_ref``),
    with its TPU kernel's guard for a row with nothing to attend to: the
    softmax is taken as exp(logits - m) / max(l, 1e-30) with m = 0 where
    every position is masked, so kv_len = 0 gives zeros (the reference's
    oracle gives NaN there).  Positions are ``arange(S)``, so kv_len > S
    counts as S.
    """
    b, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    if kv_len is not None:
        pos = torch.arange(k.shape[1], device=k.device)
        mask = pos[None, None, None, :] < kv_len.to(k.device)[:, None, None,
                                                              None]
        logits = logits.masked_fill(~mask, -torch.inf)
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, hq, d)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token decode attention with one KV head per query head:
    q (B, H, d); k, v (B, S, H, d); kv_len (B,) -> (B, H, d) float32 (the
    reference's ``decode_attention_ref``, a softmax over the positions below
    kv_len)."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    if kv_len is not None:
        pos = torch.arange(k.shape[1], device=k.device)
        logits = logits.masked_fill(
            ~(pos[None, None, :] < kv_len.to(k.device)[:, None, None]),
            -torch.inf)
    return torch.einsum("bhs,bshd->bhd", torch.softmax(logits, -1),
                        v.float())
