"""AdamW + learning-rate schedules (port of
:mod:`repro.training.optimizer`).

The WSD (Warmup-Stable-Decay) schedule of minicpm-2b [arXiv:2404.06395]
beside the cosine one.  The optimizer state mirrors the parameter tree:
float32 ``m`` and ``v``, and ``step``, a 0-dim int32 tensor on the host
(the schedule is host arithmetic, so reading it never waits for the
card).  The schedule, the bias corrections and ``lr`` are float32 at the
reference's rounding points; :func:`adamw_update` updates the parameters
and moments in place with ``torch._foreach_*`` ops, one layer at a time
(so a temporary is never larger than one layer), and clips the gradients
in place (no second copy of them).

Weight decay follows the reference's rule on the reference's leaves: a
leaf of rank >= 2 decays.  The reference stacks the transformer's layers
on a leading axis, so every tensor of a layer (the norm gammas and QKV
biases too) decays there, and only a top-level vector (``ln_final``) does
not; :func:`reference_leaves` maps the port's per-layer tree onto those
leaves.  No other model stacks: a GAT layer's tensors are leaves of their
own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"       # "cosine" | "wsd" | "const"
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1        # WSD: fraction of steps in final decay


def _step_tensor(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32, device="cpu")


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    step = _step_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * (0.5 * (1.0 + torch.cos(math.pi * t)))


def wsd_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Warmup-Stable-Decay: linear warmup, flat plateau, sharp final decay
    (MiniCPM anneals exponentially over the last ``decay_frac``)."""
    step = _step_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    decay_start = cfg.total_steps * (1.0 - cfg.decay_frac)
    t = torch.clamp((step - decay_start)
                    / max(cfg.total_steps - decay_start, 1.0), 0.0, 1.0)
    decay = 0.5 ** (t * 6.0)  # ~64x down by the end, MiniCPM-style
    return cfg.lr * warm * decay


def schedule_fn(cfg: AdamWConfig) -> Callable[[Any], torch.Tensor]:
    """step -> lr, a float32 0-dim tensor on the host."""
    if cfg.schedule == "cosine":
        return lambda s: cosine_schedule(cfg, s)
    if cfg.schedule == "wsd":
        return lambda s: wsd_schedule(cfg, s)
    return lambda s: torch.full((), cfg.lr, dtype=torch.float32)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a tree of dicts, lists, tuples and
    dataclasses (and of ``rest``, trees of the same structure); ``None``
    holds no tensor.  The training modules share it and :func:`flatten`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def flatten(tree, path=()):
    """(path, tensor) pairs of a tree (as :func:`tree_map` walks it), in
    order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, path + (i,))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from flatten(getattr(tree, f.name), path + (f.name,))
    else:
        yield path, tree


def stacks_layers(tree) -> bool:
    """Whether the reference stacks this tree's ``layers`` on a leading
    axis: only the transformer's (``transformer.init_lm``: ``embed`` and
    ``ln_final`` beside the ``layers`` list).  Every other model's
    ``layers`` (the GAT's) is a plain list, each tensor a leaf of its
    own."""
    return (isinstance(tree, dict) and isinstance(tree.get("layers"), list)
            and "embed" in tree and "ln_final" in tree)


def reference_leaves(tree) -> list[tuple[str, list[torch.Tensor], bool]]:
    """The reference's leaves of a tree in the port's layout, as (name,
    tensors, stacked).  For the transformer (:func:`stacks_layers`) the
    reference stacks ``tree["layers"]`` on a leading axis: an MoE net's
    dense prefix (the layers with ``ffn`` when some layer has ``moe``) in
    its own ``dense_layers`` stack, the rest in ``layers``; one of its
    leaves is then the same-named tensor of every layer of a stack
    (``stacked``, its rank one more than each part's).  Every other
    tensor is a leaf of its own.  Works on any tree with the parameters'
    structure (gradients, moments, error feedback)."""
    out: dict[str, tuple[list, bool]] = {}
    layer_list = tree["layers"] if stacks_layers(tree) else None
    moe_net = layer_list is not None and any("moe" in lp for lp in layer_list)
    for path, t in flatten(tree):
        if layer_list is not None and path[0] == "layers":
            group = ("dense_layers" if moe_net and "ffn" in layer_list[path[1]]
                     else "layers")
            name = "/".join([group] + [str(p) for p in path[2:]])
            out.setdefault(name, ([], True))[0].append(t)
        else:
            out["/".join(str(p) for p in path)] = ([t], False)
    return [(name, ts, stacked) for name, (ts, stacked) in out.items()]


def adamw_init(params: Params) -> Params:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    return {"m": zeros,
            "v": tree_map(torch.zeros_like, zeros),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Params,
                        max_norm: float) -> tuple[Params, torch.Tensor]:
    """Scales ``grads`` in place by min(1, max_norm / max(norm, 1e-9));
    returns (grads, norm)."""
    flat = [g for _, g in flatten(grads)]
    norm = global_norm(flat)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        torch._foreach_mul_(flat, scale)
    return grads, norm


def _chunks(items: list, size: int = 16):
    for i in range(0, len(items), size):
        yield items[i:i + size]


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: Params) -> tuple[Params, Params, dict]:
    """One AdamW step, in place: clips ``grads``, updates ``state``'s
    moments and ``params``; returns (params, state, {"lr",
    "grad_norm"})."""
    step = state["step"] + 1
    lr = schedule_fn(cfg)(step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    stepf = step.float()
    bc1 = float(1 - torch.pow(cfg.b1, stepf))     # float32 values, exactly
    bc2 = float(1 - torch.pow(cfg.b2, stepf))
    lr_f = float(lr)
    rows = []       # (param, grad, m, v, decays)
    for (_, ps, stacked), (_, gs, _), (_, ms, _), (_, vs, _) in zip(
            reference_leaves(params), reference_leaves(grads),
            reference_leaves(state["m"]), reference_leaves(state["v"])):
        decays = ps[0].dim() + (1 if stacked else 0) >= 2
        rows += [(p, g, m, v, decays) for p, g, m, v in zip(ps, gs, ms, vs)]
    for part in _chunks(rows):
        p, g, m, v, dec = (list(c) for c in zip(*part))
        g = [x.float() for x in g]
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, 1 - cfg.b2), g))
        denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        del denom
        decay = [i for i, d in enumerate(dec) if d]
        if decay and cfg.weight_decay:
            torch._foreach_add_(
                [delta[i] for i in decay],
                torch._foreach_mul([p[i].float() for i in decay],
                                   cfg.weight_decay))
        p32 = [x.float() for x in p]
        torch._foreach_sub_(p32, torch._foreach_mul(delta, lr_f))
        for dst, src in zip(p, p32):
            if dst.dtype != torch.float32:
                dst.copy_(src)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
