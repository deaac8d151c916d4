"""The reference's parameters into the port's layout.

:func:`lm_params_from_reference` takes the pytree of the reference's
``repro.models.transformer.init_lm`` as numpy arrays (for instance
``jax.tree.map(np.asarray, params)``) and returns the port's dict: the
stacked leading layer axis becomes one dict per layer, an MoE net's
``dense_layers`` stack its first entries.  Stacked MoE weights ((E, d, f)
a layer, ``router``, ``shared``), MLA's keys, ``q_norm`` / ``k_norm`` and
a tied model without ``lm_head`` carry across as they are.
:func:`params_from_reference` carries the recsys models' and the GAT's
trees across with their structure unchanged (neither stacks a layer axis).
Used by the parity tests; it imports nothing of the reference.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import TransformerConfig, leaves

Params = dict[str, Any]


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dtype)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def params_from_reference(params_np: Params, device="cuda",
                          dtype: torch.dtype = torch.float32) -> Params:
    """A tree of numpy arrays (dicts and lists: the reference's
    ``dlrm_init``, ``deepfm_init``, ``mind_init``, ``bert4rec_init`` or
    ``gat_init``) -> the same structure of tensors in ``dtype`` on
    ``device``.  BERT4Rec's ``blocks`` and the GAT's ``layers`` stay
    lists: the reference has no stacked axis there."""
    dev = resolve_device(device)
    return _tree(params_np, lambda a: _tensor(a, dtype, dev))


def lm_params_from_reference(params_np: Params, cfg: TransformerConfig,
                             device="cuda",
                             dtype: torch.dtype = torch.float32) -> Params:
    """{"embed", "dense_layers"? (stacked), "layers" (stacked), "ln_final",
    "lm_head"?} of numpy arrays -> the port's parameters in ``dtype`` on
    ``device``."""
    dev = resolve_device(device)
    out: Params = {k: _tensor(v, dtype, dev) for k, v in params_np.items()
                   if k not in ("layers", "dense_layers")}
    out["layers"] = []
    for group in ("dense_layers", "layers"):
        if group not in params_np:
            continue
        stacked = params_np[group]
        n = len(next(leaves(stacked)))
        out["layers"] += [
            _tree(stacked, lambda a, i=i: _tensor(a[i], dtype, dev))
            for i in range(n)]
    if len(out["layers"]) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(out['layers'])} layers in the "
                         f"reference's parameters, not {cfg.n_layers}")
    return out
