"""The reference's LM parameters into the port's layout.

:func:`lm_params_from_reference` takes the pytree of the reference's
``repro.models.transformer.init_lm`` as numpy arrays (for instance
``jax.tree.map(np.asarray, params)``) and returns the port's dict: the
stacked leading layer axis becomes one dict per layer.  Used by the parity
tests; it imports nothing of the reference.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import TransformerConfig, _check_dense

Params = dict[str, Any]


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dtype)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_reference(params_np: Params, cfg: TransformerConfig,
                             device="cuda",
                             dtype: torch.dtype = torch.float32) -> Params:
    """{"embed", "layers" (stacked), "ln_final", "lm_head"?} of numpy
    arrays -> the port's parameters in ``dtype`` on ``device``."""
    _check_dense(cfg)
    if "dense_layers" in params_np:
        raise NotImplementedError("a dense-prefix MoE layout is not ported")
    dev = resolve_device(device)
    out: Params = {k: _tensor(v, dtype, dev) for k, v in params_np.items()
                   if k != "layers"}
    stacked = params_np["layers"]
    out["layers"] = [_tree(stacked, lambda a, i=i: _tensor(a[i], dtype, dev))
                     for i in range(cfg.n_layers)]
    return out
