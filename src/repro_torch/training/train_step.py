"""Generic train-step builder (port of :mod:`repro.training.train_step`).

``make_train_step(loss_fn, opt_cfg, compress_grads)`` returns
    (state, batch) -> (state, metrics)
which runs the loss forward and backward (``torch.autograd.grad``), then
the optional int8 compression with error feedback, then AdamW with its
global-norm clip.  The state is updated in place and returned; the
``loss_fn`` closure carries the model config, so the same builder serves
any model whose parameters are a tree of dicts and lists.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.training import compression as comp_mod
from repro_torch.training import optimizer as opt_mod

Params = Any
LossFn = Callable[[Params, dict], tuple[torch.Tensor, dict]]


@dataclasses.dataclass
class TrainState:
    params: Params
    opt: Params
    error_feedback: Params | None = None

    @property
    def step(self) -> torch.Tensor:
        return self.opt["step"]


def init_train_state(params: Params,
                     compress_grads: bool = False) -> TrainState:
    return TrainState(
        params=params,
        opt=opt_mod.adamw_init(params),
        error_feedback=(comp_mod.init_error_feedback(params)
                        if compress_grads else None))


def make_train_step(loss_fn: LossFn, opt_cfg: opt_mod.AdamWConfig,
                    compress_grads: bool = False):
    def train_step(state: TrainState, batch: dict) -> tuple[TrainState,
                                                            dict]:
        flat = [p for _, p in opt_mod.flatten(state.params)]
        for p in flat:
            p.requires_grad_(True)
        loss, metrics = loss_fn(state.params, batch)
        it = iter(torch.autograd.grad(loss, flat))
        grads = opt_mod.tree_map(lambda _: next(it), state.params)
        for p in flat:
            p.requires_grad_(False)
        err = state.error_feedback
        if compress_grads:
            grads, err = comp_mod.compress_grads_with_feedback(grads, err)
        params, opt, opt_metrics = opt_mod.adamw_update(
            opt_cfg, state.params, grads, state.opt)
        del grads
        out = {k: v.detach() for k, v in metrics.items()}
        out.update(opt_metrics)
        out["loss"] = loss.detach()
        state.params, state.opt, state.error_feedback = params, opt, err
        return state, out

    return train_step
